"""Port parity, ``io/lm_data.py``: packing, ``TokenBatches`` and
``evaluate_perplexity`` of multiverso_tpu_torch against multiverso_tpu's
(tests/test_lm_data.py) on the same numpy streams.

Windows and masks are held bit for bit, the batch order for one seed
equal (both draw ``np.random.default_rng(seed).permutation``), and the
perplexity's mean loss within 1e-5 relative (the f32 logits sum over the
model width in another order; the JAX side under f32 matmul precision).
"""

import jax
import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
from multiverso_tpu.io import lm_data as jlm
from multiverso_tpu.models import transformer as jtf
from multiverso_tpu_torch.io import lm_data as tlm
from multiverso_tpu_torch.models import transformer as ttf
from multiverso_tpu_torch.zoo import Zoo as TZoo

PPL_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _runtimes():
    yield
    if jmv.Zoo.get().started:
        jmv.shutdown()
    if TZoo.get().started:
        TZoo.get().stop()


@pytest.mark.parametrize("n,seq", [(33, 8), (20, 8), (100, 7), (9, 8)])
def test_pack_tokens_bit_for_bit(n, seq):
    ids = np.random.default_rng(n).integers(0, 50, n)
    np.testing.assert_array_equal(tlm.pack_tokens(ids, seq),
                                  jlm.pack_tokens(ids, seq))
    assert tlm.pack_tokens(ids, seq).dtype == np.int32


@pytest.mark.parametrize("n,seq", [(20, 8), (5, 8), (33, 8), (2, 4)])
def test_pack_tokens_padded_bit_for_bit(n, seq):
    ids = np.arange(1, n + 1)
    tw, tm = tlm.pack_tokens_padded(ids, seq)
    jw, jm = jlm.pack_tokens_padded(ids, seq)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tm, jm)
    assert tm.dtype == np.float32 and tm.sum() == n - 1


def test_pack_errors_match():
    for mod in (tlm, jlm):
        with pytest.raises(ValueError, match="shorter"):
            mod.pack_tokens(np.arange(5), seq_len=8)
        with pytest.raises(ValueError, match="mask"):
            mod.pack_tokens(np.arange(20), seq_len=8, drop_remainder=False)
        with pytest.raises(ValueError, match="at least 2"):
            mod.pack_tokens_padded(np.arange(1), seq_len=8)


def _cfgs(**kw):
    base = dict(vocab_size=32, dim=16, num_heads=2, num_layers=1, max_seq=8,
                attn="local")
    base.update(kw)
    return jtf.TransformerConfig(**base), ttf.TransformerConfig(**base)


@pytest.mark.parametrize("prefetch", [True, False])
def test_batch_order_equals_jax(prefetch):
    jmv.init()
    jcfg, tcfg = _cfgs()
    windows = jlm.pack_tokens(np.arange(8 * 12 + 1) % 32, 8)
    want = [np.asarray(t) for t, _ in jlm.TokenBatches(
        windows, 4, jcfg, seed=3, prefetch=prefetch)]
    got = list(tlm.TokenBatches(windows, 4, tcfg, device="cpu", seed=3,
                                prefetch=prefetch))
    assert len(got) == len(want) == 3
    for (tok, tgt), w in zip(got, want):
        assert tok.device.type == "cpu" and tok.dtype == torch.int32
        np.testing.assert_array_equal(tok.numpy(), w)
        np.testing.assert_array_equal(tok.numpy()[:, 1:],
                                      tgt.numpy()[:, :-1])


def test_batches_follow_the_zoo_device():
    import multiverso_tpu_torch as tmv
    tmv.init(device="cpu")
    _, tcfg = _cfgs()
    windows = tlm.pack_tokens(np.arange(8 * 4 + 1) % 32, 8)
    (tok, _), = list(tlm.TokenBatches(windows, 4, tcfg))
    assert tok.device == torch.device("cpu")


def test_validation_matches_jax():
    jcfg, tcfg = _cfgs()
    w, m = jlm.pack_tokens_padded(np.arange(20), 8)
    for mod, cfg in ((jlm, jcfg), (tlm, tcfg)):
        kw = {} if mod is jlm else {"device": "cpu"}
        with pytest.raises(ValueError, match="masks"):
            mod.TokenBatches(w, 2, cfg, masks=m[:, :-1], **kw)
        with pytest.raises(ValueError, match="batch_size"):
            mod.TokenBatches(w, 8, cfg, **kw)
        with pytest.raises(ValueError, match="windows"):
            mod.TokenBatches(w[0], 1, cfg, **kw)
    # sequence-parallel attention is refused here, as the model refuses it
    with pytest.raises(NotImplementedError):
        tlm.TokenBatches(w, 2, tcfg._replace(attn="zigzag"), device="cpu")


def _params(jcfg, tcfg, seed=0):
    params = jtf.init_params(jcfg, seed=seed)
    return params, ttf.params_from_jax(jax.tree.map(np.asarray, params),
                                       tcfg, "cpu")


def test_masked_perplexity_equals_jax():
    jmv.init()
    jcfg, tcfg = _cfgs(vocab_size=16)
    stream = np.random.default_rng(5).integers(1, 16, 8 * 3 + 4)
    w, m = jlm.pack_tokens_padded(stream, 8)
    jp, model = _params(jcfg, tcfg)
    for masks in (m, None):
        with jax.default_matmul_precision("float32"):
            want = jlm.evaluate_perplexity(
                jp, jlm.TokenBatches(w, 2, jcfg, seed=0, masks=masks), jcfg)
        batches = tlm.TokenBatches(w, 2, tcfg, device="cpu", seed=0,
                                   masks=masks)
        got = tlm.evaluate_perplexity(model, batches, tcfg)
        # the next epoch's batches: triples when masked
        assert all(len(b) == (3 if masks is not None else 2)
                   for b in batches)
        np.testing.assert_allclose(got, want, rtol=PPL_RTOL)
        assert got[1] == pytest.approx(np.exp(got[0]))


def test_perplexity_with_a_given_loss_fn_and_no_batches():
    jcfg, tcfg = _cfgs(vocab_size=16)
    _, model = _params(jcfg, tcfg)
    w = tlm.pack_tokens(np.arange(8 * 4 + 1) % 16, 8)
    batches = tlm.TokenBatches(w, 2, tcfg, device="cpu", seed=1)
    calls = []

    def loss(p, tok, tgt):
        calls.append(tok.shape)
        return ttf.loss_fn(p, tok, tgt, cfg=tcfg)

    mean, _ = tlm.evaluate_perplexity(model, batches, tcfg, loss_fn=loss)
    assert calls == [(2, 8), (2, 8)] and np.isfinite(mean)
    with pytest.raises(ValueError, match="no batches"):
        tlm.evaluate_perplexity(model, [], tcfg)
