"""Port parity: multiverso_tpu_torch.models.word2vec against
multiverso_tpu.models.word2vec, on the same tables, ids and seeds.

Exact: the negative table, the initializers, the LCG jump constants, the
sampler states and the negative ids each epoch draws (uint32 arithmetic in
masked int64), the returned LCG state, the per-pair epochs' threefry
negatives, the Huffman path gather, the CBOW batches, and the numpy
helpers.

f32 on the CPU: each step is the same sequence of IEEE operations, but the
matrix products and reductions may sum in another order than XLA's, so
tables agree to atol 1e-7 per step (largest error measured: 7.5e-9 in one
step, at |x| ~ 0.1) and the loss to rtol 1e-6 (measured: 1.1e-7). The
steps are tested with duplicate ids, CBOW windows masked at the corpus
edges and the longest Huffman path; the epochs over two chained calls.

At the bench width (size 128, batch 16384, a pool of 256, the real corpus)
a rounding difference grows with every batch, because each batch adds
hundreds of updates into the frequent rows: see
``test_fused_shared_epoch_at_bench_width_matches_jax``.

bf16 (the card's compute dtype): the products round to bf16 at the same
points in both, but XLA and PyTorch may accumulate the bf16 products and
sums in other orders, so a delta may land one bf16 ulp apart; the tables'
change is held to 2^-7 (two bf16 ulps) of its own largest magnitude, and
the loss to rtol 1e-2 (measured on the CPU: equal bit for bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.data.dictionary import build_huffman
from multiverso_tpu.models import word2vec as jw2v
from multiverso_tpu_torch.data.dictionary import Dictionary
from multiverso_tpu_torch.io import realtext
from multiverso_tpu_torch.models import word2vec as tw2v
from multiverso_tpu_torch.utils import threefry

V, D, B = 300, 16, 64


def _unigram(seed=0, v=V):
    p = np.random.default_rng(seed).random(v) ** 3
    return (p / p.sum()).astype(np.float32)


def _tables(seed=1):
    rng = np.random.default_rng(seed)
    win = ((rng.random((V + 1, D)) - 0.5) / D).astype(np.float32)
    wout = (rng.normal(size=(V + 1, D)) * 0.05).astype(np.float32)
    win[V] = wout[V] = 0       # a padded row, as the tables carry
    return win, wout


def _t(a):
    return torch.from_numpy(np.array(a))


def test_negative_table_and_initializers_match_jax():
    for uni, size in ((_unigram(0), 1 << 12), (_unigram(1, 5000), 1 << 10),
                      (np.full(7, 1 / 7, np.float32), 1 << 20)):
        got = tw2v.build_negative_table(uni, size)
        want = jw2v.build_negative_table(uni, size)
        assert got.dtype == want.dtype and got.size == size
        np.testing.assert_array_equal(got, want)
    cfg = (V, D, 5, 5, 0.025, False, False, 32)
    for g, w in zip(tw2v.init_embeddings(tw2v.W2VConfig(*cfg), 3),
                    jw2v.init_embeddings(jw2v.W2VConfig(*cfg), 3)):
        np.testing.assert_array_equal(g, w)
    got, want = tw2v.init_lcg_state(256, 9), jw2v.init_lcg_state(256, 9)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    emb = np.random.default_rng(2).normal(size=(50, 8)).astype(np.float32)
    np.testing.assert_array_equal(tw2v.nearest_neighbors(emb, 4, 6),
                                  jw2v.nearest_neighbors(emb, 4, 6))


@pytest.mark.parametrize("n", [1, 7, 300])
def test_lcg_jump_consts_match_jax(n):
    for g, w in zip(tw2v._lcg_jump_consts(n), jw2v._lcg_jump_consts(n)):
        assert g.dtype == w.dtype == np.uint32
        np.testing.assert_array_equal(g, w)


def test_lcg_states_and_negative_ids_bit_for_bit():
    """The epoch's sampler states and negative ids, against the JAX
    epoch's own uint32 expression and against stepping the recurrence
    with python ints; lanes at 0 and near 2^32 included."""
    n, k, bits = 40, 64, 20
    state = jw2v.init_lcg_state(k, 4)
    state[:4] = [0, 1, 0xFFFFFFFF, 0xFFFFFFFE]
    table = jw2v.build_negative_table(_unigram(), 1 << bits)
    # the JAX epoch's expression (make_fused_shared_epoch's first lines)
    At, Ct = jw2v._lcg_jump_consts(n)
    s_j = (jnp.asarray(state)[None, :] * jnp.asarray(At)[:, None]
           + jnp.asarray(Ct)[:, None])
    nids_j = jnp.take(jnp.asarray(table),
                      (s_j >> jnp.uint32(32 - bits)).astype(jnp.int32),
                      axis=0)
    s_t = tw2v.lcg_states(_t(state.astype(np.int64)), n)
    assert s_t.dtype == torch.int64
    np.testing.assert_array_equal(s_t.numpy(),
                                  np.asarray(s_j).astype(np.int64))
    nids_t = torch.from_numpy(table.astype(np.int64))[s_t >> (32 - bits)]
    np.testing.assert_array_equal(nids_t.numpy(), np.asarray(nids_j))
    s = [int(x) for x in state]
    for t in range(n):
        s = [(x * 1664525 + 1013904223) & 0xFFFFFFFF for x in s]
        assert s_t[t].tolist() == s


def _step_inputs(seed, k=32):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, V, B)
    c[:8] = 5                       # duplicate centers
    x = rng.integers(0, V, B)
    x[8:16] = c[8:16]               # context == center
    neg = rng.integers(0, V, k)
    neg[:4] = x[:4]                 # a negative that is also a context
    return c, x, neg


def _shared_step_both(seed, jdt, tdt):
    win, wout = _tables(seed)
    c, x, neg = _step_inputs(seed)
    jwin, jwout, jl = jw2v.shared_neg_step(
        jnp.asarray(win), jnp.asarray(wout), jnp.asarray(c, jnp.int32),
        jnp.asarray(x, jnp.int32), jnp.asarray(neg, jnp.int32), 0.025,
        5 / 32, jdt)
    twin, twout = _t(win), _t(wout)
    rwin, rwout, tl = tw2v.shared_neg_step(
        twin, twout, _t(c), _t(x), _t(neg), 0.025, 5 / 32, tdt)
    assert rwin is twin and rwout is twout      # trained in place
    assert tl.dtype == torch.float32 and tl.shape == ()
    return ((win, wout), (np.asarray(jwin), np.asarray(jwout), float(jl)),
            (twin.numpy(), twout.numpy(), float(tl)))


@pytest.mark.parametrize("seed", [0, 1])
def test_shared_neg_step_f32_matches_jax(seed):
    _, (jwin, jwout, jl), (twin, twout, tl) = _shared_step_both(
        seed, jnp.float32, torch.float32)
    np.testing.assert_allclose(twin, jwin, rtol=0, atol=1e-7)
    np.testing.assert_allclose(twout, jwout, rtol=0, atol=1e-7)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)


def test_shared_neg_step_bf16_matches_jax():
    (win, wout), (jwin, jwout, jl), (twin, twout, tl) = _shared_step_both(
        2, jnp.bfloat16, torch.bfloat16)
    for got, want, before in ((twin, jwin, win), (twout, jwout, wout)):
        change = np.abs(want - before).max()
        assert change > 0
        assert np.abs(got - want).max() <= 2.0 ** -7 * change
    np.testing.assert_allclose(tl, jl, rtol=1e-2)


def test_skipgram_ns_step_matches_jax():
    win, wout = _tables(3)
    rng = np.random.default_rng(3)
    c, x = rng.integers(0, V, B), rng.integers(0, V, B)
    c[:6] = 7
    negs = rng.integers(0, V, (B, 5))
    jwin, jwout, jl = jw2v.skipgram_ns_step(
        jnp.asarray(win), jnp.asarray(wout), jnp.asarray(c, jnp.int32),
        jnp.asarray(x, jnp.int32), jnp.asarray(negs, jnp.int32), 0.025)
    twin, twout, tl = tw2v.skipgram_ns_step(_t(win), _t(wout), _t(c), _t(x),
                                            _t(negs), 0.025)
    np.testing.assert_allclose(twin.numpy(), np.asarray(jwin), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(twout.numpy(), np.asarray(jwout), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)


def test_fused_shared_epoch_matches_jax():
    """Two chained epochs of 6 batches each, f32: the tables, each epoch's
    mean loss and the carried LCG state."""
    nb, k = 6, 32
    cfg = (V, D, 5, 5, 0.025, False, False, k)
    uni = _unigram(4)
    win, wout = _tables(4)
    rng = np.random.default_rng(4)
    c = rng.integers(0, V, (nb, B))
    x = rng.integers(0, V, (nb, B))
    state = jw2v.init_lcg_state(k, 6)
    jfn = jw2v.make_fused_shared_epoch(jw2v.W2VConfig(*cfg), uni,
                                       compute_dtype=jnp.float32)
    tfn = tw2v.make_fused_shared_epoch(tw2v.W2VConfig(*cfg), uni,
                                       compute_dtype=torch.float32)
    jstate = (jnp.asarray(win), jnp.asarray(wout), jnp.asarray(state))
    tstate = (_t(win), _t(wout), _t(state.astype(np.int64)))
    cj, xj = jnp.asarray(c, jnp.int32), jnp.asarray(x, jnp.int32)
    for epoch in range(2):
        jw, jo, jl, js = jfn(jstate[0], jstate[1], cj, xj, jstate[2])
        tw, to, tl, ts = tfn(tstate[0], tstate[1], _t(c), _t(x), tstate[2])
        np.testing.assert_array_equal(ts.numpy(),
                                      np.asarray(js).astype(np.int64))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                                   atol=1e-7 * nb * (epoch + 1))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                                   atol=1e-7 * nb * (epoch + 1))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        jstate, tstate = (jw, jo, js), (tw, to, ts)
    with pytest.raises(ValueError, match="shared_negatives"):
        tw2v.make_fused_shared_epoch(tw2v.W2VConfig(V, D), uni)


def _words(key) -> tuple:
    """A jax key's words: the port's threefry key."""
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


def _huffman(seed=5):
    """Huffman paths over zipf counts (the JAX package's build; the port's
    copy is held equal to it in test_torch_dictionary.py)."""
    counts = np.random.default_rng(seed).zipf(1.3, V)
    return build_huffman(np.sort(counts)[::-1].astype(np.int64))


def _hs_tables(seed):
    rng = np.random.default_rng(seed)
    win = ((rng.random((V, D)) - 0.5) / D).astype(np.float32)
    hs = (rng.normal(size=(V - 1, D)) * 0.05).astype(np.float32)
    return win, hs


def _cbow_stream(seed, n=B, window=3):
    """CBOW batches of a zipf id stream (duplicate ids), the first and last
    rows' windows masked at the corpus edges."""
    rng = np.random.default_rng(seed)
    stream = (rng.zipf(1.5, n) - 1) % V
    stream[n // 2] = np.argmax(_huffman()[2])        # the longest path
    windows, mask, targets = jw2v.generate_cbow_batches(stream, window)
    assert not mask[0].all() and not mask[-1].all()
    return windows, mask, targets, rng


def _assert_step_close(before, want, got):
    """f32 tables to atol 1e-7 (each changed), loss to rtol 1e-6."""
    for b, w, g in zip(before, want[:2], got[:2]):
        w = np.asarray(w)
        assert np.abs(w - b).max() > 1e-4
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-7)
    assert got[2].dtype == torch.float32 and got[2].shape == ()
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)


def test_make_path_gather_matches_jax():
    codes, points, lengths = _huffman()
    assert lengths.max() == codes.shape[1] > 10
    ids = np.concatenate([[np.argmax(lengths), np.argmin(lengths), 0, V - 1],
                          np.random.default_rng(0).integers(0, V, 60)])
    want = jw2v._make_path_gather(codes, points, lengths)(
        jnp.asarray(ids, jnp.int32))
    got = tw2v._make_path_gather(codes, points, lengths)(_t(ids))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].dtype == torch.bool
    assert int(got[2][0].sum()) == codes.shape[1]     # the longest path


@pytest.mark.parametrize("n,window", [(50, 1), (50, 3), (4, 5)])
def test_generate_cbow_batches_matches_jax(n, window):
    ids = np.random.default_rng(n + window).integers(0, V, n)
    for g, w in zip(tw2v.generate_cbow_batches(ids, window),
                    jw2v.generate_cbow_batches(ids, window)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_skipgram_hs_step_matches_jax(seed):
    codes, points, lengths = _huffman()
    win, hs = _hs_tables(seed)
    rng = np.random.default_rng(seed)
    c, x = rng.integers(0, V, B), rng.integers(0, V, B)
    c[:8] = 5                                   # duplicate centers
    x[:4], x[4:8] = np.argmax(lengths), np.argmin(lengths)
    jpath = jw2v._make_path_gather(codes, points, lengths)(
        jnp.asarray(x, jnp.int32))
    want = jw2v.skipgram_hs_step(jnp.asarray(win), jnp.asarray(hs),
                                 jnp.asarray(c, jnp.int32), *jpath, 0.025)
    twin, ths = _t(win), _t(hs)
    tpath = tw2v._make_path_gather(codes, points, lengths)(_t(x))
    got = tw2v.skipgram_hs_step(twin, ths, _t(c), *tpath, 0.025)
    assert got[0] is twin and got[1] is ths      # trained in place
    _assert_step_close((win, hs), want, got)


def test_cbow_ns_step_matches_jax():
    win, wout = _tables(6)
    windows, mask, targets, rng = _cbow_stream(6)
    negs = rng.integers(0, V, (B, 5))
    negs[:4, 0] = targets[:4]             # a negative that is the target
    negs[4:12, 1] = 7                     # duplicate negatives
    want = jw2v.cbow_ns_step(
        jnp.asarray(win), jnp.asarray(wout), jnp.asarray(windows),
        jnp.asarray(mask), jnp.asarray(targets), jnp.asarray(negs, jnp.int32),
        0.025)
    twin, twout = _t(win), _t(wout)
    got = tw2v.cbow_ns_step(twin, twout, _t(windows), _t(mask), _t(targets),
                            _t(negs), 0.025)
    assert got[0] is twin and got[1] is twout
    _assert_step_close((win, wout), want, got)


def test_cbow_hs_step_matches_jax():
    codes, points, lengths = _huffman()
    win, hs = _hs_tables(7)
    windows, mask, targets, _ = _cbow_stream(7, window=5)
    jpath = jw2v._make_path_gather(codes, points, lengths)(
        jnp.asarray(targets))
    want = jw2v.cbow_hs_step(jnp.asarray(win), jnp.asarray(hs),
                             jnp.asarray(windows), jnp.asarray(mask), *jpath,
                             0.025)
    tpath = tw2v._make_path_gather(codes, points, lengths)(_t(targets))
    got = tw2v.cbow_hs_step(_t(win), _t(hs), _t(windows), _t(mask), *tpath,
                            0.025)
    _assert_step_close((win, hs), want, got)


def test_per_pair_negatives_match_the_jax_epoch_draw():
    """The ids each batch of a per-pair epoch draws (``key, sub =
    split(key)`` per batch, then ``sample_negatives_table``), bit for
    bit, all batches in one pass and one key at a time."""
    table = jw2v.build_negative_table(_unigram(), 1 << 20)
    tt = _t(table.astype(np.int64))
    n, b, k = 5, B, 5
    key = jkey = jax.random.key(9)
    want = []
    for _ in range(n):
        jkey, sub = jax.random.split(jkey)
        want.append(np.asarray(jw2v.sample_negatives_table(
            sub, jnp.asarray(table), b, k)))
        np.testing.assert_array_equal(
            tw2v.sample_negatives_table([_words(sub)], tt, b, k)[0].numpy(),
            want[-1])
    got = tw2v.epoch_negatives(_words(key), tt, n, b, k)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.stack(want))


def _epoch_inputs(variant, nb):
    """(JAX epoch, port epoch, tables, batches) for one of the four
    epochs with a key, on ``nb`` batches."""
    cbow, hs = variant.startswith("cbow"), variant.endswith("hs")
    cfg = (V, D, 5, 3, 0.025, cbow, hs, 0)
    jcfg, tcfg = jw2v.W2VConfig(*cfg), tw2v.W2VConfig(*cfg)
    if hs:
        codes, points, lengths = _huffman()
        tables = _hs_tables(8)
        make = ((jw2v.make_fused_cbow_hs_epoch, tw2v.make_fused_cbow_hs_epoch)
                if cbow else (jw2v.make_fused_hs_epoch,
                              tw2v.make_fused_hs_epoch))
        fns = [m(c, codes, points, lengths) for m, c in zip(make,
                                                           (jcfg, tcfg))]
    else:
        uni = _unigram(8)
        tables = _tables(8)
        make = ((jw2v.make_fused_cbow_epoch, tw2v.make_fused_cbow_epoch)
                if cbow else (jw2v.make_fused_epoch, tw2v.make_fused_epoch))
        fns = [m(c, uni) for m, c in zip(make, (jcfg, tcfg))]
    if cbow:
        windows, mask, targets, _ = _cbow_stream(8, nb * B)
        batches = (windows.reshape(nb, B, -1), mask.reshape(nb, B, -1),
                   targets.reshape(nb, B))
    else:
        rng = np.random.default_rng(8)
        batches = (rng.integers(0, V, (nb, B)).astype(np.int32),
                   rng.integers(0, V, (nb, B)).astype(np.int32))
    return fns, tables, batches


@pytest.mark.parametrize("variant", ["skipgram", "skipgram_hs", "cbow",
                                     "cbow_hs"])
def test_fused_epochs_match_jax(variant):
    """Two chained epochs of 6 batches each, f32, keyed as the app keys
    them (``key, sub = split(key)`` per epoch): the tables and each
    epoch's mean loss."""
    nb = 6
    (jfn, tfn), (a, b), batches = _epoch_inputs(variant, nb)
    jst, tst = (jnp.asarray(a), jnp.asarray(b)), (_t(a), _t(b))
    jkey = jax.random.key(2)
    tkey = threefry.key(2)
    jb = [jnp.asarray(x) for x in batches]
    tb = [_t(x) for x in batches]
    for epoch in range(2):
        jkey, jsub = jax.random.split(jkey)
        tkey, tsub = threefry.split(tkey)
        jw, jo, jl = jfn(*jst, *jb, jsub)
        tw, to, tl = tfn(*tst, *tb, tsub)
        for g, w, before in ((tw, jw, a), (to, jo, b)):
            assert np.abs(np.asarray(w) - before).max() > 1e-4
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-7 * nb * (epoch + 1))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        jst, tst = (jw, jo), (tw, to)


@pytest.fixture(scope="module")
def realtext_ids():
    """The real corpus at the bench config (min_count 5, sample 1e-4): its
    dictionary and its training ids."""
    tokens = realtext.load_tokens()
    d = Dictionary.build(tokens, 5)
    return d, d.subsample(d.encode(tokens), 1e-4, seed=0)


@pytest.fixture(scope="module")
def realtext_pairs(realtext_ids):
    """The real corpus's dictionary and the port's numpy skip-gram pairs
    (window 5)."""
    d, ids = realtext_ids
    return (d,) + tw2v.generate_pairs(ids, 5, seed=0)


def test_fused_shared_epoch_at_bench_width_matches_jax(realtext_pairs):
    """The bench width (bench.py:220-221: size 128, batch 16384, a pool of
    256, 5 negatives) on the real corpus (min_count 5, sample 1e-4; the
    pairs from the port's numpy generator), f32, from a fresh start.

    Over the first 16 batches the tables agree element by element: max
    |diff| <= 2e-6 of max |x| (measured 3.4e-7 at max |x| 3.5) and the
    mean loss to rtol 2e-5 (measured 2.0e-6: the loss sums 4M terms a
    batch, in another order than XLA's). The next 16 batches, chained,
    are held by their loss alone: each batch adds hundreds of updates
    into the frequent rows, and a rounding difference grows with every
    batch (ROADMAP.md C.1)."""
    d, centers, contexts = realtext_pairs
    nb, b, k = 16, 16384, 256
    c = centers[: 2 * nb * b].reshape(2, nb, b)
    x = contexts[: 2 * nb * b].reshape(2, nb, b)
    cfg = (len(d), 128, 5, 5, 0.025, False, False, k)
    win, wout = jw2v.init_embeddings(jw2v.W2VConfig(*cfg), 0)
    state = jw2v.init_lcg_state(k, 0)
    jfn = jw2v.make_fused_shared_epoch(jw2v.W2VConfig(*cfg), d.unigram_table(),
                                       compute_dtype=jnp.float32)
    tfn = tw2v.make_fused_shared_epoch(tw2v.W2VConfig(*cfg), d.unigram_table(),
                                       compute_dtype=torch.float32)
    jst = (jnp.asarray(win), jnp.asarray(wout), jnp.asarray(state))
    tst = (_t(win), _t(wout), _t(state.astype(np.int64)))
    for part in range(2):
        jw, jo, jl, js = jfn(jst[0], jst[1], jnp.asarray(c[part]),
                             jnp.asarray(x[part]), jst[2])
        tw, to, tl, ts = tfn(tst[0], tst[1], _t(c[part]), _t(x[part]),
                             tst[2])
        np.testing.assert_allclose(float(tl), float(jl), rtol=2e-5)
        np.testing.assert_array_equal(ts.numpy(),
                                      np.asarray(js).astype(np.int64))
        if part == 0:
            jw_, jo_ = np.asarray(jw), np.asarray(jo)
            scale = max(np.abs(jw_).max(), np.abs(jo_).max())
            assert scale > 1.0                       # the tables have grown
            err = max(np.abs(tw.numpy() - jw_).max(),
                      np.abs(to.numpy() - jo_).max())
            assert err <= 2e-6 * scale, (err, scale)
        jst, tst = (jw, jo, js), (tw, to, ts)


def test_fused_hs_epoch_at_bench_width_matches_jax_then_diverges(
        realtext_pairs):
    """Skip-gram HS at the bench width (size 128, batch 16384) on the real
    corpus, f32, from a fresh start, in chunks of 8 batches. Over the first
    8 the tables agree element by element: max |diff| <= 2e-5 of max |x|
    (measured 2.5e-6 at max |x| ~1) and the loss to rtol 2e-5. Then the
    design diverges, in both packages alike: each batch adds all 16,384
    paths' updates into the Huffman root and its children at lr 0.025, so
    the mean loss of batches 8-15 passes 1e6 and by batch 31 both losses
    are inf (measured: inf at batch 31 in both)."""
    d, centers, contexts = realtext_pairs
    nb, b = 8, 16384
    codes, points, lengths = build_huffman(d.counts)
    cfg = (len(d), 128, 5, 5, 0.025, False, True, 0)
    win, _ = jw2v.init_embeddings(jw2v.W2VConfig(*cfg), 0)
    hs = np.zeros((len(d) - 1, 128), np.float32)
    jfn = jw2v.make_fused_hs_epoch(jw2v.W2VConfig(*cfg), codes, points,
                                   lengths)
    tfn = tw2v.make_fused_hs_epoch(tw2v.W2VConfig(*cfg), codes, points,
                                   lengths)
    jst, tst = (jnp.asarray(win), jnp.asarray(hs)), (_t(win), _t(hs))
    losses = []
    for part in range(4):
        c = centers[part * nb * b: (part + 1) * nb * b].reshape(nb, b)
        x = contexts[part * nb * b: (part + 1) * nb * b].reshape(nb, b)
        jw, jh, jl = jfn(*jst, jnp.asarray(c), jnp.asarray(x), None)
        tw, th, tl = tfn(*tst, _t(c), _t(x), None)
        losses.append((float(jl), float(tl)))
        if part == 0:
            jw_, jh_ = np.asarray(jw), np.asarray(jh)
            scale = max(np.abs(jw_).max(), np.abs(jh_).max())
            err = max(np.abs(tw.numpy() - jw_).max(),
                      np.abs(th.numpy() - jh_).max())
            assert err <= 2e-5 * scale, (err, scale)
            np.testing.assert_allclose(float(tl), float(jl), rtol=2e-5)
        jst, tst = (jw, jh), (tw, th)
    assert min(losses[1]) > 1e6, losses
    assert not any(np.isfinite(losses[3])), losses


def test_fused_cbow_hs_epoch_at_bench_width_matches_jax_then_diverges(
        realtext_ids):
    """CBOW HS at the bench width (size 128, batch 16384, window 5) on the
    real corpus, f32, from a fresh start: the epoch's 37 batches in chunks
    of 8 (the last of 5). Over the first 8 the tables agree element by
    element: max |diff| <= 2e-5 of max |x| (measured 2.5e-7 at max |x|
    2.3) and the loss to rtol 2e-5. Then the design diverges, as skip-gram
    HS does above, in both packages alike: the mean loss of batches 8-15
    passes 1e9 (measured 3.9e10; the two within 1.6e-6 of each other, the
    finite chunks held to rtol 1e-5), and both are inf from batch 24 on, so
    the JAX app's epoch loss at this batch is NaN."""
    d, ids = realtext_ids
    nb, b = 8, 16384
    codes, points, lengths = build_huffman(d.counts)
    cfg = (len(d), 128, 5, 5, 0.025, True, True, 0)
    win, _ = jw2v.init_embeddings(jw2v.W2VConfig(*cfg), 0)
    hs = np.zeros((len(d) - 1, 128), np.float32)
    windows, masks, targets = tw2v.generate_cbow_batches(ids, 5)
    n = targets.size // b
    assert n == 37
    jfn = jw2v.make_fused_cbow_hs_epoch(jw2v.W2VConfig(*cfg), codes, points,
                                        lengths)
    tfn = tw2v.make_fused_cbow_hs_epoch(tw2v.W2VConfig(*cfg), codes, points,
                                        lengths)
    jst, tst = (jnp.asarray(win), jnp.asarray(hs)), (_t(win), _t(hs))
    losses = []
    for lo in range(0, n, nb):
        hi = min(lo + nb, n)
        wb = windows[lo * b: hi * b].reshape(hi - lo, b, -1)
        mb = masks[lo * b: hi * b].reshape(hi - lo, b, -1)
        tb = targets[lo * b: hi * b].reshape(hi - lo, b)
        jw, jh, jl = jfn(*jst, jnp.asarray(wb), jnp.asarray(mb),
                         jnp.asarray(tb), None)
        tw, th, tl = tfn(*tst, _t(wb), _t(mb), _t(tb), None)
        losses.append((float(jl), float(tl)))
        if lo == 0:
            jw_, jh_ = np.asarray(jw), np.asarray(jh)
            scale = max(np.abs(jw_).max(), np.abs(jh_).max())
            err = max(np.abs(tw.numpy() - jw_).max(),
                      np.abs(th.numpy() - jh_).max())
            assert err <= 2e-5 * scale, (err, scale)
            np.testing.assert_allclose(float(tl), float(jl), rtol=2e-5)
        elif np.isfinite(losses[-1]).all():
            np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        jst, tst = (jw, jh), (tw, th)
    assert min(losses[1]) > 1e9, losses
    assert not np.isfinite(losses[3:]).any(), losses
