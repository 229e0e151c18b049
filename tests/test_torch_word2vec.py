"""Port parity: multiverso_tpu_torch.models.word2vec against
multiverso_tpu.models.word2vec, on the same tables, ids and seeds.

Exact: the negative table, the initializers, the LCG jump constants, the
sampler states and the negative ids each epoch draws (uint32 arithmetic in
masked int64), the returned LCG state, and the numpy helpers.

f32 on the CPU: each step is the same sequence of IEEE operations, but the
matrix products and reductions may sum in another order than XLA's, so
tables agree to atol 1e-7 per step (largest error measured: 7.5e-9 in one
step, at |x| ~ 0.1) and the loss to rtol 1e-6 (measured: 1.1e-7).

bf16 (the card's compute dtype): the products round to bf16 at the same
points in both, but XLA and PyTorch may accumulate the bf16 products and
sums in other orders, so a delta may land one bf16 ulp apart; the tables'
change is held to 2^-7 (two bf16 ulps) of its own largest magnitude, and
the loss to rtol 1e-2 (measured on the CPU: equal bit for bit).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.models import word2vec as jw2v
from multiverso_tpu_torch.models import word2vec as tw2v

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
