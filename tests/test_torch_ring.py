"""Port parity, ``multiverso_tpu_torch/parallel/ring.py``: ring, zigzag and
Ulysses attention on four gloo CPU ranks against ``multiverso_tpu``'s on a
JAX mesh of the same shape: the sequence axis alone (sp=4), (dp, sp) and
(tp, sp) with the heads sharded. Each rank gets its block of the same
numpy q/k/v; the blocks of the output and of its gradients (of
sum(o * r) for a fixed r) are put back together and held to the JAX
global arrays.

Tolerances: f32 forward within 2e-5 absolute; gradients within 1e-4
relative to the largest gradient of the array (the online softmax folds
the blocks in the same order in both packages; only the einsums' sums
may differ in order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

from multiverso_tpu.parallel import ring as jring
from multiverso_tpu_torch.parallel import ring as tring
from torch_mesh_worker import World, assemble

WORLD = 4
ATOL_OUT = 2e-5
RTOL_GRAD = 1e-4


@pytest.fixture(scope="module")
def world():
    w = World(WORLD)
    yield w
    w.close()


def _jmesh(shape):
    devs = np.asarray(jax.devices()[:WORLD]).reshape([n for _, n in shape])
    return Mesh(devs, tuple(a for a, _ in shape))


def _qkvr(b, h, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, s, d)).astype(np.float32)
            for _ in range(4)]


def _jax_run(kind, shape, q, k, v, r, causal, batch_axis, head_axis):
    jm = _jmesh(shape)
    spec = JP(batch_axis, head_axis, "sp", None)
    put = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(jm, spec))

    def f(q, k, v):
        if kind == "ring":
            o = jring.ring_attention(q, k, v, "sp", jm, causal=causal,
                                     batch_axis=batch_axis,
                                     head_axis=head_axis)
        elif kind == "zigzag":
            o = jring.zigzag_ring_attention(q, k, v, "sp", jm,
                                            batch_axis=batch_axis,
                                            head_axis=head_axis)
        else:
            o = jring.ulysses_attention(q, k, v, "sp", jm, causal=causal,
                                        batch_axis=batch_axis)
        return o

    qa, ka, va = put(q), put(k), put(v)
    out = f(qa, ka, va)
    grads = jax.grad(lambda q, k, v: jnp.sum(f(q, k, v) * jnp.asarray(r)),
                     argnums=(0, 1, 2))(qa, ka, va)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


CASES = [
    # (kind, mesh, causal, batch_axis, head_axis, heads)
    ("ring", [("sp", 4)], True, None, None, 2),
    ("ring", [("sp", 4)], False, None, None, 2),
    ("ring", [("dp", 2), ("sp", 2)], True, "dp", None, 2),
    ("ring", [("tp", 2), ("sp", 2)], True, None, "tp", 4),
    ("zigzag", [("sp", 4)], True, None, None, 2),
    ("zigzag", [("dp", 2), ("sp", 2)], True, "dp", None, 2),
    ("zigzag", [("tp", 2), ("sp", 2)], True, None, "tp", 4),
    ("ulysses", [("sp", 4)], True, None, None, 4),
    ("ulysses", [("dp", 2), ("sp", 2)], True, "dp", None, 2),
    ("ulysses", [("sp", 4)], False, None, None, 4),
]


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{c[0]}-{'x'.join(a for a, _ in c[1])}-"
                              f"{'causal' if c[2] else 'full'}"
                              for c in CASES])
def test_attention_and_grads_match_jax(world, case):
    kind, shape, causal, batch_axis, head_axis, h = CASES[case]
    q, k, v, r = _qkvr(2, h, 32, 8, seed=case)
    if kind == "zigzag":
        n = dict(shape)["sp"]
        perm = tring.zigzag_shard_ids(32, n)
        np.testing.assert_array_equal(perm, np.asarray(
            jring.zigzag_shard_ids(32, n)))
        q, k, v, r = (a[:, :, perm] for a in (q, k, v, r))
    world.submit("ring_attn", shape=shape, kind=kind, q=q, k=k, v=v,
                 r=r, causal=causal, seq_axis="sp", batch_axis=batch_axis,
                 head_axis=head_axis)
    want = _jax_run(kind, shape, q, k, v, r, causal, batch_axis, head_axis)
    got = world.collect()
    for j, name in enumerate(("out", "dq", "dk", "dv")):
        full = assemble([g[j] for g in got], q.shape)
        if j == 0:
            np.testing.assert_allclose(full, want[0], rtol=0, atol=ATOL_OUT,
                                       err_msg=name)
        else:
            scale = np.abs(want[j]).max()
            np.testing.assert_allclose(full, want[j], rtol=0,
                                       atol=RTOL_GRAD * scale, err_msg=name)


def test_ring_matches_the_unsharded_oracle(world):
    """The global oracle: the gathered ring output equals
    reference_attention on the whole sequence (both packages')."""
    q, k, v, r = _qkvr(1, 2, 64, 8, seed=9)
    got = world.run("ring_attn", shape=[("sp", 4)], kind="ring", q=q, k=k,
                    v=v, r=r, causal=True)
    full = assemble([g[0] for g in got], q.shape)
    import torch
    ref = tring.reference_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=True).numpy()
    np.testing.assert_allclose(full, ref, rtol=0, atol=ATOL_OUT)


def test_sequence_shard_is_the_rank_block(world):
    x = np.arange(2 * 2 * 16 * 3, dtype=np.float32).reshape(2, 2, 16, 3)
    got = world.run("seq_shard", shape=[("dp", 2), ("sp", 2)], x=x,
                    axis="sp")
    for rank, g in enumerate(got):
        i = rank % 2     # the sp index of rank r on a (dp, sp) mesh
        np.testing.assert_array_equal(g, x[:, :, i * 8:(i + 1) * 8])


def test_validation_matches_jax():
    with pytest.raises(ValueError, match="2n"):
        tring.zigzag_shard_ids(30, 4)
    with pytest.raises(ValueError, match="2n"):
        jring.zigzag_shard_ids(30, 4)
