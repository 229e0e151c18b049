"""Port parity, ``telemetry/hotkeys.py``: the port's Space-Saving sketch
against the JAX package's on the same streams — the same counts, errors,
order and top-k, exactly (both are integer counters over the same
sequence of offers) — the sketch's own guarantees (after
``tests/test_cluster_obs.py``), and the shards' hooks: a port shard and a
JAX shard fed the same gets and adds report the same ``stats()["hotkeys"]``.
"""

import json
import time

import numpy as np
import pytest

from multiverso_tpu.ps import service as jsvc
from multiverso_tpu.ps import tables as jtables
from multiverso_tpu.telemetry import hotkeys as jhot
from multiverso_tpu.utils import config as jconfig
from multiverso_tpu_torch.ps import service as tsvc
from multiverso_tpu_torch.ps import tables as ttables
from multiverso_tpu_torch.telemetry import hotkeys as thot
from multiverso_tpu_torch.utils import config as tconfig


def _streams():
    rng = np.random.default_rng(42)
    return {"zipf": rng.zipf(1.3, size=20_000),
            "uniform": rng.integers(0, 3_000, 20_000),
            "batches": rng.zipf(1.2, size=40_000) % 5_000}


@pytest.mark.parametrize("name", ["zipf", "uniform", "batches"])
@pytest.mark.parametrize("capacity", [16, 256])
def test_sketch_matches_jax(name, capacity):
    stream = _streams()[name]
    tsk, jsk = thot.SpaceSaving(capacity), jhot.SpaceSaving(capacity)
    if name == "batches":
        # batches above BATCH_SAMPLE are stride-sampled, the phase
        # rotating batch by batch; offsets shift local ids to global ones
        rng = np.random.default_rng(1)
        pos = 0
        while pos < stream.size:
            n = int(rng.integers(1, 3 * thot.BATCH_SAMPLE))
            for sk in (tsk, jsk):
                sk.observe(stream[pos:pos + n], offset=7)
            pos += n
    else:
        for v in stream.tolist():
            tsk.offer(int(v))
            jsk.offer(int(v))
    assert thot.BATCH_SAMPLE == jhot.BATCH_SAMPLE
    assert tsk.items() == jsk.items()
    assert tsk.top(10) == jsk.top(10)
    assert (tsk.total, tsk.observed) == (jsk.total, jsk.observed)
    assert tsk.to_dict() == jsk.to_dict()
    for conservative in (False, True):
        assert (thot.hit_rate_curve(tsk.to_dict(), conservative=conservative)
                == jhot.hit_rate_curve(jsk.to_dict(),
                                       conservative=conservative))


def test_merge_matches_jax():
    rng = np.random.default_rng(3)
    dicts = []
    for i in range(3):
        sk = thot.SpaceSaving(32)
        sk.observe(rng.zipf(1.4, size=900) % 200 + 100 * i)
        dicts.append(sk.to_dict())
    for cap in (None, 8):
        assert (thot.merge_sketches(dicts + [None], capacity=cap)
                == jhot.merge_sketches(dicts + [None], capacity=cap))


def test_exact_below_capacity():
    sk = thot.SpaceSaving(16)
    for k in [1, 1, 1, 2, 2, 7]:
        sk.offer(k)
    assert sk.items()[0] == (1, 3, 0)
    assert dict((k, c) for k, c, _ in sk.items()) == {1: 3, 2: 2, 7: 1}
    assert sk.total == 6


def test_zipf_topk_recall_and_bounds():
    """Top-20 recall >= 0.9 against exact counts, memory bounded at the
    capacity, and count - err <= true frequency <= count."""
    stream = np.random.default_rng(42).zipf(1.3, size=60_000)
    sk = thot.SpaceSaving(256)
    for v in stream.tolist():
        sk.offer(int(v))
    assert len(sk) <= 256 and len(sk._heap) <= 256
    keys, counts = np.unique(stream, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    exact_top = {int(keys[i]) for i in order[:20]}
    assert len(exact_top & {k for k, _, _ in sk.top(20)}) / 20 >= 0.9
    true = {int(k): int(c) for k, c in zip(keys, counts)}
    for key, count, err in sk.items():
        assert count - err <= true.get(key, 0) <= count


def test_big_batches_are_sampled_at_the_stride_weight():
    sk = thot.SpaceSaving(8)
    t0 = time.perf_counter()
    sk.observe(np.arange(100_000, dtype=np.int64))
    assert time.perf_counter() - t0 < 0.5
    assert sk.observed == 100_000
    assert abs(sk.total - 100_000) <= thot.BATCH_SAMPLE
    sk2 = thot.SpaceSaving(8)
    sk2.observe(np.array([0, 1, 0]), offset=100)
    assert sk2.items()[0][0] == 100
    d = sk2.to_dict()
    json.dumps(d)
    assert d["items"][0][:2] == [100, 2]


def test_capacity_must_be_positive():
    with pytest.raises(ValueError):
        thot.SpaceSaving(0)


def test_shard_sketch_matches_jax(tmp_path):
    """The hooks: the same row gets and adds against a port world and a
    JAX world (2 ranks each) leave the same sketch on every shard."""
    for cfg in (tconfig, jconfig):
        cfg.set_flag("ps_timeout", 5.0)
        cfg.set_flag("hotkeys_capacity", 64)
    jconfig.set_flag("ps_native", False)
    trdv = tsvc.FileRendezvous(str(tmp_path / "t"))
    jrdv = jsvc.FileRendezvous(str(tmp_path / "j"))
    tctx = [tsvc.PSContext(r, 2, tsvc.PSService(r, 2, trdv), device="cpu")
            for r in range(2)]
    jctx = [jsvc.PSContext(r, 2, jsvc.PSService(r, 2, jrdv))
            for r in range(2)]
    try:
        tt = [ttables.AsyncMatrixTable(300, 2, name="hk", ctx=c)
              for c in tctx]
        jt = [jtables.AsyncMatrixTable(300, 2, name="hk", ctx=c)
              for c in jctx]
        rng = np.random.default_rng(8)
        for step in range(30):
            ids = rng.zipf(1.3, size=int(rng.integers(1, 700))) % 300
            vals = np.ones((ids.size, 2), np.float32)
            for t in (tt[step % 2], jt[step % 2]):
                if step % 3:
                    t.get_rows(ids)
                else:
                    t.add_rows(ids, vals)
        for r in range(2):
            got = tt[r]._shard.stats()["hotkeys"]
            want = jt[r]._shard.stats()["hotkeys"]
            assert got == want and got["total"] > 0
        tkv = [ttables.AsyncSparseKVTable(2, name="kvh", ctx=c)
               for c in tctx]
        jkv = [jtables.AsyncSparseKVTable(2, name="kvh", ctx=c)
               for c in jctx]
        keys = np.array([10**9 + 1, 5, 5, 77, 10**9 + 1, 5])
        for t in (tkv[0], jkv[0]):
            t.add_rows(keys, np.ones((keys.size, 2), np.float32))
            t.get_rows(keys)
        for r in range(2):
            assert (tkv[r]._shard.stats()["hotkeys"]
                    == jkv[r]._shard.stats()["hotkeys"])
    finally:
        for c in tctx + jctx:
            c.close()
        tconfig.reset_flags()
        jconfig.set_flag("hotkeys_capacity", 128)
