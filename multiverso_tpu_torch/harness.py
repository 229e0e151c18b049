"""Integration battery: the reference ``Test/main.cpp`` dispatcher as a
runnable module (port of ``multiverso_tpu/harness.py``).

The reference builds one binary whose argv[1] selects a test and runs it
under ``mpirun -np N``: the MPI world is the fixture (ref
Test/main.cpp:497-518; the Docker CI battery runs kv/array/net/ip/
checkpoint/restore/allreduce at np=4, ref deploy/docker/Dockerfile). Here
the same battery runs as::

    python -m multiverso_tpu_torch.harness <cmd> [<cmd> ...] [-key=value ...]

with cmd in {kv, array, net, ip, matrix, checkpoint, restore, allreduce,
async, ftrl_sparse, readers, dense_perf, sparse_perf, all}. It runs on the
card unless ``-device=cpu`` asks for the CPU. ``-nprocs=N`` relaunches
the chosen tests as N processes on this host, started as a launcher
starts them (``MASTER_ADDR``/``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``/``LOCAL_WORLD_SIZE``), which join one world through
``net_init``'s TCPStore and run every chosen test in order; ranks on one
card meet over gloo. Inside each process the battery is the same code,
so single- and multi-process behavior are asserted alike.

Every test asserts its expected values and prints one ``HARNESS PASS
<cmd>`` line on success (rank 0), and ``HARNESS TIME <cmd> <seconds>``
beside it. A relaunched process that fails or outlives ``-timeout_s``
makes the parent exit non-zero, naming the rank.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

from multiverso_tpu_torch.utils import config, log

config.define_int("nprocs", 1, "relaunch the battery as N processes of one "
                  "world (mpirun -np N analogue)")
config.define_string("coordinator", "", "internal: the TCPStore address "
                     "(host:port) of a relaunched battery process")
config.define_int("procid", -1, "internal: rank of a relaunched battery "
                  "process")
config.define_int("rows", 100_000, "num_row for the perf tests (ref default "
                  "1000000, Test/main.cpp:357)")
config.define_int("iters", 3, "outer iterations for array/matrix tests")
config.define_string("checkpoint_dir", "",
                     "where the checkpoint/restore battery writes ('' = "
                     "mv_harness_ckpt in the temporary directory); at "
                     "world > 1 each process's replica of the tables under "
                     "its own rank<r>/")
config.define_float("timeout_s", 600.0, "seconds a relaunched battery "
                    "process may run before the parent kills the world "
                    "and fails")

_DIST_UNAVAILABLE = 77   # the JAX harness's skip code


def _init(**kw):
    import multiverso_tpu_torch as mv
    mv.init(**kw)
    return mv


# --------------------------------------------------------------------------- #
# battery (each mirrors one Test/main.cpp entry)
# --------------------------------------------------------------------------- #
def test_kv() -> None:
    """ref TestKV (Test/main.cpp:31-83): get-miss is 0, add accumulates;
    multi-process: allreduce merges every worker's adds."""
    mv = _init()
    kv = mv.KVTable(name="harness_kv")
    assert kv.get([0])[0] == 0, "unwritten key must read 0"
    kv.add([0], [1])
    assert kv.get([0])[0] == 1
    merged = kv.allreduce()
    assert merged[0] == mv.size(), f"key 0 = {merged[0]} != size {mv.size()}"
    log.info("kv: key0=%s over %d processes", merged[0], mv.size())
    mv.shutdown()


def test_array() -> None:
    """ref TestArray (Test/main.cpp:85-124): sync mode, delta[i]=i, three adds
    per iter; after iter i the table holds 3*(i+1)*num_workers*delta."""
    mv = _init(sync=True)
    n = 500
    t = mv.create_table(mv.ArrayTableOption(n), name="harness_array")
    mv.barrier()
    delta = np.arange(n, dtype=np.float32)
    iters = config.get_flag("iters")
    for i in range(iters):
        for _ in range(3):
            t.add(delta)
        data = t.get()
        expect = delta * 3 * (i + 1) * mv.num_workers()
        np.testing.assert_allclose(data, expect, rtol=1e-6)
    log.info("array: %d iters verified (workers=%d)", iters, mv.num_workers())
    mv.shutdown()


def test_net() -> None:
    """ref TestNet (Test/main.cpp:126-200): raw transport echo. The
    transport is torch.distributed's collectives over the mesh's table
    axis (the Zoo's, or one over every process of the world when the Zoo
    keeps the default one-rank mesh): each rank holds its chunk of the
    message; all_gather returns the message, broadcast rank 0's chunk,
    all_reduce the chunks' sum."""
    mv = _init()
    from multiverso_tpu_torch.parallel import collectives as coll
    from multiverso_tpu_torch.parallel.mesh import Mesh

    zoo = mv.Zoo.get()
    axis = zoo.shard_axis()
    mesh = mv.mesh()
    if mesh.size != mv.size():
        mesh = Mesh({axis: mv.size()}, device=mv.device())
    n_shards = int(mesh.shape[axis])
    chunk = 4
    msg = np.arange(chunk * n_shards, dtype=np.float32)
    i = mesh.index(axis)
    mine = torch.from_numpy(msg[i * chunk:(i + 1) * chunk].copy()).to(
        mv.device())

    def host(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    # echo: the chunks gathered back unchanged
    np.testing.assert_allclose(host(coll.all_gather(mine, axis, mesh)), msg)
    # broadcast: every shard adopts shard 0's chunk
    np.testing.assert_allclose(host(coll.broadcast(mine, 0, axis, mesh)),
                               msg[:chunk])
    # allreduce: chunks sum across shards
    np.testing.assert_allclose(host(coll.all_reduce(mine, axis, mesh)),
                               msg.reshape(n_shards, chunk).sum(axis=0))
    log.info("net: gather/broadcast/allreduce echo over %d shards OK",
             n_shards)
    mv.shutdown()


def test_ip() -> None:
    """ref TestIP -> net::GetLocalIPAddress, which the reference implements
    for Windows only (src/util/net_util.cpp:70-74 is CHECK(false) on Linux).
    Topology discovery here is torch.distributed's world and the host's
    cards."""
    mv = _init()
    log.info("ip/topology: process %d/%d, %d local cards, on %s, mesh %s",
             mv.rank(), mv.size(), torch.cuda.device_count(), mv.device(),
             dict(mv.mesh().shape))
    assert mv.size() >= 1 and 0 <= mv.rank() < mv.size()
    mv.shutdown()


def test_matrix() -> None:
    """ref TestMatrix (Test/main.cpp:203-291): dense whole-table Add/Get plus
    row-batch Add/Get on rows {0,1,3,7}; after `count` rounds the expected
    value doubles on the row-batch rows. Also asserts the sparse stale-row
    protocol (ref matrix.cpp up_to_date bits) that TestMatrix exercises via
    is_sparse tables."""
    mv = _init(sync=True)
    num_row, num_col = 11, 64
    size = num_row * num_col
    t = mv.create_table(mv.MatrixTableOption(num_row, num_col),
                        name="harness_matrix")
    mv.barrier()
    v = [0, 1, 3, 7]
    delta = (np.arange(size, dtype=np.float32) + 1).reshape(num_row, num_col)
    w = mv.num_workers()
    iters = config.get_flag("iters")
    for count in range(1, iters + 1):
        t.add(delta)
        t.add_rows(v, delta[v])
        data = t.get()
        expect = delta * count * w
        expect[v] *= 2
        np.testing.assert_allclose(data, expect, rtol=1e-6)
        rows = t.get_rows(v)
        np.testing.assert_allclose(rows, expect[v], rtol=1e-6)

    # sparse stale-row protocol on the same shape
    st = mv.SparseMatrixTable(num_row, num_col, name="harness_sparse")
    all_rows = list(range(num_row))
    first = st.get_rows_sparse(all_rows, worker_id=0)
    np.testing.assert_allclose(first, 0.0)
    assert st.stale_fraction(all_rows, worker_id=0) == 0.0, \
        "everything fresh after a full pull"
    st.add_rows([2, 5], np.ones((2, num_col), np.float32))
    frac = st.stale_fraction(all_rows, worker_id=0)
    assert 0 < frac <= 2 / num_row + 1e-6, f"stale fraction {frac}"
    got = st.get_rows_sparse(all_rows, worker_id=0)
    np.testing.assert_allclose(got[2], w)
    np.testing.assert_allclose(got[5], w)
    log.info("matrix: %d rounds + sparse staleness verified (workers=%d)",
             iters, w)
    mv.shutdown()


def _checkpoint_dir(rank: int, size: int) -> str:
    d = config.get_flag("checkpoint_dir") or os.path.join(
        tempfile.gettempdir(), "mv_harness_ckpt")
    # every process keeps a replica of each table: each saves its own
    return d if size == 1 else os.path.join(d, f"rank{rank}")


def test_checkpoint(restore: bool = False) -> None:
    """ref TestCheckPoint (Test/main.cpp:292-330), and the MV_LoadTable
    resume API the reference planned but never landed (:302-316 comments):
    `restore` reloads table + updater state and training continues."""
    from multiverso_tpu_torch import checkpoint

    mv = _init()
    num_row, num_col = 11, 10
    size = num_row * num_col
    t = mv.MatrixTable(num_row, num_col, name="harness_ckpt")
    mv.barrier()
    delta = np.arange(size, dtype=np.float32).reshape(num_row, num_col)
    ckpt_dir = _checkpoint_dir(mv.rank(), mv.size())
    w = mv.num_workers()
    if not restore:
        for _ in range(50):
            t.add(delta)
        checkpoint.save(ckpt_dir, tag="harness")
        np.testing.assert_allclose(t.get(), delta * 50 * w, rtol=1e-6)
        log.info("checkpoint: 50 adds stored to %s", ckpt_dir)
    else:
        n = checkpoint.restore(ckpt_dir, tag="harness")
        assert n >= 1, "no tables restored"
        np.testing.assert_allclose(t.get(), delta * 50 * w, rtol=1e-6)
        t.add(delta)  # resume: training continues on restored state
        np.testing.assert_allclose(t.get(), delta * (50 * w + w), rtol=1e-6)
        log.info("restore: state verified, training resumed")
    mv.shutdown()


def test_allreduce() -> None:
    """ref TestAllreduce (Test/main.cpp:331-339): -ma mode MV_Aggregate."""
    prev_ma = config.get_flag("ma")
    config.set_flag("ma", True)
    try:
        mv = _init()
        a = np.ones(1, dtype=np.float32)
        mv.aggregate(a)
        assert a[0] == mv.size(), f"aggregate: {a[0]} != {mv.size()}"
        log.info("allreduce: a = %s (size %d)", a[0], mv.size())
        mv.shutdown()
    finally:
        config.set_flag("ma", prev_ma)  # don't poison later battery entries


def _perf(sparse: bool) -> None:
    """ref TestmatrixPerformance (Test/main.cpp:340-452): get-all, add a
    growing fraction of rows, get-all again, verify, Dashboard dump."""
    from multiverso_tpu_torch.utils.dashboard import Dashboard

    mv = _init()
    num_row, num_col = config.get_flag("rows"), 50
    wid, wnum = mv.worker_id(), mv.num_workers()
    delta = np.arange(num_row * num_col,
                      dtype=np.float32).reshape(num_row, num_col)
    for percent in range(0, 10, 3):
        cls = mv.SparseMatrixTable if sparse else mv.MatrixTable
        t = cls(num_row, num_col, name=f"perf_{percent}")
        mv.barrier()

        t0 = time.perf_counter()
        data = (t.get_rows_sparse(range(num_row), worker_id=wid)
                if sparse else t.get())
        log.info("%.3fs: get all rows first time (worker %d)",
                 time.perf_counter() - t0, wid)

        # ref splits rows across workers (i % worker_num == worker_id);
        # collective add_rows needs identical id sets per process, so every
        # worker pushes the full fraction and the sum scales by num_workers
        rows = [i for i in range(num_row) if i % 10 <= percent]
        if rows:
            t.add_rows(rows, delta[rows])
        mv.barrier()

        t0 = time.perf_counter()
        data = (t.get_rows_sparse(range(num_row), worker_id=wid)
                if sparse else t.get())
        log.info("%.3fs: get all rows after adding %d0%% (worker %d)",
                 time.perf_counter() - t0, percent + 1, wid)

        touched = np.zeros(num_row, bool)
        touched[rows] = True
        np.testing.assert_allclose(data[touched], delta[touched] * wnum,
                                   rtol=1e-6)
        np.testing.assert_allclose(data[~touched], 0.0)
    Dashboard.display(log.info)
    mv.shutdown()


def test_async() -> None:
    """Uncoordinated async-PS plane (no reference analogue in Test/main.cpp;
    the reference could only exercise async through full apps): per-worker
    disjoint row sets at per-worker rates over PSService shards, plus
    hash-sharded KV."""
    mv = _init()
    rank, world = mv.rank(), mv.size()
    t = mv.AsyncMatrixTable(8 * max(world, 1), 4, name="harness_async")
    kv = mv.AsyncKVTable(name="harness_async_kv")
    my_rows = np.arange(8) * max(world, 1) + rank
    for i in range(rank + 1):
        t.add_rows(my_rows, np.ones((8, 4), np.float32))
        kv.add([rank], [1.0])
    t.flush()
    mv.barrier()   # determinism fence for the asserts, not the plane
    got = t.get_rows(np.arange(8 * max(world, 1)))
    total = float(got.sum())
    expect = sum((r + 1) for r in range(world)) * 8 * 4
    assert total == expect, (total, expect)
    counts = kv.get()
    assert counts == {r: float(r + 1) for r in range(world)}, counts
    log.info("async: %d workers, row mass %.0f, kv %s", world, total, counts)
    mv.shutdown()


def test_ftrl_sparse() -> None:
    """Hash-sharded sparse keys + FTRL z/n on the uncoordinated plane (ref
    Applications/LogisticRegression/src/util/{sparse_table,
    ftrl_sparse_table}.h; no Test/main.cpp analogue: the reference never
    exercised its sparse tables outside the LR app)."""
    mv = _init()
    rank, world = mv.rank(), mv.size()
    from multiverso_tpu_torch.ps.tables import AsyncSparseKVTable
    t = AsyncSparseKVTable(4, updater="ftrl", name="harness_ftrl")
    keys = np.array([7, 1_000_003, 1_000 + rank])  # shared + per-rank keys
    for _ in range(10):
        t.add_rows(keys, np.full((3, 4), 0.5, np.float32))
    t.flush()
    mv.barrier()   # determinism fence for the asserts, not the plane
    w = t.get_rows([7, 1_000_003])
    # steady +g gradients push the FTRL weight negative once |z| > lambda1
    assert np.all(w < 0) and np.all(np.isfinite(w)), w
    per_rank = t.get_rows([1_000 + r for r in range(world)])
    assert np.all(per_rank < 0), per_rank
    fresh = t.get_rows([555])
    np.testing.assert_allclose(fresh, 0.0)   # untouched key = empty state
    log.info("ftrl_sparse: %d workers, shared w[0]=%.4f", world,
             float(w[0, 0]))
    mv.shutdown()


def test_readers() -> None:
    """Weighted + binary-sparse reader variants end-to-end (ref
    reader.h:96-114 WeightedSampleReader, :118-146 BSparseSampleReader):
    every rank writes its own weighted-text and binary shard of the same
    synthetic samples, reads both back through SampleReader, asserts the
    parsed batches agree bit-for-bit, and pushes its sample mass to a
    shared async KV table so the asserts span ranks."""
    from multiverso_tpu_torch.io.sample_reader import (SampleReader,
                                                       write_bsparse_sample)
    mv = _init()
    rank, world = mv.rank(), mv.size()
    rng = np.random.default_rng(100 + rank)
    dim, n = 32, 12
    samples = [(int(rng.integers(0, 2)),
                np.unique(rng.integers(0, dim, 5)),
                float(rng.uniform(0.5, 2.0)))
               for _ in range(n)]
    with tempfile.TemporaryDirectory(prefix="mv_readers_") as d:
        wpath, bpath = f"{d}/w_{rank}.txt", f"{d}/b_{rank}.bin"
        with open(wpath, "w") as f:
            for label, keys, w in samples:
                f.write(f"{label}:{w} "
                        + " ".join(f"{k}:1.0" for k in keys) + "\n")
        with open(bpath, "wb") as f:
            for label, keys, w in samples:
                write_bsparse_sample(f, label, keys, w)
        wbatches = list(SampleReader(wpath, dim, 4, fmt="weight"))
        bbatches = list(SampleReader(bpath, dim, 4, fmt="bsparse"))
    assert len(wbatches) == len(bbatches) == 3, len(wbatches)
    mass = 0.0
    for (wx, wy, wk), (bx, by, bk) in zip(wbatches, bbatches):
        np.testing.assert_allclose(wx, bx)     # weight folded into values
        np.testing.assert_array_equal(wy, by)
        np.testing.assert_array_equal(wk, bk)  # same active-key sets
        mass += float(wx.sum())
    kv = mv.AsyncKVTable(name="harness_readers")
    kv.add([rank], [round(mass, 3)])
    mv.barrier()
    counts = kv.get()
    assert set(counts) == set(range(world)) and all(
        v > 0 for v in counts.values()), counts
    log.info("readers: %d ranks, weighted==bsparse, mass %s", world, counts)
    mv.shutdown()


def test_dense_perf() -> None:
    _perf(sparse=False)


def test_sparse_perf() -> None:
    _perf(sparse=True)


_TESTS = {
    "kv": test_kv,
    "array": test_array,
    "net": test_net,
    "ip": test_ip,
    "matrix": test_matrix,
    "checkpoint": lambda: test_checkpoint(False),
    "restore": lambda: test_checkpoint(True),
    "allreduce": test_allreduce,
    "async": test_async,
    "ftrl_sparse": test_ftrl_sparse,
    "readers": test_readers,
    "dense_perf": test_dense_perf,
    "sparse_perf": test_sparse_perf,
}
# the Docker CI battery order (deploy/docker/Dockerfile) + the async plane
_ALL = ["kv", "array", "net", "ip", "matrix", "checkpoint", "restore",
        "allreduce", "async", "ftrl_sparse", "readers"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_cluster(names: List[str], nprocs: int, extra: List[str]) -> int:
    """Relaunch this harness as ``nprocs`` processes of one world (the
    mpirun analogue), each running ``names`` in order. Returns 0, or 1
    after naming every rank that failed or outlived ``timeout_s`` (the
    others are then killed)."""
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = dict(os.environ)
    base["PYTHONPATH"] = repo + os.pathsep + base.get("PYTHONPATH", "")
    base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                WORLD_SIZE=str(nprocs), LOCAL_WORLD_SIZE=str(nprocs))
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "multiverso_tpu_torch.harness", *names,
             f"-coordinator=127.0.0.1:{port}", f"-nprocs={nprocs}",
             f"-procid={r}", *extra],
            env=dict(base, RANK=str(r), LOCAL_RANK=str(r)))
        for r in range(nprocs)]
    deadline = time.monotonic() + config.get_flag("timeout_s")
    failed = []
    try:
        for r, p in enumerate(procs):
            try:
                code = p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                log.error("battery process %d timed out after %.0f s", r,
                          config.get_flag("timeout_s"))
                failed.append(r)
                break
            if code != 0:
                log.error("battery process %d failed (rc=%d)", r, code)
                failed.append(r)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return 1 if failed else 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cmds = [a for a in argv if not a.startswith("-")]
    flags = [a for a in argv if a.startswith("-")]
    config.parse_cmd_flags(["prog", *flags])

    if not cmds:
        # ref: argc==1 -> bare MV_Init/MV_ShutDown smoke (Test/main.cpp:500)
        mv = _init()
        mv.shutdown()
        print("HARNESS PASS init")
        return 0
    names = _ALL if cmds == ["all"] else cmds
    unknown = [n for n in names if n not in _TESTS]
    if unknown:
        log.error("unknown battery test %r (have: %s)", unknown[0],
                  " ".join(sorted(_TESTS)))
        return 2

    nprocs = config.get_flag("nprocs")
    procid = config.get_flag("procid")
    if nprocs > 1 and procid < 0:
        rc = _spawn_cluster(names, nprocs,
                            [f for f in flags if not f.startswith(
                                ("-nprocs", "-procid", "-coordinator"))])
        if rc:
            return rc
        for name in names:
            print(f"HARNESS PASS {name} (nprocs={nprocs})", flush=True)
        return 0

    if procid >= 0:  # a process of _spawn_cluster's world
        import torch.distributed as dist
        if not dist.is_available():
            log.error("torch.distributed unavailable")
            return _DIST_UNAVAILABLE
        from multiverso_tpu_torch.api import net_init
        if net_init(config.get_flag("coordinator") or None, nprocs,
                    procid) != 0:
            return 1

    for name in names:
        t0 = time.perf_counter()
        _TESTS[name]()
        if procid <= 0:
            print(f"HARNESS PASS {name}", flush=True)
            print(f"HARNESS TIME {name} {time.perf_counter() - t0:.3f}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
