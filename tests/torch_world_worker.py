"""One rank of a multi-process world of ``multiverso_tpu_torch`` (the
port's counterpart of ``tests/multiprocess_worker.py``). Imports no jax.

Started the way a launcher starts a rank: ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` in the environment; the rank
joins its world with ``net_init()``, which reads them.

    python tests/torch_world_worker.py scenario [--device cpu]
        [--ckpt DIR]
    python tests/torch_world_worker.py seeded --seed S [--device cpu]
        [--ckpt DIR]

``scenario`` runs ``tests/multiprocess_worker.py``'s steps; ``seeded``
runs the seeded cases that ``tests/jax_world_worker.py`` runs in the JAX
package (inputs from :func:`seeded_inputs`, shared by both), then the
port's own: row reads with each rank's own ids, the sparse protocol with
one worker id on every rank and, with ``--ckpt``, a checkpoint saved by
the sharded world and the restore of a one-process one
(:func:`one_process_checkpoint`). With ``--ckpt`` both modes then run
:func:`sharded_checkpoint` (``backend="orbax"``; a world of 2 and one of
4 each restore the other's tag). Each prints one ``RESULT <json>`` line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

# the JAX scenario's keys whose values differ by design: the JAX worker
# runs 2 CPU devices a process and meets its PS peers through the
# jax.distributed coordinator's store
BY_DESIGN = ("devices", "num_servers", "rendezvous")
# the port's scenario keys that the JAX worker does not print (the
# sharded checkpoint's only with --ckpt)
PORT_ONLY = ("layout", "sharded")


def closed_forms(nprocs: int) -> Dict:
    """The values every rank's scenario must give
    (``tests/test_multiprocess.py``), keyed as its ``RESULT``."""
    tri = nprocs * (nprocs + 1) / 2   # the sum of each rank's (rank + 1)
    kv = {str(k): 10.0 * (nprocs - k) for k in range(nprocs)}
    return {
        "size": nprocs, "num_workers": nprocs,
        "aggregate": [tri] * 4,
        "kv": kv, "kv_global": kv,
        "matrix_rows": [[tri] * 4, [tri] * 4],
        "matrix_union": [float((k + 1 if k < nprocs else 0)
                               + (k if k >= 1 else 0))
                         for k in range(nprocs + 1)],
        "sparse_union": [1.0] * nprocs + [0.0],
        "async_row_sum": 8 * 4 * tri,
        "sharedvar": [float(nprocs)] * 4,
    }


def layout(table) -> Dict:
    """Where this rank's part of ``table`` lives: the rows of its data
    tensor and of each row-shaped updater-state leaf (and of a sparse
    table's dirty bits), the padded rows, the block count and the range
    ``Table.sharding`` reports."""
    sh = table.sharding
    out = {"data_rows": int(table.state["data"].shape[0]),
           "padded_rows": int(table.padded_shape[0]),
           "num_shards": sh.num_shards, "axis": sh.axis,
           "rows": list(sh.rows),
           "ustate_rows": {k: int(v.shape[0]) for k, v in
                           sorted(table.state["ustate"].items())
                           if v.dim() > 0}}
    dirty = getattr(table, "_dirty", None)
    if dirty is not None:
        out["dirty_shape"] = list(dirty.shape)
    return out


def scenario(device) -> Dict:
    """``tests/multiprocess_worker.py``'s steps on a world already joined,
    with the tables on ``device``; returns its ``RESULT`` dict."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.ps import AsyncMatrixTable
    from multiverso_tpu_torch.ps.service import StoreRendezvous
    from multiverso_tpu_torch.sharedvar import mv_shared

    mv.init(device=device)
    pid, nprocs = mv.rank(), mv.size()
    out = {"rank": pid, "size": nprocs, "num_workers": mv.num_workers(),
           "num_servers": mv.num_servers(),
           # the devices the tables live on: one a process
           "devices": nprocs}
    mv.barrier()

    # aggregate: each process contributes rank+1
    data = np.full(4, float(pid + 1), np.float32)
    out["aggregate"] = mv.aggregate(data).tolist()

    # KV: the aggregated Get is repeatable and leaves the local store to
    # allreduce() to commit
    kv = mv.KVTable(name="mp_kv")
    kv.add(list(range(pid + 1)), [10] * (pid + 1))
    gview = kv.get(global_=True)
    assert kv.get(global_=True) == gview
    out["kv_global"] = {str(k): float(v) for k, v in sorted(gview.items())}
    merged = kv.allreduce()
    out["kv"] = {str(k): float(v) for k, v in sorted(merged.items())}

    # collective row add: the same ids everywhere, values summed
    mt = mv.MatrixTable(16, 4, name="mp_matrix")
    mt.add_rows([1, 3], np.full((2, 4), float(pid + 1), np.float32))
    out["matrix_rows"] = mt.get_rows([1, 3]).tolist()

    # other id sets a process: the union
    mt2 = mv.MatrixTable(16, 4, name="mp_matrix_union")
    mt2.add_rows([pid, pid + 1], np.full((2, 4), float(pid + 1),
                                         np.float32))
    out["matrix_union"] = mt2.get_rows(list(range(nprocs + 1)))[:, 0].tolist()

    # the sparse protocol's dirty bits cover the union
    smt = mv.SparseMatrixTable(nprocs + 1, 4, name="mp_sparse_union",
                               num_workers=nprocs)
    ada = mv.ArrayTable(4 * nprocs + 3, updater="adagrad",
                        name="mp_layout_adagrad")
    out["layout"] = {t.name: layout(t) for t in (mt, mt2, smt, ada)}
    all_rows = list(range(nprocs + 1))
    smt.get_rows_sparse(all_rows, worker_id=pid)       # warm the cache
    smt.add_rows([pid], np.ones((1, 4), np.float32))   # union ids
    out["sparse_union"] = smt.get_rows_sparse(
        all_rows, worker_id=pid)[:, 0].tolist()

    # the async plane over the world's store: each rank pushes its own
    # disjoint rows at its own pace
    at = AsyncMatrixTable(8 * nprocs, 4, name="mp_async_jx")
    rdv = at.ctx.service._rendezvous
    out["rendezvous"] = type(rdv).__name__ if rdv is not None else None
    if nprocs > 1:
        assert isinstance(rdv, StoreRendezvous), rdv
        rdv.publish(1000 + pid, f"probe:{pid}")
        assert rdv.lookup(1000 + ((pid + 1) % nprocs), 20.0) == (
            f"probe:{(pid + 1) % nprocs}")
    my_rows = np.arange(8) * nprocs + pid
    for _ in range(pid + 1):
        at.add_rows(my_rows, np.ones((8, 4), np.float32))
    at.flush()
    mv.barrier()   # every push landed
    out["async_row_sum"] = float(at.get_rows(np.arange(8 * nprocs)).sum())

    # shared variables: every worker adds 1; after the sync the value has
    # every worker's delta
    shared = mv_shared({"w": np.zeros(4, np.float32)}, name="mp_shared")
    local = shared.get()
    local["w"] = local["w"] + 1.0
    shared.sync(local)
    mv.barrier()
    out["sharedvar"] = shared.get()["w"].tolist()
    mv.shutdown()
    return out


# ---------------------------------------------------------------------- #
# seeded cases (world 2), the same in both packages
# ---------------------------------------------------------------------- #
SEEDED_ROWS, SEEDED_COLS = 24, 6
SEEDED_ARRAY = 40
SEEDED_ADAGRAD = dict(learning_rate=0.5, rho=0.1)
SEEDED_LR_SEED = 5   # the fused LogReg epoch's blobs


def seeded_inputs(seed: int, rank: int) -> Dict:
    """This rank's numpy inputs for the seeded cases: row ids that repeat
    within a rank and overlap across ranks, deltas, KV adds, a
    non-contiguous aggregate and a shared tree."""
    rng = np.random.default_rng([seed, rank])
    rows = [rng.integers(0, SEEDED_ROWS // 2 + 4 * rank,
                         size=int(rng.integers(3, 12)))
            for _ in range(3)]
    return {
        "rows": [r.tolist() for r in rows],
        "row_vals": [rng.normal(size=(r.size, SEEDED_COLS)).astype(
            np.float32) for r in rows],
        "array": [rng.normal(size=SEEDED_ARRAY).astype(np.float32)
                  for _ in range(3)],
        "kv_keys": rng.integers(0, 12, size=7).tolist(),
        "kv_vals": rng.integers(1, 100, size=7).tolist(),
        "sparse_rows": sorted(set(rng.integers(
            0, SEEDED_ROWS, size=5).tolist())),
        "sparse_vals": rng.normal(size=(5, SEEDED_COLS)).astype(np.float32),
        "agg": rng.normal(size=(4, 6)).astype(np.float32),
        "shared": {"a": rng.normal(size=(3, 2)).astype(np.float32),
                   "b": rng.normal(size=5).astype(np.float32)},
        "shared_step": {"a": rng.normal(size=(3, 2)).astype(np.float32),
                        "b": rng.normal(size=5).astype(np.float32)},
    }


def seeded(seed: int, device, ckpt: str = "") -> Dict:
    """The seeded cases on a world of 2 already joined; returns every
    table's state as lists."""
    import torch

    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.sharedvar import mv_shared
    from multiverso_tpu_torch.updaters import AddOption

    mv.init(device=device)
    rank = mv.rank()
    x = seeded_inputs(seed, rank)
    out: Dict = {}
    ada = AddOption(**SEEDED_ADAGRAD)
    for upd, opt in (("default", None), ("adagrad", ada)):
        t = mv.MatrixTable(SEEDED_ROWS, SEEDED_COLS, updater=upd, seed=7,
                           init_scale=0.5, name=f"seeded_rows_{upd}")
        for ids, vals in zip(x["rows"], x["row_vals"]):
            t.add_rows(ids, vals, opt)
        out[f"rows_{upd}"] = t.get().tolist()
    # whole-table adds: numpy deltas, the same as tensors (each a rank's
    # contribution), SGD, and the bf16 wire
    for name, kw, as_tensor in (("array", {}, False),
                                ("array_tensor", {}, True),
                                ("array_sgd", {"updater": "sgd"}, False),
                                ("array_bf16", {"wire_filter": "bf16"},
                                 False)):
        t = mv.ArrayTable(SEEDED_ARRAY, name=f"seeded_{name}", **kw)
        for d in x["array"]:
            t.add(torch.from_numpy(d).to(mv.device()) if as_tensor else d)
        out[name] = t.get().tolist()
    kv = mv.KVTable(name="seeded_kv")
    kv.add(x["kv_keys"], x["kv_vals"])
    out["kv_global"] = {str(k): float(v) for k, v in
                        sorted(kv.get(global_=True).items())}
    out["kv_local"] = {str(k): float(v) for k, v in sorted(kv.get().items())}
    smt = mv.SparseMatrixTable(SEEDED_ROWS, SEEDED_COLS, seed=3,
                               init_scale=0.5, name="seeded_sparse",
                               num_workers=2)
    every = list(range(SEEDED_ROWS))
    out["sparse_before"] = smt.get_rows_sparse(every, worker_id=rank).tolist()
    smt.add_rows(x["sparse_rows"], x["sparse_vals"][:len(x["sparse_rows"])])
    out["sparse_after"] = smt.get_rows_sparse(every, worker_id=rank).tolist()
    out["sparse_stale"] = smt.stale_fraction(every, worker_id=rank)
    agg = x["agg"][:, ::2]          # a non-contiguous view
    back = mv.aggregate(agg)
    out["aggregate_in_place"] = back is agg
    out["aggregate"] = x["agg"].tolist()
    shared = mv_shared(x["shared"], name="seeded_shared")
    local = shared.get()
    merged = shared.sync({k: local[k] + x["shared_step"][k]
                          for k in local})
    out["shared"] = {k: np.asarray(v).tolist()
                     for k, v in sorted(merged.items())}
    # the port's own: row reads with each rank's own ids (repeated, out
    # of order, one rank's all in one block)
    t = mv.MatrixTable(SEEDED_ROWS, SEEDED_COLS, seed=7, init_scale=0.5,
                       name="seeded_rows_mine")
    for ids, vals in zip(x["rows"], x["row_vals"]):
        t.add_rows(ids, vals)
    out["rows_mine_ids"] = mine_ids = own_ids(rank)
    out["rows_mine"] = t.get_rows(mine_ids).tolist()
    out["rows_mine_get"] = t.get().tolist()
    # the sparse protocol with worker id 0 on every rank (the harness's
    # matrix entry): every rank is served every row
    smt = mv.SparseMatrixTable(SEEDED_ROWS, SEEDED_COLS, seed=3,
                               init_scale=0.5, name="seeded_sparse_w0",
                               num_workers=2)
    first = smt.get_rows_sparse(every, worker_id=0)
    smt.add_rows(x["sparse_rows"], x["sparse_vals"][:len(x["sparse_rows"])])
    out["sparse_w0_stale"] = smt.stale_fraction(every, worker_id=0)
    out["sparse_w0"] = [first.tolist(),
                        smt.get_rows_sparse(every, worker_id=0).tolist()]
    out["sparse_w0_get"] = smt.get().tolist()
    # a fused path at the table axis of 2: LogReg's epoch over the whole
    # gathered table, the same arrays on every rank
    out["fused_lr"] = fused_lr().tolist()
    # TorchParamManager pulls the whole (gathered) table: every rank's
    # module after a sync is rank 0's init + the sum of the deltas
    from multiverso_tpu_torch.torch_ext import TorchParamManager
    torch.manual_seed(rank)   # each rank its own init; rank 0's wins
    lin = torch.nn.Linear(SEEDED_COLS, 3)
    pm = TorchParamManager(lin, name="seeded_tpm")
    out["tpm_init"] = [p.detach().numpy().tolist()
                       for p in lin.parameters()]
    with torch.no_grad():
        for p in lin.parameters():
            p.add_(float(rank + 1))
    pm.sync()
    out["tpm_synced"] = [p.detach().numpy().tolist()
                         for p in lin.parameters()]
    mv.shutdown()
    if ckpt:
        out["ckpt"] = world_checkpoint(ckpt, device)
        out["sharded"] = sharded_checkpoint(ckpt, device)
    return out


def fused_lr():
    """One fused LogReg epoch (``train_arrays``) on seeded blobs, the
    same on every rank; the table's Get."""
    from multiverso_tpu_torch.apps import logistic_regression as lr
    from multiverso_tpu_torch.models import logreg
    x, y = logreg.synthetic_dataset(256, 20, 4, seed=SEEDED_LR_SEED)
    app = lr.LogReg(lr.LogRegConfig(dict(
        input_size="20", output_size="4", minibatch_size="32",
        learning_rate="0.5", updater_type="sgd")))
    app.train_arrays(x, y, epochs=1)
    return app.table.get()


def own_ids(rank: int) -> list:
    """Rank 0 asks rows of the last block only, rank 1 rows of both
    blocks, repeated and out of order."""
    if rank == 0:
        return [SEEDED_ROWS - 1, SEEDED_ROWS - 3, SEEDED_ROWS - 1]
    return [5, 0, SEEDED_ROWS - 2, 5, 13, 1]


# ---------------------------------------------------------------------- #
# checkpoints: a one-process save restored into the sharded world, and
# the sharded world's save restored into one-process tables
# ---------------------------------------------------------------------- #
CKPT_ADAGRAD = dict(learning_rate=0.5, rho=0.1)


def ckpt_tables(mv, even: bool = True):
    """The checkpoint's tables, in one registration order: an AdaGrad
    MatrixTable (a row-shaped state leaf) and an Adam ArrayTable (row
    leaves and the whole step count), their row counts odd, so that the
    padding of one block and of two agree; with ``even`` an AdaGrad
    MatrixTable of SEEDED_ROWS rows too, whose padding differs at two
    blocks (25 rows at one, 26 at two)."""
    out = (mv.MatrixTable(SEEDED_ROWS - 1, SEEDED_COLS, updater="adagrad",
                          seed=5, init_scale=0.5, name="ck_rows"),
           mv.ArrayTable(SEEDED_ARRAY + 1, updater="adam", name="ck_array"))
    if even:
        out += (mv.MatrixTable(SEEDED_ROWS, SEEDED_COLS, updater="adagrad",
                               seed=6, init_scale=0.5, name="ck_even"),)
    return out


def ckpt_train(tables, seed: int, rank: int) -> None:
    """Seeded adds through the tables (each rank its own)."""
    from multiverso_tpu_torch.updaters import AddOption
    rng = np.random.default_rng([seed, 99, rank])
    opt = AddOption(**CKPT_ADAGRAD)
    for _ in range(2):
        for t in tables:
            if t.name == "ck_array":
                t.add(rng.normal(size=t.shape).astype(np.float32),
                      AddOption(learning_rate=0.01))
                continue
            ids = rng.integers(0, t.shape[0], 7)
            t.add_rows(ids, rng.normal(size=(7, SEEDED_COLS)).astype(
                np.float32), opt)


def ckpt_state(tables) -> Dict:
    """Each table's Get and its gathered updater-state leaves (a
    collective at a world > 1)."""
    out = {}
    for t in tables:
        with t._dispatch_lock:
            _, leaves = t._stored_arrays()
        out[t.name] = {"get": t.get().tolist(),
                       "leaves": [np.asarray(l).tolist() for l in leaves]}
    return out


def one_process_checkpoint(directory: str, seed: int) -> Dict:
    """In a process with no world: the checkpoint tables trained on one
    process and saved under ``directory/one`` (stream) and
    ``directory/one_orbax`` (sharded); their state."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import checkpoint
    mv.init(device="cpu")
    try:
        tables = ckpt_tables(mv)
        ckpt_train(tables, seed, 0)
        checkpoint.save(directory, tag="one")
        checkpoint.save(directory, tag="one_orbax", backend="orbax")
        return ckpt_state(tables)
    finally:
        mv.shutdown()


def world_checkpoint(directory: str, device) -> Dict:
    """The checkpoint tables in a fresh Zoo of this world: trained, saved
    under ``directory/world`` (a collective; rank 0 writes) and again
    with ``block=False`` under ``world_async``; then the one-process
    checkpoint ``one`` restored, each rank keeping its block."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import checkpoint
    mv.init(device=device)
    try:
        tables = ckpt_tables(mv)
        ckpt_train(tables, 11, mv.rank())
        checkpoint.save(directory, tag="world")
        checkpoint.save(directory, tag="world_async", block=False)
        checkpoint.wait_pending()
        saved = ckpt_state(tables)
        checkpoint.restore(directory, tag="one")
        restored = ckpt_state(tables)
        blocks = {t.name: {"rows": list(t.sharding.rows),
                           "data": t.state["data"].cpu().numpy().tolist(),
                           "ustate": {k: v.cpu().numpy().tolist()
                                      for k, v in t.state["ustate"].items()
                                      if v.dim() > 0}}
                  for t in tables}
    finally:
        mv.shutdown()
    return {"saved": saved, "restored": restored, "blocks": blocks}


# ---------------------------------------------------------------------- #
# the sharded checkpoint (backend="orbax"): each rank its own block
# ---------------------------------------------------------------------- #
# what a sharded save or restore must never call: each gathers a whole
# table (or a whole leaf) onto a rank
GATHERS = ("Table.unshard", "Table.whole_state", "Table._stored_arrays",
           "Table._gather_rows_of", "Table._gathered_rows",
           "collectives.raw_all_gather", "collectives.process_all_gather")
PEER_WAIT_S = 100.0   # a world waits this long for the other's tag


class GatherWatch:
    """Inside ``with``: the calls of :data:`GATHERS` and the paths this
    process opened through the checkpoint module for writing."""

    def __init__(self):
        from multiverso_tpu_torch import checkpoint, table
        from multiverso_tpu_torch.parallel import collectives
        self._mods = {"Table": table.Table, "collectives": collectives}
        self._ck = checkpoint
        self.calls = {name: 0 for name in GATHERS}
        self.written = []

    def __enter__(self):
        self._saved = []
        for name in GATHERS:
            owner, attr = name.split(".")
            obj = self._mods[owner]
            real = obj.__dict__[attr]

            def counted(*a, _real=real, _name=name, **kw):
                self.calls[_name] += 1
                return _real(*a, **kw)

            self._saved.append((obj, attr, real))
            setattr(obj, attr, counted)
        real_open = self._ck.open_stream

        def opened(path, mode="rb"):
            if "w" in mode:
                self.written.append(path)
            return real_open(path, mode)

        self._saved.append((self._ck, "open_stream", real_open))
        self._ck.open_stream = opened
        return self

    def __exit__(self, *exc):
        for obj, attr, real in reversed(self._saved):
            setattr(obj, attr, real)
        return False


def _blocks(tables) -> Dict:
    """This rank's block of each table: its rows and its data and
    row-leaf tensors, as lists."""
    return {t.name: {"rows": list(t.sharding.rows),
                     "data": t.state["data"].cpu().numpy().tolist(),
                     "ustate": {k: v.cpu().numpy().tolist()
                                for k, v in t.state["ustate"].items()
                                if t._state_row_axis(v) is not None}}
            for t in tables}


def _peer_committed(directory: str, tag: str) -> bool:
    """Rank 0 waits up to PEER_WAIT_S for ``tag``'s commit marker and
    tells every rank whether it came (one collective), so that the world
    restores it together or not at all."""
    import time

    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import checkpoint
    from multiverso_tpu_torch.parallel.collectives import process_sum
    found = 0
    if mv.rank() == 0:
        deadline = time.monotonic() + PEER_WAIT_S
        path = os.path.join(directory, tag)
        while not checkpoint.is_committed(path):
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
        found = int(checkpoint.is_committed(path))
    return bool(process_sum(np.array([found], np.int64))[0])


def _elastic(directory: str, device, block: bool) -> Dict:
    """``ElasticLoop(backend="orbax", block=block, keep=1)`` over 7 steps
    of collective adds (checkpoints after steps 2 and 5, each pruning the
    one before on rank 0), then a fresh Zoo resumed from it: the step it
    resumes at and whether redoing step 6 lands on the first run's table
    bit for bit."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import elastic
    from multiverso_tpu_torch.updaters import AddOption
    opt = AddOption(**CKPT_ADAGRAD)

    def loop():
        return elastic.ElasticLoop(directory, every=3, keep=1,
                                   heartbeat_interval=60, backend="orbax",
                                   block=block)

    def table():
        return mv.MatrixTable(SEEDED_ROWS - 1, SEEDED_COLS,
                              updater="adagrad", name="ck_elastic")

    def step(t, i):
        t.add_rows(np.arange(i, i + 5), np.full((5, SEEDED_COLS),
                                                 i + 1.0, np.float32), opt)

    mv.init(device=device)
    try:
        t, lp = table(), loop()
        try:
            for i in range(lp.resume(), 7):
                step(t, i)
                lp.completed(i)
        finally:
            lp.stop()
        want = t.get()
    finally:
        mv.shutdown()
    mv.init(device=device)
    try:
        t, lp = table(), loop()
        try:
            start = lp.resume()
        finally:
            lp.stop()
        step(t, 6)
        same = bool(np.array_equal(t.get(), want))
    finally:
        mv.shutdown()
    tags = sorted(n for n in os.listdir(directory) if n.startswith("step_"))
    return {"start": start, "same": same, "tags": tags}


def _failed_saves(directory: str, own: str, rank: int, world: int) -> Dict:
    """A sharded save, blocking and not, whose array files fail to open
    on the last rank alone: what each rank raised, and whether the tag
    was committed."""
    from multiverso_tpu_torch import checkpoint
    out = {}
    real = checkpoint.open_stream
    for name, block in (("block", True), ("async", False)):
        tag = f"{own}_broken_{name}"

        def failing(path, mode="rb", _tag=tag):
            if (rank == world - 1 and f"{_tag}{os.sep}" in path
                    and path.endswith(".npy")):
                raise OSError("disk full")
            return real(path, mode)

        checkpoint.open_stream = failing
        try:
            checkpoint.save(directory, tag=tag, backend="orbax", block=block)
            checkpoint.wait_pending()
            out[name] = "no error"
        except (OSError, RuntimeError) as e:
            out[name] = f"{type(e).__name__}: {e}"
        finally:
            checkpoint.open_stream = real
        out[f"{name}_committed"] = checkpoint.is_committed(
            os.path.join(directory, tag))
    return out


def sharded_checkpoint(directory: str, device, seed: int = 11) -> Dict:
    """The checkpoint tables of :func:`ckpt_tables` in a fresh Zoo of this
    world, trained, then saved sharded under ``directory/orbax_w<N>``
    (blocking) and ``orbax_w<N>_async`` (``block=False``), watched
    (:class:`GatherWatch`). Then, each watched: restored after more adds (the
    same world), ``one_orbax`` restored (saved by one process), and the
    other world's tag (worlds 2 and 4: ``orbax_w4``, ``orbax_w2``)
    restored once it is committed; each state gathered after its
    restore. Then a save that fails on the last rank only
    (:func:`_failed_saves`), and last ``ElasticLoop`` on the backend,
    blocking and not."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import checkpoint
    mv.init(device=device)
    world, rank = mv.size(), mv.rank()
    own, peer = f"orbax_w{world}", f"orbax_w{6 - world}"
    out: Dict = {"rank": rank, "world": world}
    try:
        tables = ckpt_tables(mv)
        ckpt_train(tables, seed, rank)
        with GatherWatch() as w:
            checkpoint.save(directory, tag=own, backend="orbax")
            checkpoint.save(directory, tag=own + "_async",
                            backend="orbax", block=False)
            out["staged"] = checkpoint._pending.staged
            checkpoint.wait_pending()
        out["save_calls"], out["written"] = w.calls, w.written
        out["staged_after"] = checkpoint._GAUGES.memory_stats()[
            "staging_bytes"]
        out["saved"] = ckpt_state(tables)
        out["blocks"] = _blocks(tables)
        out["block_bytes"] = sum(
            t.state["data"].numel() * t.state["data"].element_size()
            + sum(v.numel() * v.element_size()
                  for v in t.state["ustate"].values()
                  if t._state_row_axis(v) is not None) for t in tables)
        restores = {}
        for tag in (own, "one_orbax", peer):
            if tag == peer and not _peer_committed(directory, peer):
                continue
            ckpt_train(tables, seed + 1, rank)   # move away from it
            with GatherWatch() as w:
                n = checkpoint.restore(directory, tag=tag)
            restores[tag] = {"n": n, "calls": w.calls,
                             "written": w.written,
                             "state": ckpt_state(tables)}
        out["restores"] = restores
        out["failures"] = _failed_saves(directory, own, rank, world)
    finally:
        mv.shutdown()
    out["elastic"] = {
        name: _elastic(os.path.join(directory, f"elastic_w{world}_{name}"),
                       device, block)
        for name, block in (("block", True), ("async", False))}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("scenario", "seeded"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--ckpt", default="")
    args = ap.parse_args()
    import torch
    torch.set_num_threads(1)
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.parallel.mesh import leave_world
    from multiverso_tpu_torch.utils import config
    config.set_flag("ps_timeout", 60.0)
    config.set_flag("ps_connect_timeout", 30.0)
    config.set_flag("net_timeout_s", 90.0)
    if mv.net_init(device=args.device) != 0:
        sys.exit(f"rank {os.environ.get('RANK')}: net_init failed")
    try:
        if args.mode == "scenario":
            out = scenario(args.device)
            if args.ckpt:
                out["sharded"] = sharded_checkpoint(args.ckpt, args.device)
        else:
            out = seeded(args.seed, args.device, args.ckpt)
    finally:
        leave_world()
    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
