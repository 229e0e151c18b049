"""One rank of a multi-process world of ``multiverso_tpu_torch`` (the
port's counterpart of ``tests/multiprocess_worker.py``). Imports no jax.

Started the way a launcher starts a rank: ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` in the environment; the rank
joins its world with ``net_init()``, which reads them.

    python tests/torch_world_worker.py scenario [--device cpu]
    python tests/torch_world_worker.py seeded --seed S [--device cpu]

``scenario`` runs ``tests/multiprocess_worker.py``'s steps; ``seeded``
runs the seeded cases that ``tests/jax_world_worker.py`` runs in the JAX
package (inputs from :func:`seeded_inputs`, shared by both). Each prints
one ``RESULT <json>`` line.
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


def seeded(seed: int, device) -> Dict:
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
    mv.shutdown()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("scenario", "seeded"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cpu")
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
        out = (scenario(args.device) if args.mode == "scenario"
               else seeded(args.seed, args.device))
    finally:
        leave_world()
    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
