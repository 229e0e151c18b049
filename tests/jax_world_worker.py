"""One rank of a multi-process world of the JAX package, for the port's
world tests (``tests/test_torch_world.py``). The one helper of the port's
tests that imports jax on purpose.

    python tests/jax_world_worker.py <coordinator> <nprocs> <pid> seeded --seed S
    python tests/jax_world_worker.py <coordinator> <nprocs> <pid> mlp

``seeded`` runs ``tests/torch_world_worker.py``'s seeded cases on the same
numpy inputs (its :func:`seeded_inputs`); ``mlp`` runs the JAX package's
``examples/mlp_data_parallel.py`` unchanged and reads back its printed
epochs. Each prints one ``RESULT <json>`` line. One CPU device a process.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import re
import sys

_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_DIR)
for _p in (_REPO, _DIR):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def seeded(seed: int) -> dict:
    import numpy as np

    import multiverso_tpu as mv
    from multiverso_tpu.sharedvar import mv_shared
    from multiverso_tpu.updaters import AddOption
    from torch_world_worker import (SEEDED_ADAGRAD, SEEDED_ARRAY,
                                    SEEDED_COLS, SEEDED_ROWS, seeded_inputs)

    mv.init()
    rank = mv.rank()
    x = seeded_inputs(seed, rank)
    out = {}
    ada = AddOption(**SEEDED_ADAGRAD)
    for upd, opt in (("default", None), ("adagrad", ada)):
        t = mv.MatrixTable(SEEDED_ROWS, SEEDED_COLS, updater=upd, seed=7,
                           init_scale=0.5, name=f"seeded_rows_{upd}")
        for ids, vals in zip(x["rows"], x["row_vals"]):
            t.add_rows(ids, vals, opt)
        out[f"rows_{upd}"] = t.get().tolist()
    for name, kw in (("array", {}), ("array_sgd", {"updater": "sgd"}),
                     ("array_bf16", {"wire_filter": "bf16"})):
        t = mv.ArrayTable(SEEDED_ARRAY, name=f"seeded_{name}", **kw)
        for d in x["array"]:
            t.add(d)
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
    agg = x["agg"][:, ::2]
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


def mlp() -> dict:
    """The JAX example's run, its printed epoch lines read back."""
    spec = importlib.util.spec_from_file_location(
        "mlp_data_parallel", os.path.join(_REPO, "examples",
                                          "mlp_data_parallel.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    epochs = re.findall(r"epoch (\d+): loss ([0-9.]+)\s+test acc ([0-9.]+)",
                        buf.getvalue())
    return {"loss": [float(l) for _, l, _ in epochs],
            "acc": [float(a) for _, _, a in epochs]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("coordinator")
    ap.add_argument("nprocs", type=int)
    ap.add_argument("pid", type=int)
    ap.add_argument("mode", choices=("seeded", "mlp"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 1)
    from multiverso_tpu.utils.platform import enable_cpu_collectives
    enable_cpu_collectives()
    jax.distributed.initialize(coordinator_address=args.coordinator,
                               num_processes=args.nprocs,
                               process_id=args.pid)
    out = seeded(args.seed) if args.mode == "seeded" else mlp()
    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
