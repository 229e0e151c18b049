"""Async-PS plane throughput with one rank a process (the port's
counterpart of the JAX package's ``tools/bench_async_ps.py``, its
``strided`` pattern).

Each rank owns half of a 100,000 x 128 f32 AsyncMatrixTable (default
updater, plain wire) and, for ``--seconds``, pushes and pulls one
1,024-row batch strided over the whole table (rank r's rows r, r + 97,
..., so every op spans both owners): ``add_rows_async`` with at most 4 in
flight and a timed ``get_rows`` of the same rows. ``--plane`` picks the
wire plane: ``native`` (the C++ transport, ``ps_native`` on) or
``python``. The ranks' row sets are disjoint and each row takes one
rank's adds of one value, so after both ranks stop a numpy model of the
same f32 adds gives the table exactly: rank 0 holds its full Get to it
bit for bit.

    python -m multiverso_tpu_torch.examples.ps_bench --rdv DIR --world 2 \\
        --rank R [--seconds 2] [--plane native|python] [--device cpu] \\
        [--telemetry DIR]

``--telemetry DIR`` runs the rank with per-request trace IDs (flag
``trace_ids``) and the metrics exporter (``metrics_dir`` DIR,
``metrics_interval_s`` 0.5): each rank leaves ``metrics-rank<r>.jsonl``,
``metrics-rank<r>.prom`` and ``trace-rank<r>.jsonl`` there (the native
plane's fast path is untraced by design: trace the Python plane).

Each rank prints one ``RESULT {json}`` line: adds/s, gets/s, the Get's
p50/p99 ms, the plane the table really took, and (rank 0) whether the
full Get equalled the model.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Tuple

import numpy as np

ROWS, DIM, BATCH, DEPTH = 100_000, 128, 1024, 4


def strided_ids(rank: int, rows: int = ROWS, batch: int = BATCH
                ) -> np.ndarray:
    """Rank ``rank``'s batch: every ``rows // batch``-th row from
    ``rank`` on, so a batch spans every owner and ranks never overlap."""
    return (np.arange(batch) * (rows // batch) + rank) % rows


def rank_values(rank: int, batch: int = BATCH, dim: int = DIM
                ) -> np.ndarray:
    return (np.random.default_rng(rank).normal(size=(batch, dim)) * 0.01
            ).astype(np.float32)


def drive(table, ids: np.ndarray, vals: np.ndarray, seconds: float,
          depth: int = DEPTH) -> Tuple[int, List[float], float]:
    """The client loop: async adds (at most ``depth`` in flight) and a
    timed get of the same rows until ``seconds`` pass. Returns (adds,
    get latencies in ms, seconds)."""
    adds, lat, mids = 0, [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        mids.append(table.add_rows_async(ids, vals))
        adds += 1
        if len(mids) >= depth:
            table.wait(mids.pop(0))
        g0 = time.perf_counter()
        table.get_rows(ids)
        lat.append((time.perf_counter() - g0) * 1e3)
    for m in mids:
        table.wait(m)
    return adds, lat, time.perf_counter() - t0


def model(parts, rows: int = ROWS, dim: int = DIM) -> np.ndarray:
    """The table after ``parts`` = [(ids, vals, count)]: each rank's
    ``count`` adds of ``vals`` to ``ids``, in f32, one at a time."""
    m = np.zeros((rows, dim), np.float32)
    for ids, vals, count in parts:
        for _ in range(count):
            m[ids] += vals
    return m


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rdv", required=True)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--plane", choices=("native", "python"),
                    default="native")
    ap.add_argument("--device", default=None,
                    help="the shards' device (default: the card)")
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--telemetry", default=None, metavar="DIR",
                    help="trace requests and export metrics into DIR")
    args = ap.parse_args(argv)

    from multiverso_tpu_torch.ps.native import NativeConn
    from multiverso_tpu_torch.ps.service import (FileRendezvous, PSContext,
                                                 PSService)
    from multiverso_tpu_torch.ps.tables import AsyncMatrixTable
    from multiverso_tpu_torch.utils import config

    config.set_flag("ps_timeout", args.timeout)
    config.set_flag("ps_native", args.plane == "native")
    if args.telemetry:
        config.set_flag("trace_ids", True)
        config.set_flag("metrics_dir", args.telemetry)
        config.set_flag("metrics_interval_s", 0.5)
    rdv = FileRendezvous(args.rdv)

    def barrier(tag: str) -> None:
        rdv.mark(args.rank, tag)
        for r in range(args.world):
            if not rdv.wait_mark(r, tag, args.timeout):
                raise TimeoutError(f"rank {r} never reached {tag!r}")

    ctx = PSContext(args.rank, args.world,
                    PSService(args.rank, args.world, rdv),
                    device=args.device)
    try:
        t = AsyncMatrixTable(ROWS, DIM, name="ps_bench", ctx=ctx)
        ids, vals = strided_ids(args.rank), rank_values(args.rank)
        t.add_rows(ids, vals)   # warm: both owners' paths
        t.get_rows(ids)
        barrier("ps_bench_warm")
        adds, lat, dt = drive(t, ids, vals, args.seconds)
        conns = ctx.service.native_conns()
        st = t._shard.stats()
        res = {"rank": args.rank, "plane": args.plane,
               "device": str(ctx.device),
               "native_client": bool(t._native_ok and conns and all(
                   isinstance(c, NativeConn) for c in conns)),
               "native_server": ctx.service._native is not None,
               "registered": t._shard._native_ref is not None,
               "native_applies": st["native_applies"],
               "adds": adds, "gets": len(lat), "seconds": dt,
               "adds_per_sec": adds / dt, "gets_per_sec": len(lat) / dt,
               "get_p50_ms": float(np.percentile(lat, 50)),
               "get_p99_ms": float(np.percentile(lat, 99))}
        # the warm add counts: each rank's total goes to the other
        rdv.mark(args.rank, "ps_bench_adds", str(adds + 1))
        barrier("ps_bench_done")
        if args.rank == 0:
            counts = []
            for r in range(args.world):
                with open(os.path.join(args.rdv, f"ps_bench_adds.{r}")) as f:
                    counts.append(int(f.read()))
            want = model([(strided_ids(r), rank_values(r), counts[r])
                          for r in range(args.world)])
            res["exact"] = bool(np.array_equal(t.get(), want))
        barrier("ps_bench_checked")
    finally:
        ctx.close()
    print("RESULT " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
