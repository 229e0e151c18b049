"""WordEmbedding on the uncoordinated async PS plane, one rank of a world:
the reference's product shape (N independent processes training one
model through async tables, ref distributed_wordembedding.cpp:147-252
block pipeline + src/server.cpp async applies).

Every rank builds the same corpus and dictionary, creates the async
tables (``-async_ps 1``: shards on this process's device, the other
ranks over TCP through the ``--rdv`` directory) and trains with
``train_ps_blocks`` (``-use_ps 1``, the host plane) in the reference's
layout, as the JAX package's async cell does
(``tools/bench_we_async.py``): ``-data_presplit 1`` with every rank fed
the whole corpus, so each rank sweeps every block and pushes its deltas
divided by the world (ref communicator.cpp:154). The first epoch warms;
``--epochs`` - 1 measured epochs follow. Ranks meet at a marker in the
rendezvous directory after the tables exist, before every epoch after
the warm one (so no rank's measured epoch overlaps another's warm one),
before the profiled epoch and after training, then shut down
(``mv.shutdown`` quiesces: each rank serves until the others are done).

It prints one line ``RESULT {json}``: the loss and words/s of each
epoch, the last epoch's host time by Dashboard monitor (the block's
prep, training and push; the client's dedupe and send in ``add_rows``,
its pulls in ``get_rows``; this rank's shard serving and applying), with
``--profile`` the device's busy time in one more epoch traced by
``torch.profiler`` and that epoch's wall time, with ``--step_profile``
the step profiler's ``profile`` block of the measured epoch (per-step
phase means, attributed and stall fractions, steady-state rebuilds: the
JAX package's ``tools/bench_we_async.py`` block, which
:func:`check_profile` holds to that tool's in-run bounds), the
aggregated trained-word count (every rank's words of every epoch) and a
digest of the input embeddings.

The configuration is bench.py's PS cell (size 128, batch 8,192, 5
negatives, window 5, blocks of 50,000, f32, seed 12) on the real text
(``--corpus realtext``) or the 1M-token synthetic corpus
(``--corpus synthetic``).

Run one process per rank:

    python -m multiverso_tpu_torch.examples.we_async --rdv DIR \\
        --world 2 --rank R [--corpus synthetic] [--epochs 2] \\
        [--device cpu] [--tokens N] [--profile] [--step_profile]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time

import numpy as np

WE_CFG = dict(size=128, min_count=5, batch_size=8192, negative=5, window=5,
              data_block_size=50_000, use_ps="1", async_ps="1",
              data_presplit="1", seed=12)
SYNTH = dict(num_tokens=1_000_000, vocab=5_000, seed=12)

# the in-run bounds of the JAX package's WE async bench
# (tools/bench_we_async.py): the profiler must account for >= 90% of the
# measured epoch's wall, the pipeline must keep unattributed wall under
# 20%, and the steady state must rebuild nothing
ATTRIBUTED_FRACTION_FLOOR = 0.90
STALL_FRACTION_CEILING = 0.2


def profile_block(prof: dict, records=()) -> dict:
    """The RESULT ``profile`` block from ``profiler.summary()`` of the
    measured epoch: per-step exclusive phase means, the fractions, and
    whether ``prepare`` dominates ``compute``; with the epoch's step
    ``records``, also the per-step means of the async spans (the
    pipelined path's ``io.produce``: the block prep the producers ran
    under the step)."""
    phases = prof["phases"]
    steps = max(prof["steps"], 1)
    spans: dict = {}
    for r in records:
        for n, d in (r.get("async") or {}).items():
            spans[n] = spans.get(n, 0.0) + float(d.get("ms", 0.0))
    return {
        "async_ms_per_step": {n: round(v / steps, 2)
                              for n, v in sorted(spans.items())},
        "steps": prof["steps"],
        "wall_ms_per_step": round(prof["wall_ms"] / steps, 2),
        "attributed_fraction": prof["attributed_fraction"],
        "stall_fraction": prof["stall_fraction"],
        "overlap_ms_per_step": round(prof["overlap_ms"] / steps, 2),
        "phase_ms_per_step": {n: round(v / steps, 2)
                              for n, v in phases.items()},
        "prepare_dominates": bool(phases.get("prepare", 0.0)
                                  > phases.get("compute", 0.0)),
        "steady_recompiles": prof["steady_recompiles"],
        "compiles": prof["jax"]["compiles"],
        "transfer_mb": round(prof["jax"]["transfer_bytes"] / 1e6, 2),
    }


def check_profile(profile: dict) -> None:
    """Raise AssertionError unless a ``profile`` block meets the JAX WE
    async bench's in-run bounds (see the constants above)."""
    assert profile and profile["steps"] > 0, "no profiled steps"
    assert profile["attributed_fraction"] >= ATTRIBUTED_FRACTION_FLOOR, (
        f"profiler attributed only {profile['attributed_fraction']:.1%} "
        "of step wall time")
    assert profile["stall_fraction"] < STALL_FRACTION_CEILING, (
        f"stall fraction {profile['stall_fraction']:.1%} >= "
        f"{STALL_FRACTION_CEILING:.0%}: the prepare pipeline is not "
        "covering the step")
    assert profile["steady_recompiles"] == 0, (
        f"{profile['steady_recompiles']} steady-state rebuilds during "
        "the measured epoch")


def corpus(name: str, tokens: int = 0):
    """The training tokens: the real text, or bench.py's synthetic corpus
    (``tokens`` > 0 cuts either to that many)."""
    from multiverso_tpu_torch.apps.word_embedding import synthetic_corpus
    from multiverso_tpu_torch.io import realtext
    if name == "realtext":
        return realtext.load_tokens(tokens or None)
    return synthetic_corpus(tokens or SYNTH["num_tokens"],
                            vocab=SYNTH["vocab"], seed=SYNTH["seed"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rdv", required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--corpus", choices=("realtext", "synthetic"),
                    default="synthetic")
    ap.add_argument("--tokens", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--device", default=None)
    ap.add_argument("--size", type=int, default=WE_CFG["size"])
    ap.add_argument("--batch_size", type=int, default=WE_CFG["batch_size"])
    ap.add_argument("--block", type=int, default=WE_CFG["data_block_size"])
    ap.add_argument("--timeout", type=float, default=180.0)
    ap.add_argument("--profile", action="store_true",
                    help="trace one more epoch with torch.profiler and "
                    "report the device's busy time in it")
    ap.add_argument("--step_profile", action="store_true",
                    help="run the step profiler over the measured (last) "
                    "epoch and add its profile block to RESULT")
    args = ap.parse_args(argv)

    import torch

    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.apps.word_embedding import (WEConfig,
                                                          WordEmbedding)
    from multiverso_tpu_torch.data.dictionary import Dictionary
    from multiverso_tpu_torch.ps.service import FileRendezvous
    from multiverso_tpu_torch.telemetry import profiler as _prof
    from multiverso_tpu_torch.utils import config
    from multiverso_tpu_torch.utils.dashboard import Dashboard

    config.set_flag("ps_rank", args.rank)
    config.set_flag("ps_world", args.world)
    config.set_flag("ps_rendezvous", args.rdv)
    config.set_flag("ps_timeout", args.timeout)
    config.set_flag("ps_shutdown_grace", args.timeout)
    mv.init(device=args.device)
    rdv = FileRendezvous(args.rdv)

    def barrier(tag: str) -> None:
        rdv.mark(args.rank, tag)
        for r in range(args.world):
            if not rdv.wait_mark(r, tag, args.timeout):
                raise TimeoutError(f"rank {r} never reached {tag!r}")

    t_start = time.perf_counter()
    tokens = corpus(args.corpus, args.tokens)
    cfg = WEConfig(**{**WE_CFG, "size": args.size,
                      "batch_size": args.batch_size,
                      "data_block_size": args.block})
    we = WordEmbedding(cfg, Dictionary.build(tokens, cfg.min_count))
    ids = we.prepare_ids(tokens)
    setup_s = time.perf_counter() - t_start
    barrier("we_async_tables")
    epochs, profiled = [], None
    for e in range(args.epochs):
        if e:   # the warm epoch, then each measured one, start together
            barrier(f"we_async_epoch{e}")
        last = e == args.epochs - 1
        if last:
            Dashboard.reset()
            if args.step_profile:
                # the measured epoch only: the warm epoch's builds belong
                # to warmup
                config.set_flag("step_profile", True)
                _prof.configure()
        stats = we.train_ps_blocks(ids, epochs=1)
        if last and args.step_profile:
            config.set_flag("step_profile", False)
            _prof.configure()
        epochs.append({"loss": stats["loss"],
                       "words_per_sec": stats["words_per_sec"],
                       "seconds": stats["seconds"]})
    monitors = {name: {"count": snap.count, "total_ms": snap.total_ms,
                       "p50_ms": snap.p50_ms}
                for name, snap in Dashboard.snapshot().items()}
    if args.profile:
        barrier("we_async_profiled")
        acts = [torch.profiler.ProfilerActivity.CPU]
        if we.table_in.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            stats = we.train_ps_blocks(ids, epochs=1)
        # device-side events only: the CPU ops that launched them carry
        # the same time again as their own device time
        profiled = {"seconds": stats["seconds"], "busy_ms": sum(
            ev.self_device_time_total for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3}
    barrier("we_async_trained")
    emb = we.embeddings()
    out = {"rank": args.rank, "world": args.world, "corpus": args.corpus,
           "tokens": int(ids.size), "vocab": len(we.dict),
           "device": str(we.table_in.device), "setup_s": setup_s,
           "epochs": epochs, "monitors": monitors,
           "profiled_epoch": profiled,
           "profile": (profile_block(_prof.summary(), _prof.records())
                       if args.step_profile else None),
           "total_word_count": we.total_word_count(),
           "emb_sha": hashlib.sha256(emb.tobytes()).hexdigest(),
           "emb_finite": bool(np.isfinite(emb).all()),
           "shard_rows": [we.table_in.lo, we.table_in.hi]}
    mv.shutdown()
    print("RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
