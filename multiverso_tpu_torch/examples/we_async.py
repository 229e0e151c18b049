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
``torch.profiler`` and that epoch's wall time, the aggregated
trained-word count (every rank's words of every epoch) and a digest of
the input embeddings.

The configuration is bench.py's PS cell (size 128, batch 8,192, 5
negatives, window 5, blocks of 50,000, f32, seed 12) on the real text
(``--corpus realtext``) or the 1M-token synthetic corpus
(``--corpus synthetic``).

Run one process per rank:

    python -m multiverso_tpu_torch.examples.we_async --rdv DIR \\
        --world 2 --rank R [--corpus synthetic] [--epochs 2] \\
        [--device cpu] [--tokens N] [--profile]
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
    args = ap.parse_args(argv)

    import torch

    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.apps.word_embedding import (WEConfig,
                                                          WordEmbedding)
    from multiverso_tpu_torch.data.dictionary import Dictionary
    from multiverso_tpu_torch.ps.service import FileRendezvous
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
        if e == args.epochs - 1:
            Dashboard.reset()
        stats = we.train_ps_blocks(ids, epochs=1)
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
           "total_word_count": we.total_word_count(),
           "emb_sha": hashlib.sha256(emb.tobytes()).hexdigest(),
           "emb_finite": bool(np.isfinite(emb).all()),
           "shard_rows": [we.table_in.lo, we.table_in.hi]}
    mv.shutdown()
    print("RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
