"""Per-epoch losses of the async WordEmbedding at world 2 in the
reference's layout, for the JAX package or the port, on the CPU.

The layout is the JAX async cell's (``tools/bench_we_async.py``) and the
port example's (``multiverso_tpu_torch/examples/we_async.py``):
``-data_presplit 1``, every rank fed the whole corpus and sweeping every
block with its deltas divided by the world, the ranks meeting before
every epoch after the warm one. The configuration is the example's
(``we_async.WE_CFG``, bench.py's PS cell). For ``--pkg torch`` the ranks
are the port's example itself on ``--device cpu``; for ``--pkg jax``
they are this script's own worker, the same loop over the JAX package
(JAX on the CPU, the pure-Python plane).

Each run starts two processes over a fresh rendezvous directory and
prints every rank's epoch losses, the loss averaged over the ranks in
each epoch, and the relative fall of that mean from the warm epoch to
the last one; the last line is ``SUMMARY {json}`` with every run.

    python tests/we_async_layout_losses.py --pkg jax --corpus realtext \\
        --runs 8
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def jax_rank(args) -> None:
    """One rank of the JAX package's async WE in the example's layout."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import multiverso_tpu as mv
    from multiverso_tpu.apps.word_embedding import (WEConfig, WordEmbedding,
                                                    synthetic_corpus)
    from multiverso_tpu.data.dictionary import Dictionary
    from multiverso_tpu.io import realtext
    from multiverso_tpu.utils import config
    from multiverso_tpu.utils.filesync import file_barrier
    from multiverso_tpu_torch.examples.we_async import SYNTH, WE_CFG

    config.set_flag("ps_native", False)
    config.set_flag("ps_rank", args.rank)
    config.set_flag("ps_world", 2)
    config.set_flag("ps_rendezvous", args.rdv)
    config.set_flag("ps_timeout", args.timeout)
    mv.init()
    if args.corpus == "realtext":
        tokens = realtext.load_tokens()
    else:
        tokens = synthetic_corpus(SYNTH["num_tokens"], vocab=SYNTH["vocab"],
                                  seed=SYNTH["seed"])
    cfg = WEConfig(**WE_CFG)
    we = WordEmbedding(cfg, Dictionary.build(tokens, cfg.min_count))
    ids = we.prepare_ids(tokens)

    def barrier(tag):
        file_barrier(args.rdv, 2, args.rank, tag, timeout=args.timeout)

    barrier("tables")
    epochs = []
    for e in range(args.epochs):
        if e:
            barrier(f"epoch{e}")
        epochs.append({"loss": float(we.train_ps_blocks(ids, epochs=1)
                                     ["loss"])})
    barrier("trained")
    print("RESULT " + json.dumps({"rank": args.rank, "epochs": epochs}),
          flush=True)
    mv.shutdown()


def one_run(args) -> dict:
    """Two ranks over a fresh rendezvous directory; their epoch losses."""
    env = dict(os.environ, OMP_NUM_THREADS=str(args.threads),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    with tempfile.TemporaryDirectory() as rdv:
        if args.pkg == "jax":
            cmd = [sys.executable, os.path.abspath(__file__), "--pkg", "jax",
                   "--rdv", rdv, "--corpus", args.corpus, "--epochs",
                   str(args.epochs), "--timeout", str(args.timeout)]
        else:
            cmd = [sys.executable, "-m",
                   "multiverso_tpu_torch.examples.we_async", "--rdv", rdv,
                   "--world", "2", "--corpus", args.corpus, "--epochs",
                   str(args.epochs), "--device", "cpu", "--timeout",
                   str(args.timeout)]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=REPO,
                                  env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(2)]
        try:
            outs = [p.communicate(timeout=args.timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    ranks = []
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        lines = [l for l in so.splitlines() if l.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            raise RuntimeError(f"rank {r} failed ({p.returncode}):\n"
                               f"{se[-3000:]}")
        ranks.append([e["loss"] for e in
                      json.loads(lines[-1][len("RESULT "):])["epochs"]])
    means = [sum(l[e] for l in ranks) / len(ranks)
             for e in range(args.epochs)]
    return {"ranks": ranks, "means": means,
            "rel_fall": (means[0] - means[-1]) / means[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pkg", choices=("jax", "torch"), required=True)
    ap.add_argument("--corpus", choices=("realtext", "synthetic"),
                    default="realtext")
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--threads", type=int, default=2,
                    help="OMP_NUM_THREADS of each rank")
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--rdv", default=None)
    args = ap.parse_args(argv)
    if args.rank is not None:
        jax_rank(args)
        return 0
    runs = []
    for i in range(args.runs):
        run = one_run(args)
        runs.append(run)
        print(f"run {i} {args.pkg} {args.corpus}: ranks "
              + "; ".join(" -> ".join(f"{x:.4f}" for x in l)
                          for l in run["ranks"])
              + "; mean " + " -> ".join(f"{x:.4f}" for x in run["means"])
              + f"; relative fall {run['rel_fall']:.4f}", flush=True)
    print("SUMMARY " + json.dumps({"pkg": args.pkg, "corpus": args.corpus,
                                   "epochs": args.epochs, "runs": runs}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
