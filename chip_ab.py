#!/usr/bin/env python3
"""Time chosen chip_smoke.py phases of several checkouts in turns.

    python3 chip_ab.py --trees OLD NEW NEW OLD \\
        --phases ps_window,serving,ps_native [--out chiprun_out/ab]

Each entry of ``--trees`` is the root of a checkout of this repository.
For each entry, in the order given, a fresh process imports that
checkout's ``chip_smoke.py`` and ``multiverso_tpu_torch``, builds the
native PS library, initialises the card and runs ``phase_<name>(dev)``
for every name of ``--phases``. So parent, change, change, parent holds
two commits against each other on one card within one run. Every run's
whole output goes to ``<out>/<i>_<tree name>.log``; the lines the
phases print about themselves, and each phase's wall seconds, are echoed
here. Exits non-zero if a run fails or no card is present.
"""
import argparse
import os
import subprocess
import sys

RUN = """
import os, sys, time
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
import multiverso_tpu_torch as mv
cs.psn_build()
mv.init()
dev = mv.device()
for name in sys.argv[1].split(","):
    t0 = time.perf_counter()
    getattr(cs, "phase_" + name)(dev)
    print(f"AB phase {name} {time.perf_counter() - t0:.1f} s", flush=True)
mv.shutdown()
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--phases", required=True)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "ab"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    prefixes = tuple(args.phases.split(",")) + ("AB phase",)
    for i, tree in enumerate(args.trees):
        tree = os.path.abspath(tree)
        log = os.path.join(args.out, f"{i}_{os.path.basename(tree)}.log")
        env = dict(os.environ, TEARDOWN_CUPTI="1")
        with open(log, "w") as f:
            rc = subprocess.run([sys.executable, "-c", RUN, args.phases],
                                cwd=tree, stdout=f, stderr=subprocess.STDOUT,
                                text=True, env=env).returncode
        print(f"== run {i}: {tree} (exit {rc})", flush=True)
        with open(log) as f:
            for line in f:
                if line.startswith(prefixes):
                    print(line.rstrip()[:600], flush=True)
        if rc != 0:
            with open(log) as f:
                print(f.read()[-3000:], file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
