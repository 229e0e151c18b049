"""Run one cell of the benchmark of ``multiverso_tpu_torch`` and print its
result as the last line of standard output.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

The cell is ``benchmark/workloads/<cell>.json``; it names its
configuration (``benchmark/configs/<config>.json``), whose ``driver``
names the timed loop (``benchmark/drivers/<driver>.py``). The metrics a
cell reports are those ``BENCHMARK.json`` gives it: with ``--trace 0`` the
end-to-end ones, with ``--trace 1`` the per-layer ones, each read by
``benchmark/metrics/<metric>.py`` from the run's record. A new
configuration, cell or metric is a new file; no file here names one.

A run: set-up (the program built, weights and batches made from the seed,
the first steps driven, every shape of the window warmed), the timed
window, then the comparison with the plain reference once the program's
state is freed. It needs as many CUDA devices as the cell asks for, and
exits with another code than 0, printing no result, without them, or if
JAX or the JAX package was loaded. The benchmark's own tests run on the
CPU from the checkout's root: ``python -m pytest benchmark/tests``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# build and kernel caches at fixed paths in the checkout: the port builds
# its kernels under build/torch_kernels; any Triton or extension build
# would land here
CACHE = CHECKOUT / "build" / "bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")

import torch  # noqa: E402

T_TORCH = time.perf_counter()

from benchmark import check, trace, traffic  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "multiverso_tpu")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: Dict, cell: str, traced: bool):
    """The cell's metrics from ``BENCHMARK.json``: the end-to-end ones, or
    the per-layer ones of a traced run."""
    key = "per_layer" if traced else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device: Optional[str] = None, root: Path = HERE) -> Dict:
    """One run of ``workload`` (files under ``root``, ``BENCHMARK.json``
    beside it); returns the result object. ``device`` defaults to the
    first CUDA device, and set-up is then timed from the process's
    start."""
    t0 = T_START if device is None else time.perf_counter()
    bench = load_json(root.parent / "BENCHMARK.json")
    cell = load_json(root / "workloads" / f"{workload}.json")
    cfg = traffic.as_run(load_json(root / "configs"
                                   / f"{cell['config']}.json"))
    drv_mod = load_module(root / "drivers" / f"{cfg['driver']}.py",
                          f"benchmark_driver_{cfg['driver']}")
    dev = torch.device(device or "cuda:0")
    t_dev = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    cuda_init = time.perf_counter() - t_dev
    drv = drv_mod.Driver(cfg, cell, seed, dev, trace.Spans(traced),
                         trace.Marks(dev))
    before = time.perf_counter() - t0
    drv.setup()
    setup_s = time.perf_counter() - t0
    imports = T_TORCH - T_START if device is None else 0.0
    phases = {"import_torch": imports, "cuda_init": cuda_init,
              "harness": before - imports - cuda_init,
              **drv.phases.seconds}
    print("setup phases (s): " + json.dumps(
        {k: round(v, 3) for k, v in phases.items()}),
        file=sys.stderr, flush=True)
    if traced:
        rec, tr = trace.traced(lambda: drv.window(seconds), dev)
        rec["trace"] = tr
    else:
        rec = drv.window(seconds)
    rec["setup_s"] = setup_s
    print(f"window: {rec['window_s']:.3f} s, {rec['steps']} steps, syncs "
          f"{[round(x, 1) for x in rec.get('sync_ms', [])]} ms",
          file=sys.stderr, flush=True)
    rec["driver"] = cfg["driver"]
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell["chips"],
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                         if dev.type == "cuda" else 0)}
    rec["device_kind"] = device_info["kind"]
    rec["tf32"] = (torch.backends.cuda.matmul.allow_tf32
                   or torch.get_float32_matmul_precision() != "highest")
    readings = drv.readings
    drv.close()
    del drv
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = drv_mod.reference(cfg, cell, seed, dev)
    correct, checks = check.judge(readings, ref, cell["limits"])
    print("leaf gaps: " + json.dumps(check.leaf_gaps(readings, ref)),
          file=sys.stderr, flush=True)

    metrics = {}
    for m in cell_metrics(bench, workload, traced):
        reader = load_module(root / "metrics" / f"{m['name']}.py",
                             f"benchmark_metric_{m['name']}")
        value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": rec["steps"],
           "failed": rec["failed"], "metrics": metrics,
           "device": device_info}
    if traced:
        tr = rec["trace"]
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_json(HERE / "workloads" / f"{args.workload}.json")
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(check.lines(out["checks"]), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
