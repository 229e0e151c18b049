"""A copy of the benchmark's files under a temporary root whose
configurations hold tiny widths and whose cells hold tiny batches, so that
a whole run (set-up, window, reference, comparison) fits a CPU test. The
cells keep their names, traffic kinds and limits."""

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY_CONFIGS = {
    "cerebras-gpt-590m": dict(vocab_size=1024, n_positions=64, n_embd=256,
                              n_layer=2, n_head=2, n_inner=1024),
    "dlrm-criteo-kaggle": dict(table_rows=[50, 20, 300, 7],
                               arch_mlp_bot="13-32-16", arch_mlp_top="32-1"),
}
TINY_TRAFFIC = {"lm_ps": dict(batch=8, seq_len=64, pool=5),
                "dlrm": dict(batch=64, pool=5)}


def tiny_root(tmp: Path) -> Path:
    root = tmp / "benchmark"
    shutil.copytree(REPO / "benchmark", root,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    drivers = {}
    for name, small in TINY_CONFIGS.items():
        path = root / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(small)
        drivers[name] = cfg["driver"]
        path.write_text(json.dumps(cfg))
    for path in (root / "workloads").glob("*.json"):
        cell = json.loads(path.read_text())
        cell["traffic"].update(TINY_TRAFFIC[drivers[cell["config"]]])
        if cell["traffic"].get("sync_every"):
            cell["traffic"]["sync_every"] = 4
        path.write_text(json.dumps(cell))
    return root


def cells(driver=None):
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    out = []
    for w in bench["workloads"]:
        cfg = json.loads((REPO / "benchmark" / "configs"
                          / f"{w['config']}.json").read_text())
        if driver is None or cfg["driver"] == driver:
            out.append(w["name"])
    return out
