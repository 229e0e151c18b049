"""BENCHMARK.json and the files it names: the shapes, names and limits
that a benchmark file has to keep to."""

import json
import re
from pathlib import Path

import pytest

from benchmark import check

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = {"n_embd", "n_inner", "n_head", "hidden_size", "intermediate_size",
          "num_attention_heads", "head_dim", "arch_sparse_feature_size",
          "arch_mlp_bot", "arch_mlp_top", "num_experts_per_tok"}
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "workloads",
               "layer", "moves"}


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert (REPO / p).is_dir() and not p.endswith("_torch")


def test_names_units_and_text():
    names = []
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[part]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            for k in ("why", "layer", "source"):
                if k in e and part != "end_to_end" and part != "per_layer":
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                        and "\t" not in e[k]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= METRIC_KEYS
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_configs_files_and_reductions():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["source"].startswith("https://")
        path = REPO / c["file"]
        assert c["file"].startswith(BENCH["paths"][0] + "/") and path.is_file()
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and k in cfg
            assert k not in WIDTHS and not k.endswith(("_dim", "_rank"))


def test_workload_files():
    for w in BENCH["workloads"]:
        cell = json.loads((REPO / "benchmark" / "workloads"
                           / f"{w['name']}.json").read_text())
        assert cell["name"] == w["name"] and cell["config"] == w["config"]
        assert cell["why"] == w["why"] and cell["chips"] == w["chips"]
        assert cell["limits"] and all(map(check.known, cell["limits"]))
        assert all(v > 0 for v in cell["limits"].values())


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        mine = [m for m in BENCH["end_to_end"] if _reports(m, w["name"])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(_reports(m, w["name"]) for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", [w["name"]
                                        for w in BENCH["workloads"]]):
            assert _reports(moved, cell), (m["name"], cell)
        if "roofline" in m["name"] or "mfu" in m["name"] \
                or "share" in m["name"]:
            assert m["unit"] == "%"


def test_layers_are_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    path = REPO / "benchmark" / "metrics" / f"{metric}.py"
    assert path.is_file()
    assert "def read(rec)" in path.read_text()
