"""Whole runs of every cell at tiny sizes on the CPU: the port against the
plain references, the controls and the planted faults held to each cell's
limits, and a cell added as a data file and run by name."""

import json

import pytest
import torch

from benchmark import calibrate, run
from perfbench_tiny import cells, tiny_root

SEED = 2 ** 31 + 977


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("perfbench"))


def _limits(root, cell):
    return run.load_json(root / "workloads" / f"{cell}.json")["limits"]


@pytest.mark.parametrize("cell", cells())
@pytest.mark.parametrize("traced", [False, True])
def test_run_is_correct(root, cell, traced):
    out = run.run_cell(cell, SEED, 0.5, traced, device="cpu", root=root)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(_limits(root, cell))
    bench = run.load_json(root.parent / "BENCHMARK.json")
    want = {m["name"] for m in run.cell_metrics(bench, cell, traced)}
    got = set(out["metrics"])
    if traced:
        # the CPU has no device trace, peaks or kernels to read
        assert got <= want
        assert "breakdown" in out and out["device"]["window_s"] > 0
    else:
        assert got == want


@pytest.mark.parametrize("cell", cells())
def test_control_is_not_correct(root, cell):
    (got,) = calibrate.readings(cell, [SEED], torch.device("cpu"), root,
                                kinds=("control",))
    limits = _limits(root, cell)
    assert any(got["numbers"][k] > v for k, v in limits.items()), got


def _unchanged_lm(real):
    def factory(cfg, lr):
        from multiverso_tpu_torch.models import transformer as tfm

        def step(model, tokens, targets, mask=None):
            return tfm.loss_and_grads(model, tokens, targets, mask, cfg)[0]
        return step
    return factory


def _half_lm(real):
    def factory(cfg, lr):
        inner = real(cfg, lr)

        def step(model, tokens, targets, mask=None):
            h = tokens.shape[0] // 2
            return inner(model, tokens[:h], targets[:h])
        return step
    return factory


def _unchanged_dlrm(real):
    def factory(*a, **k):
        inner = real(*a, **k)

        def step(es, ms, ids, dense, labels):
            copy = lambda s: {"data": s["data"].clone(), "ustate": {
                n: t.clone() for n, t in s["ustate"].items()}}
            return (es, ms) + (inner(copy(es), copy(ms), ids, dense,
                                     labels)[2],)
        return step
    return factory


def _half_dlrm(real):
    def factory(*a, **k):
        inner = real(*a, **k)

        def step(es, ms, ids, dense, labels):
            h = ids.shape[0] // 2
            return inner(es, ms, ids[:h], dense[:h], labels[:h])
        return step
    return factory


def _emb_dlrm(kind):
    """A fault in the embedding's update alone: applied with the wrong
    sign, twice over (a wrong rho), or, from the second step on, one row
    on (a wrong offset in the sparse apply)."""
    def wrap(real):
        def factory(*a, **k):
            inner = real(*a, **k)
            done = []

            def step(es, ms, ids, dense, labels):
                before = es["data"].clone()
                es, ms, loss = inner(es, ms, ids, dense, labels)
                delta = es["data"] - before
                if kind == "sign":
                    es["data"] = before - delta
                elif kind == "rho":
                    es["data"] = before + 2 * delta
                elif done:
                    es["data"] = before + delta.roll(1, 0)
                done.append(1)
                return es, ms, loss
            return step
        return factory
    return wrap


FAULTS = {"lm_ps": {"unchanged": _unchanged_lm, "half_batch": _half_lm},
          "dlrm": {"unchanged": _unchanged_dlrm, "half_batch": _half_dlrm,
                   "emb_sign": _emb_dlrm("sign"),
                   "emb_rho": _emb_dlrm("rho"),
                   "emb_offset": _emb_dlrm("offset")}}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", cells())
def test_fault_is_not_correct(root, cell, fault, monkeypatch):
    from multiverso_tpu_torch.models import dlrm
    from multiverso_tpu_torch.models import transformer as tfm
    cfg = run.load_json(root / "configs" / (
        run.load_json(root / "workloads" / f"{cell}.json")["config"]
        + ".json"))
    mod = tfm if cfg["driver"] == "lm_ps" else dlrm
    broken = FAULTS[cfg["driver"]][fault](mod.make_train_step)
    monkeypatch.setattr(mod, "make_train_step", broken)
    out = run.run_cell(cell, SEED, 0.3, False, device="cpu", root=root)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["emb_sign", "emb_rho", "emb_offset"])
@pytest.mark.parametrize("cell", cells("dlrm"))
def test_embedding_fault_is_not_correct(root, cell, fault, monkeypatch):
    test_fault_is_not_correct(root, cell, fault, monkeypatch)


@pytest.mark.parametrize("fault", ["emb_sign", "emb_rho", "emb_offset"])
@pytest.mark.parametrize("cell", cells("dlrm"))
def test_embedding_fault_in_the_reference_is_not_correct(root, cell, fault):
    (got,) = calibrate.readings(cell, [SEED], torch.device("cpu"), root,
                                kinds=(fault,))
    limits = _limits(root, cell)
    assert any(got["numbers"][k] > v for k, v in limits.items()), got


def test_cell_added_as_data_runs_by_name(tmp_path):
    root = tiny_root(tmp_path)
    src = json.loads((root / "workloads" / "lm590m-local.json").read_text())
    src["name"] = "lm590m-local-copy"
    (root / "workloads" / "lm590m-local-copy.json").write_text(
        json.dumps(src))
    bench = json.loads((root.parent / "BENCHMARK.json").read_text())
    entry = dict(next(w for w in bench["workloads"]
                      if w["name"] == "lm590m-local"))
    entry.update(name="lm590m-local-copy", traffic="local-copy")
    bench["workloads"].append(entry)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "lm590m-local" in m.get("workloads", ()):
            m["workloads"].append("lm590m-local-copy")
    (root.parent / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run.run_cell("lm590m-local-copy", SEED, 0.3, False, device="cpu",
                       root=root)
    assert out["correct"]
    assert set(out["metrics"]) == {"lm_tokens_per_s", "iter_ms_p95",
                                   "setup_s"}
    assert out["metrics"]["lm_tokens_per_s"]["value"] > 0
