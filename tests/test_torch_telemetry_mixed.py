"""A mixed world — rank 0 runs the JAX package, rank 1 the port — seen by
both packages' telemetry tools.

Both ranks trace (flag ``trace_ids``), profile steps (``step_profile``),
export metrics and dump their flight recorders into shared directories.
The files are one format, so:

* a trace ID minted by either package's client stitches to the other
  package's serve and apply spans;
* the root ``tools/postmortem.py`` and ``multiverso_tpu_torch.tools.
  postmortem`` print the same merged report of the two dumps;
* the root ``tools/mvprof.py`` and ``tools/dump_metrics.py`` read the
  port's step and metrics files, and the port's copies read the JAX
  package's, with the same output as the other package's tool;
* in a mixed world of either order, each package's cluster aggregator
  polls the other's rank to the same per-table totals, and the root
  ``tools/mvtop.py`` and the port's render either's ``cluster.jsonl``
  alike.
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest

from multiverso_tpu.ps import service as jsvc
from multiverso_tpu.ps import tables as jtables
from multiverso_tpu.telemetry import exporter as jexp
from multiverso_tpu.telemetry import flightrec as jfr
from multiverso_tpu.telemetry import profiler as jprof
from multiverso_tpu.telemetry import trace as jtrace
from multiverso_tpu.utils import config as jconfig
from multiverso_tpu_torch.ps import service as tsvc
from multiverso_tpu_torch.ps import tables as ttables
from multiverso_tpu_torch.telemetry import devstats as tdev
from multiverso_tpu_torch.telemetry import exporter as texp
from multiverso_tpu_torch.telemetry import flightrec as tfr
from multiverso_tpu_torch.telemetry import memstats as tmem
from multiverso_tpu_torch.telemetry import profiler as tprof
from multiverso_tpu_torch.telemetry import trace as ttrace
from multiverso_tpu_torch.telemetry import watchdog as twd
from multiverso_tpu_torch.tools import dump_metrics as tdump
from multiverso_tpu_torch.tools import mvprof as tmvprof
from multiverso_tpu_torch.tools import postmortem as tpm
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils import log as tlog
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard

REPO = Path(__file__).resolve().parents[1]


def _root_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_root_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _reset_port() -> None:
    texp.stop_global()
    ttrace.TRACER.reset()
    ttrace.TRACER.enabled = False
    tprof.reset()
    tmem.reset()
    tdev.reset()
    twd.reset()
    tfr.reset()
    tlog.reset_rank()
    tconfig.reset_flags()
    TDashboard.reset()


@pytest.fixture
def world(tmp_path):
    """Rank 0 a JAX service, rank 1 a port service on the CPU, both on
    the Python plane (the native fast path is untraced by design), with
    tracing, step profiling and file output on in both packages."""
    _reset_port()
    dirs = {k: tmp_path / k for k in ("rdv", "fr", "metrics")}
    for cfg in (jconfig, tconfig):
        cfg.set_flag("ps_native", False)
        cfg.set_flag("ps_timeout", 10.0)
        cfg.set_flag("ps_connect_timeout", 3.0)
        cfg.set_flag("trace_ids", True)
        cfg.set_flag("step_profile", True)
        cfg.set_flag("flightrec_dir", str(dirs["fr"]))
        cfg.set_flag("metrics_dir", str(dirs["metrics"]))
    jctx = jsvc.PSContext(0, 2, jsvc.PSService(
        0, 2, jsvc.FileRendezvous(str(dirs["rdv"]))))
    tctx = tsvc.PSContext(1, 2, tsvc.PSService(
        1, 2, tsvc.FileRendezvous(str(dirs["rdv"]))), device="cpu")
    jt = jtables.AsyncMatrixTable(20, 4, name="mx", ctx=jctx)
    tt = ttables.AsyncMatrixTable(20, 4, name="mx", ctx=tctx)
    try:
        yield dirs, jt, tt
    finally:
        tctx.close()
        jctx.close()
        jexp.stop_global()
        _reset_port()


def _drive(jt, tt):
    """Each client adds to and reads rows of both owners, as steps."""
    rng = np.random.default_rng(15)
    want = np.zeros((20, 4), np.float32)
    for table, prof in ((jt, jprof), (tt, tprof)):
        for _ in range(3):
            with prof.step("mixed.step"):
                ids = rng.choice(20, size=6, replace=False)
                v = rng.normal(size=(6, 4)).astype(np.float32)
                with prof.phase("push"):
                    table.add_rows(ids, v)
                want[ids] += v
                with prof.phase("ps_wait"):
                    got = table.get_rows(np.arange(20))
        np.testing.assert_array_equal(got, want)


def test_trace_ids_stitch_across_packages(world):
    dirs, jt, tt = world
    _drive(jt, tt)
    assert jtrace.dump_to(str(dirs["metrics"])) > 0
    assert ttrace.dump_to(str(dirs["metrics"])) > 0
    spans = {}
    for r in (0, 1):
        path = dirs["metrics"] / f"trace-rank{r}.jsonl"
        spans[r] = [json.loads(l) for l in open(path)]
    # each package's client spans carry ids minted with its rank in the
    # high bits; the OTHER package's server spans carry the same ids
    for client, server in ((1, 0), (0, 1)):
        minted = {e["args"]["trace"] for e in spans[client]
                  if e["name"] in ("client.add_rows", "client.get_rows")}
        assert minted and all(t >> 32 == client for t in minted)
        served = {e["args"]["trace"] for e in spans[server]
                  if e["name"] in ("ps.serve", "shard.apply",
                                   "shard.get_gather")}
        # the client's add reached the owner's serve and apply
        assert minted & served
        chain = {e["name"] for e in spans[server]
                 if e["args"].get("trace") in minted}
        assert {"ps.serve", "shard.apply"} <= chain


def test_postmortem_merges_a_mixed_world(world):
    dirs, jt, tt = world
    _drive(jt, tt)
    assert jfr.dump_global("mixed world check") is not None
    assert tfr.dump_global("mixed world check") is not None
    fr = str(dirs["fr"])
    root = _root_tool("postmortem")
    for argv in ([fr], [fr, "--json"]):
        assert _run(root.main, argv) == _run(tpm.main, argv)
    rep = json.loads(_run(tpm.main, [fr, "--json"]))
    assert rep["ranks"] == [0, 1]
    assert {r["rank"] for r in rep["timeline"]} == {0, 1}


def test_root_tools_read_port_files_and_back(world):
    dirs, jt, tt = world
    _drive(jt, tt)
    m = str(dirs["metrics"])
    jprof.dump_to(m)
    tprof.dump_to(m)
    # one exporter record per package (rank 0 the JAX one, 1 the port's)
    jexp.ensure_started(0, jt.ctx.service.stats_payload)
    texp.ensure_started(1, tt.ctx.service.stats_payload)
    jexp.export_global()
    texp.export_global()
    root_prof, root_dump = _root_tool("mvprof"), _root_tool("dump_metrics")
    # mvprof over both ranks' step records, either tool
    for argv in ([m, "--json"], [m, "--report"]):
        assert _run(root_prof.main, argv) == _run(tmvprof.main, argv)
    rep = json.loads(_run(tmvprof.main, [m, "--json"]))
    assert set(rep["ranks"]) == {"0", "1"}
    assert rep["ranks"]["1"]["steps"] == 3
    # dump_metrics on each package's metrics and step files, either tool
    for r in (0, 1):
        for name in (f"metrics-rank{r}.jsonl", f"profile-rank{r}.jsonl"):
            argv = ["show", str(dirs["metrics"] / name)]
            assert _run(root_dump.main, argv) == _run(tdump.main, argv)
    out = _run(tdump.main, ["show", str(dirs["metrics"] /
                                        "metrics-rank1.jsonl")])
    assert "table[mx].add_rows" in out
    rec = json.loads((dirs["metrics"] / "metrics-rank1.jsonl")
                     .read_text().splitlines()[-1])
    assert rec["rank"] == 1 and "memory" in rec and "mx" in rec["shards"]
    # the .prom text parses as one sample per non-comment line
    for line in (dirs["metrics"] / "metrics-rank1.prom").read_text() \
            .splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            float(value)
    # to-perfetto wraps the port's spans for the viewer
    ttrace.dump_to(m)
    out_json = str(dirs["metrics"] / "perfetto.json")
    _run(tdump.main, ["to-perfetto", str(dirs["metrics"] /
                                         "trace-rank1.jsonl"), out_json])
    assert json.load(open(out_json))["traceEvents"]


# ---------------------------------------------------------------------- #
# the cluster plane across packages
# ---------------------------------------------------------------------- #
@pytest.fixture(params=["jax_rank0", "port_rank0"])
def cluster_world(request, tmp_path):
    """A mixed world of two ranks in either order (the Python plane in
    both packages), a table written and read from both clients, and each
    package's aggregator bound to its own rank's service."""
    from multiverso_tpu.telemetry import aggregator as jagg
    from multiverso_tpu_torch.telemetry import aggregator as tagg
    _reset_port()
    for cfg in (jconfig, tconfig):
        cfg.set_flag("ps_native", False)
        cfg.set_flag("ps_timeout", 10.0)
        cfg.set_flag("ps_connect_timeout", 3.0)
    rdv = str(tmp_path / "rdv")
    jr = 0 if request.param == "jax_rank0" else 1
    jctx = jsvc.PSContext(jr, 2, jsvc.PSService(
        jr, 2, jsvc.FileRendezvous(rdv)))
    tctx = tsvc.PSContext(1 - jr, 2, tsvc.PSService(
        1 - jr, 2, tsvc.FileRendezvous(rdv)), device="cpu")
    jt = jtables.AsyncMatrixTable(20, 4, name="cx", ctx=jctx,
                                  updater="adagrad")
    tt = ttables.AsyncMatrixTable(20, 4, name="cx", ctx=tctx,
                                  updater="adagrad")
    rng = np.random.default_rng(5)
    for table in (jt, tt):
        for i in range(12):
            row = 13 if i % 2 else int(rng.integers(0, 20))
            table.add_rows([row], np.ones((1, 4), np.float32))
            table.get_rows([row])
    aggs = {"jax": jagg.ClusterAggregator(
                jctx.service, directory=str(tmp_path / "jax")),
            "port": tagg.ClusterAggregator(
                tctx.service, directory=str(tmp_path / "port"))}
    try:
        yield tmp_path, aggs
    finally:
        tctx.close()
        jctx.close()
        _reset_port()


def test_aggregators_poll_each_other(cluster_world):
    """Each package's aggregator polls the other's rank over its one-shot
    probes: the per-table totals, the per-shard scalars and the hot keys
    are the same."""
    _, aggs = cluster_world
    recs = {k: a.poll_once() for k, a in aggs.items()}
    for rec in recs.values():
        assert rec["polled"] == 2
        assert all(e["status"] == "ok" for e in rec["ranks"].values())
    j, t = recs["jax"]["tables"]["cx"], recs["port"]["tables"]["cx"]
    for k in ("adds", "applies", "gets", "get_bytes", "add_bytes", "rows",
              "queue_depth", "skew"):
        assert j[k] == t[k], k
    assert j["shards"] == t["shards"]
    assert j["adds"] == 24 and j["gets"] == 24
    assert recs["jax"]["hotkeys"]["cx"] == recs["port"]["hotkeys"]["cx"]
    assert recs["port"]["hotkeys"]["cx"]["top"][0][0] == 13


def test_mvtops_render_each_others_cluster_jsonl(cluster_world):
    """The root ``tools/mvtop.py`` and the port's render either
    package's ``cluster.jsonl`` to the same screen."""
    from multiverso_tpu_torch.tools import mvtop as tmvtop
    tmp_path, aggs = cluster_world
    for a in aggs.values():
        a.poll_once()
        a.poll_once()
    root = _root_tool("mvtop")
    for k in aggs:
        recs = tdump.load_records(str(tmp_path / k / "cluster.jsonl"))
        assert len(recs) == 2 and "rates" in recs[1]
        for rec in recs:
            out = tmvtop.render(json.loads(json.dumps(rec)))
            assert out == root.render(json.loads(json.dumps(rec)))
            assert "ranks 2/2 up" in out and "table[cx]" in out
