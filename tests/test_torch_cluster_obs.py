"""Port parity, the cluster aggregator (``telemetry/aggregator.py``) and
its tools (``tools/mvtop.py``, ``tools/mvautoscale.py``, the cluster half
of ``tools/dump_metrics.py``, ``tools/check_obs_surface.py``), mirroring
``tests/test_cluster_obs.py``.

* Pure functions: the same numpy-made per-rank payloads (monitors,
  shards with sketches and tenant meters, serving, profile, memory,
  devices, tenants and slo blocks, an unreachable rank) and the same
  record sequences go through both packages' ``merge_cluster``,
  ``derive_rates`` and ``compact_record``: the records are equal, only
  the wall-clock ``ts`` excluded.
* Live, on the CPU: two ranks on both wire planes; the port's record
  equals its own shards' ``stats()`` sums exactly, the merged latency
  histograms' counts equal the process's monitors, the hot row heads the
  cluster top-K, rates come from consecutive polls, a dead rank is an
  entry, and ``cluster.jsonl``/``cluster.prom`` parse with the port's
  ``dump_metrics``.
* The tools: ``mvtop --once`` and ``--json``, ``mvautoscale`` against the
  root tool's ``recommend`` on the same snapshots and its exit codes, the
  cluster view of ``dump_metrics`` against the root tool's text, and the
  port's surface lint clean.
"""

import contextlib
import importlib.util
import io
import json
import time
from pathlib import Path

import numpy as np
import pytest

from multiverso_tpu.telemetry import aggregator as jagg
from multiverso_tpu_torch.ps import service as tsvc
from multiverso_tpu_torch.ps import tables as ttables
from multiverso_tpu_torch.telemetry import aggregator as tagg
from multiverso_tpu_torch.telemetry import hotkeys as thot
from multiverso_tpu_torch.telemetry import signals as tsig
from multiverso_tpu_torch.telemetry import slo as tslo
from multiverso_tpu_torch.telemetry import watchdog as twd
from multiverso_tpu_torch.telemetry.histogram import Histogram
from multiverso_tpu_torch.tools import check_obs_surface as tcheck
from multiverso_tpu_torch.tools import dump_metrics as tdump
from multiverso_tpu_torch.tools import mvautoscale as tauto
from multiverso_tpu_torch.tools import mvtop as tmvtop
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard

REPO = Path(__file__).resolve().parents[1]


def _root_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_root_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _no_ts(rec):
    """A record as JSON, the wall-clock stamp dropped (the one field the
    two packages cannot share)."""
    out = json.loads(json.dumps(rec))
    out.pop("ts", None)
    return out


@pytest.fixture(autouse=True)
def _clean():
    yield
    tagg.stop_global(final=False)
    twd.reset()   # the first PSService started the process's watchdog
    tslo.reset()
    tsig.reset()
    tconfig.reset_flags()
    TDashboard.reset()


# ---------------------------------------------------------------------- #
# numpy-made payloads
# ---------------------------------------------------------------------- #
def _hist(rng, n):
    h = Histogram()
    for v in rng.lognormal(0.0, 1.0, n):
        h.observe(float(v))
    return h.as_dict()


def _sketch(rng, lo, hot):
    sk = thot.SpaceSaving(16)
    for k in rng.integers(lo, lo + 32, 200).tolist() + [hot] * 40:
        sk.offer(int(k))
    return sk.to_dict()


def _payloads(seed: int, world: int = 3, scale: int = 1):
    """Per-rank MSG_STATS / MSG_HEALTH payloads: rank 0 and 1 share one
    process (the in-process dedupe), the last rank is unreachable on odd
    seeds. ``scale`` multiplies every counter (consecutive polls)."""
    rng = np.random.default_rng(seed)
    stats, health = {}, {}
    for r in range(world):
        if seed % 2 and r == world - 1:
            err = ConnectionRefusedError("probe refused")
            stats[r], health[r] = err, err
            continue
        pid = 100 if r < 2 else 200 + r
        adds = int(rng.integers(10, 100)) * scale
        gets = int(rng.integers(10, 100)) * scale
        sh = {"kind": "row", "lo": 32 * r, "rows": 32, "adds": adds,
              "applies": adds, "gets": gets, "get_bytes": gets * 16,
              "add_bytes": adds * 16, "queue_depth": int(rng.integers(3)),
              "version": adds, "apply": _hist(rng, 50),
              "hotkeys": _sketch(rng, 32 * r, 32 * r + 3),
              "tenants": {"default": {"ops": adds, "add_bytes": 4,
                                      "get_bytes": 8},
                          "acme": {"ops": 3 * scale, "add_bytes": 12,
                                   "get_bytes": 0},
                          "~sketch": {"capacity": 64, "total": 3,
                                      "observed": 3,
                                      "items": [["acme", 3, 0]]}}}
        st = {"rank": r, "world": world, "pid": pid,
              "addr": f"127.0.0.1:{7000 + r}",
              "monitors": {"table[t].add_rows": _hist(rng, 40),
                           "ps[t].serve": _hist(rng, 30)},
              "shards": {"t": sh, "bad": {"error": "RuntimeError: x"}},
              "serving": {"t": {
                  "epoch": 5 * scale, "age_s": 0.25, "bound_s": 2.0,
                  "refresh_ms": 1.5, "cache_rows": 8,
                  "cache_hit_rate": 0.5, "served": 40 * scale,
                  "shed": 4 * scale, "deferred": 1, "cache_hits": 20,
                  "cache_misses": 20,
                  "pool": {"active": 2, "spares_left": 1,
                           "members": [{"active": True, "age_s": 0.3,
                                        "epoch": 4 * scale}]}}},
              "profile": {"stall_fraction": 0.1 * (r + 1),
                          "steady_recompiles": r,
                          "phases": {"push": 1.0 + r, "ps_wait": 2.0}},
              "memory": {"rss_mb": 100.5 + r, "hwm_mb": 120.0,
                         "device_bytes": 1 << 20, "samples": 3,
                         "totals": {"table_bytes": 4096,
                                    "retained_bytes": 0,
                                    "pending_bytes": 0,
                                    "pinned_epochs": 0,
                                    "retired_bytes": 0},
                         "verdicts": [{"kind": "rss-creep"}]},
              "devices": {"transfers": {"h2d": {"bytes": 1000 * scale},
                                        "d2h": {"bytes": 10}},
                          "per_device": {"cuda:0": {"bytes": 1 << 16}}},
              "tenants": {"tables": {"t": {
                  "victim": {"served": 10 * scale, "shed": 1,
                             "deferred": 0, "max_age_s": 0.5,
                             "infer": _hist(rng, 10)},
                  "storm": {"served": 30 * scale, "shed": 9 * scale,
                            "deferred": 2, "max_age_s": 0.7,
                            "infer": _hist(rng, 10)}}},
                  "shares": {"storm": 0.8, "victim": 0.2},
                  "episodes": 1, "active": bool(r % 2),
                  "verdict": {"kind": "noisy-neighbor", "tenant": "storm",
                              "share": 0.8, "victims": ["victim"],
                              "why": ["shed"], "ts": 10.0 + r},
                  "admission": {"t/storm/infer": {
                      "admitted": 5, "shed": 9, "qps_limit": 50.0}}}}
        if r == 0:
            st["slo"] = {"objectives": {"a": {"kind": "availability",
                                              "firing": False,
                                              "burn_fast": 0.5}},
                         "firing": [], "episodes": 0, "evals": 3,
                         "straggler": None, "recent": []}
        stats[r] = st
        health[r] = {"status": "ok", "addr": st["addr"], "gen": 0,
                     "native": False, "queue_depth": sh["queue_depth"],
                     "inflight": 0, "oldest_inflight_s": 0.0,
                     "serve_age_s": 0.1, "apply_age_s": 0.2}
    return stats, health


# ---------------------------------------------------------------------- #
# pure merge math against the JAX package
# ---------------------------------------------------------------------- #
class TestMergeMath:
    def test_hist_merge_is_exact_and_equals_jax(self):
        rng = np.random.default_rng(3)
        sa, sb = rng.lognormal(0.0, 1.0, 400), rng.lognormal(1.0, 0.5, 300)
        ha, hb, hu = Histogram(), Histogram(), Histogram()
        for s in sa:
            ha.observe(float(s))
        for s in sb:
            hb.observe(float(s))
        for s in np.concatenate([sa, sb]):
            hu.observe(float(s))
        merged = tagg.merge_hist_dicts([ha.as_dict(), hb.as_dict(), None])
        union = hu.as_dict()
        for k in ("count", "buckets", "p50_ms", "p99_ms", "max_ms",
                  "min_ms"):
            assert merged[k] == union[k], k
        assert merged["timed"] == 700
        assert merged == jagg.merge_hist_dicts(
            [ha.as_dict(), hb.as_dict(), None])
        d = {"count": 5, "timed": 0, "sum_ms": 0.0, "min_ms": 0.0,
             "max_ms": 0.0, "buckets": []}
        assert tagg.merge_hist_dicts([d, d]) == jagg.merge_hist_dicts([d, d])

    @pytest.mark.parametrize("seed", range(4))
    def test_skew_equals_jax(self, seed):
        v = np.random.default_rng(seed).integers(0, 50, 1 + seed).tolist()
        assert tagg._skew(v) == jagg._skew(v)
        assert tagg._skew([]) == 1.0 and tagg._skew([40, 0, 0, 0]) == 4.0

    @pytest.mark.parametrize("seed", range(4))
    def test_merge_cluster_equals_jax(self, seed):
        stats, health = _payloads(seed)
        got = tagg.merge_cluster(stats, health, world=3)
        want = jagg.merge_cluster(stats, health, world=3)
        assert _no_ts(got) == _no_ts(want)
        # the process dedupe: ranks 0 and 1 share a pid, so the serving
        # counters count that process once
        assert got["serving"]["t"]["served"] == (
            40 if seed % 2 else 80)
        assert got["tables"]["t"]["adds"] == sum(
            s["shards"]["t"]["adds"] for s in stats.values()
            if isinstance(s, dict))
        assert got["tenants"]["wire"]["acme"]["ops"] == 3 * (
            2 if seed % 2 else 3)
        assert got["slo"]["evals"] == 3

    @pytest.mark.parametrize("seed", range(3))
    def test_derive_rates_and_compact_equal_jax(self, seed):
        got_seq, want_seq = [], []
        for i, scale in enumerate((1, 2, 4)):
            stats, health = _payloads(seed, scale=scale)
            for mod, seq in ((tagg, got_seq), (jagg, want_seq)):
                rec = mod.merge_cluster(stats, health, world=3)
                rec["ts"] = 100.0 + 2.0 * i
                mod.derive_rates(seq[-1] if seq else None, rec)
                seq.append(rec)
        for g, w in zip(got_seq, want_seq):
            assert json.loads(json.dumps(g)) == json.loads(json.dumps(w))
            assert (json.loads(json.dumps(tagg.compact_record(g, top=4)))
                    == json.loads(json.dumps(jagg.compact_record(w,
                                                                 top=4))))
        r = got_seq[2]["rates"]["t"]
        adds = [s["shards"]["t"]["adds"] for s in _payloads(seed)[0]
                .values() if isinstance(s, dict)]
        assert r["adds_per_s"] == pytest.approx(sum(adds) * 2 / 2.0)
        assert got_seq[2]["tenants"]["tables"]["t"]["storm"]["rates"][
            "served_per_s"] > 0
        assert tagg.derive_rates(None, got_seq[0]) is None

    def test_probe_all_concurrent_and_deadline(self):
        def probe_one(r, stats, health):
            if r == 2:
                time.sleep(30)   # a wedged rank never finishes
                return
            time.sleep(0.2)
            stats[r] = {"rank": r, "monitors": {}, "shards": {}}
            health[r] = {"status": "ok"}

        t0 = time.perf_counter()
        stats, health = tagg.probe_all(range(3), probe_one, deadline_s=1.0)
        assert time.perf_counter() - t0 < 2.0
        assert isinstance(stats[2], TimeoutError)
        rec = tagg.merge_cluster(stats, health, world=3)
        assert rec["ranks"]["2"]["status"] == "unreachable"
        assert rec["polled"] == 2


# ---------------------------------------------------------------------- #
# live two-rank worlds of the port, both wire planes
# ---------------------------------------------------------------------- #
@pytest.fixture(params=["native", "python"])
def ranks(request, tmp_path):
    tconfig.set_flag("ps_timeout", 10.0)
    tconfig.set_flag("ps_connect_timeout", 3.0)
    tconfig.set_flag("ps_native", request.param == "native")
    rdv = tsvc.FileRendezvous(str(tmp_path / "rdv"))
    ctxs = [tsvc.PSContext(r, 2, tsvc.PSService(r, 2, rdv), device="cpu")
            for r in range(2)]
    yield ctxs
    for c in ctxs:
        c.close()


def _pair(ctxs, name, rows=32, cols=4, **kw):
    return [ttables.AsyncMatrixTable(rows, cols, name=name, ctx=c, **kw)
            for c in ctxs]


def _zipf_workload(t0, num_row, hot_row, n=40, cols=4):
    rng = np.random.default_rng(7)
    for i in range(n):
        row = hot_row if i % 2 == 0 else int(rng.integers(0, num_row))
        t0.get_rows([row])
        t0.add_rows([row], np.ones((1, cols), np.float32))
    t0.flush()


class TestClusterLive:
    def test_record_equals_the_shards_sums(self, ranks):
        """Two tables: the default updater (served by the C++ server on
        the native plane, its applies folded into the shard's stats) and
        AdaGrad (always the Python plane)."""
        hot = 19   # rank 1 owns [16, 32)
        for name, upd in (("cl", "adagrad"), ("cn", None)):
            t0, _ = _pair(ranks, name, updater=upd)
            _zipf_workload(t0, 32, hot)
        agg = tagg.ClusterAggregator(ranks[0].service)
        rec = agg.poll_once()
        assert rec["kind"] == "cluster" and rec["polled"] == 2
        assert all(e["status"] == "ok" for e in rec["ranks"].values())
        for name in ("cl", "cn"):
            table = rec["tables"][name]
            st = [c.service._shards[name].stats() for c in ranks]
            for k in ("adds", "applies", "gets", "get_bytes", "add_bytes",
                      "rows"):
                assert table[k] == st[0][k] + st[1][k], (name, k)
            assert table["adds"] == 40
            # the C++ server folds its adds and applies into the shard's
            # stats, not its gets
            native = name == "cn" and tconfig.get_flag("ps_native")
            assert table["gets"] == (0 if native else 40)
            assert table["skew"] > 1.1   # the hot row is rank 1's
        # apply histogram: one process-global monitor, counted once
        assert rec["tables"]["cl"]["apply"]["count"] == \
            rec["tables"]["cl"]["applies"]
        hk = rec["hotkeys"]["cl"]
        assert hk["top"][0][0] == hot and hk["total"] == 80
        assert hk["hit_rate_curve"][0][1] >= 0.4
        # the merged monitors are the process's (two ranks, one process)
        local = TDashboard.get("table[cl].add_rows").snapshot()
        assert rec["monitors"]["table[cl].add_rows"]["count"] == \
            local.count
        json.dumps(rec)

    def test_rates_between_polls(self, ranks):
        t0, _ = _pair(ranks, "rt", updater="adagrad")
        t0.add_rows([20], np.ones((1, 4), np.float32))
        agg = tagg.ClusterAggregator(ranks[0].service)
        agg.poll_once()
        time.sleep(0.05)
        for _ in range(10):
            t0.get_rows([20])
        rec = agg.poll_once()
        r = rec["rates"]["rt"]
        assert r["gets_per_s"] == pytest.approx(
            10 / rec["rates"]["_interval_s"], rel=0.02)
        assert r["adds_per_s"] == 0.0
        assert r["skew_window"] == pytest.approx(2.0)
        assert len(agg.history()) == 2

    def test_dead_rank_is_an_entry(self, ranks):
        t0, _ = _pair(ranks, "os", rows=16, cols=2, updater="adagrad")
        t0.add_rows([9], np.ones((1, 2), np.float32))
        st = ranks[0].service.stats_oneshot(1)
        assert st["rank"] == 1 and "os" in st["shards"]
        tconfig.set_flag("ps_connect_timeout", 2.0)
        ranks[1].service.close()
        rec = tagg.ClusterAggregator(ranks[0].service).poll_once(
            timeout=2.0)
        assert rec["ranks"]["0"]["status"] == "ok"
        assert rec["ranks"]["1"]["status"] == "unreachable"
        assert rec["polled"] == 1 and "os" in rec["tables"]

    def test_writes_jsonl_and_prom(self, ranks, tmp_path):
        t0, _ = _pair(ranks, "wf", rows=16, cols=2, updater="adagrad")
        t0.add_rows([9], np.ones((1, 2), np.float32))
        d = tmp_path / "m"
        agg = tagg.ClusterAggregator(ranks[0].service, directory=str(d))
        agg.poll_once()
        agg.poll_once()
        recs = tdump.load_records(str(d / "cluster.jsonl"))
        assert len(recs) == 2 and "rates" in recs[1]
        samples = tdump.load_prom(str(d / "cluster.prom"))
        names = {(n, lb.get("table"), lb.get("rank")) for n, lb, _ in
                 samples}
        assert ("mv_shard_skew", "wf", "cluster") in names
        assert not (d / "cluster.prom.tmp").exists()

    def test_service_starts_and_stops_the_poller(self, ranks, tmp_path):
        """The flags start the aggregator at rank 0 only; closing its
        service stops it after one final poll."""
        assert tagg.ensure_started(ranks[0].service) is None
        tconfig.set_flag("stats_poll_interval_s", 30.0)
        tconfig.set_flag("metrics_dir", str(tmp_path / "m"))
        assert tagg.ensure_started(ranks[1].service) is None
        agg = tagg.ensure_started(ranks[0].service)
        assert agg is not None and tagg.global_aggregator() is agg
        assert tagg.ensure_started(ranks[0].service) is agg
        ranks[0].service.close()
        assert tagg.global_aggregator() is None
        assert len(agg.history()) >= 1
        assert (tmp_path / "m" / "cluster.jsonl").exists()


# ---------------------------------------------------------------------- #
# the tools
# ---------------------------------------------------------------------- #
class TestMvtop:
    def test_once_smoke_and_json(self, ranks, tmp_path):
        t0, _ = _pair(ranks, "mt", updater="adagrad")
        _zipf_workload(t0, 32, 21)
        rdv = str(tmp_path / "rdv")
        rc, out = _run(tmvtop.main, ["--rdv", rdv, "--once"])
        assert rc == 0 and "ranks 2/2 up" in out
        assert "table[mt]" in out and "skew=" in out
        hotline = next(ln for ln in out.splitlines() if "hot rows" in ln)
        assert hotline.split(": ", 1)[1].split(":")[0] == "21"
        rc, out = _run(tmvtop.main, ["--rdv", rdv, "--once", "--json"])
        rec = json.loads(out)
        assert rc == 0 and rec["kind"] == "cluster" and rec["polled"] == 2

    def test_render_equals_the_root_tool(self):
        root = _root_tool("mvtop")
        for seed in range(3):
            stats, health = _payloads(seed)
            rec = tagg.merge_cluster(stats, health, world=3)
            prev = tagg.merge_cluster(*_payloads(seed, scale=1), world=3)
            prev["ts"] = rec["ts"] - 1.0
            assert tmvtop.render(json.loads(json.dumps(rec))) == \
                root.render(json.loads(json.dumps(rec)))
            a, b = json.loads(json.dumps(rec)), json.loads(json.dumps(rec))
            assert tmvtop.render(a, prev=json.loads(json.dumps(prev))) == \
                root.render(b, prev=json.loads(json.dumps(prev)))

    def test_read_addrs_and_unreachable(self, tmp_path):
        d = tmp_path / "rdv"
        assert tmvtop.read_addrs(str(d)) == {}
        d.mkdir()
        (d / "0.addr").write_text("127.0.0.1:1234")
        (d / "1.addr").write_text("127.0.0.1:1235")
        (d / ".0.addr.tmp").write_text("x")
        assert tmvtop.read_addrs(str(d)) == {0: "127.0.0.1:1234",
                                             1: "127.0.0.1:1235"}
        assert tmvtop.read_addrs(str(d), world=1) == {0: "127.0.0.1:1234"}
        rec = tagg.merge_cluster({0: RuntimeError("refused")},
                                 {0: RuntimeError("refused")}, world=1)
        out = tmvtop.render(rec)
        assert "unreachable" in out and "ranks 0/1 up" in out
        assert _run(tmvtop.main, ["--rdv", str(tmp_path / "none"),
                                  "--once"])[0] == 2


class TestMvautoscale:
    SNAPS = [
        {},
        {"shed_rate": {"t": {"value": 0.3}},
         "spares_left": {"t": {"value": 1}}},
        {"shed_rate": {"t": {"value": 0.3}},
         "spares_left": {"t": {"value": 0}}},
        {"burn_rate": {"": {"value": 2.0}},
         "spares_left": {"t": {"value": 2}}},
        {"shed_rate": {"t": {"value": 0.0}},
         "active_replicas": {"t": {"value": 3}},
         "queue_depth": {"t": {"value": 0}}},
        {"queue_depth": {"t": {"value": 1000}}},
        {"shed_rate": {"t": {"value": "bad"}}},
    ]

    def test_recommend_equals_the_root_tool(self):
        root = _root_tool("mvautoscale")
        got = [tauto.recommend(s) for s in self.SNAPS]
        assert got == [root.recommend(s) for s in self.SNAPS]
        assert [v["action"] for v in got] == [
            "hold", "grow", "hold", "grow", "shrink", "hold", "hold"]
        stats, health = _payloads(0)
        rec = tagg.merge_cluster(stats, health, world=3)
        assert tauto.snapshot_from_record(rec) == \
            root.snapshot_from_record(rec)

    def test_cli_exit_codes(self, ranks, tmp_path):
        _pair(ranks, "as", rows=16, cols=2, updater="adagrad")
        rdv = str(tmp_path / "rdv")
        assert _run(tauto.main, ["--rdv", rdv])[0] == 2   # no --dry-run
        rc, out = _run(tauto.main, ["--rdv", rdv, "--dry-run", "--json",
                                    "--interval", "0.05"])
        assert rc == 0 and json.loads(out)["action"] == "hold"
        assert _run(tauto.main, ["--rdv", str(tmp_path / "none"),
                                 "--dry-run"])[0] == 2


class TestDumpMetricsCluster:
    def test_show_and_diff_equal_the_root_tool(self):
        root = _root_tool("dump_metrics")
        recs = []
        for i, scale in enumerate((1, 3)):
            rec = tagg.merge_cluster(*_payloads(1, scale=scale), world=3)
            rec["ts"] = 100.0 + i
            tagg.derive_rates(recs[-1] if recs else None, rec)
            recs.append(json.loads(json.dumps(rec)))
        for rec in recs:
            out = tdump.format_record(rec)
            assert out == root.format_record(rec)
            assert "table[t]:" in out and "skew=" in out
        out = tdump.diff_records(recs[0], recs[1])
        assert out == root.diff_records(recs[0], recs[1])
        assert "skew b/a" in out


def test_obs_surface_lint_clean_and_catches_a_dark_key():
    assert tcheck.check() == []
    found = tcheck.stats_surface_findings(
        keys_by_src={"x.py:stats()": ["never_rendered_key"]},
        renderer_text='"adds"')
    assert len(found) == 1 and "never_rendered_key" in found[0]
    assert tcheck.slo_surface_findings(kinds=["nope"], signal_names=[],
                                       renderer_text="")
    assert tcheck.tenant_surface_findings(
        keys_by_src={"t.py:note()": ["dark"]}, renderer_text="")
    rc, out = _run(tcheck.main, [])
    assert rc == 0 and "observability surface clean" in out
