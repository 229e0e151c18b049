"""Port parity, the SLO sentinel (``telemetry/slo.py``) and the signal bus
(``telemetry/signals.py``), mirroring ``tests/test_slo.py``: the same spec
and the same record sequences go through both packages' ``normalize_spec``,
``measure``, ``burn_rates``, ``straggler``, ``from_record`` and sentinel
``on_poll``, and the measurements, signals, burn rates, snapshots,
episodes and ``alerts.jsonl`` lines are equal (the records' ``ts`` are
set by the test, so nothing is excluded). Then the port alone: the bus,
the sentinel's lifecycle with its flight-recorder events, a live
two-rank pool publishing on the bus, the ``slo`` block of the stats
payload (absent while disarmed), mvtop's SLO panel against the root
tool's text and its ``--assert-slo`` exit, and lint 7."""

import contextlib
import importlib.util
import io
import json
import time
from pathlib import Path

import numpy as np
import pytest

from multiverso_tpu.telemetry import signals as jsig
from multiverso_tpu.telemetry import slo as jslo
from multiverso_tpu.utils import config as jconfig
from multiverso_tpu_torch.ps import service as tsvc
from multiverso_tpu_torch.ps import tables as ttables
from multiverso_tpu_torch.serving.pool import ReplicaPool
from multiverso_tpu_torch.telemetry import aggregator as tagg
from multiverso_tpu_torch.telemetry import flightrec as tfr
from multiverso_tpu_torch.telemetry import signals as tsig
from multiverso_tpu_torch.telemetry import slo as tslo
from multiverso_tpu_torch.telemetry import watchdog as twd
from multiverso_tpu_torch.tools import check_obs_surface as tcheck
from multiverso_tpu_torch.tools import mvautoscale as tauto
from multiverso_tpu_torch.tools import mvtop as tmvtop
from multiverso_tpu_torch.utils import config as tconfig

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean_sentinel():
    """Both packages' sentinels and buses are process-global: every test
    starts and ends disarmed."""
    for m in (tslo, tsig, jslo, jsig):
        m.reset()
    yield
    for m in (tslo, tsig, jslo, jsig):
        m.reset()
    jconfig.set_flag("slo_spec", "")
    twd.reset()   # the first PSService started the process's watchdog
    tconfig.reset_flags()


def _root_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_root_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stall_obj(**kw):
    base = {"name": "stall", "kind": "stall_fraction", "target": 0.9,
            "max": 0.5, "fast_window_s": 4.0, "slow_window_s": 10.0,
            "fast_burn": 1.0, "slow_burn": 0.1}
    base.update(kw)
    return base


def _stall_rec(ts, v=None):
    rec = {"ts": float(ts), "ranks": {"0": {"status": "serving"},
                                     "1": {"status": "serving"}}}
    if v is not None:
        rec["profile"] = {"0": {"stall_fraction": float(v)}}
    return rec


def _records(seed: int, n: int = 24):
    """A numpy-made poll stream that exercises every objective kind:
    latency monitors, serving ages and rates, profiles, availability
    (reachability, progress, pent demand, idle) and holes."""
    rng = np.random.default_rng(seed)
    recs = []
    for t in range(n):
        down = rng.random() < 0.1
        rec = {"ts": float(t), "world": 2,
               "ranks": {"0": {"status": "ok", "queue_depth": 0},
                         "1": {"status": "unreachable" if down else "ok",
                               "queue_depth": int(rng.integers(0, 9)),
                               "oldest_inflight_s": float(rng.random())}}}
        if rng.random() < 0.8:
            rec["monitors"] = {
                "ps[tb].serve": {"count": 5, "timed": 5,
                                 "p99_ms": float(rng.uniform(0, 10))},
                "table[tb].add_rows": {"count": 3, "timed": 3,
                                       "p99_ms": float(rng.uniform(0, 4))}}
        if rng.random() < 0.7:
            served, shed = rng.uniform(0, 50, 2)
            rec["serving"] = {"tb": {
                "replicas": {"0": {"age_s": float(rng.uniform(0, 3))}},
                "pools": {"0": {"spares_left": 1, "active": 2,
                                "members": [{"active": True,
                                             "age_s": float(rng.random()),
                                             "epoch": t}]}},
                "rates": {"served_per_s": float(served),
                          "shed_per_s": float(shed)}}}
        if rng.random() < 0.6:
            rec["profile"] = {
                "0": {"stall_fraction": float(rng.random()),
                      "steady_recompiles": int(rng.integers(0, 2)),
                      "phases": {"push": float(rng.random())}},
                "1": {"stall_fraction": float(rng.random()),
                      "phases": {"apply": float(rng.random() * 3)}}}
        if t and rng.random() < 0.8:
            rec["rates"] = {"tb": {"adds_per_s": float(
                rng.choice([0.0, rng.uniform(0, 20)]))}}
            rec["memory"] = {"totals": {"retained_bytes": int(
                rng.choice([0, 4096]))}}
            rec["tables"] = {"tb": {"queue_depth": 0, "shards": {
                "0": {"version": t}}}}
        recs.append(rec)
    return recs


SPEC = {"fast_window_s": 4.0, "slow_window_s": 12.0, "fast_burn": 1.0,
        "slow_burn": 0.2, "objectives": [
            {"name": "serve", "kind": "serve_latency_p99", "table": "tb",
             "threshold_ms": 6.0, "target": 0.8},
            {"name": "add", "kind": "add_latency_p99", "table": "tb",
             "max": 3.0},
            {"name": "stale", "kind": "staleness", "table": "tb",
             "max": 2.0, "target": 0.7},
            {"name": "shed", "kind": "shed_rate", "table": "tb",
             "max": 0.5},
            {"name": "avail", "kind": "availability", "table": "tb",
             "target": 0.9},
            {"name": "stall", "kind": "stall_fraction", "max": 0.6},
            {"name": "recomp", "kind": "steady_recompiles", "max": 0.0},
            {"name": "rec", "kind": "recovery_s", "max": 3.0},
            {"name": "eff", "kind": "scale_efficiency", "min": 0.8}]}


# ---------------------------------------------------------------------- #
# the pure layer against the JAX package
# ---------------------------------------------------------------------- #
class TestPureParity:
    def test_spec_normalizes_alike_and_fails_alike(self):
        assert tslo.normalize_spec(SPEC) == jslo.normalize_spec(SPEC)
        assert tslo.OBJECTIVE_KINDS == jslo.OBJECTIVE_KINDS
        assert tsig.SIGNAL_NAMES == jsig.SIGNAL_NAMES
        for bad, msg in (
                ({"objectives": [{"name": "x", "kind": "nope"}]},
                 "unknown SLO objective"),
                ({"objectives": [{"name": "x", "kind": "staleness"},
                                 {"name": "x", "kind": "shed_rate"}]},
                 "duplicate"),
                ({"objectives": [{"name": "x", "kind": "staleness",
                                  "target": 1.0}]}, "target")):
            for mod in (tslo, jslo):
                with pytest.raises(ValueError, match=msg):
                    mod.normalize_spec(bad)
        raw = json.dumps(SPEC)
        assert tslo.load_spec(raw) == jslo.load_spec(raw) == SPEC

    @pytest.mark.parametrize("seed", range(3))
    def test_measure_burn_and_straggler_equal_jax(self, seed):
        recs = _records(seed)
        ext = {"rec": 4.5, "eff": 0.7}
        objs = tslo.normalize_spec(SPEC)["objectives"]
        for obj in objs:
            for i, rec in enumerate(recs):
                got = tslo.measure(obj, rec, ext)
                assert got == jslo.measure(obj, rec, ext), (obj["name"], i)
                if got is not None:
                    assert tslo.violates(obj, got) == \
                        jslo.violates(obj, got)
                h = recs[:i + 1]
                assert tslo.burn_rates(obj, h, external=ext) == \
                    jslo.burn_rates(obj, h, external=ext)
        for rec in recs:
            assert tslo.straggler(rec) == jslo.straggler(rec)

    @pytest.mark.parametrize("seed", range(3))
    def test_signals_from_record_equal_jax(self, seed):
        for rec in _records(seed):
            rec["slo"] = {"objectives": {"a": {"burn_fast": float(seed)},
                                         "b": {"burn_fast": 2.5}},
                          "firing": ["b"]}
            rec["hotkeys"] = {"tb": {"total": 100,
                                     "top": [[1, 40, 0], [2, 10, 0]]}}
            got = [tuple(s) for s in tsig.from_record(rec)]
            assert got == [tuple(s) for s in jsig.from_record(rec)]
        assert {s.name for s in tsig.from_record(rec)} >= {
            "burn_rate", "hot_key_mass"}

    @pytest.mark.parametrize("seed", range(3))
    def test_sentinel_episodes_equal_jax(self, seed, tmp_path):
        """The sentinel's whole poll stream — snapshots, episodes and
        the alerts.jsonl lines — equals the JAX sentinel's."""
        out = {}
        for name, mod in (("port", tslo), ("jax", jslo)):
            s = mod.SLOSentinel(SPEC)
            s.note_value("rec", 4.5)
            s.note_value("eff", 0.9)
            d = tmp_path / name
            hist, snaps = [], []
            for rec in _records(seed):
                hist.append(rec)
                snaps.append(s.on_poll(rec, list(hist), str(d)))
            alerts = ((d / "alerts.jsonl").read_text().splitlines()
                      if (d / "alerts.jsonl").exists() else [])
            out[name] = (json.loads(json.dumps(snaps)), alerts)
        assert out["port"] == out["jax"]
        assert out["port"][0][-1]["evals"] == 24
        assert out["port"][1], "the stream fires at least one episode"


# ---------------------------------------------------------------------- #
# the port's sentinel and bus
# ---------------------------------------------------------------------- #
class TestLifecycle:
    def test_fire_hold_clear_refire_with_ring_events(self, tmp_path):
        s = tslo.SLOSentinel({"objectives": [_stall_obj()]})
        evs = (tfr.EV_SLO_FIRED, tfr.EV_SLO_CLEARED)
        before = len([e for e in tfr.RECORDER.snapshot() if e[2] in evs])
        hist, snaps = [], []
        for t in range(12):
            rec = _stall_rec(t, 0.9 if t in (4, 5, 11) else 0.1)
            hist.append(rec)
            snaps.append(s.on_poll(rec, list(hist), str(tmp_path)))
        assert [bool(sn["firing"]) for sn in snaps] == \
            [False] * 4 + [True] * 6 + [False] + [True]
        assert [snaps[i]["episodes"] for i in (4, 5, 11)] == [1, 1, 2]
        alerts = [json.loads(ln) for ln in
                  (tmp_path / "alerts.jsonl").read_text().splitlines()]
        assert [a["kind"] for a in alerts] == [
            "slo.fired", "slo.cleared", "slo.fired"]
        assert [a["ts"] for a in alerts] == [4.0, 10.0, 11.0]
        ring = [e for e in tfr.RECORDER.snapshot() if e[2] in evs][before:]
        assert [e[2] for e in ring] == [tfr.EV_SLO_FIRED,
                                        tfr.EV_SLO_CLEARED,
                                        tfr.EV_SLO_FIRED]
        assert "stall" in ring[0][7]

    def test_disarmed_is_none_and_the_flag_arms_lazily(self):
        s = tslo.SLOSentinel()
        assert s.on_poll(_stall_rec(0, 0.1), [_stall_rec(0, 0.1)]) is None
        assert not tslo.enabled() and tslo.stats_snapshot() is None
        tconfig.set_flag("slo_spec", json.dumps(
            {"objectives": [_stall_obj()]}))
        snap = tslo.SLOSentinel().on_poll(
            _stall_rec(1, 0.1), [_stall_rec(1, 0.1)])
        assert snap is not None and "stall" in snap["objectives"]

    def test_bus_subscribe_latest_and_filter(self):
        bus = tsig.SignalBus()
        seen, shed_only = [], []
        unsub = bus.subscribe(seen.append)
        bus.subscribe(shed_only.append, name="shed_rate")
        bus.publish([tsig.Signal("shed_rate", "pl", 0.5, 1.0, {}),
                     tsig.Signal("queue_depth", "pl", 3.0, 1.0, {})])
        assert [s.name for s in seen] == ["shed_rate", "queue_depth"]
        assert [s.name for s in shed_only] == ["shed_rate"]
        assert bus.latest("queue_depth", "pl").value == 3.0
        assert bus.snapshot()["shed_rate"]["pl"]["value"] == 0.5
        unsub()
        bus.publish([tsig.Signal("shed_rate", "pl", 0.1, 2.0, {})])
        assert len(seen) == 2


# ---------------------------------------------------------------------- #
# live two-rank world on the CPU
# ---------------------------------------------------------------------- #
@pytest.fixture
def world(tmp_path):
    for k, v in dict(ps_native=False, ps_timeout=30.0,
                     ps_connect_timeout=5.0).items():
        tconfig.set_flag(k, v)
    rdv = tsvc.FileRendezvous(str(tmp_path / "rdv"))
    ctxs = [tsvc.PSContext(r, 2, tsvc.PSService(r, 2, rdv), device="cpu")
            for r in range(2)]
    t0, _ = [ttables.AsyncMatrixTable(16, 4, name="pl", ctx=c)
             for c in ctxs]
    yield ctxs, t0, str(tmp_path / "rdv")
    for c in ctxs:
        c.close()


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


class TestLive:
    def test_pool_publishes_and_recommends(self, world):
        ctxs, t0, _ = world
        pool = ReplicaPool(t0, replicas=2, spares=1, refresh_s=0.1,
                           probe_s=0.1, staleness_s=5.0, start=True)
        try:
            t0.add_rows(np.arange(16), np.ones((16, 4), np.float32))
            t0.flush()
            time.sleep(0.25)
            pool.get_rows([1, 2, 3])
            agg = tagg.ClusterAggregator(ctxs[0].service)
            agg.poll_once()
            time.sleep(0.15)
            rec = agg.poll_once()
            snap = tsig.snapshot()   # the aggregator published it
            assert snap["spares_left"]["pl"]["value"] == 1.0
            assert snap["active_replicas"]["pl"]["value"] == 2.0
            assert tauto.snapshot_from_record(rec)["spares_left"] == \
                {"pl": {k: snap["spares_left"]["pl"][k]
                        for k in ("value", "ts", "detail")}}
            verdict = tauto.recommend(snap)
            assert verdict["action"] == "shrink" and verdict["actionable"]
        finally:
            pool.close()

    def test_stats_payload_slo_block_and_assert_slo(self, world):
        """Disarmed: no ``slo`` key anywhere. Armed: the payload carries
        the block, the aggregator judges each poll, and mvtop's
        ``--assert-slo`` exits 3 the moment an objective fires."""
        ctxs, _, rdv = world
        assert "slo" not in ctxs[0].service.stats_payload()
        assert "slo" not in tagg.ClusterAggregator(
            ctxs[0].service).poll_once()
        tslo.arm({"objectives": [_stall_obj()]})
        argv = ["--rdv", rdv, "--once", "--assert-slo"]
        assert _run(tmvtop.main, argv)[0] == 0
        assert ctxs[1].service.stats_payload()["slo"]["firing"] == []
        rec = tagg.ClusterAggregator(ctxs[0].service).poll_once()
        assert rec["slo"]["evals"] == 1
        hist = [_stall_rec(t, 0.9) for t in range(5)]
        for i in range(len(hist)):
            tslo.SENTINEL.on_poll(hist[i], hist[:i + 1])
        assert tslo.stats_snapshot()["firing"] == ["stall"]
        assert _run(tmvtop.main, argv)[0] == 3
        tslo.reset()
        assert "slo" not in ctxs[0].service.stats_payload()

    def test_straggler_on_the_real_record(self, world):
        ctxs, _, _ = world
        rec = tagg.ClusterAggregator(ctxs[0].service).poll_once()
        assert len(rec["ranks"]) == 2
        rec["ranks"]["1"]["queue_depth"] = 128
        st = tslo.straggler(rec)
        assert st["rank"] == 1 and st["attribution"] == "wire"
        assert st == jslo.straggler(rec)


def test_mvtop_slo_panel_equals_the_root_tool():
    root = _root_tool("mvtop")
    rec = {"kind": "cluster", "ts": 100.0, "world": 2, "polled": 2,
           "ranks": {"0": {"status": "ok"}, "1": {"status": "ok"}},
           "slo": {"objectives": {"embed-avail": {
               "kind": "availability", "table": "embed", "firing": True,
               "episodes": 2, "burn_fast": 6.1, "burn_slow": 1.4,
               "value": 0.0}},
               "firing": ["embed-avail"], "episodes": 2, "evals": 40,
               "straggler": {"rank": 1, "attribution": "wire",
                             "top_phase": None, "score": 1.7,
                             "components": {}},
               "recent": [{"kind": "slo.fired", "objective": "embed-avail",
                           "episode": 2, "ts": 9.5}]}}
    out = tmvtop.render(json.loads(json.dumps(rec)))
    assert out == root.render(json.loads(json.dumps(rec)))
    assert "embed-avail" in out and "FIRING" in out and "wire" in out


def test_lint7_clean_and_reads_the_port_registries():
    assert tcheck.slo_surface_findings() == []
    assert tuple(tcheck.module_tuple(
        "multiverso_tpu_torch/telemetry/slo.py", "OBJECTIVE_KINDS")) == \
        tslo.OBJECTIVE_KINDS
    assert tuple(tcheck.module_tuple(
        "multiverso_tpu_torch/telemetry/signals.py", "SIGNAL_NAMES")) == \
        tsig.SIGNAL_NAMES
    dark = tcheck.slo_surface_findings(renderer_text="")
    assert len(dark) == len(tslo.OBJECTIVE_KINDS) + len(tsig.SIGNAL_NAMES)
