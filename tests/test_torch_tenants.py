"""Port parity, the tenant attribution plane (``telemetry/tenants.py`` and
its hooks), mirroring ``tests/test_tenants.py``.

* Pure: the same numpy-made note sequences go through both packages'
  ``TenantMeter`` and ``TenantLedger`` (serves, sheds, deferrals, sweeps
  at given clocks): the meters, the verdicts, the episodes and the stats
  blocks are equal (the sweeps' ``now`` is given, so nothing is
  excluded); the admission budgets decide alike on the same calls.
* Live, on the CPU: the two-tenant shard oracle on both wire planes (a
  stamped frame punts the C++ server to the Python meter), the default
  tenant's fast path, the send window's budget (over-budget adds
  deferred, never dropped) and its rule that tenants never merge, and
  the stats payload's ``tenants`` block.
* The renderers (the port's mvtop panel and dump_metrics lines against
  the root tools' text, the exporter's gauges), the flight recorder's
  events and the postmortem timeline, and lint 6.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from multiverso_tpu.serving import admission as jadm
from multiverso_tpu.telemetry import tenants as jten
from multiverso_tpu.utils import config as jconfig
from multiverso_tpu_torch.ps import service as tsvc
from multiverso_tpu_torch.ps import tables as ttables
from multiverso_tpu_torch.ps import wire as twire
from multiverso_tpu_torch.serving import admission as tadm
from multiverso_tpu_torch.telemetry import aggregator as tagg
from multiverso_tpu_torch.telemetry import flightrec as tfr
from multiverso_tpu_torch.telemetry import hotkeys as thot
from multiverso_tpu_torch.telemetry import tenants as tten
from multiverso_tpu_torch.telemetry import watchdog as twd
from multiverso_tpu_torch.telemetry.exporter import prometheus_text
from multiverso_tpu_torch.tools import check_obs_surface as tcheck
from multiverso_tpu_torch.tools import dump_metrics as tdump
from multiverso_tpu_torch.tools import mvtop as tmvtop
from multiverso_tpu_torch.tools import postmortem as tpm
from multiverso_tpu_torch.utils import config as tconfig

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean():
    tten.reset()
    jten.reset()
    yield
    tten.reset()
    jten.reset()
    twd.reset()   # the first PSService started the process's watchdog
    tconfig.reset_flags()   # the JAX flags reset in conftest.py


def _root_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_root_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------- #
# identity and wire meta
# ---------------------------------------------------------------------- #
def test_identity_precedence_equals_jax():
    seen = []
    for ten, cfg in ((tten, tconfig), (jten, jconfig)):
        cfg.set_flag("tenant_id", "acme")
        row = [ten.current()]
        with ten.tenant_scope("storm"):
            row.append(ten.current())
            with ten.tenant_scope(""):
                row.append(ten.current())
        row.append(ten.current())
        cfg.set_flag("tenant_id", "")
        row += [ten.current(), ten.label(None), ten.label("x")]
        with ten.tenant_scope("leak"):
            ten.reset()
            row.append(ten.current())
        seen.append(row)
    assert seen[0] == seen[1] == [
        "acme", "storm", None, "acme", None, "default", "x", None]
    m = {"table": "t"}
    assert twire.with_tenant(m, None) is m
    assert json.loads(twire.pack_meta(twire.with_tenant(m, "a")).decode())[
        twire.TENANT_META_KEY] == "a"


def test_flag_reader_follows_set_flag():
    """tenants.current() reads tenant_id through config.reader, which
    takes no lock: it must still see every set_flag at once."""
    read = tconfig.reader("tenant_id")
    try:
        for v in ("a", "b", ""):
            tconfig.set_flag("tenant_id", v)
            assert read() == v and tten.current() == (v or None)
    finally:
        tconfig.set_flag("tenant_id", "")
    with pytest.raises(tconfig.FlagError):
        tconfig.reader("no_such_flag")


def test_flag_defaults_equal_jax():
    for k in ("tenant_id", "tenant_storm_share", "tenant_infer_qps",
              "tenant_add_qps", "tenant_track_max", "tenant_stale_frac",
              "stats_poll_interval_s", "slo_spec"):
        assert tconfig.get_flag(k) == jconfig.get_flag(k), k


# ---------------------------------------------------------------------- #
# the pure meter and ledger against the JAX package
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", range(3))
def test_meter_equals_jax(seed):
    rng = np.random.default_rng(seed)
    names = [None, "a", "b", "c", "d", "e"]
    ops = [(names[int(rng.integers(len(names)))], int(rng.integers(0, 3)),
            int(rng.integers(0, 64)), int(rng.integers(0, 64)))
           for _ in range(200)]
    for cap in (32, 2):
        t, j = tten.TenantMeter(track_max=cap, sketch_capacity=4), \
            jten.TenantMeter(track_max=cap, sketch_capacity=4)
        for tn, n, ab, gb in ops:
            t.note(tn, ops=n, add_bytes=ab, get_bytes=gb)
            j.note(tn, ops=n, add_bytes=ab, get_bytes=gb)
        assert t.to_dict() == j.to_dict()
    assert tten.TenantMeter().to_dict() == {}
    assert "~other" in t.to_dict()


def _ledger_events(seed: int):
    """Intervals of serves, sheds and deferrals for three tenants; the
    storm tenant dominates some intervals and is silent in others."""
    rng = np.random.default_rng(seed)
    intervals = []
    for i in range(12):
        ev = []
        storm = int(rng.choice([0, 40])) if i else 40
        ev += [("serve", "storm", float(rng.uniform(0, 3)), None, None)
               ] * storm
        for _ in range(int(rng.integers(1, 6))):
            ev.append(("serve", "victim", float(rng.uniform(0, 3)),
                       float(rng.uniform(0, 2)), 2.0))
        if rng.random() < 0.5:
            ev.append(("shed", "victim", int(rng.integers(1, 3))))
        if rng.random() < 0.3:
            ev.append(("deferred", None, 1))
        intervals.append(ev)
    return intervals


def _drive_ledger(mod, intervals):
    led = mod.TenantLedger()
    verdicts = []
    for i, ev in enumerate(intervals):
        for e in ev:
            if e[0] == "serve":
                led.note_serve("t", e[1], e[2], age_s=e[3], bound_s=e[4])
            elif e[0] == "shed":
                led.note_shed("t", e[1], n=e[2])
            else:
                led.note_deferred("t", e[1], n=e[2])
        verdicts.append(led.sweep(now=100.0 + i))
    # one more (empty) interval: the pull's own sweep clears, fires none
    snap = led.stats_snapshot()
    return (verdicts, led.episodes(), led.verdicts(),
            {k: snap.get(k) for k in ("tables", "shares", "episodes",
                                      "active", "verdict")})


@pytest.mark.parametrize("seed", range(4))
def test_ledger_verdicts_equal_jax(seed):
    iv = _ledger_events(seed)
    got, want = _drive_ledger(tten, iv), _drive_ledger(jten, iv)
    assert got == want
    assert got[1] >= 1   # the storm interval at the start fires


def test_ledger_lifecycle_and_snapshot():
    led = tten.TenantLedger()

    def interval():
        for _ in range(20):
            led.note_serve("t", "storm", ms=1.0)
        for _ in range(2):
            led.note_serve("t", "victim", ms=1.0)
        led.note_shed("t", "victim", n=1)

    interval()
    fired = led.sweep(now=100.0)
    assert fired["tenant"] == "storm" and fired["victims"] == ["victim"]
    assert fired["why"] == ["shed"] and led.episodes() == 1
    interval()
    assert led.sweep() is None and led.episodes() == 1   # stays open
    assert led.sweep() is None                           # clears
    snap = led.stats_snapshot()
    assert snap["active"] is False and snap["verdict"]["tenant"] == "storm"
    interval()
    assert led.sweep() is not None and led.episodes() == 2
    stale = tten.TenantLedger()
    for _ in range(20):
        stale.note_serve("t", "storm")
    stale.note_serve("t", "victim", age_s=0.95, bound_s=1.0)
    assert stale.sweep()["why"] == ["stale"]


def test_admission_budgets_decide_alike():
    out = []
    for adm, cfg in ((tadm, tconfig), (jadm, jconfig)):
        ctl = adm.AdmissionController()
        ctl.set_limit("t", "infer", 10.0, burst=10.0)
        ctl.set_tenant_limit("t", "storm", "infer", 1.0, burst=1.0)
        storm = [ctl.admit("t", tenant="storm") for _ in range(50)]
        victim = [ctl.admit("t", tenant="victim") for _ in range(9)]
        cfg.set_flag("tenant_infer_qps", 2.0)
        lazy = adm.AdmissionController()
        lazy_n = [lazy.admit("t", tenant="n") for _ in range(10)]
        default = [lazy.admit("t") for _ in range(10)]
        lazy.set_tenant_limit("t", "vip", "infer", 0.0)   # exemption
        vip = [lazy.admit("t", tenant="vip") for _ in range(20)]
        cfg.set_flag("tenant_infer_qps", 0.0)
        for bad in (("t", "", "infer", 1.0), ("t", "a", "nope", 1.0)):
            with pytest.raises(ValueError):
                ctl.set_tenant_limit(*bad)
        out.append((storm, victim, lazy_n, default, vip,
                    ctl.tenant_stats(), lazy.tenant_stats()))
    assert out[0] == out[1]
    storm, victim = out[0][:2]
    assert sum(storm) == 1 and all(victim)   # sheds burn no aggregate
    assert out[0][5]["t/storm/infer"] == {"admitted": 1, "shed": 49,
                                          "qps_limit": 1.0}
    a, b = tadm.AdmissionController(), tadm.AdmissionController()
    for ctl in (a, b):
        ctl.set_tenant_limit("t2", "s", "infer", 100.0)
        ctl.admit("t2", tenant="s")
    assert tadm.tenant_stats_all()["t2/s/infer"]["admitted"] == 2


# ---------------------------------------------------------------------- #
# live worlds on the CPU
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


def _pair(ctxs, name, rows=16, cols=8, **kw):
    kw1 = {k: v for k, v in kw.items() if k != "send_window_ms"}
    return (ttables.AsyncMatrixTable(rows, cols, name=name, ctx=ctxs[0],
                                     **kw),
            ttables.AsyncMatrixTable(rows, cols, name=name, ctx=ctxs[1],
                                     **kw1))


def test_two_tenant_oracle_both_planes(ranks):
    """Named tenants are exact on both wire planes: stamped frames punt
    off the C++ server, so the shard's Python meter counts them either
    way. Every op targets rank 1's rows."""
    t0, t1 = _pair(ranks, "tor")
    ones = np.ones((1, 8), np.float32)
    with tten.tenant_scope("a"):
        for r in (8, 9, 10):
            t0.add_rows([r], ones)
        t0.get_rows(np.array([12]))
    with tten.tenant_scope("b"):
        for r in (11, 12):
            t0.add_rows([r], ones)
        for _ in range(4):
            t0.get_rows(np.array([13]))
    t0.flush()
    st = t0.server_stats(1)["shards"]["tor"]["tenants"]
    a, b = st["a"], st["b"]
    assert a["ops"] == 4 and b["ops"] == 6
    assert a["add_bytes"] * 2 == b["add_bytes"] * 3 == 3 * 2 * 32
    assert b["get_bytes"] == 4 * a["get_bytes"] == 4 * 32
    assert st["~sketch"]["total"] == 10
    np.testing.assert_array_equal(t1.get_rows(np.arange(8, 13))[:, 0],
                                  np.ones(5, np.float32))


def test_default_tenant_keeps_the_fast_path(ranks):
    """Unstamped frames: the C++ server serves the native plane's (the
    meter never sees them, by design); the Python plane counts them under
    ``default`` at the same chokepoint."""
    t0, _ = _pair(ranks, "tdf")
    t0.add_rows([9], np.ones((1, 8), np.float32))
    t0.get_rows(np.array([9]))
    t0.flush()
    st = t0.server_stats(1)["shards"]["tdf"].get("tenants", {})
    if tconfig.get_flag("ps_native"):
        assert t0._native_ok and "default" not in st
    else:
        assert st["default"]["ops"] == 2
        assert st["default"]["add_bytes"] == st["default"][
            "get_bytes"] == 32
        assert "~sketch" not in st   # default traffic is not ranked


def test_send_window_defers_over_budget_never_drops(ranks):
    tconfig.set_flag("tenant_add_qps", 5.0)
    t0, _ = _pair(ranks, "twin", cols=4, send_window_ms=2.0)
    ones = np.ones((1, 4), np.float32)
    with tten.tenant_scope("w"):
        for _ in range(40):
            t0.add_rows_async([12], ones)
    t0.flush()
    deferred = tten.LEDGER.stats_snapshot()["tables"]["twin"]["w"][
        "deferred"]
    assert deferred >= 30   # a ~5-token burst against 40 instant adds
    assert t0.get_rows(np.arange(16))[12, 0] == 40.0


def test_window_never_merges_across_tenants(ranks):
    # a window only the flush closes: the merge cannot depend on timing
    t0, _ = _pair(ranks, "tmix", cols=4, send_window_ms=60_000.0)
    ones = np.ones((1, 4), np.float32)
    with tten.tenant_scope("x"):
        t0.add_rows_async([12], ones)
        t0.add_rows_async([13], ones)   # same tenant, disjoint: merges
    with tten.tenant_scope("y"):
        t0.add_rows_async([14], 2 * ones)
    t0.flush()
    st = t0.server_stats(1)["shards"]["tmix"]["tenants"]
    assert st["x"]["ops"] == 1 and st["y"]["ops"] == 1
    assert st["x"]["add_bytes"] == 2 * st["y"]["add_bytes"]
    np.testing.assert_array_equal(
        t0.get_rows(np.array([12, 13, 14]))[:, 0], [1.0, 1.0, 2.0])


def test_stats_payload_tenants_block(ranks):
    assert "tenants" not in ranks[0].service.stats_payload()
    tten.LEDGER.note_serve("t", "a", ms=2.0)
    ctl = tadm.AdmissionController()
    ctl.set_tenant_limit("t", "a", "infer", 9.0)
    ctl.admit("t", tenant="a")
    blk = ranks[0].service.stats_payload()["tenants"]
    assert blk["tables"]["t"]["a"]["served"] == 1
    assert blk["shares"] == {"a": 1.0}
    assert blk["admission"]["t/a/infer"]["admitted"] == 1
    rec = tagg.ClusterAggregator(ranks[0].service).poll_once()
    # two ranks, one process: the ledger counts once
    assert rec["tenants"]["tables"]["t"]["a"]["served"] == 1


# ---------------------------------------------------------------------- #
# renderers, flight recorder, postmortem, lint 6
# ---------------------------------------------------------------------- #
def _hist(count=3, sum_ms=9.0):
    return {"count": count, "timed": count, "sum_ms": sum_ms,
            "min_ms": 1.0, "max_ms": 5.0, "buckets": []}


def _ten_block(ts=100.0, tenant="storm"):
    return {
        "tables": {"t": {
            "storm": {"served": 80, "shed": 40, "deferred": 0,
                      "max_age_s": 0.5, "infer": _hist()},
            "victim": {"served": 4, "shed": 1, "deferred": 2,
                       "max_age_s": 0.1, "infer": _hist(1, 2.0)}}},
        "shares": {"storm": 0.9, "victim": 0.1},
        "episodes": 1, "active": True,
        "verdict": {"kind": "noisy-neighbor", "tenant": tenant,
                    "share": 0.9, "victims": ["victim"], "why": ["shed"],
                    "ts": ts},
        "admission": {"t/storm/infer": {"admitted": 80, "shed": 40,
                                        "qps_limit": 50.0}}}


def _rank_stats(rank, pid=11, ten=None):
    sk = thot.SpaceSaving(4)
    sk.offer_key("acme", 2)
    shard = {"kind": "row", "adds": 4, "gets": 2, "applies": 4,
             "queue_depth": 0, "get_bytes": 6, "add_bytes": 10, "rows": 8,
             "tenants": {"acme": {"ops": 2, "add_bytes": 10,
                                  "get_bytes": 6},
                         "~sketch": sk.to_dict()}}
    st = {"rank": rank, "addr": f"h:{rank}", "pid": pid, "monitors": {},
          "notes": {}, "shards": {"t": shard}}
    if ten is not None:
        st["tenants"] = ten
    return st


def _rec():
    ten = _ten_block()
    return tagg.merge_cluster(
        {0: _rank_stats(0, ten=ten), 1: _rank_stats(1, ten=ten)},
        {0: {"status": "ok", "addr": "h:0"},
         1: {"status": "ok", "addr": "h:1"}}, world=2)


def test_renderers_equal_the_root_tools():
    rec = _rec()
    tb = rec["tenants"]
    assert tb["tables"]["t"]["storm"]["served"] == 80   # one process
    assert tb["wire"]["acme"] == {"ops": 4, "add_bytes": 20,
                                  "get_bytes": 12}
    mvtop, dump = _root_tool("mvtop"), _root_tool("dump_metrics")
    out = tmvtop.render(json.loads(json.dumps(rec)))
    assert out == mvtop.render(json.loads(json.dumps(rec)))
    assert "tenants: episodes 1  NOISY-NEIGHBOR ACTIVE" in out
    lines = tdump._tenants_lines(tb)
    assert lines == dump._tenants_lines(tb)
    assert "budget[t/storm/infer]: admitted=80 shed=40" in "\n".join(lines)
    per_rank = {"rank": 0, "monitors": {}, "shards": {},
                "tenants": _ten_block()}
    assert tdump.format_record(per_rank) == dump.format_record(per_rank)
    txt = prometheus_text({"rank": 0, "monitors": {}, "shards": {},
                           "tenants": _ten_block()})
    assert ('mv_tenant_served_total{table="t",tenant="storm",'
            'rank="0"} 80') in txt
    assert 'mv_tenant_verdict_active{rank="0"} 1' in txt
    assert "mv_tenant_" not in prometheus_text(
        {"rank": 0, "monitors": {}, "shards": {}})


def test_flightrec_events_and_postmortem_timeline(tmp_path):
    tconfig.set_flag("flightrec_dir", str(tmp_path))
    tfr.reset()
    tfr.configure(0)
    led = tten.TenantLedger()
    for _ in range(20):
        led.note_serve("t", "storm")
    led.note_shed("t", "victim", n=2)
    led.note_serve("t", "victim")
    assert led.sweep() is not None
    kinds = [s[2] for s in tfr.RECORDER.snapshot()]
    assert tfr.EV_TENANT_SHED in kinds and tfr.EV_TENANT_VERDICT in kinds
    path = tfr.dump_global("tenant verdict test")
    dumps = [tpm.load_dump(path)]
    assert {e["ev"] for e in tpm.tenant_timeline(dumps)} == {
        "tenant.shed", "tenant.verdict"}
    assert "VERDICT noisy-neighbor storm" in tpm.render_report(dumps)
    tfr.reset()


def test_lint6_clean_and_catches_a_dark_key():
    assert tcheck.tenant_surface_findings() == []
    fs = tcheck.tenant_surface_findings(
        keys_by_src={"fake.py:f()": {"darkkey123"}},
        renderer_text='lines.append("nothing relevant")')
    assert len(fs) == 1 and "darkkey123" in fs[0]
    assert tcheck.tenant_surface_findings(
        keys_by_src={"fake.py:f()": {"brightkey"}},
        renderer_text="x.get('brightkey')") == []
