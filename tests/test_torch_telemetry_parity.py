"""The port's per-process telemetry plane against ``multiverso_tpu.telemetry``
on the same inputs (exact unless a test says otherwise).

Each test drives one scripted input through both packages — the same
seeded observe sequence, the same step/phase/async event stream, the
same in-flight table and memory history, the same stats payload, the
same flight-recorder tape — with ``time.time``/``time.monotonic``
replaced by one injected clock, so the two packages' outputs (histogram
dicts, step records, verdicts, Prometheus text, dump records) must be
equal field for field. Only what names the process itself (the pid in a
dump header) or reads the host (memory census records) is left out of
the comparison, and each test says which.
"""

import json
import math
import time

import numpy as np
import pytest

from multiverso_tpu.telemetry import exporter as jexp
from multiverso_tpu.telemetry import flightrec as jfr
from multiverso_tpu.telemetry import histogram as jhist
from multiverso_tpu.telemetry import memstats as jmem
from multiverso_tpu.telemetry import profiler as jprof
from multiverso_tpu.telemetry import watchdog as jwd
from multiverso_tpu.utils import config as jconfig
from multiverso_tpu.utils import dashboard as jdash
from multiverso_tpu_torch.telemetry import devstats as tdev
from multiverso_tpu_torch.telemetry import exporter as texp
from multiverso_tpu_torch.telemetry import flightrec as tfr
from multiverso_tpu_torch.telemetry import histogram as thist
from multiverso_tpu_torch.telemetry import memstats as tmem
from multiverso_tpu_torch.telemetry import profiler as tprof
from multiverso_tpu_torch.telemetry import trace as ttrace
from multiverso_tpu_torch.telemetry import watchdog as twd
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils import dashboard as tdash
from multiverso_tpu_torch.utils import log as tlog
from multiverso_tpu_torch.utils import timer as ttimer

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
    tdash.Dashboard.reset()


@pytest.fixture(autouse=True)
def _fresh():
    _reset_port()
    jprof.reset()
    jmem.reset()
    jwd.reset()
    jfr.reset()
    yield
    _reset_port()


class Clock:
    """One injected clock for both packages: ``time.time`` and
    ``time.perf_counter`` read ``t``, ``time.monotonic`` reads ``t - 1e6``
    (distinct values, one source)."""

    def __init__(self, t: float = 1_000_000.0):
        self.t = t

    def time(self) -> float:
        return self.t

    def monotonic(self) -> float:
        return self.t - 1e6


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(time, "time", c.time)
    monkeypatch.setattr(time, "monotonic", c.monotonic)
    monkeypatch.setattr(time, "perf_counter", c.time)
    return c


# ---------------------------------------------------------------------- #
# histogram + Dashboard
# ---------------------------------------------------------------------- #
def _samples(seed: int, n: int = 2000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    s = rng.lognormal(mean=-1.0, sigma=2.5, size=n)
    s[:5] = [0.0, 1e-9, 1e9, 2.0 ** -14, 2.0 ** 22]   # edges and clamps
    return s


@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_merge_nonzero_as_dict(seed):
    s = _samples(seed).tolist()
    out = []
    for mod in (jhist, thist):
        a, b = mod.Histogram(), mod.Histogram()
        for x in s[: len(s) // 2]:
            a.observe(x)
        for x in s[len(s) // 2:]:
            b.observe(x)
        a.merge(b)
        back = mod.Histogram.from_nonzero(a.nonzero(), count=a.count,
                                          total=a.sum)
        out.append((a.as_dict(), a.nonzero(), a.percentiles((1, 50, 99.9)),
                    back.as_dict(), mod.bucket_index(3.7)))
    assert out[0] == out[1]
    assert out[1][0]["count"] == len(s)


def test_dashboard_brief_and_hist_dicts():
    s = _samples(2, 500).tolist()
    snaps = []
    for mod in (jdash, tdash):
        mon = mod.Dashboard.get("table[t].add_rows")
        for x in s:
            mon.observe_ms(x)
        mon.incr(7)
        mod.Dashboard.get("ps[t].native_served").incr(3)
        mod.Dashboard.note("ps[t].native_served", "adds = 3, applies = 1")
        snap = mod.Dashboard.snapshot()
        snaps.append(({n: (v.brief_dict(), v.hist_dict(), v.info_string())
                       for n, v in snap.items()},
                      mod.Dashboard.notes(),
                      mon.average_ms, mon.p50_ms, mon.p99_ms, mon.max_ms))
        mod.Dashboard.reset()
    assert snaps[0] == snaps[1]


def test_monitor_begin_end_and_timer(clock):
    got = []
    for mod in (jdash, tdash):
        mon = mod.Dashboard.get("pair")
        clock.t += 1.0
        mon.begin()
        clock.t += 0.25
        mon.end()
        mon.end()   # unpaired end: ignored
        got.append(mon.snapshot().hist_dict())
        mod.Dashboard.reset()
    assert got[0] == got[1] and got[1]["count"] == 1
    assert got[1]["sum_ms"] == 250.0
    # the port's Timer counts perf_counter milliseconds
    t = ttimer.Timer()
    clock.t += 0.125
    assert t.elapse() == 125.0


# ---------------------------------------------------------------------- #
# step profiler: one scripted event stream, injected clock
# ---------------------------------------------------------------------- #
def _drive_steps(P, clock) -> None:
    """Two steps: phases (nested), a closed and an open async span, a
    retroactive producer span and unmarked gaps (stall)."""
    for k in range(2):
        clock.t = 2_000_000.0 + k
        with P.step("we.block"):
            clock.t += 0.002                     # unmarked: stall
            with P.phase("prepare"):
                clock.t += 0.010
            sp = P.async_begin("ps.get")
            with P.phase("compute"):
                clock.t += 0.004
                with P.phase("ps_wait"):         # debits compute
                    clock.t += 0.003
                clock.t += 0.006
            clock.t += 0.001
            sp.end()
            P.note_async("io.produce", clock.t - 0.02, clock.t,
                         attach="any")
            with P.phase("push"):
                clock.t += 0.0015
            clock.t += 0.005                     # stall
            P.async_begin("ps.add")              # open at step end
            clock.t += 0.003
            P.note_transfer(4096)


def test_step_records_match(clock):
    recs, sums = [], []
    for cfg, P in ((jconfig, jprof), (tconfig, tprof)):
        cfg.set_flag("step_profile", True)
        P.configure(3)
        _drive_steps(P, clock)
        recs.append(P.records())
        sums.append(P.summary())
        cfg.set_flag("step_profile", False)
        P.configure()
    assert recs[0] == recs[1]
    assert sums[0] == sums[1]
    r = recs[1][1]
    assert r["rank"] == 3 and r["async"]["ps.add"]["open"] == 1
    assert 0 < r["stall_fraction"] < 1
    assert r["jax"]["transfer_bytes"] == 4096
    assert set(r["jax"]) == set(recs[0][1]["jax"])


def test_aggregate_step_records_and_top_phase(clock):
    tconfig.set_flag("step_profile", True)
    tprof.configure(0)
    _drive_steps(tprof, clock)
    records = tprof.records()
    # a step with builds (the "jax" block's compiles) and per-function
    # retraces, as a JAX rank's record carries them
    extra = json.loads(json.dumps(records[0]))
    extra.update(step=9, jax={"compiles": 2, "compile_s": 1.5,
                              "retraces_by_fn": {"we.local_train": 1}})
    records = records + [extra, {"kind": "other"}]
    assert (jprof.aggregate_step_records(records)
            == tprof.aggregate_step_records(records))
    for r in records[:3]:
        assert jprof.step_top_phase(r) == tprof.step_top_phase(r)
    agg = tprof.aggregate_step_records(records)
    assert agg["steps"] == 3 and agg["recompile_steps"][0]["step"] == 9


def test_builds_in_steady_steps_count_as_recompiles():
    tconfig.set_flag("step_profile", True)
    tprof.configure(0)
    with tprof.step("s"):       # the thread's first step: warmup
        tprof.note_compile(2.0)
    with tprof.step("s"):
        tprof.note_compile(0.5)
        tprof.note_load()
    s = tprof.summary()
    assert s["steady_recompiles"] == 1
    assert s["jax"]["compiles"] == 2 and s["jax"]["traces"] == 1
    assert tprof.records()[1]["jax"]["compiles"] == 1


# ---------------------------------------------------------------------- #
# watchdog verdicts + memstats leak verdicts on one history
# ---------------------------------------------------------------------- #
def test_watchdog_verdicts_match(clock, tmp_path):
    verdicts = []
    for name, cfg, fr, wd in (("j", jconfig, jfr, jwd),
                              ("t", tconfig, tfr, twd)):
        cfg.set_flag("flightrec_dir", str(tmp_path / name))
        fr.configure(0)
        clock.t = 3_000_000.0
        fr.begin_op(1, 7, 0x11, 64)
        fr.begin_op(2, 8, 0x12, 8)
        seq = []
        for dt in (0.5, 1.5, 31.0, 31.5):
            clock.t = 3_000_000.0 + dt
            seq.append(wd.check_once())
        fr.end_op(1, 7)
        fr.end_op(2, 8)
        clock.t += 1
        seq.append(wd.check_once())
        verdicts.append((seq, wd.last_verdict()))
        cfg.set_flag("flightrec_dir", "")
    assert verdicts[0] == verdicts[1]
    assert [v["status"] for v in verdicts[1][0]] == [
        "ok", "slow", "stuck", "stuck", "ok"]
    # the stuck trip dumped once (rate-limited) with stacks
    lines = (tmp_path / "t" / "flightrec-rank0.jsonl").read_text()
    assert '"kind": "stack"' in lines and "watchdog stuck" in lines


class _Fake:
    """A ledger component whose gauges follow a scripted history."""

    def __init__(self, series):
        self.series, self.i = series, 0

    def memory_stats(self):
        return dict(self.series[self.i])


def test_memstats_leak_verdicts_match(clock, monkeypatch):
    series = [
        {"retained_bytes": 100, "oldest_pin_age_s": 1.0,
         "retired_bytes": 0, "pins": 1},
        {"retained_bytes": 200, "oldest_pin_age_s": 40.0,
         "retired_bytes": 4096, "retired_epochs": 2, "pins": 1},
        {"retained_bytes": 300, "oldest_pin_age_s": 41.0,
         "retired_bytes": 4096, "pins": 1},
        {"retained_bytes": 300, "oldest_pin_age_s": 1.0,
         "retired_bytes": 0, "pins": 0},
        {"retained_bytes": 400, "oldest_pin_age_s": 50.0,
         "retired_bytes": 10, "pins": 2,
         "owners": {"1": {"retained_bytes": 400, "armed_frames": 0}}},
    ]
    rss = [100.0, 100.0, 300.0, 310.0, 1000.0]
    out = []
    for cfg, mem in ((jconfig, jmem), (tconfig, tmem)):
        cfg.set_flag("memstats_rss_limit_mb", 900.0)
        comp = _Fake(series)
        mem.LEDGER.register("fake_leaky", comp)
        monkeypatch.setattr(mem, "device_census", lambda top=12: None)
        for i in range(len(series)):
            comp.i = i
            clock.t = 4_000_000.0 + i
            monkeypatch.setattr(mem, "read_rss",
                                lambda i=i: (rss[i], max(rss[: i + 1])))
            mem.LEDGER.sample_once()
        got = mem.LEDGER.verdicts()
        out.append([v for v in got if v["component"] in
                    ("fake_leaky", "fake_leaky@1", "process")])
        mem.LEDGER.unregister("fake_leaky")
        cfg.set_flag("memstats_rss_limit_mb", 0.0)
    assert out[0] == out[1]
    assert [v["kind"] for v in out[1]] == [
        "epoch-hoard", "retention-leak", "rss-creep", "epoch-hoard",
        "rss-limit"]


# ---------------------------------------------------------------------- #
# Prometheus text on one payload
# ---------------------------------------------------------------------- #
def test_prometheus_text_matches():
    mon = tdash.Dashboard.get("table[emb].add_rows")
    for x in _samples(3, 300).tolist():
        mon.observe_ms(x)
    tdash.Dashboard.get("ps[emb].native_served").incr(4)
    payload = texp.default_stats_fn()
    payload.update(
        rank=1, world=2, addr="127.0.0.1:1",
        shards={"emb": {"adds": 5, "gets": 3, "rows": 100,
                        "coalesced": 0.5, "hot": True}},
        memory={"rss_mb": 512.5, "hwm_mb": 600.0, "device_bytes": 1 << 30,
                "samples": 3, "totals": {"table_bytes": 4096, "pins": 1},
                "components": {"shard[emb:0-50]": {"table_bytes": 4096,
                                                   "dtype": "float32"}}},
        devices={"transfers": {"h2d": {"ops": 2, "bytes": 100}},
                 "collectives": {}, "compiles_by_mesh": {},
                 "per_device": {"cuda:0": {"bytes": 2048, "arrays": 3}}},
        tenants={"tables": {"emb": {"a": {"served": 3, "shed": 1,
                                          "infer": {"timed": 1,
                                                    "p50_ms": 1.0,
                                                    "p99_ms": 2.0}}}},
                 "shares": {"a": 1.0}, "episodes": 0},
        slo={"objectives": {"p99": {"kind": "latency", "table": "emb",
                                    "firing": True, "burn_fast": 2.0,
                                    "burn_slow": 1.0, "value": 3.5}},
             "episodes": 1})
    text = texp.prometheus_text(payload)
    assert text == jexp.prometheus_text(payload)
    assert 'mv_dev_live_bytes{device="cuda:0",rank="1"} 2048' in text
    assert 'mv_monitor_count{name="table[emb].add_rows",table="emb",' \
        'rank="1"} 300' in text


def test_exporter_files(tmp_path):
    """The port's exporter writes the JAX package's two files: one JSON
    record per export and the .prom text of the last one."""
    tdash.Dashboard.get("m").observe_ms(1.0)
    exp = texp.MetricsExporter(2, str(tmp_path), 0.0, texp.default_stats_fn)
    rec = exp.export_once()
    exp.export_once()
    lines = (tmp_path / "metrics-rank2.jsonl").read_text().splitlines()
    assert len(lines) == 2 and json.loads(lines[0])["rank"] == 2
    assert (tmp_path / "metrics-rank2.prom").read_text() == \
        jexp.prometheus_text(rec)


# ---------------------------------------------------------------------- #
# flight-recorder dump records
# ---------------------------------------------------------------------- #
def _tape(fr) -> None:
    fr.record(fr.EV_STATE, note="boot")
    fr.begin_op(1, 10, 0x11, 128)
    fr.begin_op(1, 11, 0x1B, 8, record=False)   # a probe: tracked only
    fr.end_op(1, 10)
    fr.end_op(1, 10)                            # idempotent: no 2nd edge
    fr.record(fr.EV_APPLY, nbytes=64)
    fr.begin_op(2, 12, 0x1A, 256)
    fr.begin_op(3, 13, 0x12, 32)
    assert fr.RECORDER.fail_peer(2) == 1
    fr.record(fr.EV_BARRIER_ENTER, msg_id=1, note="zoo.barrier")
    fr.beat("serve")


def _load(path, kinds=("header", "event", "inflight")):
    recs = [json.loads(l) for l in open(path)]
    return [r for r in recs if r["kind"] in kinds], recs


def test_flightrec_dump_records_match(clock, tmp_path):
    assert jfr.EV_NAMES == tfr.EV_NAMES
    assert jfr.MSG_EV_COVERAGE == tfr.MSG_EV_COVERAGE
    dumps = []
    for name, fr in (("j", jfr), ("t", tfr)):
        fr.configure(5)
        clock.t = 5_000_000.0
        _tape(fr)
        clock.t += 2.5
        path = fr.RECORDER.dump("test fault", directory=str(tmp_path / name))
        dumps.append(_load(path))
        assert fr.dump_stats()["count"] == 1
        # a routine dump never replaces a fault dump
        assert fr.RECORDER.dump("Zoo.stop", directory=str(tmp_path / name),
                                routine=True) is None
    (jsel, jall), (tsel, tall) = dumps
    assert jsel == tsel   # pid masked by construction: one process
    assert tsel[0]["rank"] == 5 and tsel[0]["events"] == 8
    assert [r["peer"] for r in tsel if r["kind"] == "inflight"] == [1, 3]
    # both carry the memory ledger's record (its census reads the host)
    assert any(r["kind"] == "memory" for r in tall)
    assert any(r["kind"] == "memory" for r in jall)


def test_flightrec_fatal_and_signal_paths(tmp_path):
    tconfig.set_flag("flightrec_dir", str(tmp_path))
    tfr.configure(0)
    with pytest.raises(tlog.FatalError):
        tlog.fatal("boom %d", 3)
    recs = [json.loads(l) for l in open(tmp_path / "flightrec-rank0.jsonl")]
    assert recs[0]["reason"].startswith("fatal: boom 3")
    assert any(r.get("ev") == "fatal" for r in recs)


def test_trace_spans_and_ids(tmp_path):
    tconfig.set_flag("trace_ids", True)
    ttrace.configure(7)
    tid = ttrace.new_id()
    assert tid >> 32 == 7
    with ttrace.span("client.add_rows", trace=tid, table="t"):
        pass
    ttrace.add_span("ps.serve", 1.0, 1.5, trace=tid)
    assert ttrace.dump_to(str(tmp_path)) == 2
    assert ttrace.dump_to(str(tmp_path)) == 0   # drained
    ev = [json.loads(l) for l in open(tmp_path / "trace-rank7.jsonl")]
    assert [e["args"]["trace"] for e in ev] == [tid, tid]
    assert ev[1] == {"name": "ps.serve", "cat": "ps", "ph": "X",
                     "ts": 1000000, "dur": 500000, "pid": 7,
                     "tid": ev[1]["tid"], "args": {"trace": tid}}
    assert not math.isnan(ev[0]["dur"])
