"""Memory observability plane: the per-component byte ledger (port of
``multiverso_tpu/telemetry/memstats.py``, the same records and verdicts).

* **Ledger** (always on, pull-only): each owning component registers a
  gauge callback it already computes — ``RowShard.memory_stats``,
  ``_SendWindow.memory_stats``, ``Table.memory_stats``,
  ``TrainCache.memory_stats``, ``ReadReplica.memory_stats``, the
  checkpoint staging. Registration is one dict store at construct time
  (a weak reference); gauges are computed only when a consumer pulls
  (stats pull, sampler tick, fault dump), so the hot path never touches
  this module.
* **Sampler** (flag ``memstats_interval_s``, default off): a daemon
  thread taking host RSS from ``/proc/self/status``, the per-device
  census (:func:`device_census`: ``torch.cuda.memory_allocated`` and
  ``torch.cuda.memory_stats`` per device, where the JAX package walks
  ``jax.live_arrays()``), and a ``tracemalloc`` top-N when
  ``memstats_tracemalloc`` is set.
* **Leak verdicts** (the watchdog's sweep and every sample):
  ``epoch-hoard`` (a read pin older than ``memstats_pin_age_s`` with
  retired buffers behind it), ``retention-leak`` (replay-retained bytes
  growing over ``RETENTION_K`` samples with a live owner), ``rss-creep``
  (RSS slope past ``memstats_rss_slope_mb_s``) and the RSS soft limit.
  Each emits one structured log line and one flight-recorder event per
  episode.
* **OOM forensics**: a ``MemoryError`` on the serve path or the RSS soft
  limit dumps the ledger, census and sample history through the flight
  recorder (:func:`oom_dump`); every flight-recorder dump carries them.

The ledger rides MSG_STATS as the ``"memory"`` block
(:func:`stats_snapshot`) and the exporter emits it as ``mv_mem_*``
gauges. On a machine without CUDA the census is None: the sample's
``device_bytes`` is null and CPU tensors count in ``rss_mb``.
"""

from __future__ import annotations

import collections
import itertools
import json
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

from multiverso_tpu_torch.telemetry import flightrec as _flight
from multiverso_tpu_torch.utils import config, log

config.define_float(
    "memstats_interval_s", 0.0,
    "seconds between process memory samples (host RSS from /proc, the "
    "CUDA allocator's per-device census, ledger totals) feeding "
    "the leak verdicts and bench peaks; 0 disables the sampler thread "
    "entirely — the byte ledger itself is always on and pull-only "
    "(docs/OBSERVABILITY.md 'Memory view')")
config.define_bool(
    "memstats_tracemalloc", False,
    "include a tracemalloc top-N (by allocated bytes, per source line) "
    "in every memory sample; starts tracemalloc on first use, which "
    "costs ~2x on every Python allocation — triage only, never leave "
    "on in production")
config.define_float(
    "memstats_pin_age_s", 30.0,
    "read-epoch pin age (s) past which a shard pin with retired COW "
    "buffers behind it raises the 'epoch-hoard' leak verdict (one "
    "structured log + flightrec event per episode)")
config.define_float(
    "memstats_rss_slope_mb_s", 50.0,
    "host-RSS growth rate (MB/s) over the sampler's rolling window "
    "past which the 'rss-creep' leak verdict fires; needs "
    "memstats_interval_s > 0 for the window to exist")
config.define_float(
    "memstats_rss_limit_mb", 0.0,
    "soft RSS limit (MB): a sample observing VmRSS above it dumps the "
    "ledger + device census through the flight recorder's fault path "
    "(OOM forensics, one dump per episode); 0 disables the trip")

# consecutive samples over which a component's replay-retained bytes
# must grow monotonically (with a live owner) to call 'retention-leak'
RETENTION_K = 3
# bounded sample history (at the 1 Hz triage cadence: ~4 min of tape)
HISTORY = 240
# device-census groups kept per sample/dump (by bytes, descending)
CENSUS_TOP = 12

# new flight-recorder event ids (flightrec.py owns the registry; these
# aliases keep call sites readable)
EV_MEM_HOARD = _flight.EV_MEM_HOARD
EV_MEM_LEAK = _flight.EV_MEM_LEAK
EV_MEM_RSS = _flight.EV_MEM_RSS
EV_MEM_DUMP = _flight.EV_MEM_DUMP

# gauge keys summed into the ledger totals even though they are counts,
# not byte figures (everything ending in "_bytes" sums automatically)
_COUNT_TOTALS = ("pins", "pinned_epochs", "retired_epochs",
                 "retained_frames", "pending_ops", "armed_frames")


def read_rss() -> Tuple[Optional[float], Optional[float]]:
    """(VmRSS MB, VmHWM MB) from ``/proc/self/status`` — the kernel's
    own resident-set reading and its process-lifetime high-water mark
    (the peak no sampling cadence can miss). (None, None) off-Linux."""
    try:
        with open("/proc/self/status") as f:
            txt = f.read()
    except OSError:
        return None, None
    out: List[Optional[float]] = [None, None]
    for i, tag in enumerate(("VmRSS:", "VmHWM:")):
        j = txt.find(tag)
        if j >= 0:
            try:
                out[i] = round(int(txt[j:].split()[1]) / 1024.0, 3)
            except (ValueError, IndexError):
                pass
    if out[1] is None:
        # stripped /proc (container kernels) may omit VmHWM: fall back
        # to getrusage's kernel-tracked peak (KB on Linux)
        try:
            import resource
            out[1] = round(resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 1024.0, 3)
        except Exception:   # noqa: BLE001
            pass
    return out[0], out[1]


def device_census(top: int = CENSUS_TOP) -> Optional[Dict[str, Any]]:
    """Device-memory census per CUDA device, in the JAX package's shape
    (``bytes``, ``arrays``, ``groups``, ``top``). The JAX package walks
    ``jax.live_arrays()`` and groups by (shape, dtype, device); PyTorch
    keeps no registry of live tensors, so here each group is one device:
    ``bytes`` is ``torch.cuda.memory_allocated(dev)`` (the bytes of live
    tensors, as the caching allocator rounds them), ``count`` is the
    allocator's live block count (``allocation.all.current`` of
    ``torch.cuda.memory_stats(dev)``), and ``shape``/``dtype`` read
    ``"*"``. Pull-only, like the JAX census. None when CUDA is absent or
    not initialised: CPU tensors have no device census, and their bytes
    show in the host RSS of the same sample."""
    try:
        import torch
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return None
        groups: List[Tuple[str, int, int]] = []
        for i in range(torch.cuda.device_count()):
            dev = torch.device("cuda", i)
            nb = int(torch.cuda.memory_allocated(dev))
            blocks = int(torch.cuda.memory_stats(dev).get(
                "allocation.all.current", 0))
            groups.append((str(dev), nb, blocks))
    except Exception:   # noqa: BLE001 — census is best-effort telemetry
        return None
    head = sorted(groups, key=lambda g: -g[1])[:top]
    return {
        "bytes": sum(g[1] for g in groups),
        "arrays": sum(g[2] for g in groups),
        "groups": len(groups),
        "top": [{"shape": "*", "dtype": "*", "device": d,
                 "bytes": nb, "count": n} for d, nb, n in head],
    }


def _retained_series(components: Dict[str, Dict]) -> Dict[str, int]:
    """The per-sample retention readings the leak verdict compares:
    one entry per component reporting ``retained_bytes``, plus one per
    OWNER (``name@owner``) when the component breaks retention down —
    the verdict judges owners separately, so a dead owner's re-armed
    tail cannot mask a live owner's hoard."""
    out: Dict[str, int] = {}
    for n, g in components.items():
        if isinstance(g.get("retained_bytes"), int):
            out[n] = g["retained_bytes"]
        owners = g.get("owners")
        if isinstance(owners, dict):
            for o, og in owners.items():
                if isinstance(og, dict) and isinstance(
                        og.get("retained_bytes"), int):
                    out[f"{n}@{o}"] = og["retained_bytes"]
    return out


def _tracemalloc_top(ledger: "MemLedger",
                     n: int = 10) -> Optional[List[Dict]]:
    import tracemalloc
    if not tracemalloc.is_tracing():
        tracemalloc.start()
        ledger._tracemalloc_started = True   # ours to stop later
        return None   # first sample after start has nothing to rank yet
    stats = tracemalloc.take_snapshot().statistics("lineno")[:n]
    return [{"where": str(s.traceback), "kb": round(s.size / 1024.0, 1),
             "count": s.count} for s in stats]


def _tracemalloc_release(ledger: "MemLedger") -> None:
    """Stop tracemalloc iff WE started it: the ~2x per-allocation tax
    must not outlive the flag (or a test's ledger reset) — but a
    tracing run some other owner started is not ours to kill."""
    if not ledger._tracemalloc_started:
        return
    try:
        import tracemalloc
        if tracemalloc.is_tracing():
            tracemalloc.stop()
    except Exception:   # noqa: BLE001
        pass
    ledger._tracemalloc_started = False


class MemLedger:
    """Process-global byte ledger + sampler + verdict engine (one per
    process, like the FlightRecorder; several in-process ranks share it
    — the same documented (host, pid) collapse as the monitors)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        # name -> (weakref to the owning component, gauge method name).
        # Weak: the ledger must never extend a component's lifetime —
        # a telemetry registry keeping dead shards alive would be this
        # plane's own retention leak.
        self._components: Dict[str, Tuple[weakref.ref, str]] = {}
        self._suffix = itertools.count(1)
        self._history: collections.deque = collections.deque(
            maxlen=HISTORY)
        self._verdicts: collections.deque = collections.deque(maxlen=64)
        self._active: set = set()   # (kind, component) episodes asserted
        self._peaks: Dict[str, float] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._tracemalloc_started = False   # we own the stop iff True

    # ------------------------------------------------------------------ #
    # registration (construct-time, one dict store)
    # ------------------------------------------------------------------ #
    def register(self, name: str, obj: Any,
                 attr: str = "memory_stats") -> str:
        """Register ``obj`` as the owner of the gauges its ``attr``()
        method computes; returns the (collision-suffixed) final name.
        Dead components drop silently at the next snapshot."""
        with self._lock:
            final = name
            while final in self._components:
                ref, _ = self._components[final]
                if ref() is None:   # dead entry: reuse its name
                    break
                final = f"{name}#{next(self._suffix)}"
            self._components[final] = (weakref.ref(obj), attr)
            return final

    def unregister(self, name: str) -> None:
        with self._lock:
            self._components.pop(name, None)

    # ------------------------------------------------------------------ #
    # pulls
    # ------------------------------------------------------------------ #
    def snapshot(self) -> Dict[str, Any]:
        """{"components": {name: gauges}, "totals": {...}} — computed
        by PULLING every live component's gauge callback. Dead weakrefs
        are pruned here; a gauge that raises becomes an error entry,
        never a failed snapshot."""
        with self._lock:
            items = list(self._components.items())
        components: Dict[str, Dict] = {}
        totals: Dict[str, float] = {}
        dead: List[str] = []
        for name, (ref, attr) in items:
            obj = ref()
            if obj is None:
                dead.append(name)
                continue
            try:
                g = getattr(obj, attr)()
            except Exception as e:   # noqa: BLE001 — one bad component
                components[name] = {
                    "error": f"{type(e).__name__}: {e}"[:120]}
                continue             # must not hide the rest
            if not isinstance(g, dict):
                continue
            components[name] = g
            for k, v in g.items():
                if (isinstance(v, (int, float))
                        and not isinstance(v, bool)
                        and (k.endswith("_bytes") or k in _COUNT_TOTALS)):
                    totals[k] = totals.get(k, 0) + v
        if dead:
            with self._lock:
                for name in dead:
                    ent = self._components.get(name)
                    if ent is not None and ent[0]() is None:
                        del self._components[name]
        totals = {k: int(v) for k, v in sorted(totals.items())}
        return {"components": components, "totals": totals}

    def sample_once(self) -> Dict[str, Any]:
        """One full sample: RSS + ledger totals + device census (+
        tracemalloc when flagged), appended to the bounded history;
        updates the peak gauges and runs the verdict sweep. The
        sampler thread, the watchdog-independent manual callers
        (tests, ``bench_extra``) and nothing else call this."""
        rss, hwm = read_rss()
        snap = self.snapshot()
        census = device_census()
        sample: Dict[str, Any] = {
            "ts": round(time.time(), 3),
            "rss_mb": rss, "hwm_mb": hwm,
            "device_bytes": None if census is None else census["bytes"],
            "totals": snap["totals"],
            # per-component (and, for windows, per-OWNER) replay
            # retention, kept per sample so the retention-leak verdict
            # can see monotonic growth at the granularity it judges
            "retained": _retained_series(snap["components"]),
        }
        if config.get_flag("memstats_tracemalloc"):
            try:
                tm = _tracemalloc_top(self)
                if tm is not None:
                    sample["tracemalloc"] = tm
            except Exception:   # noqa: BLE001 — triage aid, best-effort
                pass
        else:
            # flag cleared mid-run: release the ~2x allocation tax our
            # earlier flagged sample turned on
            _tracemalloc_release(self)
        with self._lock:
            self._history.append(sample)
            self._bump_peak("rss_mb", hwm if hwm is not None else rss)
            self._bump_peak("device_bytes", sample["device_bytes"])
            t = snap["totals"]
            self._bump_peak("retained_bytes", t.get("retained_bytes"))
            self._bump_peak("pinned_epochs", t.get("pinned_epochs"))
        self.check_verdicts(snap=snap, sample=sample)
        full = dict(sample)
        full["components"] = snap["components"]
        if census is not None:
            full["census"] = census
        return full

    def _bump_peak(self, key: str, v) -> None:
        if isinstance(v, (int, float)) and v > self._peaks.get(
                key, float("-inf")):
            self._peaks[key] = v

    def maybe_sample(self) -> Optional[Dict[str, Any]]:
        """The flag-gated entry: None without touching anything when
        ``memstats_interval_s`` is 0 — the null branch the flag-off
        tests pin (zero allocations, zero samples)."""
        if config.get_flag("memstats_interval_s") <= 0:
            return None
        return self.sample_once()

    # ------------------------------------------------------------------ #
    # leak verdicts
    # ------------------------------------------------------------------ #
    def check_verdicts(self, snap: Optional[Dict] = None,
                       sample: Optional[Dict] = None) -> List[Dict]:
        """One verdict sweep over the live gauges (+ the sample history
        for the windowed verdicts). Called by the watchdog's
        ``check_once`` and by every sample; each (kind, component)
        episode emits ONE structured log + flightrec event and stays
        silent until the condition clears and re-fires."""
        if snap is None:
            snap = self.snapshot()
        out: List[Dict] = []
        pin_age = config.get_flag("memstats_pin_age_s")
        for name, g in snap["components"].items():
            age = g.get("oldest_pin_age_s")
            rb = g.get("retired_bytes")
            key = ("epoch-hoard", name)
            if (isinstance(age, (int, float)) and isinstance(rb, int)
                    and age > pin_age and rb > 0):
                v = self._emit(key, EV_MEM_HOARD, {
                    "oldest_pin_age_s": round(age, 3),
                    "retired_bytes": rb,
                    "retired_epochs": g.get("retired_epochs"),
                    "pins": g.get("pins")}, nbytes=rb)
                if v:
                    out.append(v)
            else:
                self._active.discard(key)
        with self._lock:
            hist = list(self._history)
        if len(hist) >= RETENTION_K:
            tail = hist[-RETENTION_K:]
            for name, g in snap["components"].items():
                if "retained_bytes" not in g:
                    continue
                owners = g.get("owners")
                if isinstance(owners, dict) and owners:
                    # per-OWNER granularity: one dead owner's re-armed
                    # tail (failover WORKING — frames awaiting the
                    # restored incarnation) must not mask another LIVE
                    # owner hoarding acked frames nothing prunes
                    targets = [(f"{name}@{o}", og)
                               for o, og in owners.items()
                               if isinstance(og, dict)]
                else:
                    targets = [(name, g)]
                for tkey, tg in targets:
                    key = ("retention-leak", tkey)
                    series = [s.get("retained", {}).get(tkey)
                              for s in tail]
                    growing = (all(isinstance(v, int) for v in series)
                               and all(series[i] < series[i + 1]
                                       for i in range(len(series) - 1))
                               and series[0] > 0)
                    live_owner = not tg.get("armed_frames")
                    if growing and live_owner:
                        v = self._emit(key, EV_MEM_LEAK, {
                            "retained_bytes": series[-1],
                            "grew_over_samples": len(series),
                            "retained_frames": tg.get(
                                "retained_frames")},
                            nbytes=series[-1])
                        if v:
                            out.append(v)
                    else:
                        self._active.discard(key)
        out.extend(self._rss_verdicts(hist, sample))
        return out

    def _rss_verdicts(self, hist: List[Dict],
                      sample: Optional[Dict]) -> List[Dict]:
        out: List[Dict] = []
        slope_mb_s = config.get_flag("memstats_rss_slope_mb_s")
        window = [s for s in hist
                  if isinstance(s.get("rss_mb"), (int, float))]
        key = ("rss-creep", "process")
        if len(window) >= 2 and slope_mb_s > 0:
            a, b = window[0], window[-1]
            dt = b["ts"] - a["ts"]
            slope = (b["rss_mb"] - a["rss_mb"]) / dt if dt > 0 else 0.0
            if slope > slope_mb_s:
                v = self._emit(key, EV_MEM_RSS, {
                    "slope_mb_s": round(slope, 3),
                    "window_s": round(dt, 3),
                    "rss_mb": b["rss_mb"]})
                if v:
                    out.append(v)
            else:
                self._active.discard(key)
        limit = config.get_flag("memstats_rss_limit_mb")
        key = ("rss-limit", "process")
        # judge the limit ONLY against a fresh sample: the watchdog's
        # sample-less sweeps must leave the episode state untouched —
        # discarding it there would let a sustained over-limit RSS
        # re-fire the verdict (and a full forensics dump) on every
        # sampler tick instead of once per episode
        if sample is not None and limit > 0:
            rss = sample.get("rss_mb")
            if isinstance(rss, (int, float)) and rss > limit:
                v = self._emit(key, EV_MEM_RSS, {
                    "rss_mb": rss, "limit_mb": limit})
                if v:
                    out.append(v)
                    # OOM forensics: the soft-limit trip IS the moment
                    # to preserve the ledger — dump through the flight
                    # recorder's fault path (one dump per episode; the
                    # providers attach the ledger + census + history)
                    oom_dump(f"memstats: rss {rss:.1f} MB over soft "
                             f"limit {limit:.1f} MB")
            else:
                self._active.discard(key)
        return out

    def _emit(self, key: Tuple[str, str], ev: int, info: Dict,
              nbytes: int = 0) -> Optional[Dict]:
        with self._lock:
            if key in self._active:
                return None
            self._active.add(key)
            verdict = {"kind": key[0], "component": key[1],
                       "ts": round(time.time(), 3)}
            verdict.update(info)
            self._verdicts.append(verdict)
        _flight.record(ev, nbytes=int(nbytes),
                       note=f"{key[0]} {key[1]}"[:120])
        log.error("memstats: %s verdict %s", key[0], json.dumps(verdict))
        return verdict

    # ------------------------------------------------------------------ #
    # consumer shapes
    # ------------------------------------------------------------------ #
    def stats_snapshot(self) -> Dict[str, Any]:
        """The MSG_STATS ``"memory"`` block (and the exporter's): the
        live ledger + RSS, the last sample's device total, and the
        recent verdicts. Pure JSON-safe data, process-global like the
        monitors (the aggregator dedupes by (host, pid))."""
        snap = self.snapshot()
        rss, hwm = read_rss()
        with self._lock:
            last = self._history[-1] if self._history else None
            verdicts = list(self._verdicts)[-8:]
            samples = len(self._history)
        return {
            "rss_mb": rss, "hwm_mb": hwm,
            "device_bytes": (last or {}).get("device_bytes"),
            "totals": snap["totals"],
            "components": snap["components"],
            "samples": samples,
            "verdicts": verdicts,
        }

    def samples(self) -> List[Dict]:
        with self._lock:
            return list(self._history)

    def verdicts(self) -> List[Dict]:
        with self._lock:
            return list(self._verdicts)

    def bench_extra(self) -> Dict[str, Any]:
        """The bench record's ``extra.memory``: one final sample, then
        the run's peaks — VmHWM for RSS (kernel-tracked, so no sampling
        cadence can under-read it), sampled high-waters for the ledger
        hoards and the device census."""
        final = self.sample_once()
        with self._lock:
            peaks = dict(self._peaks)
            samples = len(self._history)
        return {
            "peak_rss_mb": peaks.get("rss_mb", final.get("hwm_mb")),
            "peak_retained_bytes": int(peaks.get("retained_bytes", 0)),
            "peak_pinned_epochs": int(peaks.get("pinned_epochs", 0)),
            "device_high_water_bytes": (
                None if "device_bytes" not in peaks
                else int(peaks["device_bytes"])),
            "rss_mb": final.get("rss_mb"),
            "samples": samples,
            "verdicts": len(self.verdicts()),
        }

    # ------------------------------------------------------------------ #
    # sampler lifecycle
    # ------------------------------------------------------------------ #
    def start(self) -> "MemLedger":
        with self._lock:
            if self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._loop, name="mv-memstats", daemon=True)
                self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(
                max(config.get_flag("memstats_interval_s"), 0.05)):
            try:
                self.sample_once()
            except Exception as e:   # noqa: BLE001 — the sampler must
                log.error("memstats sample failed: %s", e)  # outlive bugs

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def reset(self) -> None:
        """Test isolation: stop the sampler and forget history/
        verdicts/episodes/peaks. Component REGISTRATIONS are kept:
        they are weakrefs (a test's dead shards prune themselves at
        the next snapshot), and module-level gauges registered at
        import time (checkpoint.py's) register exactly once per
        process — clearing them here would leave that plane dark for
        every test after the first."""
        self.stop()
        _tracemalloc_release(self)
        with self._lock:
            self._history.clear()
            self._verdicts.clear()
            self._active.clear()
            self._peaks.clear()


LEDGER = MemLedger()


# module-level wrappers (the call-site idiom, like flightrec/watchdog)
def register(name: str, obj: Any, attr: str = "memory_stats") -> str:
    return LEDGER.register(name, obj, attr)


def stats_snapshot() -> Dict[str, Any]:
    return LEDGER.stats_snapshot()


def sample_once() -> Dict[str, Any]:
    return LEDGER.sample_once()


def maybe_sample() -> Optional[Dict[str, Any]]:
    return LEDGER.maybe_sample()


def check_verdicts() -> List[Dict]:
    return LEDGER.check_verdicts()


def bench_extra() -> Dict[str, Any]:
    return LEDGER.bench_extra()


def ensure_started() -> Optional[MemLedger]:
    """Start the process sampler if the flag enables it (idempotent;
    the first PSService calls this, same lifecycle as the watchdog)."""
    if config.get_flag("memstats_interval_s") <= 0:
        return None
    return LEDGER.start()


def stop_global() -> None:
    LEDGER.stop()


def reset() -> None:
    LEDGER.reset()


def oom_dump(reason: str) -> Optional[str]:
    """OOM forensics entry: record the event and dump the ring + ledger
    (+ stacks) through the flight recorder's fault path. Called on a
    ``MemoryError`` crossing the serve path and on the RSS soft-limit
    trip; never raises (the fault must still fail its own way)."""
    try:
        _flight.record(EV_MEM_DUMP, note=reason[:120])
        return _flight.dump_global(reason, stacks=True)
    except Exception:   # noqa: BLE001
        return None


# ---------------------------------------------------------------------- #
# fault-dump provider: every flight-recorder dump carries the ledger +
# census + bounded sample history, so postmortem renders the memory
# timeline next to the wire timeline without any extra artifact
# ---------------------------------------------------------------------- #
def _dump_records() -> List[Dict]:
    recs: List[Dict] = []
    snap = LEDGER.snapshot()
    rss, hwm = read_rss()
    census = device_census()
    recs.append({
        "kind": "memory", "ts": round(time.time(), 3),
        "rss_mb": rss, "hwm_mb": hwm,
        "totals": snap["totals"], "components": snap["components"],
        "census": census, "verdicts": LEDGER.verdicts()[-8:],
    })
    for s in LEDGER.samples()[-48:]:
        recs.append({"kind": "memsample", "ts": s.get("ts"),
                     "rss_mb": s.get("rss_mb"),
                     "device_bytes": s.get("device_bytes"),
                     "totals": s.get("totals", {})})
    return recs


_flight.add_dump_provider(_dump_records)
