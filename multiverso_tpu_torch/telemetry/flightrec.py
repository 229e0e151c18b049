"""Always-on flight recorder: the PS plane's black box (port of
``multiverso_tpu/telemetry/flightrec.py``: the same ring, event codes and
dump format, so either package's ``tools/postmortem.py`` merges a mixed
world's dumps).

The plane's steady-state telemetry (histograms, trace spans,
MSG_STATS) is — all of it in-memory, all of it dying with the process. The
failures that actually cost wall-clock (a stuck ``_SendWindow`` flush, a
shard queue that stops draining, a rank dead mid-barrier taking
``file_barrier``/SSP waits to their timeouts) leave no evidence behind.
This module is the production answer (cf. PyTorch's c10d flight
recorder; Dapper-style request tracing covers only the happy path): a
lock-cheap, ALWAYS-ON per-rank ring buffer of the last N wire events and
state transitions, dumped atomically as JSONL at fault time — fatal log,
SIGTERM/SIGABRT, ``Zoo.stop``, peer death with unacked traffic, or a
watchdog trip (telemetry/watchdog.py).

Cost discipline (the recorder cannot be flag-gated off — a black box
that has to be enabled before the crash is not a black box):

* **fixed slots** — ``flightrec_slots`` preallocated 8-field lists; a
  record commits one tuple into its slot with a single slice-assign
  (atomic w.r.t. signal-handler dumps). No growth, no formatting, one
  small tuple on the hot path.
* **one RLock hold** per record (~1 us). RLock, not Lock: a dump may run
  from a signal handler that interrupted the main thread mid-record,
  and a non-reentrant lock would deadlock the handler.
* timestamps are ``time.monotonic()``; the wall-clock anchor
  (``mono_to_wall``) is computed once at DUMP time so per-event cost
  stays one clock read, and tools/postmortem.py can still merge ranks
  onto one wall-clock timeline.

Beyond events, the recorder tracks **in-flight requests**: ``begin_op``
at ``_Peer.request`` (peer rank, wire msg id, type, bytes), ``end_op``
on the reply. This is what the watchdog ages, what ``MSG_HEALTH``
reports as "oldest in-flight op", and what lets a survivor's dump name
the DEAD rank's oldest unacked (src, dst, msg id) — the "who was stuck
on whom" question tools/postmortem.py answers without a repro.

Dump files (``flightrec-rank<r>.jsonl``) are written only when a
directory resolves — the ``flightrec_dir`` flag, else ``$MV_FLIGHTREC_DIR``,
else ``metrics_dir`` — so the always-on recorder never litters a run
that configured no observability output. Each dump atomically REPLACES
the rank's file; a ROUTINE dump (``routine=True`` — the Zoo.stop last
tape) is skipped once any FAULT dump exists, so a shutdown after a
watchdog trip can never overwrite the trip's stacks and in-flight
evidence with a healthy tape. Natively-served ops (the zero-Python C++
fast path) are not recorded, same rule as tracing.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

from multiverso_tpu_torch.telemetry import exporter as _exporter  # noqa: F401  (defines metrics_dir)
from multiverso_tpu_torch.utils import config

config.define_int(
    "flightrec_slots", 4096,
    "flight-recorder ring size (events kept for a fault-time dump); the "
    "recorder itself is always on — this only bounds its fixed memory "
    "(~1 KB per 8 slots). See docs/OBSERVABILITY.md 'Postmortem "
    "debugging'")
config.define_string(
    "flightrec_dir", "",
    "directory for flight-recorder dumps (flightrec-rank<r>.jsonl); "
    "empty falls back to $MV_FLIGHTREC_DIR, then metrics_dir — with "
    "none of the three set, fault-time dumps are skipped (the ring "
    "still records)")

# ---------------------------------------------------------------------- #
# event kinds: small ints on the hot path, names in dumps
# ---------------------------------------------------------------------- #
EV_SEND = 1            # client request on the wire (begin_op)
EV_ACK = 2             # reply completed the request (end_op ok)
EV_ERR = 3             # request failed (end_op not-ok / peer sweep)
EV_RECV = 4            # server side: request arrived on a conn thread
EV_REPLY = 5           # server side: reply handed to the socket
EV_WIN_ENQ = 6         # send window: logical add queued for an owner
EV_WIN_FLUSH = 7       # send window: one owner's flush started
EV_WIN_FLUSH_END = 8   # send window: flush's frames are on the conn
EV_WIN_ACK = 9         # send window: a frame's batch ack fanned out
EV_APPLY = 10          # shard: one updater dispatch applied
EV_WAVE = 11           # shard: one MSG_BATCH conflict-free wave applied
EV_BARRIER_ENTER = 12  # barrier/file_barrier entered
EV_BARRIER_EXIT = 13   # barrier/file_barrier satisfied
EV_BARRIER_TIMEOUT = 14
EV_SSP_WAIT = 15       # SSP clock blocked on stragglers
EV_SSP_TIMEOUT = 16
EV_PEER_DEAD = 17      # a peer connection was observed dead
EV_FATAL = 18          # Logger.fatal fired
EV_SIGNAL = 19         # SIGTERM/SIGABRT reached the dump handler
EV_SLOW = 20           # watchdog: request older than watchdog_slow_ms
EV_STUCK = 21          # watchdog: request older than watchdog_stuck_s
EV_STATE = 22          # free-form state transition (note names it)
EV_SSP_RESOLVED = 23   # a blocked SSP wait resolved (pairs EV_SSP_WAIT)
EV_GET_SERVE = 24      # shard: a get pinned an epoch to serve off-lock
EV_GET_CHUNK = 25      # service: one streamed-reply sub-frame sent
EV_GET_WIN = 26        # client get coalescer: one batched fetch shipped
# elastic shard failover lifecycle (ps/failover.py, docs/FAILOVER.md):
# postmortem renders these five as the recovery timeline
EV_FAILOVER_DETECT = 27   # supervisor confirmed a dead|stuck rank
EV_FAILOVER_RESPAWN = 28  # supervisor launched the replacement
EV_FAILOVER_RESTORE = 29  # a shard restored from its checkpoint
EV_FAILOVER_REPLAY = 30   # replay plane: frame re-flushed / dedup'd
EV_FAILOVER_REJOIN = 31   # restored incarnation is serving again
# serving plane: snapshot serves
# and replica refreshes ride the same tape as gets/adds
EV_SNAPSHOT_SERVE = 32    # shard: MSG_SNAPSHOT export served
EV_REPLICA_PULL = 33      # client: one ReadReplica refresh completed
# memory observability plane (telemetry/memstats.py): leak verdicts +
# the OOM-forensics dump trigger, one event per episode (deduped by
# the ledger until the condition clears — never a per-sweep flood)
EV_MEM_HOARD = 34         # epoch-hoard: aged pin holding retired buffers
EV_MEM_LEAK = 35          # retention-leak: replay tail growing, live owner
EV_MEM_RSS = 36           # rss-creep / rss soft-limit trip
EV_MEM_DUMP = 37          # OOM forensics dump fired (MemoryError/limit)
# device plane (telemetry/devstats.py): collective op begin/end — every
# parallel/collectives.py entry point marks both edges (note carries
# "coll.<op>", nbytes the payload), so a hang inside a mesh collective
# is visible on the tape like a wedged wire op
EV_COLL_BEGIN = 38        # collective op dispatched (host side)
EV_COLL_END = 39          # collective op returned to the caller
# fault-injection wire plane (ps/faults.py, docs/FAILOVER.md "Chaos
# scenarios"): every INJECTED fault lands its own event (note carries
# the kind — drop/delay/duplicate/reorder/partition/reset/slow_serve/
# drop_reply), so injected and organic faults are distinguishable in
# tools/postmortem.py timelines; plane arm/disarm/phase transitions
# mark the scenario's envelope on the same tape
EV_FAULT_INJECT = 40      # one fault injected into the wire plane
EV_FAULT_PLANE = 41       # fault plane armed / disarmed / phase flip
# tenant attribution plane (telemetry/tenants.py): a per-tenant budget
# shed is POLICY, not incident — it lands its own event (note carries
# "table:tenant") so a chaos run's sheds read as intended throttling in
# postmortem timelines; the noisy-neighbor verdict is one event per
# episode, deduped by the ledger until the condition clears (the same
# discipline as the EV_MEM_* verdicts)
EV_TENANT_SHED = 42       # admission refused a read on a tenant budget
EV_TENANT_VERDICT = 43    # noisy-neighbor episode opened
# SLO sentinel (telemetry/slo.py): ONE event per episode transition —
# the burn-rate alert firing and later clearing each land exactly one
# ring write (sentinel-deduped like the tenant verdict), so a chaos
# run's tape reads objective-first without per-poll flooding
EV_SLO_FIRED = 44         # an objective's burn-rate episode opened
EV_SLO_CLEARED = 45       # the episode's fast window re-entered budget

EV_NAMES = {
    EV_SEND: "send", EV_ACK: "ack", EV_ERR: "err", EV_RECV: "recv",
    EV_REPLY: "reply", EV_WIN_ENQ: "win.enqueue",
    EV_WIN_FLUSH: "win.flush", EV_WIN_FLUSH_END: "win.flush_end",
    EV_WIN_ACK: "win.ack", EV_APPLY: "shard.apply",
    EV_WAVE: "shard.wave", EV_BARRIER_ENTER: "barrier.enter",
    EV_BARRIER_EXIT: "barrier.exit",
    EV_BARRIER_TIMEOUT: "barrier.timeout", EV_SSP_WAIT: "ssp.wait",
    EV_SSP_TIMEOUT: "ssp.timeout", EV_PEER_DEAD: "peer.dead",
    EV_FATAL: "fatal", EV_SIGNAL: "signal", EV_SLOW: "watchdog.slow",
    EV_STUCK: "watchdog.stuck", EV_STATE: "state",
    EV_SSP_RESOLVED: "ssp.resolved", EV_GET_SERVE: "get.serve",
    EV_GET_CHUNK: "get.chunk", EV_GET_WIN: "get.window",
    EV_FAILOVER_DETECT: "failover.detect",
    EV_FAILOVER_RESPAWN: "failover.respawn",
    EV_FAILOVER_RESTORE: "failover.restore",
    EV_FAILOVER_REPLAY: "failover.replay",
    EV_FAILOVER_REJOIN: "failover.rejoin",
    EV_SNAPSHOT_SERVE: "snapshot.serve",
    EV_REPLICA_PULL: "replica.pull",
    EV_MEM_HOARD: "mem.epoch_hoard",
    EV_MEM_LEAK: "mem.retention_leak",
    EV_MEM_RSS: "mem.rss",
    EV_MEM_DUMP: "mem.oom_dump",
    EV_COLL_BEGIN: "coll.begin",
    EV_COLL_END: "coll.end",
    EV_FAULT_INJECT: "fault.inject",
    EV_FAULT_PLANE: "fault.plane",
    EV_TENANT_SHED: "tenant.shed",
    EV_TENANT_VERDICT: "tenant.verdict",
    EV_SLO_FIRED: "slo.fired",
    EV_SLO_CLEARED: "slo.cleared",
}

# ---------------------------------------------------------------------- #
# wire-opcode -> ring-event coverage map. Every MSG_* opcode defined in
# ps/service.py MUST have an entry here naming the ring events that mark
# its lifecycle on the tape — tools/check_obs_surface.py asserts the
# mapping statically (tier-1). A new opcode once shipped with no
# flightrec/trace coverage precisely because nothing forced the
# question; an EMPTY tuple is a legitimate answer (probe traffic is
# deliberately excluded so 2 Hz polling cannot wrap the tape past
# pre-wedge evidence) but it must be GIVEN, not forgotten.
# ---------------------------------------------------------------------- #
MSG_EV_COVERAGE = {
    "MSG_REPLY_OK": (EV_ACK, EV_REPLY),
    "MSG_REPLY_ERR": (EV_ERR, EV_REPLY),
    "MSG_REPLY_CHUNK": (EV_GET_CHUNK,),
    "MSG_PING": (),          # probe: excluded from the tape
    # data opcodes also carry EV_FAULT_INJECT where the chaos plane
    # (ps/faults.py) can touch them — an injected drop/dup/reorder on
    # an add frame is part of that opcode's lifecycle on the tape
    "MSG_ADD_ROWS": (EV_SEND, EV_RECV, EV_APPLY, EV_WIN_ENQ,
                     EV_WIN_FLUSH, EV_WIN_ACK, EV_FAULT_INJECT),
    # EV_TENANT_SHED: a read refused on a per-tenant admission budget
    # never reaches the wire, but the shed IS part of the get lifecycle
    # — the tape must show policy throttling next to the frames it
    # displaced (tools/postmortem.py renders both)
    "MSG_GET_ROWS": (EV_SEND, EV_RECV, EV_GET_SERVE, EV_GET_WIN,
                     EV_FAULT_INJECT, EV_TENANT_SHED),
    "MSG_SET_ROWS": (EV_SEND, EV_RECV, EV_APPLY),
    "MSG_ADD_FULL": (EV_SEND, EV_RECV, EV_APPLY),
    "MSG_GET_FULL": (EV_SEND, EV_RECV, EV_GET_SERVE),
    "MSG_KV_ADD": (EV_SEND, EV_RECV, EV_APPLY),
    "MSG_KV_GET": (EV_SEND, EV_RECV, EV_GET_SERVE),
    "MSG_GET_STATE": (EV_SEND, EV_RECV),
    "MSG_SET_STATE": (EV_SEND, EV_RECV),
    "MSG_BATCH": (EV_SEND, EV_RECV, EV_WAVE, EV_WIN_FLUSH, EV_WIN_ACK,
                  EV_FAULT_INJECT),
    # probe traffic itself stays off the tape — but the tenant
    # verdict sweep rides the stats pull and lands ONE event per
    # noisy-neighbor episode (ledger-deduped, never a per-poll flood),
    # and the SLO sentinel judges every objective on the aggregator's
    # stats poll: an episode firing/clearing is one event each,
    # sentinel-deduped under the same discipline
    "MSG_STATS": (EV_TENANT_VERDICT, EV_SLO_FIRED, EV_SLO_CLEARED),
    "MSG_HEALTH": (),        # probe: excluded from the tape
    "MSG_SNAPSHOT": (EV_SNAPSHOT_SERVE, EV_REPLICA_PULL,
                     EV_FAULT_INJECT, EV_TENANT_SHED),
    # multi-owner super-frame (ps/spmd.py, flag ps_fanout): carries
    # add/get sub-ops for every colocated shard of the destination
    # process — grouped applies land EV_APPLY (note "spmd ops=K"),
    # grouped gathers EV_GET_SERVE, per-sub batch dispatch EV_WAVE,
    # and the wire path the ordinary send/recv edges
    "MSG_MULTI": (EV_SEND, EV_RECV, EV_APPLY, EV_WAVE, EV_GET_SERVE,
                  EV_FAULT_INJECT),
}


# ---------------------------------------------------------------------- #
# auxiliary dump providers: other telemetry planes (memstats' byte
# ledger + sample history) register a zero-arg callable returning extra
# JSONL records to append to every dump — fault OR routine — so one
# artifact carries the wire tape AND the memory timeline. Providers run
# at DUMP time only (never on the hot path) and are individually
# fault-isolated: a provider raising must not cost the ring's tape.
# ---------------------------------------------------------------------- #
_dump_providers: List[Any] = []


def add_dump_provider(fn) -> None:
    if fn not in _dump_providers:
        _dump_providers.append(fn)


def resolve_dir() -> Optional[str]:
    """Dump directory resolution (module docstring): flag, env,
    metrics_dir, else None (= record but never write)."""
    d = config.get_flag("flightrec_dir")
    if d:
        return d
    d = os.environ.get("MV_FLIGHTREC_DIR", "")
    if d:
        return d
    d = config.get_flag("metrics_dir")
    return d or None


class FlightRecorder:
    """Process-global ring recorder (one per process, like the Tracer);
    several in-process ranks share it, attributed to the first
    configured rank — the same documented collapse as trace IDs."""

    def __init__(self, slots: Optional[int] = None):
        n = int(slots if slots is not None
                else config.get_flag("flightrec_slots"))
        self._n = max(16, n)
        # preallocated slots, fields assigned in place on record():
        # [seq, mono_ts, kind, peer, msg_type, msg_id, nbytes, note]
        self._slots: List[List[Any]] = [[0, 0.0, 0, -1, 0, -1, 0, None]
                                        for _ in range(self._n)]
        self._seq = 0
        self._lock = threading.RLock()   # RLock: dumps may run from a
        #                                  signal handler mid-record
        # (peer rank, wire msg id) -> (t0 mono, msg_type, nbytes,
        # record-in-ring flag — see begin_op)
        self._inflight: Dict[Tuple[int, int],
                             Tuple[float, int, int, bool]] = {}
        # name -> last-touch monotonic ts (serve loop, shard apply, ...)
        self._beats: Dict[str, float] = {}
        self.rank = 0
        self._rank_pinned = False
        self._dumps = 0
        self._fault_dumped = False
        self._last_dump: Optional[str] = None
        # serializes whole dumps (snapshot -> tmp write -> commit):
        # concurrent triggers (watchdog trip + peer death + Zoo.stop)
        # are exactly the multi-fault moment, and unserialized writers
        # would interleave. RLock for the same signal-handler
        # reentrancy reason as the ring lock; tmp names are ALSO unique
        # per attempt so a reentrant dump can never truncate the
        # interrupted one's half-written file
        self._dump_lock = threading.RLock()
        self._dump_attempts = 0

    # ------------------------------------------------------------------ #
    def configure(self, rank: Optional[int] = None) -> None:
        """Adopt flags (called from PSService init / Zoo.start);
        idempotent. First caller's rank sticks (see class docstring).
        The ring is resized to ``flightrec_slots`` only while still
        empty — resizing a live ring would drop the black box's tape."""
        with self._lock:
            if rank is not None and not self._rank_pinned:
                self.rank = int(rank)
                self._rank_pinned = True
            n = max(16, int(config.get_flag("flightrec_slots")))
            if n != self._n and self._seq == 0:
                self._n = n
                self._slots = [[0, 0.0, 0, -1, 0, -1, 0, None]
                               for _ in range(self._n)]

    # ------------------------------------------------------------------ #
    # hot path
    # ------------------------------------------------------------------ #
    def record(self, kind: int, peer: int = -1, msg_type: int = 0,
               msg_id: int = -1, nbytes: int = 0,
               note: Optional[str] = None) -> None:
        # slot first, seq last, each a single bytecode: a signal
        # handler's dump interrupting this method re-enters the RLock on
        # the same thread, and either ordering mistake would let its
        # snapshot emit a torn or stale record at the TAIL of the fault
        # dump — the first line an operator reads
        with self._lock:
            i = self._seq
            self._slots[i % self._n][:] = (
                i, time.monotonic(), kind, peer, msg_type, msg_id,
                nbytes, note)
            self._seq = i + 1

    def begin_op(self, peer: int, msg_id: int, msg_type: int,
                 nbytes: int = 0, record: bool = True) -> None:
        """A request left for ``peer``: record the send edge and track it
        in flight until :meth:`end_op` (one lock hold for both).
        ``record=False`` tracks WITHOUT ring events — probe traffic
        (ping/stats polls) is legitimately stuck traffic the watchdog
        should age, but its send/ack edges at supervisor polling rates
        would wrap the tape past pre-wedge evidence (same rule as the
        server-side probe exclusion)."""
        with self._lock:
            if record:
                self.record(EV_SEND, peer=peer, msg_type=msg_type,
                            msg_id=msg_id, nbytes=nbytes)
            self._inflight[(peer, msg_id)] = (time.monotonic(), msg_type,
                                              nbytes, record)

    def end_op(self, peer: int, msg_id: int, ok: bool = True) -> None:
        """Close an in-flight op. Idempotent: racing closers (reply vs.
        death-sweep vs. the send path's unwind) record ONE ack/err edge
        — an already-closed op is a silent no-op, so callers may close
        unconditionally without spraying phantom events into the ring."""
        with self._lock:
            ent = self._inflight.pop((peer, msg_id), None)
            if ent is None:
                return
            if ent[3]:   # honor begin_op's record-in-ring flag
                self.record(EV_ACK if ok else EV_ERR, peer=peer,
                            msg_type=ent[1], msg_id=msg_id)

    def fail_peer(self, peer: int, msg_ids=None) -> int:
        """Drop in-flight ops to a dead peer (AFTER the death dump: the
        dump is what preserves them); returns how many were dropped.
        ``msg_ids`` scopes the sweep to the DYING INCARNATION's own
        requests — a reconnected fresh peer may already have live ops
        under the same rank, and a rank-wide sweep would silently erase
        them from the watchdog's view (None sweeps the whole rank, for
        callers that know no newer incarnation exists). One EV_ERR marks
        the sweep — per-op events would spam the ring right when its
        tail matters most."""
        with self._lock:
            if msg_ids is None:
                gone = [k for k in self._inflight if k[0] == peer]
            else:
                gone = [(peer, m) for m in msg_ids
                        if (peer, m) in self._inflight]
            for k in gone:
                del self._inflight[k]
            if gone:
                self.record(EV_ERR, peer=peer, nbytes=len(gone),
                            note="peer died; in-flight ops failed")
            return len(gone)

    def beat(self, name: str) -> None:
        """Liveness heartbeat for a named loop (GIL-atomic dict store —
        no lock on this path)."""
        self._beats[name] = time.monotonic()

    def beat_age(self, name: str) -> Optional[float]:
        t = self._beats.get(name)
        return None if t is None else time.monotonic() - t

    # ------------------------------------------------------------------ #
    # reads
    # ------------------------------------------------------------------ #
    def snapshot(self, last: Optional[int] = None) -> List[List[Any]]:
        """Ring contents in record order (oldest first), copied.
        ``last`` bounds the work to the newest N slots — the copy runs
        under the hot path's lock, so a periodic consumer (the
        watchdog's 10-event slow-report window) must cost O(N), not an
        O(flightrec_slots) sweep of the whole ring."""
        with self._lock:
            i = self._seq
            count = min(i, self._n)
            take = count if last is None else min(last, count)
            # slots for seq [i-take, i) — index arithmetic, no full-ring
            # slice/concat even when the ring has wrapped
            return [list(self._slots[j % self._n])
                    for j in range(i - take, i)]

    def inflight_snapshot(self) -> List[Tuple[int, int, float, int, int]]:
        """[(peer, msg_id, age_s, msg_type, nbytes)], unordered."""
        now = time.monotonic()
        with self._lock:
            return [(p, mid, now - ent[0], ent[1], ent[2])
                    for (p, mid), ent in self._inflight.items()]

    def oldest_inflight(self) -> Optional[Tuple[float, int, int, int]]:
        """(age_s, peer, msg_id, msg_type) of the oldest unacked
        request, or None."""
        snap = self.inflight_snapshot()
        if not snap:
            return None
        p, mid, age, mt, _ = max(snap, key=lambda e: e[2])
        return (age, p, mid, mt)

    def dump_stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"count": self._dumps, "last": self._last_dump}

    # ------------------------------------------------------------------ #
    def dump(self, reason: str, directory: Optional[str] = None,
             stacks: bool = False, routine: bool = False) -> Optional[str]:
        """Atomically write the ring (+ in-flight table, + per-thread
        stacks when ``stacks``) as ``flightrec-rank<r>.jsonl``. Returns
        the path, or None when no directory resolves. ``routine=True``
        (the Zoo.stop last tape) is SKIPPED once a fault dump exists —
        the routine tape's only value is "last state when nothing else
        fired", and replacing a fault dump with it would destroy the
        stacks/in-flight evidence the recorder exists to preserve (a
        LATER fault dump still replaces an earlier one: the rate-limited
        refresh of a long hang). Never raises — fault paths call this
        and must still fail their own way."""
        try:
            directory = directory or resolve_dir()
            if not directory:
                return None
            if routine and self._fault_dumped:
                return None
            self._dump_lock.acquire()
        except Exception:   # noqa: BLE001
            return None
        try:
            events = self.snapshot()
            inflight = self.inflight_snapshot()
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(directory,
                                f"flightrec-rank{self.rank}.jsonl")
            with self._lock:
                self._dump_attempts += 1
                attempt = self._dump_attempts
            tmp = (f"{path}.{os.getpid()}.{threading.get_ident()}"
                   f".{attempt}.tmp")
            header = {
                "kind": "header", "rank": self.rank, "pid": os.getpid(),
                "reason": reason, "ts": round(time.time(), 6),
                # per-process monotonic -> wall anchor, so postmortem can
                # merge several ranks' events onto one timeline
                "mono_to_wall": round(time.time() - time.monotonic(), 6),
                "events": len(events), "slots": self._n,
                "dump_seq": self._dumps,
            }
            with open(tmp, "w") as f:
                f.write(json.dumps(header) + "\n")
                for s in events:
                    f.write(json.dumps({
                        "kind": "event", "seq": s[0],
                        "mono": round(s[1], 6),
                        "ev": EV_NAMES.get(s[2], s[2]), "peer": s[3],
                        "type": s[4], "msg_id": s[5], "nbytes": s[6],
                        "note": s[7]}) + "\n")
                for (p, mid, age, mt, nb) in inflight:
                    f.write(json.dumps({
                        "kind": "inflight", "peer": p, "msg_id": mid,
                        "age_s": round(age, 3), "type": mt,
                        "nbytes": nb}) + "\n")
                if stacks:
                    names = {t.ident: t.name
                             for t in threading.enumerate()}
                    for tid, frame in sys._current_frames().items():
                        lines = traceback.format_stack(frame)
                        f.write(json.dumps({
                            "kind": "stack", "tid": tid,
                            "thread": names.get(tid, "?"),
                            "frames": [ln.strip()
                                       for ln in lines[-24:]]}) + "\n")
                for prov in list(_dump_providers):
                    try:
                        for rec in prov() or ():
                            f.write(json.dumps(rec) + "\n")
                    except Exception:   # noqa: BLE001 — a provider bug
                        pass            # must not cost the ring's tape
            # commit: _dump_lock (held for this whole method) serializes
            # racing dumps, so a fault dump either finished before this
            # routine one started (the re-check below sees the flag) or
            # starts after (and correctly replaces the routine tape).
            # The ring lock is NOT held across the filesystem ops — a
            # slow disk must stall dumps, never the hot path's record().
            with self._lock:
                fault_already = self._fault_dumped
            if routine and fault_already:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                return None
            os.replace(tmp, path)
            with self._lock:
                self._dumps += 1
                if not routine:
                    self._fault_dumped = True
                self._last_dump = path
            return path
        except Exception:   # noqa: BLE001 — the black box must never
            return None     # turn a fault into a different fault
        finally:
            self._dump_lock.release()

    def reset(self) -> None:
        """Test isolation: empty the ring/in-flight table and unpin."""
        with self._lock:
            self._seq = 0
            for s in self._slots:
                s[0] = 0
                s[7] = None
            self._inflight.clear()
            self._beats.clear()
            self._rank_pinned = False
            self.rank = 0
            self._dumps = 0
            self._fault_dumped = False
            self._last_dump = None


RECORDER = FlightRecorder()


# module-level wrappers (the call-site idiom, like telemetry.trace)
def configure(rank: Optional[int] = None) -> None:
    RECORDER.configure(rank)


def record(kind: int, peer: int = -1, msg_type: int = 0, msg_id: int = -1,
           nbytes: int = 0, note: Optional[str] = None) -> None:
    RECORDER.record(kind, peer=peer, msg_type=msg_type, msg_id=msg_id,
                    nbytes=nbytes, note=note)


def begin_op(peer: int, msg_id: int, msg_type: int, nbytes: int = 0,
             record: bool = True) -> None:
    RECORDER.begin_op(peer, msg_id, msg_type, nbytes, record=record)


def end_op(peer: int, msg_id: int, ok: bool = True) -> None:
    RECORDER.end_op(peer, msg_id, ok)


def beat(name: str) -> None:
    RECORDER.beat(name)


def dump_global(reason: str, stacks: bool = False,
                routine: bool = False) -> Optional[str]:
    return RECORDER.dump(reason, stacks=stacks, routine=routine)


def dump_stats() -> Dict[str, Any]:
    return RECORDER.dump_stats()


def reset() -> None:
    RECORDER.reset()


# ---------------------------------------------------------------------- #
# fault-signal hook: dump before the previous disposition runs
# ---------------------------------------------------------------------- #
_installed: Dict[int, Any] = {}


def install_signal_handlers(signals=(signal.SIGTERM, signal.SIGABRT)
                            ) -> None:
    """Chain a dump in front of the existing SIGTERM/SIGABRT
    disposition (installed from Zoo.start). A handler installed LATER
    (e.g. bench.py's salvage) replaces this one — such owners call
    :func:`dump_global` themselves. No-op off the main thread."""
    for sig in signals:
        if sig in _installed:
            continue
        try:
            prev = signal.getsignal(sig)

            def _handler(signum, frame, _prev=prev):
                try:
                    RECORDER.record(EV_SIGNAL, note=f"signal {signum}")
                    RECORDER.dump(f"signal {signum}", stacks=True)
                except Exception:   # noqa: BLE001
                    pass
                if callable(_prev):
                    _prev(signum, frame)
                elif _prev != signal.SIG_IGN:
                    # SIG_DFL — or None, a handler installed by C code
                    # that Python cannot call: restore default + re-raise
                    # so the process still dies with the right status
                    # (swallowing SIGTERM would make it unkillable short
                    # of SIGKILL)
                    signal.signal(signum, signal.SIG_DFL)
                    os.kill(os.getpid(), signum)

            signal.signal(sig, _handler)
            _installed[sig] = prev
        except (ValueError, OSError):   # not the main thread / exotic env
            pass
