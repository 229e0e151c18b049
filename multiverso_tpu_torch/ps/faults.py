"""Fault-injection wire plane: seeded, declarative, off by default (port
of ``multiverso_tpu/ps/faults.py``).

Degraded states are provoked deterministically at the boundaries where
they occur in production: the ``_Peer`` client send path and the
``_serve_conn`` server loop in ``ps/service.py``. Those are the Python
wire's: the native plane's C++ threads bypass them, so a chaos run sets
``ps_native=False``, as the JAX package's does.

Fault kinds (per-(src, dst) rules of a declarative JSON scenario spec):

* ``drop`` — the frame never reaches the wire (the caller's timeout is
  the only signal, like a lossy link);
* ``delay`` — the send sleeps ``delay_ms`` ± ``jitter_ms`` first (a slow
  wire; backpressures senders to that peer like a real one);
* ``duplicate`` — the encoded frame is sent twice (the shard's replay
  sequence channels must dedupe the second apply);
* ``reorder`` — the frame is held back and released AFTER the next
  frame(s) to the same peer, up to ``depth`` held at once;
* ``partition`` — one-way src→dst: every send raises a synthetic
  connection reset before touching the socket, so the peer is observed
  dead, replay re-arms, and reconnects keep failing until the rule
  deactivates (heal);
* ``reset`` — one injected connection reset (then traffic resumes on
  the reconnect);
* ``slow_serve`` — the SERVER sleeps ``delay_ms`` before handling a
  data request (a slow rank, not a slow wire);
* ``drop_reply`` — the server handles the request but never sends the
  reply (an ack lost after the apply: the replay plane must dedupe the
  client's retry).

Determinism: every probabilistic decision is a pure function of
``(seed, rule index, src, dst, per-pair message index)`` — no wall
clock, no shared RNG stream — so the same seed, spec and per-pair
message sequence inject the identical fault sequence in this package and
in the JAX one. Rules gated by a ``phase`` flip only when the scenario
calls :meth:`FaultPlane.set_phase`; ``from_s``/``until_s`` wall-clock
windows exist for free-running chaos and are reproducible at scenario
granularity only.

Cost: module global :data:`PLANE` is :class:`NullFaultPlane` unless a
spec is armed, and every hook site guards on ``PLANE.armed`` (one global
load and one attribute load); disarmed, no injection code path is
reachable.

Every injected fault lands an ``EV_FAULT_INJECT`` event on the flight
recorder (its note names the kind), and arming, disarming and phase
flips land ``EV_FAULT_PLANE``, so injected and organic faults tell apart
in postmortem timelines. :meth:`FaultPlane.stats` and
:meth:`FaultPlane.log_snapshot` carry what was injected.

Scenario spec (JSON; :func:`load_spec` accepts a path or inline JSON)::

    {"seed": 7,
     "rules": [
       {"kind": "duplicate", "src": 0, "dst": 1, "p": 0.3,
        "msg_types": ["MSG_BATCH", "MSG_ADD_ROWS"]},
       {"kind": "partition", "src": "*", "dst": 1,
        "phase": "partitioned"},
       {"kind": "slow_serve", "rank": 1, "delay_ms": 50, "p": 1.0}]}
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from multiverso_tpu_torch.telemetry import flightrec as _flight
from multiverso_tpu_torch.utils import config, log

KINDS = ("drop", "delay", "duplicate", "reorder", "partition", "reset",
         "slow_serve", "drop_reply")
_SEND_KINDS = ("drop", "delay", "duplicate", "reorder", "partition",
               "reset")
_SERVE_KINDS = ("slow_serve", "drop_reply")


class InjectedFault(ConnectionResetError):
    """Synthetic connection reset raised at an injected partition /
    reset point. Subclasses ConnectionResetError so the existing
    OSError handling in ``_Peer.request`` treats it exactly like a
    real peer death (that is the point) while postmortems can still
    tell it apart by type name."""


def _msg_type_ids(names) -> Optional[frozenset]:
    """Spec ``msg_types`` (names like "MSG_ADD_ROWS" or raw ints) to an
    id set; None = every type. Lazy service import (service imports
    this module at module scope)."""
    if not names:
        return None
    out = set()
    for n in names:
        if isinstance(n, int):
            out.add(n)
        else:
            from multiverso_tpu_torch.ps import service as svc
            v = getattr(svc, str(n), None)
            if not isinstance(v, int):
                raise ValueError(f"faults spec: unknown msg type {n!r}")
            out.add(v)
    return frozenset(out)


class Rule:
    """One declarative fault rule, validated up front so a typo'd spec
    fails at arm time, not silently mid-chaos."""

    __slots__ = ("idx", "kind", "src", "dst", "p", "msg_types",
                 "delay_ms", "jitter_ms", "depth", "phase", "from_s",
                 "until_s", "count", "max_count")

    def __init__(self, idx: int, spec: Dict[str, Any]):
        self.idx = idx
        self.kind = spec.get("kind")
        if self.kind not in KINDS:
            raise ValueError(f"faults spec rule {idx}: unknown kind "
                             f"{self.kind!r} (one of {KINDS})")
        # slow_serve/drop_reply are server-side: "rank" names the slow
        # rank (the serving side has no peer identity for the client)
        self.src = spec.get("src", "*")
        self.dst = spec.get("dst", spec.get("rank", "*"))
        self.p = float(spec.get("p", 1.0))
        self.msg_types = _msg_type_ids(spec.get("msg_types"))
        self.delay_ms = float(spec.get("delay_ms", 0.0))
        self.jitter_ms = float(spec.get("jitter_ms", 0.0))
        self.depth = max(int(spec.get("depth", 1)), 1)
        self.phase = spec.get("phase")
        self.from_s = spec.get("from_s")
        self.until_s = spec.get("until_s")
        self.max_count = spec.get("max_count")   # None = unbounded
        self.count = 0

    def matches(self, src: int, dst: int, msg_type: int,
                phase: Optional[str], t_s: float) -> bool:
        if self.phase is not None and self.phase != phase:
            return False
        if self.from_s is not None and t_s < self.from_s:
            return False
        if self.until_s is not None and t_s >= self.until_s:
            return False
        if self.src != "*" and int(self.src) != src:
            return False
        if self.dst != "*" and int(self.dst) != dst:
            return False
        if self.msg_types is not None and msg_type not in self.msg_types:
            return False
        if self.max_count is not None and self.count >= self.max_count:
            return False
        return True


def _draw(seed: int, rule_idx: int, src: int, dst: int, n: int) -> float:
    """Deterministic uniform [0,1) from the decision coordinates — a
    fresh, integer-keyed Random per decision so one rule's draws can
    never shift another's (stateful streams would), and int keys so
    PYTHONHASHSEED never enters. Off the hot path by construction (the
    plane is armed)."""
    key = (seed * 1000003) ^ (rule_idx * 8191) ^ (src * 131071) \
        ^ (dst * 524287) ^ (n * 2654435761)
    return random.Random(key).random()


class SendPlan:
    """What the hook site should do with one outbound frame."""

    __slots__ = ("drop", "delay_s", "duplicate", "reorder", "hold_s",
                 "depth", "reset", "kinds")

    def __init__(self):
        self.drop = False
        self.delay_s = 0.0
        self.duplicate = False
        self.reorder = False
        # reorder release valve: a held frame ships after the NEXT
        # frame to the peer or after this long, whichever first — a
        # blocking caller awaiting the held frame's own ack must not
        # deadlock waiting for traffic it is itself the source of
        self.hold_s = 0.025
        # bounded reorder: frames held back at once (the rule's depth,
        # clamped by the hook site's own safety cap)
        self.depth = 1
        self.reset = False
        self.kinds: List[str] = []


class NullFaultPlane:
    """The disarmed plane: hook sites check ``armed`` and never call
    anything else — flag-off keeps every injection codepath
    unreachable (the null-object rule)."""

    armed = False

    def stats(self) -> Dict[str, Any]:
        return {}


class FaultPlane:
    """One armed scenario: rules + deterministic per-pair streams +
    the injected-fault log the golden tests compare."""

    armed = True

    def __init__(self, spec: Dict[str, Any],
                 seed: Optional[int] = None, rank: int = 0):
        rules = spec.get("rules")
        if not isinstance(rules, list) or not rules:
            raise ValueError("faults spec: 'rules' must be a non-empty "
                             "list")
        self.rules = [Rule(i, r) for i, r in enumerate(rules)]
        self.seed = int(spec.get("seed", seed if seed is not None
                                 else config.get_flag("faults_seed")))
        self.rank = int(rank)
        self.phase: Optional[str] = spec.get("phase")
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        # per-(src,dst) outbound message index: the determinism axis
        self._msg_n: Dict[Tuple[int, int], int] = {}
        self.counts: Dict[str, int] = {}
        # bounded injected-fault log (the golden-sequence evidence):
        # (pair msg index, kind, src, dst, msg_type)
        self.log: List[Tuple[int, str, int, int, int]] = []
        self._log_cap = 4096

    # ------------------------------------------------------------------ #
    def set_phase(self, phase: Optional[str]) -> None:
        """Flip phase-gated rules (explicit, reproducible — never
        wall-clock). Records the transition on the ring."""
        self.phase = phase
        _flight.record(_flight.EV_FAULT_PLANE,
                       note=f"phase={phase or '-'}")

    def configure(self, rank: int) -> None:
        self.rank = int(rank)

    def _note(self, kind: str, n: int, src: int, dst: int,
              msg_type: int, msg_id: int = -1,
              extra: str = "") -> None:
        """Record one injected fault. Caller holds ``self._lock`` —
        the whole decision loop runs under it, so per-rule counts
        (max_count), the injected log and the ring events stay
        consistent and deterministic under concurrent senders."""
        self.counts[kind] = self.counts.get(kind, 0) + 1
        if len(self.log) < self._log_cap:
            self.log.append((n, kind, src, dst, msg_type))
        _flight.record(_flight.EV_FAULT_INJECT, peer=dst,
                       msg_type=msg_type, msg_id=msg_id,
                       note=f"{kind}{extra} src={src}")

    # ------------------------------------------------------------------ #
    def plan_send(self, dst: int, msg_type: int, msg_id: int = -1,
                  src: Optional[int] = None) -> Optional[SendPlan]:
        """Decide this outbound frame's fate. ``src`` is the sending
        rank (the peer registry threads it through; in-process
        multi-rank worlds would otherwise all report the last
        configured rank). None = untouched (the overwhelmingly common
        case even under chaos). The per-pair message index advances
        for every frame, matched or not, so rule activation never
        shifts the decision stream."""
        if src is None or src < 0:
            src = self.rank
        t_s = time.monotonic() - self._t0
        plan: Optional[SendPlan] = None
        # ONE lock hold over the whole decision: the per-pair index,
        # every rule's max_count check-and-increment, and the injected
        # log commit together — concurrent senders can neither
        # overshoot a one-shot rule nor interleave the log
        with self._lock:
            n = self._msg_n.get((src, dst), 0)
            self._msg_n[(src, dst)] = n + 1
            matched: List[Tuple[Rule, str]] = []
            for rule in self.rules:
                if rule.kind not in _SEND_KINDS:
                    continue
                if not rule.matches(src, dst, msg_type, self.phase,
                                    t_s):
                    continue
                if rule.p < 1.0 and _draw(self.seed, rule.idx, src,
                                          dst, n) >= rule.p:
                    continue
                rule.count += 1
                if plan is None:
                    plan = SendPlan()
                extra = ""
                if rule.kind in ("drop", "partition"):
                    plan.drop = plan.drop or rule.kind == "drop"
                    plan.reset = plan.reset or rule.kind == "partition"
                elif rule.kind == "delay":
                    j = rule.jitter_ms * (
                        2.0 * _draw(self.seed, rule.idx + 10007, src,
                                    dst, n) - 1.0)
                    d = max(rule.delay_ms + j, 0.0) / 1e3
                    plan.delay_s += d
                    extra = f":{d * 1e3:.1f}ms"
                elif rule.kind == "duplicate":
                    plan.duplicate = True
                elif rule.kind == "reorder":
                    plan.reorder = True
                    plan.depth = max(plan.depth, rule.depth)
                    if rule.delay_ms > 0:
                        plan.hold_s = rule.delay_ms / 1e3
                matched.append((rule, extra))
            if plan is not None:
                # note only the kinds that take EFFECT at the hook site
                # (stats and the log are what operators and the golden
                # tests trust): a terminal reset/partition suppresses
                # drop/duplicate/reorder (the frame never ships), a
                # drop suppresses duplicate/reorder, a reorder hold
                # suppresses duplicate (the held frame ships once).
                # Delay always happened — the sleep runs first. The
                # decision DRAWS above are unaffected (per-rule keyed),
                # so suppression never shifts the streams.
                for rule, extra in matched:
                    k = rule.kind
                    if plan.reset and k in ("drop", "duplicate",
                                            "reorder"):
                        continue
                    if plan.drop and k in ("duplicate", "reorder"):
                        continue
                    if plan.reorder and k == "duplicate":
                        continue
                    plan.kinds.append(k)
                    self._note(k, n, src, dst, msg_type, msg_id, extra)
        return plan

    def plan_serve(self, msg_type: int, msg_id: int = -1,
                   rank: Optional[int] = None) -> Tuple[float, bool]:
        """Server-side decision for one received data request:
        (slow-serve sleep seconds, drop the reply?). ``rank`` is the
        SERVING rank (dst; the serve loop threads it through for
        in-process multi-rank worlds); the requester's identity is
        unknown at the conn (src = -1 in the decision coordinates and
        the log)."""
        dst = self.rank if rank is None or rank < 0 else int(rank)
        t_s = time.monotonic() - self._t0
        sleep_s, drop_reply = 0.0, False
        with self._lock:   # same one-hold rule as plan_send
            n = self._msg_n.get((-1, dst), 0)
            self._msg_n[(-1, dst)] = n + 1
            for rule in self.rules:
                if rule.kind not in _SERVE_KINDS:
                    continue
                if not rule.matches(-1, dst, msg_type, self.phase,
                                    t_s):
                    continue
                if rule.p < 1.0 and _draw(self.seed, rule.idx, -1,
                                          dst, n) >= rule.p:
                    continue
                rule.count += 1
                if rule.kind == "slow_serve":
                    j = rule.jitter_ms * (
                        2.0 * _draw(self.seed, rule.idx + 10007, -1,
                                    dst, n) - 1.0)
                    d = max(rule.delay_ms + j, 0.0) / 1e3
                    sleep_s += d
                    self._note("slow_serve", n, -1, dst, msg_type,
                               msg_id, f":{d * 1e3:.1f}ms")
                else:
                    drop_reply = True
                    self._note("drop_reply", n, -1, dst, msg_type,
                               msg_id)
        return sleep_s, drop_reply

    # ------------------------------------------------------------------ #
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"seed": self.seed, "phase": self.phase,
                    "injected": dict(self.counts),
                    "rules": len(self.rules),
                    "logged": len(self.log)}

    def log_snapshot(self) -> List[Tuple[int, str, int, int, int]]:
        with self._lock:
            return list(self.log)


# ---------------------------------------------------------------------- #
# module plane: the null object unless armed
# ---------------------------------------------------------------------- #
NULL = NullFaultPlane()
PLANE: Any = NULL
_arm_lock = threading.Lock()


def enabled() -> bool:
    return PLANE.armed


def load_spec(spec) -> Dict[str, Any]:
    """A dict passes through; a string is inline JSON (starts with
    '{') or a file path."""
    if isinstance(spec, dict):
        return spec
    s = str(spec).strip()
    if s.startswith("{"):
        return json.loads(s)
    with open(s) as f:
        return json.load(f)


def arm(spec, seed: Optional[int] = None,
        rank: Optional[int] = None) -> FaultPlane:
    """Build + bind the process fault plane (replaces any previous
    one). Records the arming on the ring so a chaos run's dump is
    self-describing."""
    global PLANE
    plane = FaultPlane(load_spec(spec), seed=seed,
                       rank=rank if rank is not None else
                       getattr(PLANE, "rank", 0))
    with _arm_lock:
        PLANE = plane
    _flight.record(_flight.EV_FAULT_PLANE,
                   note=f"armed seed={plane.seed} "
                        f"rules={len(plane.rules)}")
    log.info("fault plane armed: %d rules, seed %d", len(plane.rules),
             plane.seed)
    return plane


def disarm() -> None:
    global PLANE
    with _arm_lock:
        was = PLANE
        PLANE = NULL
    if was.armed:
        _flight.record(_flight.EV_FAULT_PLANE, note="disarmed")


def configure(rank: int) -> None:
    """Adopt this process's rank (PSService init) and arm from the
    ``faults_spec`` flag / ``$MV_FAULTS_SPEC`` when set and the plane
    is not already armed — the flag path chaos bench workers use. One
    flag read when disarmed; nothing else runs."""
    if PLANE.armed:
        PLANE.configure(rank)
        return
    spec = config.get_flag("faults_spec") or os.environ.get(
        "MV_FAULTS_SPEC", "")
    if spec:
        try:
            arm(spec, rank=rank)
        except Exception as e:   # noqa: BLE001 — a bad spec must be
            # loud but must not take the service down with it
            log.error("fault plane arm failed (%s: %s); plane stays "
                      "disarmed", type(e).__name__, e)
