"""The PS half of the mesh data plane: process colocation and stacked
shard groups (port of ``multiverso_tpu/ps/spmd.py``).

Two halves, both off by default:

**Process colocation registry and fan-out routing** (flag ``ps_fanout``).
Every :class:`~multiverso_tpu_torch.ps.service.PSService` registers here
under ``(world key, rank)`` once it publishes its address; the world key
is the rendezvous identity (``FileRendezvous.identity``, the directory's
real path), so two independent worlds in one process never cross-route.
With the flag armed, a client's Python-plane request to a COLOCATED rank
skips the localhost socket and runs inline on the caller's thread in the
owning service's handler: the caller's program order is per-owner FIFO,
so read-your-writes and the send-window fences keep their contract.
Multi-owner row ops coalesce into ONE ``MSG_MULTI`` super-frame per
destination process (``PSService.multi_local``), whose sub-ops the
service dispatches across its colocated shards: an N-shard row op costs
one dispatch, not N socket round trips.

**Stacked shard groups** (flag ``ps_spmd_stack``). Colocated
``RowShard``\\ s of one table that live on one ``torch.device`` pool their
rows into ONE ``(S, R_max, C)`` tensor on that device, and each row-axis
updater-state leaf stacks the same way (``ops/spmd_apply.py``): one plane
per (world key, table, device). A wave round of several shards applies
as one gather -> updater -> scatter over the flattened stack, and a
multi-owner get as one ``index_select``. On a machine with one card every
member of a table stacks on ``cuda:0``, which is what the JAX package's
``_make_mesh`` gives with one local device (no mesh); shards on different
cards stack per card, the counterpart of the contiguous slot blocks the
JAX package places on each device of its ``("shards",)`` mesh. Shards keep
their identity (locks, pins, stats, replay channels, checkpoints are all
per shard); only the storage and the dispatch are pooled.

Classic per-shard reads of a grouped shard (``RowShard._data`` /
``_ustate``) get a COPY of its slab, cached per plane epoch: a slab view
of the stack would change under a reader that pinned it, and the JAX
contract is that a pinned view never changes. The hot paths never
materialize one: grouped adds run through :meth:`MeshStack.apply_grouped`
and grouped gets through :meth:`MeshStack.gather_grouped`, whose
``index_select`` makes a new tensor. Exotic mutations (``set_rows``,
whole-table adds, state restores) EVICT the shard back to classic storage
first.

Lock order (everywhere): the plane's admit lock, then the member shards'
locks sorted by ``(lo, id)``, then the plane lock. The plane never takes a
shard lock while holding its own. A grouped apply bumps the shards'
``_version`` under the plane lock, so the snapshot and checkpoint reads
hold the plane lock across (version, bytes).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.ops import spmd_apply
from multiverso_tpu_torch.telemetry import flightrec as _flight
from multiverso_tpu_torch.telemetry import memstats as _memstats
from multiverso_tpu_torch.updaters import (AddOption,
                                           OPT_INSENSITIVE as _OPT_INSENSITIVE,
                                           STATELESS_LINEAR as _LINEAR)
from multiverso_tpu_torch.utils import config, log
from multiverso_tpu_torch.utils.dashboard import Dashboard

config.define_bool(
    "ps_fanout", False,
    "process-coalesced fan-out routing for the async PS: python-plane "
    "requests to COLOCATED ranks (same process, same world) skip the "
    "localhost socket and dispatch in-process, and multi-owner row ops "
    "ship as ONE multi-owner super-frame (MSG_MULTI) per destination "
    "process instead of one frame per shard. Off by default: the wire "
    "benches and chaos planes measure the socket path; tools/"
    "bench_scale.py arms it for the mesh scale curve")
config.define_bool(
    "ps_spmd_stack", False,
    "pool colocated same-table device-backed row shards into one "
    "mesh-sharded (S, rows, cols) stacked array and compile the "
    "apply/gather paths to ONE per-device SPMD program per dispatch "
    "(ops/spmd_apply.py). Engages only for shards that are not "
    "host-numpy mode, not natively registered, not locally sharded, "
    "with a row-local-state updater and no sparse dirty-bit protocol; "
    "anything else keeps the classic per-shard path")


# ---------------------------------------------------------------------- #
# process colocation registry
# ---------------------------------------------------------------------- #
_REG_LOCK = threading.RLock()
# (world key, rank) -> PSService (live services only; close() removes)
_SERVICES: Dict[Tuple[Any, int], Any] = {}
# (world key, table, device) -> MeshStack
_PLANES: Dict[Tuple[Any, str, str], "MeshStack"] = {}


def proc_key(rendezvous) -> Optional[Any]:
    """World identity for colocation decisions: services may only route
    to each other when they share BOTH a process and a rendezvous.
    ``None`` = no rendezvous = single-rank world, nothing to route."""
    if rendezvous is None:
        return None
    ident = getattr(rendezvous, "identity", None)
    if ident is not None:
        return ident
    return ("obj", id(rendezvous))


def register_service(service) -> None:
    key = getattr(service, "_proc_key", None)
    if key is None:
        return
    with _REG_LOCK:
        _SERVICES[(key, service.rank)] = service


def unregister_service(service) -> None:
    key = getattr(service, "_proc_key", None)
    if key is None:
        return
    with _REG_LOCK:
        if _SERVICES.get((key, service.rank)) is service:
            del _SERVICES[(key, service.rank)]


def colocated_service(key, rank: int):
    """The LIVE colocated service for ``(key, rank)``, or None. A closed
    service that never unregistered is pruned here, so routing observes
    its death as it would a dead socket."""
    if key is None:
        return None
    with _REG_LOCK:
        svc = _SERVICES.get((key, int(rank)))
        if svc is None:
            return None
        if getattr(svc, "_closed", False):
            del _SERVICES[(key, int(rank))]
            return None
        return svc


def colocated_ranks(key) -> List[int]:
    if key is None:
        return []
    with _REG_LOCK:
        return sorted(r for (k, r), s in _SERVICES.items()
                      if k == key and not getattr(s, "_closed", False))


def reset_registry() -> None:
    """Test isolation: drop every registration (leaked services keep
    their threads; the registry must not keep routing to them)."""
    with _REG_LOCK:
        _SERVICES.clear()
        _PLANES.clear()


# ---------------------------------------------------------------------- #
# stacked shard groups
# ---------------------------------------------------------------------- #
def shard_eligible(shard) -> bool:
    """Stacked-grouping eligibility; anything else keeps the classic path
    (never wrong, only ungrouped):

    * exactly a ``RowShard`` (a ``HashShard`` grows and remaps its rows);
    * not ``_np_mode`` (a CPU tensor with a linear updater: it applies in
      place at host speed, and the native C++ server may hold its
      pointer), and not natively registered;
    * a ``ROW_LOCAL_STATE`` updater (per-row elementwise with row-aligned
      state, so a round that leaves a shard out, or splits by option,
      changes nothing it should not);
    * no sparse dirty-bit protocol (its mask snapshot is coupled to the
      per-shard lock discipline).

    So a card shard with the default updater groups, and so does a CPU
    shard with AdaGrad. The port has no local device sharding, which the
    JAX package also excludes."""
    from multiverso_tpu_torch.ps.shard import RowShard
    from multiverso_tpu_torch.updaters import ROW_LOCAL_STATE
    return (type(shard) is RowShard
            and not shard._np_mode
            and shard._native_ref is None
            and shard._dirty is None
            and type(shard.updater) in ROW_LOCAL_STATE)


def try_join(service, table: str, shard) -> Optional["MeshStack"]:
    """Admit ``shard`` to its table's stacked group on its device when the
    flag is armed and the shard qualifies. Called from
    ``PSService.register_handler``. Returns the plane when the shard ended
    up in it (the group activates at its second member); an ineligible
    shard returns None, and a failed admit logs and leaves it classic."""
    key = getattr(service, "_proc_key", None)
    if (key is None or not config.get_flag("ps_spmd_stack")
            or not shard_eligible(shard)):
        return None
    pkey = (key, table, str(shard.device))
    with _REG_LOCK:
        plane = _PLANES.get(pkey)
        if plane is None:
            plane = _PLANES[pkey] = MeshStack(table)
    try:
        plane.admit(shard, service)
    except Exception as e:   # noqa: BLE001 — grouping is an optimization
        log.error("spmd: admit of %s shard [%d,%d) failed (%s); shard "
                  "stays classic", table, shard.lo, shard.hi, e)
        return None
    return plane


def release_service(service) -> None:
    """Evict the closing service's shards from their planes (they keep
    working standalone, e.g. for a final failover checkpoint) and drop
    the service from the routing registry. A plane left with no live
    member is dropped: its stack must not outlive the world it served."""
    unregister_service(service)
    key = getattr(service, "_proc_key", None)
    if key is None:
        return
    with _REG_LOCK:
        planes = [(kt, p) for kt, p in _PLANES.items() if kt[0] == key]
    for _kt, p in planes:
        p.release_owner(service)
    with _REG_LOCK:
        for kt, p in planes:
            with p.lock:
                dead = (not any(m is not None for m in p.members)
                        and not p._pending)
                if dead:
                    p.stack = None
                    p.ustate = None
            if dead and _PLANES.get(kt) is p:
                del _PLANES[kt]


class MeshStack:
    """One table's stacked shard group on one device (see the module
    docstring).

    ``members[slot]`` is the slot's RowShard (None = an evicted slot; its
    rows in the stack go stale and are never addressed again). The stack
    activates at the second admitted member: a lone shard stays classic,
    so a single-rank world never pays for the stacked layout."""

    def __init__(self, table: str):
        self.table = table
        self.device: Optional[torch.device] = None   # the members' device
        self.lock = threading.RLock()
        # serializes admit/evict/rebuild end to end (OUTERMOST, before any
        # member shard lock): two concurrent admits each capturing the
        # roster and committing a rebuild would otherwise overwrite each
        # other's member list, leaving a shard on a slot another owns
        self._admit_lock = threading.Lock()
        self.members: List[Any] = []      # slot -> shard (or None)
        self._owners: List[Any] = []      # slot -> owning service
        self._pending: List[Tuple[Any, Any]] = []   # before activation
        self.stack: Optional[torch.Tensor] = None   # (S, R_max, C)
        self.ustate: Optional[Dict[str, torch.Tensor]] = None
        self.epoch = 0
        self._row_axes: Dict[str, int] = {}   # per-shard row axis a leaf
        self._padded: Optional[Tuple[int, int]] = None
        self._dtype = None
        self._updater = None
        self._apply = None
        self._gather = spmd_apply.build_stacked_gather()
        self._slice = spmd_apply.build_slice()
        self._slot_applies: Dict[int, int] = {}
        self._dispatches = 0
        self._registered_mem = False

    # ------------------------------------------------------------------ #
    @property
    def active(self) -> bool:
        return self.stack is not None

    def slot_of(self, shard) -> Optional[int]:
        """The slot ``shard`` holds in the stack, or None (not a
        member)."""
        for i, m in enumerate(self.members):
            if m is shard:
                return i
        return None

    def admit(self, shard, service) -> None:
        """Admit one shard; activates (builds the stack) at 2+ live
        members. The shard must match the group (dtype, columns, updater
        type, device) and hold every updater-state leaf on the row axis;
        an incompatible shard raises and stays classic."""
        ustate = shard._ustate_raw if shard._plane is None else None
        if ustate is not None and any(shard._state_row_axis(v) < 0
                                      for v in ustate.values()):
            raise ValueError(f"{self.table}: a row-free updater-state "
                             "leaf cannot stack")
        with self._admit_lock:
            with self.lock:
                have = [s for s in self.members if s is not None]
                ref = have[0] if have else (self._pending[0][0]
                                            if self._pending else None)
                if ref is not None and (
                        shard.dtype != ref.dtype
                        or shard.num_col != ref.num_col
                        or type(shard.updater) is not type(ref.updater)
                        or shard.device != ref.device):
                    raise ValueError("incompatible shard for group "
                                     f"{self.table}")
                if any(s is shard for s in self.members) or any(
                        s is shard for s, _ in self._pending):
                    return
            # activation/growth rewrites member storage: every member
            # shard's lock (sorted), then the plane lock
            self._rebuild(extra=[(shard, service)])

    def release_owner(self, service) -> None:
        with self.lock:
            shards = [s for s, o in zip(self.members, self._owners)
                      if s is not None and o is service]
            self._pending = [(s, o) for s, o in self._pending
                             if o is not service]
        for s in shards:
            self.evict(s)

    # ------------------------------------------------------------------ #
    @staticmethod
    def _locked_members(shards):
        stack = contextlib.ExitStack()
        for s in sorted(shards, key=lambda x: (x.lo, id(x))):
            stack.enter_context(s._lock)
        return stack

    def _rebuild(self, extra: Sequence[Tuple[Any, Any]] = ()) -> None:
        """(Re)build the stack from the members' CURRENT state and the
        ``extra`` joiners, with every involved shard's lock held (applies
        quiesced), then the plane lock."""
        with self.lock:
            live = [(s, o) for s, o in zip(self.members, self._owners)
                    if s is not None]
            joiners = list(self._pending) + [
                (s, o) for s, o in extra
                if not any(s is m for m, _ in live)]
            roster = live + joiners
        if len(roster) < 2:
            with self.lock:
                self._pending = joiners
            return
        shards = [s for s, _ in roster]
        with self._locked_members(shards):
            with self.lock:
                s_count = len(shards)
                self.device = shards[0].device
                r_max = max(s._padded[0] for s in shards)
                cols = shards[0].num_col
                tdtype = shards[0].tdtype
                # raw storage: a grouped member's _data/_ustate properties
                # would route back here
                datas, states = [], []
                for s in shards:
                    if s._plane is None:
                        datas.append(s._data_raw)
                        states.append(s._ustate_raw)
                    else:
                        datas.append(self._slot_data(s))
                        states.append(self._slot_state(s))
                axes = {k: shards[0]._state_row_axis(v)
                        for k, v in states[0].items()}
                stack = torch.zeros((s_count, r_max, cols), dtype=tdtype,
                                    device=self.device)
                for i, d in enumerate(datas):
                    stack[i, : d.shape[0]].copy_(d)
                ustate: Dict[str, torch.Tensor] = {}
                for k, ax in axes.items():
                    leaf0 = states[0][k]
                    st = torch.zeros(
                        spmd_apply.stacked_shape(leaf0.shape, ax, s_count,
                                                 r_max),
                        dtype=leaf0.dtype, device=self.device)
                    for i, sd in enumerate(states):
                        leaf = sd[k]
                        st.select(ax, i).narrow(ax, 0, leaf.shape[ax]) \
                            .copy_(leaf)
                    ustate[k] = st
                self.stack = stack
                self.ustate = ustate
                self._row_axes = axes
                self._padded = (r_max, cols)
                self._dtype = shards[0].dtype
                self._updater = shards[0].updater
                self._apply = spmd_apply.build_stacked_apply(
                    self._updater, axes,
                    _LINEAR.get(type(self._updater)))
                self.epoch += 1
                self.members = list(shards)
                self._owners = [o for _, o in roster]
                self._pending = []
                state_nb = sum(v.numel() * v.element_size()
                               for v in ustate.values())
                for i, s in enumerate(shards):
                    # the group's padded shape: an evicted shard takes
                    # its slab back at this size
                    s._padded = (r_max, cols)
                    s._plane = self
                    s._plane_slot = i
                    s._view_cache = None
                    s._ustate_view_cache = None
                    s._data_raw = None
                    s._ustate_raw = None
                    # static ledger share: memory_stats must never
                    # materialize a view just to report bytes
                    s._mem_state_bytes = state_nb // s_count
                if not self._registered_mem:
                    self._registered_mem = True
                    _memstats.register(f"spmd[{self.table}]", self)
        log.debug("spmd: %s stacked %d shards on %s", self.table,
                  len(shards), self.device)

    # ------------------------------------------------------------------ #
    # per-shard materialized copies (classic read paths, checkpoints)
    # ------------------------------------------------------------------ #
    def _slot_data(self, shard) -> torch.Tensor:
        """Caller holds the plane lock: a copy of the shard's slab."""
        return self._slice(self.stack, shard._plane_slot)

    def _slot_state(self, shard) -> Dict[str, torch.Tensor]:
        return {k: self._slice(v, shard._plane_slot, self._row_axes[k])
                for k, v in self.ustate.items()}

    def view(self, shard) -> torch.Tensor:
        """The shard's slab as a tensor of its own, cached per plane epoch
        (any apply invalidates it). A pinned older copy stays as it was:
        no apply writes it."""
        with self.lock:
            if (shard._view_cache is not None
                    and shard._view_epoch == self.epoch):
                return shard._view_cache
            v = self._slot_data(shard)
            shard._view_cache = v
            shard._view_epoch = self.epoch
            return v

    def ustate_view(self, shard) -> Dict[str, torch.Tensor]:
        with self.lock:
            cached = shard._ustate_view_cache
            if cached is not None:
                return cached
            v = self._slot_state(shard)
            shard._ustate_view_cache = v
            return v

    def evict(self, shard) -> None:
        """Copy the shard back to classic per-shard storage (the
        always-safe fallback for exotic mutations and teardown). The
        slot's rows in the stack go stale and are never addressed again.
        ``_admit_lock`` first: an eviction racing a concurrent admit's
        rebuild could otherwise be re-admitted from its stale roster."""
        with self._admit_lock, shard._lock:
            with self.lock:
                if shard._plane is not self:
                    return
                slot = shard._plane_slot
                shard._data_raw = self._slot_data(shard)
                shard._ustate_raw = self._slot_state(shard)
                shard._plane = None
                shard._plane_slot = None
                shard._view_cache = None
                shard._ustate_view_cache = None
                self.members[slot] = None
        log.debug("spmd: %s slot %d evicted to classic storage",
                  self.table, slot)

    # ------------------------------------------------------------------ #
    # the grouped dispatch paths
    # ------------------------------------------------------------------ #
    def apply_rows(self, shard, local: np.ndarray, vals: np.ndarray,
                   opt) -> bool:
        """One shard's apply through the stack (the classic
        ``_apply_rows`` of a grouped shard redirects here; the caller
        holds the shard's lock, and the plane lock nests inside). False
        when the shard is no longer in this plane."""
        return not self.apply_grouped([(shard, local, vals, opt)])

    def apply_grouped(self, entries: Sequence[Tuple[Any, np.ndarray,
                                                    np.ndarray, Any]]
                      ) -> List[Tuple[Any, np.ndarray, np.ndarray, Any]]:
        """Apply one wave ROUND — at most one ``(shard, local ids, vals,
        opt)`` per member, ids unique within an entry — with one updater
        call per distinct ``AddOption`` (one in all for an opt-insensitive
        updater), each over the flattened stack. Shards without work are
        not touched. A malformed entry raises before anything applies.
        Returns the entries whose shard left this plane (evicted since the
        caller grouped them): none of them applied, and the caller applies
        them through the shard's classic path."""
        t0 = time.perf_counter()
        strays = []
        with self.lock:
            by_slot: Dict[int, Tuple[Any, np.ndarray, np.ndarray,
                                     AddOption]] = {}
            cols = self._padded[1] if self._padded else 0
            for shard, local, vals, opt in entries:
                if shard._plane is not self:
                    strays.append((shard, local, vals, opt))
                    continue
                slot = shard._plane_slot
                if slot in by_slot:
                    raise RuntimeError(
                        f"{self.table}: two waves for slot {slot} in one "
                        "round")
                local = np.asarray(local, np.int64).reshape(-1)
                vals = np.asarray(vals, self._dtype)
                if vals.shape != (local.size, cols):
                    raise ValueError(
                        f"{self.table}: slot {slot} got values "
                        f"{vals.shape} for {local.size} ids")
                if local.size and (local.min() < 0
                                   or local.max() >= shard.n):
                    raise IndexError(f"{self.table}: slot {slot} ids "
                                     f"outside [0, {shard.n})")
                by_slot[slot] = (shard, local, vals,
                                 opt if opt is not None else AddOption())
            if not by_slot:
                return strays
            merge_all = type(self._updater) in _OPT_INSENSITIVE
            parts: Dict[Any, List[int]] = {}
            for slot in sorted(by_slot):
                parts.setdefault(None if merge_all else by_slot[slot][3],
                                 []).append(slot)
            r_max = self._padded[0]
            for slots in parts.values():
                flat = np.concatenate([slot * r_max + by_slot[slot][1]
                                       for slot in slots])
                vals = np.concatenate([by_slot[slot][2] for slot in slots])
                self._apply(
                    self.stack, self.ustate,
                    spmd_apply.to_device_ids(flat, self.device),
                    torch.from_numpy(np.ascontiguousarray(vals))
                    .to(self.device),
                    by_slot[slots[0]][3])
                self._dispatches += 1
            self.epoch += 1
            nbytes = 0
            for slot, (shard, _local, vals, _o) in by_slot.items():
                shard._version += 1
                shard._view_cache = None
                shard._ustate_view_cache = None
                self._slot_applies[slot] = \
                    self._slot_applies.get(slot, 0) + 1
                nbytes += vals.nbytes
        ms = (time.perf_counter() - t0) * 1e3
        for shard, _l, _v, _o in by_slot.values():
            Dashboard.get(shard._mon_apply).observe_ms(ms)
            if shard.service is not None:
                shard.service.beat("apply")
        _flight.record(_flight.EV_APPLY, nbytes=nbytes,
                       note=f"spmd ops={len(by_slot)}")
        return strays

    def gather_grouped(self, pairs: Sequence[Tuple[Any, np.ndarray]]
                       ) -> List[Optional[np.ndarray]]:
        """Serve every ``(shard, local ids)`` pair's gather in ONE
        ``index_select`` over the flattened stack; returns the per-pair
        OWNED host row blocks in input order (None for a pair whose shard
        left this plane: the caller serves it classically). Ids are
        shard-local and validated by the caller. The gather is issued
        under the plane lock, so it sees each grouped apply wholly or not
        at all; the copy to the host runs after the lock is released."""
        order: List[Tuple[int, int]] = []   # (pair index, rows)
        with self.lock:
            r_max = self._padded[0] if self._padded else 0
            flat = []
            seen = set()
            for i, (shard, local) in enumerate(pairs):
                if shard._plane is not self:
                    continue
                slot = shard._plane_slot
                if slot in seen:
                    raise RuntimeError(
                        f"{self.table}: duplicate gather slot {slot}")
                seen.add(slot)
                local = np.asarray(local, np.int64).reshape(-1)
                flat.append(slot * r_max + local)
                order.append((i, local.size))
            if flat:
                rows_t = self._gather(
                    self.stack, spmd_apply.to_device_ids(
                        np.concatenate(flat), self.device))
        out: List[Optional[np.ndarray]] = [None] * len(pairs)
        if not order:
            return out
        rows = rows_t.cpu().numpy()
        a = 0
        for i, n in order:
            out[i] = rows[a: a + n]
            a += n
        return out

    # ------------------------------------------------------------------ #
    # observability
    # ------------------------------------------------------------------ #
    def stats_for(self, shard) -> Optional[Dict[str, Any]]:
        """The shard's slice of the plane for ``stats()['spmd']``:
        placement (slot -> device) and its share of grouped applies —
        what mvtop's placement panel renders."""
        with self.lock:
            if shard._plane is not self:
                return None
            slot = shard._plane_slot
            total = sum(self._slot_applies.values()) or 0
            mine = self._slot_applies.get(slot, 0)
            stack = self.stack
            return {
                "group": self.table,
                "slot": slot,
                "members": sum(1 for m in self.members if m is not None),
                "device": str(self.device),
                "applies": mine,
                "apply_share": (round(mine / total, 4) if total else 0.0),
                "dispatches": self._dispatches,
                "stack_bytes": (int(stack.numel() * stack.element_size())
                                if stack is not None else 0),
            }

    def memory_stats(self) -> Dict[str, Any]:
        """Byte-ledger gauges of the pooled storage (the per-shard gauges
        report their slab SHARE; this is the stack itself, including the
        rows kept by evicted slots)."""
        with self.lock:
            stack, ustate = self.stack, self.ustate or {}
            stack_nb = (stack.numel() * stack.element_size()
                        if stack is not None else 0)
            state_nb = sum(v.numel() * v.element_size()
                           for v in ustate.values())
            live = sum(1 for m in self.members if m is not None)
            return {"stack_bytes": int(stack_nb),
                    "ustate_bytes": int(state_nb),
                    "slots": len(self.members),
                    "live_slots": live,
                    "dispatches": self._dispatches}
