"""Typed flag registry (port of ``multiverso_tpu/utils/config.py``).

``define_*`` registers a typed flag with a default and help string,
``parse_cmd_flags`` consumes ``-key=value`` argv entries (compacting argv,
as the reference Multiverso does), and ``set_flag`` is the programmatic
override used by ``api.init``. Types: bool, int, float, str.

Only the flags the port reads are defined here; the rest of the JAX
package's inventory arrives with the modules that read them.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

_TRUE_STRINGS = frozenset({"true", "1", "yes", "on"})
_FALSE_STRINGS = frozenset({"false", "0", "no", "off"})


@dataclass
class _Flag:
    name: str
    value: Any
    default: Any
    type: type
    help: str


_registry: Dict[str, _Flag] = {}
_lock = threading.RLock()


class FlagError(KeyError):
    """Raised for unknown flags or bad flag values."""


def _define(name: str, default: Any, ftype: type, help: str) -> None:
    with _lock:
        if name in _registry and _registry[name].type is not ftype:
            raise FlagError(
                f"flag {name!r} redefined with different type "
                f"({_registry[name].type.__name__} -> {ftype.__name__})"
            )
        _registry[name] = _Flag(name, default, default, ftype, help)


def define_bool(name: str, default: bool, help: str = "") -> None:
    _define(name, bool(default), bool, help)


def define_int(name: str, default: int, help: str = "") -> None:
    _define(name, int(default), int, help)


def define_float(name: str, default: float, help: str = "") -> None:
    _define(name, float(default), float, help)


def define_string(name: str, default: str, help: str = "") -> None:
    _define(name, str(default), str, help)


def _coerce(flag: _Flag, value: Any) -> Any:
    if flag.type is bool:
        if isinstance(value, bool):
            return value
        s = str(value).strip().lower()
        if s in _TRUE_STRINGS:
            return True
        if s in _FALSE_STRINGS:
            return False
        raise FlagError(f"bad boolean value {value!r} for flag {flag.name!r}")
    try:
        return flag.type(value)
    except (TypeError, ValueError) as e:
        raise FlagError(
            f"bad {flag.type.__name__} value {value!r} for flag {flag.name!r}"
        ) from e


def get_flag(name: str) -> Any:
    with _lock:
        try:
            return _registry[name].value
        except KeyError:
            raise FlagError(f"unknown flag {name!r}") from None


def reader(name: str) -> Callable[[], Any]:
    """A reader of one flag's current value that takes no lock, for
    per-op hot paths: a dict lookup and an attribute read, each atomic
    under the interpreter lock, see every ``set_flag``, ``reset_flags``
    and redefinition at the next call."""
    get_flag(name)   # unknown names fail here, not on the hot path
    return lambda: _registry[name].value


def set_flag(name: str, value: Any) -> None:
    """Programmatic override (ref SetCMDFlag)."""
    with _lock:
        try:
            flag = _registry[name]
        except KeyError:
            raise FlagError(f"unknown flag {name!r}") from None
        flag.value = _coerce(flag, value)


def has_flag(name: str) -> bool:
    with _lock:
        return name in _registry


def reset_flags() -> None:
    """Reset every flag to its default (test isolation helper)."""
    with _lock:
        for flag in _registry.values():
            flag.value = flag.default


def flags() -> Dict[str, Any]:
    """Snapshot of the current flag values."""
    with _lock:
        return {name: f.value for name, f in _registry.items()}


def parse_cmd_flags(argv: Optional[List[str]] = None) -> List[str]:
    """Consume ``-key=value`` entries from ``argv``; return the remainder.

    Recognized flags are removed, everything else is kept in order.
    Unknown ``-key=value`` entries are kept (the reference warns and keeps
    them too).
    """
    if argv is None:
        return []
    remainder: List[str] = []
    for arg in argv:
        matched = False
        if arg.startswith("-") and "=" in arg:
            body = arg.lstrip("-")
            key, _, value = body.partition("=")
            with _lock:
                if key in _registry:
                    flag = _registry[key]
                    flag.value = _coerce(flag, value)
                    matched = True
        if not matched:
            remainder.append(arg)
    return remainder


def consume_runtime_flags(argv: Optional[List[str]]) -> List[str]:
    """App-CLI preamble: ``-key=value`` entries are runtime flags, parsed
    into the registry (an unknown one is logged and dropped, as the
    reference warns and keeps going); everything else (the app's own
    ``-key value`` pairs and positionals) is returned in order."""
    argv = list(argv or [])
    flags = [a for a in argv if a.startswith("-") and "=" in a]
    rest = [a for a in argv if not (a.startswith("-") and "=" in a)]
    for a in parse_cmd_flags(flags):
        from multiverso_tpu_torch.utils import log   # lazy: log reads flags
        log.error("unknown runtime flag %s (ignored; app keys use "
                  "'-key value' form)", a)
    return rest


def parse_config_file(path: str) -> Dict[str, str]:
    """Parse a ``key=value`` config file (LR-app style, ref configure.cpp).

    Lines starting with ``#`` and blank lines are skipped. Known flags are
    set; all pairs are returned for the app to read.
    """
    out: Dict[str, str] = {}
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            key, _, value = line.partition("=")
            key, value = key.strip(), value.strip()
            if not key:
                continue
            out[key] = value
            with _lock:
                if key in _registry:
                    flag = _registry[key]
                    flag.value = _coerce(flag, value)
    return out


# ---------------------------------------------------------------------------
# Flags read by this package (names, types and defaults as in the JAX
# package, plus ``device``).
# ---------------------------------------------------------------------------
define_string("updater_type", "default", "server-side updater: "
              "default|sgd|momentum_sgd|adagrad|adam|ftrl")
define_int("num_workers", 0, "logical workers; 0 = one per process")
define_int("num_servers", 0, "logical server shards; 0 = one per process "
           "(the device its tables live on)")
define_float("net_timeout_s", 600.0,
             "seconds a multi-process world's store connect and each of "
             "its collectives wait before they fail (net_init, and a "
             "launcher's world joined by init())")
define_string("log_level", "info", "debug|info|error|fatal")
define_string("log_file", "", "optional log file path ('' = stdout only)")
define_bool("log_jsonl", False,
            "write the log FILE as structured JSONL (ts/mono/level/rank/"
            "name/msg); console output stays text")
define_bool("dashboard", True, "collect Monitor timings and display at shutdown")
# The reference's command-line flags (names, types and defaults as in the
# JAX package): a reference command line sets them, and this package takes
# them. ``ma`` and ``sync`` are recorded for the code that reads them (the
# harness's allreduce entry sets ``ma``); the others change nothing here.
define_bool("ma", False, "model-average (allreduce) mode: no parameter "
            "tables; recorded for the code that reads it (the harness's "
            "allreduce entry sets it around MV_Aggregate)")
define_bool("sync", False, "BSP semantics (reference SyncServer); "
            "recorded only: every collective add already keeps the "
            "processes in step, and the async plane (ps/) is the "
            "uncoordinated mode")
define_float("backup_worker_ratio", 0.0, "no-op: the reference declared "
             "it and never read it; stragglers are elastic.stragglers()'s "
             "step lag")
define_int("omp_threads", 4, "no-op: shard updates are torch ops on the "
           "table's device (reference OpenMP server loop); torch's CPU "
           "threads follow torch.set_num_threads")
define_string("allocator_type", "smart", "no-op: device memory is the "
              "PyTorch caching allocator's (reference SmartAllocator)")
define_int("allocator_alignment", 16, "no-op: the PyTorch caching "
           "allocator controls buffer alignment")
define_string("machine_file", "", "no-op: a world's ranks meet through "
              "the TCPStore of net_init or a launcher's environment "
              "(reference ZMQ membership file)")
define_int("port", 55555, "no-op: see machine_file; the store's port "
           "comes from net_init(coordinator_address) or MASTER_PORT")
define_string("device", "",
              "torch device the tables and models live on: '' = cuda "
              "(the card), or an explicit device such as 'cpu' or 'cuda:1'")
define_string("mesh_axis", "mv", "name of the table-sharding mesh axis")
define_string("ps_role", "default",
              "role of this process: none|worker|server|default")
# The async PS plane's client windows (ps/tables.py), off by default as
# in the JAX package (the per-tenant add budget, tenant_add_qps, lives
# with the other tenant flags in telemetry/tenants.py).
define_float("batch_window_ms", 0.0,
             "send-window age bound in ms for async add_rows batching; "
             "0 disables the window (every add ships immediately). "
             "1-2 ms suits ~1-row adds")
define_int("batch_window_bytes", 1 << 20,
           "flush an owner's send window early once its pending add "
           "payloads reach this many bytes")
define_int("batch_window_ops", 64,
           "flush an owner's send window early once this many logical "
           "adds are queued for it")
define_float("get_window_ms", 0.0,
             "enable the client get coalescer for async tables: > 0 "
             "turns on single-flight per-owner fetches — a get to an "
             "idle owner dispatches immediately; gets arriving while that "
             "owner's fetch is outstanding merge into one follow-up frame, "
             "dispatched when the reply lands or after this many ms. 0 "
             "disables (every get is its own frame). Per-table override: "
             "get_window_ms= on the table")
# Exactly-once replay (ps/tables._SendWindow, ps/shard's sequence
# channels): windowed frames carry a per-(client, table) sequence, the
# owning shard dedupes them, and the client retains each frame past its
# ack until the shard reports it durable (checkpointed); on a shard
# death the retained tail re-flushes to the restored incarnation.
define_bool("ps_replay", False,
            "stamp windowed async-table frames with (client, seq), "
            "retain them until the owning shard reports them durable, "
            "and replay the unacked/non-durable tail to a restarted "
            "shard incarnation (dedup by per-client high-water mark on "
            "the shard). Requires a send window (batch_window_ms / "
            "send_window_ms=); the failover checkpointer advances the "
            "durable mark")
define_float("ps_replay_timeout", 120.0,
             "seconds a replayed frame keeps retrying against a dead "
             "owner before its futures fail with PSPeerError (bounds "
             "how long a failover may take before clients give up)")
define_float("ps_replay_backoff", 0.5,
             "BASE seconds between replay attempts against an owner "
             "that is still unreachable; each failed attempt within an "
             "episode doubles the delay (jittered) up to "
             "ps_replay_backoff_cap (utils/retry.py)")
define_float("ps_replay_backoff_cap", 4.0,
             "cap seconds for the replay plane's exponential backoff: "
             "a long owner respawn decays to this poll rate instead "
             "of hammering the restarting rank at the base rate")
define_int("ps_replay_max_frames", 4096,
           "retained-frame cap per owner: past it the oldest ACKED "
           "frames are dropped (with a warning) — durability degrades "
           "to ack-time instead of checkpoint-time rather than memory "
           "growing without bound when no checkpointer is advancing "
           "the durable mark")
# Shard failover (ps/failover.py, checkpoint.py's per-shard half).
define_float("failover_timeout", 10.0,
             "seconds of beacon staleness before the failover "
             "supervisor treats a rank as dead (tombstoned PS deaths "
             "short-circuit this)")
define_float("failover_poll_s", 0.5,
             "failover supervisor poll interval seconds")
define_float("failover_ckpt_interval_s", 0.0,
             "per-shard incremental checkpoint cadence seconds; > 0 "
             "(with failover_dir set) starts a ShardCheckpointer with "
             "each PSService — the durable half of exactly-once "
             "replay. 0 = off")
define_string("failover_dir", "",
              "directory for per-shard failover checkpoints (local/NFS; "
              "shard-r<rank>/v<N> tags inside)")
define_int("failover_ckpt_keep", 2,
           "committed per-shard checkpoint tags kept per rank")
define_int("ps_generation", 0,
           "this process's shard incarnation generation; the failover "
           "supervisor spawns each replacement at the previous "
           "generation + 1, and MSG_HEALTH echoes it")
# The fault-injection wire plane (ps/faults.py).
define_string("faults_spec", "",
              "chaos scenario spec for the fault-injection wire plane "
              "(ps/faults.py): a JSON file path, or inline JSON when it "
              "starts with '{'. Empty = plane disarmed (the null object; "
              "no injection code path reachable)")
define_int("faults_seed", 0,
           "seed for the fault plane's deterministic decision streams: "
           "the same seed + spec + per-(src,dst) message sequence "
           "injects the identical fault sequence (a spec's own \"seed\" "
           "key wins over this flag)")
define_int("get_chunk_rows", 0,
           "chunk-stream async get replies above this many rows: the "
           "owner ships self-describing sub-frames instead of one frame, "
           "so the client's decode and scatter overlap the receive. "
           "0 disables")
