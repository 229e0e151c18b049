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
from typing import Any, Dict, List, Optional

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
define_string("log_level", "info", "debug|info|error|fatal")
define_string("log_file", "", "optional log file path ('' = stdout only)")
define_bool("log_jsonl", False,
            "write the log FILE as structured JSONL (ts/mono/level/rank/"
            "name/msg); console output stays text")
define_bool("dashboard", True, "collect Monitor timings and display at shutdown")
define_string("device", "",
              "torch device the tables and models live on: '' = cuda "
              "(the card), or an explicit device such as 'cpu' or 'cuda:1'")
define_string("ps_role", "default",
              "role of this process: none|worker|server|default")
# The async PS plane's client windows (ps/tables.py), off by default as
# in the JAX package; its replay plane and per-tenant add budgets exist
# with the JAX package's names and defaults, and an async table refuses
# them when set (ROADMAP.md §A).
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
define_float("tenant_add_qps", 0.0,
             "per-(table, tenant) client-side add budget (qps) at the send "
             "window; 0 disables the bucket (the only value the port "
             "takes)")
define_bool("ps_replay", False,
            "stamp windowed async-table frames with (client, seq) and "
            "replay the non-durable tail to a restarted shard")
define_int("get_chunk_rows", 0,
           "chunk-stream async get replies above this many rows: the "
           "owner ships self-describing sub-frames instead of one frame, "
           "so the client's decode and scatter overlap the receive. "
           "0 disables")
