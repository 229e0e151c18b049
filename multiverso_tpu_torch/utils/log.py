"""Leveled logger + CHECK assertions (port of ``multiverso_tpu/utils/log.py``).

Timestamped leveled messages (DEBUG/INFO/ERROR/FATAL) to stdout and an
optional file, a ``kill_fatal`` toggle deciding whether FATAL raises, and
``check`` / ``check_notnull`` assertion helpers. ``reset_log_file(path,
jsonl=True)`` makes the file sink structured: one JSON object per line.
The flight-recorder dump on FATAL arrives with the telemetry slice.
"""

from __future__ import annotations

import datetime
import enum
import json
import sys
import threading
import time
from typing import Any, IO, Optional

from multiverso_tpu_torch.utils import config


class LogLevel(enum.IntEnum):
    DEBUG = 0
    INFO = 1
    ERROR = 2
    FATAL = 3


_LEVEL_NAMES = {
    LogLevel.DEBUG: "DEBUG",
    LogLevel.INFO: "INFO",
    LogLevel.ERROR: "ERROR",
    LogLevel.FATAL: "FATAL",
}

_LEVEL_FROM_STRING = {name.lower(): lvl for lvl, name in _LEVEL_NAMES.items()}


class FatalError(RuntimeError):
    """Raised on FATAL logs / failed CHECKs when kill-on-fatal is enabled."""


class Logger:
    """Instance logger. Module-level helpers use a default one."""

    def __init__(self, level: LogLevel = LogLevel.INFO,
                 file: Optional[IO[str]] = None,
                 name: str = "multiverso_tpu_torch",
                 kill_fatal: bool = True):
        self.level = level
        self.name = name
        self.kill_fatal = kill_fatal
        self.rank = 0
        self._file = file
        self._jsonl = False
        self._lock = threading.Lock()

    def reset_log_file(self, path: str, jsonl: bool = False) -> None:
        """Point the file sink at ``path`` (empty = none); ``jsonl=True``
        writes one JSON object per line to the file."""
        with self._lock:
            if self._file is not None:
                self._file.close()
            self._file = open(path, "a") if path else None
            self._jsonl = bool(jsonl)

    def write(self, level: LogLevel, msg: str, *args: Any) -> None:
        if level < self.level:
            return
        if args:
            msg = msg % args
        ts = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S.%f")[:-3]
        line = f"[{_LEVEL_NAMES[level]}] [{ts}] [{self.name}] {msg}"
        with self._lock:
            print(line, file=sys.stderr if level >= LogLevel.ERROR else sys.stdout)
            if self._file is not None:
                if self._jsonl:
                    self._file.write(json.dumps({
                        "ts": round(time.time(), 6),
                        "mono": round(time.monotonic(), 6),
                        "level": _LEVEL_NAMES[level], "rank": self.rank,
                        "name": self.name, "msg": msg}) + "\n")
                else:
                    self._file.write(line + "\n")
                self._file.flush()
        if level == LogLevel.FATAL and self.kill_fatal:
            raise FatalError(msg)

    def debug(self, msg: str, *args: Any) -> None:
        self.write(LogLevel.DEBUG, msg, *args)

    def info(self, msg: str, *args: Any) -> None:
        self.write(LogLevel.INFO, msg, *args)

    def error(self, msg: str, *args: Any) -> None:
        self.write(LogLevel.ERROR, msg, *args)

    def fatal(self, msg: str, *args: Any) -> None:
        self.write(LogLevel.FATAL, msg, *args)


_default = Logger()


def configure_from_flags() -> None:
    """Apply the log_level / log_file / log_jsonl flags to the default
    logger."""
    level = _LEVEL_FROM_STRING.get(config.get_flag("log_level").lower())
    if level is not None:
        _default.level = level
    path = config.get_flag("log_file")
    if path:
        _default.reset_log_file(path, jsonl=config.get_flag("log_jsonl"))


def set_level(level: LogLevel) -> None:
    _default.level = level


def debug(msg: str, *args: Any) -> None:
    _default.debug(msg, *args)


def info(msg: str, *args: Any) -> None:
    _default.info(msg, *args)


def error(msg: str, *args: Any) -> None:
    _default.error(msg, *args)


def fatal(msg: str, *args: Any) -> None:
    _default.fatal(msg, *args)


def check(condition: Any, msg: str = "CHECK failed") -> None:
    """ref log.h CHECK macro: fatal-log on false condition."""
    if not condition:
        _default.fatal(msg)


def check_notnull(value: Any, name: str = "value") -> Any:
    """ref log.h CHECK_NOTNULL: returns the value for chaining."""
    if value is None:
        _default.fatal(f"CHECK_NOTNULL failed: {name} is None")
    return value
