"""Timer (port of ``multiverso_tpu/utils/timer.py``; ref:
include/multiverso/util/timer.h:9, src/timer.cpp)."""

from __future__ import annotations

import time


class Timer:
    """Monotonic stopwatch; elapsed time in milliseconds like the reference."""

    def __init__(self) -> None:
        self._start = time.perf_counter()

    def start(self) -> None:
        self._start = time.perf_counter()

    def elapse(self) -> float:
        """Milliseconds since the last start()."""
        return (time.perf_counter() - self._start) * 1e3
