"""Shared retry policy: capped exponential backoff + jitter + deadlines
(port of ``multiverso_tpu/utils/retry.py``; numpy-free, the same
schedule).

* **capped exponential**: attempt ``k`` waits ``base * factor**k``,
  capped at ``cap`` — early retries are cheap, a long outage decays to
  a bounded poll rate instead of hammering the respawning owner;
* **jitter**: each delay is scaled by a uniform factor in
  ``[1 - jitter, 1 + jitter]`` so a fleet of clients re-arming off the
  same death event spreads out (deterministic when a ``seed`` is given);
* **deadline propagation**: every sleep is clamped to the remaining
  deadline and :meth:`Backoff.sleep` returns False once it is
  exhausted, so a caller's total budget means the total — including
  the waits — not per-attempt.

Used by ``ps/service._Peer`` connect retries and the one-shot probe
retries (``ps_probe_attempts``).
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple

DEFAULT_BASE_S = 0.05
DEFAULT_CAP_S = 2.0
DEFAULT_FACTOR = 2.0
DEFAULT_JITTER = 0.25


class Backoff:
    """One retry schedule. Stateless per attempt — callers pass the
    attempt index, so several frames/owners can share one policy
    object while each tracks its own episode."""

    def __init__(self, base_s: float = DEFAULT_BASE_S,
                 cap_s: float = DEFAULT_CAP_S,
                 factor: float = DEFAULT_FACTOR,
                 jitter: float = DEFAULT_JITTER,
                 seed: Optional[int] = None):
        self.base_s = max(float(base_s), 0.0)
        self.cap_s = max(float(cap_s), self.base_s)
        self.factor = max(float(factor), 1.0)
        self.jitter = min(max(float(jitter), 0.0), 1.0)
        # a seeded stream makes the schedule reproducible (chaos runs);
        # the default shares the process-global RNG — jitter quality
        # matters, sequence identity does not
        self._rng = random.Random(seed) if seed is not None else random

    def delay_s(self, attempt: int,
                deadline: Optional[float] = None) -> float:
        """Delay before retry number ``attempt`` (0-based), jittered,
        capped, and clamped to the remaining ``deadline``
        (``time.monotonic()`` timestamp). Returns 0.0 when the deadline
        has passed — the caller's loop should treat that together with
        :meth:`expired`."""
        d = min(self.base_s * (self.factor ** max(int(attempt), 0)),
                self.cap_s)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        if deadline is not None:
            d = min(d, max(deadline - time.monotonic(), 0.0))
        return d

    @staticmethod
    def expired(deadline: Optional[float]) -> bool:
        return deadline is not None and time.monotonic() >= deadline

    def sleep(self, attempt: int,
              deadline: Optional[float] = None) -> bool:
        """Sleep the attempt's delay; False when the deadline is
        already exhausted (nothing slept) — the retry loop's stop
        signal."""
        if self.expired(deadline):
            return False
        time.sleep(self.delay_s(attempt, deadline))
        return True


def deadline_in(seconds: Optional[float]) -> Optional[float]:
    """Monotonic deadline ``seconds`` from now (None = unbounded) —
    the propagation unit every retrying call passes down."""
    return None if seconds is None else time.monotonic() + float(seconds)


def remaining_s(deadline: Optional[float],
                default: float = 0.0) -> float:
    """Seconds left until ``deadline`` (never negative); ``default``
    when unbounded — lets a per-attempt socket timeout inherit the
    caller's overall budget."""
    if deadline is None:
        return default
    return max(deadline - time.monotonic(), 0.0)


def call_with_retries(fn: Callable, *, attempts: int,
                      deadline: Optional[float] = None,
                      retry_on: Tuple = (OSError, TimeoutError),
                      backoff: Optional[Backoff] = None,
                      on_retry: Optional[Callable] = None):
    """Run ``fn()`` up to ``attempts`` times, sleeping the shared
    backoff between failures, never past ``deadline``. The LAST error
    re-raises unchanged (callers wrap in their own typed errors);
    ``on_retry(attempt, exc)`` observes each retry (telemetry)."""
    backoff = backoff or Backoff()
    attempts = max(int(attempts), 1)
    last: Optional[BaseException] = None
    for k in range(attempts):
        try:
            return fn()
        except retry_on as e:   # noqa: PERF203 — retry loop
            last = e
            if k + 1 >= attempts or not backoff.sleep(k, deadline):
                raise
            if on_retry is not None:
                try:
                    on_retry(k, e)
                except Exception:   # noqa: BLE001 — telemetry only
                    pass
    raise last  # pragma: no cover — unreachable (loop raises)
