"""Fixed-bucket log-scale latency histogram (port of the part of
``multiverso_tpu/telemetry/histogram.py`` that ``Dashboard`` uses).

Bucket boundaries are powers of ``2**(1/LOG2_SUB)`` over [2**-14, 2**22)
ms; out-of-range samples clamp into the edge buckets. Quantiles are
interpolated inside the covering bucket and clamped to the exact observed
min/max. Not thread-safe on its own: the owning Monitor holds the lock.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

LOG2_SUB = 4
_MIN_EXP = -14
_MAX_EXP = 22
NBUCKETS = (_MAX_EXP - _MIN_EXP) * LOG2_SUB
# bucket i covers [2**(_MIN_EXP + i/SUB), 2**(_MIN_EXP + (i+1)/SUB)) ms
BOUNDS: Tuple[float, ...] = tuple(
    2.0 ** (_MIN_EXP + (i + 1) / LOG2_SUB) for i in range(NBUCKETS))


def bucket_index(ms: float) -> int:
    """Bucket of a sample, clamped into [0, NBUCKETS-1]; samples <= 0
    land in bucket 0."""
    if ms <= 0.0:
        return 0
    i = int((math.log2(ms) - _MIN_EXP) * LOG2_SUB)
    if i < 0:
        return 0
    if i >= NBUCKETS:
        return NBUCKETS - 1
    return i


class Histogram:
    """Log2-bucket histogram; the caller synchronizes."""

    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self) -> None:
        self.counts: List[int] = [0] * NBUCKETS
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0

    def observe(self, ms: float) -> None:
        self.counts[bucket_index(ms)] += 1
        self.count += 1
        self.sum += ms
        if ms < self.min:
            self.min = ms
        if ms > self.max:
            self.max = ms

    def percentile(self, q: float) -> float:
        """Quantile estimate (``q`` in [0, 100])."""
        if self.count == 0:
            return 0.0
        if q <= 0:
            return self.min
        if q >= 100:
            return self.max
        target = self.count * q / 100.0
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = BOUNDS[i] / (2.0 ** (1.0 / LOG2_SUB))
                hi = BOUNDS[i]
                frac = (target - cum) / c
                est = lo + (hi - lo) * frac
                return min(max(est, self.min), self.max)
            cum += c
        return self.max

    def percentiles(self, qs: Sequence[float] = (50, 90, 99)
                    ) -> Tuple[float, ...]:
        return tuple(self.percentile(q) for q in qs)
