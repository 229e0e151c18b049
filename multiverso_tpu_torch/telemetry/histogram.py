"""Fixed-bucket log-scale histogram for latency (and other positive)
samples (port of ``multiverso_tpu/telemetry/histogram.py``: the same
buckets, so histograms of either package merge exactly).

Design constraints, in order:

1. ``observe`` must stay cheap enough for the PS hot path (a windowed
   1-row ``add_rows_async`` completes in ~30 us; the whole Monitor
   update budget is well under a microsecond): one ``math.log2``, one
   list increment, no allocation. The histogram itself takes NO lock —
   the embedding :class:`~multiverso_tpu_torch.utils.dashboard.Monitor`
   already holds one for its count/sum fields and the histogram update
   rides inside that same critical section.
2. Fixed memory: bucket boundaries are powers of ``2**(1/LOG2_SUB)``
   over a hard-coded range, so every histogram is one flat int list and
   two histograms (e.g. a remote shard's and a local one) merge by
   elementwise addition — no rebucketing, ever.
3. Quantiles reconstruct from buckets with bounded relative error
   (one bucket width, ~19% at ``LOG2_SUB=4``), tightened at the edges
   by the tracked exact min/max.

The range [2**-14, 2**22) ms spans ~61 ns to ~70 min — below the
cheapest monitored op and above any sane request timeout; out-of-range
samples clamp into the edge buckets (their mass is never lost, only
their resolution).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

# sub-buckets per octave (power of two): 4 -> bucket ratio 2**0.25 ~ 1.19
LOG2_SUB = 4
_MIN_EXP = -14          # lowest bucket lower bound: 2**-14 ms (~61 ns)
_MAX_EXP = 22           # highest bucket upper bound: 2**22 ms (~70 min)
NBUCKETS = (_MAX_EXP - _MIN_EXP) * LOG2_SUB
# bucket i covers [2**(_MIN_EXP + i/SUB), 2**(_MIN_EXP + (i+1)/SUB)) ms
BOUNDS: Tuple[float, ...] = tuple(
    2.0 ** (_MIN_EXP + (i + 1) / LOG2_SUB) for i in range(NBUCKETS))


def bucket_index(ms: float) -> int:
    """Bucket index of a sample (clamped into [0, NBUCKETS-1); <= 0
    samples land in bucket 0 — a zero-duration observe must count, not
    raise on log2)."""
    if ms <= 0.0:
        return 0
    i = int((math.log2(ms) - _MIN_EXP) * LOG2_SUB)
    if i < 0:
        return 0
    if i >= NBUCKETS:
        return NBUCKETS - 1
    return i


class Histogram:
    """Log2-bucket histogram. NOT thread-safe on its own: the caller
    (Monitor) synchronizes; snapshots are taken under that same lock."""

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

    def merge(self, other: "Histogram") -> None:
        """Elementwise merge (cross-shard / cross-rank aggregation);
        identical fixed buckets make this exact."""
        for i, c in enumerate(other.counts):
            if c:
                self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        if other.min < self.min:
            self.min = other.min
        if other.max > self.max:
            self.max = other.max

    # ------------------------------------------------------------------ #
    def percentile(self, q: float) -> float:
        """Quantile estimate (``q`` in [0, 100]) by linear interpolation
        inside the covering bucket, clamped to the exact observed
        min/max so p0/p100 are never a bucket-width off."""
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

    # ------------------------------------------------------------------ #
    def nonzero(self) -> List[Tuple[float, int]]:
        """Sparse view: (bucket upper bound ms, count) for occupied
        buckets — the export/merge wire format (a full 144-bucket dump
        per monitor per interval would be mostly zeros)."""
        return [(BOUNDS[i], c) for i, c in enumerate(self.counts) if c]

    @classmethod
    def from_nonzero(cls, items: Sequence[Tuple[float, int]],
                     count: Optional[int] = None, total: float = 0.0,
                     min_ms: Optional[float] = None,
                     max_ms: Optional[float] = None) -> "Histogram":
        """Rebuild from the sparse view (bound values are matched to the
        fixed bucket table by index; a bound that no longer matches —
        e.g. from a future layout — clamps like an ordinary sample)."""
        h = cls()
        for bound, c in items:
            # the bound is a bucket UPPER bound: nudge just below it so
            # bucket_index maps it back to the originating bucket
            h.counts[bucket_index(float(bound) * 0.999)] += int(c)
        h.count = sum(h.counts) if count is None else int(count)
        h.sum = float(total)
        occupied = [float(b) for b, c in items if c]
        # an incr-only monitor's record has count > 0 with NO buckets —
        # min/max only reconstruct when there is bucket mass to infer
        # them from (or the caller passed them explicitly)
        if min_ms is not None:
            h.min = float(min_ms)
        elif occupied:
            h.min = min(occupied) / (2 ** (1 / LOG2_SUB))
        if max_ms is not None:
            h.max = float(max_ms)
        elif occupied:
            h.max = max(occupied)
        return h

    def as_dict(self) -> Dict:
        """JSON-safe snapshot — SAME key set as
        ``dashboard.MonitorSnapshot.hist_dict()`` (the exporter /
        MSG_STATS wire shape; keep the two in lockstep). A bare
        histogram has no ``incr``-style untimed events, so here
        ``timed`` == ``count``."""
        p50, p90, p99 = self.percentiles((50, 90, 99))
        return {
            "count": self.count,
            "sum_ms": round(self.sum, 6),
            "min_ms": round(self.min, 6) if self.count else 0.0,
            "max_ms": round(self.max, 6),
            "p50_ms": round(p50, 6),
            "p90_ms": round(p90, 6),
            "p99_ms": round(p99, 6),
            "timed": self.count,
            "buckets": [[b, c] for b, c in self.nonzero()],
        }
