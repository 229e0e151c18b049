"""Bounded-memory heavy-hitter sketch for PS row traffic (port of
``multiverso_tpu/telemetry/hotkeys.py``, the same counts and order).

Space-Saving (Metwally/Agrawal/El Abbadi, "Efficient computation of
frequent and top-k elements in data streams"): keep at most ``capacity``
(key, count, err) entries; a known key increments in O(1), an unknown
key evicts the current minimum and inherits its count as the new entry's
overestimate bound (``err``). Guarantees, independent of stream length:

* every tracked key's true frequency f satisfies
  ``count - err <= f <= count``;
* any key whose true frequency exceeds ``total / capacity`` is tracked —
  the zipf heads this sketch exists for are far above that bar.

Design constraints, in order:

1. The shard serve paths call this per request (always-on, like the
   flight recorder), so a recorded op must stay O(1): one dict lookup +
   one list increment for a known key. Eviction uses a lazy min-heap
   (exactly one heap entry per tracked key; a stale top re-pushes at its
   live count) — amortized O(log capacity), and since pushed counts are
   lower bounds that only grow, the first popped entry whose pushed
   count matches its live count IS the true minimum.
2. Bounded memory: ``capacity`` dict entries + ``capacity`` heap entries,
   a few KB at the default. Batches above :data:`BATCH_SAMPLE` rows are
   stride-sampled at the stride's weight — relative frequencies AND the
   raw-traffic count scale survive uniform sampling (a key served via
   chunked mega-gets ranks correctly against one served via 1-row ops),
   and a 100k-row chunked get must not pay 100k dict ops.
3. Mergeable: :func:`merge_sketches` sums per-key across shards for the
   cluster top-K. Row-partitioned and hash-sharded PS tables give each
   shard a DISJOINT key space, so the cross-shard merge is exact — a
   pure concatenation; the summing path exists for re-partitioned runs.

The shards feed it on their get and add serve paths
(``ps/shard.RowShard._note_rows``, ``HashShard._note_keys``); the read
replica seeds its hot-row cache from the merged top-K
(``serving/replica.ReadReplica``).
"""

from __future__ import annotations

import heapq
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from multiverso_tpu_torch.utils import config

config.define_int(
    "hotkeys_capacity", 128,
    "per-shard Space-Saving heavy-hitter sketch size (tracked row ids on "
    "the get/add serve paths; feeds stats()['hotkeys'], the read "
    "replica's hot-row cache seed and the cache-hit-if-cached curve). "
    "Always on; 0 disables the sketch entirely")

# batches above this many ids are stride-sampled before offering (see
# module docstring constraint 2)
BATCH_SAMPLE = 512


class SpaceSaving:
    """The sketch. Thread-safe: shard connection threads record
    concurrently; one internal lock per offered batch."""

    __slots__ = ("capacity", "total", "observed", "_counts", "_heap",
                 "_nbatches", "_lock")

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("SpaceSaving capacity must be positive")
        self.capacity = int(capacity)
        # key -> [count, err]; exactly one (pushed_count, key) heap entry
        # per tracked key (stale after increments, fixed lazily)
        self._counts: Dict[int, List[int]] = {}
        self._heap: List[Tuple[int, int]] = []
        self.total = 0      # offers counted (weighted; ~= raw traffic)
        self.observed = 0   # raw ids seen (pre-sampling)
        self._nbatches = 0  # rotates the sampling phase (see observe)
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._counts)

    # ------------------------------------------------------------------ #
    def _offer(self, key: int, inc: int) -> None:
        """Caller holds ``self._lock``."""
        self.total += inc
        e = self._counts.get(key)
        if e is not None:
            e[0] += inc   # heap entry goes stale; fixed at eviction time
            return
        if len(self._counts) < self.capacity:
            self._counts[key] = [inc, 0]
            heapq.heappush(self._heap, (inc, key))
            return
        # evict the true minimum: pushed counts are lower bounds, so the
        # first popped entry whose pushed count matches its live count is
        # it (stale tops re-push at their live count; each key re-pushes
        # at most once per eviction — the lock excludes new increments)
        while True:
            cnt, k = heapq.heappop(self._heap)
            live = self._counts[k][0]
            if live == cnt:
                break
            heapq.heappush(self._heap, (live, k))
        del self._counts[k]
        self._counts[key] = [cnt + inc, cnt]
        heapq.heappush(self._heap, (cnt + inc, key))

    def offer(self, key: int, inc: int = 1) -> None:
        with self._lock:
            self.observed += inc
            self._offer(int(key), int(inc))

    def offer_key(self, key, inc: int = 1) -> None:
        """Like :meth:`offer` without the int cast: string keys (tenant
        ids, ``telemetry/tenants.py``) rank the same way row ids do.
        Don't mix key types in one sketch: a stale-top re-push would
        then compare int against str."""
        with self._lock:
            self.observed += inc
            self._offer(key, int(inc))

    def observe(self, ids, offset: int = 0) -> None:
        """Record a batch of row ids (``offset`` turns shard-local ids
        into global ones without allocating a shifted copy). Batches
        above :data:`BATCH_SAMPLE` are stride-sampled, with each sampled
        key offered at the STRIDE's weight — counts stay on the
        raw-traffic scale, so a key served through big chunked gets
        ranks against a key served through 1-row ops instead of being
        undercounted by n/BATCH_SAMPLE (the top-K and the cache-hit
        curve compare across batch sizes by construction)."""
        arr = np.asarray(ids).reshape(-1)
        n = int(arr.size)
        if n == 0:
            return
        off = int(offset)
        with self._lock:
            self.observed += n
            self._nbatches += 1
            inc = 1
            if n > BATCH_SAMPLE:
                inc = -(-n // BATCH_SAMPLE)
                # ROTATING phase: a workload re-issuing the same big
                # caller-ordered batch every step (a DLRM chunked get)
                # would otherwise sample the identical positions forever
                # — an off-stride hot key would never be observed. The
                # batch counter cycles the start through every residue,
                # so across repeats the sample is uniform.
                # start < inc <= n, so the slice is never empty
                arr = arr[self._nbatches % inc:: inc]
            for k in arr.tolist():
                self._offer(int(k) + off, inc)

    # ------------------------------------------------------------------ #
    def items(self) -> List[Tuple[int, int, int]]:
        """``(key, estimated count, overestimate bound)`` descending by
        count (true frequency is within ``[count - err, count]``)."""
        with self._lock:
            out = [(k, c, e) for k, (c, e) in self._counts.items()]
        out.sort(key=lambda t: (-t[1], t[0]))
        return out

    def top(self, k: int) -> List[Tuple[int, int, int]]:
        return self.items()[:k]

    def to_dict(self) -> Dict:
        """JSON-safe snapshot — the MSG_STATS / exporter wire shape
        (``items`` descending, same tuple order as :meth:`items`)."""
        with self._lock:
            total, observed = self.total, self.observed
            out = [[k, c, e] for k, (c, e) in self._counts.items()]
        out.sort(key=lambda t: (-t[1], t[0]))
        return {"capacity": self.capacity, "total": total,
                "observed": observed, "items": out}


# ---------------------------------------------------------------------- #
# cross-shard merge + the cache-sizing curve
# ---------------------------------------------------------------------- #
def merge_sketches(dicts: Iterable[Optional[Dict]],
                   capacity: Optional[int] = None, key=int) -> Dict:
    """Merge :meth:`SpaceSaving.to_dict` payloads into one cluster-level
    sketch dict. Counts for a key present in several inputs sum (their
    err bounds sum too, staying conservative); PS shards partition the
    key space, so in practice this is an exact concatenation. The result
    keeps the ``capacity`` largest entries (default: the largest input
    capacity). ``key`` normalizes keys across inputs: ``int`` for row
    ids (the default), ``str`` for tenant-id sketches."""
    acc: Dict[Any, List[int]] = {}
    total = observed = cap = 0
    for d in dicts:
        if not d:
            continue
        total += int(d.get("total", 0) or 0)
        observed += int(d.get("observed", 0) or 0)
        cap = max(cap, int(d.get("capacity", 0) or 0))
        for k, c, e in d.get("items", []):
            a = acc.setdefault(key(k), [0, 0])
            a[0] += int(c)
            a[1] += int(e)
    items = sorted(([k, c, e] for k, (c, e) in acc.items()),
                   key=lambda t: (-t[1], t[0]))
    cap = int(capacity or cap or len(items))
    return {"capacity": cap, "total": total, "observed": observed,
            "items": items[:cap]}


def hit_rate_curve(sketch: Dict, points: int = 10,
                   conservative: bool = False) -> List[List[float]]:
    """Estimated cache-hit-rate-if-cached curve: ``[[k, rate], ...]`` at
    k = 1, 2, 4, ... — the fraction of sketched row traffic the top-k
    keys would have absorbed had they been device-cached: the sizing
    input for a hot-row cache. ``conservative=False`` (default) uses the
    raw counts — an UPPER-bound estimate, since Space-Saving counts
    overestimate within ``err`` (materially so when the sketch runs
    well under capacity-to-distinct-keys: every eviction inherits the
    minimum); ``conservative=True`` uses ``max(count - err, 0)`` — the
    guaranteed LOWER bound. Both bound the SKETCHED traffic only: a
    measured cache-hit rate over a raw request stream (the serving
    replica's) can legitimately exceed even
    the upper curve, because shards sketch post-dedupe traffic — the
    curves are a sizing floor for such caches, not a bracket."""
    items = sketch.get("items", [])
    total = sketch.get("total", 0)
    if not items or not total:
        return []
    csum, acc = [], 0
    for _, c, e in items:
        acc += max(c - e, 0) if conservative else c
        csum.append(acc)
    out: List[List[float]] = []
    k = 1
    while k <= len(items) and len(out) < points:
        out.append([k, round(csum[k - 1] / total, 4)])
        k *= 2
    return out
