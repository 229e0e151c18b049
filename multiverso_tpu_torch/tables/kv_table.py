"""KVTable: sparse key-value table (port of
``multiverso_tpu/tables/kv_table.py``).

The reference's KVTable is a hash-sharded ``unordered_map<Key, Val>``, used
by WordEmbedding as the global word-count aggregator. Scalar KV traffic has
no business on the card, so, as in the JAX package, it is a host dict per
process with the reference's Add/Get semantics, summed across processes on
demand: ``get(global_=True)`` reads the world's sum without changing the
local dict, ``allreduce`` commits it as the local dict. Both are
collectives (every process calls them) over a host allgather
(``collectives.process_allgather``): the key sets are ragged, so the
processes first agree on the longest and pad with the key -1. One
process: the local view. ``store``/``load`` write and read the JAX
package's format.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional

import numpy as np

from multiverso_tpu_torch.utils.dashboard import monitor
from multiverso_tpu_torch.zoo import Zoo


class KVTable:
    def __init__(self, dtype=np.int64, name: str = "kv"):
        self.name = name
        self.dtype = np.dtype(dtype)
        self._store: Dict[int, float] = {}
        self._lock = threading.Lock()
        self._zoo = Zoo.get()
        self.table_id = self._zoo.register_table(self)

    def add(self, keys: Iterable[int], values: Iterable) -> None:
        """ref kv_table.h Add: accumulate into the map."""
        with monitor(f"table[{self.name}].add"), self._lock:
            for k, v in zip(keys, values):
                self._store[int(k)] = self._store.get(int(k), 0) + v

    def get(self, keys: Optional[Iterable[int]] = None,
            global_: bool = False) -> Dict[int, float]:
        """ref kv_table.h Get (:44-99): the values of ``keys`` (0 for a key
        never added), or the whole map. ``global_=True`` asks for the
        server-aggregated values, every process's adds summed (a
        collective; the local dict is unchanged, so it may be asked
        again); with one process they are the local ones."""
        if global_ and self._zoo.size() > 1:
            with monitor(f"table[{self.name}].get"):
                merged = self._merged()
                if keys is None:
                    return merged
                return {int(k): merged.get(int(k), 0) for k in keys}
        with monitor(f"table[{self.name}].get"), self._lock:
            if keys is None:
                return dict(self._store)
            return {int(k): self._store.get(int(k), 0) for k in keys}

    def raw(self) -> Dict[int, float]:
        """ref kv_table.h raw(): the worker-local view."""
        return self.get()

    def __getitem__(self, key: int):
        return self._store.get(int(key), 0)

    def allreduce(self) -> Dict[int, float]:
        """Sum every process's dict and commit the sum as the local dict
        (a collective; twice with no add between multiplies by the world:
        ``get(global_=True)`` is the repeatable read). With one process
        the local view, unchanged."""
        if self._zoo.size() == 1:
            return self.get()
        merged = self._merged()
        with self._lock:
            self._store = dict(merged)
        return merged

    def _merged(self) -> Dict[int, float]:
        """Every process's dict summed, in rank order (float64 values)."""
        from multiverso_tpu_torch.parallel.collectives import \
            process_allgather
        with self._lock:
            items = sorted(self._store.items())
        keys = np.array([k for k, _ in items], dtype=np.int64)
        vals = np.array([v for _, v in items], dtype=np.float64)
        n = int(process_allgather(np.array([keys.size], np.int64)).max())
        if n == 0:
            return {}
        pad = n - keys.size
        if pad:
            keys = np.concatenate([keys, np.full(pad, -1, np.int64)])
            vals = np.concatenate([vals, np.zeros(pad, np.float64)])
        merged: Dict[int, float] = {}
        for krow, vrow in zip(process_allgather(keys),
                              process_allgather(vals)):
            for k, v in zip(krow, vrow):
                if k >= 0:
                    merged[int(k)] = merged.get(int(k), 0) + v
        return merged

    # ------------------------------------------------------------------ #
    # checkpoint (implemented, unlike the reference's stub)
    # ------------------------------------------------------------------ #
    def store(self, stream) -> None:
        """The keys (int64) and the values (float64), sorted by key, with
        ``np.save``."""
        with self._lock:
            items = sorted(self._store.items())
        np.save(stream, np.array([k for k, _ in items], dtype=np.int64),
                allow_pickle=False)
        np.save(stream, np.array([v for _, v in items], dtype=np.float64),
                allow_pickle=False)

    def load(self, stream) -> None:
        """Replace the map with what :meth:`store` (of either package)
        wrote, each value cast to the table's dtype."""
        keys = np.load(stream)
        vals = np.load(stream)
        with self._lock:
            self._store = {int(k): self.dtype.type(v).item()
                           for k, v in zip(keys, vals)}


class KVTableOption:
    def __init__(self, dtype=np.int64):
        self.dtype = dtype

    def build(self, name: str = "kv") -> KVTable:
        return KVTable(dtype=self.dtype, name=name)
