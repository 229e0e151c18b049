"""KVTable: sparse key-value table (port of
``multiverso_tpu/tables/kv_table.py``).

The reference's KVTable is a hash-sharded ``unordered_map<Key, Val>``, used
by WordEmbedding as the global word-count aggregator. Scalar KV traffic has
no business on the card, so, as in the JAX package, it is a host dict with
the reference's Add/Get semantics. The port runs one process, so the
aggregated view (``get(global_=True)``, ``allreduce``) is the local one.
``store``/``load`` write and read the JAX package's format.
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
        self.table_id = Zoo.get().register_table(self)

    def add(self, keys: Iterable[int], values: Iterable) -> None:
        """ref kv_table.h Add: accumulate into the map."""
        with monitor(f"table[{self.name}].add"), self._lock:
            for k, v in zip(keys, values):
                self._store[int(k)] = self._store.get(int(k), 0) + v

    def get(self, keys: Optional[Iterable[int]] = None,
            global_: bool = False) -> Dict[int, float]:
        """ref kv_table.h Get (:44-99): the values of ``keys`` (0 for a key
        never added), or the whole map. ``global_=True`` asks for the
        server-aggregated values; with one process they are the local
        ones."""
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
        """Aggregate across processes and commit the merged view; with one
        process the local view, unchanged."""
        return self.get()

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
