"""The WordEmbedding block pipeline's producer queue (port of
``multiverso_tpu/io/sample_reader.py``, its ``BlockPrepareQueue``).

Not ported yet (ROADMAP): ``SampleReader`` and its formats, which serve
logistic regression, and the profiler's ``io.produce`` spans and
``io_wait`` phase.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterator, Sequence


class BlockPrepareQueue:
    """Bounded K-deep ORDERED prefetch queue over a finite work list.

    ``fn(item, index)`` runs on ``threads`` producer threads for items
    ahead of the consumer, at most ``depth`` outstanding (claimed but not
    yet consumed), and :meth:`next` yields the results strictly in order,
    so a pure ``fn`` gives the results of calling it inline, whatever the
    threads' schedule.

    A producer's exception is raised at the matching :meth:`next` call
    (order kept) and ends the queue. ``close()`` releases the threads
    early; they are daemons either way.
    """

    def __init__(self, items: Sequence[Any],
                 fn: Callable[[Any, int], Any],
                 depth: int = 4, threads: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._items = items
        self._fn = fn
        self._depth = int(depth)
        self._cond = threading.Condition()
        self._results: dict = {}          # index -> ("ok"|"err", payload)
        self._next_claim = 0              # producer side
        self._next_emit = 0               # consumer side
        self._closed = False
        self._threads = [
            threading.Thread(target=self._produce, daemon=True,
                             name=f"mv-blockprep-{i}")
            for i in range(max(1, min(int(threads), len(items) or 1)))]
        for t in self._threads:
            t.start()

    def _produce(self) -> None:
        n = len(self._items)
        while True:
            with self._cond:
                while (not self._closed and self._next_claim < n
                       and self._next_claim - self._next_emit
                       >= self._depth):
                    self._cond.wait()
                if self._closed or self._next_claim >= n:
                    return
                i = self._next_claim
                self._next_claim += 1
            try:
                out = ("ok", self._fn(self._items[i], i))
            except BaseException as e:   # noqa: BLE001 -- raised in order
                out = ("err", e)         # at the consumer's next()
            with self._cond:
                if self._closed:   # closed mid-produce: drop the payload
                    return         # (close() already purged _results)
                self._results[i] = out
                self._cond.notify_all()

    def next(self) -> Any:
        """The next result in submission order. Raises StopIteration past
        the last item, or the producer's exception for THIS index."""
        i = self._next_emit
        if i >= len(self._items):
            raise StopIteration
        with self._cond:
            while i not in self._results and not self._closed:
                self._cond.wait()
            if i not in self._results:
                raise RuntimeError("BlockPrepareQueue closed while "
                                   f"item {i} was pending")
            kind, payload = self._results.pop(i)
            self._next_emit = i + 1
            self._cond.notify_all()
        if kind == "err":
            self.close()
            raise payload
        return payload

    def __iter__(self) -> Iterator[Any]:
        while True:
            try:
                yield self.next()
            except StopIteration:
                return

    def close(self) -> None:
        with self._cond:
            self._closed = True
            # ends the queue for real: items produced ahead are dropped, so
            # a next() after an error or a close raises, instead of racing
            # the producers for whatever they happened to finish first
            self._results.clear()
            self._cond.notify_all()

    def __enter__(self) -> "BlockPrepareQueue":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
