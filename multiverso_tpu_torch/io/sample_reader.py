"""Background-thread sample reader with a bounded ring buffer, and the
WordEmbedding block pipeline's producer queue (port of
``multiverso_tpu/io/sample_reader.py``).

The reference LR SampleReader (ref:
Applications/LogisticRegression/src/reader.cpp) fills a ring buffer of
parsed samples on a background thread while training consumes them, with
variants for text/libsvm, weighted and binary-sparse formats, plus
per-chunk key sets for sparse pulls.

Formats:
* ``libsvm``:       ``label idx:val idx:val ...`` (indices 0-based here)
* ``dense``:        ``label v0 v1 v2 ...``
* ``weight``:       ``label:weight idx:val ...`` — per-sample importance
  weight pre-scaled into the feature values, so the gradient is weighted
  without touching the objective (ref reader.h:96-114
  WeightedSampleReader::ParseLine, reader.cpp:243-287: values * weight)
* ``weight_dense``: ``label:weight v0 v1 ...`` (the reference's weighted
  reader with sparse=false)
* ``bsparse``:      binary presence-only sparse records — per sample
  ``u64 n, i32 label, f64 weight, u64 keys[n]`` little-endian, every
  present feature's value = weight (ref reader.h:118-146
  BSparseSampleReader, reader.cpp:376-438 ParseSample; the layout matches
  the reference's size_t/int/double record, and the JAX package's, so
  files interoperate)

The reader yields fixed-size minibatches as dense numpy arrays; for sparse
formats it also reports the batch's active-key set (the
``SparseBlock<bool>`` keys the reference feeds to sparse pulls).

Step profiler (flag ``step_profile``): in both the reader and
``BlockPrepareQueue`` each producer's per-item interval lands as an
``io.produce`` async span on the process's open step, and the consumer's
blocked wait is the step's ``io_wait`` phase.
"""

from __future__ import annotations

import queue
import struct
import threading
import time
from typing import (IO, Any, Callable, Iterator, Optional, Sequence, Set,
                    Tuple)

import numpy as np

from multiverso_tpu_torch.io.stream import TextReader, open_stream
from multiverso_tpu_torch.telemetry import profiler as _prof

FORMATS = ("libsvm", "dense", "weight", "weight_dense", "bsparse")

_BS_HEAD = struct.Struct("<qid")   # n, label, weight (size_t, int, double)


def _parse_weight_head(tok: str) -> Tuple[int, float]:
    """``label:weight`` head token (weight optional, default 1)."""
    lab, _, w = tok.partition(":")
    return int(float(lab)), (float(w) if w else 1.0)


def parse_line(line: str, input_dim: int,
               fmt: str) -> Optional[Tuple[int, np.ndarray]]:
    parts = line.split()
    if not parts:
        return None
    weight = 1.0
    if fmt in ("weight", "weight_dense"):
        label, weight = _parse_weight_head(parts[0])
    else:
        label = int(float(parts[0]))
    x = np.zeros(input_dim, dtype=np.float32)
    if fmt in ("dense", "weight_dense"):
        vals = np.asarray(parts[1:], dtype=np.float32)
        x[: vals.size] = vals[:input_dim]
    else:  # libsvm / weight
        for tok in parts[1:]:
            idx, _, val = tok.partition(":")
            i = int(idx)
            if 0 <= i < input_dim:
                x[i] = float(val)
    if weight != 1.0:
        x *= weight   # ref reader.cpp:258-262 — importance weight folded
    return label, x   # into the values, gradient scales implicitly


def write_bsparse_sample(stream: IO[bytes], label: int,
                         keys: Sequence[int], weight: float = 1.0) -> None:
    """Append one binary-sparse record (the format ``fmt="bsparse"``
    reads; see the module docstring for the layout)."""
    keys = np.asarray(keys, np.int64)
    stream.write(_BS_HEAD.pack(keys.size, int(label), float(weight)))
    stream.write(keys.astype("<i8").tobytes())


def _iter_bsparse(uri: str, input_dim: int
                  ) -> Iterator[Tuple[int, np.ndarray]]:
    """Record iterator for the binary presence-only format."""
    with open_stream(uri, "rb") as s:
        while True:
            head = s.read(_BS_HEAD.size)
            if not head:
                return
            if len(head) < _BS_HEAD.size:
                raise ValueError(f"{uri}: truncated bsparse record header")
            n, label, weight = _BS_HEAD.unpack(head)
            # 100M keys/sample (800 MB) is far beyond any real record: a
            # bigger n means a corrupt/misaligned file, and trusting it
            # would attempt the allocation before the short-read check
            if n < 0 or n > 100_000_000:
                raise ValueError(f"{uri}: implausible key count {n} "
                                 "(corrupt or non-bsparse file?)")
            raw = s.read(8 * n)
            if len(raw) < 8 * n:
                raise ValueError(f"{uri}: truncated bsparse key block")
            keys = np.frombuffer(raw, "<i8")
            x = np.zeros(input_dim, np.float32)
            x[keys[(keys >= 0) & (keys < input_dim)]] = weight
            yield label, x


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
            t0 = time.time()
            try:
                out = ("ok", self._fn(self._items[i], i))
            except BaseException as e:   # noqa: BLE001 -- raised in order
                out = ("err", e)         # at the consumer's next()
            t1 = time.time()
            with self._cond:
                if self._closed:   # closed mid-produce: drop the payload
                    return         # (close() already purged _results)
                self._results[i] = out
                self._cond.notify_all()
            if _prof.enabled():
                _prof.note_async("io.produce", t0, t1, attach="any")

    def next(self) -> Any:
        """The next result in submission order (timed as the step's
        ``io_wait`` phase when the producers are behind). Raises
        StopIteration past the last item, or the producer's exception for
        THIS index."""
        i = self._next_emit
        if i >= len(self._items):
            raise StopIteration
        with _prof.phase("io_wait"):
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


class SampleReader:
    """Iterate (X, y, keys) minibatches from a sample file.

    ``keys`` is the sorted active-feature-id set of the batch (sparse-pull
    support); for dense formats it is None.
    """

    def __init__(self, uri: str, input_dim: int, batch_size: int,
                 fmt: str = "libsvm", capacity: int = 8,
                 loop_epochs: int = 1, drop_remainder: bool = False):
        if fmt not in FORMATS:
            raise ValueError(f"unknown sample format {fmt!r}; "
                             f"known: {FORMATS}")
        self.input_dim = input_dim
        self.batch_size = batch_size
        self.fmt = fmt
        self.drop_remainder = drop_remainder
        self._uri = uri
        self._loop_epochs = loop_epochs
        self._queue: "queue.Queue" = queue.Queue(maxsize=capacity)
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._error: Optional[BaseException] = None
        self._thread.start()

    @property
    def _dense_like(self) -> bool:
        """Dense formats carry no sparse key set."""
        return self.fmt in ("dense", "weight_dense")

    def _samples(self) -> Iterator[Tuple[int, np.ndarray]]:
        if self.fmt == "bsparse":
            yield from _iter_bsparse(self._uri, self.input_dim)
            return
        reader = TextReader(self._uri)
        try:
            for line in reader:
                parsed = parse_line(line, self.input_dim, self.fmt)
                if parsed is not None:
                    yield parsed
        finally:
            reader.close()

    def _fill(self) -> None:
        try:
            for _ in range(self._loop_epochs):
                xs, ys, keys = [], [], set()
                t_batch0 = time.time()
                for label, x in self._samples():
                    ys.append(label)
                    xs.append(x)
                    if not self._dense_like:
                        keys.update(np.nonzero(x)[0].tolist())
                    if len(xs) == self.batch_size:
                        self._emit(xs, ys, keys, t_batch0)
                        xs, ys, keys = [], [], set()
                        t_batch0 = time.time()
                if xs and not self.drop_remainder:
                    self._emit(xs, ys, keys, t_batch0)
            self._queue.put(None)
        except BaseException as e:   # noqa: BLE001 -- raised at the
            self._error = e          # consumer's next item
            self._queue.put(None)

    def _emit(self, xs, ys, keys: Set[int],
              t_batch0: Optional[float] = None) -> None:
        X = np.stack(xs)
        y = np.asarray(ys, dtype=np.int32)
        k = (None if self._dense_like
             else np.asarray(sorted(keys), dtype=np.int64))
        # stamp the interval's end BEFORE the put: a full queue blocks
        # put() on backpressure, and folding that wait into io.produce
        # would name the input pipeline the critical path exactly when
        # the producer is idle
        t_done = time.time()
        self._queue.put((X, y, k))
        # the producer thread holds no step of its own: its per-batch
        # parse+assemble interval attaches to the process's current step
        if t_batch0 is not None and _prof.enabled():
            _prof.note_async("io.produce", t_batch0, t_done,
                             attach="any")

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                         Optional[np.ndarray]]]:
        while True:
            # io_wait: the consumer (the training step's thread) blocked
            # on the producer
            with _prof.phase("io_wait"):
                item = self._queue.get()
            if item is None:
                if self._error is not None:
                    raise self._error
                return
            yield item
