"""AsyncBuffer: double-buffered prefetch (port of
``multiverso_tpu/utils/async_buffer.py``).

The reference ASyncBuffer
(ref: include/multiverso/util/async_buffer.h:11-116) overlaps a parameter
pull with compute by keeping two buffers and a background fill thread —
the mechanism behind the LR app's pipeline mode
(ref Applications/LogisticRegression/src/model/ps_model.cpp:236-271).

CUDA's asynchronous launches overlap device work by themselves; the
host-side pattern is needed when the fill function does blocking host
work (data loading, a table Get that copies to the host). The API mirrors
the reference: ``get()`` returns the ready buffer and kicks off the next
fill.

``version_fn`` pairs with the table get-cache (``Table.version``): when the
source's version is unchanged since the last completed fill, the next fill
is skipped entirely and ``get()`` re-serves the previous result — a
prefetch loop over a quiet table then costs one integer compare per
iteration instead of one device->host pull.
"""

from __future__ import annotations

import threading
from typing import Callable, Generic, Optional, TypeVar

T = TypeVar("T")


class AsyncBuffer(Generic[T]):
    def __init__(self, fill_fn: Callable[[], T],
                 version_fn: Optional[Callable[[], int]] = None):
        self._fill_fn = fill_fn
        self._version_fn = version_fn
        self._result: Optional[T] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # version OBSERVED BEFORE the fill ran (a mutation landing mid-fill
        # bumps the source version past this, so the next get() refills)
        self._filled_version: Optional[int] = None
        self.skipped_fills = 0   # diagnostic: fills avoided by version_fn
        self._start_fill()

    def _start_fill(self) -> None:
        pre = self._version_fn() if self._version_fn is not None else None

        def run():
            try:
                self._result = self._fill_fn()
                self._filled_version = pre
            except BaseException as e:  # surfaced on next get()
                self._error = e
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def _fresh(self) -> bool:
        """True when the last completed fill is still current (version
        unchanged), so the next fill may be skipped."""
        return (self._version_fn is not None
                and self._error is None
                and self._filled_version is not None
                and self._version_fn() == self._filled_version)

    def get(self, start_next: bool = True) -> T:
        """Block for the in-flight fill, return it, start the next one.

        On a fill error the exception is re-raised here; a new fill is still
        started (when ``start_next``) so the buffer recovers from transient
        failures instead of serving stale results forever."""
        assert self._thread is not None
        self._thread.join()
        err, self._error = self._error, None
        result = self._result
        if start_next:
            if err is None and self._fresh():
                self.skipped_fills += 1
            else:
                self._start_fill()
        if err is not None:
            raise err
        return result

    def stop(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
