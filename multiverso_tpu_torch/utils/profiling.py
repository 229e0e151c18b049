"""Profiler integration (port of ``multiverso_tpu/utils/profiling.py``).

``trace(name)`` captures a host + device profile of the enclosed region
with ``torch.profiler`` and writes it as a Chrome trace
(``<trace_dir>/<name>.json``, viewable in Perfetto or
``chrome://tracing``, next to the trace spans of ``telemetry/trace.py``);
``annotate(name)`` marks a named region inside it
(``torch.profiler.record_function``).

After a ``torch.profiler`` run kineto keeps CUPTI attached unless
``TEARDOWN_CUPTI`` is set, and every later launch pays for it on the host;
``trace`` sets it (unless the caller chose a value) so a profiled region
leaves the host-bound code after it as fast as before.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Iterator, Optional

import torch

from multiverso_tpu_torch.utils import config, log

config.define_string("trace_dir", "", "when set, trace() regions write a "
                     "torch.profiler Chrome trace under this directory")


@contextmanager
def trace(name: str = "trace",
          trace_dir: Optional[str] = None) -> Iterator[Optional[str]]:
    """Capture a host + device profile of the enclosed region and yield
    the path of the Chrome trace it writes on exit (None, and no
    profiling, when no directory is configured)."""
    directory = trace_dir or config.get_flag("trace_dir")
    if not directory:
        yield None
        return
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{name}.json")
    log.info("profiler trace -> %s", path)
    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()   # the region's kernels end inside
    prof.export_chrome_trace(path)


def annotate(name: str):
    """Named region inside a trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
