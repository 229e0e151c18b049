"""One-shot host <-> device link speed probe (port of
``multiverso_tpu/utils/linkprobe.py``).

The wire filters (bf16, 1bit, topk) trade encode time on the host for
bytes on the host <-> device link: a gain on a slow link (a remote or
tunneled device, ~100 ms/MB), a loss on a fast one (a local card's PCIe).
Table creation asks this probe, and warns when a filter is set on a fast
link.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

_CACHED_MS: Dict[str, float] = {}

# above this, a 1 MB upload is "slow wire" territory where compressing the
# payload pays for itself (a local card's PCIe measures ~1 ms or less)
FAST_LINK_MS = 20.0


def device_link_ms(device: torch.device, refresh: bool = False) -> float:
    """Median warm time (ms) of a 1 MB host -> ``device`` upload and a
    readback, cached per device for the process. On the CPU there is no
    link and the copy is a memcpy."""
    key = str(device)
    if key in _CACHED_MS and not refresh:
        return _CACHED_MS[key]
    buf = torch.from_numpy(np.zeros(1 << 20, np.uint8))
    int(buf.to(device)[0])                 # warm the transfer path
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        int(buf.to(device, copy=True)[0])  # the readback is the sync
        times.append(time.perf_counter() - t0)
    _CACHED_MS[key] = float(np.median(times) * 1e3)
    return _CACHED_MS[key]
