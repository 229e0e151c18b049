"""Builds the package's CUDA kernels from ``multiverso_tpu_torch/csrc/`` at
first use and loads them with ctypes.

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes) under ``build/torch_kernels/`` beside the package.
The library's file name carries a hash of the source, the headers it may
include from ``csrc/`` and the flags, so an edited source or header is
rebuilt and a stale library is never loaded. A failed
build raises; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

from multiverso_tpu_torch.telemetry import profiler as _profiler

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# the C signature of every exported function, set on load
_SIGNATURES = {
    "flash_fwd": {
        "mv_flash_fwd": (ctypes.c_int, [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p]),
        "mv_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
    "flash_bwd": {
        "mv_flash_bwd_dq": (ctypes.c_int, [ctypes.c_void_p] * 7 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p]),
        "mv_flash_bwd_dkv": (ctypes.c_int, [ctypes.c_void_p] * 9 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p]),
        "mv_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
}
KERNELS = tuple(_SIGNATURES)

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library lives: the name hashes its ``.cu``
    source, every header under ``csrc/`` (the sources share them) and the
    flags, so an edited source or header is rebuilt."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(p for p in CSRC.iterdir()
                         if p.suffix in (".cuh", ".h")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    Returns (library path, seconds spent, compiler output)."""
    out = library_path(name)
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} (exit {res.returncode}):"
                           f"\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent builder sees all or nothing
    _profiler.note_compile(seconds)
    return out, seconds, res.stdout + res.stderr


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, Tuple[float, str]]:
    """Build every kernel at once, one ``nvcc`` process per source."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        results: List[Tuple[Path, float, str]] = list(pool.map(build, names))
    return {n: (s, t) for n, (_, s, t) in zip(names, results)}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        path, _, _ = build(name)
        lib = ctypes.CDLL(str(path))
        _profiler.note_load()
        for fn, (restype, argtypes) in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.restype, f.argtypes = restype, argtypes
        _loaded[name] = lib
        return lib
