"""ctypes loaders for the port's host C++ libraries (port of
``multiverso_tpu/native/__init__.py``): ``csrc/mv_data.cpp``, the
WordEmbedding data pipeline and the LR reader's libsvm line parser, loaded
here, and ``csrc/mv_ps.cpp``, the async-PS transport, loaded by
``ps/native.py``, both through :func:`build_and_load`.

A library is built with the host C++ compiler (``$CXX``, else ``g++``) at
first use into ``build/torch_native/`` beside the package; its file name
hashes the source and the flags, so an edited source is rebuilt. Where no
compiler builds it, ``available()`` is False and callers take the numpy
versions (``Dictionary.subsample``, ``word2vec.generate_pairs``), as the
JAX package does. The two paths draw from different RNGs, so they give
different (equally valid) id and pair streams; the native one matches the
JAX package's native library bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from multiverso_tpu_torch.telemetry import profiler as _profiler

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_native"
# no -march=native: the library may be loaded on another machine than the
# one that built it, and baseline x86-64 doubles give the same draws
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_build_failed = False


def library_path(so_name: str = "libmv_data", src_name: str = "mv_data.cpp",
                 extra_flags: Sequence[str] = ()) -> Path:
    """Where ``csrc/<src_name>`` builds to: ``<so_name>-<hash>.so``, the
    hash over the source and the flags."""
    h = hashlib.sha256((CSRC / src_name).read_bytes())
    h.update(" ".join([*CXX_FLAGS, *extra_flags]).encode())
    return BUILD_DIR / f"{so_name}-{h.hexdigest()[:16]}.so"


def build_and_load(so_name: str, src_name: str,
                   extra_flags: Sequence[str] = (),
                   timeout: int = 180) -> Optional[ctypes.CDLL]:
    """Build ``csrc/<src_name>`` unless its library exists (atomic rename,
    so a concurrent process never loads half a file), then CDLL it. The
    one build-on-first-use path of this module and ``ps/native.py``.
    None when no compiler produced a loadable library."""
    out = library_path(so_name, src_name, extra_flags)
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            t0 = time.perf_counter()
            subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS,
                            *extra_flags, "-o", str(tmp),
                            str(CSRC / src_name)],
                           check=True, capture_output=True, timeout=timeout)
            os.replace(tmp, out)
            _profiler.note_compile(time.perf_counter() - t0)
        except (subprocess.SubprocessError, OSError):
            tmp.unlink(missing_ok=True)
            if not out.exists():
                return None
    try:
        lib = ctypes.CDLL(str(out))
    except OSError:
        return None
    _profiler.note_load()
    return lib


def _try_load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        lib = build_and_load("libmv_data", "mv_data.cpp")
        if lib is None:
            _build_failed = True
            return None
        c_i64, c_i32, c_u64, c_dbl = (ctypes.c_int64, ctypes.c_int32,
                                      ctypes.c_uint64, ctypes.c_double)
        p = ctypes.POINTER
        lib.mv_corpus_load.restype = ctypes.c_void_p
        lib.mv_corpus_load.argtypes = [ctypes.c_char_p, c_i64, c_i64]
        lib.mv_corpus_free.restype = None
        lib.mv_corpus_free.argtypes = [ctypes.c_void_p]
        for fn in (lib.mv_corpus_vocab_size, lib.mv_corpus_size,
                   lib.mv_corpus_total_tokens):
            fn.restype, fn.argtypes = c_i64, [ctypes.c_void_p]
        lib.mv_corpus_counts.restype = None
        lib.mv_corpus_counts.argtypes = [ctypes.c_void_p, p(c_i64)]
        lib.mv_corpus_ids.restype = None
        lib.mv_corpus_ids.argtypes = [ctypes.c_void_p, p(c_i32)]
        lib.mv_corpus_word.restype = ctypes.c_char_p
        lib.mv_corpus_word.argtypes = [ctypes.c_void_p, c_i64]
        lib.mv_subsample.restype = c_i64
        lib.mv_subsample.argtypes = [p(c_i32), c_i64, p(c_i64), c_i64,
                                     c_dbl, c_u64, p(c_i32)]
        lib.mv_generate_pairs.restype = c_i64
        lib.mv_generate_pairs.argtypes = [p(c_i32), c_i64, c_i32, c_u64,
                                          c_i32, p(c_i32), p(c_i32)]
        lib.mv_parse_libsvm_line.restype = c_i32
        lib.mv_parse_libsvm_line.argtypes = [ctypes.c_char_p, c_i64,
                                             p(ctypes.c_float), c_i64]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is built and loaded (the native path
    is active); False means the numpy versions are used."""
    return _try_load() is not None


def _need() -> ctypes.CDLL:
    lib = _try_load()
    if lib is None:
        raise RuntimeError("native library unavailable (no C++ compiler "
                           "built csrc/mv_data.cpp)")
    return lib


_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


class NativeCorpus:
    """Handle over mv_corpus_load: the tokenized, pruned, encoded corpus."""

    def __init__(self, path: str, min_count: int = 5,
                 max_vocab: Optional[int] = None):
        self._lib = _need()
        self._h = self._lib.mv_corpus_load(path.encode(), min_count,
                                           max_vocab or 0)
        if not self._h:
            raise IOError(f"mv_corpus_load failed for {path!r}")

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.mv_corpus_free(self._h)
            self._h = None

    __del__ = close

    @property
    def vocab_size(self) -> int:
        return self._lib.mv_corpus_vocab_size(self._h)

    @property
    def total_tokens(self) -> int:
        return self._lib.mv_corpus_total_tokens(self._h)

    def counts(self) -> np.ndarray:
        out = np.zeros(self.vocab_size, dtype=np.int64)
        self._lib.mv_corpus_counts(self._h, out.ctypes.data_as(_I64P))
        return out

    def ids(self) -> np.ndarray:
        out = np.zeros(self._lib.mv_corpus_size(self._h), dtype=np.int32)
        self._lib.mv_corpus_ids(self._h, out.ctypes.data_as(_I32P))
        return out

    def words(self) -> List[str]:
        return [self._lib.mv_corpus_word(self._h, i).decode()
                for i in range(self.vocab_size)]


def subsample(ids: np.ndarray, counts: np.ndarray, t: float = 1e-4,
              seed: int = 0) -> np.ndarray:
    lib = _need()
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    out = np.zeros(ids.size, dtype=np.int32)
    m = lib.mv_subsample(ids.ctypes.data_as(_I32P), ids.size,
                         counts.ctypes.data_as(_I64P), counts.size,
                         t, seed, out.ctypes.data_as(_I32P))
    return out[:m].copy()


def generate_pairs(ids: np.ndarray, window: int, seed: int = 0,
                   dynamic: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    lib = _need()
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    cap = 2 * window * max(ids.size, 1)
    centers = np.zeros(cap, dtype=np.int32)
    contexts = np.zeros(cap, dtype=np.int32)
    m = lib.mv_generate_pairs(ids.ctypes.data_as(_I32P), ids.size, window,
                              seed, 1 if dynamic else 0,
                              centers.ctypes.data_as(_I32P),
                              contexts.ctypes.data_as(_I32P))
    return centers[:m].copy(), contexts[:m].copy()


# mv_parse_libsvm_line's answer for an empty or comment line
_NO_LABEL = -(1 << 31)


def parse_libsvm_line(line: bytes, dim: int
                      ) -> Optional[Tuple[int, np.ndarray]]:
    """One libsvm line (``label idx:val ...``) as ``(label, dense f32 row
    of width dim)``; None for an empty or comment line. Parsing stops at
    the first token that is not ``idx:val``; indices outside ``[0, dim)``
    are skipped."""
    lib = _need()
    x = np.zeros(dim, dtype=np.float32)
    label = lib.mv_parse_libsvm_line(
        line, len(line), x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dim)
    if label == _NO_LABEL:
        return None
    return label, x
