"""ctypes loader for the host-side data pipeline ``csrc/mv_data.cpp`` (port
of ``multiverso_tpu/native/__init__.py``, the parts WordEmbedding uses).

The library is built with the host C++ compiler (``$CXX``, else ``g++``) at
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
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "mv_data.cpp"
BUILD_DIR = _PKG.parent / "build" / "torch_native"
# no -march=native: the library may be loaded on another machine than the
# one that built it, and baseline x86-64 doubles give the same draws
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_build_failed = False


def library_path() -> Path:
    """Where the library lives: the name hashes the source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libmv_data-{h.hexdigest()[:16]}.so"


def _build(timeout: int = 180) -> Optional[Path]:
    """Compile the source unless its library exists (atomic rename, so a
    concurrent process never loads half a file). None if no compiler
    produced it."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o",
                        str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=timeout)
        os.replace(tmp, out)
    except (subprocess.SubprocessError, OSError):
        tmp.unlink(missing_ok=True)
        return out if out.exists() else None
    return out


def _try_load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = _build()
        try:
            lib = ctypes.CDLL(str(path)) if path is not None else None
        except OSError:
            lib = None
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
