"""ctypes loader and wrappers for the native async-PS transport (port of
``multiverso_tpu/ps/native.py``; the library is ``csrc/mv_ps.cpp``, host
C++ built with ``$CXX`` or ``g++`` and ``-pthread`` into
``build/torch_native/libmv_ps-<hash>.so`` at first use).

See ``csrc/mv_ps.cpp`` for what lives in C++ and why. This module is the
thin Python face of it:

* :func:`server_new` / :func:`serve_fd` / :func:`register_shard` — the
  server half, used by :class:`~multiverso_tpu_torch.ps.service.PSService`
  to adopt accepted connections into C++ threads and to register shards
  whose rows are a CPU tensor with a linear updater for zero-Python
  serving. Frames C++ cannot serve (every op on a shard on the card, among
  others) arrive back through the punt callback as raw frames.
* :class:`NativeConn` — the client half: counted fire-and-forget adds and
  buffer-filling gets over one persistent connection, with a C++ recv
  thread (no Python wakeup per reply), and :func:`add_fanout` /
  :func:`get_fanout`, which split a batch by owner and reassemble the
  replies in C.

Where no compiler builds the library, ``available()`` is False and the
pure-Python plane runs unchanged.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch import native as _native

SO_NAME, SRC_NAME, EXTRA_FLAGS = "libmv_ps", "mv_ps.cpp", ("-pthread",)

_lib = None
_lock = threading.Lock()
_build_failed = False

# ctypes signature for the punt callback: (conn_id, frame_ptr, frame_len).
# Invoked from a C++ connection thread; ctypes acquires the GIL.
PUNT_CB = ctypes.CFUNCTYPE(None, ctypes.c_uint64,
                           ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int64)


def library_path() -> Path:
    """Where the library builds to (the name hashes source and flags)."""
    return _native.library_path(SO_NAME, SRC_NAME, EXTRA_FLAGS)


def _try_load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        lib = _native.build_and_load(SO_NAME, SRC_NAME, EXTRA_FLAGS)
        if lib is None:
            _build_failed = True
            return None
        vp, i64, u64, i32, dbl = (ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_uint64, ctypes.c_int,
                                  ctypes.c_double)
        cp, ccp = ctypes.c_char_p, ctypes.c_char_p
        lib.mvps_server_new.restype = vp
        lib.mvps_server_new.argtypes = [PUNT_CB, i32]
        lib.mvps_server_adopt.restype = i32
        lib.mvps_server_adopt.argtypes = [vp, i32]
        lib.mvps_register_shard.restype = vp
        lib.mvps_register_shard.argtypes = [vp, cp, i64, i64, i64, i32,
                                            dbl, vp, vp, i64]
        lib.mvps_unregister_shard.restype = i32
        lib.mvps_unregister_shard.argtypes = [vp, cp]
        lib.mvps_shard_pin_lock.argtypes = [vp]
        lib.mvps_shard_pin_unlock.argtypes = [vp]
        lib.mvps_shard_pin_stats.argtypes = [vp, ctypes.POINTER(u64),
                                             ctypes.POINTER(u64)]
        lib.mvps_shard_pin_free.argtypes = [vp]
        lib.mvps_send_raw.restype = i32
        lib.mvps_send_raw.argtypes = [vp, u64, ctypes.c_char_p, i64]
        lib.mvps_server_close.argtypes = [vp]
        lib.mvps_server_free.argtypes = [vp]
        lib.mvnet_connect.restype = vp
        lib.mvnet_connect.argtypes = [ccp, i32, dbl, dbl]
        lib.mvnet_add.restype = i64
        lib.mvnet_add.argtypes = [vp, i32, ctypes.c_char_p, i64, vp, i64,
                                  vp, i64, cp, vp, i32,
                                  ctypes.POINTER(i64)]
        lib.mvnet_take_add_error.restype = i32
        lib.mvnet_take_add_error.argtypes = [vp, i64, ctypes.c_char_p, i32]
        lib.mvnet_adds_done.restype = i64
        lib.mvnet_adds_done.argtypes = [vp]
        lib.mvnet_adds_issued.restype = i64
        lib.mvnet_adds_issued.argtypes = [vp]
        lib.mvnet_wait_adds.restype = i32
        lib.mvnet_wait_adds.argtypes = [vp, i64, dbl]
        lib.mvnet_get_send.restype = i64
        lib.mvnet_get_send.argtypes = [vp, i32, ctypes.c_char_p, i64, vp,
                                       i64, vp, i64]
        lib.mvnet_get_wait.restype = i32
        lib.mvnet_get_wait.argtypes = [vp, i64, dbl]
        lib.mvnet_get_cancel.argtypes = [vp, i64]
        lib.mvnet_add_fanout.restype = i32
        lib.mvnet_add_fanout.argtypes = [ctypes.POINTER(vp), i32, i32,
                                         i64, ctypes.c_char_p, i64, vp,
                                         i64, vp, i64, cp, i64,
                                         ctypes.POINTER(i64),
                                         ctypes.POINTER(i64)]
        lib.mvnet_get_fanout.restype = i32
        lib.mvnet_get_fanout.argtypes = [ctypes.POINTER(vp), i32, i32,
                                         i64, ctypes.c_char_p, i64, vp,
                                         i64, vp, i64,
                                         ctypes.POINTER(i64)]
        lib.mvnet_dead.restype = i32
        lib.mvnet_dead.argtypes = [vp]
        lib.mvnet_last_error.argtypes = [vp, ctypes.c_char_p, i32]
        lib.mvnet_shutdown.argtypes = [vp]
        lib.mvnet_free.argtypes = [vp]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the library built and loaded (the native plane can
    run); False means the Python plane only."""
    return _try_load() is not None


# ------------------------------------------------------------------ #
# server half
# ------------------------------------------------------------------ #
def server_new(punt_cb: Callable[[int, bytes], None], rank: int
               ) -> Tuple[int, object]:
    """Create a native server. ``punt_cb(conn_id, frame_bytes)`` receives
    frames C++ couldn't serve (it must reply via :func:`send_raw` or let
    the request time out at the client). Returns ``(handle, keepalive)``
    — the caller must keep ``keepalive`` (the CFUNCTYPE object) alive as
    long as the server exists, or ctypes frees the trampoline under C++."""
    lib = _try_load()
    assert lib is not None

    def _cb(conn_id, ptr, length):
        try:
            punt_cb(int(conn_id), ctypes.string_at(ptr, length))
        except BaseException:   # noqa: BLE001 — C++ can't take exceptions
            pass                # handler already replied ERR where possible

    cfunc = PUNT_CB(_cb)
    handle = lib.mvps_server_new(cfunc, int(rank))
    return handle, cfunc


def serve_fd(server: int, fd: int) -> bool:
    lib = _try_load()
    return lib.mvps_server_adopt(server, fd) == 0


def register_shard(server: int, name: str, lo: int, n: int, ncol: int,
                   data: torch.Tensor, sign: float,
                   dirty: Optional[np.ndarray], nworkers: int
                   ) -> Optional[int]:
    """Register a host-backed linear shard for native serving. ``data``
    must be the shard's live, C-contiguous CPU tensor (float32/float64) of
    ``n`` rows plus the scratch row; ``dirty`` its C-contiguous numpy bool
    [nworkers, n] bit matrix or None. The CALLER owns both buffers'
    lifetime (the Python shard object outlives the registration via the
    service's handler reference) and never swaps them while registered.
    Returns a PIN — a stable handle to THIS shard object for lock/stats,
    immune to same-name re-registration — or None if the shard can't be
    served natively. Free the pin with :func:`shard_pin_free` when the
    shard dies."""
    lib = _try_load()
    if not isinstance(data, torch.Tensor) or data.device.type != "cpu":
        return None
    if data.dtype == torch.float32:
        itemsize = 4
    elif data.dtype == torch.float64:
        itemsize = 8
    else:
        return None
    if not data.is_contiguous() or data.dim() != 2:
        return None
    if dirty is not None and (dirty.dtype != np.bool_
                              or not dirty.flags.c_contiguous):
        return None
    return lib.mvps_register_shard(
        server, name.encode(), lo, n, ncol, itemsize, float(sign),
        data.data_ptr(), dirty.ctypes.data if dirty is not None else None,
        nworkers) or None


def unregister_shard(server: int, name: str) -> None:
    """Drop the shard registered as ``name`` from the C++ server: from
    then on its ops punt to Python (``PSService._punt``), as those of a
    shard never registered do. Its pin stays valid until freed."""
    lib = _try_load()
    lib.mvps_unregister_shard(server, name.encode())


def shard_pin_lock(pin: int) -> None:
    _try_load().mvps_shard_pin_lock(pin)


def shard_pin_unlock(pin: int) -> None:
    _try_load().mvps_shard_pin_unlock(pin)


def shard_pin_stats(pin: int) -> Tuple[int, int]:
    lib = _try_load()
    adds = ctypes.c_uint64()
    applies = ctypes.c_uint64()
    lib.mvps_shard_pin_stats(pin, ctypes.byref(adds), ctypes.byref(applies))
    return adds.value, applies.value


def shard_pin_free(pin: int) -> None:
    lib = _lib   # no load/build at interpreter teardown
    if lib is not None:
        lib.mvps_shard_pin_free(pin)


def send_raw(server: int, conn_id: int, frame: bytes) -> bool:
    lib = _try_load()
    return lib.mvps_send_raw(server, conn_id, frame, len(frame)) == 0


def server_close(server: int) -> None:
    lib = _try_load()
    lib.mvps_server_close(server)


def server_free(server: int) -> None:
    lib = _try_load()
    lib.mvps_server_free(server)


# ------------------------------------------------------------------ #
# client half
# ------------------------------------------------------------------ #
class NativeConnError(RuntimeError):
    pass


class NativeConn:
    """One native client connection (counted adds + buffer-filling gets).

    NOT thread-safe at the Python level beyond what the C++ side gives:
    concurrent adds/gets are fine (C++ locks internally); close() must not
    race in-flight calls (the service guards it with its peers lock)."""

    __slots__ = ("_h", "_lib", "closed")

    def __init__(self, addr: str, connect_timeout: float,
                 io_timeout: float):
        lib = _try_load()
        if lib is None:
            raise NativeConnError("libmv_ps unavailable (no C++ compiler "
                                  "built csrc/mv_ps.cpp)")
        host, port = addr.rsplit(":", 1)
        h = lib.mvnet_connect(host.encode(), int(port),
                              float(connect_timeout), float(io_timeout))
        if not h:
            raise NativeConnError(f"cannot connect to {addr}")
        self._h = h
        self._lib = lib
        self.closed = False

    def last_error(self) -> str:
        buf = ctypes.create_string_buffer(512)
        self._lib.mvnet_last_error(self._h, buf, len(buf))
        return buf.value.decode(errors="replace")

    def dead(self) -> bool:
        return self.closed or bool(self._lib.mvnet_dead(self._h))

    def add(self, msg_type: int, meta_b: bytes, ids: Optional[np.ndarray],
            vals: np.ndarray) -> Tuple[int, int]:
        """Counted fire-and-forget add; returns ``(seq, msg_id)`` — seq
        for :meth:`wait_adds` (completion), msg_id for
        :meth:`take_add_error` (this op's own server error, if any).
        ``ids`` (int64, contiguous) may be None for ADD_FULL. Raises on a
        dead connection."""
        if ids is not None:
            assert ids.dtype == np.int64 and ids.flags.c_contiguous
        assert vals.flags.c_contiguous
        ds = vals.dtype.str
        shape = (ctypes.c_int64 * vals.ndim)(*vals.shape)
        seq_out = ctypes.c_int64()
        mid = self._lib.mvnet_add(
            self._h, msg_type, meta_b, len(meta_b),
            ids.ctypes.data if ids is not None else None,
            ids.size if ids is not None else 0,
            vals.ctypes.data, vals.nbytes, ds.encode(), shape, vals.ndim,
            ctypes.byref(seq_out))
        if mid < 0:
            raise NativeConnError(f"native add failed: {self.last_error()}")
        return int(seq_out.value), int(mid)

    def adds_done(self) -> int:
        return int(self._lib.mvnet_adds_done(self._h))

    def adds_issued(self) -> int:
        """Highest add seq issued — read under the C-side issue lock, so
        a flush fence built on it can never under-wait a racing add."""
        return int(self._lib.mvnet_adds_issued(self._h))

    def wait_adds(self, seq: int, timeout: float) -> None:
        """Block until all adds up to ``seq`` are acknowledged. Raises
        TimeoutError or NativeConnError (dead connection). Per-op server
        errors are separate: :meth:`take_add_error`."""
        rc = self._lib.mvnet_wait_adds(self._h, seq, float(timeout))
        if rc == 0:
            return
        if rc == -1:
            raise TimeoutError(f"native adds not acked within {timeout}s")
        raise NativeConnError(self.last_error() or "native add failed")

    def take_add_error(self, msg_id: int) -> Optional[str]:
        """The ERR-reply message for add ``msg_id`` (consumed), or None."""
        buf = ctypes.create_string_buffer(512)
        if self._lib.mvnet_take_add_error(self._h, msg_id, buf, len(buf)):
            return buf.value.decode(errors="replace")
        return None

    def get_send(self, msg_type: int, meta_b: bytes,
                 ids: Optional[np.ndarray], out: np.ndarray) -> int:
        """Dispatch a get whose reply payload fills ``out`` (exact-size
        contiguous buffer). Returns the wait id."""
        if ids is not None:
            assert ids.dtype == np.int64 and ids.flags.c_contiguous
        assert out.flags.c_contiguous and out.flags.writeable
        mid = self._lib.mvnet_get_send(
            self._h, msg_type, meta_b, len(meta_b),
            ids.ctypes.data if ids is not None else None,
            ids.size if ids is not None else 0,
            out.ctypes.data, out.nbytes)
        if mid < 0:
            raise NativeConnError(f"native get failed: {self.last_error()}")
        return int(mid)

    def get_wait(self, mid: int, timeout: float) -> None:
        rc = self._lib.mvnet_get_wait(self._h, mid, float(timeout))
        if rc == 0:
            return
        if rc == -1:
            raise TimeoutError(f"native get: no reply within {timeout}s")
        raise NativeConnError(self.last_error() or "native get failed")

    def get_cancel(self, mid: int) -> None:
        """Drop a pending get; afterwards the recv loop can never touch
        the op's out buffer (abandoned-future safety)."""
        self._lib.mvnet_get_cancel(self._h, mid)

    @property
    def handle(self) -> int:
        return self._h

    def close(self) -> None:
        """Sever the connection (idempotent). The C++ Client is NOT freed
        here — outstanding futures may still call into it (every call on a
        shut-down conn safely reports dead); it's freed when the last
        Python reference drops."""
        if not self.closed:
            self.closed = True
            self._lib.mvnet_shutdown(self._h)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.mvnet_free(self._h)
                self._h = None
        except Exception:   # noqa: BLE001 — interpreter teardown
            pass


def add_fanout(conns, world: int, mod_owner: bool, rows_per: int,
               meta_b: bytes, ids: np.ndarray, vals: np.ndarray):
    """Partition an add batch by owner and send per-owner frames in C.
    ``conns``: one NativeConn or None per rank. Returns
    ``[(rank, conn, seq, mid) | (rank, None, -1, -1)]`` for each rank
    that owns rows (None conn = unreachable/dead: caller fails that
    part). Raises only on caller bugs (owner out of range)."""
    lib = _try_load()
    assert ids.dtype == np.int64 and ids.flags.c_contiguous
    assert vals.flags.c_contiguous and vals.ndim == 2
    handles = (ctypes.c_void_p * world)(
        *[c.handle if c is not None and not c.dead() else None
          for c in conns])
    out_seq = (ctypes.c_int64 * world)()
    out_mid = (ctypes.c_int64 * world)()
    rc = lib.mvnet_add_fanout(
        handles, world, 1 if mod_owner else 0, rows_per,
        meta_b, len(meta_b), ids.ctypes.data, ids.size,
        vals.ctypes.data, vals.strides[0], vals.dtype.str.encode(),
        vals.shape[1], out_seq, out_mid)
    if rc < 0:
        raise ValueError("add_fanout: row owner out of range")
    out = []
    for r in range(world):
        if out_mid[r] == -2:
            continue
        if out_mid[r] == -1:
            out.append((r, None, -1, -1))
        else:
            out.append((r, conns[r], int(out_seq[r]), int(out_mid[r])))
    return out


def get_fanout(conns, world: int, mod_owner: bool, rows_per: int,
               meta_b: bytes, ids: np.ndarray, out: np.ndarray):
    """Per-owner GET_ROWS whose replies scatter into ``out`` (k, ncol) at
    the original batch positions — reassembly happens in the C++ recv
    thread. Same return shape as :func:`add_fanout` (seq slot unused)."""
    lib = _try_load()
    assert ids.dtype == np.int64 and ids.flags.c_contiguous
    assert out.flags.c_contiguous and out.ndim == 2
    assert out.shape[0] == ids.size
    handles = (ctypes.c_void_p * world)(
        *[c.handle if c is not None and not c.dead() else None
          for c in conns])
    out_mid = (ctypes.c_int64 * world)()
    rc = lib.mvnet_get_fanout(
        handles, world, 1 if mod_owner else 0, rows_per,
        meta_b, len(meta_b), ids.ctypes.data, ids.size,
        out.ctypes.data, out.strides[0], out_mid)
    if rc < 0:
        raise ValueError("get_fanout: row owner out of range")
    res = []
    for r in range(world):
        if out_mid[r] == -2:
            continue
        if out_mid[r] == -1:
            res.append((r, None, -1, -1))
        else:
            res.append((r, conns[r], 0, int(out_mid[r])))
    return res
