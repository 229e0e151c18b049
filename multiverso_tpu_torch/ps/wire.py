"""PS wire format: framed messages of JSON meta + raw numpy blobs (port of
``multiverso_tpu/ps/wire.py``, byte for byte the same frames).

A rank of either package reads the other's traffic: the header, the meta
JSON and the blob descriptors are the JAX package's, and so are the
codec payloads (``encode_payload``). Payloads stay numpy on the wire;
tensors on the card are copied to the host before they are encoded.

Frame layout (little-endian)::

    magic   4s   b"MVPS"
    type    u16  message type (service.py MSG_*)
    flags   u16  reserved
    msg_id  i64  request/reply correlation id
    metalen u32  length of the UTF-8 JSON meta dict
    narr    u32  number of numpy blobs
    paylen  i64  total bytes after the header (meta + all blobs)
    meta    bytes[metalen]
    narr x: dlen u8, dtype bytes[dlen], ndim u8, shape i64[ndim], raw bytes

bfloat16 blobs: the JAX package carries them as ``ml_dtypes.bfloat16``
arrays, whose descriptor is the dtype's name ``"bfloat16"``. This package
keeps numpy without ``ml_dtypes``: a bf16 blob is a :class:`Bf16` array,
a ``uint16`` view of the raw bits that frames with the same ``"bfloat16"``
descriptor, and a received ``"bfloat16"`` blob parses into one. Rounding
to bf16 is round-to-nearest-even, as ``ml_dtypes`` rounds.

Safety: reads are bounded (MAX_META, MAX_BLOB, MAX_FRAME) so a garbage
peer cannot make the process allocate without bound from one header.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

MAGIC = b"MVPS"
_HEADER = struct.Struct("<4sHHqIIq")
_U8 = struct.Struct("<B")
MAX_META = 64 << 20
MAX_BLOB = 4 << 30
# total-frame sanity bound: must admit legitimate multi-blob frames (a
# checkpoint dump is [keys, rows, every updater-state leaf] in ONE frame),
# so it bounds garbage headers, not real payloads
MAX_FRAME = MAX_META + 8 * MAX_BLOB

BF16_NAME = "bfloat16"


class WireError(RuntimeError):
    pass


# JSON-meta key carrying the per-request trace ID
TRACE_META_KEY = "tr"
# multi-owner super-frame sub-op addressing (MSG_MULTI): each inner frame
# names its OWNING rank here; absent = the receiving rank owns the sub-op
OWNER_META_KEY = "ow"
# the caller's tenant id on add/get frames (stamped only for a
# non-default tenant)
TENANT_META_KEY = "tn"

# Exactly-once replay meta: a windowed add frame (MSG_ADD_ROWS /
# MSG_BATCH from a replay-enabled send window) stamps its outer meta with
# the sending client's identity and a per-(client, table) sequence; the
# owning shard dedupes by them. Replies echo the shard's durable
# (checkpointed) high-water mark for that client, the client's
# retention-prune signal. Unstamped frames behave exactly as before.
REPLAY_CLIENT_KEY = "cl"     # request: client identity string
REPLAY_SEQ_KEY = "seq"       # request: per-(client, table) sequence
REPLAY_DURABLE_KEY = "dseq"  # reply: durable high-water mark for cl
REPLAY_DUP_KEY = "dup"       # reply: frame was a deduped duplicate


def with_trace(meta: Dict, trace) -> Dict:
    """Meta dict + trace ID (no-op passthrough for ``trace=None``)."""
    if trace is None:
        return meta
    meta = dict(meta)
    meta[TRACE_META_KEY] = trace
    return meta


def with_tenant(meta: Dict, tenant) -> Dict:
    """Meta dict + tenant id (no-op passthrough for the default tenant)."""
    if not tenant:
        return meta
    meta = dict(meta)
    meta[TENANT_META_KEY] = tenant
    return meta


ONEBIT_BLOCK = 1024   # per-block scale granularity of the "1bit" wire


class Bf16(np.ndarray):
    """A bfloat16 blob: a ``uint16`` array of the raw bf16 bits that
    frames under the ``"bfloat16"`` descriptor (see the module
    docstring). Make one with :func:`f32_to_bf16`; read it with
    :func:`bf16_to_f32`."""

    def __array_finalize__(self, obj):
        pass


def f32_to_bf16(arr) -> Bf16:
    """Round to bfloat16, nearest even (a NaN becomes the canonical quiet
    NaN of its sign), as ``ml_dtypes`` does. A float64 input rounds to float32
    first."""
    f = np.ascontiguousarray(np.asarray(arr, np.float32))
    u = f.view(np.uint32)
    bits = ((u + (((u >> 16) & 1) + np.uint32(0x7FFF))) >> 16)
    nan = np.isnan(f)
    if nan.any():
        bits = np.where(nan, ((u >> 16) & np.uint32(0x8000))
                        | np.uint32(0x7FC0), bits)
    return bits.astype(np.uint16).view(Bf16)


def bf16_to_f32(arr) -> np.ndarray:
    """The float32 values of a :class:`Bf16` blob (exact)."""
    u = np.asarray(arr).view(np.uint16).astype(np.uint32) << 16
    return u.view(np.float32)


def as_values(arr, dtype) -> np.ndarray:
    """A received value blob in the table's ``dtype`` (a bf16 blob widens
    exactly, then casts; any other blob casts)."""
    if isinstance(arr, Bf16):
        return bf16_to_f32(arr).astype(dtype, copy=False)
    return np.asarray(arr, dtype)


class ChunkedReply:
    """A streamed get reply: ``meta`` is the FINAL frame's meta (carries
    ``chunks``/``rows``) and ``chunks`` an iterator of ``(chunk_meta,
    chunk_arrays)`` sub-frames. The service sends each sub-frame as
    ``MSG_REPLY_CHUNK`` under the request's msg_id as the iterator yields,
    and closes the stream with an ordinary ``MSG_REPLY_OK`` carrying
    ``meta``; an exception mid-iteration becomes a ``MSG_REPLY_ERR``."""

    __slots__ = ("meta", "chunks")

    def __init__(self, meta: Dict, chunks):
        self.meta, self.chunks = meta, chunks


def to_wire(arr: np.ndarray, wire: str) -> np.ndarray:
    """Single-blob codec for a wire mode ("none" | "bf16"), shared by
    client sends and shard replies."""
    if wire == "bf16":
        return f32_to_bf16(arr)
    return arr


def encode_payload(arr: np.ndarray, wire: str) -> List[np.ndarray]:
    """The ONE place PS payloads are wire-encoded: an array -> the blob
    list that travels in the frame. "none" -> [arr]; "bf16" -> [bf16];
    "1bit" -> [sign bits, per-block scales]; "topk" -> [i32 idx, f32
    vals] of the ~3% largest-|x| entries (the numpy filters of
    ``utils/filters.py``, bit for bit with the JAX package's)."""
    if wire == "1bit":
        from multiverso_tpu_torch.utils import filters
        bits, scales = filters.onebit_encode_np(
            np.asarray(arr, np.float32).reshape(-1), ONEBIT_BLOCK)
        return [bits, scales]
    if wire == "topk":
        from multiverso_tpu_torch.utils import filters
        idx, vals = filters.topk_encode_np(
            np.asarray(arr, np.float32).reshape(-1))
        return [idx, vals]
    return [to_wire(arr, wire)]


def decode_payload(arrays: Sequence[np.ndarray], wire: str,
                   shape: Tuple[int, ...], dtype) -> np.ndarray:
    """Inverse of :func:`encode_payload` (the other endpoint)."""
    if wire == "1bit":
        from multiverso_tpu_torch.utils import filters
        n = int(np.prod(shape, dtype=np.int64))
        flat = filters.onebit_decode_np(np.asarray(arrays[0]),
                                        np.asarray(arrays[1]), n,
                                        ONEBIT_BLOCK)
        return flat.reshape(shape).astype(dtype, copy=False)
    if wire == "topk":
        from multiverso_tpu_torch.utils import filters
        n = int(np.prod(shape, dtype=np.int64))
        flat = filters.topk_decode_np(arrays[0], arrays[1], n)
        return flat.reshape(shape).astype(dtype, copy=False)
    return as_values(arrays[0], dtype).reshape(shape)


def _recv_exact(sock: socket.socket, n: int, *, sof: bool = False
                ) -> memoryview:
    """Read exactly ``n`` bytes. ``sof`` (start-of-frame): a timeout with
    ZERO bytes consumed is an idle socket and re-raises as TimeoutError so
    callers may keep the connection; any timeout after bytes were consumed
    desyncs the framing and is fatal (WireError)."""
    try:
        buf = bytearray(n)
    except MemoryError:
        raise WireError(f"cannot buffer {n}-byte frame") from None
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            r = sock.recv_into(view[got:], n - got)
        except TimeoutError:
            if sof and got == 0:
                raise
            raise WireError("timeout mid-message (framing lost)") from None
        if r == 0:
            raise WireError("peer closed connection mid-message")
        got += r
    return memoryview(buf)


def pack_meta(meta: Dict) -> bytes:
    """Pre-serialize a meta dict (one serialization for a fan-out op)."""
    return json.dumps(meta).encode()


def _descriptor(a: np.ndarray) -> bytes:
    if isinstance(a, Bf16):
        return BF16_NAME.encode()
    # custom dtypes stringify as '<V2', which does NOT round-trip; their
    # registered name does (the JAX package's rule)
    ds = a.dtype.str
    if np.dtype(ds) != a.dtype:
        ds = a.dtype.name
    return ds.encode()


def _frame_parts(msg_type: int, msg_id: int, meta,
                 arrays: Sequence[np.ndarray]) -> List:
    """Frame as a buffer list (header+meta+per-array header, array bodies
    interleaved as zero-copy memoryviews where the layout allows)."""
    meta_b = meta if isinstance(meta, (bytes, bytearray)) else \
        json.dumps(meta).encode()
    parts: List = [None, meta_b]   # header patched once paylen is known
    paylen = len(meta_b)
    for a in arrays:
        bf16 = isinstance(a, Bf16)
        # asarray, not ascontiguousarray: the latter promotes 0-d to 1-d,
        # and the non-contiguous fallback below linearizes via tobytes()
        a = np.asarray(a)
        dt = BF16_NAME.encode() if bf16 else _descriptor(a)
        head = struct.pack(f"<B{len(dt)}sB{a.ndim}q",
                           len(dt), dt, a.ndim, *a.shape)
        try:   # 0-d views can't always export
            body = (a.data.cast("B") if a.flags.c_contiguous
                    else memoryview(a.tobytes()))
        except (ValueError, TypeError):
            body = memoryview(a.tobytes())
        parts.append(head)
        parts.append(body)
        paylen += len(head) + a.nbytes
    parts[0] = _HEADER.pack(MAGIC, msg_type, 0, msg_id, len(meta_b),
                            len(arrays), paylen)
    return parts


def encode(msg_type: int, msg_id: int, meta,
           arrays: Sequence[np.ndarray] = ()) -> bytes:
    return b"".join(bytes(p) if isinstance(p, memoryview) else p
                    for p in _frame_parts(msg_type, msg_id, meta, arrays))


def send(sock: socket.socket, msg_type: int, msg_id: int, meta,
         arrays: Sequence[np.ndarray] = ()) -> None:
    """Send one frame with ``sendmsg`` scatter-gather: array payloads go
    to the kernel straight from their own buffers. ``meta`` may be a dict
    or pre-packed ``pack_meta`` bytes."""
    views = [p if isinstance(p, memoryview) else memoryview(p)
             for p in _frame_parts(msg_type, msg_id, meta, arrays)]
    while views:
        sent = sock.sendmsg(views)
        while views and sent >= len(views[0]):   # drop fully-sent parts
            sent -= len(views[0])
            views.pop(0)
        if views and sent:                        # resume mid-part
            views[0] = views[0][sent:]


def recv(sock: socket.socket) -> Tuple[int, int, Dict, List[np.ndarray]]:
    """Read one message; returns (msg_type, msg_id, meta, arrays).
    Raises TimeoutError (connection still usable) only when the socket was
    idle. Arrays are zero-copy views into the frame buffer."""
    head = _recv_exact(sock, _HEADER.size, sof=True)
    magic, msg_type, _flags, msg_id, metalen, narr, paylen = \
        _HEADER.unpack(head)
    if magic != MAGIC:
        raise WireError(f"bad magic {bytes(magic)!r}")
    if metalen > MAX_META:
        raise WireError(f"meta too large ({metalen} bytes)")
    if paylen < metalen or paylen > MAX_FRAME:
        raise WireError(f"frame length out of bounds ({paylen} bytes)")
    body = _recv_exact(sock, paylen)
    meta, arrays = _parse_body(body, metalen, narr, paylen)
    return msg_type, msg_id, meta, arrays


def parse_frame(frame: bytes) -> Tuple[int, int, Dict, List[np.ndarray]]:
    """Parse one complete frame already in memory (header + body); same
    validation as :func:`recv`. Arrays are views into ``frame``."""
    if len(frame) < _HEADER.size:
        raise WireError("short frame")
    magic, msg_type, _flags, msg_id, metalen, narr, paylen = \
        _HEADER.unpack_from(frame)
    if magic != MAGIC:
        raise WireError(f"bad magic {bytes(magic)!r}")
    if metalen > MAX_META or paylen < metalen or paylen > MAX_FRAME:
        raise WireError("frame length out of bounds")
    body = memoryview(frame)[_HEADER.size:]
    if len(body) != paylen:
        raise WireError(f"frame body {len(body)} != paylen {paylen}")
    meta, arrays = _parse_body(body, metalen, narr, paylen)
    return msg_type, msg_id, meta, arrays


# bound on logical sub-ops per MSG_BATCH frame
MAX_BATCH_OPS = 4096


def pack_batch(subframes: Sequence[bytes]) -> List[np.ndarray]:
    """Pack complete inner frames (each a full :func:`encode` output) as
    the blob list of ONE outer MSG_BATCH / MSG_MULTI frame."""
    if not subframes:
        raise WireError("empty batch")
    if len(subframes) > MAX_BATCH_OPS:
        raise WireError(f"batch of {len(subframes)} sub-ops exceeds "
                        f"MAX_BATCH_OPS ({MAX_BATCH_OPS})")
    return [np.frombuffer(f, np.uint8) for f in subframes]


def unpack_batch(arrays: Sequence[np.ndarray]
                 ) -> List[Tuple[int, Dict, List[np.ndarray]]]:
    """Inverse of :func:`pack_batch`: ``(msg_type, meta, arrays)`` per
    sub-op, in order; sub-arrays are views into the outer frame."""
    if len(arrays) > MAX_BATCH_OPS:
        raise WireError(f"batch of {len(arrays)} sub-ops exceeds "
                        f"MAX_BATCH_OPS ({MAX_BATCH_OPS})")
    out = []
    for blob in arrays:
        msg_type, _mid, meta, arrs = parse_frame(np.ascontiguousarray(blob))
        out.append((msg_type, meta, arrs))
    return out


def peek_msg_id(frame: bytes) -> int:
    """msg_id from a frame whose header is known-sane — lets a server
    send a bound ERR reply even when the BODY fails to parse."""
    if len(frame) < _HEADER.size:
        raise WireError("short frame")
    return _HEADER.unpack_from(frame)[3]


def _parse_body(body, metalen: int, narr: int, paylen: int
                ) -> Tuple[Dict, List[np.ndarray]]:
    try:
        meta = json.loads(bytes(body[:metalen]) or b"{}")
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise WireError(f"malformed meta json: {e}") from None
    arrays: List[np.ndarray] = []
    off = metalen
    try:
        for _ in range(narr):
            (dlen,) = _U8.unpack_from(body, off)
            off += 1
            name = bytes(body[off:off + dlen]).decode()
            bf16 = name == BF16_NAME
            dtype = np.dtype(np.uint16 if bf16 else name)
            off += dlen
            (ndim,) = _U8.unpack_from(body, off)
            off += 1
            shape = struct.unpack_from(f"<{ndim}q", body, off) if ndim else ()
            off += 8 * ndim
            if any(d < 0 for d in shape):
                # a negative dim would make count=-1, which frombuffer
                # reads as "the rest of the buffer"
                raise WireError(f"negative dim in blob shape {shape}")
            count = int(np.prod(shape, dtype=np.int64)) if ndim else 1
            nbytes = count * dtype.itemsize
            if nbytes > MAX_BLOB or off + nbytes > paylen:
                raise WireError(f"blob out of bounds ({nbytes} bytes)")
            a = np.frombuffer(body, dtype=dtype, count=count,
                              offset=off).reshape(shape)
            arrays.append(a.view(Bf16) if bf16 else a)
            off += nbytes
    except (struct.error, ValueError, TypeError, UnicodeDecodeError) as e:
        # TypeError: np.dtype() on a garbage dtype string
        raise WireError(f"malformed frame: {e}") from None
    return meta, arrays
