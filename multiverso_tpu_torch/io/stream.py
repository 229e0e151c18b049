"""URI-dispatched streams (port of ``multiverso_tpu/io/stream.py``).

The reference IO layer
(ref: include/multiverso/io/io.h:24-132 — Stream/StreamFactory/TextReader with
``file://`` vs ``hdfs://`` URI dispatch; the working remote backend was
src/io/hdfs_stream.cpp:1-157). The cloud-storage scheme of the TPU era is
``gs://``; any non-local scheme is dispatched through fsspec, so ``gs://``
(via gcsfs), ``s3://``, ``memory://`` (the fake-FS test backend), etc. all
work through the same factory — the analogue of the reference's pluggable
StreamFactory per URI scheme. Local paths (bare or ``file://``) are
first-class and never touch fsspec.
"""

from __future__ import annotations

import io as _io
import os
from typing import IO, Iterator, Optional


class Stream:
    """Thin binary stream wrapper (ref io.h Stream: Read/Write/Good)."""

    def __init__(self, fileobj: IO[bytes], uri: str):
        self._f = fileobj
        self.uri = uri

    def write(self, data: bytes) -> int:
        return self._f.write(data)

    def read(self, size: int = -1) -> bytes:
        return self._f.read(size)

    def good(self) -> bool:
        return not self._f.closed

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "Stream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # numpy save/load compatibility
    def seek(self, *args):
        return self._f.seek(*args)

    def tell(self):
        return self._f.tell()

    def readinto(self, b):
        return self._f.readinto(b)

    def readline(self, *args):
        return self._f.readline(*args)

    def flush(self):
        return self._f.flush()


def _open_fsspec(uri: str, mode: str) -> IO[bytes]:
    """Remote stream via fsspec (ref src/io/hdfs_stream.cpp — the reference's
    one remote backend; fsspec gives us gs/s3/memory/... through one seam)."""
    try:
        import fsspec
    except ImportError as e:   # the card's machine has no fsspec
        raise NotImplementedError(
            f"{uri!r} needs fsspec for remote schemes (reference analogue: "
            "hdfs:// needed libhdfs)") from e
    fs, path = fsspec.core.url_to_fs(uri)
    if "w" in mode or "a" in mode:
        parent = path.rsplit("/", 1)[0]
        if parent and parent != path:
            try:
                fs.makedirs(parent, exist_ok=True)
            except Exception:
                pass  # flat namespaces (gs buckets) have no real dirs
    return fs.open(path, mode)


def open_stream(uri: str, mode: str = "rb") -> Stream:
    """ref StreamFactory::GetStream (io.h) — dispatch on URI scheme."""
    if "b" not in mode:
        mode += "b"
    if uri.startswith("file://"):
        path = uri[len("file://"):]
    elif "://" in uri:
        return Stream(_open_fsspec(uri, mode), uri)
    else:
        path = uri
    if "w" in mode or "a" in mode:
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
    return Stream(open(path, mode), uri)


class TextReader:
    """Line reader over a Stream (ref io.h TextReader::GetLine)."""

    def __init__(self, uri_or_stream, buf_size: int = 1 << 20):
        if isinstance(uri_or_stream, Stream):
            self._stream = uri_or_stream
        else:
            self._stream = open_stream(uri_or_stream, "rb")
        self._wrapped = _io.TextIOWrapper(
            _io.BufferedReader(self._stream._f, buf_size), encoding="utf-8",
            errors="replace")

    def get_line(self) -> Optional[str]:
        line = self._wrapped.readline()
        return line.rstrip("\n") if line else None

    def __iter__(self) -> Iterator[str]:
        while True:
            line = self.get_line()
            if line is None:
                return
            yield line

    def close(self) -> None:
        self._wrapped.close()
