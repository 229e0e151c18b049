"""Real-text corpus access (port of ``multiverso_tpu/io/realtext.py``).

``data/realtext.txt.gz`` is a committed shard of real English prose (package
documentation and docstrings) normalized like text8: lowercase a-z and
single spaces, ~1.3M tokens. If a text8 file is present (``$MV_TEXT8`` or
``data/text8``), it is preferred.
"""

from __future__ import annotations

import gzip
import os
import tempfile
from typing import List, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SHARD = os.path.join(_REPO, "data", "realtext.txt.gz")


def provenance() -> str:
    if _text8_path():
        return "text8"
    return "realtext (image docs/docstrings, text8-normalized, real English)"


def _text8_path() -> Optional[str]:
    for cand in (os.environ.get("MV_TEXT8", ""),
                 os.path.join(_REPO, "data", "text8")):
        if cand and os.path.exists(cand):
            return cand
    return None


def load_tokens(max_tokens: Optional[int] = None) -> List[str]:
    t8 = _text8_path()
    if t8 is not None:
        with open(t8) as f:
            text = f.read() if max_tokens is None else f.read(
                max_tokens * 12)
    else:
        with gzip.open(_SHARD, "rt") as f:
            text = f.read() if max_tokens is None else f.read(
                max_tokens * 12)
    toks = text.split()
    if max_tokens is not None:
        toks = toks[:max_tokens]
    return toks


def materialize(path: Optional[str] = None) -> str:
    """Decompress the shard to a plain file (for -train_file style CLIs);
    returns the path. Cached across calls; written under a temporary name
    and renamed, so a concurrent reader never sees half a file."""
    t8 = _text8_path()
    if t8 is not None:
        return t8
    path = path or os.path.join(tempfile.gettempdir(), "mv_realtext.txt")
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        tmp = f"{path}.{os.getpid()}.tmp"
        with gzip.open(_SHARD, "rb") as src, open(tmp, "wb") as dst:
            dst.write(src.read())
        os.replace(tmp, path)
    return path
