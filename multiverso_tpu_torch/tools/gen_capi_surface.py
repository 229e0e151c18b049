#!/usr/bin/env python
"""Regenerate the port's C driver's declarations from its C ABI, the one
source of truth, ``multiverso_tpu_torch/csrc/mv_capi.cpp``.

It parses the ``extern "C"`` ``MV_*`` definitions there and rewrites the
declaration block of ``csrc/mv_capi_test.c`` (between its ``BEGIN``/``END
generated ABI declarations`` markers), so the driver cannot drift from
the library. The Lua binding, ``examples/lua/multiverso.lua``, binds the
same surface through its ``ffi.cdef[[...]]`` block: this tool reads that
block and holds it equal to the surface, but never rewrites the file.

    python -m multiverso_tpu_torch.tools.gen_capi_surface          # rewrite
    python -m multiverso_tpu_torch.tools.gen_capi_surface --check  # verify

``--check`` exits 1 when either mirror differs from what the surface
generates; without it the C driver is rewritten and a Lua cdef that
differs still exits 1 (it has to be edited by hand).
"""

from __future__ import annotations

import os
import re
import sys
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
_REPO = _PKG.parent
CAPI = _PKG / "csrc" / "mv_capi.cpp"
CTEST = _PKG / "csrc" / "mv_capi_test.c"
LUA = _REPO / "examples" / "lua" / "multiverso.lua"

_BEGIN = ("/* BEGIN generated ABI declarations "
          "(multiverso_tpu_torch/tools/gen_capi_surface.py) */")
_END = "/* END generated ABI declarations */"


def parse_capi(path: Path = CAPI):
    """(ret, name, [param, ...]) for every ``extern "C"`` ``MV_*``
    definition, in source order. Commented-out parameter names
    (``int* /*argc*/``) come back as names. A looser scan cross-checks
    the strict pattern: an ``MV_`` definition the strict one misses
    raises instead of vanishing from the generated declarations."""
    src = path.read_text()
    out = []
    for m in re.finditer(
            r"^((?:const\s+)?(?:unsigned\s+|signed\s+)?\w+(?:\s+\w+)?"
            r"(?:\s*\*+)?)\s*(MV_\w+)\s*\(([^)]*)\)\s*\{",
            src, re.MULTILINE | re.DOTALL):
        ret, name, raw = " ".join(m.group(1).split()), m.group(2), m.group(3)
        params = []
        for p in raw.split(",") if raw.strip() else []:
            p = re.sub(r"/\*\s*(\w+)\s*\*/", r"\1", p)   # /*argc*/ -> argc
            params.append(" ".join(p.split()))
        out.append((ret, name, params))
    loose = set(re.findall(r"^[ \t]*[\w\*&: \t]+?\b(MV_\w+)\s*\([^)]*\)\s*\{",
                           src, re.MULTILINE | re.DOTALL))
    missed = sorted(loose - {name for _, name, _ in out})
    if missed:
        raise SystemExit(
            f"{path}: MV_ definitions {missed} match the loose scan but not "
            "the strict return-type pattern; extend parse_capi's pattern")
    if not out:
        raise SystemExit(f"no extern-C MV_* definitions found in {path}")
    return out


def _decl(ret, name, params, empty="") -> str:
    args = ", ".join(params) if params else empty
    pad = " " if ret == "void" else "  "
    return f"{ret}{pad}{name}({args});"


def lua_cdef_block(surface) -> str:
    lines = ["typedef void* TableHandler;"]
    lines += [_decl(*f) for f in surface]
    return "\n" + "\n".join(lines) + "\n"


def c_decl_block(surface) -> str:
    # C, unlike C++, needs (void) to declare a prototype with no arguments
    return "\n".join(_decl(r, n, p, empty="void") for r, n, p in surface)


def render(path: Path, surface) -> str:
    """``path``'s text with its generated block as ``surface`` makes it."""
    src = path.read_text()
    if path.suffix == ".lua":
        return re.sub(r"(ffi\.cdef\[\[).*?(\]\])",
                      lambda m: m.group(1) + lua_cdef_block(surface)
                      + m.group(2),
                      src, count=1, flags=re.DOTALL)
    begin, end = src.index(_BEGIN), src.index(_END)
    return (src[:begin + len(_BEGIN)] + "\n" + c_decl_block(surface)
            + "\n" + src[end:])


def main(argv) -> int:
    check = "--check" in argv
    surface = parse_capi()
    stale = []
    want = render(CTEST, surface)
    if CTEST.read_text() != want:
        if check:
            stale.append(CTEST)
        else:
            CTEST.write_text(want)
            print(f"regenerated: {os.path.relpath(CTEST, _REPO)}")
    if LUA.read_text() != render(LUA, surface):
        stale.append(LUA)   # read, never rewritten
    if stale:
        print("generated ABI mirrors differ from csrc/mv_capi.cpp: "
              f"{[os.path.relpath(p, _REPO) for p in stale]} (the C driver "
              "regenerates without --check; the Lua cdef is edited by "
              "hand)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
