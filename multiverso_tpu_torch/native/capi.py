"""The port's C ABI, ``libmultiverso.so``, and its C driver (the
counterparts of the JAX package's Makefile targets ``capi`` and
``capi_test``).

:func:`build` compiles ``csrc/mv_capi.cpp`` with the host C++ compiler
(``$CXX``, else ``g++``) at first use into ``build/torch_native/``: the
library's file name hashes the source and the flags, as
``native.library_path`` does, and :func:`library_dir` is a directory
beside it in which the library is ``libmultiverso.so``, the name an
``ffi.load('multiverso')`` (``examples/lua/multiverso.lua``) or a linker's
``-lmultiverso`` looks for. Python's headers and libpython come from
``sysconfig``. A failed build raises ``RuntimeError`` with the compiler's
error output: there is no other way to the C ABI.

:func:`build_driver` compiles ``csrc/mv_capi_test.c`` with ``$CC`` (else
``cc``) against that library and libpython, and :func:`driver_env` is the
environment it runs in: the embedded interpreter takes its prefix from
libpython, which need not be the running interpreter's (a virtual
environment's), so ``PYTHONPATH`` names the repository and this
interpreter's site-packages.

Run ``python -m multiverso_tpu_torch.native.capi`` to build and print the
directory that holds ``libmultiverso.so``; add ``--driver`` to build the C
driver too and print its path on a second line.
"""

from __future__ import annotations

import hashlib
import os
import site
import subprocess
import sys
import sysconfig
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from multiverso_tpu_torch.native import BUILD_DIR, CSRC, CXX_FLAGS
from multiverso_tpu_torch.telemetry import profiler as _profiler

REPO = CSRC.parents[1]
_lock = threading.Lock()


def _python_flags() -> Dict[str, List[str]]:
    """Compile and link flags for Python's C API, from ``sysconfig``:
    ``include`` for the library, ``library`` to link libpython into it
    (empty when libpython is not shared: the process that loads the
    library supplies the symbols), ``executable`` for a C program that
    embeds the interpreter."""
    cv = sysconfig.get_config_var
    ver = cv("LDVERSION") or cv("VERSION")
    extra = (cv("LIBS") or "").split() + (cv("SYSLIBS") or "").split()
    include = [f"-I{sysconfig.get_paths()['include']}"]
    if cv("Py_ENABLE_SHARED"):
        libdir = cv("LIBDIR")
        link = [f"-L{libdir}", f"-lpython{ver}", f"-Wl,-rpath,{libdir}",
                *extra]
        return {"include": include, "library": link, "executable": link}
    static = os.path.join(cv("LIBPL"), f"libpython{ver}.a")
    return {"include": include, "library": [],
            "executable": [static, "-Wl,-E", *extra]}


def _compile(cmd: List[str], out: Path, timeout: int) -> None:
    """Run the compiler command ``cmd`` that builds ``out``; raise with
    the compiler's output when it fails."""
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=timeout)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building {out.name} failed: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(
            f"building {out.name} failed (exit {res.returncode}):\n"
            f"{' '.join(cmd)}\n{res.stderr[-4000:]}")
    _profiler.note_compile(time.perf_counter() - t0)


def _tmp(path: Path) -> Path:
    return path.with_name(
        f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")


def _flags() -> Tuple[List[str], List[str]]:
    """The C ABI's compile flags and its link flags."""
    py = _python_flags()
    return [*CXX_FLAGS, *py["include"], "-pthread"], py["library"]


def library_path() -> Path:
    """Where ``csrc/mv_capi.cpp`` builds to: ``libmultiverso-<hash>.so``,
    the hash over the source and the flags."""
    cflags, lflags = _flags()
    h = hashlib.sha256((CSRC / "mv_capi.cpp").read_bytes())
    h.update(" ".join([*cflags, *lflags]).encode())
    return BUILD_DIR / f"libmultiverso-{h.hexdigest()[:16]}.so"


def build(timeout: int = 300) -> Path:
    """Build the C ABI unless it exists and return the library's path.
    Raises ``RuntimeError`` with the compiler's output on failure."""
    out = library_path()
    with _lock:
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            cflags, lflags = _flags()
            tmp = _tmp(out)
            try:
                _compile([os.environ.get("CXX", "g++"), *cflags, "-o",
                          str(tmp), str(CSRC / "mv_capi.cpp"), *lflags],
                         out, timeout)
                os.replace(tmp, out)
            finally:
                tmp.unlink(missing_ok=True)
        link_dir = out.with_suffix("")
        link = link_dir / "libmultiverso.so"
        if not link.exists():
            link_dir.mkdir(exist_ok=True)
            tmp = _tmp(link)
            os.symlink(os.path.join("..", out.name), tmp)
            os.replace(tmp, link)
    return out


def library_dir() -> Path:
    """A directory in which the built C ABI is ``libmultiverso.so``: put
    it on ``LD_LIBRARY_PATH`` for ``ffi.load('multiverso')``, or pass it
    to a linker's ``-L``."""
    return build().with_suffix("")


def build_driver(timeout: int = 300) -> Path:
    """Build ``csrc/mv_capi_test.c`` against the C ABI and libpython
    unless it exists; return the executable's path. Raises like
    :func:`build`."""
    lib = build(timeout)
    cc = os.environ.get("CC", "cc")
    py = _python_flags()["executable"]
    flags = ["-O1", "-g", "-Wall"]
    h = hashlib.sha256((CSRC / "mv_capi_test.c").read_bytes())
    h.update(" ".join([lib.name, cc, *flags, *py]).encode())
    out = BUILD_DIR / f"mv_capi_test-{h.hexdigest()[:16]}"
    with _lock:
        if not out.exists():
            d = lib.with_suffix("")
            tmp = _tmp(out)
            try:
                _compile([cc, *flags, "-o", str(tmp),
                          str(CSRC / "mv_capi_test.c"), f"-L{d}",
                          "-lmultiverso", f"-Wl,-rpath,{d}", *py, "-lm"],
                         out, timeout)
                os.replace(tmp, out)
            finally:
                tmp.unlink(missing_ok=True)
    return out


def driver_env(platform: Optional[str] = None,
               base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The environment a C program that embeds the interpreter through
    the C ABI runs in: ``PYTHONPATH`` holds the repository and this
    interpreter's site-packages before what ``base`` (default
    ``os.environ``) had; ``MV_CAPI_PLATFORM`` is ``platform`` (``"cpu"``
    puts the tables on the CPU) or, when None, unset: the card."""
    env = dict(os.environ if base is None else base)
    paths = [str(REPO), *site.getsitepackages()]
    if env.get("PYTHONPATH"):
        paths.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(paths)
    env.pop("MV_CAPI_PLATFORM", None)
    if platform is not None:
        env["MV_CAPI_PLATFORM"] = platform
    return env


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    print(library_dir())
    if "--driver" in argv:
        print(build_driver())
    return 0


if __name__ == "__main__":
    sys.exit(main())
