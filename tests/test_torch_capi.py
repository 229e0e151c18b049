"""Port parity, the C ABI: ``multiverso_tpu_torch/csrc/mv_capi.cpp``
(``libmultiverso.so``), its Python side ``c_api_support.py``, its build
(``native/capi.py``), its C driver ``csrc/mv_capi_test.c`` and the surface
tool ``tools/gen_capi_surface.py``.

* (a) one seeded sequence of ``MV_*`` calls goes through ctypes into the
  JAX package's ``mv_capi.cpp`` (compiled from its source into
  ``tmp_path``) and into the port's library, each in its own process (both
  export the same symbols and each owns a Zoo), on the CPU: an array table
  and a 64 x 8 matrix table, sync and async; whole, row and async adds
  with duplicate row ids; every buffer read back equal bit for bit;
* (b) the port's C driver builds, runs with ``MV_CAPI_PLATFORM=cpu``,
  exits 0 and prints ``MV_CAPI_TEST PASS``;
* (c) the library's ``nm -D`` exports, the ``MV_*`` definitions of the
  port's ``mv_capi.cpp``, the Lua binding's cdef and the JAX
  ``mv_capi.cpp``'s definitions are one surface, signatures included;
* (d) ``gen_capi_surface --check`` passes;
* (e) without ``MV_CAPI_PLATFORM`` and without a card, ``MV_Init``
  reports the missing card and the driver exits non-zero;
* a failed build raises with the compiler's output, and ``barrier``
  flushes every async table, fences, then raises the first flush error.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from multiverso_tpu_torch import c_api_support
from multiverso_tpu_torch.native import capi

REPO = Path(__file__).resolve().parents[1]
JAX_CAPI = REPO / "multiverso_tpu" / "native" / "mv_capi.cpp"
LUA = REPO / "examples" / "lua" / "multiverso.lua"

# one process drives one library through ctypes: argv[1] the library,
# argv[2] the output .npz; the call sequence is seeded and the same for
# both libraries
_DRIVE = r'''
import ctypes, sys
import numpy as np
lib = ctypes.CDLL(sys.argv[1])
fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
hp = ctypes.POINTER(ctypes.c_void_p)
vp, ci = ctypes.c_void_p, ctypes.c_int
for n in ("MV_NewArrayTable", "MV_NewAsyncArrayTable"):
    getattr(lib, n).argtypes = [ci, hp]
for n in ("MV_NewMatrixTable", "MV_NewAsyncMatrixTable"):
    getattr(lib, n).argtypes = [ci, ci, hp]
for n in ("MV_GetArrayTable", "MV_AddArrayTable", "MV_AddAsyncArrayTable",
          "MV_GetMatrixTableAll", "MV_AddMatrixTableAll",
          "MV_AddAsyncMatrixTableAll"):
    getattr(lib, n).argtypes = [vp, fp, ci]
for n in ("MV_GetMatrixTableByRows", "MV_AddMatrixTableByRows",
          "MV_AddAsyncMatrixTableByRows"):
    getattr(lib, n).argtypes = [vp, fp, ci, ip, ci]
lib.MV_Init(None, None)
rng = np.random.default_rng(2026)
out = {"ids": np.array([lib.MV_NumWorkers(), lib.MV_WorkerId(),
                        lib.MV_ServerId()])}
F = lambda a: a.ctypes.data_as(fp)
I = lambda a: a.ctypes.data_as(ip)

def normal(*shape):
    return rng.normal(size=shape).astype(np.float32)

N, R, C = 50, 64, 8
for kind in ("", "Async"):
    h = ctypes.c_void_p()
    getattr(lib, f"MV_New{kind}ArrayTable")(N, ctypes.byref(h))
    for step in range(3):
        lib.MV_AddArrayTable(h, F(normal(N)), N)
        lib.MV_AddAsyncArrayTable(h, F(normal(N)), N)
        lib.MV_Barrier()
        buf = np.zeros(N, np.float32)
        lib.MV_GetArrayTable(h, F(buf), N)
        out[f"{kind}array{step}"] = buf
    m = ctypes.c_void_p()
    getattr(lib, f"MV_New{kind}MatrixTable")(R, C, ctypes.byref(m))
    lib.MV_AddMatrixTableAll(m, F(normal(R, C)), R * C)
    lib.MV_AddAsyncMatrixTableAll(m, F(normal(R, C)), R * C)
    lib.MV_Barrier()
    for step in range(3):
        ids = rng.integers(0, R, 24).astype(np.int32)
        ids[:4] = ids[4]                       # duplicates, always
        lib.MV_AddMatrixTableByRows(m, F(normal(24, C)), 24 * C, I(ids), 24)
        ids2 = rng.integers(0, R, 16).astype(np.int32)
        ids2[8:] = ids2[:8]
        lib.MV_AddAsyncMatrixTableByRows(m, F(normal(16, C)), 16 * C,
                                         I(ids2), 16)
        lib.MV_Barrier()
        rows = np.zeros((24, C), np.float32)
        lib.MV_GetMatrixTableByRows(m, F(rows), 24 * C, I(ids), 24)
        out[f"{kind}rows{step}"] = rows
        whole = np.zeros((R, C), np.float32)
        lib.MV_GetMatrixTableAll(m, F(whole), R * C)
        out[f"{kind}matrix{step}"] = whole
lib.MV_ShutDown()
np.savez(sys.argv[2], **out)
print("DRIVE OK")
'''


def _run_drive(lib: Path, out: Path, env: dict) -> dict:
    res = subprocess.run([sys.executable, "-c", _DRIVE, str(lib), str(out)],
                         env=env, capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert res.returncode == 0 and "DRIVE OK" in res.stdout, \
        res.stderr[-3000:]
    # a Python error inside an MV_* call is printed and cleared by the
    # shim: none may have happened
    assert "Traceback" not in res.stderr, res.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _build_jax_capi(tmp_path: Path) -> Path:
    """The JAX package's C ABI, compiled from its source into tmp_path
    with the port's flags (nothing is built under multiverso_tpu/)."""
    cflags, lflags = capi._flags()
    lib = tmp_path / "jax" / "libmultiverso.so"
    lib.parent.mkdir()
    subprocess.run(["g++", *cflags, "-o", str(lib), str(JAX_CAPI), *lflags],
                   check=True, capture_output=True, timeout=300)
    return lib


def test_capi_matches_the_jax_capi_bit_for_bit(tmp_path):
    """(a) The same MV_* calls into both libraries read back the same
    buffers bit for bit."""
    port_lib = capi.build()
    jax_lib = _build_jax_capi(tmp_path)
    env = dict(os.environ, MV_CAPI_PLATFORM="cpu", MV_CAPI_CPU_DEVICES="1",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]))
    jax_out = _run_drive(jax_lib, tmp_path / "jax.npz", env)
    port_out = _run_drive(port_lib, tmp_path / "port.npz", env)
    assert sorted(jax_out) == sorted(port_out)
    assert len(port_out) == 1 + 2 * 9
    assert list(port_out["ids"]) == [1, 0, 0]
    for k in jax_out:
        assert jax_out[k].dtype == port_out[k].dtype, k
        np.testing.assert_array_equal(port_out[k], jax_out[k], err_msg=k)
    # the sequence did something: every table moved
    assert all(np.abs(v).sum() > 0 for k, v in port_out.items() if k != "ids")


def test_c_driver_passes_on_the_cpu():
    """(b) csrc/mv_capi_test.c against the port's library, the tables on
    the CPU."""
    driver = capi.build_driver()
    res = subprocess.run([str(driver)], env=capi.driver_env("cpu"),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "MV_CAPI_TEST PASS" in res.stdout
    assert "FAIL" not in res.stderr


def test_c_driver_without_a_platform_needs_the_card():
    """(e) MV_CAPI_PLATFORM unset and no card: MV_Init reports the missing
    card (the shim prints the RuntimeError) and the driver fails."""
    driver = capi.build_driver()
    env = capi.driver_env(None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([str(driver)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0
    assert "MV_CAPI_TEST PASS" not in res.stdout
    assert "torch.cuda.is_available() is False" in res.stderr
    assert "MV_CAPI_TEST:" in res.stderr and "failures" in res.stderr


def _normalize_sig(decl: str) -> str:
    """``ret name(args)`` -> ``ret(type,...)``, parameter names dropped
    (``int row_ids[]`` -> ``int[]``), so declarations compare by types."""
    decl = re.sub(r"/\*.*?\*/", " ", decl)
    decl = " ".join(decl.split())
    m = re.match(r"(\w[\w\s\*]*?)\s+MV_\w+\s*\((.*)\)\s*;?$", decl)
    assert m, decl
    ret, args = m.group(1), m.group(2).strip()
    out = []
    for a in (args.split(",") if args and args != "void" else []):
        a = a.strip()
        arr = "[]" if "[" in a else ""
        a = re.sub(r"\[[^\]]*\]", "", a)
        toks = a.replace("*", " * ").split()
        if len(toks) > 1 and re.fullmatch(r"\w+", toks[-1]) \
                and toks[-1] not in ("int", "float", "void", "char"):
            toks = toks[:-1]
        out.append("".join(toks) + arr)
    return f"{ret}({','.join(out)})"


def _cpp_sigs(path: Path) -> dict:
    src = path.read_text()
    return {re.search(r"(MV_\w+)", d).group(1): _normalize_sig(d)
            for d in re.findall(
                r"^\s*(?:void|int|float|double)[\w\s\*]*?\bMV_\w+\s*"
                r"\([^)]*\)(?=\s*\{)", src, re.MULTILINE)}


def _decl_sigs(text: str) -> dict:
    return {re.search(r"(MV_\w+)", d).group(1): _normalize_sig(d)
            for d in re.findall(r"[^;{}/]*\bMV_\w+\s*\([^)]*\)\s*;", text)}


def test_surface_is_one_surface():
    """(c) exports = the port's definitions = the Lua cdef = the JAX
    definitions, by name and by signature; the C driver declares and calls
    every one."""
    lib = capi.build()
    nm = subprocess.run(["nm", "-D", "--defined-only", str(lib)],
                        capture_output=True, text=True, check=True).stdout
    exported = set(re.findall(r"\sT\s+(MV_\w+)", nm))
    port = _cpp_sigs(capi.CSRC / "mv_capi.cpp")
    jax = _cpp_sigs(JAX_CAPI)
    cdef = re.search(r"ffi\.cdef\[\[(.*?)\]\]", LUA.read_text(),
                     re.DOTALL).group(1)
    lua = _decl_sigs(cdef)
    assert len(port) == 19
    assert exported == set(port) == set(lua) == set(jax)
    assert port == jax == lua
    driver = (capi.CSRC / "mv_capi_test.c").read_text()
    head, body = driver.split("END generated ABI declarations")
    assert _decl_sigs(head) == port
    assert set(re.findall(r"\b(MV_\w+)\s*\(", body)) == set(port)


def test_generated_declarations_are_current():
    """(d) The C driver's declaration block is what the surface tool
    generates, and the Lua cdef equals the port's surface."""
    res = subprocess.run(
        [sys.executable, "-m", "multiverso_tpu_torch.tools.gen_capi_surface",
         "--check"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_surface_check_catches_a_drift(tmp_path, monkeypatch):
    """The check fails on a driver whose declarations drifted, and the
    rewrite repairs it without touching the Lua file."""
    from multiverso_tpu_torch.tools import gen_capi_surface as gen
    ctest = tmp_path / "mv_capi_test.c"
    ctest.write_text(gen.CTEST.read_text().replace(
        "void MV_Barrier(void);\n", ""))
    monkeypatch.setattr(gen, "CTEST", ctest)
    lua_before = LUA.read_bytes()
    assert gen.main(["--check"]) == 1
    assert gen.main([]) == 0
    assert ctest.read_text() == gen.render(gen.CTEST, gen.parse_capi())
    assert gen.main(["--check"]) == 0
    assert LUA.read_bytes() == lua_before


def test_library_dir_holds_libmultiverso(tmp_path):
    """The directory ``library_dir`` names holds ``libmultiverso.so``,
    the build's library under the name the Lua shim loads, and ``python
    -m multiverso_tpu_torch.native.capi`` prints that directory."""
    d = capi.library_dir()
    assert (d / "libmultiverso.so").resolve() == capi.build().resolve()
    assert d.parent == capi.BUILD_DIR
    res = subprocess.run([sys.executable, "-m",
                          "multiverso_tpu_torch.native.capi"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == str(d)


def test_failed_build_raises_with_the_compiler_output(tmp_path,
                                                      monkeypatch):
    """No quiet way out: a C ABI that does not compile raises, naming the
    compiler's error."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "mv_capi.cpp").write_text("#include <Python.h>\nint broken(\n")
    monkeypatch.setattr(capi, "CSRC", csrc)
    monkeypatch.setattr(capi, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error"):
        capi.build()
    assert not list((tmp_path / "build").glob("libmultiverso-*"))


class _Flush:
    def __init__(self, exc=None):
        self.exc, self.flushed = exc, 0

    def flush(self):
        self.flushed += 1
        if self.exc is not None:
            raise self.exc


@pytest.mark.parametrize("errors", [0, 1, 3])
def test_barrier_flushes_then_fences_then_raises(monkeypatch, errors):
    """barrier flushes every async table, runs the barrier even when a
    flush raised, then raises the first error chained to the second."""
    excs = [ValueError(f"flush {i}") for i in range(errors)]
    tables = {1: _Flush(), 2: object()}
    tables.update({10 + i: _Flush(e) for i, e in enumerate(excs)})
    fenced = []
    monkeypatch.setattr(c_api_support, "_tables", tables)
    monkeypatch.setattr(c_api_support.mv, "barrier",
                        lambda: fenced.append(1))
    if errors == 0:
        c_api_support.barrier()
    else:
        with pytest.raises(ValueError, match="flush 0") as info:
            c_api_support.barrier()
        assert info.value.__cause__ is (excs[1] if errors > 1 else None)
    assert fenced == [1]
    assert all(t.flushed == 1 for t in tables.values()
               if isinstance(t, _Flush))


def test_support_module_names_no_reference_package():
    """The shim imports the port's support module: a copy of the JAX
    shim's module string would drive the JAX package from the port's
    library."""
    src = (capi.CSRC / "mv_capi.cpp").read_text()
    assert 'PyImport_ImportModule("multiverso_tpu_torch.c_api_support")' \
        in src
    assert json.dumps("multiverso_tpu.c_api_support") not in src
