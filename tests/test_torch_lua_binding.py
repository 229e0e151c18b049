"""The Lua binding against the port's C ABI, under a real Lua interpreter
(lupa): the counterpart of tests/test_lua_binding.py.

The unmodified ``examples/lua/multiverso.lua`` is executed with its
``ffi.load('multiverso')`` resolved to the port's ``libmultiverso.so``
(``native/capi.py``), and the reference's Lua test battery (ref
binding/lua/test.lua:1-79) and its XOR demo run through it, with the
tables on the CPU (``MV_CAPI_PLATFORM=cpu``). lupa embeds plain Lua, not
LuaJIT, so ``require('ffi')`` is a ctypes bridge covering the constructs
the binding uses. Without lupa the module skips, as the JAX test does;
the C driver (tests/test_torch_capi.py) calls every symbol either way.
"""

import ctypes
import os
from pathlib import Path

import numpy as np
import pytest

lupa = pytest.importorskip("lupa")

from multiverso_tpu_torch.native import capi  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
LUA = REPO / "examples" / "lua" / "multiverso.lua"


@pytest.fixture(autouse=True)
def _cpu_tables(monkeypatch):
    """The shim's MV_Init starts the port's Zoo in this process (it
    attaches to the running interpreter) on the CPU; stopped after."""
    monkeypatch.setenv("MV_CAPI_PLATFORM", "cpu")
    yield
    from multiverso_tpu_torch.zoo import Zoo
    if Zoo.get().started:
        Zoo.get().stop()


class _CLib:
    """ctypes stand-in for LuaJIT's ``ffi.load`` result: typed MV_*
    callables."""

    def __init__(self, path: str):
        lib = ctypes.CDLL(path)
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int)
        hp = ctypes.POINTER(ctypes.c_void_p)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for n in ("MV_NewArrayTable", "MV_NewAsyncArrayTable"):
            getattr(lib, n).argtypes = [ci, hp]
        for n in ("MV_NewMatrixTable", "MV_NewAsyncMatrixTable"):
            getattr(lib, n).argtypes = [ci, ci, hp]
        for n in ("MV_GetArrayTable", "MV_AddArrayTable",
                  "MV_AddAsyncArrayTable", "MV_GetMatrixTableAll",
                  "MV_AddMatrixTableAll", "MV_AddAsyncMatrixTableAll"):
            getattr(lib, n).argtypes = [vp, fp, ci]
        for n in ("MV_GetMatrixTableByRows", "MV_AddMatrixTableByRows",
                  "MV_AddAsyncMatrixTableByRows"):
            getattr(lib, n).argtypes = [vp, fp, ci, ip, ci]
        self._lib = lib

    def __getattr__(self, name):
        if name.startswith("MV_"):
            return getattr(self._lib, name)
        raise AttributeError(name)


class _FFIShim:
    """The subset of LuaJIT's ffi module that multiverso.lua uses; its
    ``load('multiverso')`` opens ``libmultiverso.so`` from the directory
    the port's build names."""

    def cdef(self, src):
        assert "MV_Init" in src

    def load(self, name):
        assert name == "multiverso"
        return _CLib(str(capi.library_dir() / "libmultiverso.so"))

    def new(self, spec, n=None):
        if spec == "TableHandler[1]":
            return (ctypes.c_void_p * 1)()
        if spec == "float[?]":
            return (ctypes.c_float * int(n))()
        if spec == "int[?]":
            return (ctypes.c_int * int(n))()
        raise NotImplementedError(spec)


def _load_binding():
    rt = lupa.LuaRuntime(unpack_returned_tuples=True)
    rt.globals()["__py_ffi"] = _FFIShim()
    rt.execute("package.preload['ffi'] = function() return __py_ffi end")
    module = rt.execute("return (function()\n" + LUA.read_text()
                        + "\nend)()")
    rt.globals()["__py_mv"] = module
    rt.execute("package.preload['multiverso'] = function()"
               " return __py_mv end")
    return rt, module


def _farray(*vals):
    return (ctypes.c_float * len(vals))(*vals)


def test_lua_array_table_roundtrip():
    """ref test.lua testArray: add twice, read back the doubled range."""
    rt, M = _load_binding()
    M["init"]()
    assert int(M["num_workers"]()) == 1
    size = 64
    t = M["new_array_table"](size)
    delta = _farray(*range(1, size + 1))
    t["add"](t, delta)
    t["add"](t, delta)
    M["barrier"]()
    out = (ctypes.c_float * size)()
    t["get"](t, out)
    np.testing.assert_array_equal(list(out), 2.0 * np.arange(1, size + 1))


def test_lua_async_tables_same_accessor_surface():
    """The async-plane constructors return handles the ordinary accessors
    drive; MV_Barrier flushes the async ops before the read."""
    rt, M = _load_binding()
    M["init"]()
    size = 32
    t = M["new_async_array_table"](size)
    delta = _farray(*range(1, size + 1))
    t["add"](t, delta)
    t["add_async"](t, delta)
    M["barrier"]()
    out = (ctypes.c_float * size)()
    t["get"](t, out)
    np.testing.assert_array_equal(list(out), 2.0 * np.arange(1, size + 1))
    num_row, num_col = 6, 4
    m = M["new_async_matrix_table"](num_row, num_col)
    full = _farray(*([1.0] * (num_row * num_col)))
    m["add"](m, full)
    m["add_async"](m, full)
    M["barrier"]()
    mo = (ctypes.c_float * (num_row * num_col))()
    m["get"](m, mo)
    np.testing.assert_array_equal(list(mo), 2.0)


def test_lua_xor_demo_converges():
    """The reference's Lua demo tier (binding/lua/demos/xor): the MLP's
    parameters live in an ArrayTable behind the shim and the C ABI."""
    rt, _ = _load_binding()
    src = (REPO / "examples" / "lua" / "xor_demo.lua").read_text()
    demo = rt.execute("return (function()\n" + src + "\nend)()")
    final_loss = float(demo["run"](3000, 2.0))
    assert final_loss < 0.05, final_loss


def test_lua_matrix_table_full_and_rows():
    """ref test.lua testMatrix (one worker): a whole-table add and a row
    add; the touched rows read back doubled, the others single."""
    rt, M = _load_binding()
    M["init"]()
    num_row, num_col = 11, 10
    size = num_row * num_col
    t = M["new_matrix_table"](num_row, num_col)
    t["add"](t, _farray(*range(1, size + 1)))
    row_ids = [0, 1, 5, 10]
    rows_c = (ctypes.c_int * len(row_ids))(*row_ids)
    t["add_rows"](t, _farray(*[r * num_col + c + 1 for r in row_ids
                               for c in range(num_col)]),
                  rows_c, len(row_ids))
    M["barrier"]()
    out = (ctypes.c_float * size)()
    t["get"](t, out)
    expect = np.arange(1, size + 1, dtype=np.float64).reshape(num_row,
                                                              num_col)
    expect[row_ids] *= 2
    np.testing.assert_array_equal(
        np.asarray(list(out)).reshape(num_row, num_col), expect)
    out_rows = (ctypes.c_float * (len(row_ids) * num_col))()
    t["get_rows"](t, rows_c, len(row_ids), out_rows)
    np.testing.assert_array_equal(
        np.asarray(list(out_rows)).reshape(len(row_ids), num_col),
        expect[row_ids])
