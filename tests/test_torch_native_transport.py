"""The port's native C++ transport (``multiverso_tpu_torch/ps/native.py``
over ``csrc/mv_ps.cpp``), the counterpart of
``tests/test_native_transport.py``, on the CPU.

A two-rank port world is parametrised over both wire planes (``native``,
the default, and ``python``, ``ps_native`` off). With it: the live native
server, a registered CPU shard, the two planes' results against each
other, against the JAX package (its Python plane) and against numpy,
and the native stats. Then the punt paths (a bf16 wire, a stateful
updater, the sparse stale-row protocol, a checkpoint round trip, a
malformed punted body), the client's errors, mixed worlds in which a JAX
native client meets a port native server and the reverse, the C++ under
the sanitizers, and the native module's ``build_and_load`` and
``parse_libsvm_line`` against the JAX package's.

Tolerances: bit for bit (``assert_array_equal``) for the plain adder and
SGD, whose applies are the same IEEE f32 adds on every plane; rtol 1e-5,
atol 1e-6 for the stateful updaters (XLA's and torch's sqrt and division
differ by a few ulp).
"""

import io
import socket
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from multiverso_tpu import native as jnative_data
from multiverso_tpu.ps import service as jsvc
from multiverso_tpu.ps import tables as jtables
from multiverso_tpu.utils import config as jconfig
from multiverso_tpu_torch import native as tnative_data
from multiverso_tpu_torch.ps import native as tnative
from multiverso_tpu_torch.ps import service as tsvc
from multiverso_tpu_torch.ps import tables as ttables
from multiverso_tpu_torch.ps import wire as twire
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard

STATEFUL_RTOL = 1e-5
STATEFUL_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _flags():
    for cfg in (tconfig, jconfig):
        cfg.set_flag("ps_timeout", 10.0)
        cfg.set_flag("ps_connect_timeout", 3.0)
    # the JAX reference world runs its Python plane unless a test asks
    jconfig.set_flag("ps_native", False)
    yield
    tconfig.reset_flags()
    TDashboard.reset()


def _port_world(directory, native=True, n=2):
    tconfig.set_flag("ps_native", native)
    rdv = tsvc.FileRendezvous(str(directory))
    return [tsvc.PSContext(r, n, tsvc.PSService(r, n, rdv), device="cpu")
            for r in range(n)]


def _jax_world(directory, n=2):
    rdv = jsvc.FileRendezvous(str(directory))
    return [jsvc.PSContext(r, n, jsvc.PSService(r, n, rdv))
            for r in range(n)]


def _close(ctxs):
    for c in ctxs:
        c.close()


@pytest.fixture(params=["native", "python"])
def two_ranks(request, tmp_path):
    """Two port ranks on the CPU, on the native or the Python plane."""
    ctxs = _port_world(tmp_path / "rdv", native=request.param == "native")
    yield request.param, ctxs
    _close(ctxs)


@pytest.fixture
def native_ranks(tmp_path):
    ctxs = _port_world(tmp_path / "rdv")
    yield ctxs
    _close(ctxs)


def test_library_builds_from_the_port_source():
    assert tnative.available()
    path = tnative.library_path()
    assert path.exists() and path.parent == tnative_data.BUILD_DIR
    assert path.name.startswith("libmv_ps-")
    assert "multiverso_tpu/native" not in str(path)


# ---------------------------------------------------------------------- #
# both planes
# ---------------------------------------------------------------------- #
def test_native_server_is_live(two_ranks):
    plane, ctxs = two_ranks
    native = plane == "native"
    assert (ctxs[0].service._native is not None) == native
    t = ttables.AsyncMatrixTable(10, 4, name="nl", ctx=ctxs[0])
    assert t._native_ok == native
    assert (t._shard._native_ref is not None) == native


def test_health_reports_the_native_server(two_ranks):
    plane, ctxs = two_ranks
    t0 = ttables.AsyncMatrixTable(4, 2, name="hl", ctx=ctxs[0])
    ttables.AsyncMatrixTable(4, 2, name="hl", ctx=ctxs[1])
    assert t0.server_health()["native"] is (plane == "native")
    assert t0.server_health(1)["native"] is (plane == "native")
    ctxs[1].service.close()
    # a closed service keeps reporting what it ran (the raw handle stays)
    assert ctxs[1].service.health_payload()["native"] is (plane == "native")


def _ab_script(tabs, arrays):
    """A seeded op sequence through two ranks' tables; returns what the
    gets read. ``tabs`` are (AsyncMatrixTable, AsyncMatrixTable),
    ``arrays`` the AsyncArrayTable pair."""
    t0, t1 = tabs
    rng = np.random.default_rng(0)
    out = []
    for _ in range(5):
        ids = rng.choice(12, size=4, replace=False)
        t0.add_rows(ids, rng.normal(size=(4, 3)).astype(np.float32))
        t1.add_rows(ids[::-1], np.ones((4, 3), np.float32))
    t1.add(np.full((12, 3), 0.25, np.float32))
    mids = [t0.add_rows_async([i, 11 - i],
                              rng.normal(size=(2, 3)).astype(np.float32))
            for i in range(6)]
    for m in mids:
        t0.wait(m)
    out += [t0.get(), t1.get_rows(np.arange(12)), t1.get_rows([3, 9, 3])]
    t1.set_rows([0, 11], np.full((2, 3), 0.5, np.float32))
    out += [t0.get_rows([0, 5, 11])]
    arrays[0].add(np.arange(8, dtype=np.float32) / 7)
    arrays[1].add(np.ones(8, np.float32))
    out += [arrays[1].get()]
    return out


def _numpy_ab():
    rng = np.random.default_rng(0)
    m = np.zeros((12, 3), np.float32)
    out = []
    for _ in range(5):
        ids = rng.choice(12, size=4, replace=False)
        m[ids] += rng.normal(size=(4, 3)).astype(np.float32)
        m[ids[::-1]] += np.ones((4, 3), np.float32)
    m += np.float32(0.25)
    for i in range(6):
        m[[i, 11 - i]] += rng.normal(size=(2, 3)).astype(np.float32)
    out += [m.copy(), m.copy(), m[[3, 9, 3]]]
    m[[0, 11]] = 0.5
    out += [m[[0, 5, 11]]]
    a = np.arange(8, dtype=np.float32) / 7
    out += [a + np.float32(1.0)]
    return out


def _ab_tables(mod, ctxs, name):
    tabs = [mod.AsyncMatrixTable(12, 3, name=name, ctx=c) for c in ctxs]
    arrs = [mod.AsyncArrayTable(8, name=name + "_a", ctx=c) for c in ctxs]
    return tabs, arrs


def test_planes_equal_jax_and_numpy_bit_for_bit(two_ranks, tmp_path):
    """The op sequence on either port plane reads back exactly what the
    JAX package's Python plane and a numpy model read."""
    plane, ctxs = two_ranks
    tabs, arrs = _ab_tables(ttables, ctxs, "ab")
    assert tabs[0]._native_ok == (plane == "native")
    got = _ab_script(tabs, arrs)
    jctxs = _jax_world(tmp_path / "jax")
    try:
        want = _ab_script(*_ab_tables(jtables, jctxs, "ab"))
    finally:
        _close(jctxs)
    for g, w, n in zip(got, want, _numpy_ab()):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, n)


def test_ab_python_plane_equivalence(tmp_path):
    """The same op sequence through the native plane and the pure-Python
    plane leaves the same bytes, and the SGD updater's too."""
    results = {}
    for native in (True, False):
        ctxs = _port_world(tmp_path / f"rdv{int(native)}", native=native)
        try:
            tabs, arrs = _ab_tables(ttables, ctxs, "ab")
            s = [ttables.AsyncMatrixTable(6, 2, updater="sgd", name="sg",
                                          ctx=c) for c in ctxs]
            assert s[0]._shard._np_mode
            assert (s[0]._shard._native_ref is not None) == native
            s[1].add_rows([0, 5], np.full((2, 2), 0.3, np.float32))
            s[0].add(np.full((6, 2), 0.1, np.float32))
            results[native] = _ab_script(tabs, arrs) + [s[0].get()]
        finally:
            _close(ctxs)
    for a, b in zip(results[True], results[False]):
        np.testing.assert_array_equal(a, b)
    sgd = np.zeros((6, 2), np.float32)
    sgd[[0, 5]] -= np.float32(0.3)
    sgd -= np.float32(0.1)
    np.testing.assert_array_equal(results[True][-1], sgd)


def test_native_stats_count_served_ops(two_ranks):
    plane, ctxs = two_ranks
    t0 = ttables.AsyncMatrixTable(10, 2, name="ns", ctx=ctxs[0])
    ttables.AsyncMatrixTable(10, 2, name="ns", ctx=ctxs[1])
    t0.add_rows([0, 1], np.ones((2, 2), np.float32))   # shard 0 add
    t0.add(np.ones((10, 2), np.float32))               # both shards
    st = t0._shard.stats()
    assert st["version"] == 2   # two applied mutations on either plane
    if plane == "native":
        # C++ counts the row add and the whole-shard add alike
        assert t0._shard.stat_adds == st["adds"] == st["applies"] == 2
        assert t0._shard._stat_adds == 0   # the Python path untouched
        assert st["native_applies"] == 2
    else:
        # the Python plane counts row adds only, as the JAX package's
        assert t0._shard.stat_adds == st["adds"] == st["applies"] == 1
        assert st["native_applies"] == 0


# ---------------------------------------------------------------------- #
# the punt paths
# ---------------------------------------------------------------------- #
def test_bf16_wire_punts_and_works(native_ranks, tmp_path):
    """bf16 payloads cannot be served natively: they punt to the Python
    handler under the native shard mutex, and read back as the JAX
    package's bf16 wire does."""
    t0 = ttables.AsyncMatrixTable(10, 4, name="pw", wire="bf16",
                                  ctx=native_ranks[0])
    t1 = ttables.AsyncMatrixTable(10, 4, name="pw", wire="bf16",
                                  ctx=native_ranks[1])
    assert not t0._native_ok                     # client: python conns
    assert t1._shard._native_ref is not None     # server: native
    vals = np.random.default_rng(2).normal(size=(2, 4)).astype(np.float32)
    t0.add_rows([7, 8], vals)                    # remote owner, punted
    got = t1.get_rows([7, 8])
    assert t1._shard._stat_adds == 1             # applied in Python
    jctxs = _jax_world(tmp_path / "jax")
    try:
        j = [jtables.AsyncMatrixTable(10, 4, name="pw", wire="bf16",
                                      ctx=c) for c in jctxs]
        j[0].add_rows([7, 8], vals)
        np.testing.assert_array_equal(got, j[1].get_rows([7, 8]))
    finally:
        _close(jctxs)


def test_stateful_updater_punts(native_ranks, tmp_path):
    """AdaGrad shards are not linear: every op punts through the C++
    conn threads to the Python handler, and agrees with the JAX
    package's AdaGrad within the stateful tolerance."""
    ops = [([2, 7], np.ones((2, 4), np.float32)),
           ([7, 9], np.full((2, 4), 0.5, np.float32))]

    def run(mod, ctxs):
        ts = [mod.AsyncMatrixTable(10, 4, name="pa", updater="adagrad",
                                   ctx=c) for c in ctxs]
        for ids, v in ops:
            ts[0].add_rows(ids, v)
        return ts, ts[1].get_rows([2, 7, 9])

    ts, got = run(ttables, native_ranks)
    assert ts[0]._shard._native_ref is None and ts[0]._native_ok
    assert np.all(got < 0)   # adagrad: w -= lr * g / sqrt(g2 + eps)
    jctxs = _jax_world(tmp_path / "jax")
    try:
        _, want = run(jtables, jctxs)
    finally:
        _close(jctxs)
    np.testing.assert_allclose(got, want, rtol=STATEFUL_RTOL,
                               atol=STATEFUL_ATOL)


def test_sparse_protocol_over_native_server(native_ranks):
    """The stale-row protocol with C++ serving both shards: adds set dirty
    bits in C, sparse gets read and clear them and reply [mask, stale
    rows] in C — the wire the Python server speaks."""
    t0 = ttables.AsyncSparseMatrixTable(10, 4, name="psp",
                                        ctx=native_ranks[0])
    t1 = ttables.AsyncSparseMatrixTable(10, 4, name="psp",
                                        ctx=native_ranks[1])
    assert t0._shard._native_ref is not None   # dirty bits live in C++
    assert not t0._native_ok                    # client: python conns
    ids = np.array([1, 6])
    np.testing.assert_array_equal(t1.get_rows_sparse(ids, worker_id=1),
                                  np.zeros((2, 4), np.float32))
    assert t1.last_transfer_rows == 2          # first pull: all stale
    again = t1.get_rows_sparse(ids, worker_id=1)
    assert t1.last_transfer_rows == 0 and again.shape == (2, 4)
    t0.add_rows([6], np.ones((1, 4), np.float32))
    t1.add_rows([1], np.full((1, 4), 3.0, np.float32))
    t0.flush(), t1.flush()
    got = t1.get_rows_sparse(ids, worker_id=1)
    assert t1.last_transfer_rows == 2          # both rows re-dirtied
    want = np.array([[3.0] * 4, [1.0] * 4], np.float32)
    np.testing.assert_array_equal(got, want)
    got0 = t0.get_rows_sparse(ids, worker_id=0)   # per-worker bits
    assert t0.last_transfer_rows == 2
    np.testing.assert_array_equal(got0, want)


def test_sparse_get_served_natively_not_punted(native_ranks):
    t0 = ttables.AsyncSparseMatrixTable(8, 2, name="psn",
                                        ctx=native_ranks[0])
    t1 = ttables.AsyncSparseMatrixTable(8, 2, name="psn",
                                        ctx=native_ranks[1])
    calls = []
    orig = t0._shard.handle

    def spy(*a, **k):
        calls.append(a[0])
        return orig(*a, **k)

    native_ranks[0].service.register_handler("psn", spy, shard=t0._shard)
    t1.get_rows_sparse(np.array([0, 1]), worker_id=1)   # rank 0's rows
    t1.add_rows([0], np.ones((1, 2), np.float32))
    t1.flush()
    got = t1.get_rows_sparse(np.array([0, 1]), worker_id=1)
    np.testing.assert_array_equal(got, [[1.0, 1.0], [0.0, 0.0]])
    assert calls == []   # everything served in C++


def test_checkpoint_roundtrip_over_native(native_ranks, tmp_path):
    """store/load and the per-shard checkpoint punt (GET_STATE, SET_ROWS,
    SET_STATE); the restore copies in place, so the shard's tensor — the
    pointer C++ holds — stays the same one."""
    t0 = ttables.AsyncMatrixTable(10, 4, name="ck", ctx=native_ranks[0])
    t1 = ttables.AsyncMatrixTable(10, 4, name="ck", ctx=native_ranks[1])
    vals = np.arange(40, dtype=np.float32).reshape(10, 4) / 3
    t0.add_rows(np.arange(10), vals)
    want = t0.get()
    np.testing.assert_array_equal(want, vals)
    buf = io.BytesIO()
    t0.store(buf)
    ptr = t1._shard._data.data_ptr()
    meta, arrays = t1._shard.checkpoint_state()
    t0.add(np.ones((10, 4), np.float32))     # diverge
    t1._shard.restore_checkpoint(meta, arrays)
    assert t1._shard._data.data_ptr() == ptr
    np.testing.assert_array_equal(t0.get_rows(np.arange(5, 10)), vals[5:])
    assert t1._shard.stats()["version"] == meta["version"]
    t0.add(np.ones((10, 4), np.float32))
    buf.seek(0)
    t0.load(buf)
    np.testing.assert_array_equal(t0.get(), want)
    assert t1._shard._data.data_ptr() == ptr


def test_malformed_punted_body_gets_fast_err_reply(native_ranks):
    """A frame whose header is sane but whose body does not parse is
    punted by C++ and comes back as a fast ERR reply bound to the
    header's msg id (dropping it would park the peer for ps_timeout)."""
    host, port = native_ranks[0].service.addr.rsplit(":", 1)
    s = socket.create_connection((host, int(port)), timeout=10)
    try:
        bad = b"{definitely not json"
        frame = twire._HEADER.pack(twire.MAGIC, 0x7F, 0, 42, len(bad), 0,
                                   len(bad)) + bad
        t0 = time.monotonic()
        s.sendall(frame)
        msg_type, msg_id, meta, _ = twire.recv(s)
        assert msg_type == tsvc.MSG_REPLY_ERR and msg_id == 42
        assert "WireError" in meta.get("error", "")
        assert time.monotonic() - t0 < 5.0
    finally:
        s.close()


# ---------------------------------------------------------------------- #
# the client's errors
# ---------------------------------------------------------------------- #
def test_out_of_shard_get_errors_cleanly(native_ranks):
    """A C++-served error reply surfaces as NativeConnError with the
    server's message and leaves the connection usable."""
    ttables.AsyncMatrixTable(10, 2, name="er", ctx=native_ranks[0])
    conn = tnative.NativeConn(native_ranks[0].service.addr, 5.0, 10.0)
    try:
        meta_b = b'{"table": "er"}'
        out = np.empty((1, 2), np.float32)
        mid = conn.get_send(tsvc.MSG_GET_ROWS, meta_b,
                            np.array([99], np.int64), out)
        with pytest.raises(tnative.NativeConnError, match="outside shard"):
            conn.get_wait(mid, 10.0)
        mid = conn.get_send(tsvc.MSG_GET_ROWS, meta_b,
                            np.array([1], np.int64), out)
        conn.get_wait(mid, 10.0)
        np.testing.assert_array_equal(out, np.zeros((1, 2), np.float32))
    finally:
        conn.close()


def test_dead_peer_surfaces_pspeererror(tmp_path):
    ctxs = _port_world(tmp_path / "rdv")
    try:
        t0 = ttables.AsyncMatrixTable(10, 2, name="dp", ctx=ctxs[0])
        ttables.AsyncMatrixTable(10, 2, name="dp", ctx=ctxs[1])
        t0.add_rows([7], np.ones((1, 2), np.float32))   # warm the conn
        ctxs[1].close()                                 # "kill" rank 1
        with pytest.raises(tsvc.PSPeerError):
            for _ in range(20):   # the first failure may land either way
                t0.add_rows([7], np.ones((1, 2), np.float32))
    finally:
        ctxs[0].close()


# ---------------------------------------------------------------------- #
# mixed worlds: one JAX rank and one port rank, both native
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("client", ["jax", "torch"])
def test_mixed_world_native_both_ways(tmp_path, client):
    """Rank 0 is a JAX service, rank 1 a port service on the CPU, both on
    the native plane. ``client`` drives every op, so its native client
    meets the other package's native server on that server's shard: the
    reads equal numpy bit for bit, and the served shard counts the ops as
    natively applied."""
    jconfig.set_flag("ps_native", True)
    tconfig.set_flag("ps_native", True)
    rdv = str(tmp_path / "rdv")
    jctx = jsvc.PSContext(0, 2, jsvc.PSService(0, 2,
                                               jsvc.FileRendezvous(rdv)))
    tctx = tsvc.PSContext(1, 2, tsvc.PSService(1, 2,
                                               tsvc.FileRendezvous(rdv)),
                          device="cpu")
    try:
        jt = jtables.AsyncMatrixTable(10, 3, name="mx", ctx=jctx)
        tt = ttables.AsyncMatrixTable(10, 3, name="mx", ctx=tctx)
        assert jt._native_ok and tt._native_ok
        assert jt._shard._native_ref is not None
        assert tt._shard._native_ref is not None
        drive, served = (jt, tt) if client == "jax" else (tt, jt)
        rng = np.random.default_rng(6)
        want = np.zeros((10, 3), np.float32)
        for _ in range(4):
            ids = rng.choice(10, size=5, replace=False)
            v = rng.normal(size=(5, 3)).astype(np.float32)
            drive.add_rows(ids, v)
            want[ids] += v
        d = rng.normal(size=(10, 3)).astype(np.float32)
        drive.add(d)
        want += d
        np.testing.assert_array_equal(drive.get_rows(np.arange(10)), want)
        np.testing.assert_array_equal(drive.get(), want)
        np.testing.assert_array_equal(served.get(), want)
        st = served._shard.stats()
        assert st["adds"] == 5 and served._shard._stat_adds == 0
    finally:
        tctx.close()
        jctx.close()


# ---------------------------------------------------------------------- #
# the C++ under the sanitizers
# ---------------------------------------------------------------------- #
def test_smoke_under_sanitizers(tmp_path):
    """csrc/mv_ps_smoke.cpp drives every entry point of the port's
    mv_ps.cpp through real sockets and threads; built under
    address+undefined and under thread sanitizers (two binaries, the
    sanitizers exclude each other), both runs assert values and exit 0."""
    csrc = tnative_data.CSRC
    src = [str(csrc / "mv_ps.cpp"), str(csrc / "mv_ps_smoke.cpp")]
    base = ["g++", "-O1", "-g", "-std=c++17", "-Wall",
            "-fno-omit-frame-pointer", "-pthread"]
    builds = {"asan": ["-fsanitize=address,undefined"],
              "tsan": ["-fsanitize=thread"]}

    def build(name):
        out = str(tmp_path / f"mv_ps_smoke_{name}")
        subprocess.run(base + builds[name] + ["-o", out] + src, check=True,
                       capture_output=True, timeout=240)
        return out

    with ThreadPoolExecutor(2) as ex:
        bins = list(ex.map(build, builds))
    for b in bins:
        res = subprocess.run([b], capture_output=True, text=True,
                             timeout=120)
        assert res.returncode == 0, res.stderr[-2000:]
        assert "mv_ps_smoke OK" in res.stdout


# ---------------------------------------------------------------------- #
# the native module: build_and_load and parse_libsvm_line
# ---------------------------------------------------------------------- #
def test_build_and_load_hashes_source_and_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative_data, "BUILD_DIR", tmp_path / "build")
    lib = tnative_data.build_and_load("libmv_ps", "mv_ps.cpp",
                                      ("-pthread",))
    assert lib is not None and hasattr(lib, "mvps_server_new")
    path = tnative_data.library_path("libmv_ps", "mv_ps.cpp",
                                     ("-pthread",))
    assert path.exists() and path.parent == tmp_path / "build"
    assert not list(path.parent.glob("*.tmp"))   # renamed into place
    assert path != tnative_data.library_path("libmv_ps", "mv_ps.cpp")
    assert path != tnative_data.library_path("libmv_data", "mv_data.cpp",
                                             ("-pthread",))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert tnative_data.build_and_load("libmv_ps", "mv_ps.cpp",
                                       ("-DX=1",)) is None
    # an existing library loads without the compiler
    assert tnative_data.build_and_load("libmv_ps", "mv_ps.cpp",
                                       ("-pthread",)) is not None


_LIBSVM = [b"1 0:0.5 3:2.25 7:-1e-3", b"-1 2:1", b"+1 1:3.5",
           b"0", b"  \t", b"", b"# a comment", b"   # indented comment",
           b"1 4:1.5 junk 5:2", b"1 99:4 -3:2 2:1", b"2 0:1 0:2",
           b"1 3:", b"1 3:x", b"notalabel 1:2", b"1 1:2\n",
           b"7 1:1e40 2:-0.0 6:5"]


@pytest.mark.parametrize("line", _LIBSVM)
def test_parse_libsvm_line_matches_jax(line):
    got = tnative_data.parse_libsvm_line(line, 8)
    want = jnative_data.parse_libsvm_line(line, 8)
    if want is None:
        assert got is None
        return
    assert got[0] == want[0]
    assert got[1].dtype == want[1].dtype == np.float32
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].tobytes() == want[1].tobytes()   # -0.0 and inf too
