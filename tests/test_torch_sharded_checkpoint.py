"""Port parity, the sharded checkpoint: ``checkpoint.save(...,
backend="orbax", block=True|False)``, its ``restore``, ``wait_pending``
and ``latest``, against the JAX package's orbax backend on its 8-device
test mesh (``tests/test_bindings.py`` TestCheckpoint's six orbax cases,
each run in both packages side by side).

* save and restore, updater state included, for ``default``, ``sgd``,
  ``adagrad``, ``momentum_sgd`` and ``adam``: both packages take the same
  seeded numpy adds (equal bit for bit for the default updater and SGD,
  the stateful ones within rtol 1e-5 / atol 1e-6: ROADMAP C.4); the
  port's state is then loaded into the JAX tables (the stream format,
  bit for bit), and after each package's round trip, with other adds
  between save and restore, the port's Gets and updater-state leaves
  equal the JAX package's bit for bit; the next add from the restored
  state agrees as the trained states did;
* ``file://`` URIs, with the arrays under the tag; tables added since
  the save are left as they are; an asynchronous save is visible only
  after ``wait_pending``; a restore finalizes a save in flight; a stream
  save finalizes a pending sharded one;
* the port's own: a failed write is discarded (no manifest, no marker)
  and raised; the staged gauge counts the table's block and returns to
  0; a JAX-written orbax tag is refused, and the JAX restore of the
  port's tag fails (ROADMAP C.27); a renamed table or another shape
  raises.

The row counts are one short of a multiple of 8, so the one-process port
and the JAX package on 8 devices pad every table alike.
"""

import io
import json
import os
import threading

import numpy as np
import pytest

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu import checkpoint as jck
from multiverso_tpu.updaters import AddOption as JAddOption
from multiverso_tpu_torch import checkpoint as tck
from multiverso_tpu_torch.updaters import AddOption as TAddOption
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard
from multiverso_tpu_torch.zoo import Zoo as TZoo

UPDATERS = ["default", "sgd", "adagrad", "momentum_sgd", "adam"]
EXACT = ("default", "sgd")
RTOL, ATOL = 1e-5, 1e-6   # stateful updaters across packages (C.4)
OPT = dict(momentum=0.9, learning_rate=0.1, rho=0.1)
PKGS = {"jax": (jmv, jck, JAddOption), "torch": (tmv, tck, TAddOption)}


def _stop_port():
    try:
        tck.wait_pending()
    finally:
        zoo = TZoo.get()
        if zoo.started:
            zoo.stop()
        tconfig.reset_flags()
        TDashboard.reset()


@pytest.fixture
def both():
    """The JAX package on its 8-device mesh, the port on the CPU."""
    jmv.init()
    tmv.init(device="cpu")
    yield
    _stop_port()


@pytest.fixture
def port():
    tmv.init(device="cpu")
    yield
    _stop_port()


def _tables(pkg, updater):
    return [pkg.ArrayTable(63, updater=updater, name="arr"),
            pkg.MatrixTable(15, 4, updater=updater, name="mat"),
            pkg.KVTable(name="kv"),
            pkg.SparseMatrixTable(7, 3, updater=updater, name="sp")]


def _train(tables, opt_cls, seed):
    rng = np.random.default_rng(seed)
    arr, mat, kv, sp = tables
    for _ in range(2):
        arr.add(rng.normal(size=63).astype(np.float32), opt_cls(**OPT))
        mat.add_rows(np.array([1, 5, 14, 5]),
                     rng.normal(size=(4, 4)).astype(np.float32),
                     opt_cls(**OPT))
        sp.add_rows(np.array([0, 6]),
                    rng.normal(size=(2, 3)).astype(np.float32),
                    opt_cls(**OPT))
    kv.add([3, 9, 3], [1, 2, 5])


def _stored(t):
    """A table's stored arrays, as its ``store`` writes them: the padded
    data, then each updater-state leaf."""
    buf = io.BytesIO()
    t.store(buf)
    buf.seek(0)
    data = np.load(buf)
    return [data] + [np.load(buf) for _ in range(int(np.load(buf)))]


def _state(tables):
    """Each array table's stored arrays, and the KV table's map."""
    arr, mat, kv, sp = tables
    return [_stored(arr), _stored(mat),
            {int(k): float(v) for k, v in kv.get().items()}, _stored(sp)]


def _same(a, b, updater=None):
    """Two :func:`_state`s: bit for bit, or within C.4's tolerance for a
    stateful ``updater``."""
    for x, y in zip(a, b):
        if isinstance(x, dict):
            assert x == y
            continue
        assert len(x) == len(y)
        for u, v in zip(x, y):
            assert u.shape == v.shape
            if updater is None or updater in EXACT:
                np.testing.assert_array_equal(u, v)
            else:
                np.testing.assert_allclose(u, v, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("updater", UPDATERS)
def test_save_restore_orbax_backend(both, tmp_path, updater):
    tt, jt = _tables(tmv, updater), _tables(jmv, updater)
    _train(tt, TAddOption, 0)
    _train(jt, JAddOption, 0)
    _same(_state(tt), _state(jt), updater)
    for a, b in zip(tt, jt):   # the port's state, into the JAX tables
        buf = io.BytesIO()
        a.store(buf)
        buf.seek(0)
        b.load(buf)
    saved = _state(tt)
    _same(_state(jt), saved)
    dirs = {"torch": str(tmp_path / "torch"), "jax": str(tmp_path / "jax")}
    tck.save(dirs["torch"], tag="t0", backend="orbax")
    jck.save(dirs["jax"], tag="t0", backend="orbax")
    _train(tt, TAddOption, 1)
    _train(jt, JAddOption, 1)
    assert tck.restore(dirs["torch"], tag="t0") == 4
    assert jck.restore(dirs["jax"], tag="t0") == 4
    _same(_state(tt), saved)
    _same(_state(jt), saved)
    assert tck.latest(dirs["torch"]) == jck.latest(dirs["jax"]) == "t0"
    # the updater state came back: the next add from it agrees as the
    # trained states did
    _train(tt, TAddOption, 2)
    _train(jt, JAddOption, 2)
    _same(_state(tt), _state(jt), updater)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_orbax_file_uri_roundtrip(both, tmp_path, pkg):
    # file:// URIs put the arrays inside the checkpoint's directory
    mv, ck, _ = PKGS[pkg]
    t = mv.ArrayTable(15, name="uri_t")
    t.add(np.arange(15, dtype=np.float32))
    uri = f"file://{tmp_path}"
    ck.save(uri, tag="u0", backend="orbax")
    assert (tmp_path / "u0" / "arrays").is_dir()
    if pkg == "torch":
        assert (tmp_path / "u0" / "arrays" / "table_0" /
                "data.0.npy").is_file()
    snap = t.get().copy()
    t.add(np.ones(15, np.float32))
    ck.restore(uri, tag="u0")
    np.testing.assert_array_equal(t.get(), snap)
    np.testing.assert_array_equal(snap, np.arange(15, dtype=np.float32))


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_orbax_restore_skips_tables_added_since_save(both, tmp_path, pkg):
    mv, ck, _ = PKGS[pkg]
    t = mv.ArrayTable(7, name="old_t")
    t.add(np.ones(7, np.float32))
    ck.save(str(tmp_path), tag="t1", backend="orbax")
    snap = t.get().copy()
    extra = mv.ArrayTable(7, name="new_t")   # registered after the save
    extra.add(np.full(7, 3.0, np.float32))
    t.add(np.ones(7, np.float32))
    assert ck.restore(str(tmp_path), tag="t1") == 1
    np.testing.assert_array_equal(t.get(), snap)
    np.testing.assert_array_equal(extra.get(), np.full(7, 3.0, np.float32))


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_async_orbax_save_finalizes_on_wait(both, tmp_path, pkg):
    mv, ck, _ = PKGS[pkg]
    t = mv.ArrayTable(31, name="async_t")
    t.add(np.ones(31, np.float32))
    snap = t.get().copy()
    ck.save(str(tmp_path), tag="a0", backend="orbax", block=False)
    # invisible until finalized: no manifest yet
    assert ck.latest(str(tmp_path)) is None
    assert ck.wait_pending() == 1
    assert ck.latest(str(tmp_path)) == "a0"
    t.add(np.ones(31, np.float32))
    ck.restore(str(tmp_path), tag="a0")
    np.testing.assert_array_equal(t.get(), snap)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_restore_waits_for_inflight_async_save(both, tmp_path, pkg):
    mv, ck, _ = PKGS[pkg]
    t = mv.ArrayTable(15, name="async_u")
    t.add(np.full(15, 2.0, np.float32))
    ck.save(str(tmp_path), tag="u0", backend="orbax", block=False)
    t.add(np.ones(15, np.float32))
    # restore finalizes the pending save itself, no explicit wait
    ck.restore(str(tmp_path), tag="u0")
    np.testing.assert_array_equal(t.get(), np.full(15, 2.0, np.float32))
    assert ck.wait_pending() == 0


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_stream_save_finalizes_pending_async(both, tmp_path, pkg):
    mv, ck, _ = PKGS[pkg]
    t = mv.ArrayTable(15, name="mix_t")
    t.add(np.ones(15, np.float32))
    ck.save(str(tmp_path), tag="a", backend="orbax", block=False)
    # a stream save finalizes 'a' first, so latest() orders the two
    ck.save(str(tmp_path), tag="b", backend="stream")
    assert ck.latest(str(tmp_path)) == "b"
    assert ck.wait_pending() == 0   # already finalized
    assert ck.is_committed(os.path.join(str(tmp_path), "a"))


@pytest.mark.parametrize("block", [True, False])
def test_failed_write_is_discarded_and_raised(port, tmp_path, monkeypatch,
                                              block):
    t = tmv.ArrayTable(15, updater="adagrad", name="bad_t")
    t.add(np.ones(15, np.float32))
    good = t.get().copy()
    tck.save(str(tmp_path), tag="good", backend="orbax")
    real = tck.open_stream

    def failing(path, mode="rb"):
        if path.endswith(".npy") and "broken" in path:
            raise OSError("disk full")
        return real(path, mode)

    monkeypatch.setattr(tck, "open_stream", failing)
    t.add(np.ones(15, np.float32))
    with pytest.raises(OSError, match="disk full"):
        tck.save(str(tmp_path), tag="broken", backend="orbax", block=block)
        tck.wait_pending()
    broken = os.path.join(str(tmp_path), "broken")
    assert not tck.is_committed(broken)
    assert not os.path.exists(os.path.join(broken, "manifest.json"))
    assert tck.latest(str(tmp_path)) == "good"
    assert tck.wait_pending() == 0   # the failure does not wedge later calls
    assert tck._GAUGES.memory_stats()["staging_bytes"] == 0
    with pytest.raises(ValueError, match="commit marker"):
        tck.restore(str(tmp_path), "broken")
    tck.restore(str(tmp_path), "good")
    np.testing.assert_array_equal(t.get(), good)


def test_gauge_counts_the_block_until_written(port, tmp_path, monkeypatch):
    t = tmv.ArrayTable(999, updater="adam", name="gauge_t")
    t.add(np.ones(999, np.float32))
    gate = threading.Event()
    real = tck.open_stream

    def held(path, mode="rb"):
        if path.endswith(".npy"):
            assert gate.wait(30)
        return real(path, mode)

    monkeypatch.setattr(tck, "open_stream", held)
    tck.save(str(tmp_path), "g", backend="orbax", block=False)
    # the block's data and adam's m and v (rows), the step count shared,
    # and the table's index
    leaves = [t.state["data"]] + [t.state["ustate"][k]
                                  for k in sorted(t.state["ustate"])]
    index = json.dumps(dict(t.block_index(), name=t.name)).encode()
    want = sum(x.numel() * x.element_size() for x in leaves) + len(index)
    assert tck._pending.staged == want > 3 * 4000
    from multiverso_tpu_torch.telemetry import memstats
    ledger = memstats.stats_snapshot()["components"]["checkpoint"]
    assert ledger["staging_bytes"] == want
    gate.set()
    assert tck.wait_pending() == 1
    assert tck._GAUGES.memory_stats()["staging_bytes"] == 0


def test_a_jax_written_orbax_tag_is_refused(both, tmp_path):
    jt = jmv.ArrayTable(15, name="w")
    tt = tmv.ArrayTable(15, name="w")
    jt.add(np.ones(15, np.float32))
    jck.save(str(tmp_path), tag="j", backend="orbax")
    with open(tmp_path / "j" / "manifest.json") as f:
        assert "layout" not in json.load(f)
    with pytest.raises(ValueError, match="layout"):
        tck.restore(str(tmp_path), tag="j")
    np.testing.assert_array_equal(tt.get(), np.zeros(15, np.float32))


def test_the_jax_restore_of_the_ports_tag_fails(both, tmp_path):
    """ROADMAP C.27: the port's files are not orbax's, and the JAX
    restore reads them through orbax, which fails."""
    jmv.ArrayTable(15, name="w")
    tt = tmv.ArrayTable(15, name="w")
    tt.add(np.ones(15, np.float32))
    tck.save(str(tmp_path), tag="p", backend="orbax")
    with pytest.raises(Exception):
        jck.restore(str(tmp_path), tag="p")


def test_a_renamed_table_or_another_shape_raises(port, tmp_path):
    tmv.ArrayTable(15, name="a")
    tck.save(str(tmp_path), "t", backend="orbax")
    TZoo.get().stop()
    tmv.init(device="cpu")
    tmv.ArrayTable(15, name="b")
    with pytest.raises(ValueError, match="same order"):
        tck.restore(str(tmp_path), "t")
    TZoo.get().stop()
    tmv.init(device="cpu")
    tmv.ArrayTable(16, name="a")
    with pytest.raises(ValueError, match="shape"):
        tck.restore(str(tmp_path), "t")
