"""The asynchronous whole-Zoo save, ``checkpoint.save(..., block=False)``
and ``checkpoint.wait_pending()``, in the port's ``stream`` format (the
JAX package's own asynchronous save is orbax's; its semantics are kept,
tests/test_bindings.py:146-175 and :247-256 ported):

* invisible until ``wait_pending`` writes the manifest and the commit
  marker; ``restore``, a blocking save and the next asynchronous save
  each finalize the one in flight; ``latest()`` orders them;
* a failed background write is discarded (never visible) and raised;
* an add made after ``save(block=False)`` returns is absent from the
  checkpoint; the files equal a blocking save's byte for byte, the async
  and KV tables' included; the JAX package's ``restore`` reads it into
  tables equal to the port's bit for bit;
* the checkpoint gauge counts the snapshot's bytes while it is written
  and returns to 0; ``backend="orbax"`` (the sharded backend,
  tests/test_torch_sharded_checkpoint.py) round-trips, blocking and not.
"""

import filecmp
import json
import os
import threading

import jax
import numpy as np
import pytest

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu import checkpoint as jck
from multiverso_tpu_torch import checkpoint as tck
from multiverso_tpu_torch import elastic as tel
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard
from multiverso_tpu_torch.zoo import Zoo as TZoo

UPDATERS = ["default", "sgd", "momentum_sgd", "adagrad", "adam", "ftrl"]
OPT = dict(momentum=0.9, learning_rate=0.1, rho=0.1)


@pytest.fixture
def port():
    tmv.init(device="cpu")
    yield
    try:
        tck.wait_pending()
    finally:
        zoo = TZoo.get()
        if zoo.started:
            zoo.stop()
        tconfig.reset_flags()
        TDashboard.reset()


def _staged() -> int:
    return tck._GAUGES._staging


def test_async_save_finalizes_on_wait(port, tmp_path):
    t = tmv.ArrayTable(32, name="async_t")
    t.add(np.ones(32, np.float32))
    snap = t.get().copy()
    path = tck.save(str(tmp_path), tag="a0", block=False)
    assert path == os.path.join(str(tmp_path), "a0")
    # invisible until finalized: no manifest, no marker
    assert tck.latest(str(tmp_path)) is None
    assert not tck.is_committed(path)
    assert tck.wait_pending() == 1
    assert tck.latest(str(tmp_path)) == "a0" and tck.is_committed(path)
    assert tck.wait_pending() == 0
    t.add(np.ones(32, np.float32))
    assert tck.restore(str(tmp_path), tag="a0") == 1
    np.testing.assert_array_equal(t.get(), snap)
    assert _staged() == 0


def test_restore_waits_for_inflight_async_save(port, tmp_path):
    t = tmv.ArrayTable(16, name="async_u")
    t.add(np.full(16, 2.0, np.float32))
    tck.save(str(tmp_path), tag="u0", block=False)
    t.add(np.ones(16, np.float32))
    # restore finalizes the pending save itself, no explicit wait
    tck.restore(str(tmp_path), tag="u0")
    np.testing.assert_array_equal(t.get(), np.full(16, 2.0, np.float32))
    assert tck.wait_pending() == 0


@pytest.mark.parametrize("second_block", [True, False])
def test_a_save_finalizes_the_pending_one(port, tmp_path, second_block):
    t = tmv.ArrayTable(16, name="mix_t")
    t.add(np.ones(16, np.float32))
    tck.save(str(tmp_path), tag="a", block=False)
    # the next save, blocking or not, finalizes 'a' first, so latest()
    # orders the two
    t.add(np.ones(16, np.float32))
    tck.save(str(tmp_path), tag="b", block=second_block)
    assert tck.is_committed(os.path.join(str(tmp_path), "a"))
    assert tck.wait_pending() == (0 if second_block else 1)
    assert tck.latest(str(tmp_path)) == "b"
    tck.restore(str(tmp_path), "a")
    np.testing.assert_array_equal(t.get(), np.ones(16, np.float32))
    tck.restore(str(tmp_path), "b")
    np.testing.assert_array_equal(t.get(), np.full(16, 2.0, np.float32))


def test_failed_write_is_discarded_and_raised(port, tmp_path, monkeypatch):
    t = tmv.ArrayTable(16, name="bad_t")
    t.add(np.ones(16, np.float32))
    tck.save(str(tmp_path), tag="good")
    real = tck.open_stream

    def failing(path, mode="rb"):
        if path.endswith(".mvt") and "broken" in path:
            raise OSError("disk full")
        return real(path, mode)

    monkeypatch.setattr(tck, "open_stream", failing)
    t.add(np.ones(16, np.float32))
    tck.save(str(tmp_path), tag="broken", block=False)
    with pytest.raises(OSError, match="disk full"):
        tck.wait_pending()
    # never visible: latest keeps the committed tag, restore refuses
    broken = os.path.join(str(tmp_path), "broken")
    assert not tck.is_committed(broken)
    assert not os.path.exists(os.path.join(broken, "manifest.json"))
    assert tck.latest(str(tmp_path)) == "good"
    assert tck.wait_pending() == 0   # the failure does not wedge later calls
    assert _staged() == 0
    with pytest.raises(ValueError, match="commit marker"):
        tck.restore(str(tmp_path), "broken")
    tck.restore(str(tmp_path), "good")
    np.testing.assert_array_equal(t.get(), np.ones(16, np.float32))


@pytest.mark.parametrize("block", [True, False])
def test_orbax_round_trips(port, tmp_path, block):
    """``backend="orbax"``, blocking and not, on the arguments that
    raised before the sharded backend was ported: the tag is visible
    once the save is finalized (at once, or in ``wait_pending``), its
    staged bytes return to 0, and the table comes back bit for bit."""
    t = tmv.ArrayTable(8, updater="adam", name="async_v")
    t.add(np.arange(8, dtype=np.float32))
    snap = t.get().copy()
    tck.save(str(tmp_path), tag="x", backend="orbax", block=block)
    assert tck.is_committed(str(tmp_path / "x")) == block
    assert tck.wait_pending() == (0 if block else 1)
    assert tck.latest(str(tmp_path)) == "x" and _staged() == 0
    t.add(np.ones(8, np.float32))
    assert tck.restore(str(tmp_path), tag="x") == 1
    np.testing.assert_array_equal(t.get(), snap)


def _tables(pkg, updater):
    """The same tables, registered in the same order, in either package."""
    return [pkg.ArrayTable(50, updater=updater, name="arr"),
            pkg.MatrixTable(12, 4, updater=updater, name="mat"),
            pkg.KVTable(name="kv"),
            pkg.SparseMatrixTable(10, 3, updater=updater, name="sp")]


def _train(tables, opt_cls, seed):
    rng = np.random.default_rng(seed)
    arr, mat, kv, sp = tables
    for _ in range(2):
        arr.add(rng.normal(size=50).astype(np.float32), opt_cls(**OPT))
        mat.add_rows(np.array([1, 5, 11, 5]),
                     rng.normal(size=(4, 4)).astype(np.float32),
                     opt_cls(**OPT))
        sp.add_rows(np.array([0, 7]),
                    rng.normal(size=(2, 3)).astype(np.float32),
                    opt_cls(**OPT))
    kv.add([3, 9, 3], [1, 2, 5])


def _reads(tables):
    arr, mat, kv, sp = tables
    return [arr.get().copy(), mat.get_rows(np.arange(12)).copy(),
            dict(kv.get()), sp.get_rows(np.arange(10)).copy()]


def _same_files(a: str, b: str) -> list:
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    return names


@pytest.mark.parametrize("updater", UPDATERS)
def test_async_files_equal_a_blocking_save_and_miss_later_adds(
        port, tmp_path, updater):
    from multiverso_tpu_torch.updaters import AddOption
    tables = _tables(tmv, updater)
    atab = tmv.AsyncArrayTable(20, name="async_arr")
    _train(tables, AddOption, 0)
    atab.add(np.arange(20, dtype=np.float32))
    saved = _reads(tables)
    saved_async = atab.get().copy()
    tck.save(str(tmp_path), "async", block=False)
    # adds made after the return: absent from the checkpoint
    _train(tables, AddOption, 1)
    atab.add(np.ones(20, np.float32))
    assert tck.wait_pending() == 1
    moved = _reads(tables)
    assert not np.array_equal(moved[0], saved[0])
    # the state the snapshot took, saved blocking: the same bytes
    assert tck.restore(str(tmp_path), "async") == 5
    for a, b in zip(_reads(tables), saved):
        if isinstance(a, dict):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(atab.get(), saved_async)
    tck.save(str(tmp_path), "blocking")
    names = _same_files(str(tmp_path / "async"), str(tmp_path / "blocking"))
    assert len([n for n in names if n.endswith(".mvt")]) == 5
    assert {"manifest.json", tck.COMMIT_MARKER} <= set(names)
    assert _staged() == 0


@pytest.fixture
def runtimes():
    jmv.init(mesh=jax.sharding.Mesh(np.array(jax.devices()[:1]), ("mv",)))
    tmv.init(device="cpu")
    yield
    try:
        tck.wait_pending()
    finally:
        zoo = TZoo.get()
        if zoo.started:
            zoo.stop()
        tconfig.reset_flags()
        TDashboard.reset()


@pytest.mark.parametrize("updater", ["default", "adagrad", "adam"])
def test_jax_restores_the_async_checkpoint_bit_for_bit(runtimes, tmp_path,
                                                       updater):
    from multiverso_tpu_torch.updaters import AddOption
    tt = _tables(tmv, updater)
    jt = _tables(jmv, updater)
    _train(tt, AddOption, 0)
    saved = _reads(tt)
    tck.save(str(tmp_path), "step_000000001", block=False)
    _train(tt, AddOption, 1)   # after the return: not in the checkpoint
    assert tck.wait_pending() == 1
    with open(tmp_path / "step_000000001" / "manifest.json") as f:
        assert [e["name"] for e in json.load(f)["tables"].values()] == [
            "arr", "mat", "kv", "sp"]
    assert jck.latest(str(tmp_path)) == "step_000000001"
    assert jck.restore(str(tmp_path), "step_000000001") == 4
    for a, b in zip(_reads(jt), saved):
        if isinstance(a, dict):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)


def test_gauge_counts_the_snapshot_until_written(port, tmp_path,
                                                 monkeypatch):
    t = tmv.ArrayTable(1000, updater="adam", name="gauge_t")
    t.add(np.ones(1000, np.float32))
    gate = threading.Event()
    real = tck.open_stream

    def held(path, mode="rb"):
        if path.endswith(".mvt"):
            assert gate.wait(30)
        return real(path, mode)

    monkeypatch.setattr(tck, "open_stream", held)
    tck.save(str(tmp_path), "g", block=False)
    # the padded data and adam's m, v (rows) and step: f32 each
    leaves = [t.state["data"]] + [t.state["ustate"][k]
                                  for k in sorted(t.state["ustate"])]
    want = sum(x.numel() * x.element_size() for x in leaves)
    assert _staged() == want > 3 * 4000
    from multiverso_tpu_torch.telemetry import memstats
    ledger = memstats.stats_snapshot()["components"]["checkpoint"]
    assert ledger["staging_bytes"] == want
    gate.set()
    assert tck.wait_pending() == 1
    assert _staged() == 0


def test_elastic_loop_saves_asynchronously(port, tmp_path):
    d = str(tmp_path / "run")
    t = tmv.ArrayTable(6, updater="adagrad", name="w")
    loop = tel.ElasticLoop(d, every=2, keep=2, heartbeat_interval=0.05,
                           block=False)
    try:
        assert loop.resume() == 0
        for step in range(5):
            t.add(np.full(6, step + 1, np.float32))
            loop.completed(step)
    finally:
        loop.stop()   # finalizes the last save
    want = t.get().copy()
    assert tck.latest(d) == "step_000000003"
    t.add(np.full(6, 100.0, np.float32))
    loop = tel.ElasticLoop(d, every=2, heartbeat_interval=0.05, block=False)
    try:
        assert loop.resume() == 4
    finally:
        loop.stop()
    t.add(np.full(6, 5.0, np.float32))   # step 4 again, after the resume
    np.testing.assert_array_equal(t.get(), want)
