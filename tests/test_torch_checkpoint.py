"""Port parity, ``checkpoint.py``: the whole-Zoo ``save``/``restore`` of the
``stream`` format and the per-shard failover checkpoints, each written by
either package and restored by the other.

* whole Zoo: Array, Matrix, KV and SparseMatrix tables with updater state,
  trained on the same numpy deltas in both packages; a checkpoint of
  either restores in the other to the saved rows bit for bit, and the
  next add continues from the restored updater state (the default
  updater and SGD bit for bit, the stateful ones within rtol 1e-5, atol
  1e-6: ROADMAP C.4). The JAX Zoo runs on one CPU device, where both
  packages pad rows alike;
* per shard: rank 1's row shard of a two-rank async world (and a hash
  shard) checkpointed by one package restores into the other's shard,
  for every updater — the state leaves in sorted key order, the replay
  channels adopted (a re-sent stamped frame dedupes), the version kept;
* commit markers: torn tags are invisible, ``latest`` skips uncommitted
  tags, ``prune_shard_tags`` keeps ``keep``; an unknown backend raises,
  and ``backend="orbax"``, blocking and not, round-trips the Zoo (the
  asynchronous stream save has tests/test_torch_async_save.py, the
  sharded backend tests/test_torch_sharded_checkpoint.py).
"""

import json
import os
import time

import jax
import numpy as np
import pytest

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu import checkpoint as jck
from multiverso_tpu.ps import service as jsvc
from multiverso_tpu.ps import tables as jtables
from multiverso_tpu.ps import wire as jwire
from multiverso_tpu.updaters import AddOption as JAddOption
from multiverso_tpu.utils import config as jconfig
from multiverso_tpu_torch import checkpoint as tck
from multiverso_tpu_torch.ps import service as tsvc
from multiverso_tpu_torch.ps import tables as ttables
from multiverso_tpu_torch.updaters import AddOption
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard
from multiverso_tpu_torch.zoo import Zoo as TZoo

UPDATERS = ["default", "sgd", "momentum_sgd", "adagrad", "adam", "ftrl"]
EXACT = ("default", "sgd")
RTOL, ATOL = 1e-5, 1e-6   # stateful updaters across packages (C.4)
OPT = dict(momentum=0.9, learning_rate=0.1, rho=0.1)


def _close(a, b, updater):
    if updater in EXACT:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------- #
# whole Zoo
# ---------------------------------------------------------------------- #
@pytest.fixture
def runtimes():
    jmv.init(mesh=jax.sharding.Mesh(np.array(jax.devices()[:1]), ("mv",)))
    tmv.init(device="cpu")
    yield
    zoo = TZoo.get()
    if zoo.started:
        zoo.stop()
    tconfig.reset_flags()
    TDashboard.reset()


def _zoo_tables(pkg, updater):
    """The same four tables, registered in the same order."""
    return [pkg.ArrayTable(50, updater=updater, name="arr"),
            pkg.MatrixTable(12, 4, updater=updater, name="mat"),
            pkg.KVTable(name="kv"),
            pkg.SparseMatrixTable(10, 3, updater=updater, name="sp")]


def _train(tables, opt_cls, seed):
    rng = np.random.default_rng(seed)
    arr, mat, kv, sp = tables
    for _ in range(2):
        arr.add(rng.normal(size=50).astype(np.float32), opt_cls(**OPT))
        mat.add_rows(np.array([1, 5, 11]),
                     rng.normal(size=(3, 4)).astype(np.float32),
                     opt_cls(**OPT))
        sp.add_rows(np.array([0, 7]),
                    rng.normal(size=(2, 3)).astype(np.float32),
                    opt_cls(**OPT))
    kv.add([3, 9, 3], [1, 2, 5])


def _reads(tables):
    arr, mat, kv, sp = tables
    return [arr.get().copy(), mat.get_rows(np.arange(12)).copy(),
            dict(kv.get()), sp.get_rows(np.arange(10)).copy()]


@pytest.mark.parametrize("updater", UPDATERS)
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_zoo_checkpoint_crosses_packages(runtimes, tmp_path, updater,
                                         writer):
    jt = _zoo_tables(jmv, updater)
    tt = _zoo_tables(tmv, updater)
    src, dst = (jt, tt) if writer == "jax" else (tt, jt)
    src_opt = JAddOption if writer == "jax" else AddOption
    dst_opt = AddOption if writer == "jax" else JAddOption
    _train(src, src_opt, 0)
    saved = _reads(src)
    save, restore = ((jck.save, tck.restore) if writer == "jax"
                     else (tck.save, jck.restore))
    path = save(str(tmp_path), "step_000000001")
    assert jck.is_committed(path) and tck.is_committed(path)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert [e["name"] for e in manifest["tables"].values()] == [
        "arr", "mat", "kv", "sp"]
    assert manifest["tables"]["1"]["dtype"] == "float32"
    assert restore(str(tmp_path), "step_000000001") == 4
    got = _reads(dst)
    for a, b in zip(got, saved):
        if isinstance(a, dict):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)
    # the restored updater state steps like the writer's own
    _train(src, src_opt, 1)
    _train(dst, dst_opt, 1)
    for a, b in zip(_reads(dst), _reads(src)):
        if isinstance(a, dict):
            assert a == b
        else:
            _close(a, b, updater)


def test_zoo_restore_rejects_a_renamed_table(runtimes, tmp_path):
    tmv.ArrayTable(4, name="a")
    tck.save(str(tmp_path), "t")
    TZoo.get().stop()
    tmv.init(device="cpu")
    tmv.ArrayTable(4, name="b")
    with pytest.raises(ValueError, match="same order"):
        tck.restore(str(tmp_path), "t")


def test_unknown_backend_raises(runtimes, tmp_path):
    tmv.ArrayTable(4, name="a")
    with pytest.raises(ValueError, match="backend"):
        tck.save(str(tmp_path), "t", backend="nope")
    assert not os.path.exists(tmp_path / "t")


@pytest.mark.parametrize("kw", [dict(backend="orbax"),
                                dict(backend="orbax", block=False)])
def test_orbax_backend_round_trips(runtimes, tmp_path, kw):
    """The sharded backend, blocking and not, in the port's layout: the
    whole Zoo (the KV table in the stream format inside the tag) comes
    back bit for bit after later adds, updater state included (the next
    add lands where it landed from the saved state)."""
    tables = _zoo_tables(tmv, "adagrad")
    _train(tables, AddOption, 0)
    saved = _reads(tables)
    tck.save(str(tmp_path), "t", **kw)
    tck.wait_pending()
    with open(tmp_path / "t" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["backend"] == "orbax" and manifest["layout"] == tck.LAYOUT
    assert [e["kind"] for e in manifest["tables"].values()] == [
        "orbax", "orbax", "stream", "orbax"]
    _train(tables, AddOption, 1)
    after = _reads(tables)
    assert tck.restore(str(tmp_path), "t") == 4
    for a, b in zip(_reads(tables), saved):
        if isinstance(a, dict):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)
    _train(tables, AddOption, 1)
    for a, b in zip(_reads(tables), after):
        if isinstance(a, dict):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------- #
# commit markers (tests/test_failover.py TestTornFullCheckpoint)
# ---------------------------------------------------------------------- #
def _fake_tag(root, tag, committed):
    d = root / tag
    d.mkdir(parents=True)
    (d / "manifest.json").write_text(
        json.dumps({"tables": {}, "version": 1}))
    if committed:
        (d / tck.COMMIT_MARKER).write_text("1")


def test_latest_skips_uncommitted(tmp_path):
    _fake_tag(tmp_path, "step_000000009", committed=True)
    time.sleep(0.02)
    _fake_tag(tmp_path, "step_000000019", committed=False)
    assert tck.latest(str(tmp_path)) == "step_000000009"
    assert jck.latest(str(tmp_path)) == "step_000000009"


def test_restore_rejects_uncommitted(runtimes, tmp_path):
    _fake_tag(tmp_path, "step_000000009", committed=False)
    with pytest.raises(ValueError, match="commit marker"):
        tck.restore(str(tmp_path), "step_000000009")


def test_truncated_mid_write(tmp_path):
    _fake_tag(tmp_path, "step_000000009", committed=True)
    d = tmp_path / "step_000000019"
    d.mkdir()
    (d / "manifest.json").write_text('{"tables": {"0": {"na')
    assert tck.latest(str(tmp_path)) == "step_000000009"


# ---------------------------------------------------------------------- #
# per-shard checkpoints
# ---------------------------------------------------------------------- #
@pytest.fixture
def worlds(tmp_path):
    """A two-rank JAX world and a two-rank port world (own rendezvous
    each), Python wire plane."""
    for cfg in (tconfig, jconfig):
        cfg.set_flag("ps_timeout", 10.0)
        cfg.set_flag("ps_connect_timeout", 3.0)
    jconfig.set_flag("ps_native", False)
    jr = jsvc.FileRendezvous(str(tmp_path / "jrdv"))
    tr = tsvc.FileRendezvous(str(tmp_path / "trdv"))
    j = [jsvc.PSContext(r, 2, jsvc.PSService(r, 2, jr)) for r in range(2)]
    t = [tsvc.PSContext(r, 2, tsvc.PSService(r, 2, tr), device="cpu")
         for r in range(2)]
    yield {"jax": (jtables, JAddOption, j), "torch": (ttables, AddOption, t)}
    for c in j + t:
        c.close()
    tconfig.reset_flags()
    TDashboard.reset()


def _pair(worlds, pkg, kind, updater, name):
    mod, _, ctxs = worlds[pkg]
    if kind == "row":
        return [mod.AsyncMatrixTable(12, 3, updater=updater, name=name,
                                     ctx=c) for c in ctxs]
    return [mod.AsyncSparseKVTable(3, updater=updater, name=name, ctx=c)
            for c in ctxs]


def _shard_adds(tables, opt_cls, seed, kind):
    rng = np.random.default_rng(seed)
    for step in range(3):
        ids = (np.array([6, 8, 11]) if kind == "row"
               else np.array([1, 3, 101]))   # rank 1 owns odd keys
        tables[step % 2].add_rows(
            ids, rng.normal(size=(3, 3)).astype(np.float32),
            opt_cls(**OPT))


@pytest.mark.parametrize("kind", ["row", "hash"])
@pytest.mark.parametrize("updater", UPDATERS)
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_shard_tag_crosses_packages(worlds, tmp_path, writer, updater,
                                    kind):
    reader = "torch" if writer == "jax" else "jax"
    ck = {"jax": jck, "torch": tck}
    src = _pair(worlds, writer, kind, updater, "sh")
    dst = _pair(worlds, reader, kind, updater, "sh")
    _shard_adds(src, worlds[writer][1], 0, kind)
    # a replay-stamped frame lands on the writer's rank-1 shard
    stamped = {"table": "sh", "opt": {}, jwire.REPLAY_CLIENT_KEY: "c9",
               jwire.REPLAY_SEQ_KEY: 0}
    blob = [np.array([6 if kind == "row" else 3]),
            np.ones((1, 3), np.float32)]
    src[1]._shard.handle(jsvc.MSG_ADD_ROWS, stamped, blob)
    ids = np.array([6, 8, 11] if kind == "row" else [1, 3, 101])
    want = src[0].get_rows(ids).copy()
    path = ck[writer].save_shard_state(str(tmp_path / "ck"), 1, [src[1]])
    assert ck[reader].is_committed(path)
    assert ck[reader].latest_shard_tag(str(tmp_path / "ck"), 1) == \
        os.path.basename(path)
    assert ck[reader].restore_shard_state(str(tmp_path / "ck"), 1,
                                          [dst[1]]) == 1
    np.testing.assert_array_equal(dst[0].get_rows(ids), want)
    st = dst[1]._shard.stats()
    assert st["version"] == src[1]._shard.stats()["version"]
    # the restored channel dedupes the frame the checkpoint holds
    rmeta, _ = dst[1]._shard.handle(jsvc.MSG_ADD_ROWS, stamped, blob)
    assert rmeta.get(jwire.REPLAY_DUP_KEY) is True
    assert rmeta[jwire.REPLAY_DURABLE_KEY] == 0
    # the restored updater state steps like the writer's own
    _shard_adds(src, worlds[writer][1], 1, kind)
    _shard_adds(dst, worlds[reader][1], 1, kind)
    _close(dst[0].get_rows(ids), src[0].get_rows(ids), updater)


def test_restore_places_rows_on_the_shard_device(worlds, tmp_path):
    ts = _pair(worlds, "torch", "row", "adagrad", "dv")
    ts[0].add_rows([7], np.ones((1, 3), np.float32))
    tck.save_shard_state(str(tmp_path), 1, [ts[1]])
    assert tck.restore_shard_state(str(tmp_path), 1, [ts[1]]) == 1
    shard = ts[1]._shard
    assert shard._data.device == shard.device
    assert all(v.device == shard.device for v in shard._ustate.values())


def test_torn_shard_tag_invisible_and_pruned(worlds, tmp_path):
    ts = _pair(worlds, "torch", "row", "default", "tt")
    ckdir = str(tmp_path / "ck")
    tck.save_shard_state(ckdir, 1, [ts[1]])
    p2 = tck.save_shard_state(ckdir, 1, [ts[1]])
    os.remove(os.path.join(p2, tck.COMMIT_MARKER))
    assert tck.latest_shard_tag(ckdir, 1) == "v000000000"
    assert jck.latest_shard_tag(ckdir, 1) == "v000000000"
    with pytest.raises(ValueError, match="not committed"):
        tck.restore_shard_state(ckdir, 1, [ts[1]],
                                tag=os.path.basename(p2))
    for _ in range(3):
        tck.save_shard_state(ckdir, 1, [ts[1]])
    tck.prune_shard_tags(ckdir, 1, keep=2)
    left = sorted(os.listdir(os.path.dirname(p2)))
    assert left == ["v000000003", "v000000004"]
    assert tck.latest_shard_tag(str(tmp_path / "none"), 1) is None
    assert tck.restore_shard_state(str(tmp_path / "none"), 1,
                                   [ts[1]]) == 0


def test_shard_checkpoints_need_a_local_directory(worlds):
    ts = _pair(worlds, "torch", "row", "default", "rm")
    with pytest.raises(ValueError, match="local"):
        tck.save_shard_state("memory://x", 1, [ts[1]])


def test_adam_step_leaf_record(worlds, tmp_path):
    """ROADMAP C.14, a record of the reference: the JAX package writes a
    0-d updater leaf (Adam's step) with ``np.ascontiguousarray``, i.e. as
    shape (1,), and its own row-shard restore rejects that shape, so a
    JAX Adam row shard cannot restore its own tag. The port reads the
    (1,) leaf back as 0-d, and writes 0-d leaves as 0-d, which the JAX
    package restores."""
    js = _pair(worlds, "jax", "row", "adam", "ad")
    ts = _pair(worlds, "torch", "row", "adam", "ad")
    js[0].add_rows([7], np.ones((1, 3), np.float32), JAddOption(**OPT))
    ts[0].add_rows([7], np.ones((1, 3), np.float32), AddOption(**OPT))
    jpath = jck.save_shard_state(str(tmp_path / "j"), 1, [js[1]])
    tpath = tck.save_shard_state(str(tmp_path / "t"), 1, [ts[1]])
    jleaf = tck._load_shard_file(os.path.join(jpath, "ad.mvs"))[1][2]
    tleaf = tck._load_shard_file(os.path.join(tpath, "ad.mvs"))[1][2]
    assert jleaf.shape == (1,) and tleaf.shape == ()
    assert int(jleaf[0]) == int(tleaf) == 1
    with pytest.raises(jsvc.PSError, match="leaf shape"):
        jck.restore_shard_state(str(tmp_path / "j"), 1, [js[1]])
    assert tck.restore_shard_state(str(tmp_path / "j"), 1, [ts[1]]) == 1
    assert jck.restore_shard_state(str(tmp_path / "t"), 1, [js[1]]) == 1
    assert int(ts[1]._shard._ustate["t"]) == 1
