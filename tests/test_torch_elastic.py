"""Port parity, ``elastic.py``: beacons and tombstones written by either
package are read alike by the other's ``peers``, ``failed``, ``health``
and ``stragglers`` (the stale-tombstone incarnation rule of
``tests/test_failover.py`` included), and ``ElasticLoop`` checkpoints and
resumes the port's Zoo, from its own checkpoints and from the JAX
package's."""

import json
import time

import jax
import numpy as np
import pytest

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu import elastic as jel
from multiverso_tpu_torch import elastic as tel
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.zoo import Zoo as TZoo

PKGS = {"jax": jel, "torch": tel}
PAIRS = [("jax", "torch"), ("torch", "jax")]


def _verdicts(mod, hb):
    return (mod.peers(hb), mod.failed(hb, timeout=1e9),
            mod.health(hb, timeout=1e9), mod.stragglers(hb, lag=3))


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_beacons_and_tombstones_read_alike(tmp_path, writer, reader):
    w, r = PKGS[writer], PKGS[reader]
    hb = str(tmp_path / "hb")
    for rank, step in ((0, 10), (1, 9), (2, 2)):
        b = w.Heartbeat(hb, rank=rank, addr=f"h:{7000 + rank}")
        b.set_step(step)
        b.beat()
    w.mark_failed(hb, 1)
    got = _verdicts(r, hb)
    assert got == _verdicts(w, hb)
    peers, dead, health, slow = got
    assert peers[0]["addr"] == "h:7000" and peers[2]["step"] == 2
    assert dead == [1]
    assert health == {0: "ok", 1: "dead", 2: "ok"}
    assert slow == [2]
    assert r._tombstones(hb)[1]["addr"] == "h:7001"


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_fresh_incarnation_clears_an_out_stamped_tombstone(
        tmp_path, writer, reader):
    """The predecessor kept beating while wedged (its beacon stamps ahead
    of anything the replacement writes); the replacement's new address
    clears the tombstone whichever package wrote which file."""
    w, r = PKGS[writer], PKGS[reader]
    hb = str(tmp_path / "hb")
    pred = w.Heartbeat(hb, rank=3, addr="10.0.0.1:7001")
    pred.beat()
    with open(pred.path) as f:
        raw = json.load(f)
    raw["ts"] = time.time() + 1000.0
    with open(pred.path, "w") as f:
        json.dump(raw, f)
    w.mark_failed(hb, 3)
    assert 3 in r.failed(hb, timeout=1e9)
    r.Heartbeat(hb, rank=3, addr="10.0.0.1:7002").beat()
    assert 3 not in w.failed(hb, timeout=1e9)
    assert 3 not in r.failed(hb, timeout=1e9)
    assert r.health(hb, timeout=1e9)[3] == "ok"


@pytest.mark.parametrize("mod", ["jax", "torch"])
def test_addr_less_beacons_keep_the_timestamp_rule(tmp_path, mod):
    m, other = PKGS[mod], PKGS["torch" if mod == "jax" else "jax"]
    hb = str(tmp_path / "hb")
    b = m.Heartbeat(hb, rank=2)
    b.beat()
    other.mark_failed(hb, 2)
    assert 2 in m.failed(hb, timeout=1e9)
    time.sleep(0.01)
    b.beat()   # newer beacon, same (absent) identity: clears by ts
    assert 2 not in other.failed(hb, timeout=1e9)


def test_stale_beacon_is_dead_and_stuck_is_read(tmp_path):
    # the port's beacon carries no verdict until its watchdog has run; a
    # PSService of an earlier test in this process starts the watchdog
    from multiverso_tpu_torch.telemetry import watchdog
    watchdog.reset()
    hb = str(tmp_path / "hb")
    tel.Heartbeat(hb, rank=0).beat()
    # a JAX rank's beacon carries the watchdog's last verdict
    with open(tmp_path / "hb" / "heartbeat.1.json", "w") as f:
        json.dump({"rank": 1, "step": 0, "ts": time.time(),
                   "last_health": {"status": "stuck",
                                   "oldest_inflight_s": 9.0,
                                   "inflight": 2}}, f)
    with open(tmp_path / "hb" / "heartbeat.2.json", "w") as f:
        json.dump({"rank": 2, "step": 0, "ts": time.time() - 60}, f)
    (tmp_path / "hb" / "heartbeat.9.json").write_text("{torn")
    for m in (jel, tel):
        assert m.health(hb, timeout=30.0) == {0: "ok", 1: "stuck",
                                              2: "dead"}
    assert "last_health" not in tel.peers(hb)[0]   # the port writes none


def test_heartbeat_thread_beats_and_stops(tmp_path):
    hb = str(tmp_path / "hb")
    b = tel.Heartbeat(hb, interval=0.05, rank=4, addr="h:1").start()
    try:
        t0 = jel.peers(hb)[4]["ts"]
        time.sleep(0.3)
        assert jel.peers(hb)[4]["ts"] > t0
        b.set_addr("h:2")
        b.set_step(7)
        time.sleep(0.2)
        assert jel.peers(hb)[4]["addr"] == "h:2"
        assert jel.peers(hb)[4]["step"] == 7
    finally:
        b.stop()
    assert b._thread is None


# ---------------------------------------------------------------------- #
# ElasticLoop
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


def _steps(pkg, t, start, stop, every, directory):
    loop = pkg.ElasticLoop(directory, every=every, keep=2,
                           heartbeat_interval=0.05)
    try:
        first = loop.resume()
        assert first == start
        for step in range(first, stop):
            t.add(np.full(6, step + 1, np.float32))
            loop.completed(step)
    finally:
        loop.stop()


def test_elastic_loop_resumes_the_port(runtimes, tmp_path):
    d = str(tmp_path / "run")
    t = tmv.ArrayTable(6, updater="adagrad", name="w")
    _steps(tel, t, 0, 7, 3, d)   # checkpoints after steps 2 and 5
    want = t.get().copy()
    assert sorted(p.name for p in (tmp_path / "run").iterdir()
                  if p.name.startswith("step_")) == [
        "step_000000002", "step_000000005"]
    t.add(np.full(6, 100.0, np.float32))   # lost work past the save
    TZoo.get().stop()
    tmv.init(device="cpu")
    t2 = tmv.ArrayTable(6, updater="adagrad", name="w")
    loop = tel.ElasticLoop(d, every=3, heartbeat_interval=0.05)
    try:
        assert loop.resume() == 6
    finally:
        loop.stop()
    # step 6's add never reached a checkpoint: the resume holds steps
    # 0-5, and redoing step 6 from the restored AdaGrad state lands on
    # the first run's table bit for bit
    assert not np.array_equal(t2.get(), want)
    t2.add(np.full(6, 7.0, np.float32))
    np.testing.assert_array_equal(t2.get(), want)


def test_elastic_loop_resumes_from_a_jax_checkpoint(runtimes, tmp_path):
    d = str(tmp_path / "run")
    jt = jmv.ArrayTable(6, name="w")
    tt = tmv.ArrayTable(6, name="w")
    _steps(jel, jt, 0, 4, 2, d)   # the JAX loop writes step_..01, ..03
    _steps(tel, tt, 4, 6, 2, d)   # the port resumes at 4 from JAX's tag
    want = np.full(6, sum(range(1, 7)), np.float32)
    np.testing.assert_array_equal(tt.get(), want)


@pytest.mark.parametrize("kw", [dict(backend="orbax"), dict(block=False)])
def test_elastic_loop_refuses_the_orbax_format(tmp_path, kw):
    with pytest.raises(ValueError):
        tel.ElasticLoop(str(tmp_path), **kw)
