"""Port parity, ``ssp.py`` and the read side of ``elastic.py``: the JAX
package's SSP cases (tests/test_ssp.py) on multiverso_tpu_torch's
SSPClock, a JAX clock and a port clock as two workers of one directory,
and the port's ``failed()``/``peers()`` against the JAX ones over beacons
and tombstones written by the JAX ``Heartbeat`` and ``mark_failed``."""

import threading
import time

import pytest

from multiverso_tpu import elastic as jelastic
from multiverso_tpu.ssp import SSPClock as JSSPClock
from multiverso_tpu_torch import elastic
from multiverso_tpu_torch.ssp import SSPClock, SSPTimeout


def _run_workers(tmp_path, n, steps, staleness, delays, ignore=None,
                 timeout=10.0, classes=None):
    """Run n worker threads; record (worker, clock, min_peer_at_return)."""
    classes = classes or [SSPClock] * n
    history = []
    lock = threading.Lock()
    errors = []

    def worker(wid):
        try:
            clk = classes[wid](str(tmp_path), staleness=staleness,
                               num_workers=n, worker_id=wid, poll=0.005,
                               timeout=timeout, ignore=ignore)
            for _ in range(steps):
                time.sleep(delays[wid])
                c = clk.tick()
                with lock:
                    history.append((wid, c, min(clk.peer_clocks().values())))
        except Exception as e:  # propagate to the main thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    return history


def test_bsp_lockstep(tmp_path):
    # staleness=0: nobody returns from tick(c) before everyone hits c
    hist = _run_workers(tmp_path, n=3, steps=10, staleness=0,
                        delays=[0.0, 0.002, 0.01])
    for wid, clock, min_peer in hist:
        assert min_peer >= clock, (wid, clock, min_peer)


@pytest.mark.parametrize("mixed", [False, True])
def test_bounded_lead(tmp_path, mixed):
    """``mixed``: worker 0 is a JAX clock, worker 1 the port's, on one
    directory (the same beacon files)."""
    s = 2
    hist = _run_workers(tmp_path, n=2, steps=12, staleness=s,
                        delays=[0.0, 0.01],
                        classes=[JSSPClock, SSPClock] if mixed else None)
    for wid, clock, min_peer in hist:
        assert min_peer >= clock - s, (wid, clock, min_peer)
    leads = [clock - min_peer for wid, clock, min_peer in hist if wid == 0]
    assert max(leads) >= 1
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "sspclock.0.json", "sspclock.1.json"]


def test_ignore_dead_worker(tmp_path):
    # worker 1 never starts; with it ignored, worker 0 sails through
    clk = SSPClock(str(tmp_path), staleness=0, num_workers=2, worker_id=0,
                   poll=0.005, timeout=5.0, ignore=lambda: [1])
    for _ in range(5):
        clk.tick()
    assert clk.clock == 5


def test_timeout_raises(tmp_path):
    clk = SSPClock(str(tmp_path), staleness=0, num_workers=2, worker_id=0,
                   poll=0.005, timeout=0.2)
    with pytest.raises(SSPTimeout, match="stragglers"):
        clk.tick()


def test_rejects_negative_staleness(tmp_path):
    with pytest.raises(ValueError, match="staleness"):
        SSPClock(str(tmp_path), staleness=-1, num_workers=1, worker_id=0)


def test_resume_from_a_jax_beacon(tmp_path):
    # a restarted worker resumes from its beacon, whichever package wrote
    # it, and each package reads the other's clock
    clk = JSSPClock(str(tmp_path), staleness=5, num_workers=1, worker_id=0)
    for _ in range(3):
        clk.tick()
    resumed = SSPClock(str(tmp_path), staleness=5, num_workers=1,
                       worker_id=0)
    assert resumed.clock == 3
    assert resumed.tick() == 4
    assert JSSPClock(str(tmp_path), staleness=5, num_workers=1,
                     worker_id=0).clock == 4
    assert resumed.peer_clocks() == {0: 4}


def test_failed_matches_jax_over_jax_beacons(tmp_path):
    d = str(tmp_path)
    assert elastic.failed(d) == jelastic.failed(d) == []
    for rank, addr in ((0, "a:1"), (1, "b:1"), (2, None), (3, "d:1")):
        jelastic.Heartbeat(d, rank=rank, addr=addr).beat()
    (tmp_path / "heartbeat.9.json").write_text("{torn")     # skipped
    assert elastic.peers(d) == jelastic.peers(d)
    assert sorted(elastic.peers(d)) == [0, 1, 2, 3]
    # tombstones: rank 1 at its last beacon, rank 3 then respawned at
    # another address, rank 5 with no beacon at all
    jelastic.mark_failed(d, 1)
    jelastic.mark_failed(d, 3)
    jelastic.mark_failed(d, 5, addr="f:1")
    time.sleep(0.01)
    jelastic.Heartbeat(d, rank=3, addr="d:2").beat()
    assert elastic._tombstones(d) == jelastic._tombstones(d)
    assert elastic.failed(d) == jelastic.failed(d) == [1, 5]
    # a beacon older than the timeout
    assert elastic.failed(d, timeout=0.0) == jelastic.failed(d, timeout=0.0)
    assert elastic.failed(d, timeout=0.0) == [0, 1, 2, 3, 5]
    assert elastic.failed(str(tmp_path / "none")) == []
