"""Port parity, the last public names the port lacked:
``models/word2vec.sample_negatives`` (the JAX function's inverse-CDF
draw, bit for bit), ``utils/linkprobe.link_is_fast``,
``ops/wire_codec.host_codec_device`` and ``ps/native.unregister_shard``
(a shard the C++ server serves, then unregistered: its ops punt to
Python and still land)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.models import word2vec as jw2v
from multiverso_tpu_torch import zoo as tzoo
from multiverso_tpu_torch.models import word2vec as tw2v
from multiverso_tpu_torch.ops import wire_codec
from multiverso_tpu_torch.ps import native as tnative
from multiverso_tpu_torch.ps import service as tsvc
from multiverso_tpu_torch.ps import tables as ttables
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils import linkprobe, threefry
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard


def _cdf(vocab: int, seed: int, zeros: int = 0) -> np.ndarray:
    """The unigram^0.75 running sum in f32 (as word2vec builds it), with
    ``zeros`` words of count 0: repeated cdf values, where the left side
    of the search decides."""
    counts = np.random.default_rng(seed).integers(1, 1000, vocab)
    counts[:zeros] = 0
    p = counts.astype(np.float64) ** 0.75
    return np.cumsum(p / p.sum()).astype(np.float32)


@pytest.mark.parametrize("seed,vocab,batch,k,zeros", [
    (0, 10, 4, 5, 0), (1, 1000, 64, 5, 0), (42, 71_290, 256, 8, 0),
    (7, 50, 33, 3, 20), (2 ** 31 - 1, 3, 128, 16, 1)])
def test_sample_negatives_matches_jax(seed, vocab, batch, k, zeros):
    cdf = _cdf(vocab, seed, zeros)
    want = np.asarray(jw2v.sample_negatives(
        jax.random.PRNGKey(seed), jnp.asarray(cdf), batch, k))
    got = tw2v.sample_negatives(threefry.key(seed), torch.from_numpy(cdf),
                                batch, k)
    assert got.dtype == torch.int32 and tuple(got.shape) == (batch, k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.min() >= 0 and want.max() < vocab
    if zeros:   # a word of count 0 is never drawn
        assert not np.isin(got.numpy(), np.arange(1, zeros)).any()


def test_sample_negatives_edges_of_the_search():
    """A draw equal to a cdf value takes that index (left side), and a
    draw above the last value takes len(cdf), as jnp.searchsorted does."""
    key = threefry.key(3)
    u = threefry.uniform(key, (4, 6)).numpy()
    cdf = np.sort(np.concatenate([u.reshape(-1)[:5], [0.5, 2.0]])
                  ).astype(np.float32)
    want = np.asarray(jw2v.sample_negatives(jax.random.PRNGKey(3),
                                            jnp.asarray(cdf), 4, 6))
    got = tw2v.sample_negatives(key, torch.from_numpy(cdf), 4, 6).numpy()
    np.testing.assert_array_equal(got, want)
    short = cdf[:3]
    got = tw2v.sample_negatives(key, torch.from_numpy(short), 4, 6).numpy()
    assert got.max() == 3
    np.testing.assert_array_equal(got, np.asarray(jw2v.sample_negatives(
        jax.random.PRNGKey(3), jnp.asarray(short), 4, 6)))


@pytest.mark.parametrize("ms,fast", [(0.4, True), (19.99, True),
                                     (20.0, False), (150.0, False)])
def test_link_is_fast_reads_the_probe(monkeypatch, ms, fast):
    seen = []
    monkeypatch.setattr(linkprobe, "device_link_ms",
                        lambda device: seen.append(device) or ms)
    assert linkprobe.link_is_fast("cpu") is fast
    assert seen == [torch.device("cpu")]


def test_link_is_fast_defaults_to_the_zoo_then_the_card(monkeypatch):
    monkeypatch.setattr(linkprobe, "device_link_ms", lambda device: 1.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    zoo = tzoo.Zoo.get()
    assert not zoo.started
    with pytest.raises(RuntimeError, match="device='cpu'"):
        linkprobe.link_is_fast()
    zoo.start(device="cpu")
    try:
        assert linkprobe.link_is_fast()
    finally:
        zoo.stop()
        tconfig.reset_flags()


def test_link_is_fast_on_this_host_cpu(monkeypatch):
    """The real probe on the CPU, where there is no link and its copy is
    a memcpy of 1 MB: a positive finite reading, cached (a second call
    reads no clock), ``refresh=True`` measuring again (the probe's three
    timed copies read the clock), and the decision agreeing with the
    cached reading. No bound on the reading's size: on this host it is
    the load other test processes put on its cores; the 20 ms bound on a
    real link is chip_smoke.py's, on the card."""
    import threading
    cpu = torch.device("cpu")
    clock = linkprobe.time.perf_counter
    me, reads = threading.get_ident(), []

    def counted():
        # the time module is the process's: count this thread's reads only
        if threading.get_ident() == me:
            reads.append(1)
        return clock()

    monkeypatch.setattr(linkprobe.time, "perf_counter", counted)
    first = linkprobe.device_link_ms(cpu, refresh=True)
    assert np.isfinite(first) and first > 0, first
    assert len(reads) == 6                # three timed copies, two reads each
    assert linkprobe.device_link_ms(cpu) == first
    assert len(reads) == 6                # the cache: no copy, no clock
    again = linkprobe.device_link_ms(cpu, refresh=True)
    assert np.isfinite(again) and again > 0, again
    assert len(reads) == 12
    assert linkprobe.device_link_ms(cpu) == again
    assert linkprobe.link_is_fast("cpu") is (again < linkprobe.FAST_LINK_MS)
    assert linkprobe.link_is_fast(cpu) is linkprobe.link_is_fast("cpu")


def test_host_codec_device_is_the_cpu():
    dev = wire_codec.host_codec_device()
    assert dev == torch.device("cpu")
    # the encoders run there on a host payload
    flat = torch.from_numpy(np.random.default_rng(0).normal(
        size=2048).astype(np.float32)).to(dev)
    bits, scales, _ = wire_codec.onebit_encode(flat, torch.zeros_like(flat))
    assert bits.device == dev and scales.device == dev


@pytest.fixture
def native_world(tmp_path):
    tconfig.set_flag("ps_native", True)
    tconfig.set_flag("ps_timeout", 10.0)
    tconfig.set_flag("ps_connect_timeout", 3.0)
    rdv = tsvc.FileRendezvous(str(tmp_path / "rdv"))
    ctxs = [tsvc.PSContext(r, 2, tsvc.PSService(r, 2, rdv), device="cpu")
            for r in range(2)]
    yield ctxs
    for c in ctxs:
        c.close()
    tconfig.reset_flags()
    TDashboard.reset()


def test_unregistered_shard_punts_to_python(native_world):
    """Rank 0's shard is served by the C++ server until it is
    unregistered; after that rank 1's adds and gets of its rows punt to
    the Python handler, and every add lands once."""
    ctxs = native_world
    t0 = ttables.AsyncMatrixTable(10, 2, name="un", ctx=ctxs[0])
    t1 = ttables.AsyncMatrixTable(10, 2, name="un", ctx=ctxs[1])
    assert tnative.available() and t0._shard._native_ref is not None
    mine = np.array([0, 1], np.int64)
    assert t0._shard.lo == 0 and t0._shard.n >= 2   # rank 0's rows
    ones = np.ones((2, 2), np.float32)
    t1.add_rows(mine, ones)
    native_adds, _ = t0._shard._native_stats()
    assert native_adds == 1 and t0._shard._stat_adds == 0
    tnative.unregister_shard(ctxs[0].service._native, "un")
    t1.add_rows(mine, ones)
    t1.add_rows(mine, ones)
    assert t0._shard._native_stats()[0] == native_adds   # C++ saw none
    assert t0._shard._stat_adds == 2                      # Python did
    np.testing.assert_array_equal(t1.get_rows(mine), 3 * ones)
    np.testing.assert_array_equal(t0.get_rows(mine), 3 * ones)
    # unregistering a name the server does not hold is harmless
    tnative.unregister_shard(ctxs[0].service._native, "un")
    tnative.unregister_shard(ctxs[0].service._native, "never")
    t1.add_rows(mine, ones)
    np.testing.assert_array_equal(t0.get_rows(mine), 4 * ones)
