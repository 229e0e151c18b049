"""Port parity, ``ps/wire.py`` and ``ps/service.py``: the async PS plane of
multiverso_tpu_torch against multiverso_tpu's pure-Python plane
(``ps_native=False``).

* the frames: the port's ``encode`` gives the JAX package's bytes for
  every message type, a bf16 payload and a ``MSG_BATCH`` frame, and each
  package's ``parse_frame`` reads the other's frames;
* the service: two ranks in one process over a ``FileRendezvous`` in
  ``tmp_path`` (real loopback sockets), with the failure semantics of the
  JAX package (dead peers give failed futures, flush surfaces swept
  failures, quiesce, stale markers and stale incarnations ignored, socket
  deaths tombstoned through ``elastic.bind_ps``);
* a mixed world: rank 0 a JAX ``PSContext``, rank 1 a port one, in one
  directory, summing exactly;
* the pinned read: a Get racing Adds sees whole rows;
* the refusals of the planes not ported (native, a world > 1 without a
  rendezvous), each naming its ROADMAP item, and the replay plane that
  was once refused.

``ps_timeout`` and ``ps_connect_timeout`` are a few seconds in both
packages, so no test can wait out the 300 s default.
"""

import socket
import os
import struct
import sys
import threading
import time
import types
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest

from multiverso_tpu.ps import service as jsvc
from multiverso_tpu.ps import tables as jtables
from multiverso_tpu.ps import wire as jwire
from multiverso_tpu.utils import config as jconfig
from multiverso_tpu_torch import elastic as telastic
from multiverso_tpu_torch.ps import service as tsvc
from multiverso_tpu_torch.ps import tables as ttables
from multiverso_tpu_torch.ps import wire as twire
from multiverso_tpu_torch.ps.shard import RowShard
from multiverso_tpu_torch.updaters import AddOption, get_updater
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard
from multiverso_tpu_torch.zoo import Zoo as TZoo

ROADMAP = (Path(__file__).resolve().parents[1] / "ROADMAP.md").read_text()


@pytest.fixture(autouse=True)
def _short_timeouts():
    for cfg in (tconfig, jconfig):
        cfg.set_flag("ps_timeout", 5.0)
        cfg.set_flag("ps_connect_timeout", 3.0)
    jconfig.set_flag("ps_native", False)
    yield
    zoo = TZoo.get()
    if zoo.started:
        zoo.stop()
    tconfig.reset_flags()
    TDashboard.reset()


@pytest.fixture
def port_ranks(tmp_path):
    """Two port PSContexts on the CPU over one file rendezvous."""
    rdv = tsvc.FileRendezvous(str(tmp_path / "rdv"))
    ctxs = [tsvc.PSContext(r, 2, tsvc.PSService(r, 2, rdv), device="cpu")
            for r in range(2)]
    yield ctxs
    for c in ctxs:
        c.close()


# ---------------------------------------------------------------------- #
# the frames
# ---------------------------------------------------------------------- #
_MSG_TYPES = [tsvc.MSG_REPLY_OK, tsvc.MSG_REPLY_ERR, tsvc.MSG_REPLY_CHUNK,
              tsvc.MSG_PING, tsvc.MSG_ADD_ROWS, tsvc.MSG_GET_ROWS,
              tsvc.MSG_SET_ROWS, tsvc.MSG_ADD_FULL, tsvc.MSG_GET_FULL,
              tsvc.MSG_KV_ADD, tsvc.MSG_KV_GET, tsvc.MSG_GET_STATE,
              tsvc.MSG_SET_STATE, tsvc.MSG_BATCH, tsvc.MSG_STATS,
              tsvc.MSG_HEALTH, tsvc.MSG_SNAPSHOT, tsvc.MSG_MULTI]


def test_message_type_ids_match_jax():
    names = [n for n in dir(jsvc) if n.startswith("MSG_")]
    assert len(names) == len(_MSG_TYPES)
    for n in names:
        assert getattr(tsvc, n) == getattr(jsvc, n), n


def _payloads(rng):
    return [np.arange(6, dtype=np.int64),
            rng.normal(size=(6, 5)).astype(np.float32),
            rng.normal(size=(3,)).astype(np.float64),
            np.array([True, False, True]),
            np.array(7, dtype=np.int32),
            np.zeros((0, 4), np.float32),
            np.arange(4, dtype=np.uint8)]


@pytest.mark.parametrize("msg_type", _MSG_TYPES)
def test_frames_match_jax_byte_for_byte(msg_type):
    rng = np.random.default_rng(msg_type)
    meta = {"table": "t", "opt": AddOption(worker_id=1)._asdict(),
            "wire": "none", "n": 3}
    arrays = _payloads(rng)
    a = twire.encode(msg_type, 12345, meta, arrays)
    b = jwire.encode(msg_type, 12345, meta, arrays)
    assert a == b
    # each package parses the other's frame
    for parse, frame in ((twire.parse_frame, b), (jwire.parse_frame, a)):
        mt, mid, m, got = parse(frame)
        assert (mt, mid, m) == (msg_type, 12345, meta)
        for x, y in zip(got, arrays):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    # pre-packed meta gives the same frame too
    assert twire.encode(msg_type, 1, twire.pack_meta(meta)) == \
        jwire.encode(msg_type, 1, jwire.pack_meta(meta))


@pytest.mark.parametrize("codec", ["none", "bf16", "1bit", "topk"])
def test_codec_payloads_match_jax(codec):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(37, 9)) * 100).astype(np.float32)
    meta = {"table": "t", "wire": codec}
    a = twire.encode(tsvc.MSG_ADD_ROWS, 3, meta,
                     [np.arange(37)] + twire.encode_payload(x, codec))
    b = jwire.encode(jsvc.MSG_ADD_ROWS, 3, meta,
                     [np.arange(37)] + jwire.encode_payload(x, codec))
    assert a == b
    # each package reads the other's frame, and decodes it alike
    _, _, tm, ta = twire.parse_frame(b)
    _, _, jm, ja = jwire.parse_frame(a)
    assert tm == jm == meta
    tv = twire.decode_payload(ta[1:], codec, x.shape, np.float32)
    jv = jwire.decode_payload(ja[1:], codec, x.shape, np.float32)
    assert np.array_equal(tv, jv)
    if codec == "bf16":
        assert isinstance(ta[1], twire.Bf16)
        assert ja[1].dtype == ml_dtypes.bfloat16


def test_bf16_rounding_matches_ml_dtypes_on_every_class_of_bits():
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2 ** 32, 200_000, dtype=np.uint64
                        ).astype(np.uint32)
    special = np.array([0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00001,
                        0x7F7FFFFF, 0x00000001, 0x80000000, 0x3F808000,
                        0x3F818000, 0x7F7F8000], np.uint32)
    x = np.concatenate([bits, special]).view(np.float32)
    got = twire.f32_to_bf16(x).view(np.uint16)
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    assert np.array_equal(got, want)
    assert np.array_equal(twire.bf16_to_f32(got),
                          want.view(ml_dtypes.bfloat16).astype(np.float32),
                          equal_nan=True)


def test_batch_frame_matches_jax_and_unpacks_in_both():
    rng = np.random.default_rng(3)
    subs = []
    for i in range(5):
        m = {"table": "b", "opt": AddOption(worker_id=i)._asdict()}
        arrs = [np.arange(i, i + 3), rng.normal(size=(3, 4)
                                                 ).astype(np.float32)]
        subs.append((m, arrs))
    tinner = [twire.encode(tsvc.MSG_ADD_ROWS, i, m, a)
              for i, (m, a) in enumerate(subs)]
    jinner = [jwire.encode(jsvc.MSG_ADD_ROWS, i, m, a)
              for i, (m, a) in enumerate(subs)]
    assert tinner == jinner
    a = twire.encode(tsvc.MSG_BATCH, 9, {"table": "b"},
                     twire.pack_batch(tinner))
    b = jwire.encode(jsvc.MSG_BATCH, 9, {"table": "b"},
                     jwire.pack_batch(jinner))
    assert a == b
    for parse, unpack, frame in ((twire.parse_frame, twire.unpack_batch, b),
                                 (jwire.parse_frame, jwire.unpack_batch, a)):
        mt, mid, meta, blobs = parse(frame)
        assert (mt, mid) == (tsvc.MSG_BATCH, 9)
        got = unpack(blobs)
        assert len(got) == 5
        for (gm_t, gm, ga), (m, arrs) in zip(got, subs):
            assert gm_t == tsvc.MSG_ADD_ROWS and gm == m
            for x, y in zip(ga, arrs):
                assert np.array_equal(x, y)
    with pytest.raises(twire.WireError):
        twire.pack_batch([])
    with pytest.raises(twire.WireError):
        twire.unpack_batch([np.zeros(1, np.uint8)] * (twire.MAX_BATCH_OPS
                                                      + 1))


def test_roundtrip_via_socket():
    a, b = socket.socketpair()
    meta = {"table": "t", "opt": {"worker_id": 3}}
    arrays = [np.arange(6, dtype=np.float32).reshape(2, 3),
              np.array(7, dtype=np.int64), np.zeros(0, dtype=np.float64),
              twire.f32_to_bf16(np.array([1.5, -2.25], np.float32))]
    twire.send(a, 0x11, 42, meta, arrays)
    msg_type, msg_id, meta2, arrays2 = twire.recv(b)
    assert (msg_type, msg_id, meta2) == (0x11, 42, meta)
    for x, y in zip(arrays, arrays2):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    assert isinstance(arrays2[3], twire.Bf16)
    np.testing.assert_array_equal(twire.bf16_to_f32(arrays2[3]),
                                  [1.5, -2.25])
    a.close(), b.close()


def test_negative_dim_rejected():
    a, b = socket.socketpair()
    payload = (b"{}" + struct.pack("<B", 3) + b"<i8" + struct.pack("<B", 1)
               + struct.pack("<q", -1) + bytes(24))
    a.sendall(twire._HEADER.pack(twire.MAGIC, 0x11, 0, 1, 2, 1,
                                 len(payload)) + payload)
    with pytest.raises(twire.WireError, match="negative dim"):
        twire.recv(b)
    a.close(), b.close()


def test_corrupt_meta_json_is_wire_error():
    bad_meta = b"{not json"
    frame = twire._HEADER.pack(twire.MAGIC, 0x11, 0, 7, len(bad_meta),
                               0, len(bad_meta)) + bad_meta
    with pytest.raises(twire.WireError, match="meta json"):
        twire.parse_frame(frame)
    assert twire.peek_msg_id(frame) == 7   # an ERR reply stays bindable
    with pytest.raises(twire.WireError):
        twire.parse_frame(frame[:10])


def test_bad_magic_raises():
    a, b = socket.socketpair()
    a.sendall(b"XXXX" + bytes(twire._HEADER.size - 4))
    with pytest.raises(twire.WireError):
        twire.recv(b)
    a.close(), b.close()


def test_service_survives_garbage_connections(port_ranks):
    t0 = ttables.AsyncMatrixTable(10, 2, name="g", ctx=port_ranks[0])
    ttables.AsyncMatrixTable(10, 2, name="g", ctx=port_ranks[1])
    host, port = port_ranks[1].service.addr.rsplit(":", 1)
    rng = np.random.default_rng(0)
    for payload in (
            rng.integers(0, 256, 64, dtype=np.uint8).tobytes(),
            b"MVPS" + bytes(4),
            twire.encode(0x11, 1, {"table": "g"})[:10],
            twire._HEADER.pack(twire.MAGIC, 0x11, 0, 1, twire.MAX_META + 1,
                               0, twire.MAX_META + 1),
            twire._HEADER.pack(twire.MAGIC, 0x11, 0, 1, 4, 0,
                               twire.MAX_FRAME + 1),
            twire._HEADER.pack(twire.MAGIC, 0x11, 0, 1, 4, 0, -8)):
        s = socket.create_connection((host, int(port)), timeout=5)
        s.sendall(payload)
        s.close()
    time.sleep(0.2)
    t0.add_rows([9], np.ones((1, 2), np.float32))
    np.testing.assert_allclose(t0.get_rows([9])[0], 1.0)


# ---------------------------------------------------------------------- #
# the service in a port world
# ---------------------------------------------------------------------- #
def test_different_row_sets_per_worker(port_ranks):
    t0 = ttables.AsyncMatrixTable(10, 4, name="m", ctx=port_ranks[0])
    t1 = ttables.AsyncMatrixTable(10, 4, name="m", ctx=port_ranks[1])
    t0.add_rows([0, 7], np.full((2, 4), 1.0, np.float32))
    t1.add_rows([3, 7, 9], np.full((3, 4), 2.0, np.float32))
    t1.add_rows([7], np.full((1, 4), 0.5, np.float32))
    got = t0.get_rows([0, 3, 7, 9])
    np.testing.assert_array_equal(got[:, 0], [1.0, 2.0, 3.5, 2.0])
    np.testing.assert_array_equal(t1.get_rows([7])[0], 3.5)
    assert t0.device.type == "cpu" and t0._shard._data.device.type == "cpu"


def test_uncoordinated_rates(port_ranks):
    t0 = ttables.AsyncMatrixTable(8, 2, name="r", ctx=port_ranks[0])
    t1 = ttables.AsyncMatrixTable(8, 2, name="r", ctx=port_ranks[1])

    def fast():
        for _ in range(50):
            t0.add_rows([1, 6], np.ones((2, 2), np.float32))

    def slow():
        for _ in range(5):
            t1.add_rows([1], np.ones((1, 2), np.float32))
            time.sleep(0.01)

    th = [threading.Thread(target=fast), threading.Thread(target=slow)]
    [x.start() for x in th]
    [x.join() for x in th]
    t0.flush(), t1.flush()
    got = t0.get_rows([1, 6])
    np.testing.assert_array_equal(got[:, 0], [55.0, 50.0])


def test_async_msg_ids_and_wait(port_ranks):
    t0 = ttables.AsyncMatrixTable(6, 3, name="w", ctx=port_ranks[0])
    ttables.AsyncMatrixTable(6, 3, name="w", ctx=port_ranks[1])
    mids = [t0.add_rows_async([i % 6], np.ones((1, 3), np.float32))
            for i in range(7)]
    gid = t0.get_rows_async([0, 1, 2, 3, 4, 5])
    for m in mids:
        t0.wait(m)
    rows = t0.wait(gid)
    assert rows.shape == (6, 3)
    np.testing.assert_array_equal(rows[:, 0], [2, 1, 1, 1, 1, 1])
    assert t0.wait(mids[0]) is None   # a consumed id


def test_errors_are_typed(port_ranks):
    t0 = ttables.AsyncMatrixTable(5, 2, name="e", ctx=port_ranks[0])
    with pytest.raises(IndexError):
        t0.add_rows([5], np.ones((1, 2), np.float32))
    with pytest.raises(TypeError):
        t0.get_rows([0.5])
    with pytest.raises(ValueError):
        t0.get_rows([])
    with pytest.raises(ValueError):
        ttables.AsyncMatrixTable(5, 2, name="e2", wire="fp8",
                                 ctx=port_ranks[0])


def test_chunked_replies_stream_into_the_buffer(port_ranks):
    """get_chunk_rows > 0: a remote get above it streams MSG_REPLY_CHUNK
    sub-frames that the client scatters as they land; the result equals
    the unchunked one, and the shard counts the chunks."""
    rng = np.random.default_rng(4)
    init = rng.normal(size=(40, 3)).astype(np.float32)
    t0 = ttables.AsyncMatrixTable(40, 3, name="ch", init=init,
                                  ctx=port_ranks[0])
    t1 = ttables.AsyncMatrixTable(40, 3, name="ch", init=init,
                                  ctx=port_ranks[1])
    tconfig.set_flag("get_chunk_rows", 6)
    ids = rng.permutation(40)[:30]
    np.testing.assert_array_equal(t0.get_rows(ids), init[ids])
    np.testing.assert_array_equal(t0.get(), init)
    assert t1._shard.stats()["get_chunks"] > 0
    assert t0._shard.stats()["get_chunks"] == 0   # the local rank never


def test_stats_and_health(port_ranks):
    t0 = ttables.AsyncMatrixTable(8, 2, name="st", ctx=port_ranks[0])
    ttables.AsyncMatrixTable(8, 2, name="st", ctx=port_ranks[1])
    t0.add_rows([1, 7], np.ones((2, 2), np.float32))
    remote = t0.server_stats(1)["shards"]["st"]
    assert remote["kind"] == "row" and remote["adds"] == 1
    assert remote["lo"] == 4 and remote["rows"] == 4
    assert t0.server_stats()["rank"] == 0
    h = t0.server_health(1)
    assert h["rank"] == 1 and h["status"] == "ok"
    assert h["serve_age_s"] is not None and h["queue_depth"] == 0
    assert port_ranks[0].service.stats_oneshot(1)["rank"] == 1
    assert port_ranks[0].service.ping(1)


def test_super_frame_dispatch(port_ranks):
    """MSG_MULTI: sub-ops naming their owners under "ow" run against the
    colocated shards, in order, one reply each; a failing sub-op fails
    alone. Over a socket and in-process (multi_local) alike."""
    t0 = ttables.AsyncMatrixTable(8, 2, name="mu", ctx=port_ranks[0])
    ttables.AsyncMatrixTable(8, 2, name="mu", ctx=port_ranks[1])
    svc0 = port_ranks[0].service
    opt = AddOption()._asdict()
    subs = [(tsvc.MSG_ADD_ROWS, {"table": "mu", "opt": opt, "ow": 0},
             [np.array([1]), np.ones((1, 2), np.float32)]),
            (tsvc.MSG_ADD_ROWS, {"table": "mu", "opt": opt, "ow": 1},
             [np.array([6]), np.full((1, 2), 2.0, np.float32)]),
            (tsvc.MSG_ADD_ROWS, {"table": "mu", "opt": opt, "ow": 1},
             [np.array([1]), np.ones((1, 2), np.float32)]),   # wrong owner
            (tsvc.MSG_GET_ROWS, {"table": "mu", "ow": 1}, [np.array([6])])]
    futs = svc0.multi_local(subs)
    assert futs[0].result(5) == ({}, [])
    with pytest.raises(tsvc.PSError, match="outside shard"):
        futs[2].result(5)
    np.testing.assert_array_equal(futs[3].result(5)[1][0], [[2.0, 2.0]])
    frames = [twire.encode(mt, i, m, a) for i, (mt, m, a) in enumerate(subs)]
    meta, blobs = svc0.request(1, tsvc.MSG_MULTI, {"n": 4},
                               twire.pack_batch(frames)).result(5)
    replies = twire.unpack_batch(blobs)
    assert [r[0] for r in replies] == [tsvc.MSG_REPLY_OK, tsvc.MSG_REPLY_OK,
                                       tsvc.MSG_REPLY_ERR, tsvc.MSG_REPLY_OK]
    np.testing.assert_array_equal(replies[3][2][0], [[4.0, 4.0]])
    np.testing.assert_array_equal(t0.get_rows([1, 6])[:, 0], [2.0, 4.0])


# ---------------------------------------------------------------------- #
# failure semantics
# ---------------------------------------------------------------------- #
def test_idle_connection_survives_timeout(tmp_path):
    tconfig.set_flag("ps_timeout", 0.5)
    rdv = tsvc.FileRendezvous(str(tmp_path / "rdv"))
    ctxs = [tsvc.PSContext(r, 2, tsvc.PSService(r, 2, rdv), device="cpu")
            for r in range(2)]
    try:
        t0 = ttables.AsyncMatrixTable(10, 2, name="idle", ctx=ctxs[0])
        ttables.AsyncMatrixTable(10, 2, name="idle", ctx=ctxs[1])
        t0.add_rows([9], np.ones((1, 2), np.float32))   # open the conn
        time.sleep(1.2)                                 # > ps_timeout idle
        np.testing.assert_array_equal(t0.get_rows([9])[0], 1.0)
    finally:
        for c in ctxs:
            c.close()


def test_first_contact_dead_peer_yields_failed_future(port_ranks):
    t0 = ttables.AsyncMatrixTable(10, 2, name="fc", ctx=port_ranks[0])
    ttables.AsyncMatrixTable(10, 2, name="fc", ctx=port_ranks[1])
    port_ranks[1].close()   # dies before rank 0 ever dials it
    time.sleep(0.1)
    start = time.monotonic()
    mid = t0.add_rows_async([1, 9], np.ones((2, 2), np.float32))
    with pytest.raises(tsvc.PSPeerError):
        t0.wait(mid)
    assert time.monotonic() - start < 12.0
    np.testing.assert_array_equal(t0.get_rows([1])[0], 1.0)


def test_flush_surfaces_swept_failures(port_ranks):
    t0 = ttables.AsyncMatrixTable(10, 2, name="sf", ctx=port_ranks[0])
    ttables.AsyncMatrixTable(10, 2, name="sf", ctx=port_ranks[1])
    t0.add_rows([9], np.ones((1, 2), np.float32))
    port_ranks[1].close()
    time.sleep(0.1)
    t0.add_rows_async([8], np.ones((1, 2), np.float32))   # will fail
    time.sleep(0.3)
    t0._SWEEP_THRESHOLD = 1   # sweep at the next ops, before the flush
    for _ in range(3):        # sweeps must not raise (no poisoning)
        t0.add_rows([1], np.ones((1, 2), np.float32))
    assert t0._swept_failures
    with pytest.raises(tsvc.PSPeerError):
        t0.flush()
    t0.flush()   # failure consumed; the table stays usable
    np.testing.assert_array_equal(t0.get_rows([1])[0], 3.0)


def test_dead_peer_does_not_hang_live_traffic(port_ranks):
    t0 = ttables.AsyncMatrixTable(10, 2, name="dp", ctx=port_ranks[0])
    ttables.AsyncMatrixTable(10, 2, name="dp", ctx=port_ranks[1])
    t0.add_rows([0, 9], np.ones((2, 2), np.float32))
    t0.flush()
    port_ranks[1].close()
    time.sleep(0.1)
    t0.add_rows([1], np.ones((1, 2), np.float32))
    np.testing.assert_array_equal(t0.get_rows([1])[0], 1.0)
    start = time.monotonic()
    with pytest.raises(tsvc.PSPeerError):
        t0.get_rows([9])
    assert time.monotonic() - start < 10.0
    assert 1 in port_ranks[0].service.dead_ranks()
    # inside the reconnect backoff a request fails fast
    start = time.monotonic()
    with pytest.raises(tsvc.PSPeerError):
        t0.get_rows([9])
    assert time.monotonic() - start < 1.0


def test_stale_incarnation_death_is_ignored(port_ranks):
    svc0 = port_ranks[0].service
    assert svc0.ping(1)
    cur = svc0._peers[1]
    svc0._note_death(1, peer=types.SimpleNamespace())   # stale object
    assert 1 not in svc0.dead_ranks()
    svc0._note_death(1, peer=cur)   # the live incarnation does count
    assert 1 in svc0.dead_ranks()
    assert svc0._peer(1) is cur     # a healthy peer clears it
    assert 1 not in svc0.dead_ranks()


def test_bind_ps_tombstone_is_read_by_both_packages(port_ranks, tmp_path):
    from multiverso_tpu import elastic as jelastic
    hb = str(tmp_path / "hb")
    telastic.bind_ps(hb, port_ranks[0])
    t0 = ttables.AsyncMatrixTable(8, 2, name="tomb", ctx=port_ranks[0])
    ttables.AsyncMatrixTable(8, 2, name="tomb", ctx=port_ranks[1])
    t0.add_rows([7], np.ones((1, 2), np.float32))   # an established conn
    assert telastic.failed(hb) == []
    port_ranks[1].service.close()
    with pytest.raises(tsvc.PSError):
        t0.get_rows([7])
    deadline = time.monotonic() + 5
    while telastic.failed(hb) != [1] and time.monotonic() < deadline:
        time.sleep(0.02)
    assert telastic.failed(hb) == [1]
    assert jelastic.failed(hb) == [1]
    # a first-contact failure is backoff only: no tombstone for rank 2
    telastic.mark_failed(hb, 3, addr="127.0.0.1:1")
    assert telastic.failed(hb) == [1, 3] == jelastic.failed(hb)


def test_quiesce_converges(port_ranks):
    tconfig.set_flag("ps_shutdown_grace", 30.0)
    t0 = time.monotonic()
    th = threading.Thread(target=lambda: port_ranks[0].quiesce())
    th.start()
    time.sleep(0.15)            # rank 0 waits on rank 1's mark
    port_ranks[1].quiesce()
    th.join(timeout=10)
    assert not th.is_alive()
    assert time.monotonic() - t0 < 10


def test_quiesce_times_out_without_the_peer(port_ranks):
    tconfig.set_flag("ps_shutdown_grace", 0.4)
    t0 = time.monotonic()
    port_ranks[0].quiesce()     # rank 1 never marks
    assert 0.3 < time.monotonic() - t0 < 5.0


def test_quiesce_skips_an_observed_dead_peer(port_ranks):
    tconfig.set_flag("ps_shutdown_grace", 30.0)
    t = ttables.AsyncMatrixTable(8, 2, name="qd", ctx=port_ranks[0])
    ttables.AsyncMatrixTable(8, 2, name="qd", ctx=port_ranks[1])
    t.add_rows([7], np.ones((1, 2), np.float32))
    port_ranks[1].service.close()
    with pytest.raises(Exception):
        t.get_rows([7])
    assert 1 in port_ranks[0].service.dead_ranks()
    t0 = time.monotonic()
    port_ranks[0].quiesce()
    assert time.monotonic() - t0 < 5.0


def test_stale_markers_from_previous_run_ignored(tmp_path):
    rdv = tsvc.FileRendezvous(str(tmp_path / "r"))
    rdv.mark(1, "ps_quiesce", "127.0.0.1:1111")   # previous run
    rdv.publish(1, "127.0.0.1:2222")              # current incarnation
    assert not rdv.wait_mark(1, "ps_quiesce", 0.2, expect="127.0.0.1:2222")
    rdv.mark(1, "ps_quiesce", "127.0.0.1:2222")
    assert rdv.wait_mark(1, "ps_quiesce", 1.0, expect="127.0.0.1:2222")
    # the JAX package's rendezvous reads the same files
    assert jsvc.FileRendezvous(str(tmp_path / "r")).lookup(1, 1.0) == \
        "127.0.0.1:2222"


# ---------------------------------------------------------------------- #
# a mixed world: rank 0 JAX, rank 1 the port
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("wire", ["none", "bf16"])
def test_mixed_world_sums_exactly(tmp_path, wire):
    """A JAX rank and a port rank meet in one rendezvous directory and
    serve each other's rows: adds from both, in a fixed order, then gets
    from both equal the numpy model bit for bit (bf16: the model adds the
    bf16-rounded deltas that crossed the wire; the local rank's adds stay
    f32)."""
    rdv_dir = str(tmp_path / "mixed")
    jctx = jsvc.PSContext(0, 2, jsvc.PSService(0, 2,
                                               jsvc.FileRendezvous(rdv_dir)))
    tctx = tsvc.PSContext(1, 2, tsvc.PSService(1, 2,
                                               tsvc.FileRendezvous(rdv_dir)),
                          device="cpu")
    try:
        rows, cols = 23, 6
        jt = jtables.AsyncMatrixTable(rows, cols, name="mx", wire=wire,
                                      ctx=jctx)
        tt = ttables.AsyncMatrixTable(rows, cols, name="mx", wire=wire,
                                      ctx=tctx)
        rng = np.random.default_rng(5)
        model = np.zeros((rows, cols), np.float32)
        rows_per = -(-rows // 2)
        for step in range(12):
            table, rank = (jt, 0) if step % 2 == 0 else (tt, 1)
            ids = rng.choice(rows, 7, replace=False)
            vals = rng.normal(size=(7, cols)).astype(np.float32)
            table.add_rows(ids, vals)
            for i, v in zip(ids, vals):
                remote = (i // rows_per) != rank
                if wire == "bf16" and remote:
                    v = twire.bf16_to_f32(twire.f32_to_bf16(v))
                model[i] += v
        jget = jt.get_rows(np.arange(rows))
        tget = tt.get_rows(np.arange(rows))
        if wire == "none":
            assert np.array_equal(jget, model)
            assert np.array_equal(tget, model)
            assert np.array_equal(jt.get(), tt.get())
        else:
            # a get reply from the other rank rides bf16 too
            lo = slice(0, rows_per)
            hi = slice(rows_per, rows)
            assert np.array_equal(jget[lo], model[lo])
            assert np.array_equal(tget[hi], model[hi])
            assert np.array_equal(
                jget[hi], twire.bf16_to_f32(twire.f32_to_bf16(model[hi])))
            assert np.array_equal(
                tget[lo], twire.bf16_to_f32(twire.f32_to_bf16(model[lo])))
        # the KV table crosses too
        jk = jtables.AsyncKVTable(name="mkv", ctx=jctx)
        tk = ttables.AsyncKVTable(name="mkv", ctx=tctx)
        jk.add([0, 1, 2], [1.0, 1.0, 1.0])
        tk.add([1, 2, 3], [2.0, 2.0, 2.0])
        assert jk.get() == tk.get() == {0: 1.0, 1: 3.0, 2: 3.0, 3: 2.0}
    finally:
        tctx.close()
        jctx.close()


# ---------------------------------------------------------------------- #
# the pinned read
# ---------------------------------------------------------------------- #
def test_pinned_epoch_is_never_written_in_place():
    upd = get_updater("adagrad")
    s = RowShard(0, 6, 3, np.float32, upd, "pin", device="cpu",
                 init=np.ones((6, 3), np.float32))
    pin = s._pin_data()
    before = pin.data.clone()
    s._apply_rows(np.array([1, 4]), np.ones((2, 3), np.float32),
                  AddOption())
    assert s._data is not pin.data and s._stat_cow == 1
    assert torch_equal(pin.data, before)             # the epoch held
    s._release_data(pin)
    # no pin: the apply writes in place
    live = s._data
    s._apply_rows(np.array([2]), np.ones((1, 3), np.float32), AddOption())
    assert s._data is live and s._stat_cow == 1
    assert s.stats()["cow_applies"] == 1


def torch_equal(a, b):
    return bool((a == b).all())


def test_get_racing_adds_sees_whole_rows(port_ranks):
    """Adds from rank 0 (served on rank 1's connection thread) race gets
    of the same rows from rank 1 (its local executor thread): every row a
    get returns is one epoch's row — all columns equal, since each add
    moves every column of a row by the same amount."""
    rows, cols = 16, 16_384
    init = np.repeat(np.arange(rows, dtype=np.float32)[:, None], cols, 1)
    t0 = ttables.AsyncMatrixTable(rows, cols, name="race", init=init,
                                  ctx=port_ranks[0])
    t1 = ttables.AsyncMatrixTable(rows, cols, name="race", init=init,
                                  ctx=port_ranks[1])
    ids = np.arange(8, 16)   # rank 1's rows
    stop = threading.Event()

    def adder():
        while not stop.is_set():
            t0.add_rows(ids, np.ones((ids.size, cols), np.float32))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    th = threading.Thread(target=adder)
    th.start()
    try:
        seen = set()
        for _ in range(60):
            got = t1.get_rows(ids)
            assert (got == got[:, :1]).all(), "a torn row"
            seen.add(float(got[0, 0]))
    finally:
        stop.set()
        th.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not th.is_alive()
    assert len(seen) > 1   # the gets did race the adds


def test_concurrent_hammer_sums_exactly(port_ranks):
    """More client threads than cores, over both ranks' sockets and local
    executors: overlapping random batches of small integers (exact in
    f32 in any order), so the coalescing queue merges concurrent adds;
    the grand total is exact, and the shards count every add."""
    t0 = ttables.AsyncMatrixTable(64, 8, name="hammer", ctx=port_ranks[0])
    t1 = ttables.AsyncMatrixTable(64, 8, name="hammer", ctx=port_ranks[1])
    rng = np.random.default_rng(7)
    batches = [(rng.choice(64, size=16, replace=False),
                rng.integers(-3, 4, size=(16, 8)).astype(np.float32))
               for _ in range(96)]
    expect = np.zeros((64, 8), np.float32)
    for ids, vals in batches:
        np.add.at(expect, ids, vals)
    nthreads = 4 * (os.cpu_count() or 2)

    def work(table, chunk):
        for ids, vals in chunk:
            table.add_rows(ids, vals)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work,
                                    args=((t0, t1)[i % 2],
                                          batches[i::nthreads]))
                   for i in range(nthreads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    np.testing.assert_array_equal(t0.get_rows(np.arange(64)), expect)
    adds = sum(t._shard.stat_adds for t in (t0, t1))
    applies = sum(t._shard.stat_applies for t in (t0, t1))
    assert adds == sum(np.unique(ids // 32).size for ids, _ in batches)
    assert applies <= adds


# ---------------------------------------------------------------------- #
# refusals
# ---------------------------------------------------------------------- #
def test_ps_native_raises_naming_its_item():
    assert tconfig.get_flag("ps_native") is False
    tconfig.set_flag("ps_native", True)
    with pytest.raises(NotImplementedError, match="native plane"):
        tsvc.PSService(0, 1)
    assert tsvc.NATIVE_ITEM in ROADMAP


def test_ps_replay_raises_naming_its_item(port_ranks):
    """Once a refusal, now the replay plane: ``ps_replay=True`` builds a
    table (no NotImplementedError), and a replay-stamped frame — as a JAX
    client sends it — applies once at the shard and acks a second copy as
    a duplicate with the durable floor, bit for bit against numpy."""
    tconfig.set_flag("ps_replay", True)
    t = ttables.AsyncMatrixTable(4, 2, name="rp", ctx=port_ranks[0])
    ttables.AsyncMatrixTable(4, 2, name="rp", ctx=port_ranks[1])
    assert t._window is None   # replay rides the send window only
    tconfig.set_flag("ps_replay", False)
    t2 = ttables.AsyncMatrixTable(4, 2, name="rp2", ctx=port_ranks[0])
    meta = {"table": "rp2", "opt": {}, jwire.REPLAY_CLIENT_KEY: "c",
            jwire.REPLAY_SEQ_KEY: 0}
    arrays = [np.array([0]), np.ones((1, 2), np.float32)]
    r1, _ = t2._shard.handle(tsvc.MSG_ADD_ROWS, meta, arrays)
    r2, _ = t2._shard.handle(tsvc.MSG_ADD_ROWS, meta, arrays)
    assert not r1.get(jwire.REPLAY_DUP_KEY)
    assert r1[jwire.REPLAY_DURABLE_KEY] == -1
    assert r2[jwire.REPLAY_DUP_KEY] is True
    np.testing.assert_array_equal(t2.get_rows([0, 1]),
                                  np.array([[1, 1], [0, 0]], np.float32))
    assert t2._shard.stats()["dup_frames"] == 1


def test_world_without_rendezvous_raises_naming_its_item():
    tconfig.set_flag("ps_world", 2)
    tconfig.set_flag("ps_rank", 0)
    with pytest.raises(NotImplementedError, match="rendezvous without a "
                                                  "file"):
        tsvc.default_context()
    assert tsvc.NO_FILE_RDV_ITEM in ROADMAP
    tconfig.set_flag("ps_rank", -1)
    with pytest.raises(tsvc.PSError, match="ps_rank"):
        tsvc.default_context()


def test_default_context_world_one_on_the_zoo_device():
    """``ps_world <= 0`` is a world of 1 (rank 0) on the Zoo's device; the
    context closes at shutdown."""
    import multiverso_tpu_torch as tmv
    tmv.init(device="cpu")
    t = tmv.AsyncMatrixTable(6, 2, name="d1")
    ctx = tsvc.default_context()
    assert (ctx.rank, ctx.world, ctx.device.type) == (0, 1, "cpu")
    assert t.table_id is not None
    t.add_rows([5], np.ones((1, 2), np.float32))
    np.testing.assert_array_equal(t.get_row(5), 1.0)
    tmv.shutdown()
    assert tsvc._default_ctx is None


def test_context_without_device_needs_the_card(monkeypatch, tmp_path):
    """A rank's shards live on the card unless the caller asks for the
    CPU: with no Zoo and no CUDA, a context (and a train cache) without a
    device raises instead of quietly landing on the CPU."""
    import torch
    from multiverso_tpu_torch.serving import hotcache as thc
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    svc = tsvc.PSService(0, 1)
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsvc.PSContext(0, 1, svc)
        assert tsvc.PSContext(0, 1, svc, device="cpu").device.type == "cpu"
    finally:
        svc.close()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thc.HotRowCache(4)
