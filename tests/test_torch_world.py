"""Port parity, the multi-process world (``multiverso_tpu_torch``'s
``net_init``, the Zoo's world, the collective table adds and unions,
``aggregate``, ``StoreRendezvous``): N real processes of each package on
this CPU, on the same inputs.

* The JAX package's own ``tests/multiprocess_worker.py`` at worlds 2 and
  4 beside the port's ``tests/torch_world_worker.py`` doing the same
  steps, its ranks started as a launcher starts them (``MASTER_ADDR``,
  ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) and met through
  ``net_init()`` over gloo: every ``RESULT`` key equal between the two
  and to ``tests/test_multiprocess.py``'s closed forms, the keys that
  differ by design held to their own rule.
* Seeded inputs at world 2 (``tests/jax_world_worker.py`` for the JAX
  package): overlapping and repeated row adds (default updater and
  AdaGrad), whole-table adds (numpy and tensor deltas, SGD, the bf16
  wire), KV adds with the global Get, the sparse table across a union
  add, ``aggregate`` of a non-contiguous array, ``mv_shared``. Bit for
  bit, AdaGrad within rtol 1e-5 / atol 1e-6 (ROADMAP C.4).
* The sharded layout: at worlds 2 and 4 each rank holds its block of
  every table and of its row-shaped updater state, and ``sharding``
  says which; row reads with each rank's own ids; the sparse protocol
  with one worker id on every rank; a checkpoint of the sharded world
  of 2 loaded into one-process tables of both packages, and a
  one-process checkpoint restored into the sharded world, bit for bit.
* The sharded checkpoint (``backend="orbax"``): the world of 2 (the
  seeded run) and the world of 4 (the scenario run) each save their
  blocks, blocking and not, and restore their own tag, a one-process
  tag and the other world's (each waits for the other's commit marker);
  every file holds exactly its rank's block, no rank gathers, and each
  restore is bit for bit, as is a one-process restore of the world of
  2's tag and the JAX package's orbax round trip of the same state on
  its 8-device mesh; ``ElasticLoop`` resumes on it at both worlds.
* ``StoreRendezvous`` in one process, and a two-service async world over
  it against the ``FileRendezvous`` world bit for bit.
* ``examples/mlp_data_parallel.py`` at two ranks against the JAX
  example's printed losses, and ``examples/transformer_ps.py`` unchanged
  under a launcher.

Every process has a timeout, and so has every gloo group
(``net_timeout_s``), so a hang fails a test instead of the run.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
from datetime import timedelta

import numpy as np
import pytest
import torch

import torch_world_worker as tw

_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_DIR)
_TIMEOUT = 150
ADAGRAD_RTOL, ADAGRAD_ATOL = 1e-5, 1e-6
SEED = 11


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**kw):
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update({k: str(v) for k, v in kw.items()})
    return env


def _start(cmds):
    """Popen each (argv, env); stdout/stderr captured."""
    return [subprocess.Popen(argv, env=env, cwd=_REPO, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for argv, env in cmds]


def _collect(procs):
    """[(rc, stdout, stderr)] in order; every process ends (killed at the
    timeout)."""
    out = [None] * len(procs)

    def wait(i, p):
        try:
            o, e = p.communicate(timeout=_TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            o, e = p.communicate()
            e += f"\n(killed after {_TIMEOUT} s)"
        out[i] = (p.returncode, o, e)

    threads = [threading.Thread(target=wait, args=(i, p))
               for i, p in enumerate(procs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def _results(outs, what):
    res = []
    for r, (rc, o, e) in enumerate(outs):
        assert rc == 0, f"{what} rank {r} rc={rc}\n{e[-3000:]}"
        lines = [l for l in o.splitlines() if l.startswith("RESULT ")]
        assert lines, f"{what} rank {r} printed no RESULT\n{e[-2000:]}"
        res.append(json.loads(lines[-1][len("RESULT "):]))
    return res


def _port_world(world, argv):
    """A port world started as a launcher starts one; its raw outputs. A
    world whose store lost its free port to another process is started
    once more (the bind-then-close pick is racy)."""
    for attempt in range(2):
        port = _free_port()
        outs = _collect(_start([
            (argv, _env(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=r,
                        WORLD_SIZE=world, LOCAL_RANK=r))
            for r in range(world)]))
        if all(rc == 0 for rc, _, _ in outs) or not any(
                "address already in use" in e.lower() for _, _, e in outs):
            return outs
    return outs


def _both(world, port_argv, jax_script, jax_extra=()):
    """Both packages' worlds at once (the JAX one unchanged, through
    jax.distributed); their raw outputs (port, JAX)."""
    port = _free_port()
    jprocs = _start([([sys.executable, os.path.join(_DIR, jax_script),
                       f"127.0.0.1:{port}", str(world), str(r), *jax_extra],
                      _env()) for r in range(world)])
    outs = _port_world(world, port_argv)
    return outs, _collect(jprocs)


_WORKER = [sys.executable, os.path.join(_DIR, "torch_world_worker.py")]
_CKPT = tempfile.mkdtemp(prefix="mv_world_ckpt_")
_RUNS = {
    "scenario2": lambda: _both(2, _WORKER + ["scenario"],
                               "multiprocess_worker.py"),
    "scenario4": lambda: _both(4, _WORKER + ["scenario", "--ckpt", _CKPT],
                               "multiprocess_worker.py"),
    "seeded": lambda: _both(2, _WORKER + ["seeded", "--seed", str(SEED),
                                          "--ckpt", _CKPT],
                            "jax_world_worker.py",
                            ("seeded", "--seed", str(SEED))),
    "mlp": lambda: _both(
        2, [sys.executable, "-m",
            "multiverso_tpu_torch.examples.mlp_data_parallel", "--device",
            "cpu"], "jax_world_worker.py", ("mlp",)),
    "lm": lambda: _port_world(2, [
        sys.executable, "-m", "multiverso_tpu_torch.examples.transformer_ps",
        "--device", "cpu", "--steps", "4", "--sync-every", "2"]),
}
_CONCURRENT_RUNS = 3


@pytest.fixture(scope="module")
def runs():
    """Every world of this file, started once, a few at a time; each
    entry its raw outputs or the error that stopped it. The one-process
    checkpoint the seeded world restores is saved here first (its state
    under ``"one"``); the checkpoints' directory goes with the module."""
    from concurrent.futures import ThreadPoolExecutor
    out = {"one": tw.one_process_checkpoint(_CKPT, SEED)}
    with ThreadPoolExecutor(_CONCURRENT_RUNS) as pool:
        futs = {name: pool.submit(fn) for name, fn in _RUNS.items()}
    for name, fut in futs.items():
        try:
            out[name] = fut.result()
        except Exception as e:   # noqa: BLE001 — raised in its tests
            out[name] = e
    yield out
    shutil.rmtree(_CKPT, ignore_errors=True)


def _run(runs, name):
    got = runs[name]
    if isinstance(got, Exception):
        raise got
    return got


def _parsed(runs, name):
    port, jax_ = _run(runs, name)
    return _results(port, "port"), _results(jax_, f"JAX {name}")


# ---------------------------------------------------------------------- #
# (1) the JAX package's scenario, side by side
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("world", [2, 4])
def test_scenario_matches_the_jax_world(runs, world):
    port, jax_ = _parsed(runs, f"scenario{world}")
    want = tw.closed_forms(world)
    for r in range(world):
        assert port[r]["rank"] == jax_[r]["rank"] == r
        keys = set(jax_[r]) - set(tw.BY_DESIGN)
        assert keys == set(port[r]) - set(tw.BY_DESIGN) - set(tw.PORT_ONLY)
        for k in sorted(keys):
            assert port[r][k] == jax_[r][k], (r, k)
        for k, v in want.items():
            assert port[r][k] == v, (r, k)


@pytest.mark.parametrize("world", [2, 4])
def test_scenario_keys_that_differ_by_design(runs, world):
    """The JAX worker runs 2 CPU devices a process and its tables shard
    over all of them; each port process is one rank of the mesh, one
    device, and its tables shard over the ranks. The JAX async plane
    meets at the jax.distributed coordinator's store, the port's at the
    torch.distributed world's."""
    port, jax_ = _parsed(runs, f"scenario{world}")
    for r in range(world):
        assert jax_[r]["devices"] == jax_[r]["num_servers"] == 2 * world
        assert port[r]["devices"] == port[r]["num_servers"] == world
        assert jax_[r]["rendezvous"] == "JaxRendezvous"
        assert port[r]["rendezvous"] == "StoreRendezvous"


# ---------------------------------------------------------------------- #
# (2) seeded inputs, world 2
# ---------------------------------------------------------------------- #
EXACT = ("rows_default", "array", "array_sgd", "array_bf16",
         "sparse_before", "sparse_after", "aggregate")


@pytest.mark.parametrize("key", EXACT)
def test_seeded_tables_bit_for_bit(runs, key):
    port, jax_ = _parsed(runs, "seeded")
    for r in range(2):
        np.testing.assert_array_equal(np.asarray(port[r][key], np.float32),
                                      np.asarray(jax_[r][key], np.float32),
                                      err_msg=f"rank {r} {key}")


def test_seeded_adagrad_rows_within_tolerance(runs):
    port, jax_ = _parsed(runs, "seeded")
    for r in range(2):
        np.testing.assert_allclose(port[r]["rows_adagrad"],
                                   jax_[r]["rows_adagrad"],
                                   rtol=ADAGRAD_RTOL, atol=ADAGRAD_ATOL)


def test_a_tensor_delta_is_its_ranks_contribution(runs):
    """A tensor delta is summed over the world like a numpy one: the
    table equals the JAX package's after its numpy (host) deltas."""
    port, jax_ = _parsed(runs, "seeded")
    for r in range(2):
        np.testing.assert_array_equal(np.asarray(port[r]["array_tensor"],
                                                 np.float32),
                                      np.asarray(jax_[r]["array"],
                                                 np.float32))


def test_seeded_replicas_stay_equal(runs):
    """Every rank's whole-table Get gathers the same blocks: the ranks'
    Gets equal each other bit for bit (AdaGrad too)."""
    port, _ = _parsed(runs, "seeded")
    for key in EXACT[:-1] + ("rows_adagrad", "array_tensor",
                             "rows_mine_get", "sparse_w0_get"):
        if key.startswith("sparse_"):
            continue
        np.testing.assert_array_equal(
            np.asarray(port[0][key], np.float32).view(np.uint32),
            np.asarray(port[1][key], np.float32).view(np.uint32),
            err_msg=key)
    assert port[0]["shared"] == port[1]["shared"]
    assert port[0]["kv_global"] == port[1]["kv_global"]
    assert port[0]["sparse_w0_get"] == port[1]["sparse_w0_get"]


def test_seeded_kv_and_shared(runs):
    port, jax_ = _parsed(runs, "seeded")
    x = [tw.seeded_inputs(SEED, r) for r in range(2)]
    want = {}
    for xi in x:
        for k, v in zip(xi["kv_keys"], xi["kv_vals"]):
            want[str(k)] = want.get(str(k), 0.0) + float(v)
    for r in range(2):
        assert port[r]["kv_global"] == jax_[r]["kv_global"] == dict(
            sorted(want.items()))
        assert port[r]["kv_local"] == jax_[r]["kv_local"]
        for k in port[r]["shared"]:
            np.testing.assert_array_equal(
                np.asarray(port[r]["shared"][k], np.float32),
                np.asarray(jax_[r]["shared"][k], np.float32))


def test_seeded_sparse_dirty_bits_cover_the_union(runs):
    """After the union add every rank pulls the rows any rank added: the
    stale share of its next full pull is the union's, not its own."""
    port, jax_ = _parsed(runs, "seeded")
    x = [tw.seeded_inputs(SEED, r) for r in range(2)]
    union = set(x[0]["sparse_rows"]) | set(x[1]["sparse_rows"])
    for r in range(2):
        assert port[r]["sparse_stale"] == jax_[r]["sparse_stale"] == 0.0
        moved = np.any(np.asarray(port[r]["sparse_after"])
                       != np.asarray(port[r]["sparse_before"]), axis=1)
        assert set(np.flatnonzero(moved).tolist()) == union


def test_seeded_aggregate_in_place_on_a_view(runs):
    port, jax_ = _parsed(runs, "seeded")
    x = [tw.seeded_inputs(SEED, r)["agg"] for r in range(2)]
    for r in range(2):
        assert port[r]["aggregate_in_place"] and jax_[r]["aggregate_in_place"]
        got = np.asarray(port[r]["aggregate"], np.float32)
        np.testing.assert_array_equal(got[:, ::2], x[0][:, ::2] + x[1][:, ::2])
        np.testing.assert_array_equal(got[:, 1::2], x[r][:, 1::2])


# ---------------------------------------------------------------------- #
# (2b) the sharded layout
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_holds_its_block(runs, world):
    """Every table of the scenario (two MatrixTables, a SparseMatrixTable
    and an AdaGrad ArrayTable) keeps padded_rows / world rows on each
    rank, in its data, its row-shaped updater state and the sparse
    table's dirty bits, and ``sharding`` reports rank r's range."""
    port, _ = _parsed(runs, f"scenario{world}")
    for r in range(world):
        lay = port[r]["layout"]
        assert len(lay) == 4
        for name, t in lay.items():
            block = t["padded_rows"] // world
            assert t["padded_rows"] % world == 0, name
            assert t["num_shards"] == world and t["axis"] == "mv", name
            assert t["data_rows"] == block, name
            assert t["rows"] == [r * block, (r + 1) * block], name
            assert all(n == block for n in t["ustate_rows"].values()), name
            if "dirty_shape" in t:
                assert t["dirty_shape"] == [world, block], name
        assert lay["mp_layout_adagrad"]["ustate_rows"] == {
            "g_sqr": lay["mp_layout_adagrad"]["data_rows"]}


def test_get_rows_with_each_ranks_own_ids(runs):
    """Each rank reads its own ids (rank 0's all in the other rank's
    block, repeated; rank 1's across both blocks, out of order): each
    gets exactly those rows of the table's Get."""
    port, _ = _parsed(runs, "seeded")
    for r in range(2):
        ids = port[r]["rows_mine_ids"]
        assert ids == tw.own_ids(r)
        whole = np.asarray(port[r]["rows_mine_get"], np.float32)
        np.testing.assert_array_equal(
            np.asarray(port[r]["rows_mine"], np.float32), whole[ids])
    np.testing.assert_array_equal(np.asarray(port[0]["rows_mine_get"]),
                                  np.asarray(port[0]["rows_default"]))


def test_sparse_protocol_with_one_worker_id_on_every_rank(runs):
    """Both ranks pull as worker 0 (the harness's matrix entry): each is
    served every row, the first pull the seeded init and the second the
    table after the union add, and the stale share after the add is the
    union's."""
    port, _ = _parsed(runs, "seeded")
    x = [tw.seeded_inputs(SEED, r) for r in range(2)]
    union = set(x[0]["sparse_rows"]) | set(x[1]["sparse_rows"])
    for r in range(2):
        first, second = (np.asarray(a, np.float32)
                         for a in port[r]["sparse_w0"])
        np.testing.assert_array_equal(
            first, np.asarray(port[r]["sparse_before"], np.float32))
        np.testing.assert_array_equal(
            second, np.asarray(port[r]["sparse_w0_get"], np.float32))
        np.testing.assert_array_equal(
            second, np.asarray(port[r]["sparse_after"], np.float32))
        assert port[r]["sparse_w0_stale"] == len(union) / tw.SEEDED_ROWS


def test_whole_state_paths_refuse_a_block_and_params_gather(runs):
    """At a table axis of 2 a fused path runs on the whole gathered table
    (LogReg's ``train_arrays``, the same blobs on both ranks): both
    ranks' Gets equal the one-process port's bit for bit. And
    TorchParamManager's pull gathers the blocks: both ranks start from
    rank 0's module and, after one sync in which rank r added r + 1 to
    every parameter, hold that init + 3."""
    port, _ = _parsed(runs, "seeded")
    import multiverso_tpu_torch as mv
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # as the ranks run
    mv.init(device="cpu")
    try:
        want = tw.fused_lr()
    finally:
        mv.shutdown()
        torch.set_num_threads(threads)
    for r in range(2):
        np.testing.assert_array_equal(
            np.asarray(port[r]["fused_lr"], np.float32), want)
    assert np.abs(want).max() > 1e-2          # trained
    init = port[0]["tpm_init"]
    assert port[1]["tpm_init"] == init
    for r in range(2):
        for got, p0 in zip(port[r]["tpm_synced"], init):
            np.testing.assert_array_equal(
                np.asarray(got, np.float32),
                np.asarray(p0, np.float32) + np.float32(3.0))


def _leaves_equal(got, want, what):
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, what
        np.testing.assert_array_equal(g, w, err_msg=what)


def _one_process_loads(pkg, tag):
    """``tag`` of the checkpoints' directory restored into one-process
    tables of ``pkg`` (``"port"`` or ``"jax"``, the JAX package on one
    CPU device): each table's Get and stored updater-state leaves."""
    import io
    if pkg == "port":
        import multiverso_tpu_torch as mv
        from multiverso_tpu_torch import checkpoint
        mv.init(device="cpu")
        try:
            tables = tw.ckpt_tables(mv)
            checkpoint.restore(_CKPT, tag=tag)
            return {t.name: {"get": t.get(),
                             "leaves": [np.asarray(leaf) for leaf in
                                        t._stored_arrays()[1]]}
                    for t in tables}
        finally:
            mv.shutdown()
    import jax
    import multiverso_tpu as jmv
    from multiverso_tpu import checkpoint as jcheckpoint
    jmv.init(mesh=jax.sharding.Mesh(np.array(jax.devices()[:1]), ("mv",)))
    try:
        # the JAX load takes its own padding only: the odd tables
        tables = tw.ckpt_tables(jmv, even=False)
        jcheckpoint.restore(_CKPT, tag=tag)
        out = {}
        for t in tables:
            buf = io.BytesIO()
            t.store(buf)
            buf.seek(0)
            np.load(buf)
            leaves = [np.load(buf) for _ in range(int(np.load(buf)))]
            out[t.name] = {"get": np.asarray(t.get()), "leaves": leaves}
        return out
    finally:
        jmv.shutdown()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_sharded_checkpoint_loads_into_one_process_tables(runs, pkg):
    """The world of 2 saved its sharded tables (rank 0 wrote the whole
    of each, at the padding of one block): one-process tables of either
    package restore it, and their Gets and updater-state leaves equal the
    world's bit for bit (the port's even-row table too, whose padding at
    two blocks differs); the ``block=False`` save wrote the same
    bytes."""
    port, _ = _parsed(runs, "seeded")
    saved = port[0]["ckpt"]["saved"]
    assert saved == port[1]["ckpt"]["saved"]
    got = _one_process_loads(pkg, "world")
    assert sorted(got) == (["ck_array", "ck_even", "ck_rows"]
                           if pkg == "port" else ["ck_array", "ck_rows"])
    assert set(got) <= set(saved)
    for name, want in saved.items():
        if name not in got:
            continue
        np.testing.assert_array_equal(
            got[name]["get"], np.asarray(want["get"], np.float32))
        _leaves_equal(got[name]["leaves"],
                      [np.asarray(leaf, np.asarray(g).dtype) for leaf, g
                       in zip(want["leaves"], got[name]["leaves"])],
                      f"{pkg} {name}")
    for f in sorted(os.listdir(os.path.join(_CKPT, "world"))):
        if f.endswith(".mvt"):
            with open(os.path.join(_CKPT, "world", f), "rb") as a, \
                    open(os.path.join(_CKPT, "world_async", f), "rb") as b:
                assert a.read() == b.read(), f


def test_one_process_checkpoint_restores_into_the_sharded_world(runs):
    """A one-process checkpoint restored into the world of 2: each
    rank's Gets and gathered updater state equal the one-process
    tables' bit for bit, and each rank holds its block of them."""
    port, _ = _parsed(runs, "seeded")
    one = runs["one"]
    for r in range(2):
        ck = port[r]["ckpt"]
        for name, want in one.items():
            got = ck["restored"][name]
            np.testing.assert_array_equal(np.asarray(got["get"], np.float32),
                                          np.asarray(want["get"],
                                                     np.float32))
            _leaves_equal([np.asarray(l, np.float32) for l in got["leaves"]],
                          [np.asarray(l, np.float32) for l in want["leaves"]],
                          f"rank {r} {name}")
            blk = ck["blocks"][name]
            lo, hi = blk["rows"]
            assert hi - lo == len(blk["data"])
            whole = np.zeros((2 * (hi - lo),) + np.shape(want["get"])[1:],
                             np.float32)
            whole[: len(want["get"])] = np.asarray(want["get"], np.float32)
            np.testing.assert_array_equal(
                np.asarray(blk["data"], np.float32), whole[lo:hi])


# ---------------------------------------------------------------------- #
# (2c) the sharded checkpoint (backend="orbax")
# ---------------------------------------------------------------------- #
SHARDED = {2: ("seeded", 0), 4: ("scenario4", 0)}   # the run, port side


def _sharded(runs, world):
    port, _ = _parsed(runs, SHARDED[world][0])
    out = [r["sharded"] for r in port]
    assert [o["rank"] for o in out] == list(range(world))
    assert all(o["world"] == world for o in out)
    return out


def _state_equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for name in want:
        np.testing.assert_array_equal(
            np.asarray(got[name]["get"], np.float32),
            np.asarray(want[name]["get"], np.float32),
            err_msg=f"{what} {name}")
        _leaves_equal([np.asarray(l, np.float32)
                       for l in got[name]["leaves"]],
                      [np.asarray(l, np.float32)
                       for l in want[name]["leaves"]], f"{what} {name}")


def _table_ids():
    with open(os.path.join(_CKPT, "orbax_w2", "manifest.json")) as f:
        tables = json.load(f)["tables"]
    return {e["name"]: int(tid) for tid, e in tables.items()}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("tag", ["", "_async"])
def test_sharded_save_files_hold_each_ranks_block(runs, world, tag):
    """Blocking and ``block=False``: block ``r`` of every table's data
    and row-shaped updater state is the file ``<leaf>.<r>.npy``, equal to
    rank r's block bit for bit; each rank opened for writing only its
    own block's files (rank 0 also the indexes, the shared leaves and the
    manifest and marker), and staged only its own block (rank 0 also the
    indexes and the shared leaves), back to 0 after."""
    out = _sharded(runs, world)
    ids = _table_ids()
    root = os.path.join(_CKPT, f"orbax_w{world}{tag}")
    extra = 0
    for name, tid in ids.items():
        tdir = os.path.join(root, "arrays", f"table_{tid}")
        with open(os.path.join(tdir, "index.json")) as f:
            index = json.load(f)
        assert len(index["blocks"]) == world
        extra += os.path.getsize(os.path.join(tdir, "index.json"))
        for leaf, axis in index["leaves"].items():
            if axis == "shared":
                extra += np.load(os.path.join(tdir, f"{leaf}.npy")).nbytes
                continue
            for r, o in enumerate(out):
                blk = o["blocks"][name]
                assert blk["rows"] == index["blocks"][r]
                want = (blk["data"] if leaf == "data" else
                        blk["ustate"][leaf.split(".", 1)[1]])
                got = np.load(os.path.join(tdir, f"{leaf}.{r}.npy"))
                np.testing.assert_array_equal(
                    got, np.asarray(want, got.dtype),
                    err_msg=f"{name} {leaf} block {r}")
    for r, o in enumerate(out):
        mine = [os.path.relpath(p, root) for p in o["written"]
                if p.startswith(root + os.sep)]
        arrays = sorted(p for p in mine if p.endswith(".npy")
                        and p.rsplit(".", 2)[-2].isdigit())
        assert arrays and all(p.endswith(f".{r}.npy") for p in arrays), r
        others = sorted(set(mine) - set(arrays))
        if r:
            assert others == [], others
        else:
            assert {"manifest.json", "COMMIT"} <= set(others)
        assert o["staged"] == o["block_bytes"] + (extra if r == 0 else 0)
        assert o["staged_after"] == 0


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_save_and_restore_gather_nothing(runs, world):
    """No call of ``unshard``, ``whole_state``, ``_stored_arrays``,
    ``raw_all_gather`` or the host gathers of a table's rows during the
    sharded saves or any sharded restore, on every rank."""
    for o in _sharded(runs, world):
        assert set(o["save_calls"].values()) == {0}, o["save_calls"]
        assert o["restores"], o
        for tag, got in o["restores"].items():
            assert set(got["calls"].values()) == {0}, (tag, got["calls"])
            assert got["written"] == [], (tag, got["written"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", ["block", "async"])
def test_a_failed_write_on_one_rank_raises_on_every_rank(runs, world, mode):
    """The last rank's array files fail to open: that rank raises its
    own error, every other rank a RuntimeError naming it, and no manifest
    or commit marker is written."""
    last = world - 1
    root = os.path.join(_CKPT, f"orbax_w{world}_broken_{mode}")
    for o in _sharded(runs, world):
        got = o["failures"]
        assert got[f"{mode}_committed"] is False
        if o["rank"] == last:
            assert got[mode] == "OSError: disk full", got
        else:
            assert got[mode].startswith("RuntimeError") and (
                f"rank(s) [{last}] failed" in got[mode]), got
    assert not os.path.exists(os.path.join(root, "manifest.json"))
    assert not os.path.exists(os.path.join(root, "COMMIT"))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_restore_at_the_same_world(runs, world):
    for o in _sharded(runs, world):
        got = o["restores"][f"orbax_w{world}"]
        assert got["n"] == 3
        _state_equal(got["state"], o["saved"], f"rank {o['rank']}")


@pytest.mark.parametrize("src,dst", [(1, 2), (1, 4), (2, 4), (4, 2)])
def test_sharded_restore_across_layouts(runs, src, dst):
    """A tag saved at one block count restores at another bit for bit:
    the one-process tag into the worlds of 2 and 4, and each world's tag
    into the other."""
    want = (runs["one"] if src == 1 else _sharded(runs, src)[0]["saved"])
    tag = "one_orbax" if src == 1 else f"orbax_w{src}"
    for o in _sharded(runs, dst):
        assert tag in o["restores"], (tag, sorted(o["restores"]))
        _state_equal(o["restores"][tag]["state"], want,
                     f"{src}->{dst} rank {o['rank']}")


def _port_one_process_restore(tag):
    """``tag`` restored into one-process port tables: each table's Get
    and stored leaves."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import checkpoint
    mv.init(device="cpu")
    try:
        tables = tw.ckpt_tables(mv)
        assert checkpoint.restore(_CKPT, tag=tag) == 3
        return tw.ckpt_state(tables)
    finally:
        mv.shutdown()


def test_sharded_restore_of_the_world_in_one_process(runs):
    """2 -> 1: the world of 2's tag restored into one-process tables."""
    _state_equal(_port_one_process_restore("orbax_w2"),
                 _sharded(runs, 2)[0]["saved"], "2->1")


def _jax_orbax_round_trip(state, directory):
    """The JAX package's orbax round trip of ``state`` (a
    :func:`tw.ckpt_state`) in the same tables on its 8-device mesh: each
    table's logical rows loaded (its own padding rows zero), saved with
    orbax, moved by an add, restored; each table's Get and stored leaves,
    logical rows."""
    import io
    import multiverso_tpu as jmv
    from multiverso_tpu import checkpoint as jcheckpoint
    jmv.init()
    try:
        tables = tw.ckpt_tables(jmv)
        for t in tables:
            rows = t.shape[0]
            buf = io.BytesIO()

            def padded(a):
                a = np.asarray(a, np.float32)
                if a.ndim == 0:
                    return a
                out = np.zeros((t.padded_shape[0],) + a.shape[1:],
                               np.float32)
                out[:rows] = a[:rows]
                return out

            np.save(buf, padded(state[t.name]["get"]))
            leaves = state[t.name]["leaves"]
            np.save(buf, np.asarray(len(leaves)))
            for leaf in leaves:
                np.save(buf, padded(leaf))
            buf.seek(0)
            t.load(buf)
        jcheckpoint.save(directory, tag="jax", backend="orbax")
        for t in tables:
            t.add(np.ones(t.shape, np.float32))
        assert jcheckpoint.restore(directory, tag="jax") == 3
        out = {}
        for t in tables:
            buf = io.BytesIO()
            t.store(buf)
            buf.seek(0)
            np.load(buf)
            leaves = [np.load(buf) for _ in range(int(np.load(buf)))]
            out[t.name] = {
                "get": np.asarray(t.get()),
                "leaves": [l if l.ndim == 0 else l[: t.shape[0]]
                           for l in leaves]}
        return out
    finally:
        jmv.shutdown()


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_restore_equals_the_jax_orbax_round_trip(runs, world,
                                                         tmp_path):
    """The world's restored state (its own tag) equals the JAX package's
    orbax round trip of the same state on its mesh, bit for bit (logical
    rows: the packages pad alike only where the row count allows)."""
    o = _sharded(runs, world)[0]
    got = o["restores"][f"orbax_w{world}"]["state"]
    want = _jax_orbax_round_trip(o["saved"], str(tmp_path))
    logical = {name: {"get": got[name]["get"],
                      "leaves": [np.asarray(l) if np.ndim(l) == 0 else
                                 np.asarray(l)[: len(got[name]["get"])]
                                 for l in got[name]["leaves"]]}
               for name in got}
    _state_equal(logical, want, f"world {world} against JAX")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", ["block", "async"])
def test_elastic_loop_resumes_on_the_sharded_format(runs, world, mode):
    """``ElasticLoop(backend="orbax", keep=1)``: every rank of the world
    checkpoints after steps 2 and 5, rank 0 alone prunes, and a fresh Zoo
    resumes at 6 and lands, redoing step 6, on the first run's table bit
    for bit. The prune counts committed tags: blocking, step 5's save
    prunes step 2's; asynchronous, step 5's is not yet committed when
    the loop prunes, so step 2's stays (as in the JAX package)."""
    tags = (["step_000000005"] if mode == "block" else
            ["step_000000002", "step_000000005"])
    for o in _sharded(runs, world):
        e = o["elastic"][mode]
        assert e == {"start": 6, "same": True, "tags": tags}, (o["rank"], e)


# ---------------------------------------------------------------------- #
# (3) StoreRendezvous in one process
# ---------------------------------------------------------------------- #
def _store_pair():
    import torch.distributed as dist
    port = _free_port()
    master = dist.TCPStore("127.0.0.1", port, 2, True,
                           timeout=timedelta(seconds=20),
                           wait_for_workers=False)
    client = dist.TCPStore("127.0.0.1", port, 2, False,
                           timeout=timedelta(seconds=20))
    return master, client


def test_store_rendezvous_publish_lookup_and_marks():
    from multiverso_tpu_torch.ps.service import PSPeerError, StoreRendezvous
    master, client = _store_pair()
    a, b = StoreRendezvous(master), StoreRendezvous(client)
    assert a.identity == b.identity
    assert StoreRendezvous(client, "other").identity != a.identity
    a.publish(0, "127.0.0.1:1000")
    b.publish(1, "127.0.0.1:1001")
    assert b.lookup(0, 2.0) == "127.0.0.1:1000"
    assert a.lookup(1, 2.0) == "127.0.0.1:1001"
    with pytest.raises(PSPeerError, match="never published"):
        a.lookup(7, 0.1)
    b.mark(1, "done", "x1")
    assert a.wait_mark(1, "done", 1.0)
    assert a.wait_mark(1, "done", 1.0, expect="x1")
    # a marker of another incarnation does not satisfy the wait
    assert not a.wait_mark(1, "done", 0.2, expect="x2")
    # nobody marked: False by the deadline
    assert not a.wait_mark(0, "done", 0.1)
    # a later mark is seen by a wait already waiting
    t = threading.Timer(0.1, lambda: a.mark(0, "late", "v"))
    t.start()
    assert b.wait_mark(0, "late", 5.0, expect="v")
    t.join()


def _two_rank_world(rdv_of, dev="cpu"):
    from multiverso_tpu_torch.ps.service import PSContext, PSService
    return [PSContext(r, 2, PSService(r, 2, rdv_of(r)), device=dev)
            for r in range(2)]


@pytest.mark.parametrize("plane", ["native", "python"])
def test_async_world_over_the_store_equals_the_file_world(plane, tmp_path):
    from multiverso_tpu_torch.ps import tables as ttables
    from multiverso_tpu_torch.ps.service import (FileRendezvous,
                                                 StoreRendezvous)
    from multiverso_tpu_torch.utils import config
    config.set_flag("ps_timeout", 20.0)
    config.set_flag("ps_connect_timeout", 10.0)
    if plane == "python":
        config.set_flag("ps_native", False)
    rng = np.random.default_rng(3)
    ops = [(rng.integers(0, 64, 16), rng.normal(size=(16, 8)).astype(
        np.float32), int(rng.integers(0, 2))) for _ in range(12)]
    stores = _store_pair()
    fdir = str(tmp_path / "rdv")
    got = {}
    try:
        for name, rdv_of in (
                ("store", lambda r: StoreRendezvous(stores[r])),
                ("file", lambda r: FileRendezvous(fdir))):
            ctxs = _two_rank_world(rdv_of)
            try:
                tabs = [ttables.AsyncMatrixTable(64, 8, name=f"w_{name}",
                                                 ctx=c) for c in ctxs]
                for ids, vals, r in ops:
                    tabs[r].add_rows(ids, vals)
                for t in tabs:
                    t.flush()
                got[name] = [t.get_rows(np.arange(64)) for t in tabs]
            finally:
                for c in ctxs:
                    c.close()
    finally:
        config.reset_flags()
    for r in range(2):
        np.testing.assert_array_equal(got["store"][r], got["file"][r])
    np.testing.assert_array_equal(got["store"][0], got["store"][1])
    assert np.abs(got["store"][0]).sum() > 0


def test_default_context_takes_the_world_store():
    """ps_world=2, no ps_rendezvous and an initialized world: the default
    context meets at the world's store; ps_world <= 0 takes the world's
    rank and size."""
    import torch.distributed as dist
    from multiverso_tpu_torch.parallel.mesh import (leave_world, net_join,
                                                    world_store)
    from multiverso_tpu_torch.ps import service as tsvc
    from multiverso_tpu_torch.utils import config
    assert world_store() is None
    net_join(f"127.0.0.1:{_free_port()}", 1, 0, "cpu", timeout_s=20.0)
    try:
        assert dist.get_world_size() == 1 and world_store() is not None
        config.set_flag("device", "cpu")
        config.set_flag("ps_shutdown_grace", 0.2)
        config.set_flag("ps_world", 2)
        config.set_flag("ps_rank", 0)
        ctx = tsvc.default_context()
        rdv = ctx.service._rendezvous
        assert isinstance(rdv, tsvc.StoreRendezvous)
        assert rdv.lookup(0, 2.0) == ctx.service.addr
        tsvc.reset_default_context()
        config.set_flag("ps_world", 0)
        ctx = tsvc.default_context()
        assert (ctx.rank, ctx.world) == (0, 1)
        assert ctx.service._rendezvous is None
        tsvc.reset_default_context()
    finally:
        tsvc.reset_default_context()
        config.reset_flags()
        leave_world()
    assert world_store() is None


# ---------------------------------------------------------------------- #
# one process: the API's identities and errors
# ---------------------------------------------------------------------- #
def test_aggregate_of_one_process_and_its_aliases():
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.utils import config
    mv.init(device="cpu")
    try:
        base = np.arange(12, dtype=np.float32).reshape(3, 4)
        view = base[:, ::2]
        assert mv.aggregate(view) is view
        assert mv.aggregate(base, size=5) is base
        np.testing.assert_array_equal(base.reshape(-1),
                                      np.arange(12, dtype=np.float32))
        np.testing.assert_array_equal(mv.aggregate([1.0, 2.0]), [1.0, 2.0])
        assert mv.MV_Aggregate is mv.aggregate
        assert mv.workers_num() == mv.num_workers() == 1
        assert mv.servers_num() == mv.num_servers() == 1
        assert mv.worker_id_to_rank(0) == mv.MV_WorkerIdToRank(0) == 0
        assert mv.server_id_to_rank(0) == mv.MV_ServerIdToRank(0) == 0
        assert (mv.MV_Rank(), mv.MV_Size()) == (0, 1)
        config.set_flag("num_servers", 3)
        assert mv.num_servers() == 3
    finally:
        mv.shutdown()
        config.reset_flags()


def test_net_init_returns_minus_one_on_error():
    import multiverso_tpu_torch as mv
    assert mv.net_init("no-port-here", 1, 0, device="cpu") == -1
    assert mv.net_init("127.0.0.1:1", 2, 5, device="cpu") == -1
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_process_collectives_of_a_world_of_one():
    from multiverso_tpu_torch.parallel import collectives as coll
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert coll.process_sum(a) is a
    np.testing.assert_array_equal(coll.process_allgather(a), a[None])
    t = torch.ones(3)
    assert coll.process_sum_tensor(t) is t


def test_barrier_flushes_the_tables_written_since_the_last():
    """One process: the barrier applies the queued (coalesced) adds of
    the tables written since the last barrier."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.zoo import Zoo
    mv.init(device="cpu")
    try:
        t = mv.ArrayTable(8, name="fenced")
        with t._dispatch_lock:    # hold the applier off: the add queues
            t.add_async(np.ones(8, np.float32))
            assert t._addq_inflight == 1
            assert t.table_id in Zoo.get()._dirty
        mv.barrier()
        assert t._addq_inflight == 0 and not Zoo.get()._dirty
        np.testing.assert_array_equal(t.get(), np.ones(8, np.float32))
    finally:
        mv.shutdown()


# ---------------------------------------------------------------------- #
# (4) the examples
# ---------------------------------------------------------------------- #
def test_mlp_data_parallel_matches_the_jax_example(runs):
    """Two ranks, each its own data (seed = worker id), deltas merged
    every 8 batches and at each epoch's end: the port's printed losses
    and accuracies are the JAX example's (printed to 4 decimals)."""
    outs, jouts = _run(runs, "mlp")
    jres = _results(jouts, "JAX mlp example")
    for r, (rc, o, e) in enumerate(outs):
        assert rc == 0, e[-3000:]
        assert f"process {r}/2" in o
        got = [l for l in o.splitlines() if l.startswith("epoch ")]
        want = [f"epoch {i}: loss {l:.4f}  test acc {a:.4f}"
                for i, (l, a) in enumerate(zip(jres[r]["loss"],
                                               jres[r]["acc"]))]
        assert len(want) == 6 and got == want


def test_transformer_ps_runs_unchanged_under_a_launcher(runs):
    """The LM example, started as two ranks of a launcher's world: both
    join it in init() and train through the shared table; they start
    from the same weights and batch, so every sync leaves them equal."""
    finals = []
    for r, (rc, o, e) in enumerate(_run(runs, "lm")):
        assert rc == 0, e[-3000:]
        assert f"process {r}/2" in o
        finals.append([l for l in o.splitlines()
                       if l.startswith("transformer-PS ok")])
    assert finals[0] and finals[0] == finals[1]
