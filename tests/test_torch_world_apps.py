"""Port parity, the apps' whole-state paths on tables sharded over a
world's ranks: ``multiverso_tpu_torch``'s WordEmbedding ``train_fused``
(all five branches) and its PS block device plane, LogReg's fused
``train_arrays`` and ``ResNetTrainer.train``/``evaluate`` at a table axis
of 2 (two gloo ranks on this CPU, ``tests/torch_world_apps_worker.py``),
against the same calls of the port in one process and of the JAX package
on its 8-device test mesh, whose tables split eight ways (the JAX ResNet
trainer splits each batch over that axis too).

The world and the one-process port run the same CPU operations in the
same order on the same inputs, one intra-op thread each: every rank
trains the same batches and keeps its block. WordEmbedding trains by
owner (each step reads its rows from their owners, an owner's value
plus the others' -0.0, and adds its deltas into the rows its block
holds, in their order), the device plane asks each row's owner and
pushes each block's rows to its owner, and LogReg gathers the whole
table for the call. So WordEmbedding, the device plane and LogReg equal
the one-process run bit for bit, and match the JAX app within the
tolerances of ``tests/test_torch_word_embedding.py``,
``tests/test_torch_ps_blocks.py`` and ``tests/test_torch_logreg.py``.
WordEmbedding never gathers a table (``aw.WEWatch``: no ``unshard`` or
``whole_state``, no f32 tensor of a table's size, each step the
designed all-reduces of its rows), at a table axis of 2 and, for two
branches, of 4 (``parallel/mesh.spawn``).
The ResNet trainer is data-parallel (each rank its half of each batch,
BatchNorm's moments summed over the ranks, the gradient reduce-scattered
to the blocks), so its sums run in another order: it is held to
``tests/test_torch_resnet.py``'s tolerances against both, its first
step's gradient within 1e-5 of max |g| of the one-process one.

The DLRM step (``models/dlrm.make_train_step``) on the sharded
embedding table reads and pushes its rows by owner: with each rank on
its half of each global batch it is held within 1e-5 to the one-process
port and to the JAX step on the 8-device mesh (AdaGrad, default,
momentum_sgd), without a data axis to the one-process port bit for bit,
and in every step the table is never gathered (no ``unshard``, no
tensor of its size, no collective past the batch's rows or the MLP). A
world of 4 (``parallel/mesh.spawn``) runs it on three layouts in
float64.

One world of 2 ranks starts once for the module, each rank with a
timeout; the references run in this process meanwhile.
"""

import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
import torch_world_apps_worker as aw
from multiverso_tpu.apps import logistic_regression as jlr
from multiverso_tpu.apps import resnet_cifar as jres_app
from multiverso_tpu.apps import word_embedding as jwe
from multiverso_tpu.models import dlrm as jdlrm
from multiverso_tpu.models import resnet as jres
from multiverso_tpu.updaters import AddOption as JAddOption
from multiverso_tpu.utils import config as jconfig
from multiverso_tpu_torch.apps import word_embedding as twe
from multiverso_tpu_torch.models import resnet as tres
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard
from multiverso_tpu_torch.zoo import Zoo as TZoo

_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_DIR)
_TIMEOUT = 240
WORLD = 2
# tests/test_torch_word_embedding.py: the shared pool after its epochs to
# atol 2e-6, the other branches 4e-6; losses rtol 1e-5
WE_ATOL = {"sg_shared": 2e-6}
WE_ATOL_OTHER, WE_LOSS_RTOL = 4e-6, 1e-5
# tests/test_torch_ps_blocks.py: block losses rtol 1e-6, tables atol 1e-5
PS_LOSS_RTOL, PS_ATOL = 1e-6, 1e-5
# tests/test_torch_logreg.py: the table within 1e-5 of its max |x|, the
# loss rtol 1e-4
LR_TABLE_RTOL, LR_LOSS_RTOL = 1e-5, 1e-4
# tests/test_torch_resnet.py's trainer bounds
RES_LOSS_RTOL, RES_FWD_ATOL = 1e-4, 1e-4
RES_CLOSE_ATOL, RES_CLOSE_SHARE = 1e-6, 0.999
RES_GRAD_RTOL = 1e-5
# tests/test_torch_dlrm.py's make_train_step bounds: the loss relative,
# each table as max |diff| over max |x| (AdaGrad's first step divides a
# row's delta by its own size, so a tighter bound catches rounding)
DLRM_RTOL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_world(out_dir):
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    return [subprocess.Popen(
        [sys.executable, os.path.join(_DIR, "torch_world_apps_worker.py"),
         out_dir],
        env={**env, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
             "RANK": str(r), "WORLD_SIZE": str(WORLD),
             "LOCAL_RANK": str(r)},
        cwd=_REPO, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(WORLD)]


def _collect(procs):
    """[(rc, stdout, stderr)] in rank order; a rank past the timeout is
    killed."""
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


def _port_reference(out_dir):
    """The same calls in one process of the port (one intra-op thread, as
    the ranks)."""
    tmv.init(device="cpu")
    try:
        ref = {}
        tokens, owner_tokens = aw.we_tokens(), aw.we_owner_tokens()
        for name, extra in aw.WE_BRANCHES.items():
            ref[f"we_{name}"] = aw.we_fused(
                twe.WEConfig.from_argv(aw.WE_ARGV + extra), tokens)
            ref[f"we_owner_{name}"] = aw.we_fused(
                twe.WEConfig.from_argv(aw.WE_OWNER_ARGV + extra),
                owner_tokens)
        ptoks = aw.ps_tokens()
        for name, extra in aw.PS_VARIANTS.items():
            cfg = twe.WEConfig(**aw.PS_SMALL, **extra)
            ids = twe.WordEmbedding(cfg, twe.Dictionary.build(
                ptoks, cfg.min_count)).prepare_ids(ptoks)
            ref[f"ps_{name}"] = aw.we_blocks(
                cfg, ids[: aw.PS_BLOCKS * cfg.data_block_size], ptoks)
        ref["lr"] = aw.lr_fused(aw.LR_PAIRS, *aw.lr_data())
        train, evaluate = aw.res_data()
        ref["res"] = aw.resnet(aw.RES_KW, train, evaluate, aw.res_init(
            os.path.join(out_dir, "res_init.npz")))
        data = aw.dlrm_data()
        for u in aw.DLRM_UPDATERS:
            ref[f"dlrm_{u}"] = aw.dlrm_steps(u, aw.DLRM_OPT, data,
                                             aw.DLRM_STEPS, aw.DLRM_BATCH)
        return ref
    finally:
        TZoo.get().stop()
        tconfig.reset_flags()
        TDashboard.reset()


def _jax_dlrm(updater):
    """``aw.DLRM_STEPS`` steps of the JAX ``make_train_step`` (jitted) on
    the 8-device mesh's sharded tables with the global batches, from the
    port's start: the losses and both tables, and the embedding table
    after the first step."""
    cfg = jdlrm.DLRMConfig(**aw.DLRM_CFG)
    rows = jdlrm.total_rows(cfg)
    emb = jmv.MatrixTable(rows, cfg.embed_dim, updater=updater,
                          init=aw.dlrm_init(), name=f"dlrm_emb_{updater}")
    flat, meta = jdlrm.flatten_mlp(jdlrm.init_mlp_params(cfg, 0))
    mlp = jmv.ArrayTable(flat.size, updater=updater, init=flat,
                         name=f"dlrm_mlp_{updater}")
    opt = JAddOption(**aw.DLRM_OPT)
    cat, dense, labels = aw.dlrm_data()
    b = aw.DLRM_BATCH
    out = {"losses": []}
    with jax.default_matmul_precision("float32"):
        step = jax.jit(jdlrm.make_train_step(cfg, emb, mlp, meta,
                                             emb_opt=opt, mlp_opt=opt))
        es, ms = emb.state, mlp.state
        for i in range(aw.DLRM_STEPS):
            sl = slice(i * b, (i + 1) * b)
            es, ms, loss = step(es, ms, jnp.asarray(cat[sl]),
                                jnp.asarray(dense[sl]),
                                jnp.asarray(labels[sl]))
            out["losses"].append(float(loss))
            if i == 0:
                out["emb_first"] = np.asarray(es["data"])[:rows]
    out["losses"] = np.array(out["losses"])
    out["emb"] = np.asarray(es["data"])[:rows]
    out["mlp"] = np.asarray(ms["data"])[: flat.size]
    return out


def _jax_reference():
    """The JAX apps on the 8-device test mesh, on the same inputs."""
    jmv.init()
    try:
        ref = {}
        tokens = aw.we_tokens()
        for name, extra in aw.WE_BRANCHES.items():
            cfg = jwe.WEConfig.from_argv(aw.WE_ARGV + extra)
            app = jwe.WordEmbedding(cfg, jwe.Dictionary.build(
                tokens, cfg.min_count))
            stats = app.train_fused(app.prepare_ids(tokens), epochs=1)
            ref[f"we_{name}"] = {
                "loss": stats["loss"], "in": np.asarray(app.embeddings()),
                "out": np.asarray((app.table_hs if cfg.hs
                                   else app.table_out).get())}
        ptoks = aw.ps_tokens()
        for name, extra in aw.PS_VARIANTS.items():
            cfg = jwe.WEConfig(**aw.PS_SMALL, **extra)
            app = jwe.WordEmbedding(cfg, jwe.Dictionary.build(
                ptoks, cfg.min_count))
            ids = app.prepare_ids(ptoks)
            losses, inner = [], app._train_block_device

            def record(prep, _inner=inner, _out=losses):
                loss = _inner(prep)
                _out.append(loss)
                return loss

            app._train_block_device = record
            stats = app.train_ps_blocks(
                ids[: aw.PS_BLOCKS * cfg.data_block_size], epochs=1)
            ref[f"ps_{name}"] = {
                "loss": stats["loss"],
                "block_losses": np.array([float(x) for x in losses]),
                "in": np.asarray(app.table_in.get()),
                "out": np.asarray((app.table_hs if cfg.hs
                                   else app.table_out).get())}
        lr = jlr.LogReg(jlr.LogRegConfig(aw.LR_PAIRS))
        stats = lr.train_arrays(*aw.lr_data(), epochs=1)
        ref["lr"] = {"loss": stats["loss"],
                     "table": np.asarray(lr.table.get())}
        (x, y), (xe, ye) = aw.res_data()
        trainer = jres_app.ResNetTrainer(seed=0, **aw.RES_KW)
        with jax.default_matmul_precision("float32"):
            stats = trainer.train(x, y, epochs=1)
            acc = trainer.evaluate(xe, ye)
        bn, _ = tres.flatten_params(jax.tree.map(np.asarray, trainer.bn))
        ref["res"] = {"loss": stats["loss"], "eval": acc, "bn": bn,
                      "table": np.asarray(trainer.table.get())[
                          : trainer.n_params]}
        for u in aw.DLRM_UPDATERS:
            ref[f"dlrm_{u}"] = _jax_dlrm(u)
        return ref
    finally:
        jmv.shutdown()
        jconfig.reset_flags()


@pytest.fixture(scope="module")
def runs():
    """The world's ranks (their RESULT dicts and arrays), the one-process
    port's and the JAX package's results."""
    import json
    out_dir = tempfile.mkdtemp(prefix="mv_world_apps_")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        params, bn = jres.init_resnet(jax.random.key(0), depth=8,
                                      num_classes=4)
        flat, bn_np = tres.resnet_from_jax(jax.tree.map(np.asarray, params),
                                           jax.tree.map(np.asarray, bn))
        aw.save_res_init(os.path.join(out_dir, "res_init.npz"), flat,
                         tres.flatten_params(bn_np)[0])
        for attempt in range(2):
            procs = _start_world(out_dir)
            port_ref = _port_reference(out_dir) if attempt == 0 else port_ref
            jax_ref = _jax_reference() if attempt == 0 else jax_ref
            outs = _collect(procs)
            # a world whose store lost its free port is started once more
            if all(rc == 0 for rc, _, _ in outs) or not any(
                    "address already in use" in e.lower()
                    for _, _, e in outs):
                break
        ranks = []
        for r, (rc, o, e) in enumerate(outs):
            assert rc == 0, f"rank {r} rc={rc}\n{e[-3000:]}"
            lines = [l for l in o.splitlines() if l.startswith("RESULT ")]
            assert lines, f"rank {r} printed no RESULT\n{e[-2000:]}"
            got = json.loads(lines[-1][len("RESULT "):])
            with np.load(os.path.join(out_dir, f"rank{r}.npz")) as f:
                got.update({k: f[k] for k in f.files})
            ranks.append(got)
        yield {"ranks": ranks, "port": port_ref, "jax": jax_ref}
    finally:
        torch.set_num_threads(threads)
        shutil.rmtree(out_dir, ignore_errors=True)


def _rank(got, prefix):
    return {k.split("/", 1)[1]: v for k, v in got.items()
            if k.startswith(prefix + "/")}


@pytest.mark.parametrize("branch", list(aw.WE_BRANCHES))
def test_train_fused_at_a_table_axis_of_two(runs, branch):
    """One epoch of each branch: both ranks' gathered tables, loss and
    LCG state equal the one-process port's bit for bit, the words are
    counted once, and the tables and loss match the JAX app."""
    one, jx = runs["port"][f"we_{branch}"], runs["jax"][f"we_{branch}"]
    atol = WE_ATOL.get(branch, WE_ATOL_OTHER)
    for r in range(WORLD):
        got = _rank(runs["ranks"][r], f"we_{branch}")
        assert runs["ranks"][r]["size"] == WORLD
        assert got["loss"] == one["loss"]
        for k in ("in", "out"):
            np.testing.assert_array_equal(got[k], one[k], err_msg=k)
            assert np.abs(jx[k]).max() > 1e-2                 # trained
            np.testing.assert_allclose(got[k], jx[k], rtol=0, atol=atol,
                                       err_msg=k)
        np.testing.assert_allclose(got["loss"], jx["loss"],
                                   rtol=WE_LOSS_RTOL)
        if branch == "sg_shared":
            np.testing.assert_array_equal(got["lcg"], one["lcg"])
        assert got["words"] == one["words"] == one["tokens"]


def _assert_by_owner(got, world, size):
    """A watched ``train_fused`` call on a table axis of ``world``
    (``aw.WEWatch``): no ``unshard``/``whole_state``; before the first
    step only ``require_same_inputs``' digest (8 bytes a rank); each step
    one all-reduce a table read, of exactly the rows it reads
    (``aw.we_step_reads``), none past ``world`` x the step's rows; each
    rank's blocks 1/world of the padded tables."""
    reads = got["watch/reads"]
    assert got["watch/gathers"] == 0
    assert got["watch/pre"] == [["process_all_gather", 8 * world]]
    assert got["watch/step_ops"] == ["all_reduce"]
    n = got["batches"]
    assert n > 0 and got["watch/step_colls"].tolist() == [len(reads)] * n
    want = [r * size * 4 for r in reads]
    assert got["watch/step_payloads"].tolist() == [want] * n
    assert max(want) <= world * sum(reads) * size * 4
    assert len(got["watch/step_ms"]) == n
    for k in ("in", "out"):
        assert got[f"watch/block_numel_{k}"] * world == \
            got[f"watch/whole_numel_{k}"]


@pytest.mark.parametrize("branch", list(aw.WE_BRANCHES))
def test_train_fused_never_gathers_the_tables(runs, branch):
    """``train_fused`` by owner at ``aw.WE_OWNER_ARGV``, whose tables hold
    at least 8x the rows a step reads: no rank enters ``unshard`` or
    ``whole_state`` or makes an f32 tensor of a whole table's elements;
    each step's collectives are the designed all-reduces of its rows
    (:func:`_assert_by_owner`), their bytes a step far below a table's;
    the tables, loss and LCG state equal the one-process port's bit for
    bit, and the words are counted once."""
    one = runs["port"][f"we_owner_{branch}"]
    size = int(aw.WE_OWNER_ARGV[aw.WE_OWNER_ARGV.index("-size") + 1])
    for r in range(WORLD):
        got = _rank(runs["ranks"][r], f"we_owner_{branch}")
        _assert_by_owner(got, WORLD, size)
        whole = min(got["watch/whole_numel_in"],
                    got["watch/whole_numel_out"])
        assert whole >= 8 * sum(got["watch/reads"]) * size
        assert got["watch/largest"] < whole
        assert got["batches"] == one["batches"]
        assert got["loss"] == one["loss"]
        for k in ("in", "out"):
            np.testing.assert_array_equal(got[k], one[k], err_msg=k)
        assert np.abs(got["out"]).max() > 1e-3     # trained from zeros
        if branch == "sg_shared":
            np.testing.assert_array_equal(got["lcg"], one["lcg"])
        assert got["words"] == one["words"] == one["tokens"]


@pytest.mark.parametrize("variant", list(aw.PS_VARIANTS))
def test_device_plane_at_a_table_axis_of_two(runs, variant):
    """Two blocks on the device plane, one worker: each block's loss and
    both gathered tables equal the one-process port's bit for bit, and
    match the JAX app's device plane."""
    one, jx = runs["port"][f"ps_{variant}"], runs["jax"][f"ps_{variant}"]
    assert len(one["block_losses"]) == aw.PS_BLOCKS
    for r in range(WORLD):
        got = _rank(runs["ranks"][r], f"ps_{variant}")
        np.testing.assert_array_equal(got["block_losses"],
                                      one["block_losses"])
        assert got["loss"] == one["loss"]
        for k in ("in", "out"):
            np.testing.assert_array_equal(got[k], one[k], err_msg=k)
            assert np.abs(jx[k]).max() > 1e-2                 # trained
            np.testing.assert_allclose(got[k], jx[k], rtol=0, atol=PS_ATOL,
                                       err_msg=k)
        np.testing.assert_allclose(got["block_losses"], jx["block_losses"],
                                   rtol=PS_LOSS_RTOL)
        assert got["words"] == one["words"] == aw.PS_BLOCKS * 4000


def test_lr_train_arrays_at_a_table_axis_of_two(runs):
    one, jx = runs["port"]["lr"], runs["jax"]["lr"]
    for r in range(WORLD):
        got = _rank(runs["ranks"][r], "lr")
        np.testing.assert_array_equal(got["table"], one["table"])
        assert got["loss"] == one["loss"]
        scale = float(np.abs(jx["table"]).max())
        assert float(np.abs(got["table"] - jx["table"]).max()) <= \
            LR_TABLE_RTOL * scale
        np.testing.assert_allclose(got["loss"], jx["loss"],
                                   rtol=LR_LOSS_RTOL)


@pytest.mark.parametrize("against", ["port", "jax"])
def test_resnet_train_at_a_table_axis_of_two(runs, against):
    """Three data-parallel steps (8 images a rank a step): the loss within
    1e-4 relative, the flat table within ``2 * lr * steps`` with 99.9% of
    it within 1e-6, and the BN running stats within 1e-4 of each
    reference's."""
    want = runs[against]["res"]
    lr, steps = aw.RES_KW["learning_rate"], aw.RES_STEPS
    for r in range(WORLD):
        got = _rank(runs["ranks"][r], "res")
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   rtol=RES_LOSS_RTOL)
        err = np.abs(got["table"] - want["table"])
        assert err.max() <= 2 * lr * steps, err.max()
        assert (err <= RES_CLOSE_ATOL).mean() >= RES_CLOSE_SHARE
        np.testing.assert_allclose(got["bn"], want["bn"], rtol=0,
                                   atol=RES_FWD_ATOL)


def test_resnet_ranks_agree_and_evaluate(runs):
    """The BN running stats equal on both ranks bit for bit, and
    ``evaluate`` gives one accuracy on both ranks, the one-process port's
    (the JAX app's within one image of 64)."""
    a, b = (_rank(runs["ranks"][r], "res") for r in range(WORLD))
    np.testing.assert_array_equal(a["bn"], b["bn"])
    np.testing.assert_array_equal(a["table"], b["table"])
    assert a["eval"] == b["eval"] == runs["port"]["res"]["eval"]
    assert abs(a["eval"] - runs["jax"]["res"]["eval"]) <= 1 / 64


def test_resnet_first_step_gradient(runs):
    """The first step's flat gradient, reduce-scattered to the blocks and
    gathered, within 1e-5 of max |g| of the one-process gradient: a
    backward that dropped the other rank's share of BatchNorm's moments
    misses by far more."""
    want = runs["port"]["res"]["grad"]
    for r in range(WORLD):
        got = _rank(runs["ranks"][r], "res")["grad"]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= RES_GRAD_RTOL * np.abs(want).max()


@pytest.mark.parametrize("path", ["we_fused", "we_blocks", "lr", "resnet"])
def test_mismatched_inputs_raise_on_every_rank(runs, path):
    """Rank 1 passes other inputs than rank 0: every rank raises
    ``ValueError`` (and the world goes on: the ranks ended with a
    RESULT)."""
    assert all(runs["ranks"][r]["mismatch"][path] for r in range(WORLD))


def _close(got, want, rtol=DLRM_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), err


def _dlrm_close(got, want):
    """The loss within 1e-5 relative, both tables within 1e-5 of max |x|
    (test_torch_dlrm.py::test_make_train_step_matches_jax's bounds)."""
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=DLRM_RTOL)
    for k in ("emb", "mlp"):
        _close(got[k], want[k])


def _dlrm_payload_bound(shards: int, batch_rows: int, mlp_padded: int,
                        itemsize: int = 4) -> int:
    """The most a collective of the step may carry: a rank's ids (8
    bytes each) and rows (D values) to and from every owner, or the
    MLP's gather."""
    d = aw.DLRM_CFG["embed_dim"]
    return max(shards * batch_rows * (d * itemsize + 8),
               itemsize * mlp_padded)


@pytest.mark.parametrize("updater", aw.DLRM_UPDATERS)
@pytest.mark.parametrize("against", ["port", "jax"])
def test_dlrm_step_by_owner_at_a_table_axis_of_two(runs, updater, against):
    """Four steps of ``make_train_step`` with the data axis on the table
    axis, each rank on its half of each global batch, its rows read from
    and pushed to their owners: both ranks' losses and gathered tables
    within 1e-5 of the one-process port's and of the JAX step's on the
    8-device mesh with the global batch."""
    want = runs[against][f"dlrm_{updater}"]
    for r in range(WORLD):
        got = _rank(runs["ranks"][r], f"dlrm_{updater}")
        assert np.abs(got["emb"] - got["emb_first"]).max() > 1e-3  # trained
        _dlrm_close(got, want)
        if against == "jax":
            _close(got["emb_first"], want["emb_first"])


def test_dlrm_step_without_a_data_axis_equals_one_process(runs):
    """Every rank brings the global batch and sums the gradients of its
    own rows into its block, with nothing exchanged: the same operations
    as one process, so the same losses and tables bit for bit."""
    one = runs["port"]["dlrm_adagrad"]
    for r in range(WORLD):
        got = _rank(runs["ranks"][r], "dlrm_global")
        np.testing.assert_array_equal(got["losses"], one["losses"])
        for k in ("emb", "mlp"):
            np.testing.assert_array_equal(got[k], one[k])


def test_dlrm_momentum_moves_rows_the_batch_did_not_touch(runs):
    """momentum_sgd applies to every row of the block, as the JAX step
    applies its updater to the whole sharded delta: the rows of the first
    batch that no later batch touched go on moving, as the JAX step's
    do."""
    cat, _, _ = aw.dlrm_data()
    offsets = np.concatenate([[0], np.cumsum(aw.DLRM_CFG["vocab_sizes"])[
        :-1]])
    ids = (cat + offsets[None, :]).reshape(aw.DLRM_STEPS, -1)
    idle = np.setdiff1d(ids[0], ids[1:])
    assert idle.size > 100
    jx = runs["jax"]["dlrm_momentum_sgd"]
    moved = np.abs(jx["emb"] - jx["emb_first"])[idle]
    assert moved.min(axis=1).max() > 0 and moved.max() > 1e-3
    for r in range(WORLD):
        got = _rank(runs["ranks"][r], "dlrm_momentum_sgd")
        _close((got["emb"] - got["emb_first"])[idle],
               (jx["emb"] - jx["emb_first"])[idle])


@pytest.mark.parametrize("variant", list(aw.DLRM_UPDATERS) + ["global"])
def test_dlrm_step_never_gathers_the_embedding_table(runs, variant):
    """In every step no rank calls the embedding table's ``unshard`` or
    makes a tensor of as many elements as the whole table, and no
    collective carries more than the batch's ids and rows to and from
    every owner, or the MLP's gather."""
    d = aw.DLRM_CFG["embed_dim"]
    bound_rows = aw.DLRM_BATCH // WORLD * len(aw.DLRM_CFG["vocab_sizes"])
    if variant == "global":
        bound_rows *= WORLD
    for r in range(WORLD):
        got = _rank(runs["ranks"][r], f"dlrm_{variant}")
        assert got["unshard_calls"] == 0
        assert len(got["largest"]) == aw.DLRM_STEPS
        assert max(got["largest"]) < got["whole_numel"]
        bound = _dlrm_payload_bound(WORLD, bound_rows, got["mlp_padded"])
        assert bound < 4 * got["whole_numel"]   # a gather would show
        for step, moved in zip(got["payloads"], got["bytes"]):
            assert max(b for _, b in step) <= bound, step
            # devstats' tally of the step, less than the table's bytes
            assert sum(b for _, b in step) == moved < 4 * got["whole_numel"]
        # the rows come from their owners in one all_to_all; by owner
        # the gradients go back in one more, and nothing else is
        # exchanged without a data axis
        want = 1 if variant == "global" else 2
        assert all(sum(op == "all_to_all" for op, _ in s) == want
                   for s in got["payloads"])
        assert got["emb"].shape == (sum(aw.DLRM_CFG["vocab_sizes"]), d)


@pytest.fixture(scope="module")
def world4():
    """A world of 4 CPU ranks (``mesh.spawn``, ``aw.world4``) and the same
    calls in one process of the port: the DLRM step on each layout of
    ``aw.DLRM_WORLD4`` in turn, in float64, where the sums' order moves
    the tables by ~1e-14 of max |x| (in float32 AdaGrad turned the 4
    ranks' order into 1.4e-5 of max |x|, past the 1e-5 bound: rounding,
    not a fault); ``train_fused`` of the branches of ``aw.WE_WORLD4`` in
    f32."""
    from multiverso_tpu_torch.parallel.mesh import spawn
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ranks = spawn(aw.world4, 4, "cpu", timeout=_TIMEOUT)
        tmv.init(device="cpu")
        try:
            one = aw.dlrm_steps("adagrad", aw.DLRM_OPT, aw.dlrm_data(),
                                aw.DLRM_STEPS, aw.DLRM_BATCH,
                                dtype=np.float64)
            tokens = aw.we_tokens()
            one.update({f"we_{b}": aw.we_fused(twe.WEConfig.from_argv(
                aw.WE_ARGV + aw.WE_BRANCHES[b]), tokens)
                        for b in aw.WE_WORLD4})
        finally:
            TZoo.get().stop()
            tconfig.reset_flags()
            TDashboard.reset()
    finally:
        torch.set_num_threads(threads)
    return ranks, one


@pytest.mark.parametrize("layout", list(aw.DLRM_WORLD4))
def test_dlrm_step_at_a_world_of_four(world4, layout):
    """A world of 4 in float64: the table split 4 ways with the rows
    exchanged by owner, split 2 ways with the block all-reduced over the
    other axis, and split 2 ways with both. Every rank's losses (f32, as
    ``loss_fn`` makes them) within 1e-5 relative and its tables within
    1e-12 of max |x| of the one-process port's; the table never gathered
    (the block's all-reduce carries one block, the MLP's gradient and the
    loss)."""
    ranks, one = world4
    shape, axis = aw.DLRM_WORLD4[layout]
    shards = shape["mv"]
    parts = int(np.prod([shape[a] for a in ((axis,) if isinstance(
        axis, str) else axis)]))
    bound_rows = aw.DLRM_BATCH // parts * len(aw.DLRM_CFG["vocab_sizes"])
    for r, rank in enumerate(ranks):
        got = rank[layout]
        np.testing.assert_allclose(got["losses"], one["losses"],
                                   rtol=DLRM_RTOL)
        for k in ("emb", "mlp"):
            _close(got[k], one[k], rtol=1e-12)
        assert got["unshard_calls"] == 0
        assert max(got["largest"]) < got["whole_numel"]
        bound = max(_dlrm_payload_bound(shards, bound_rows,
                                        got["mlp_padded"], 8),
                    8 * (got["whole_numel"] // shards + got["mlp_padded"]
                         + 1))
        for step in got["payloads"]:
            assert max(b for _, b in step) <= bound, (r, step)


@pytest.mark.parametrize("branch", aw.WE_WORLD4)
def test_train_fused_at_a_world_of_four(world4, branch):
    """``train_fused`` by owner on a table axis of 4 in f32: every rank's
    gathered tables, loss and LCG state equal the one-process port's bit
    for bit (each row read from its one owner plus three ranks' -0.0,
    each row's deltas added at its owner in the one-process order), the
    words counted once, and the tables never gathered."""
    ranks, one = world4
    want = one[f"we_{branch}"]
    size = int(aw.WE_ARGV[aw.WE_ARGV.index("-size") + 1])
    for rank in ranks:
        got = rank[f"we_{branch}"]
        _assert_by_owner(got, 4, size)
        assert got["loss"] == want["loss"]
        for k in ("in", "out"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if branch == "sg_shared":
            np.testing.assert_array_equal(got["lcg"], want["lcg"])
        assert got["words"] == want["words"] == want["tokens"]
