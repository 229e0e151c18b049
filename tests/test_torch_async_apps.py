"""Port parity, the apps on the async PS plane: LogisticRegression with
``async_ps=true`` and WordEmbedding with ``-async_ps 1`` in
multiverso_tpu_torch against multiverso_tpu (``ps_native=False``), on
the CPU, on the same data and seeds.

* LR at world 1 on the configs of tests/test_logreg.py:53-100: dense
  (``AsyncArrayTable``), and sparse (``AsyncSparseKVTable``) with SGD and
  FTRL, pipelined or not. The weights after the first epoch agree with
  JAX's to ``TABLE_RTOL`` of their largest magnitude (the two packages'
  matrix products sum in other orders); the dense pipelined pull runs on
  a thread and is held by convergence. Accuracy above 0.9 in both.
* WE at world 1 on test_torch_ps_blocks.py's small config: every block's
  loss to rtol 1e-6 and both tables to atol 1e-5 of JAX's, and the
  pipelined path with the hot-row train cache equal to the unpipelined,
  uncached oracle bit for bit (bench.py:361-375's parity stage).
* WE at world 2: two OS processes of
  ``multiverso_tpu_torch.examples.we_async`` meeting through a rendezvous
  directory, in the reference's layout (``-data_presplit 1``: each rank
  sweeps every block, its deltas divided by the world).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.apps import logistic_regression as japp
from multiverso_tpu.apps import word_embedding as jwe
from multiverso_tpu.models import logreg as jlr
from multiverso_tpu.utils import config as jconfig
from multiverso_tpu_torch.apps import logistic_regression as tapp
from multiverso_tpu_torch.apps import word_embedding as twe
from multiverso_tpu_torch.ps import tables as ttables
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard
from multiverso_tpu_torch.zoo import Zoo as TZoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# LR from the same start: the products sum in another order and the
# convex loss does not amplify it (tests/test_torch_logreg.py's bound)
TABLE_RTOL = 1e-5
# tests/test_torch_ps_blocks.py's config, async tables
SMALL = dict(size=16, min_count=5, batch_size=128, negative=3,
             data_block_size=4000, seed=9, use_ps="1", async_ps="1")


@pytest.fixture(autouse=True)
def runtimes():
    for cfg in (tconfig, jconfig):
        cfg.set_flag("ps_timeout", 10.0)
        cfg.set_flag("ps_connect_timeout", 3.0)
    jconfig.set_flag("ps_native", False)
    # the JAX package on one CPU device (its tables then pad like the
    # port's); torch on one intra-op thread (other test processes share
    # the cores)
    jmv.init(mesh=jax.sharding.Mesh(np.array(jax.devices()[:1]), ("mv",)))
    tmv.init(device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    zoo = TZoo.get()
    if zoo.started:
        zoo.stop()
    tconfig.reset_flags()
    TDashboard.reset()


def _close(a, b, rtol=TABLE_RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(float(np.abs(a).max()), 1e-30)
    assert float(np.abs(a - b).max()) <= rtol * scale


def _write_svm(path, x, y):
    with open(path, "w") as f:
        for xi, yi in zip(x, y):
            feats = " ".join(f"{j}:{v:.5f}" for j, v in enumerate(xi))
            f.write(f"{yi} {feats}\n")


def _pairs(train, **over):
    base = dict(input_size="10", output_size="2", train_file=str(train),
                test_file=str(train), train_epoch="1", sync_frequency="1",
                async_ps="true", minibatch_size="64")
    base.update({k: str(v) for k, v in over.items()})
    return base


# ---------------------------------------------------------------------- #
# LogisticRegression
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("pipeline", ["false", "true"])
def test_async_lr_dense_matches_jax(tmp_path, pipeline):
    x, y = jlr.synthetic_dataset(1024, 10, 2, seed=6)
    train = tmp_path / "train.svm"
    _write_svm(train, x, y)
    pairs = _pairs(train, pipeline=pipeline)
    j = japp.LogReg(japp.LogRegConfig(pairs))
    t = tapp.LogReg(tapp.LogRegConfig(pairs))
    assert isinstance(t.table, ttables.AsyncArrayTable)
    j.train_file()
    t.train_file()
    if pipeline == "false":
        _close(t._local_w, j._local_w)
    for lr in (j, t):   # a second epoch, then the held-out accuracy
        lr.train_file()
        assert lr.test_file() > 0.9
    with pytest.raises(ValueError, match="async_ps"):
        t.train_arrays(x, y)


@pytest.mark.parametrize("updater,pipeline", [("sgd", "false"),
                                              ("sgd", "true"),
                                              ("ftrl", "false"),
                                              ("ftrl", "true")])
def test_async_lr_sparse_matches_jax(tmp_path, updater, pipeline):
    """Hash-keyed feature rows on an AsyncSparseKVTable (FTRL's z/n as
    shard state). The pipelined lookahead dispatches batch N+1's pull
    before batch N's push on one FIFO, so it is deterministic and held to
    JAX too."""
    x, y = jlr.synthetic_dataset(1024, 10, 2, seed=8)
    train = tmp_path / "train.svm"
    _write_svm(train, x, y)
    pairs = _pairs(train, sparse="true", updater_type=updater,
                   pipeline=pipeline,
                   learning_rate="0.5" if updater == "sgd" else "0.1")
    j = japp.LogReg(japp.LogRegConfig(pairs))
    t = tapp.LogReg(tapp.LogRegConfig(pairs))
    assert isinstance(t.sparse_table, ttables.AsyncSparseKVTable)
    j.train_file()
    t.train_file()
    _close(t.sparse_table.get(), j.sparse_table.get())
    for lr in (j, t):
        lr.train_file()
        lr.train_file()
        assert lr.test_file() > 0.9
    # the model round-trips through the JAX package's checkpoint format
    path = tmp_path / "m.bin"
    t.cfg.output_file = str(path)
    t.save_model()
    j.load_model(str(path))
    _close(j.sparse_table.get(), t.sparse_table.get(), rtol=0)


def test_async_lr_config_errors():
    with pytest.raises(ValueError, match="async_ps"):
        tapp.LogRegConfig({"input_size": "4", "async_ps": "true",
                           "mnist_dir": "auto"})


# ---------------------------------------------------------------------- #
# WordEmbedding
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def small_tokens():
    return twe.synthetic_corpus(50_000, vocab=300, seed=5)


def _block_losses(we) -> list:
    out, inner = [], we._train_prepared

    def record(*args):
        loss = inner(*args)
        out.append(loss)
        return loss

    we._train_prepared = record
    return out


@pytest.mark.parametrize("variant", [{}, {"cbow": 1, "hs": 1}],
                         ids=["sg", "cbow_hs"])
def test_we_async_blocks_match_jax(small_tokens, variant):
    """World 1: the async tables' seeded init (default_rng([seed, lo]))
    and the host plane agree with the JAX app block by block."""
    kw = dict(SMALL, **variant)
    j = jwe.WordEmbedding(jwe.WEConfig(**kw),
                          jwe.Dictionary.build(small_tokens, 5))
    t = twe.WordEmbedding(twe.WEConfig(**kw),
                          twe.Dictionary.build(small_tokens, 5))
    assert isinstance(t.table_in, ttables.AsyncMatrixTable)
    assert isinstance(t.word_count, ttables.AsyncKVTable)
    assert t._ps_topology() == (1, 0) == j._ps_topology()
    ids = j.prepare_ids(small_tokens)
    np.testing.assert_array_equal(t.prepare_ids(small_tokens), ids)
    np.testing.assert_array_equal(t.table_in.get(), j.table_in.get())
    jl, tl = _block_losses(j), _block_losses(t)
    js, ts = j.train_ps_blocks(ids, epochs=1), t.train_ps_blocks(ids,
                                                                  epochs=1)
    assert len(tl) == len(jl) == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    np.testing.assert_allclose(ts["loss"], js["loss"], rtol=1e-6)
    sec = (lambda we: we.table_hs) if variant else (lambda we: we.table_out)
    for jt, tt in ((j.table_in, t.table_in), (sec(j), sec(t))):
        want = jt.get()
        assert np.abs(want).max() > 1e-2
        np.testing.assert_allclose(tt.get(), want, rtol=0, atol=1e-5)
    assert t.total_word_count() == j.total_word_count() == ids.size
    with pytest.raises(ValueError, match="train_ps_blocks"):
        t.train_fused(ids)


def test_we_async_pipelined_cached_equals_the_oracle(small_tokens):
    """bench.py:361-375's parity stage at world 1: the pipelined path with
    the hot-row train cache (write-through) equals the unpipelined,
    uncached oracle bit for bit, over two epochs."""
    out = {}
    for mode in ("pipeline", "oracle"):
        tconfig.set_flag("train_cache_rows",
                         1 << 16 if mode == "pipeline" else 0)
        kw = dict(SMALL, pipeline="1" if mode == "pipeline" else "0")
        t = twe.WordEmbedding(twe.WEConfig(**kw),
                              twe.Dictionary.build(small_tokens, 5))
        losses = _block_losses(t)
        stats = t.train_ps_blocks(t.prepare_ids(small_tokens), epochs=2)
        cache = t.table_in.train_cache_stats()
        out[mode] = (stats["loss"], losses, t.table_in.get(),
                     t.table_out.get())
        if mode == "pipeline":
            assert cache["hits"] > 0
            assert t.table_in._train_cache.device == t.table_in.device
        else:
            assert cache is None
        TZoo.get().stop()
        tmv.init(device="cpu")
    assert len(out["pipeline"][1]) == 6
    assert out["pipeline"][:2] == out["oracle"][:2]
    for a, b in zip(out["pipeline"][2:], out["oracle"][2:]):
        np.testing.assert_array_equal(a, b)


def test_we_async_two_processes(tmp_path):
    """World 2 in two OS processes on the CPU (the card's product shape,
    chip_smoke.py's ps_async phase, at a tiny size): both ranks finish,
    see the same tables, count every rank's words, report their monitors
    and a profiled epoch, and the loss is finite."""
    rdv = str(tmp_path / "rdv")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "multiverso_tpu_torch.examples.we_async",
           "--rdv", rdv, "--world", "2", "--corpus", "synthetic",
           "--tokens", "20000", "--size", "16", "--batch_size", "256",
           "--block", "4000", "--device", "cpu", "--epochs", "2",
           "--timeout", "120", "--profile"]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    results = []
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-3000:]
        line = [l for l in so.splitlines() if l.startswith("RESULT ")]
        results.append(json.loads(line[-1][7:]))
    r0, r1 = results
    assert r0["emb_sha"] == r1["emb_sha"] and r0["emb_finite"]
    assert r0["shard_rows"][1] == r1["shard_rows"][0]
    # two epochs and the profiled one, each rank sweeping every block
    assert r0["total_word_count"] == r1["total_word_count"] == \
        2 * 3 * r0["tokens"]
    for r in results:
        assert all(np.isfinite(e["loss"]) for e in r["epochs"])
        assert r["profiled_epoch"]["seconds"] > 0
        assert r["monitors"]["we.block"]["count"] > 0
