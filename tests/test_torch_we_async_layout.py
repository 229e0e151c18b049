"""The async WordEmbedding example's layout (``examples/we_async.py``):
the reference's, as the JAX package's async cell runs it
(``tools/bench_we_async.py``): ``-data_presplit 1``, every rank fed the
whole corpus and sweeping every block with its deltas divided by the
world, and the ranks meeting before every epoch after the warm one.

* the example's configuration is the JAX cell's;
* the layout's arithmetic against the JAX package's: a rank of a world of
  2 (the topology forced, so the run is deterministic in one process)
  sweeps every block and pushes half-scaled deltas, block losses within
  rtol 1e-6 and tables within 1e-5 of the JAX app's (the bounds of
  ``tests/test_torch_async_apps.py``);
* two processes of the example meet at every marker.
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
from multiverso_tpu.apps import word_embedding as jwe
from multiverso_tpu.utils import config as jconfig
import multiverso_tpu_torch as tmv
from multiverso_tpu_torch.apps import word_embedding as twe
from multiverso_tpu_torch.examples import we_async
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard
from multiverso_tpu_torch.zoo import Zoo as TZoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(size=16, min_count=5, batch_size=128, negative=3,
             data_block_size=4000, seed=9, use_ps="1", async_ps="1")


@pytest.fixture(autouse=True)
def runtimes():
    for cfg in (tconfig, jconfig):
        cfg.set_flag("ps_timeout", 10.0)
        cfg.set_flag("ps_connect_timeout", 3.0)
    jconfig.set_flag("ps_native", False)
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


def test_example_config_is_the_jax_cells():
    """tools/bench_we_async.py:141-144's WEConfig (minus its pipeline and
    per-corpus block size) and the example's agree on every field."""
    want = jwe.WEConfig(size=128, min_count=5, batch_size=8192, negative=5,
                        window=5, data_block_size=50_000, use_ps="1",
                        async_ps="1", data_presplit="1", seed=12)
    got = twe.WEConfig(**we_async.WE_CFG)
    for field in ("size", "min_count", "batch_size", "negative", "window",
                  "data_block_size", "use_ps", "async_ps", "data_presplit",
                  "seed"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.data_presplit


@pytest.mark.parametrize("presplit", ["1", "0"])
def test_rank_of_two_sweeps_like_jax(presplit, monkeypatch):
    """Rank 0 of a world of 2 (topology forced): with -data_presplit 1 it
    trains EVERY block, with 0 only blocks[0::2]; either way it pushes
    (new - old) / 2. The port's blocks and tables follow the JAX app's."""
    tokens = twe.synthetic_corpus(30_000, vocab=300, seed=5)
    kw = dict(SMALL, data_presplit=presplit)
    j = jwe.WordEmbedding(jwe.WEConfig(**kw),
                          jwe.Dictionary.build(tokens, 5))
    t = twe.WordEmbedding(twe.WEConfig(**kw),
                          twe.Dictionary.build(tokens, 5))
    monkeypatch.setattr(type(j), "_ps_topology", lambda self: (2, 0))
    monkeypatch.setattr(type(t), "_ps_topology", lambda self: (2, 0))
    ids = j.prepare_ids(tokens)
    losses = {}
    for name, we in (("jax", j), ("port", t)):
        got, inner = [], we._train_prepared

        def record(*args, inner=inner, got=got):
            loss = inner(*args)
            got.append(float(loss))
            return loss

        we._train_prepared = record
        we.train_ps_blocks(ids, epochs=1)
        losses[name] = got
    n_blocks = -(-ids.size // SMALL["data_block_size"])
    assert len(losses["port"]) == (n_blocks if presplit == "1"
                                   else -(-n_blocks // 2))
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-6)
    for jt, tt in ((j.table_in, t.table_in), (j.table_out, t.table_out)):
        np.testing.assert_allclose(tt.get(), jt.get(), rtol=0, atol=1e-5)
    words = t.total_word_count()
    assert words == j.total_word_count()
    assert (words == ids.size) == (presplit == "1")


def test_two_processes_meet_before_every_epoch(tmp_path):
    rdv = str(tmp_path / "rdv")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "multiverso_tpu_torch.examples.we_async",
           "--rdv", rdv, "--world", "2", "--corpus", "synthetic",
           "--tokens", "12000", "--size", "16", "--batch_size", "256",
           "--block", "4000", "--device", "cpu", "--epochs", "3",
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
    marks = set(os.listdir(rdv))
    for tag in ("we_async_tables", "we_async_epoch1", "we_async_epoch2",
                "we_async_profiled", "we_async_trained"):
        assert {f"{tag}.0", f"{tag}.1"} <= marks, tag
    assert "we_async_epoch0.0" not in marks   # the warm epoch starts free
    r0, r1 = results
    assert r0["emb_sha"] == r1["emb_sha"]
    # three epochs and the profiled one, both ranks sweeping every block
    assert r0["total_word_count"] == 2 * 4 * r0["tokens"]
    assert len(r0["epochs"]) == len(r1["epochs"]) == 3
