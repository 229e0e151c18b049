"""Port parity at the WordEmbedding bench width on the real corpus: the
port's ``train_fused`` against the JAX package's, on the CPU, f32, for the
configurations whose losses rise or blow up there.

The width is bench.py:220-221 (size 128, batch 16,384, window 5, 5
negatives, min_count 5, sample 1e-4) on ``data/realtext.txt.gz``. Each
test makes the calls ``chip_smoke.py``'s ``we`` phase makes: a warm epoch
and three more, one epoch a call, each call drawing its negatives afresh
from the seed, as the JAX app does. At this width a rounding difference
grows with every batch (ROADMAP.md C.1), so past the first batches the two
packages are held by their losses, each within its measured bound.
"""

import jax
import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.apps import word_embedding as jwe
from multiverso_tpu_torch.apps import word_embedding as twe
from multiverso_tpu_torch.io import realtext
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard
from multiverso_tpu_torch.zoo import Zoo as TZoo

BENCH = dict(size=128, min_count=5, batch_size=16384, negative=5, window=5)
CALLS = 4                         # the warm epoch and three timed ones


@pytest.fixture(autouse=True)
def _both_runtimes():
    # the JAX package on one CPU device: on the 8-device test mesh its
    # tables shard 8 ways and every batch's gathers cross devices
    jmv.init(mesh=jax.sharding.Mesh(np.array(jax.devices()[:1]), ("mv",)))
    tmv.init(device="cpu")
    # one intra-op thread, as in test_torch_word_embedding.py: other test
    # processes share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    zoo = TZoo.get()
    if zoo.started:
        zoo.stop()
    tconfig.reset_flags()
    TDashboard.reset()


@pytest.fixture(scope="module")
def tokens():
    return realtext.load_tokens()


def _losses(tokens, calls, **kw):
    """Each package's loss per call of ``train_fused(ids, epochs=1)``, and
    the two WordEmbeddings."""
    cfg = {**BENCH, **kw}
    j = jwe.WordEmbedding(jwe.WEConfig(**cfg), jwe.Dictionary.build(tokens, 5))
    t = twe.WordEmbedding(twe.WEConfig(**cfg), twe.Dictionary.build(tokens, 5))
    ids = j.prepare_ids(tokens)
    np.testing.assert_array_equal(t.prepare_ids(tokens), ids)
    jl, tl = [], []
    for _ in range(calls):
        jl.append(j.train_fused(ids, epochs=1)["loss"])
        tl.append(t.train_fused(ids, epochs=1)["loss"])
    assert t.total_word_count() == j.total_word_count() == calls * ids.size
    return np.array(jl), np.array(tl), j, t


def test_cbow_ns_at_bench_width_matches_jax_epoch_by_epoch(tokens):
    """CBOW with per-pair negatives, 37 batches an epoch. Each call's loss
    within rtol 1e-5 of JAX's (measured <= 1.7e-7), and in both packages
    the loss falls for three epochs and rises in the fourth (JAX: 2.7649
    to 2.9264): the reference's own course at this batch, not the port's."""
    jl, tl, j, t = _losses(tokens, CALLS, cbow=1)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for losses in (jl, tl):
        assert losses[0] > losses[1] > losses[2] < losses[3], losses


@pytest.mark.parametrize("batch,trains", [(512, True), (1024, False)],
                         ids=["512_trains", "1024_rises"])
def test_cbow_hs_trains_up_to_batch_512(tokens, batch, trains):
    """CBOW with hierarchical softmax (Huffman paths of up to 18 nodes):
    every batch adds all its targets' updates into the Huffman root and
    the nodes below it at lr 0.025, so the batch bounds what trains. 512
    is the largest power of two at which the loss falls epoch after epoch
    over the four calls (at 16,384 it is NaN in the first epoch, see
    test_torch_word2vec.py); at 1024 it rises in the third call (JAX:
    7.661 to 9.092), in both packages alike. The losses agree to rtol
    1e-5 (measured <= 1e-7) up to the call where 1024 turns."""
    calls = CALLS if trains else 3
    jl, tl, _, _ = _losses(tokens, calls, cbow=1, hs=1, batch_size=batch)
    agree = calls if trains else 2
    np.testing.assert_allclose(tl[:agree], jl[:agree], rtol=1e-5)
    for losses in (jl, tl):
        assert np.isfinite(losses).all()
        assert bool(np.all(np.diff(losses) < 0)) == trains, losses
