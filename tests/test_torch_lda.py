"""Port parity, ``models/lda.py``: multiverso_tpu_torch's LDA against
multiverso_tpu's (tests/test_lda.py) on the same planted-topic corpus.

Tolerances: the corpus bit for bit; ``make_batch_step``'s delta, theta and
log-likelihood within 1e-5 relative (f32 sums over the topics and the
document in another order); the delta's mass equal to the token count
within 1e-5 relative; the trainer's table after tests/test_lda.py's 3
epochs within 1e-4 of max |x| of the JAX package's, with purity > 0.85,
and its per-batch log-likelihoods within 5e-5 relative.
The port alone then recovers the topics over two ranks of
``AsyncSparseMatrixTable`` on the CPU.
"""

import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.models import lda as jlda
from multiverso_tpu_torch.models import lda as tlda
from multiverso_tpu_torch.ps import service as tsvc
from multiverso_tpu_torch.ps.tables import AsyncSparseMatrixTable
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard
from multiverso_tpu_torch.zoo import Zoo as TZoo

STEP_RTOL = 1e-5
# each batch's ll is a mean of 2,048 log terms over a table that has
# drifted by a few ulp after many batches: measured 6.5e-6 relative
LL_RTOL = 5e-5
TABLE_RTOL = 1e-4
PLANTED = dict(vocab_size=400, num_topics=4, doc_len=32, em_iters=4)


@pytest.fixture(autouse=True)
def _runtimes():
    yield
    if jmv.Zoo.get().started:
        jmv.shutdown()
    if TZoo.get().started:
        TZoo.get().stop()
    tconfig.reset_flags()
    TDashboard.reset()


def _purity(word_topics, labels, k):
    """tests/test_lda.py's greedy-matched agreement of learned topics with
    the planted ones."""
    conf = np.zeros((k, k))
    for w, t in enumerate(word_topics):
        conf[labels[w], t] += 1
    return conf.max(axis=1).sum() / conf.sum()


@pytest.mark.parametrize("seed,n", [(3, 600), (5, 64), (0, 7)])
def test_synthetic_corpus_bit_for_bit(seed, n):
    cfg = jlda.LDAConfig(**PLANTED)
    docs, labels = tlda.synthetic_corpus(tlda.LDAConfig(**PLANTED), n, seed)
    want_docs, want_labels = jlda.synthetic_corpus(cfg, n, seed)
    np.testing.assert_array_equal(docs, want_docs)
    np.testing.assert_array_equal(labels, want_labels)


@pytest.mark.parametrize("u,d,em_iters", [(20, 6, 3), (50, 16, 5), (3, 2, 1)])
def test_batch_step_matches_jax_and_conserves_counts(u, d, em_iters):
    kw = dict(vocab_size=64, num_topics=4, doc_len=8, em_iters=em_iters)
    rng = np.random.default_rng(u)
    phi = rng.uniform(0.0, 2.0, (u, 4)).astype(np.float32)
    docs_local = rng.integers(0, u, (d, 8)).astype(np.int32)
    jd, jth, jll = jlda.make_batch_step(jlda.LDAConfig(**kw))(phi, docs_local)
    td, tth, tll = tlda.make_batch_step(tlda.LDAConfig(**kw))(
        torch.from_numpy(phi), torch.from_numpy(docs_local))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=STEP_RTOL,
                               atol=STEP_RTOL * float(np.abs(jd).max()))
    np.testing.assert_allclose(tth.numpy(), np.asarray(jth), rtol=STEP_RTOL,
                               atol=1e-7)
    np.testing.assert_allclose(float(tll), float(jll), rtol=STEP_RTOL)
    # each token adds exactly one expected count
    np.testing.assert_allclose(float(td.sum()), d * 8, rtol=STEP_RTOL)
    np.testing.assert_allclose(tth.sum(1).numpy(), 1.0, rtol=STEP_RTOL)


def _train(trainers, docs, pick=lambda lo: 0):
    lls = []
    for _ in range(3):
        for lo in range(0, len(docs), 64):
            lls.append(trainers[pick(lo)].train_batch(docs[lo: lo + 64]))
    return lls


def test_planted_topics_table_matches_jax():
    jmv.init()
    tmv.init(device="cpu")
    jcfg, tcfg = jlda.LDAConfig(**PLANTED), tlda.LDAConfig(**PLANTED)
    jt = jmv.SparseMatrixTable(400, 4, name="lda_phi", num_workers=1)
    tt = tmv.SparseMatrixTable(400, 4, name="lda_phi", num_workers=1)
    docs, labels = tlda.synthetic_corpus(tcfg, 600, seed=3)
    want_lls = _train([jlda.LDATrainer(jcfg, jt)], docs)
    trainer = tlda.LDATrainer(tcfg, tt)
    lls = _train([trainer], docs)
    np.testing.assert_allclose(lls, want_lls, rtol=LL_RTOL)
    want, got = np.asarray(jt.get()), tt.get()
    assert np.abs(got - want).max() <= TABLE_RTOL * np.abs(want).max()
    # the likelihood ascends and the planted topics come back
    assert np.mean(lls[-5:]) > np.mean(lls[:5]) + 0.1
    assert _purity(trainer.word_topics(), labels, 4) > 0.85


def test_only_stale_rows_move():
    tmv.init(device="cpu")
    cfg = tlda.LDAConfig(vocab_size=256, num_topics=4, doc_len=16)
    table = tmv.SparseMatrixTable(256, 4, name="lda_stale", num_workers=1)
    trainer = tlda.LDATrainer(cfg, table)
    docs, _ = tlda.synthetic_corpus(cfg, 64, seed=5)
    trainer.train_batch(docs[:32])
    touched = np.unique(docs[:32].reshape(-1))
    untouched = np.setdiff1d(np.arange(256), touched)[:10]
    assert untouched.size and table.stale_fraction(untouched) == 1.0
    # the push dirtied the touched rows for every worker again
    assert table.stale_fraction(touched) == 1.0


def test_planted_topics_over_two_async_ranks(tmp_path):
    tconfig.set_flag("ps_timeout", 5.0)
    tconfig.set_flag("ps_connect_timeout", 3.0)
    rdv = tsvc.FileRendezvous(str(tmp_path / "rdv"))
    ctxs = [tsvc.PSContext(r, 2, tsvc.PSService(r, 2, rdv), device="cpu")
            for r in range(2)]
    try:
        cfg = tlda.LDAConfig(**PLANTED)
        tables = [AsyncSparseMatrixTable(400, 4, name="lda_async",
                                         num_workers=2, ctx=ctxs[r])
                  for r in range(2)]
        trainers = [tlda.LDATrainer(cfg, tables[r], worker_id=r)
                    for r in range(2)]
        docs, labels = tlda.synthetic_corpus(cfg, 600, seed=3)
        # batches alternate between the two workers
        lls = _train(trainers, docs, pick=lambda lo: (lo // 64) % 2)
        assert np.mean(lls[-5:]) > np.mean(lls[:5]) + 0.1
        for r in range(2):   # both read the same converged table
            assert _purity(trainers[r].word_topics(), labels, 4) > 0.85, r
    finally:
        for c in ctxs:
            c.close()
