"""lightLDA-style topic model on the sparse parameter-server tables (port
of ``multiverso_tpu/models/lda.py``).

The word-topic count matrix lives in a ``SparseMatrixTable`` (or the async
plane's ``ps.tables.AsyncSparseMatrixTable``: the trainer runs unchanged
on either). Per batch a worker PULLS only the batch's vocabulary rows
(stale ones cross the wire, fresh ones come from its row cache), runs a
few EM iterations on dense [D, L, K] responsibilities on the device, and
PUSHES the expected-count delta for those rows.

The scatter-add of the responsibilities onto the pulled rows is
``index_add_``; on the card it adds with atomics in no fixed order, so
the delta is not bit-reproducible there (hold it by tolerance).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class LDAConfig(NamedTuple):
    vocab_size: int = 1000
    num_topics: int = 8
    doc_len: int = 64        # tokens per document (fixed; pad/trim)
    em_iters: int = 5        # EM iterations per batch on the pulled rows
    alpha: float = 0.1       # document-topic prior
    beta: float = 0.01       # topic-word prior


def make_batch_step(cfg: LDAConfig):
    """Per-batch EM: ``(phi_rows, docs_local) -> (delta_rows, theta, ll)``.

    ``phi_rows`` [U, K] f32: the pulled word-topic counts of the batch's U
    unique words; ``docs_local`` [D, L] int: indices INTO those U rows.
    Returns the expected-count delta for the same U rows [U, K], the
    per-doc topic mixtures [D, K] and the batch mean log-likelihood (a
    0-dim tensor), all on the inputs' device."""
    K, a, b = cfg.num_topics, cfg.alpha, cfg.beta

    @torch.no_grad()
    def step(phi_rows: torch.Tensor, docs_local: torch.Tensor):
        # topic-word distribution from the counts (beta-smoothed); the
        # normalizer is the pulled rows' plus the prior mass, as in JAX
        phi = phi_rows + b
        phi = phi / torch.sum(phi, dim=0, keepdim=True)        # [U, K]
        d, l = docs_local.shape
        flat = docs_local.reshape(-1).long()
        theta = torch.full((d, K), 1.0 / K, dtype=torch.float32,
                           device=phi.device)
        pw = phi.index_select(0, flat).reshape(d, l, K)        # [D, L, K]
        ll = None
        for _ in range(cfg.em_iters):
            r = pw * theta[:, None, :]
            norm = torch.sum(r, dim=-1, keepdim=True)
            r = r / torch.clamp(norm, min=1e-30)
            theta = torch.sum(r, dim=1) + a
            theta = theta / torch.sum(theta, dim=-1, keepdim=True)
            ll = torch.mean(torch.log(torch.clamp(norm[..., 0], min=1e-30)))
        # final responsibilities -> expected word-topic counts, added onto
        # the pulled rows (duplicates accumulate)
        r = pw * theta[:, None, :]
        r = r / torch.clamp(torch.sum(r, dim=-1, keepdim=True), min=1e-30)
        delta = torch.zeros_like(phi_rows).index_add_(0, flat,
                                                      r.reshape(d * l, K))
        return delta, theta, ll

    return step


class LDATrainer:
    """Sparse push/pull training loop over a (sync or async) sparse
    matrix table.

    Per batch: unique word ids -> ``get_rows_sparse`` (stale rows only
    travel) -> EM on the table's device (:func:`make_batch_step`) ->
    ``add_rows`` of the expected-count delta. The table's default ``+=``
    updater is the count accumulator, as on lightLDA's servers."""

    def __init__(self, cfg: LDAConfig, table, worker_id: int = 0):
        self.cfg = cfg
        self.table = table
        self.worker_id = worker_id
        self.device = table.device
        self._step = make_batch_step(cfg)

    def train_batch(self, docs: np.ndarray) -> float:
        """docs [D, L] int global word ids; returns the batch mean ll."""
        uids, local = np.unique(docs.reshape(-1), return_inverse=True)
        rows = self.table.get_rows_sparse(uids, worker_id=self.worker_id)
        delta, _, ll = self._step(
            torch.from_numpy(np.ascontiguousarray(rows)).to(self.device),
            torch.from_numpy(local.reshape(docs.shape)).to(self.device))
        self.table.add_rows(uids, delta.cpu().numpy())
        return float(ll)

    def word_topics(self) -> np.ndarray:
        """argmax topic per word from the (pulled) full table."""
        counts = self.table.get()
        return np.argmax(counts + self.cfg.beta, axis=1)


def synthetic_corpus(cfg: LDAConfig, n_docs: int, seed: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Planted-topic corpus: topic k owns vocab block k; each doc mixes two
    topics. Returns (docs [n_docs, doc_len] int32, the true word->topic
    labels); the JAX package's arrays, bit for bit."""
    rng = np.random.default_rng(seed)
    K, V, L = cfg.num_topics, cfg.vocab_size, cfg.doc_len
    block = V // K
    labels = np.repeat(np.arange(K), block)
    labels = np.pad(labels, (0, V - labels.size), constant_values=K - 1)
    docs = np.empty((n_docs, L), np.int32)
    for d in range(n_docs):
        ks = rng.choice(K, size=2, replace=False)
        mix = rng.dirichlet([1.0, 1.0])
        topic_of_tok = ks[(rng.uniform(size=L) > mix[0]).astype(int)]
        offs = rng.integers(0, block, L)
        docs[d] = topic_of_tok * block + offs
    return docs, labels
