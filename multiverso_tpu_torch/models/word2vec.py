"""word2vec model math (port of ``multiverso_tpu/models/word2vec.py``, the
parts the fused skip-gram path with a batch-shared negative pool needs).

The step functions take the two embedding tables as tensors and train them
IN PLACE (``index_add_``), where the JAX functions return new arrays; each
still returns ``(win, wout, loss)``. The JAX epoch is a ``lax.scan`` over
pair batches inside one jitted program; here it is a Python loop over the
batch dimension of device-resident pair tensors, so each batch is a dozen
eager PyTorch launches and the tables never leave the device.

Random streams are the JAX package's own: the shared negatives come from
word2vec.c's linear congruential generator, jumped in closed form per batch
(``_lcg_jump_consts``) and read through the same 2^20-slot table, so a seed
gives the same negative ids bit for bit. uint32 arithmetic runs on int64
tensors masked with ``0xFFFFFFFF``; the 32 x 32-bit product, which would
overflow int64, is split into 16-bit halves of the multiplier.

Scatter-adds with duplicate ids: on the CPU ``index_add_`` adds in index
order; on CUDA it uses atomics, so two runs differ by f32 rounding.

Not ported yet (ROADMAP): per-pair negatives from ``jax.random``
(``make_fused_epoch``), CBOW and hierarchical softmax, and the PS block
path's ``splitmix32``/``counter_negs``.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class W2VConfig(NamedTuple):
    vocab_size: int
    embedding_dim: int = 128
    negatives: int = 5
    window: int = 5
    learning_rate: float = 0.025
    cbow: bool = False
    hierarchical_softmax: bool = False
    shared_negatives: int = 0  # >0: batch-shared negative pool


def init_embeddings(cfg: W2VConfig, seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Input: uniform +-0.5/dim (ref communicator.cpp:20 server random
    init); output: zeros."""
    rng = np.random.default_rng(seed)
    win = ((rng.random((cfg.vocab_size, cfg.embedding_dim)) - 0.5)
           / cfg.embedding_dim).astype(np.float32)
    wout = np.zeros((cfg.vocab_size, cfg.embedding_dim), dtype=np.float32)
    return win, wout


def build_negative_table(unigram: np.ndarray, size: int = 1 << 20
                         ) -> np.ndarray:
    """Precomputed sampling table: word w occupies ~unigram[w]*size slots
    (word2vec.c's table, sized 2^20). Sampling is a uniform slot and one
    gather."""
    p = np.asarray(unigram, dtype=np.float64)
    p = p / p.sum()
    counts = np.maximum(np.round(p * size).astype(np.int64), 1)
    table = np.repeat(np.arange(p.size, dtype=np.int32), counts)
    if table.size >= size:
        return table[:size]
    pad = np.random.default_rng(0).choice(
        p.size, size - table.size, p=p).astype(np.int32)
    return np.concatenate([table, pad])


def _ns_forward_backward(v: torch.Tensor, u: torch.Tensor,
                         labels: torch.Tensor, lr: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Negative-sampling math. v: (B, D); u: (B, T, D); labels: (T,) or
    (B, T). Returns (loss, dv, du), ascent deltas pre-scaled by lr (ref
    BPOutputLayer, wordembedding.cpp:100-140)."""
    scores = torch.einsum("bd,btd->bt", v, u)
    sig = torch.sigmoid(scores)
    g = (labels - sig) * lr                                   # (B, T)
    dv = torch.einsum("bt,btd->bd", g, u)
    du = g[..., None] * v[:, None, :]
    # loss: -log sigmoid(pos) - log sigmoid(-neg)
    logsig = F.logsigmoid(torch.where(labels > 0, scores, -scores))
    loss = -torch.mean(torch.sum(logsig, dim=-1))
    return loss, dv, du


def skipgram_ns_step(win: torch.Tensor, wout: torch.Tensor,
                     centers: torch.Tensor, contexts: torch.Tensor,
                     negatives: torch.Tensor, lr: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One skip-gram negative-sampling minibatch with per-pair negatives,
    tables updated in place. centers/contexts: (B,); negatives: (B, K)."""
    b, k = negatives.shape
    d = win.shape[1]
    v = win.index_select(0, centers)                          # (B, D)
    targets = torch.cat([contexts[:, None], negatives], dim=1).reshape(-1)
    u = wout.index_select(0, targets).reshape(b, k + 1, d)    # (B, K+1, D)
    labels = torch.cat([torch.ones((b, 1), dtype=v.dtype, device=v.device),
                        torch.zeros((b, k), dtype=v.dtype, device=v.device)],
                       dim=1)
    loss, dv, du = _ns_forward_backward(v, u, labels, lr)
    win.index_add_(0, centers, dv)
    wout.index_add_(0, targets, du.reshape(-1, d))
    return win, wout, loss


_LCG_A = np.uint32(1664525)
_LCG_C = np.uint32(1013904223)
_MASK32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=8)
def _lcg_jump_consts(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Closed-form LCG jump constants: ``s_t = A^t * s_0 + C_t (mod 2^32)``
    for t = 1..n, so a whole epoch's sampler states come from one
    vectorized (n, K') expression. Bit-identical to stepping the
    recurrence n times."""
    At = np.empty(n, np.uint32)
    Ct = np.empty(n, np.uint32)
    # python ints masked to 32 bits (np.uint32 scalars would wrap too, but
    # warn on every overflow)
    A, C = int(_LCG_A), int(_LCG_C)
    a, c = A, C
    for t in range(n):
        At[t], Ct[t] = a, c
        a = (a * A) & _MASK32
        c = (c * A + C) & _MASK32
    return At, Ct


def lcg_states(lcg_state: torch.Tensor, n: int) -> torch.Tensor:
    """The sampler's states after 1..n steps, (n, K') int64 in [0, 2^32),
    from the per-lane states ``lcg_state`` (K',) int64 in [0, 2^32).

    ``s * A_t mod 2^32`` with both factors below 2^32 would overflow int64,
    so A_t is split into 16-bit halves: ``s * A = s * a_lo + (s * a_hi) <<
    16``, where only the low 16 bits of ``s * a_hi`` survive the shift
    modulo 2^32. Every intermediate stays below 2^49."""
    At, Ct = _lcg_jump_consts(n)
    dev = lcg_state.device
    a = torch.from_numpy(At.astype(np.int64)).to(dev)[:, None]
    c = torch.from_numpy(Ct.astype(np.int64)).to(dev)[:, None]
    s = lcg_state[None, :]
    prod = s * (a & 0xFFFF) + (((s * (a >> 16)) & 0xFFFF) << 16)
    return (prod + c) & _MASK32


def shared_neg_step(win: torch.Tensor, wout: torch.Tensor,
                    centers: torch.Tensor, contexts: torch.Tensor,
                    neg_ids: torch.Tensor, lr: float,
                    neg_weight: float = 1.0,
                    compute_dtype: torch.dtype = torch.bfloat16
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Skip-gram NS minibatch with a batch-SHARED pool of K' negatives,
    tables updated in place.

    The reference draws k fresh negatives per pair; sharing one pool across
    the minibatch turns the negative half into two (B, D) x (D, K') matrix
    products and a K'-row scatter. ``neg_weight`` (typically k/K') rescales
    the negative gradient so the expected objective matches k negatives per
    pair. centers/contexts: (B,); neg_ids: (K',). The tables keep their
    storage dtype (f32); the products run in ``compute_dtype``.
    """
    cd = compute_dtype
    v = win.index_select(0, centers).to(cd)                   # (B, D)
    up = wout.index_select(0, contexts).to(cd)                # (B, D)
    un = wout.index_select(0, neg_ids).to(cd)                 # (K', D)
    pos = torch.sum(v * up, dim=-1).float()                   # (B,)
    negs = torch.matmul(v, un.t()).float()                    # (B, K')
    gp = ((1.0 - torch.sigmoid(pos)) * lr).to(cd)
    gn = (-torch.sigmoid(negs) * (lr * neg_weight)).to(cd)
    dv = gp[:, None] * up + torch.matmul(gn, un)              # (B, D)
    dup = gp[:, None] * v
    dun = torch.matmul(gn.t(), v)                             # (K', D)
    loss = (-torch.mean(F.logsigmoid(pos))
            - neg_weight * torch.mean(
                torch.sum(F.logsigmoid(-negs), dim=-1)))
    win.index_add_(0, centers, dv.to(win.dtype))
    # two scatters into wout, not one over the concatenated rows: the
    # K'-row pool scatter is cheap, while concatenating materializes a
    # (B + K', D) tensor
    wout.index_add_(0, contexts, dup.to(wout.dtype))
    wout.index_add_(0, neg_ids, dun.to(wout.dtype))
    return win, wout, loss


EpochFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                    torch.Tensor],
                   Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]]


def make_fused_shared_epoch(cfg: W2VConfig, unigram: np.ndarray,
                            compute_dtype: torch.dtype = torch.bfloat16,
                            table_bits: int = 20) -> EpochFn:
    """Epoch with batch-shared negatives drawn by word2vec.c's LCG
    (``next_random = next_random * A + C``, which the reference inherits
    at wordembedding.cpp SampleNegative).

    Returns ``epoch_fn(win, wout, centers, contexts, lcg_state) -> (win,
    wout, mean_loss, lcg_state)``: centers/contexts are (num_batches, B)
    int64 on the tables' device, lcg_state (K',) int64 in [0, 2^32). The
    whole epoch's sampler states come from one closed-form jump and one
    table gather before the loop; each batch then runs
    :func:`shared_neg_step` in place. The mean loss stays on the device
    (the caller reads it once), and the returned state is the last
    batch's, which carries into the next epoch.
    """
    k_shared = cfg.shared_negatives
    if k_shared <= 0:
        raise ValueError("cfg.shared_negatives must be > 0")
    table = torch.from_numpy(build_negative_table(
        unigram, 1 << table_bits).astype(np.int64))
    neg_weight = cfg.negatives / k_shared
    shift = 32 - table_bits   # top bits: the LCG's low bits are weak
    tables: Dict[torch.device, torch.Tensor] = {}

    def epoch_fn(win, wout, centers, contexts, lcg_state):
        neg_table = tables.get(win.device)
        if neg_table is None:
            neg_table = tables[win.device] = table.to(win.device)
        s_all = lcg_states(lcg_state, centers.shape[0])
        nids = neg_table[s_all >> shift]                      # (n, K')
        losses = []
        for c, x, nid in zip(centers, contexts, nids):
            win, wout, loss = shared_neg_step(
                win, wout, c, x, nid, cfg.learning_rate, neg_weight,
                compute_dtype)
            losses.append(loss)
        return win, wout, torch.stack(losses).mean(), s_all[-1]

    return epoch_fn


def init_lcg_state(k_shared: int, seed: int = 0) -> np.ndarray:
    """Independent per-lane LCG seeds for :func:`make_fused_shared_epoch`
    (uint32, the JAX package's draw)."""
    return np.random.default_rng(seed).integers(
        0, np.iinfo(np.uint32).max, size=(k_shared,), dtype=np.uint32)


def nearest_neighbors(win: np.ndarray, word_id: int,
                      k: int = 10) -> np.ndarray:
    """Cosine-similarity neighbors (analogy/eval helper)."""
    w = win / (np.linalg.norm(win, axis=1, keepdims=True) + 1e-8)
    sims = w @ w[word_id]
    return np.argsort(-sims)[1: k + 1]


def generate_pairs(ids: np.ndarray, window: int, seed: int = 0,
                   dynamic: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Sliding-window (center, context) pairs with the reference's random
    window shrink (word2vec 'b = rand % window'), vectorized one offset at
    a time, then shuffled so minibatches mix offsets. The numpy fallback
    of the native generator: another RNG, so other pairs."""
    n = ids.size
    if n < 2:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32))
    rng = np.random.default_rng(seed)
    win_sizes = (rng.integers(1, window + 1, size=n) if dynamic
                 else np.full(n, window))
    centers_parts, contexts_parts = [], []
    idx = np.arange(n)
    for d in range(1, window + 1):
        ok = win_sizes >= d
        fwd = ok & (idx + d < n)
        bwd = ok & (idx - d >= 0)
        i_f = idx[fwd]
        i_b = idx[bwd]
        centers_parts.append(ids[i_f])
        contexts_parts.append(ids[i_f + d])
        centers_parts.append(ids[i_b])
        contexts_parts.append(ids[i_b - d])
    centers = np.concatenate(centers_parts).astype(np.int32)
    contexts = np.concatenate(contexts_parts).astype(np.int32)
    perm = rng.permutation(centers.size)
    return centers[perm], contexts[perm]
