"""word2vec model math: skip-gram and CBOW, negative sampling and
hierarchical softmax (port of ``multiverso_tpu/models/word2vec.py``, the
parts the fused epochs and the PS block path need).

The step functions take the embedding tables as tensors and train them IN
PLACE (``index_add_``), where the JAX functions return new arrays; each
still returns ``(win, wout, loss)`` (``wout`` is the HS inner-node table
``hs_out`` in the HS steps). The JAX epoch is a ``lax.scan`` over batches
inside one jitted program; here it is a Python loop over the batch
dimension of device-resident tensors, so each batch is a dozen eager
PyTorch launches and the tables never leave the device. Only the
shared-pool epoch has a compute dtype; the others compute in the tables'
dtype (f32), as the JAX epochs do on every platform.

Random streams are the JAX package's own, so a seed gives the same
negative ids bit for bit:

* the shared pool comes from word2vec.c's linear congruential generator,
  jumped in closed form per batch (``_lcg_jump_consts``) and read through
  the 2^20-slot table. uint32 arithmetic runs on int64 tensors masked with
  ``0xFFFFFFFF``; the 32 x 32-bit product, which would overflow int64, is
  split into 16-bit halves of the multiplier;
* per-pair negatives (``make_fused_epoch``, ``make_fused_cbow_epoch``)
  come from jax.random's threefry2x32 (``utils/threefry.py``): the JAX
  epoch splits its key once per batch inside the scan; here the chain of
  splits is walked on the host and the whole epoch's (n, B, K) ids are
  drawn in one vectorized pass before the loop;
* the PS block path's negatives are slots of the 2^20-slot table hashed
  from counters by ``splitmix32`` (``counter_negs``), on numpy uint32
  arrays on the host and on int64 tensors on the device, equal bit for
  bit.

Scatter-adds with duplicate ids: on the CPU ``index_add_`` adds in index
order; on CUDA it uses atomics, so two runs differ by f32 rounding.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multiverso_tpu_torch.utils import threefry


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


def sample_negatives_table(keys: Sequence[threefry.Key],
                           neg_table: torch.Tensor, batch: int,
                           k: int) -> torch.Tensor:
    """(n, batch, k) negative ids for n keys, in one pass:
    ``jax.random.randint`` slots into ``neg_table``, row j drawn with key
    j (the JAX function's (batch, k) draw for each key)."""
    idx = threefry.randint(keys, (batch, k), 0, neg_table.shape[0],
                           device=neg_table.device)
    return neg_table[idx]


def epoch_negatives(key: threefry.Key, neg_table: torch.Tensor, n: int,
                    batch: int, k: int) -> torch.Tensor:
    """The (n, batch, k) negative ids a per-pair epoch of n batches draws
    from ``key``, equal to the JAX epoch's bit for bit: its scan takes
    ``key, sub = split(key)`` once per batch and draws with ``sub``."""
    subs = []
    for _ in range(n):
        key, sub = threefry.split(key)
        subs.append(sub)
    return sample_negatives_table(subs, neg_table, batch, k)


_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` and ``c`` (an int or an int64
    tensor) in [0, 2^32). The plain int64 product can pass 2^63, so ``c`` is
    split into 16-bit halves: ``x * c = x * c_lo + (x * c_hi) << 16``,
    where only the low 16 bits of ``x * c_hi`` survive the shift modulo
    2^32. Every intermediate stays below 2^49."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _MASK32


def splitmix32(x):
    """Counter-based hash (splitmix64's finalizer, 32-bit constants), equal
    bit for bit on numpy uint32 arrays and on int64 tensors holding values
    in [0, 2^32). The PS block path draws the same negative stream twice
    with it: on the host, to know which rows to pull, and on the device,
    so the sampled ids never cross the host -> device wire."""
    if isinstance(x, torch.Tensor):
        x = _mul32(x ^ (x >> 16), 0x7FEB352D)
        x = _mul32(x ^ (x >> 15), 0x846CA68B)
        return x ^ (x >> 16)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def counter_negs(base, count: int, table_mask: int):
    """Slot indices into a pow2-sized negative table for the counters
    [base, base + count), which wrap past 2^32 as uint32 does.
    ``table_mask`` = table size - 1. A numpy uint32 ``base`` gives a numpy
    uint32 array; a 0-d int64 tensor gives an int64 tensor on its
    device."""
    if isinstance(base, torch.Tensor):
        ctr = (torch.arange(count, dtype=torch.int64, device=base.device)
               + base) & _MASK32
        return splitmix32(ctr) & table_mask
    ctr = np.arange(count, dtype=np.uint32) + base
    return splitmix32(ctr) & np.uint32(table_mask)


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


def _ns_targets(pos: torch.Tensor, negatives: torch.Tensor,
                wout: torch.Tensor, v: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(flat target ids, their wout rows (B, K+1, D), labels (B, K+1)) for
    the positive ids ``pos`` (B,) and their negatives (B, K)."""
    b, k = negatives.shape
    tgt = torch.cat([pos[:, None], negatives.to(pos.dtype)], 1).reshape(-1)
    u = wout.index_select(0, tgt).reshape(b, k + 1, -1)
    labels = torch.cat([torch.ones((b, 1), dtype=v.dtype, device=v.device),
                        torch.zeros((b, k), dtype=v.dtype, device=v.device)],
                       dim=1)
    return tgt, u, labels


def skipgram_ns_step(win: torch.Tensor, wout: torch.Tensor,
                     centers: torch.Tensor, contexts: torch.Tensor,
                     negatives: torch.Tensor, lr: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One skip-gram negative-sampling minibatch with per-pair negatives,
    tables updated in place. centers/contexts: (B,); negatives: (B, K)."""
    v = win.index_select(0, centers)                          # (B, D)
    targets, u, labels = _ns_targets(contexts, negatives, wout, v)
    loss, dv, du = _ns_forward_backward(v, u, labels, lr)
    win.index_add_(0, centers, dv)
    wout.index_add_(0, targets, du.reshape(-1, du.shape[-1]))
    return win, wout, loss


def _cbow_mean(win: torch.Tensor, windows: torch.Tensor,
               window_mask: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked mean of the window's input vectors (ref FeedForward average,
    wordembedding.cpp:57-80). Returns (v, denom, m) for the backward."""
    b, w = windows.shape
    ctx = win.index_select(0, windows.reshape(-1)).reshape(b, w, -1)
    m = window_mask.to(ctx.dtype)[..., None]                   # (B, W, 1)
    denom = torch.clamp(m.sum(dim=1), min=1.0)                 # (B, 1)
    return (ctx * m).sum(dim=1) / denom, denom, m


def _cbow_spread(win: torch.Tensor, windows: torch.Tensor,
                 dv: torch.Tensor, denom: torch.Tensor,
                 m: torch.Tensor) -> torch.Tensor:
    """Scatter dv back over the window, divided like the forward mean. A
    masked-out slot (id 0) takes an exact zero, as in the JAX step."""
    dctx = (dv[:, None, :] / denom[:, None, :]) * m            # (B, W, D)
    return win.index_add_(0, windows.reshape(-1),
                          dctx.reshape(-1, dctx.shape[-1]))


def cbow_ns_step(win: torch.Tensor, wout: torch.Tensor,
                 windows: torch.Tensor, window_mask: torch.Tensor,
                 targets_pos: torch.Tensor, negatives: torch.Tensor,
                 lr: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One CBOW minibatch, tables updated in place: windows (B, W) context
    ids with a bool mask, whose averaged input vectors predict targets_pos
    (B,) against negatives (B, K)."""
    v, denom, m = _cbow_mean(win, windows, window_mask)
    tgt, u, labels = _ns_targets(targets_pos, negatives, wout, v)
    loss, dv, du = _ns_forward_backward(v, u, labels, lr)
    _cbow_spread(win, windows, dv, denom, m)
    wout.index_add_(0, tgt, du.reshape(-1, du.shape[-1]))
    return win, wout, loss


def _hs_forward_backward(v: torch.Tensor, u: torch.Tensor,
                         codes: torch.Tensor, path_mask: torch.Tensor,
                         lr: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hierarchical-softmax math. v: (B, D) predictor vectors; u: (B, L, D)
    inner-node vectors along each word's Huffman path. Returns (loss, dv,
    du), ascent deltas pre-scaled by lr."""
    scores = torch.einsum("bd,bld->bl", v, u)
    sig = torch.sigmoid(scores)
    # label for Huffman: predict 1 - code (word2vec.c convention)
    labels = 1.0 - codes.to(v.dtype)
    mask = path_mask.to(v.dtype)
    g = (labels - sig) * mask * lr                             # (B, L)
    dv = torch.einsum("bl,bld->bd", g, u)
    du = g[..., None] * v[:, None, :]
    # the where comes first, so a padded slot cannot give inf * 0
    masked = torch.where(path_mask, scores * (1 - 2 * codes),
                         torch.zeros((), dtype=scores.dtype,
                                     device=scores.device))
    loss = -torch.mean(torch.sum(F.logsigmoid(masked) * mask, dim=-1))
    return loss, dv, du


def skipgram_hs_step(win: torch.Tensor, hs_out: torch.Tensor,
                     centers: torch.Tensor, codes: torch.Tensor,
                     points: torch.Tensor, path_mask: torch.Tensor,
                     lr: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hierarchical-softmax skip-gram minibatch, tables updated in place.
    codes/points/path_mask: (B, L), the context word's Huffman path (ref
    huffman_encoder.cpp output, consumed at the wordembedding.cpp HS
    branch); hs_out has V-1 inner-node rows."""
    b, path_len = points.shape
    v = win.index_select(0, centers)                           # (B, D)
    flat = points.reshape(-1)
    u = hs_out.index_select(0, flat).reshape(b, path_len, -1)  # (B, L, D)
    loss, dv, du = _hs_forward_backward(v, u, codes, path_mask, lr)
    win.index_add_(0, centers, dv)
    hs_out.index_add_(0, flat, du.reshape(-1, du.shape[-1]))
    return win, hs_out, loss


def cbow_hs_step(win: torch.Tensor, hs_out: torch.Tensor,
                 windows: torch.Tensor, window_mask: torch.Tensor,
                 codes: torch.Tensor, points: torch.Tensor,
                 path_mask: torch.Tensor, lr: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CBOW x hierarchical softmax, tables updated in place: the averaged
    window context predicts the target word's Huffman path (ref
    wordembedding.cpp CBOW+HS branch). windows/window_mask: (B, W);
    codes/points/path_mask: (B, L), the TARGET word's path."""
    b, path_len = points.shape
    v, denom, m = _cbow_mean(win, windows, window_mask)
    flat = points.reshape(-1)
    u = hs_out.index_select(0, flat).reshape(b, path_len, -1)  # (B, L, D)
    loss, dv, du = _hs_forward_backward(v, u, codes, path_mask, lr)
    _cbow_spread(win, windows, dv, denom, m)
    hs_out.index_add_(0, flat, du.reshape(-1, du.shape[-1]))
    return win, hs_out, loss


class _OnDevice:
    """Host arrays copied to each device once, at first use there."""

    def __init__(self, *arrays: np.ndarray):
        self._host = [torch.from_numpy(np.asarray(a)) for a in arrays]
        self._by_device: Dict[torch.device, list] = {}

    def on(self, device: torch.device) -> list:
        got = self._by_device.get(device)
        if got is None:
            got = self._by_device[device] = [t.to(device)
                                             for t in self._host]
        return got


def _scan(step, win: torch.Tensor, wout: torch.Tensor, *xs: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX epochs' ``lax.scan``: ``step(win, wout, *batch) -> (win,
    wout, loss)`` over the leading axis of ``xs``; returns the tables and
    the mean loss, left on the device."""
    losses = []
    for batch in zip(*xs):
        win, wout, loss = step(win, wout, *batch)
        losses.append(loss)
    return win, wout, torch.stack(losses).mean()


# the negatives' table size, the JAX epochs' 2^20 slots
_TABLE_SLOTS = 1 << 20

SgEpochFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor, threefry.Key],
                     Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
CbowEpochFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor, torch.Tensor, threefry.Key],
                       Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def make_fused_epoch(cfg: W2VConfig, unigram: np.ndarray) -> SgEpochFn:
    """Skip-gram NS epoch with per-pair negatives (the reference's
    semantics, ``shared_negatives=0``). Returns ``epoch_fn(win, wout,
    centers, contexts, key) -> (win, wout, mean_loss)``: centers/contexts
    are (num_batches, B) on the tables' device, ``key`` a threefry key;
    batch t draws its (B, K) negatives with the t-th subkey of the JAX
    epoch's split chain, all n batches' ids in one pass before the loop."""
    table = _OnDevice(build_negative_table(unigram, _TABLE_SLOTS)
                      .astype(np.int64))

    def epoch_fn(win, wout, centers, contexts, key):
        n, b = centers.shape
        negs = epoch_negatives(key, table.on(win.device)[0], n, b,
                               cfg.negatives)
        return _scan(lambda w, o, c, x, neg: skipgram_ns_step(
            w, o, c, x, neg, cfg.learning_rate), win, wout, centers,
            contexts, negs)

    return epoch_fn


_LCG_A = np.uint32(1664525)
_LCG_C = np.uint32(1013904223)


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
    from the per-lane states ``lcg_state`` (K',) int64 in [0, 2^32); the
    products modulo 2^32 as :func:`_mul32` takes them."""
    At, Ct = _lcg_jump_consts(n)
    dev = lcg_state.device
    a = torch.from_numpy(At.astype(np.int64)).to(dev)[:, None]
    c = torch.from_numpy(Ct.astype(np.int64)).to(dev)[:, None]
    return (_mul32(lcg_state[None, :], a) + c) & _MASK32


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
    table = _OnDevice(build_negative_table(unigram, 1 << table_bits)
                      .astype(np.int64))
    neg_weight = cfg.negatives / k_shared
    shift = 32 - table_bits   # top bits: the LCG's low bits are weak

    def epoch_fn(win, wout, centers, contexts, lcg_state):
        neg_table = table.on(win.device)[0]
        s_all = lcg_states(lcg_state, centers.shape[0])
        nids = neg_table[s_all >> shift]                      # (n, K')
        win, wout, loss = _scan(lambda w, o, c, x, nid: shared_neg_step(
            w, o, c, x, nid, cfg.learning_rate, neg_weight, compute_dtype),
            win, wout, centers, contexts, nids)
        return win, wout, loss, s_all[-1]

    return epoch_fn


def init_lcg_state(k_shared: int, seed: int = 0) -> np.ndarray:
    """Independent per-lane LCG seeds for :func:`make_fused_shared_epoch`
    (uint32, the JAX package's draw)."""
    return np.random.default_rng(seed).integers(
        0, np.iinfo(np.uint32).max, size=(k_shared,), dtype=np.uint32)


def make_fused_cbow_epoch(cfg: W2VConfig, unigram: np.ndarray
                          ) -> CbowEpochFn:
    """CBOW-NS epoch with per-pair negatives. Returns ``epoch_fn(win,
    wout, windows, masks, targets, key) -> (win, wout, mean_loss)`` over
    (num_batches, B, W) windows and masks and (num_batches, B) targets;
    the negatives are drawn as in :func:`make_fused_epoch`."""
    table = _OnDevice(build_negative_table(unigram, _TABLE_SLOTS)
                      .astype(np.int64))

    def epoch_fn(win, wout, windows, masks, targets, key):
        n, b = targets.shape
        negs = epoch_negatives(key, table.on(win.device)[0], n, b,
                               cfg.negatives)
        return _scan(lambda w, o, ws, m, t, neg: cbow_ns_step(
            w, o, ws, m, t, neg, cfg.learning_rate), win, wout, windows,
            masks, targets, negs)

    return epoch_fn


def _make_path_gather(codes: np.ndarray, points: np.ndarray,
                      lengths: np.ndarray
                      ) -> Callable[[torch.Tensor], Tuple[torch.Tensor, ...]]:
    """Closure gathering words' Huffman paths on the ids' device: the path
    tables go there once; ``gather(ids) -> (code, point, mask)``, each
    ``ids.shape + (L,)``: codes and points int64, the mask bool."""
    tables = _OnDevice(codes.astype(np.int64), points.astype(np.int64),
                       lengths.astype(np.int64))
    max_len = codes.shape[1]

    def gather(ids: torch.Tensor):
        codes_d, points_d, lengths_d = tables.on(ids.device)
        steps = torch.arange(max_len, device=ids.device)
        mask = steps < lengths_d[ids][..., None]
        return codes_d[ids], points_d[ids], mask

    return gather


def make_fused_hs_epoch(cfg: W2VConfig, codes: np.ndarray,
                        points: np.ndarray, lengths: np.ndarray
                        ) -> SgEpochFn:
    """Hierarchical-softmax skip-gram epoch: ``epoch_fn(win, hs_out,
    centers, contexts, key) -> (win, hs_out, mean_loss)``; each batch
    gathers its contexts' Huffman paths. HS draws nothing at random: the
    key is taken and ignored, as in the JAX epoch, so every epoch function
    keeps one signature."""
    path = _make_path_gather(codes, points, lengths)

    def epoch_fn(win, hs_out, centers, contexts, key):
        del key
        return _scan(lambda w, o, c, x: skipgram_hs_step(
            w, o, c, *path(x), cfg.learning_rate), win, hs_out, centers,
            contexts)

    return epoch_fn


def make_fused_cbow_hs_epoch(cfg: W2VConfig, codes: np.ndarray,
                             points: np.ndarray, lengths: np.ndarray
                             ) -> CbowEpochFn:
    """CBOW x HS epoch: ``epoch_fn(win, hs_out, windows, masks, targets,
    key) -> (win, hs_out, mean_loss)``; each batch gathers its TARGETS'
    Huffman paths. The key is ignored, as in the JAX epoch."""
    path = _make_path_gather(codes, points, lengths)

    def epoch_fn(win, hs_out, windows, masks, targets, key):
        del key
        return _scan(lambda w, o, ws, m, t: cbow_hs_step(
            w, o, ws, m, *path(t), cfg.learning_rate), win, hs_out, windows,
            masks, targets)

    return epoch_fn


def generate_cbow_batches(ids: np.ndarray, window: int
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(windows, mask, targets) for CBOW: each position is a target
    predicted from its masked +-window context; slots past the corpus
    edges hold id 0 and a False mask."""
    pad = np.concatenate([np.full(window, -1, ids.dtype), ids,
                          np.full(window, -1, ids.dtype)])
    view = np.lib.stride_tricks.sliding_window_view(pad, 2 * window + 1)
    ctx = np.delete(view, window, axis=1)        # (n, 2*window)
    mask = ctx >= 0
    windows = np.where(mask, ctx, 0).astype(np.int32)
    return windows, mask, ids.astype(np.int32)


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
