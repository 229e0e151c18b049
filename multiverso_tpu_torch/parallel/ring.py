"""Sequence (context) parallelism: ring attention, its zigzag layout and
Ulysses all-to-all (port of ``multiverso_tpu/parallel/ring.py``), and the
attention oracle ``reference_attention``.

Each function takes this rank's local ``[B, H, S/n, D]`` q/k/v, sharded
over the sequence axis ``axis_name`` of the mesh (and over ``batch_axis``
on B, ``head_axis`` on H when given), and returns this rank's local
output, which is what the JAX function's sequence-sharded output holds
on this rank.

* **Ring attention**: Q stays local, the K/V block rotates around the
  ring (``parallel/collectives.ppermute``, K and V packed in one tensor a
  hop; the backward sends their gradients the other way), and a
  numerically stable online softmax (running max, denominator, output in
  q's dtype, as in JAX) folds each visiting block in. Causal masking uses
  global block positions.
* **Zigzag**: rank i holds chunks i and 2n-1-i of the 2n sequence chunks,
  so every rank has the same causal work each tick; a dead chunk pair is
  skipped, not masked.
* **Ulysses**: ``all_to_all`` sequence -> heads, full softmax attention
  by einsum on all of S for H/n heads, heads -> sequence.

They keep the JAX math (einsum scores, no flash kernel: the JAX package
does not call its kernel there either). ``precision`` is accepted for
API parity: it names the TPU's matmul precision; the port's matmuls run
in the inputs' dtype.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from multiverso_tpu_torch.parallel import collectives as coll
from multiverso_tpu_torch.telemetry import devstats as _devstats
from multiverso_tpu_torch.zoo import Zoo

_NEG_INF = -1e30


def _mesh_axis(axis_name, mesh):
    zoo = Zoo.get()
    mesh = mesh or zoo.mesh()
    return mesh, (axis_name or mesh.axis_names[-1])


def sequence_shard(x, axis_name: Optional[str] = None, seq_dim: int = 2,
                   mesh=None) -> torch.Tensor:
    """This rank's sequence slice of a global [B, H, S, D] array (numpy
    or a host tensor), on the mesh's device."""
    mesh, ax = _mesh_axis(axis_name, mesh)
    t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) \
        else x
    n, i = mesh.axis_size(ax), mesh.index(ax)
    if t.shape[seq_dim] % n:
        raise ValueError(f"seq {t.shape[seq_dim]} not divisible by {n} "
                         "shards")
    c = t.shape[seq_dim] // n
    t = t.narrow(seq_dim, i * c, c).contiguous()
    _devstats.note_transfer(t.numel() * t.element_size(), "h2d")
    return t.to(mesh.device)


def _online_update(qc, kc, vc, scale, allowed, m, l, o):
    """One block of the online softmax: fold the scores of ``qc @ kc^T``
    (masked where ``allowed`` is False; None = no mask) into the running
    (max, denominator, output)."""
    neg_inf = torch.tensor(_NEG_INF, dtype=qc.dtype, device=qc.device)
    s = torch.einsum("bhqd,bhkd->bhqk", qc, kc) * scale
    if allowed is not None:
        s = torch.where(allowed[None, None], s, neg_inf)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    if allowed is not None:
        # fully masked rows would otherwise get exp(neg_inf - neg_inf) = 1
        p = torch.where(allowed[None, None], p, torch.zeros_like(p))
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    o_new = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vc)
    return m_new, l_new, o_new


def _init_state(q, rows):
    b, h, _, d = q.shape
    return (torch.full((b, h, rows), _NEG_INF, dtype=q.dtype,
                       device=q.device),
            torch.zeros((b, h, rows), dtype=q.dtype, device=q.device),
            torch.zeros((b, h, rows, d), dtype=q.dtype, device=q.device))


def ring_attention(q, k, v, axis_name: Optional[str] = None, mesh=None,
                   precision: Optional[str] = None, causal: bool = False,
                   batch_axis: Optional[str] = None,
                   head_axis: Optional[str] = None) -> torch.Tensor:
    """Ring attention over this rank's sequence block [B, H, S/n, D];
    returns its output block. ``batch_axis``/``head_axis`` name the axes
    B and H are sharded on (the inputs are already local, so they only
    label the layout).

    Causal note: with contiguous blocks rank i has useful work on i+1 of
    its n ticks; the masked ticks still run (as in JAX).
    :func:`zigzag_ring_attention` is the balanced layout."""
    mesh, ax = _mesh_axis(axis_name, mesh)
    n, idx = mesh.axis_size(ax), mesh.index(ax)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    sq, sk = q.shape[2], k.shape[2]
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v))
    with _devstats.collective_span("ring_attention", nbytes, mesh=mesh):
        qpos = idx * sq + torch.arange(sq, device=q.device)
        m, l, o = _init_state(q, sq)
        kv = torch.stack([k, v])
        for t in range(n):
            allowed = None
            if causal:
                # after t rotations the visiting block is (idx - t) % n
                j = (idx - t) % n
                kpos = j * sk + torch.arange(sk, device=q.device)
                allowed = qpos[:, None] >= kpos[None, :]
            m, l, o = _online_update(q, kv[0], kv[1], scale, allowed, m, l,
                                     o)
            if t < n - 1:
                kv = coll.ppermute(kv, mesh, ax, coll.ring_perm(n))
        return o / l[..., None]


def ulysses_attention(q, k, v, axis_name: Optional[str] = None, mesh=None,
                      causal: bool = False,
                      batch_axis: Optional[str] = None) -> torch.Tensor:
    """All-to-all sequence parallelism: sequence -> heads, full attention
    on H/n heads, heads -> sequence. The global head count must be
    divisible by the shard count."""
    mesh, ax = _mesh_axis(axis_name, mesh)
    n = mesh.axis_size(ax)
    if q.shape[1] % n:
        raise ValueError(f"heads {q.shape[1]} not divisible by shards {n}")
    scale = 1.0 / (q.shape[-1] ** 0.5)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v))
    with _devstats.collective_span("ulysses_attention", nbytes, mesh=mesh):
        # [3, B, H, S/n, D] -> [3, B, H/n, S, D]: one all_to_all for q, k
        # and v together
        qkv = coll.all_to_all(torch.stack([q, k, v]), mesh, ax,
                              split_dim=2, concat_dim=3)
        qh, kh, vh = qkv.unbind(0)
        s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
        if causal:
            sfull = qh.shape[2]
            mask = torch.ones((sfull, sfull), dtype=torch.bool,
                              device=q.device).tril()
            s = torch.where(mask, s, torch.tensor(_NEG_INF, dtype=s.dtype,
                                                  device=s.device))
        p = torch.softmax(s, -1)
        o = torch.einsum("bhqk,bhkd->bhqd", p, vh)
        return coll.all_to_all(o, mesh, ax, split_dim=2, concat_dim=1)


def zigzag_shard_ids(seq_len: int, n: int) -> np.ndarray:
    """Global token order of the zigzag layout: rank i owns chunks i and
    2n-1-i of the 2n equal chunks. ``x[..., perm, :]`` is zigzag-ordered
    (rank-major); ``np.argsort(perm)`` inverts it."""
    if seq_len % (2 * n):
        raise ValueError(f"seq {seq_len} not divisible by 2n={2 * n} chunks")
    c = seq_len // (2 * n)
    order = []
    for i in range(n):
        order.extend(range(i * c, (i + 1) * c))                    # chunk i
        j = 2 * n - 1 - i
        order.extend(range(j * c, (j + 1) * c))                    # 2n-1-i
    return np.asarray(order, np.int64)


def zigzag_ring_attention(q, k, v, axis_name: Optional[str] = None,
                          mesh=None, precision: Optional[str] = None,
                          batch_axis: Optional[str] = None,
                          head_axis: Optional[str] = None) -> torch.Tensor:
    """Causal ring attention over this rank's zigzag block [B, H, 2c, D]
    (chunks i and 2n-1-i); returns its output block in the same layout.
    Each tick computes the live chunk pairs only: q_lo against k_hi is
    always dead, q_hi against k_lo always fully live, and the other two
    are live, diagonal or dead by the visiting block's owner."""
    mesh, ax = _mesh_axis(axis_name, mesh)
    n, idx = mesh.axis_size(ax), mesh.index(ax)
    if q.shape[2] % 2:
        raise ValueError(f"local seq {q.shape[2]} is not two chunks")
    scale = 1.0 / (q.shape[-1] ** 0.5)
    c = q.shape[2] // 2
    ar = torch.arange(c, device=q.device)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v))

    def chunk_attn(qc, kc, vc, qpos0, kpos0, mode, st):
        if mode == 0:
            return st
        allowed = ((qpos0 + ar)[:, None] >= (kpos0 + ar)[None, :]
                   if mode == 1 else None)
        return _online_update(qc, kc, vc, scale, allowed, *st)

    with _devstats.collective_span("zigzag_ring_attention", nbytes,
                                   mesh=mesh):
        q_lo, q_hi = q[:, :, :c], q[:, :, c:]
        st_lo, st_hi = _init_state(q, c), _init_state(q, c)
        kv = torch.stack([k, v])
        for t in range(n):
            j = (idx - t) % n                  # owner of the visiting block
            k_lo, k_hi = kv[0, :, :, :c], kv[0, :, :, c:]
            v_lo, v_hi = kv[1, :, :, :c], kv[1, :, :, c:]
            qpos_lo, qpos_hi = idx * c, (2 * n - 1 - idx) * c
            kpos_lo, kpos_hi = j * c, (2 * n - 1 - j) * c
            m1 = 2 if idx > j else (1 if idx == j else 0)   # q_lo, k_lo
            m4 = 2 if idx < j else (1 if idx == j else 0)   # q_hi, k_hi
            st_lo = chunk_attn(q_lo, k_lo, v_lo, qpos_lo, kpos_lo, m1,
                               st_lo)
            st_hi = chunk_attn(q_hi, k_lo, v_lo, qpos_hi, kpos_lo, 2,
                               st_hi)
            st_hi = chunk_attn(q_hi, k_hi, v_hi, qpos_hi, kpos_hi, m4,
                               st_hi)
            if t < n - 1:
                kv = coll.ppermute(kv, mesh, ax, coll.ring_perm(n))
        return torch.cat([st_lo[2] / st_lo[1][..., None],
                          st_hi[2] / st_hi[1][..., None]], dim=2)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """Unsharded softmax attention over [B, H, S, D]: scores and softmax in
    f32 whatever the input dtype, ``p`` cast to ``v``'s dtype before
    ``p @ v``, output in ``v``'s dtype."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2:]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=s.device).tril()
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, -1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
