"""The plain DLRM step in float32 with AdaGrad on both tables.

Written from facebookresearch/dlrm's architecture: each of the F
categorical fields reads one row of its embedding (all fields' rows in one
matrix, field f's rows after those of the fields before it), the dense
features go through the bottom MLP (ReLU after every layer), the bottom
output and the F rows interact by their pairwise dots (the upper
triangle, without the diagonal), the top MLP (ReLU after every layer but
the last) reads the bottom output and the dots, and the loss is the mean
binary cross-entropy of the logit. Autograd gives the gradients; a row
read by several examples of the batch gets the sum of their gradients.

AdaGrad is Multiverso's: per element, ``G += g**2 / lr**2`` and
``w -= g * rho / (sqrt(G) + 1e-10)``, on the embedding's rows and on the
MLP's weights alike. Products are float32 with TF32 off, or the control's
lower precision (``lowp``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from benchmark import traffic
from benchmark.reference import lowp

EPS = 1e-10


def _named(mlp: Dict[str, List[torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {f"{k}.{i}": t for k, ts in mlp.items() for i, t in enumerate(ts)}


def _mlp(x, ws, bs, mode, last_linear):
    for i, (w, b) in enumerate(zip(ws, bs)):
        x = lowp.matmul(x, w, mode) + b
        if not (last_linear and i == len(ws) - 1):
            x = torch.relu(x)
    return x


def loss_of(p: Dict[str, torch.Tensor], rows: torch.Tensor,
            dense: torch.Tensor, labels: torch.Tensor, cfg: Dict,
            mode: Optional[str] = None) -> torch.Tensor:
    """rows [B, F, D], dense [B, 13], labels [B] -> mean BCE."""
    nb = len(traffic.dlrm_mlp_shapes(cfg)[0])
    nt = len(traffic.dlrm_mlp_shapes(cfg)[1])
    x = _mlp(dense, [p[f"bottom_w.{i}"] for i in range(nb)],
             [p[f"bottom_b.{i}"] for i in range(nb)], mode, False)
    z = torch.cat([x[:, None, :], rows], 1)
    dots = lowp.matmul(z, z.transpose(1, 2), mode)
    iu, ju = torch.triu_indices(z.shape[1], z.shape[1], 1, device=z.device)
    top_in = torch.cat([x, dots[:, iu, ju]], 1)
    logit = _mlp(top_in, [p[f"top_w.{i}"] for i in range(nt)],
                 [p[f"top_b.{i}"] for i in range(nt)], mode, True)[:, 0]
    return F.binary_cross_entropy_with_logits(logit, labels)


def adagrad_(w: torch.Tensor, hist: torch.Tensor, g: torch.Tensor,
             lr: float, rho: float) -> None:
    hist += g * g / (lr * lr)
    w -= g * rho / (torch.sqrt(hist) + EPS)


def run(cfg: Dict, cell: Dict, seed: int, device, mode: Optional[str] = None,
        half_batch: bool = False, reverse: bool = False,
        fault: Optional[str] = None) -> Dict:
    """The first three steps from ``seed``'s tables on the pool's first
    three batches. Returns each step's loss, each leaf's norm of the first
    gradient as AdaGrad's state shows it (lr * sqrt(G)), and of the change
    after the three steps; the embedding is the leaf ``"emb"``.
    ``half_batch`` plants the fault of a step that leaves half of its
    batch out; ``reverse`` takes each batch's examples in reverse order,
    the same sums in another order. ``fault`` plants one in the
    embedding's update alone: ``"emb_sign"`` applies it with the wrong
    sign, ``"emb_rho"`` with twice rho, ``"emb_offset"`` writes the
    second and third steps' rows one row on."""
    tr = cell["traffic"]
    lr, rho = tr["lr"], tr["rho"]
    rows_n = cfg["table_rows"]
    offsets = torch.tensor(traffic.field_offsets(rows_n), device=device,
                           dtype=torch.int64)
    dim = cfg["arch_sparse_feature_size"]
    with torch.no_grad():
        table = torch.empty((sum(rows_n), dim), device=device)
        traffic.dlrm_table_into(cfg, seed, table)
        table0 = table.clone()
        hist = torch.zeros_like(table)
        mlp = _named(traffic.dlrm_mlp(cfg, seed, device))
        mlp0 = {k: v.clone() for k, v in mlp.items()}
        mhist = {k: torch.zeros_like(v) for k, v in mlp.items()}
        ids, dense, labels = traffic.dlrm_batches(cfg, tr, seed, device)
    losses: List[float] = []
    grad_norm: Dict[str, float] = {}
    with lowp.strict_float32():
        for i in range(3):
            n = ids.shape[1] // 2 if half_batch else ids.shape[1]
            order = torch.arange(n - 1, -1, -1, device=device) if reverse \
                else torch.arange(n, device=device)
            gid = (ids[i, order].long() + offsets).reshape(-1)
            uids, inv = torch.unique(gid, return_inverse=True)
            urows = table[uids].requires_grad_()
            leaves = {k: v.detach().requires_grad_() for k, v in mlp.items()}
            loss = loss_of(leaves, urows[inv].reshape(n, len(rows_n), dim),
                           dense[i, order], labels[i, order], cfg, mode)
            gs = torch.autograd.grad(loss, [urows] + list(leaves.values()))
            losses.append(float(loss.detach()))
            with torch.no_grad():
                w_rows, h_rows = table[uids], hist[uids]
                adagrad_(w_rows, h_rows, gs[0], lr,
                         2 * rho if fault == "emb_rho" else rho)
                if fault == "emb_sign":
                    w_rows = 2 * table[uids] - w_rows
                dst = uids
                if fault == "emb_offset" and i > 0:
                    dst = (uids + 1) % table.shape[0]
                table[dst], hist[dst] = w_rows, h_rows
                for (k, w), g in zip(mlp.items(), gs[1:]):
                    adagrad_(w, mhist[k], g, lr, rho)
                if i == 0:
                    grad_norm = {"emb": lr * float(
                        hist.sum(dtype=torch.float64).sqrt())}
                    grad_norm.update({k: lr * float(
                        h.sum(dtype=torch.float64).sqrt())
                                      for k, h in mhist.items()})
    with torch.no_grad():
        change = {"emb": float((table - table0).norm())}
        change.update({k: float((mlp[k] - mlp0[k]).norm()) for k in mlp})
    return {"loss": losses, "grad": grad_norm, "change": change}

