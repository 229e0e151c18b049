"""DLRM-style CTR training on the parameter tables, data-parallel over a
mesh (port of ``examples/dlrm_ctr.py``).

Every categorical field lives in one MatrixTable and the dot-interaction
MLP in one ArrayTable (``models/dlrm.py``), and one fused step does
gather -> grad -> duplicate-accumulating scatter -> server-side AdaGrad.
Each rank is one process of a ``torch.distributed`` world that this
script spawns: the tables' rows are sharded over the ``dp`` axis, the
Zoo mesh's table axis (each rank holds a block on its own device), and
each rank takes its shard of every batch. In
``models.dlrm.make_train_step(mesh=, axis=)`` each rank reads its
batch's unique rows from their owners and pushes their gradients back to
the owners (an all_to_all each way), so no rank holds the whole
embedding table; the small MLP is gathered and its gradient averaged in
one all-reduce. Each owner applies the updater to its block with the
global batch's averaged delta.

Run: python -m multiverso_tpu_torch.examples.dlrm_ctr
         [--device cpu] [--world 2] [--epochs N] [--samples N]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def rank_main(rank: int, world: int, device, epochs: int, samples: int):
    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.models import dlrm
    from multiverso_tpu_torch.parallel.mesh import Mesh
    from multiverso_tpu_torch.updaters import AddOption
    mesh = Mesh({"dp": world}, device=device)
    mv.init(device=device, mesh=mesh)
    try:
        cfg = dlrm.DLRMConfig(vocab_sizes=(2000, 2000, 500, 100),
                              embed_dim=16, dense_dim=8, bottom_mlp=(32, 16),
                              top_mlp=(32, 1))
        emb = mv.MatrixTable(dlrm.total_rows(cfg), cfg.embed_dim,
                             updater="adagrad", seed=0, init_scale=0.05,
                             name="ctr_embeddings")
        flat, meta = dlrm.flatten_mlp(dlrm.init_mlp_params(cfg, 0))
        mlp = mv.ArrayTable(flat.size, updater="adagrad", init=flat,
                            name="ctr_mlp")
        cat, dense, labels = dlrm.synthetic_ctr(cfg, samples, seed=1)
        opt = AddOption(learning_rate=0.2, rho=0.1)
        step = dlrm.make_train_step(cfg, emb, mlp, meta, opt, opt,
                                    mesh=mesh, axis="dp")
        es, ms = emb.state, mlp.state
        bs = 512
        per = bs // world
        epoch_bce = []
        for epoch in range(epochs):
            tot, nb = 0.0, 0
            for i in range(0, len(labels) - bs + 1, bs):
                lo = i + rank * per
                es, ms, loss = step(es, ms, cat[lo:lo + per],
                                    dense[lo:lo + per], labels[lo:lo + per])
                tot, nb = tot + float(loss), nb + 1
            epoch_bce.append(tot / nb)
            if rank == 0:
                print(f"epoch {epoch}  bce {epoch_bce[-1]:.4f}", flush=True)
        emb.adopt(es)
        mlp.adopt(ms)
        # evaluate with pulled tables (the PS read path)
        dev = mv.device()
        params = dlrm.unflatten_mlp(torch.as_tensor(
            mlp.get()[:flat.size], device=dev), meta)
        ids = (cat + dlrm.field_offsets(cfg)[None, :]).reshape(-1)
        rows = torch.as_tensor(emb.get_rows(ids), device=dev).reshape(
            len(labels), len(cfg.vocab_sizes), cfg.embed_dim)
        with torch.no_grad():
            logits = dlrm.forward(params, rows, torch.as_tensor(
                dense, device=dev), cfg)
        acc = float(np.mean((logits.cpu().numpy() > 0) == (labels > 0.5)))
        digest = float(np.abs(emb.get()).sum())
    finally:
        mv.shutdown()
    return epoch_bce, acc, float(max(labels.mean(), 1 - labels.mean())), \
        digest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--samples", type=int, default=16384)
    args = ap.parse_args(argv)
    from multiverso_tpu_torch.parallel.mesh import spawn
    out = spawn(rank_main, args.world, args.device,
                (args.epochs, args.samples))
    bce, acc, base, digest = out[0]
    assert all(abs(o[3] - digest) <= 1e-3 * digest for o in out), \
        "the ranks' tables diverged"
    print(f"train accuracy {acc:.4f}  (base rate {base:.4f}); bce by epoch "
          f"{[round(v, 4) for v in bce]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
