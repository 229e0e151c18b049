"""Pipeline-parallel LM training over a (dp, pp) mesh with the
interleaved schedule (port of ``examples/pipelined_lm.py``).

The layer stack is split across the ``pp`` axis (each rank two
non-contiguous chunks), microbatches ride a ppermute ring
(``parallel/pipeline.py``) and autograd differentiates straight through
it; ``remat`` recomputes each layer in the backward. Each rank is one
process of a ``torch.distributed`` world that this script spawns. Rank 0
then folds the stages back to the plain [L, ...] layout and decodes.

Run: python -m multiverso_tpu_torch.examples.pipelined_lm
         [--device cpu] [--world 4] [--dp 2]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def rank_main(rank: int, world: int, device, dp: int, steps: int):
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.models import transformer as tfm
    from multiverso_tpu_torch.parallel.mesh import Mesh
    pp = world // dp
    mesh = Mesh({"dp": dp, "pp": pp}, device=device)
    mv.init(device=device, mesh=mesh)
    try:
        cfg = tfm.TransformerConfig(
            vocab_size=256, dim=64, num_heads=4, num_layers=2 * pp,
            max_seq=32, attn="local", batch_axis="dp",
            pp_chunks=2,   # interleaved: pp ranks x 2 chunks x 1 layer
            remat=True)    # recompute layers in backward
        params = tfm.init_params(cfg, seed=0)
        stacked = tfm.shard_params_pp(tfm.stack_pp_params(params, cfg, pp),
                                      mesh, cfg=cfg)
        # the interleaved schedule runs a fixed n_micro == pp
        step = tfm.make_pp_train_step(cfg, n_micro=pp, learning_rate=0.1,
                                      mesh=mesh)
        rng = np.random.default_rng(0)
        toks = rng.integers(0, cfg.vocab_size, (pp * dp, cfg.max_seq + 1))
        tok = tfm.shard_batch(toks[:, :-1].astype(np.int32), cfg, mesh)
        tgt = tfm.shard_batch(toks[:, 1:].astype(np.int32), cfg, mesh)
        losses = []
        for i in range(steps):
            stacked, loss = step(stacked, tok, tgt)
            losses.append(float(loss))
            if rank == 0 and i % 5 == 0:
                print(f"step {i:3d}  loss {losses[-1]:.4f}", flush=True)
        # interop: the plain [L, ...] layout for decoding
        plain = tfm.unstack_pp_params(tfm.pp_tree_to_numpy(stacked, cfg,
                                                           mesh), cfg)
    finally:
        mv.shutdown()
    if rank != 0:
        return losses, None
    dcfg = cfg._replace(batch_axis=None, pp_chunks=1)
    model = tfm.params_from_jax(plain, dcfg, device)
    out = tfm.generate(model, toks[:2, :4].astype(np.int32), dcfg, 8)
    return losses, tuple(out.shape)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    from multiverso_tpu_torch.parallel.mesh import spawn
    out = spawn(rank_main, args.world, args.device, (args.dp, args.steps))
    losses, shape = out[0]
    assert losses[-1] < losses[0], losses
    print(f"final loss {losses[-1]:.4f}")
    print("decoded shape:", shape)
    return 0


if __name__ == "__main__":
    sys.exit(main())
