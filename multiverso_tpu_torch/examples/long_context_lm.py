"""Long-context LM training with ring attention over a (dp, sp) mesh
(port of ``examples/long_context_lm.py``).

A decoder-only LM whose sequence axis is context-parallel: each rank holds
S/sp tokens of each sequence and the K/V blocks rotate around the ``sp``
ring (``parallel/ring.py``), so per-rank attention memory is
O((S/sp)^2); the batch rides ``dp``. Each rank is one process of a
``torch.distributed`` world that this script spawns.

Run: python -m multiverso_tpu_torch.examples.long_context_lm
         [--device cpu] [--world 4] [--dp 2]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

SEQ, BATCH, STEPS = 256, 4, 40


def synthetic_text(n, seed=0):
    """A noisy periodic token stream: learnable but not trivial (the JAX
    example's draws)."""
    rng = np.random.default_rng(seed)
    base = np.tile(np.arange(16, dtype=np.int32), n // 16 + 1)[:n]
    noise = rng.integers(0, 16, n).astype(np.int32)
    keep = rng.random(n) < 0.9
    return np.where(keep, base, noise)


def rank_main(rank: int, world: int, device, dp: int, steps: int) -> list:
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.models import transformer as tf
    from multiverso_tpu_torch.parallel.mesh import Mesh
    mesh = Mesh({"dp": dp, "sp": world // dp}, device=device)
    mv.init(device=device, mesh=mesh)
    try:
        cfg = tf.TransformerConfig(vocab_size=16, dim=64, num_heads=4,
                                   num_layers=2, max_seq=SEQ, attn="ring",
                                   seq_axis="sp", batch_axis="dp")
        model = tf.params_from_jax(tf.init_params(cfg, seed=0), cfg,
                                   mesh=mesh)
        stream = synthetic_text(BATCH * (SEQ + 1))
        chunks = stream[: BATCH * (SEQ + 1)].reshape(BATCH, SEQ + 1)
        tokens = tf.shard_batch(chunks[:, :-1], cfg, mesh)
        targets = tf.shard_batch(chunks[:, 1:], cfg, mesh)
        step = tf.make_train_step(cfg, learning_rate=0.3)
        losses = []
        for i in range(steps):
            losses.append(float(step(model, tokens, targets)))
            if rank == 0 and (i % 10 == 0 or i == steps - 1):
                print(f"step {i:3d}  loss {losses[-1]:.4f}", flush=True)
    finally:
        mv.shutdown()
    return losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    from multiverso_tpu_torch.parallel.mesh import spawn
    finals = [r[-1] for r in spawn(rank_main, args.world, args.device,
                                   (args.dp, args.steps))]
    assert max(finals) - min(finals) < 1e-4, finals   # one global loss
    assert finals[0] < 1.0, "LM failed to learn the periodic stream"
    print(f"long-context LM ok: seq={SEQ} over {args.world // args.dp} "
          f"sequence shards x {args.dp} data shards, final loss "
          f"{finals[0]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
