"""Readings that the limits of ``correct`` are set from, at a cell's own
size: the control (the reference in the program's place, computed in the
precision below the configuration's) and the planted fault of a step that
leaves half of its batch out, each held against the float32 reference by
``check.numbers``. The benchmark's runs do not run this.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3

prints one JSON line a seed and kind. The control of a bfloat16
configuration is fp8, of a float32 one TF32 (``reference/lowp.py``).
The kind ``reversed`` (DLRM cells) is a second float32 reference that
sums each batch's examples in reverse order: what rounding alone moves.
The kind ``grad_direct`` (LM cells) holds the norms of the program's own
first gradient, as autograd returns it before SGD rounds it into the
weights, against the reference's float32 gradient, leaf by leaf; the kind
``witness`` does the same with the program's token lookup read through
``F.embedding``, whose backward sums a row's duplicates in float32. The
kind ``program`` is the program's own readings, from the cell's set-up
(its first steps through the window's call) without a window: what a run
compares. The kinds ``emb_sign``, ``emb_rho`` and ``emb_offset`` (DLRM
cells) plant a fault in the embedding's update alone, in the reference
put in the program's place (``reference/dlrm.py``).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

from benchmark import check, trace, traffic
from benchmark.run import HERE, load_json, load_module

CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


def control_mode(cfg) -> str:
    return CONTROL[cfg.get("torch_dtype") or cfg["dtype"]]


def lm_direct_gaps(cfg, cell, seed, device, witness=False):
    """Each leaf's gap between the norms of the program's first gradient
    (``transformer.loss_and_grads`` on the first batch) and the float32
    reference's, over the larger of the reference's and the median's.
    ``witness`` reads the token rows through ``F.embedding`` instead of
    the program's ``embed[tokens]``, for the one call."""
    import statistics
    from multiverso_tpu_torch.models import transformer as tfm
    from benchmark.reference import lm as reference_lm
    from benchmark.reference import lowp
    dtype = getattr(torch, cfg["torch_dtype"])
    tcfg = tfm.TransformerConfig(
        vocab_size=cfg["vocab_size"], dim=cfg["n_embd"],
        num_heads=cfg["n_head"], num_layers=cfg["n_layer"],
        max_seq=cfg["n_positions"],
        mlp_ratio=cfg["n_inner"] // cfg["n_embd"], dtype=dtype,
        attn=cfg["attn"])
    model = tfm.Transformer(tcfg, device)
    with torch.no_grad():
        traffic.lm_weights_into(cfg, seed, dict(model.named_parameters()))
    batch = traffic.lm_batches(cfg, cell["traffic"], seed, device)[0]
    lookup = tfm._embed_lookup
    if witness:
        tfm._embed_lookup = lambda params, embed, tokens: \
            torch.nn.functional.embedding(tokens.long(), embed)
    try:
        loss_p, grads = tfm.loss_and_grads(model, batch[:, :-1],
                                           batch[:, 1:])
    finally:
        tfm._embed_lookup = lookup
    prog = {n: float(g.float().norm())
            for (n, _), g in zip(model.named_parameters(), grads)}
    g_embed = grads[[n for n, _ in model.named_parameters()].index(
        "embed")].float()
    del model, grads
    w0 = {k: v.float() for k, v in traffic.lm_weights(cfg, seed, device,
                                                      dtype).items()}
    with lowp.strict_float32():
        loss_r, g = reference_lm.loss_and_grads(w0, batch, cfg)
    ref = {k: float(v.norm()) for k, v in g.items()}
    med = statistics.median(ref.values())
    # where the embedding's gap lies: the 64 rows the batch reads most
    # (as inputs or as targets) against the rest
    counts = torch.bincount(batch.reshape(-1), minlength=cfg["vocab_size"])
    top = torch.topk(counts, 64).indices
    rest = torch.ones_like(counts, dtype=torch.bool)
    rest[top] = False
    r_e = g["embed"]
    split = {
        "top64": abs(float(g_embed[top].norm()) / float(r_e[top].norm()) - 1),
        "rest": abs(float(g_embed[rest].norm()) / float(r_e[rest].norm())
                    - 1),
        "cosine": float(torch.nn.functional.cosine_similarity(
            g_embed.reshape(1, -1), r_e.reshape(1, -1))),
        "top64_share": float(r_e[top].norm() / r_e.norm())}
    return {"loss": abs(float(loss_p) - loss_r) / loss_r,
            "grad": {k: abs(prog[k] - r) / max(r, med)
                     for k, r in ref.items()},
            "embed": split}


def program_readings(drv, cfg, cell, seed, device):
    """The readings a run of the cell compares: its set-up, no window."""
    d = drv.Driver(cfg, cell, seed, device, trace.Spans(False),
                   trace.Marks(device))
    d.setup()
    got = d.readings
    d.close()
    del d
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return got


def readings(workload: str, seeds, device, root: Path = HERE,
             kinds=("control", "half_batch")):
    cell = load_json(root / "workloads" / f"{workload}.json")
    cfg = traffic.as_run(load_json(root / "configs"
                                   / f"{cell['config']}.json"))
    drv = load_module(root / "drivers" / f"{cfg['driver']}.py",
                      f"benchmark_driver_{cfg['driver']}")
    for seed in seeds:
        t0 = time.perf_counter()
        ref = drv.reference(cfg, cell, seed, device)
        t_ref = time.perf_counter() - t0
        for kind in kinds:
            t0 = time.perf_counter()
            if kind in ("grad_direct", "witness"):
                yield {"workload": workload, "seed": seed, "kind": kind,
                       "direct": lm_direct_gaps(cfg, cell, seed, device,
                                                kind == "witness")}
                continue
            if kind == "program":
                got = program_readings(drv, cfg, cell, seed, device)
            elif kind == "control":
                got = drv.reference(cfg, cell, seed, device,
                                    mode=control_mode(cfg))
            elif kind == "reversed":
                got = drv.reference(cfg, cell, seed, device, reverse=True)
            elif kind.startswith("emb_"):
                got = drv.reference(cfg, cell, seed, device, fault=kind)
            else:
                got = drv.reference(cfg, cell, seed, device, half_batch=True)
            yield {"workload": workload, "seed": seed, "kind": kind,
                   "numbers": check.numbers(got, ref),
                   "leaf_gaps": check.leaf_gaps(got, ref),
                   "reference_s": t_ref,
                   "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kinds", default="control,half_batch")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    for rec in readings(args.workload, seeds, torch.device("cuda:0"),
                        kinds=tuple(args.kinds.split(","))):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
