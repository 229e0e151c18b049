"""How far the card's f32 WordEmbedding epoch lies from the CPU's, beside
the rounding error of f32 itself on the same epoch.

For each of ``--starts`` fresh runs: a WordEmbedding on the real text at
the width ``chip_smoke.py``'s ``we`` phase uses trains one warm and
``--epochs`` epochs on the card (``index_add_``'s atomics make every start
a little different), then the shared-pool epoch of the first ``--batches``
batches runs from those tables twice on the card in f32, once on the CPU
in f32 and once on the CPU in f64. One JSON line per start gives the max
|diff| of the tables, over their max |x|: card against the CPU
(``card_cpu``), the card against itself (``card_card``), the CPU's f32
against f64 (``cpu_f64``) and the card's f32 against f64 (``card_f64``);
the same three differences as Frobenius norms (``norm_*``). The last line
sums them up, with the card-against-CPU difference over the larger of the
CPU's f32 error and the card's spread, in either measure. Run it on the card:

    python -m multiverso_tpu_torch.examples.we_f32_error --starts 30
"""

import argparse
import json
import sys

import numpy as np
import torch

# chip_smoke.py's WE_CFG: bench.py's real-text width
WE_CFG = dict(size=128, min_count=5, batch_size=16384, negative=5, window=5,
              shared_negatives=256)


def _max_rel(a, b, scale: float) -> float:
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(a, b)) / scale


def _norm(a, b) -> float:
    """The Frobenius norm of the difference of two lists of tables."""
    return float(sum(float((x.double() - y.double()).norm()) ** 2
                     for x, y in zip(a, b)) ** 0.5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--starts", type=int, default=30)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batches", type=int, default=8)
    args = ap.parse_args(argv)

    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.apps.word_embedding import (WEConfig,
                                                          WordEmbedding)
    from multiverso_tpu_torch.data.dictionary import Dictionary
    from multiverso_tpu_torch.io import realtext
    from multiverso_tpu_torch.models import word2vec as w2v

    torch.backends.cuda.matmul.allow_tf32 = False
    mv.init()
    dev, cpu = mv.device(), torch.device("cpu")
    tokens = realtext.load_tokens()
    cfg = WEConfig(**WE_CFG)
    d = Dictionary.build(tokens, cfg.min_count)
    ids = WordEmbedding(cfg, d).prepare_ids(tokens)
    w2v_cfg = w2v.W2VConfig(len(d), cfg.size, cfg.negative, cfg.window,
                            cfg.alpha, False, False, cfg.shared_negatives)
    n = args.batches
    rows = []
    for i in range(args.starts):
        we = WordEmbedding(cfg, d)
        for _ in range(1 + args.epochs):
            we.train_fused(ids, epochs=1)
        cbd, xbd, _ = we._device_pairs(ids)
        start = (we.table_in.raw(), we.table_out.raw(), we._lcg)
        fns = {dt: w2v.make_fused_shared_epoch(w2v_cfg, we.unigram,
                                               compute_dtype=dt)
               for dt in (torch.float32, torch.float64)}

        def epoch(where, dt=torch.float32):
            win, wout, _, _ = fns[dt](
                *(t.to(where, dt, copy=True) for t in start[:2]),
                cbd[:n].to(where), xbd[:n].to(where),
                start[2].to(where, copy=True))
            return [win.cpu(), wout.cpu()]

        g1, g2, c, e = (epoch(dev), epoch(dev), epoch(cpu),
                        epoch(cpu, torch.float64))
        scale = max(float(t.abs().max()) for t in c)
        row = {"start": i, "max_x": scale,
               "card_cpu": max(_max_rel(g1, c, scale),
                               _max_rel(g2, c, scale)),
               "card_card": _max_rel(g1, g2, scale),
               "cpu_f64": _max_rel(c, e, scale),
               "card_f64": max(_max_rel(g1, e, scale),
                               _max_rel(g2, e, scale)),
               "norm_card_cpu": max(_norm(g1, c), _norm(g2, c)),
               "norm_card_card": _norm(g1, g2), "norm_cpu_f64": _norm(c, e)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del we
    # chip_smoke.py's bound: a factor of the larger noise of the two
    ratio = [r["card_cpu"] / max(r["cpu_f64"], r["card_card"]) for r in rows]
    nratio = [r["norm_card_cpu"] / max(r["norm_cpu_f64"], r["norm_card_card"])
              for r in rows]
    print(json.dumps({
        "card": torch.cuda.get_device_name(dev), "starts": len(rows),
        "batches": n, **{f"max_{k}": max(r[k] for r in rows)
                         for k in ("card_cpu", "card_card", "cpu_f64",
                                   "card_f64")},
        "max_card_cpu_over_noise": max(ratio),
        "p50_card_cpu_over_noise": float(np.median(ratio)),
        "max_norm_card_cpu_over_noise": max(nratio),
        "p50_norm_card_cpu_over_noise": float(np.median(nratio)),
        "starts_over_2e-5": sum(r["card_cpu"] > 2e-5 for r in rows)}))
    mv.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
