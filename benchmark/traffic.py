"""The benchmark's one generator: weights and inputs made from ``--seed``.

Everything here is plain ``torch`` and is made on the device it is asked
for, in a few large calls, from a ``torch.Generator`` seeded with the run's
seed and a fixed tag per stream, so the same seed gives the same numbers on
the same device. A workload file holds only parameters: the generator reads
them, and a new traffic mix is a new data file.

The references call the same functions, so the program and the reference
start from the same weights and read the same batches; neither takes
anything the other made.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

HERE = Path(__file__).resolve().parent

# one stream per use, so that adding a stream leaves the others unchanged
_STREAMS = {"lm_weights": 1, "lm_tokens": 2, "dlrm_table": 3,
            "dlrm_mlp": 4, "dlrm_ids": 5, "dlrm_dense": 6, "dlrm_labels": 7}


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A generator on ``device`` for one stream of one seed. The seed may
    be any whole number up to 2**63: it is folded with the stream's tag."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed((int(seed) * 131 + _STREAMS[stream]) % (2 ** 63 - 1))
    return g


def as_run(cfg: Dict) -> Dict:
    """The configuration as it is run: its file holds the source's values,
    and each departure of the program under ``assumed`` with the
    ``value`` it runs at."""
    out = dict(cfg)
    out.update({k: v["value"] for k, v in cfg.get("assumed", {}).items()
                if isinstance(v, dict) and "value" in v})
    return out


def ranks_by_weight(n: int, weights: torch.Tensor, gen: torch.Generator
                    ) -> torch.Tensor:
    """``n`` draws of a rank in [0, len(weights)) with P(r) proportional
    to ``weights[r]`` (float64), by inverse CDF."""
    cdf = torch.cumsum(weights, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(n, generator=gen, device=weights.device,
                   dtype=torch.float64)
    return torch.searchsorted(cdf, u).clamp_(max=len(weights) - 1)


def zipf_ranks(n: int, vocab: int, alpha: float, gen: torch.Generator,
               device) -> torch.Tensor:
    """``n`` draws of a rank in [0, vocab) with P(r) proportional to
    (r + 1) ** -alpha; alpha 0 is uniform."""
    r = torch.arange(1, vocab + 1, device=device, dtype=torch.float64)
    return ranks_by_weight(n, r.pow(-alpha), gen)


def word_counts(path: str, device) -> torch.Tensor:
    """A measured rank-frequency table: one count a line under a header,
    most frequent first (``benchmark/<path>``)."""
    lines = (HERE / path).read_text().split()[1:]
    return torch.tensor([float(x) for x in lines], dtype=torch.float64,
                        device=device)


# ---------------------------------------------------------------- LM ----

def lm_leaf_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    """The LM's leaves by dotted name, in the port's layout (per-layer
    weights stacked on a leading layer axis; y = x @ w)."""
    d, L, v = cfg["n_embd"], cfg["n_layer"], cfg["vocab_size"]
    f = cfg["n_inner"]
    return {"embed": (v, d), "pos": (cfg["n_positions"], d), "ln_f": (d,),
            "layers.wqkv": (L, d, 3 * d), "layers.wo": (L, d, d),
            "layers.ln1": (L, d), "layers.ln2": (L, d),
            "layers.w1": (L, d, f), "layers.w2": (L, f, d)}


def lm_weights_into(cfg: Dict, seed: int,
                    leaves: Dict[str, torch.Tensor]) -> None:
    """Fill the LM's leaves (by dotted name, on one device, in the dtype
    they are served in) with the initial weights, one normal draw per
    leaf: GPT-2's scales (0.02 for the embeddings, 1/sqrt(d) for the
    products, divided by sqrt(2 L) for the two that write the residual),
    ones for the norms' gains."""
    dev = next(iter(leaves.values())).device
    gen = generator(seed, "lm_weights", dev)
    d, L, f = cfg["n_embd"], cfg["n_layer"], cfg["n_inner"]
    s = d ** -0.5
    scales = {"embed": 0.02, "pos": 0.02, "layers.wqkv": s,
              "layers.wo": s / (2 * L) ** 0.5, "layers.w1": s,
              "layers.w2": f ** -0.5 / (2 * L) ** 0.5}
    for name in lm_leaf_shapes(cfg):
        if name in scales:
            leaves[name].normal_(0.0, scales[name], generator=gen)
        else:
            leaves[name].fill_(1.0)


def lm_weights(cfg: Dict, seed: int, device,
               dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The LM's initial weights as new tensors (see ``lm_weights_into``)."""
    out = {name: torch.empty(shape, dtype=dtype, device=device)
           for name, shape in lm_leaf_shapes(cfg).items()}
    lm_weights_into(cfg, seed, out)
    return out


def lm_batches(cfg: Dict, traffic: Dict, seed: int, device) -> torch.Tensor:
    """The pool of batches, [pool, batch, seq_len + 1] int64 token ids: one
    stream drawn from the measured word frequencies of ``unigram`` (the
    vocabulary's most frequent ranks, where it has fewer ids than the
    table has words), its ranks mapped to ids through a seeded
    permutation, packed into sequences. Batch i of the pool holds tokens
    [:, :-1] and their next tokens [:, 1:]."""
    gen = generator(seed, "lm_tokens", device)
    v = cfg["vocab_size"]
    p, b, s = traffic["pool"], traffic["batch"], traffic["seq_len"]
    perm = torch.randperm(v, generator=gen, device=device)
    counts = word_counts(traffic["unigram"], device)[:v]
    ranks = ranks_by_weight(p * b * (s + 1), counts, gen)
    return perm[ranks].reshape(p, b, s + 1)


# -------------------------------------------------------------- DLRM ----

def dlrm_mlp_shapes(cfg: Dict) -> Tuple[List[Tuple[int, int]],
                                        List[Tuple[int, int]]]:
    """(bottom, top) layer shapes [in, out]: the top MLP reads the bottom
    output and the (F + 1 choose 2) pairwise dots."""
    bot = [int(x) for x in cfg["arch_mlp_bot"].split("-")]
    top = [int(x) for x in cfg["arch_mlp_top"].split("-")]
    f = len(cfg["table_rows"])
    n_inter = (f + 1) * f // 2
    if bot[-1] != cfg["arch_sparse_feature_size"]:
        raise ValueError("the bottom MLP must end at the feature size")
    bottom = list(zip(bot[:-1], bot[1:]))
    top_in = [bot[-1] + n_inter] + top
    return bottom, list(zip(top_in[:-1], top_in[1:]))


def dlrm_mlp(cfg: Dict, seed: int, device) -> Dict[str, List[torch.Tensor]]:
    """The MLPs' weights as facebookresearch/dlrm draws them: normal with
    std sqrt(2 / (in + out)) for a weight [in, out], normal with std
    sqrt(1 / out) for a bias; float32."""
    gen = generator(seed, "dlrm_mlp", device)
    bottom, top = dlrm_mlp_shapes(cfg)
    out: Dict[str, List[torch.Tensor]] = {}
    for part, shapes in (("bottom", bottom), ("top", top)):
        ws, bs = [], []
        for i, o in shapes:
            ws.append(torch.empty((i, o), device=device).normal_(
                0.0, (2.0 / (i + o)) ** 0.5, generator=gen))
            bs.append(torch.empty((o,), device=device).normal_(
                0.0, (1.0 / o) ** 0.5, generator=gen))
        out[f"{part}_w"], out[f"{part}_b"] = ws, bs
    return out


def dlrm_table_into(cfg: Dict, seed: int, out: torch.Tensor) -> None:
    """Fill ``out`` [sum(rows), D] (float32, on its device) with the
    embedding: each field's rows uniform in +-sqrt(1 / rows), as
    facebookresearch/dlrm draws them, one call a field."""
    gen = generator(seed, "dlrm_table", out.device)
    off = 0
    for n in cfg["table_rows"]:
        lim = (1.0 / n) ** 0.5
        out[off:off + n].uniform_(-lim, lim, generator=gen)
        off += n


def field_offsets(rows: Sequence[int]) -> List[int]:
    out, off = [], 0
    for n in rows:
        out.append(off)
        off += n
    return out


def dlrm_batches(cfg: Dict, traffic: Dict, seed: int, device
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pool of batches: (ids [pool, batch, F] int32, each field's own
    row index; dense [pool, batch, 13] float32; labels [pool, batch]
    float32). Ids are Zipf(``zipf_alpha``) within each field through a
    seeded permutation of its rows; alpha 0 is uniform. Labels are
    planted as the DLRM model's ``synthetic_ctr`` plants them: Bernoulli
    of the sigmoid of a linear term of the dense features plus an
    affinity of the (field 0, field 1) pair, so only the embeddings and
    the interaction can learn them."""
    p, b = traffic["pool"], traffic["batch"]
    n = p * b
    rows = cfg["table_rows"]
    gen = generator(seed, "dlrm_ids", device)
    cols = []
    for v in rows:
        perm = torch.randperm(v, generator=gen, device=device)
        cols.append(perm[zipf_ranks(n, v, traffic["zipf_alpha"], gen,
                                    device)].to(torch.int32))
    ids = torch.stack(cols, 1)
    gen = generator(seed, "dlrm_dense", device)
    dense = torch.randn((n, cfg["num_dense"]), generator=gen, device=device)
    gen = generator(seed, "dlrm_labels", device)
    w = torch.randn((cfg["num_dense"],), generator=gen, device=device)
    affinity = torch.randn((rows[0], rows[1]), generator=gen,
                           device=device) * 1.5
    logit = dense @ w + affinity[ids[:, 0].long(), ids[:, 1].long()]
    u = torch.rand((n,), generator=gen, device=device)
    labels = (u < torch.sigmoid(logit)).float()
    return (ids.reshape(p, b, len(rows)), dense.reshape(p, b, -1),
            labels.reshape(p, b))
