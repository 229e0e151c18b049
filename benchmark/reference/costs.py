"""Operations and bytes that the work needs, counted from shapes, and the
peaks of the chips the benchmark knows.

The flash kernels' counts are those the port's kernel table was held to
since its first chip figures, generalised to any causal [B, H, S, D]:
each tensor is read or written once, and the FLOPs are over the unmasked
(query, key) pairs only, S (S + 1) / 2 of them a head.

* B1, forward: q, k, v read and o written (4 tensors), plus the f32
  logsumexp that a training forward writes; 4 D FLOPs a pair (QK^T and
  PV).
* B2, dQ: q, k, v, o, dO read and dQ written (6 tensors) and the
  logsumexp read; 6 D a pair (S again, dP, dQ).
* B3, dK and dV with its delta pre-pass: q, k, v, o, dO read and dK, dV
  written (7 tensors) and the logsumexp read; 8 D a pair (S, dP, dV, dK).

The model FLOPs of an LM step are 6 x the parameters outside the position
table x the tokens, plus the causal attention over the unmasked pairs:
4 D FLOPs a pair in the forward, 8 D in the backward, in every layer. No
recompute is counted. A DLRM step counts its matrix products: the MLPs
forward, their weights' gradients, and their inputs' gradients except the
dense features', and the pairwise dots' product forward and its two
gradients.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

# NVIDIA's data sheet, H100 SXM, dense rates without sparsity, at 700 W
PEAKS = {
    "H100": {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12,
             "f32": 67e12, "hbm_bytes_s": 3.35e12},
}


def peaks(kind: str) -> Optional[Dict[str, float]]:
    """The peak table of the card named ``kind`` (torch's device name)."""
    for key, table in PEAKS.items():
        if key in kind:
            return table
    return None


def _pairs(b: int, h: int, s: int) -> int:
    return b * h * s * (s + 1) // 2


def flash_fwd(b: int, h: int, s: int, d: int, elem: int = 2,
              with_lse: bool = True) -> Tuple[int, int]:
    """(bytes, FLOPs) of one B1 call."""
    t = b * h * s * d * elem
    return 4 * t + (b * h * s * 4 if with_lse else 0), 4 * d * _pairs(b, h, s)


def flash_bwd_dq(b: int, h: int, s: int, d: int,
                 elem: int = 2) -> Tuple[int, int]:
    """(bytes, FLOPs) of one B2 call."""
    t = b * h * s * d * elem
    return 6 * t + b * h * s * 4, 6 * d * _pairs(b, h, s)


def flash_bwd_dkv(b: int, h: int, s: int, d: int,
                  elem: int = 2) -> Tuple[int, int]:
    """(bytes, FLOPs) of one B3 call, its delta pre-pass included."""
    t = b * h * s * d * elem
    return 7 * t + b * h * s * 4, 8 * d * _pairs(b, h, s)


def least_time(nbytes: int, flops: int, peak: Dict[str, float],
               dtype: str = "bf16") -> float:
    """Seconds: the larger of bytes over the memory rate and FLOPs over
    the dtype's rate."""
    return max(nbytes / peak["hbm_bytes_s"], flops / peak[dtype])


def lm_params_nonpos(cfg: Dict) -> int:
    d, L, v, f = (cfg["n_embd"], cfg["n_layer"], cfg["vocab_size"],
                  cfg["n_inner"])
    return v * d + L * (d * 3 * d + d * d + 2 * d * f + 2 * d) + d


def lm_step_flops(cfg: Dict, batch: int, seq: int) -> int:
    """Model FLOPs of one training step on [batch, seq] tokens."""
    attn = 12 * cfg["n_embd"] * batch * seq * (seq + 1) // 2
    return 6 * lm_params_nonpos(cfg) * batch * seq + cfg["n_layer"] * attn


def dlrm_example_flops(cfg: Dict) -> int:
    """Matrix-product FLOPs of one example's forward and backward."""
    bot = [int(x) for x in cfg["arch_mlp_bot"].split("-")]
    top = [int(x) for x in cfg["arch_mlp_top"].split("-")]
    f = len(cfg["table_rows"])
    n_inter = (f + 1) * f // 2
    bottom = list(zip(bot[:-1], bot[1:]))
    top_in = [bot[-1] + n_inter] + top
    tops = list(zip(top_in[:-1], top_in[1:]))
    mlp = sum(2 * i * o for i, o in bottom + tops)
    first = 2 * bottom[0][0] * bottom[0][1]
    dots = 2 * (f + 1) ** 2 * cfg["arch_sparse_feature_size"]
    # forward, weights' gradients, inputs' gradients but the dense input's
    return mlp + mlp + (mlp - first) + 3 * dots
