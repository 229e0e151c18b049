"""The cost arithmetic against hand counts."""

import json
from pathlib import Path

import pytest

from benchmark.reference import costs

REPO = Path(__file__).resolve().parents[2]
H100 = costs.peaks("NVIDIA H100 80GB HBM3")


def test_flash_counts_at_the_kernel_tables_shape():
    # (2, 16, 1024, 128) bf16 causal: one [B*H, S, D] tensor is 8 MiB,
    # 2 * 16 * 1024 * 1025 / 2 = 16,793,600 unmasked pairs
    t, lse, pairs = 8 * 2 ** 20, 2 * 16 * 1024 * 4, 16_793_600
    assert costs.flash_fwd(2, 16, 1024, 128, with_lse=False) == (
        4 * t, 4 * 128 * pairs)
    assert costs.flash_fwd(2, 16, 1024, 128) == (4 * t + lse,
                                                 4 * 128 * pairs)
    assert costs.flash_bwd_dq(2, 16, 1024, 128) == (6 * t + lse,
                                                    6 * 128 * pairs)
    assert costs.flash_bwd_dkv(2, 16, 1024, 128) == (7 * t + lse,
                                                     8 * 128 * pairs)
    # the kernel table's bounds: 33.6 MB = 10.0 us, 50.5 MB = 15.1 us,
    # 58.9 MB = 17.6 us, all three bytes-bound
    b1 = costs.least_time(*costs.flash_fwd(2, 16, 1024, 128, with_lse=False),
                          H100)
    b2 = costs.least_time(*costs.flash_bwd_dq(2, 16, 1024, 128), H100)
    b3 = costs.least_time(*costs.flash_bwd_dkv(2, 16, 1024, 128), H100)
    assert (round(b1 * 1e6, 1), round(b2 * 1e6, 1), round(b3 * 1e6, 1)) == (
        10.0, 15.1, 17.6)


def test_flash_fwd_is_flop_bound_at_the_lm_cells_shape():
    nbytes, flops = costs.flash_fwd(8, 12, 2048, 128)
    assert flops / H100["bf16"] > nbytes / H100["hbm_bytes_s"]
    assert costs.least_time(nbytes, flops, H100) == pytest.approx(
        1.0313e11 / 989e12, rel=1e-3)


def test_lm_flops_by_hand():
    cfg = json.loads((REPO / "benchmark/configs/cerebras-gpt-590m.json")
                     .read_text())
    # 50,257 x 1,536 tied embedding + 18 x (wqkv, wo, w1, w2, two gains)
    # + the final gain
    n = 50257 * 1536 + 18 * (1536 * 4608 + 1536 * 1536 + 2 * 1536 * 6144
                             + 2 * 1536) + 1536
    assert costs.lm_params_nonpos(cfg) == n == 586_859_520
    attn = 18 * 12 * 1536 * 2048 * 2049 // 2
    assert costs.lm_step_flops(cfg, 1, 2048) == 6 * n * 2048 + attn
    per_token = costs.lm_step_flops(cfg, 8, 2048) / (8 * 2048)
    assert per_token == pytest.approx(3.86e9, rel=2e-3)


def test_dlrm_flops_by_hand():
    cfg = json.loads((REPO / "benchmark/configs/dlrm-criteo-kaggle.json")
                     .read_text())
    bottom = 2 * (13 * 512 + 512 * 256 + 256 * 64 + 64 * 16)
    top = 2 * (367 * 512 + 512 * 256 + 256 * 1)
    dots = 2 * 27 * 27 * 16
    want = (bottom + top + dots                  # forward
            + bottom + top                       # weights' gradients
            + bottom - 2 * 13 * 512 + top        # inputs' gradients
            + 2 * dots)                          # the dots' two gradients
    assert costs.dlrm_example_flops(cfg) == want == 2_902_880


def test_unknown_card_has_no_peaks():
    assert costs.peaks("cpu") is None
