#!/usr/bin/env python3
"""Drive multiverso_tpu_torch's main path on one NVIDIA card and check it.

Phases, every one on every run, in this order:

1. build    compile every CUDA kernel from ``multiverso_tpu_torch/csrc``
            into ``build/torch_kernels/`` (one nvcc per source, in
            parallel), print ptxas's registers and spills, and check with
            ``cuobjdump -sass`` that the bf16 B1 (forward), B2 (dQ) and B3
            (dK/dV) kernels hold wgmma (HGMMA) and TMA-load (UTMALDG)
            instructions, and in ptxas's report that they spill nothing
2. kernel   each kernel (B1 forward, B2 dQ, B3 dK/dV) against its plain
            PyTorch version on the card, at the main paths' shape and at
            edge shapes, plus CUDA-event times: the kernel and its library
            call in turns (median of 6 runs each), the kernel with a cold
            L2, and the plain version
3. ps       init() on the card, the 472M LM's parameters in one ArrayTable
            (SharedPytree), Get, one sync (Add of a delta, then Get) checked
            against numpy, and each updater timed on a 16M-element table
4. request  the full-width LM built from the table's Get scores request
            batches [2, 1024] with attn="flash" under inference_mode (a
            main path: launch counts are zeroed just before and read just
            after), checked against attn="local" on the same weights
5. train    the full-width LM built from the table's Get trains through
            the PS (``train_ps``: SGD steps on one batch, a delta-sync
            every few steps; the other main path, counted the same way),
            each sync checked against numpy bit for bit, the gradients of
            attn="flash" against attn="local", and one step profiled

It prints the card's name and power limit, one ``{"kernels": [...]}`` JSON
line, and as its last line ``{"ok": true, "device": {...}}``. Any failed
check raises and the script exits non-zero; it also exits non-zero when
no CUDA device is present.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and bf16
# tensor-core FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# tolerances of the kernel against its plain version (max abs error). bf16
# is ~2x the largest error this script measured on an H100 (3.9e-3, one
# bf16 ulp at |out| in [0.5, 1)); the kernel phase also checks that a
# plain version which skips p's rounding to bf16 before p@v lands outside it
ATOL_OUT = {"float32": 2e-5, "bfloat16": 8e-3}
ATOL_LSE = 1e-4   # f32 sums over up to 1024 keys in another order
# B2/B3 (dq, dk, dv) against the plain backward, max abs error. f32: the
# kernels sum delta and the products over up to 1024 keys or queries in
# another order (largest error measured on an H100: 1.1e-6, so ~4x).
# bf16: ~2x the largest error of the FMA kernels (1.95e-3, one bf16 ulp at
# |dk| in [0.25, 0.5)); the wgmma dK/dV kernel reaches 3.9e-3 (one ulp in
# [0.5, 1)). dk and dv reach |x| > 5, where one ulp is 3.1e-2: an f32 sum
# grouped otherwise than the plain version's moves them by an ulp, so the
# kernels and flash_backward_plain sum them per 64-row q tile alike. The
# kernel phase also checks that a plain backward which skips ds's and p's
# rounding to bf16 lands outside the limit in dq, dk and dv
ATOL_BWD = {"float32": 4e-6, "bfloat16": 4e-3}
# attn="flash" vs attn="local" on the bf16 model: p is rounded to bf16 at
# another point (running vs final max) and the error passes 8 layers;
# 0.25 is 8 bf16 ulps at the logits' magnitude (|logits| in [4, 8))
ATOL_LOGITS = 0.25
ATOL_LOSS = 1e-2
# one step's gradients, attn="flash" vs attn="local" on the bf16 model:
# ||g_flash - g_local|| / ||g_local|| over each parameter leaf. p is rounded
# to bf16 at other points (against the lse vs the softmax output) and the
# difference passes 8 layers; ~2.5x the largest measured (7.7e-3, embed)
RTOL_GRAD = 2e-2

# the "472M" LM of bench.py (vocab 32768, dim 2048, 16 heads, seq 1024)
LM = dict(vocab_size=32768, dim=2048, num_heads=16, max_seq=1024)
LAYERS = 8
BATCH = 2
BATCHES = 4        # request batches scored on the main path
TRAIN_STEPS = 6    # SGD steps on the training path, as bench.py's step
SYNC_EVERY = 3     # a delta-sync through the PS after every 3rd step
LR = 1e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (warm
    L2: the inputs stay in the 50 MB cache)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(kernel, library, rounds: int = 3) -> tuple:
    """(kernel ms, library ms): the medians of warm ``cuda_ms`` runs taken
    in turns, kernel, library, library, kernel, over ``rounds`` rounds, so
    a drift of the card's clocks falls on both alike."""
    ks, ls = [], []
    for _ in range(rounds):
        ks.append(cuda_ms(kernel))
        ls.append(cuda_ms(library))
        ls.append(cuda_ms(library))
        ks.append(cuda_ms(kernel))
    return float(np.median(ks)), float(np.median(ls))


def cold_ms(fn, iters: int = 10) -> float:
    """Median device time of one call of ``fn`` with a cold L2: a 64 MB
    write before each launch evicts the 50 MB cache, and each launch is
    timed by its own pair of events."""
    import torch
    flush = torch.empty(16 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    times = []
    for _ in range(iters):
        flush.fill_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# the kernels that must run on the tensor cores and be fed by TMA, by the
# name of their (mangled) function in the SASS
TENSOR_CORE_KERNELS = ("flash_fwd_wgmma", "flash_bwd_dq_wgmma",
                       "flash_bwd_dkv_wgmma")


def sass_counts(lib) -> dict:
    """{function: (HGMMA, UTMALDG)}: the wgmma and TMA-load instructions
    of each kernel in a built library, from ``cuobjdump -sass``."""
    import os
    from multiverso_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = [0, 0]
        elif fn is not None:
            counts[fn][0] += "HGMMA" in line
            counts[fn][1] += "UTMALDG" in line
    return {f: tuple(c) for f, c in counts.items()}


def spills(text: str) -> dict:
    """{function: spill store + load bytes} from ptxas's ``-v`` report."""
    out, fn = {}, None
    for line in text.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
        elif fn is not None and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            out[fn] = sum(nums[1:3])   # stack frame, spill stores, loads
            fn = None
    return out


def phase_build() -> None:
    """Build every kernel, print ptxas's registers and spills, and check in
    the SASS that the bf16 B1, B2 and B3 kernels use wgmma and TMA, and in
    ptxas's report that they do not spill."""
    from multiverso_tpu_torch.ops import _build
    t0 = time.perf_counter()
    results = _build.build_all()
    for name, (seconds, text) in results.items():
        log(f"build {name}: {seconds:.1f} s")
        for line in text.splitlines():
            if any(t in line for t in ("entry function", "registers",
                                         "spill")):
                log(f"  ptxas: {line.strip()}")
        for fn, nbytes in spills(text).items():
            if nbytes and any(k in fn for k in TENSOR_CORE_KERNELS):
                raise AssertionError(f"{fn} spills {nbytes} bytes")
    log(f"build total: {time.perf_counter() - t0:.1f} s")
    found = {k: 0 for k in TENSOR_CORE_KERNELS}
    for name in _build.KERNELS:
        for fn, (hgmma, utmaldg) in sass_counts(
                _build.library_path(name)).items():
            log(f"  sass {name}: {fn}: HGMMA {hgmma}, UTMALDG {utmaldg}")
            for k in TENSOR_CORE_KERNELS:
                if k in fn:
                    if not (hgmma and utmaldg):
                        raise AssertionError(f"{fn} has no HGMMA or no "
                                             f"UTMALDG instruction")
                    found[k] += 1
    if not all(found.values()):
        raise AssertionError(f"tensor-core kernels missing from the SASS: "
                             f"{found}")


SLICE_SHAPE = (BATCH, LM["num_heads"], LM["max_seq"],
               LM["dim"] // LM["num_heads"])
# the edge shapes each kernel is held at: S = 40 and S = 200 are not
# multiples of the kernels' tiles (64 rows; the bf16 B1 and B2 take 128 q
# rows, and 128 (B1) or 64 (B2) k rows; the bf16 B3 128 k rows and 64 q
# rows), (2,3,200,128) has several heads, so a tile read past the end of
# one head's S would take the next head's rows; (1,2,96,32) has several
# tiles at head dim 32, (2,4,1024,64) is head dim 64 at full S;
# (1,2,320,128) leaves B3 a last k tile of 64 rows (one consumer
# warpgroup's rows all past S) while 5 q tiles are live
EDGE_SHAPES = (((1, 4, 64, 64), 128), ((1, 4, 40, 64), 128),
               ((2, 3, 200, 128), 200), ((1, 2, 96, 32), 32),
               ((2, 4, 1024, 64), 128), ((1, 2, 320, 128), 64))


def phase_kernel(dev) -> list:
    """B1, B2 and B3 against their plain versions; returns their records,
    whose ``launches`` the request and train phases fill in."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype, n):
        return [torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32).to(dtype) for _ in range(n)]

    return [kernel_fwd(randn)] + kernel_bwd(randn)


def bound(nbytes: int, flops: int) -> dict:
    """The least time for the work: bytes over the memory rate, operations
    over the bf16 tensor-core rate, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def kernel_fwd(randn) -> dict:
    """B1 against its plain version, and its times."""
    import torch
    import torch.nn.functional as F
    from multiverso_tpu_torch.ops import attention_kernels as ak

    def qkv(shape, dtype):
        return randn(shape, dtype, 3)

    slice_shape = SLICE_SHAPE
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for causal in (True, False):
            for lse in (False, True):
                cases.append((slice_shape, dtype, causal, lse, 128))
        for shape, blk in EDGE_SHAPES:
            for causal in (True, False):
                cases.append((shape, dtype, causal, True, blk))
    slice_err = None
    for shape, dtype, causal, with_lse, blk in cases:
        q, k, v = qkv(shape, dtype)
        if with_lse:
            out, lse = ak.flash_attention_with_lse(q, k, v, causal, blk, blk)
        else:
            out, lse = ak.flash_attention(q, k, v, causal, blk, blk), None
        ref, ref_lse = ak.flash_forward_plain(q, k, v, causal, with_lse)
        torch.cuda.synchronize()
        name = str(dtype).replace("torch.", "")
        err = max_err(out, ref)
        lse_err = max_err(lse, ref_lse) if with_lse else 0.0
        log(f"kernel flash_fwd {tuple(shape)} {name} causal={causal} "
            f"lse={with_lse}: max_abs_err out {err:.3e} lse {lse_err:.3e}")
        if not (err <= ATOL_OUT[name] and lse_err <= ATOL_LSE):
            raise AssertionError(f"flash_fwd disagrees with its plain version "
                                 f"at {shape} {name} causal={causal}")
        if not torch.isfinite(out).all():
            raise AssertionError("flash_fwd produced non-finite values")
        if (shape, dtype, causal, with_lse) == (slice_shape, torch.bfloat16,
                                                True, False):
            slice_err = err
            # p@v with p left in f32: the slip the bf16 tolerance must catch
            slip = max_err(ak.flash_forward_plain(
                q.float(), k.float(), v.float(), causal, False)[0].to(dtype),
                ref)
            log(f"kernel flash_fwd {tuple(shape)} bf16: p unrounded before "
                f"p@v would err {slip:.3e} (tolerance {ATOL_OUT[name]:.0e})")
            if slip <= ATOL_OUT[name]:
                raise AssertionError("the bf16 tolerance does not tell p's "
                                     "rounding before p@v")
    q, k, v = qkv((1, 2, 96, 32), torch.bfloat16)
    try:
        ak.flash_attention(q, k, v, True, 64, 64)
    except ValueError as e:
        log(f"kernel flash_fwd ValueError contract holds: {e}")
    else:
        raise AssertionError("S=96 with 64-row blocks must raise ValueError")

    q, k, v = qkv(slice_shape, torch.bfloat16)

    def kernel():
        return ak._flash_forward_cuda(q, k, v, True, False)

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    ms, library_ms = in_turns(kernel, library)
    ms_cold = cold_ms(kernel)
    plain_ms = cuda_ms(lambda: ak.flash_forward_plain(q, k, v, True, False),
                       iters=5)
    b, h, s, d = slice_shape
    nbytes = 4 * b * h * s * d * q.element_size()       # q, k, v read, o written
    flops = 4 * d * b * h * s * (s + 1) // 2             # unmasked pairs only
    lim = bound(nbytes, flops)
    log(f"kernel flash_fwd {slice_shape} bf16 causal: {ms:.4f} ms (median "
        f"in turns with sdpa; cold L2 {ms_cold:.4f} ms), plain "
        f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, kernel/sdpa "
        f"{ms / library_ms:.2f}, bound {lim['bound_ms']:.4f} ms ({nbytes} B, "
        f"{flops} FLOP)")
    return {
        "name": "flash_fwd", "route": "cuda",
        "source": "multiverso_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "multiverso_tpu/ops/attention_kernels.py:138",
        "design": {"bfloat16": "wgmma+tma", "float32": "fma"},
        "launches": None, "max_abs_err": slice_err, "ms": ms,
        "ms_cold_l2": ms_cold, "plain_ms": plain_ms, **lim,
        "library_ms": library_ms, "library_ratio": ms / library_ms,
    }


def kernel_bwd(randn) -> list:
    """B2 (dQ) and B3 (dK/dV) against the plain backward, on the forward
    kernel's out and lse, at the training path's shape and the edge
    shapes; then their times at the training path's shape."""
    import torch
    import torch.nn.functional as F
    from multiverso_tpu_torch.ops import attention_kernels as ak

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for causal in (True, False):
            cases.append((SLICE_SHAPE, dtype, causal, 128))
        for shape, blk in EDGE_SHAPES:
            for causal in (True, False):
                cases.append((shape, dtype, causal, blk))
    slice_err = {}
    for shape, dtype, causal, blk in cases:
        q, k, v, do = randn(shape, dtype, 4)
        out, lse = ak.flash_attention_with_lse(q, k, v, causal, blk, blk)
        dq = ak._flash_bwd_dq_cuda(q, k, v, out, lse, do, causal)
        dk, dv = ak._flash_bwd_dkv_cuda(q, k, v, out, lse, do, causal)
        ref = ak.flash_backward_plain(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        name = str(dtype).replace("torch.", "")
        errs = [max_err(a, b) for a, b in zip((dq, dk, dv), ref)]
        mags = [float(t.float().abs().max()) for t in ref]
        log(f"kernel flash_bwd {tuple(shape)} {name} causal={causal}: "
            f"max_abs_err dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}"
            f" (max |dq| {mags[0]:.3f} |dk| {mags[1]:.3f} |dv| "
            f"{mags[2]:.3f})")
        if not all(torch.isfinite(t).all() for t in (dq, dk, dv)):
            raise AssertionError("flash_bwd produced non-finite values")
        if max(errs) > ATOL_BWD[name]:
            raise AssertionError(f"flash_bwd disagrees with its plain version "
                                 f"at {shape} {name} causal={causal}")
        if (shape, dtype, causal) == (SLICE_SHAPE, torch.bfloat16, True):
            slice_err = {"flash_bwd_dq": errs[0],
                         "flash_bwd_dkv": max(errs[1:])}
            # the plain backward in f32, ds and p left unrounded before
            # ds@k, ds^T@q and p^T@dO: the roundings the kernels must keep
            slip = [max_err(a.to(dtype), b) for a, b in zip(
                ak.flash_backward_plain(q.float(), k.float(), v.float(),
                                        out.float(), lse, do.float(),
                                        causal), ref)]
            log(f"kernel flash_bwd {tuple(shape)} bf16: ds and p unrounded "
                f"would err dq {slip[0]:.3e}, dk {slip[1]:.3e}, dv "
                f"{slip[2]:.3e} (kernel {errs[0]:.3e}, {errs[1]:.3e}, "
                f"{errs[2]:.3e}; tolerance {ATOL_BWD[name]:.0e})")
            for what, err in zip(("ds's rounding before ds@k",
                                  "ds's rounding before ds^T@q",
                                  "p's rounding before p^T@dO"), slip):
                if err <= ATOL_BWD[name]:
                    raise AssertionError(f"the bf16 tolerance does not tell "
                                         f"{what}")

    q, k, v, do = randn(SLICE_SHAPE, torch.bfloat16, 4)
    out, lse = ak.flash_attention_with_lse(q, k, v, True)
    plain_ms = cuda_ms(lambda: ak.flash_backward_plain(q, k, v, out, lse, do,
                                                       True), iters=5)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)

    def library():
        return torch.autograd.grad(o, (qr, kr, vr), do, retain_graph=True)

    b, h, s, d = SLICE_SHAPE
    t = b * h * s * d * q.element_size()    # one [B*H, S, D] tensor
    lse_b = b * h * s * 4
    pairs = b * h * s * (s + 1) // 2         # unmasked pairs only
    recs = []
    for name, kernel, nbytes, flops, line, design in (
            ("flash_bwd_dq", lambda: ak._flash_bwd_dq_cuda(
                q, k, v, out, lse, do, True), 6 * t + lse_b, 6 * d * pairs,
             262, "wgmma+tma"),
            ("flash_bwd_dkv", lambda: ak._flash_bwd_dkv_cuda(
                q, k, v, out, lse, do, True), 7 * t + lse_b, 8 * d * pairs,
             280, "wgmma+tma")):
        ms, library_ms = in_turns(kernel, library)
        ms_cold = cold_ms(kernel)
        lim = bound(nbytes, flops)
        log(f"kernel {name} {SLICE_SHAPE} bf16 causal: {ms:.4f} ms (median "
            f"in turns with the sdpa backward; cold L2 {ms_cold:.4f} ms), "
            f"plain backward (dq, dk, dv) {plain_ms:.4f} ms, sdpa backward "
            f"(dq, dk, dv) {library_ms:.4f} ms, kernel/sdpa "
            f"{ms / library_ms:.2f}, bound {lim['bound_ms']:.4f} ms "
            f"({nbytes} B, {flops} FLOP, {lim['bound_by']})")
        recs.append({
            "name": name, "route": "cuda",
            "source": "multiverso_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"multiverso_tpu/ops/attention_kernels.py:{line}",
            "design": {"bfloat16": design, "float32": "fma"},
            "launches": None, "max_abs_err": slice_err[name], "ms": ms,
            "ms_cold_l2": ms_cold, "plain_ms": plain_ms, **lim,
            "library_ms": library_ms, "library_ratio": ms / library_ms,
        })
    return recs


def lm_config(layers: int):
    import torch
    from multiverso_tpu_torch.models import transformer as tfm
    return tfm.TransformerConfig(num_layers=layers, dtype=torch.bfloat16,
                                 attn="flash", **LM)


def phase_ps(dev, layers: int):
    """The LM's parameters through the PS; returns the SharedPytree."""
    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import updaters
    from multiverso_tpu_torch.models import transformer as tfm
    from multiverso_tpu_torch.sharedvar import _flatten

    cfg = lm_config(layers)
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, seed=0)
    log(f"ps init_params (numpy, seed 0): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    shared = mv.SharedPytree(params, name="lm_params")
    torch.cuda.synchronize()
    n = shared.table.size
    log(f"ps SharedPytree: {n} f32 parameters in one ArrayTable on {dev} "
        f"({n * 4 / 2**30:.2f} GiB), {time.perf_counter() - t0:.1f} s")
    if shared.table.raw().device != dev:
        raise AssertionError(f"the table is on {shared.table.raw().device}")

    t0 = time.perf_counter()
    got = shared.get()
    log(f"ps get: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    if not np.array_equal(got["layers"]["wqkv"], params["layers"]["wqkv"]):
        raise AssertionError("Get does not return the initial parameters")

    rng = np.random.default_rng(1)
    local = got
    local["ln_f"] = local["ln_f"] + np.float32(0.5)
    local["layers"]["wo"][0] += rng.normal(0, 1e-3, local["layers"]["wo"][0]
                                           .shape).astype(np.float32)
    last = shared._last
    expected = last + (_flatten(local) - last)
    t0 = time.perf_counter()
    merged = shared.sync(local)
    log(f"ps sync (Add of the delta, then Get): "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    if not np.array_equal(shared.table.get(), expected):
        raise AssertionError("sync: table disagrees with numpy")
    if not np.array_equal(merged["ln_f"], expected_leaf(expected, merged)):
        raise AssertionError("sync: merged tree disagrees with numpy")
    log("ps sync matches numpy bit for bit")
    del params, local, merged, expected, last

    size = 16 * 2**20
    opt = updaters.AddOption(momentum=0.9, learning_rate=0.1, rho=0.1)
    for name in ("default", "sgd", "momentum_sgd", "adagrad", "adam", "ftrl"):
        times = {}
        for where in ("cuda", "cpu"):
            d = dev if where == "cuda" else torch.device("cpu")
            upd = updaters.get_updater(name)
            data = torch.zeros(size + 1, device=d)
            state = upd.init_state((size + 1,), torch.float32, d)
            delta = torch.full((size + 1,), 1e-3, device=d)
            if where == "cuda":
                times[where] = cuda_ms(lambda: upd.apply(data, state, delta,
                                                         opt))
            else:
                t0 = time.perf_counter()
                for _ in range(3):
                    upd.apply(data, state, delta, opt)
                times[where] = (time.perf_counter() - t0) / 3 * 1e3
        table = mv.ArrayTable(size, updater=name, name=f"bench_{name}")
        delta = torch.full(table.padded_shape, 1e-3, device=dev)
        table.add(delta, opt)
        t0 = time.perf_counter()
        for _ in range(10):
            table.add(delta, opt)
        add_ms = (time.perf_counter() - t0) / 10 * 1e3
        log(f"ps updater {name} on {size} f32: apply {times['cuda']:.4f} ms "
            f"on the card, {times['cpu']:.2f} ms on the CPU; table.add "
            f"(device delta, blocking) {add_ms:.4f} ms")
        del table
    return shared


def expected_leaf(flat: np.ndarray, tree: dict) -> np.ndarray:
    """``ln_f`` out of a flat vector in sorted-key order (embed, layers,
    ln_f, pos)."""
    off = tree["embed"].size + sum(a.size for a in tree["layers"].values())
    return flat[off: off + tree["ln_f"].size]


def phase_request(dev, shared, layers: int, batches: int) -> int:
    """Score request batches with attn="flash" under inference_mode;
    returns flash_fwd launches."""
    import torch
    from multiverso_tpu_torch.models import transformer as tfm
    from multiverso_tpu_torch.ops import attention_kernels as ak

    cfg = lm_config(layers)
    t0 = time.perf_counter()
    model = tfm.params_from_jax(shared.get(), cfg, dev)
    torch.cuda.synchronize()
    log(f"request model from the table's Get: "
        f"{sum(p.numel() for p in model.parameters())} parameters, bf16, "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batches, BATCH, cfg.max_seq + 1))).to(dev)
    with torch.inference_mode():
        # warm-up request (cuBLAS handles, allocator) outside the counted run
        float(tfm._nll(tfm.forward(model, toks[0, :, :-1]), toks[0, :, 1:]))

        ak.reset_launch_counts()
        lat, losses, first_logits, events = [], [], None, []
        t_run = time.perf_counter()
        for i in range(batches):
            t0 = time.perf_counter()
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            logits = tfm.forward(model, toks[i, :, :-1])
            loss = tfm._nll(logits, toks[i, :, 1:])
            ev[1].record()
            losses.append(float(loss))   # host readback = end of the request
            lat.append((time.perf_counter() - t0) * 1e3)
            events.append(ev)
            if i == 0:
                first_logits = logits
        run_s = time.perf_counter() - t_run
        counts = ak.launch_counts()
        launches = counts["flash_fwd"]
        if counts != {"flash_fwd": layers * batches, "flash_bwd_dq": 0,
                      "flash_bwd_dkv": 0}:
            raise AssertionError(f"request launches {counts}, expected "
                                 f"{layers * batches} flash_fwd only")
        tokens = batches * BATCH * cfg.max_seq
        log(f"request scored {batches} batches [{BATCH}, {cfg.max_seq}]: "
            f"losses {[round(l, 5) for l in losses]}, latency ms "
            f"{[round(t, 3) for t in lat]}, p50 {float(np.median(lat)):.3f} "
            f"ms; device span ms (CUDA events) "
            f"{[round(a.elapsed_time(b), 3) for a, b in events]}; {tokens} "
            f"tokens in {run_s * 1e3:.3f} ms = {tokens / run_s:.0f} tokens/s;"
            f" flash_fwd launches {launches}")
        if not (torch.isfinite(first_logits).all()
                and np.isfinite(losses).all()):
            raise AssertionError("non-finite logits or loss")
        if first_logits.shape != (BATCH, cfg.max_seq, cfg.vocab_size):
            raise AssertionError(f"logits shape {tuple(first_logits.shape)}")

        ref_logits = tfm.forward(model, toks[0, :, :-1],
                                 cfg._replace(attn="local"))
        ref_loss = float(tfm._nll(ref_logits, toks[0, :, 1:]))
        d_logits = max_err(first_logits, ref_logits)
        d_loss = abs(losses[0] - ref_loss)
        log(f"request flash vs local: max |logits diff| {d_logits:.4e} "
            f"(logits max |x| {float(ref_logits.float().abs().max()):.3f}), "
            f"|loss diff| {d_loss:.4e} (local loss {ref_loss:.5f})")
        if not (d_logits <= ATOL_LOGITS and d_loss <= ATOL_LOSS):
            raise AssertionError("attn='flash' disagrees with attn='local'")
        tok, tgt = toks[0, :, :-1], toks[0, :, 1:]
        profile("request", lambda: float(tfm._nll(tfm.forward(model, tok),
                                                    tgt)))
    return launches


class CheckedSync:
    """A SharedPytree whose ``sync`` is timed and checked: after each sync
    the table (its Get, which ``sync`` keeps as ``_last``) must equal the
    numpy ``last + (current - last)`` bit for bit."""

    def __init__(self, shared):
        self.shared = shared
        self.ms = []

    def sync(self, params):
        import torch
        from multiverso_tpu_torch.sharedvar import _flatten
        last = self.shared._last
        expected = last + (_flatten(params) - last)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        merged = self.shared.sync(params)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(self.shared._last, expected):
            raise AssertionError("train sync: table disagrees with numpy")
        return merged


def phase_train(dev, shared, layers: int) -> dict:
    """Train the full-width LM through the PS with ``train_ps``; returns
    the launch counts of the counted run."""
    import torch
    from multiverso_tpu_torch.examples.transformer_ps import train_ps
    from multiverso_tpu_torch.models import transformer as tfm
    from multiverso_tpu_torch.ops import attention_kernels as ak

    cfg = lm_config(layers)
    t0 = time.perf_counter()
    model = tfm.params_from_jax(shared.get(), cfg, dev)
    torch.cuda.synchronize()
    log(f"train model from the table's Get: "
        f"{sum(p.numel() for p in model.parameters())} parameters, bf16, "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (BATCH, cfg.max_seq + 1))).to(dev)
    tok, tgt = toks[:, :-1], toks[:, 1:]

    sgd = tfm.make_train_step(cfg, LR)
    host_ms, spans = [], []

    def timed_step(model, tok, tgt):
        t0 = time.perf_counter()
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        loss = sgd(model, tok, tgt)
        ev[1].record()
        float(loss)   # host readback = end of the step
        host_ms.append((time.perf_counter() - t0) * 1e3)
        spans.append(ev)
        return loss

    # warm-up step (cuBLAS handles, allocator) outside the counted run
    float(sgd(model, tok, tgt))
    checked = CheckedSync(shared)
    ak.reset_launch_counts()
    t_run = time.perf_counter()
    losses = train_ps(model, checked, tok, tgt, TRAIN_STEPS, SYNC_EVERY, LR,
                      step_fn=timed_step)
    run_s = time.perf_counter() - t_run
    counts = ak.launch_counts()
    want = layers * TRAIN_STEPS
    if counts != {"flash_fwd": want, "flash_bwd_dq": want,
                  "flash_bwd_dkv": want}:
        raise AssertionError(f"train launches {counts}, expected {want} of "
                             f"each kernel")
    dev_ms = [a.elapsed_time(b) for a, b in spans]
    tokens = TRAIN_STEPS * BATCH * cfg.max_seq
    log(f"train {TRAIN_STEPS} SGD steps (lr {LR}) on one batch [{BATCH}, "
        f"{cfg.max_seq}], sync every {SYNC_EVERY}: losses "
        f"{[round(l, 5) for l in losses]}")
    log(f"train step ms (host, to the loss readback) "
        f"{[round(t, 3) for t in host_ms]}, p50 "
        f"{float(np.median(host_ms)):.3f}; device span ms (CUDA events) "
        f"{[round(t, 3) for t in dev_ms]}, p50 {float(np.median(dev_ms)):.3f}"
        f"; {tokens} tokens in {sum(host_ms):.3f} ms of steps = "
        f"{tokens / sum(host_ms) * 1e3:.0f} tokens/s, in {run_s * 1e3:.3f} "
        f"ms with the syncs = {tokens / run_s:.0f} tokens/s; sync ms "
        f"{[round(t, 3) for t in checked.ms]}; launches {counts}")
    log(f"train syncs match numpy bit for bit ({len(checked.ms)} syncs)")
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite train loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")

    # one step's gradients, attn="flash" against attn="local"
    params = list(model.parameters())
    grads = {}
    for attn in ("flash", "local"):
        loss = tfm.loss_fn(model, tok, tgt, cfg=cfg._replace(attn=attn))
        grads[attn] = torch.autograd.grad(loss, params)
    rel = {}
    for (name, _), gf, gl in zip(model.named_parameters(), grads["flash"],
                                 grads["local"]):
        rel[name] = float((gf.float() - gl.float()).norm()
                          / gl.float().norm())
    del grads
    log("train grads flash vs local, ||g_flash - g_local|| / ||g_local||: "
        + ", ".join(f"{n} {r:.3e}" for n, r in rel.items()))
    if not max(rel.values()) <= RTOL_GRAD:
        raise AssertionError("attn='flash' gradients disagree with "
                             "attn='local'")
    profile("train step", lambda: float(sgd(model, tok, tgt)))
    return counts


def profile(label: str, fn, top: int = 8) -> None:
    """Where one request's or step's time goes: torch.profiler over one
    call of ``fn`` (after the counted run), device time by kernel and the
    idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile as trace

    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, memcpy); the CPU ops that launched
    # them carry the same time again as their own device time
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy = sum(ms for _, ms in rows)
    if busy == 0:
        log(f"{label} profile: wall {wall:.3f} ms, device time not measured "
            f"(the profiler saw no device activity)")
        return
    log(f"{label} profile (profiler on): wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms, idle share {max(0.0, 1 - busy / wall):.3f}")
    groups = {}
    for name, ms in rows:
        low = name.lower()
        group = ("flash_bwd_dq" if "flash_bwd_dq" in low else
                 "flash_bwd_dkv" if "flash_bwd_dkv" in low else
                 "flash_fwd" if "flash_fwd" in low else
                 "matmul" if any(t in low for t in ("gemm", "nvjet", "cutlass",
                                                    "sm90_xmma")) else
                 "elementwise/reduce/copy")
        groups[group] = groups.get(group, 0.0) + ms
    log(f"{label} profile by group: " + ", ".join(
        f"{g} {ms:.3f} ms ({ms / busy:.1%})"
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])))
    for name, ms in rows[:top]:
        log(f"  {ms:9.3f} ms {ms / busy:6.1%}  {name[:90]}")


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script checks the port on the card",
              file=sys.stderr)
        return 1
    import multiverso_tpu_torch as mv

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    phase_build()
    records = phase_kernel(torch.device("cuda", 0))
    mv.init()   # the card: no device argument
    dev = mv.device()
    shared = phase_ps(dev, LAYERS)
    paths = {"request": {"flash_fwd": phase_request(dev, shared, LAYERS,
                                                    BATCHES)}}
    torch.cuda.empty_cache()   # the request model is gone
    paths["train"] = phase_train(dev, shared, LAYERS)
    mv.shutdown()
    for rec in records:
        by_path = {p: c[rec["name"]] for p, c in paths.items()
                   if c.get(rec["name"])}
        rec["launches"] = sum(by_path.values())
        rec["launches_by_path"] = by_path
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
