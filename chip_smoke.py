#!/usr/bin/env python3
"""Drive multiverso_tpu_torch's main path on one NVIDIA card and check it.

Phases, every one on every run, in this order:

1. build    compile every CUDA kernel from ``multiverso_tpu_torch/csrc``
            into ``build/torch_kernels/`` (one nvcc per source, in parallel)
2. kernel   each kernel against its plain PyTorch version on the card, at
            the main path's shape and at small edge shapes, plus CUDA-event
            times of the kernel, the plain version and the library call
3. ps       init() on the card, the 472M LM's parameters in one ArrayTable
            (SharedPytree), Get, one sync (Add of a delta, then Get) checked
            against numpy, and each updater timed on a 16M-element table
4. request  the full-width LM built from the table's Get scores request
            batches [2, 1024] with attn="flash" (the main path: launch
            counts are zeroed just before and read just after), checked
            against attn="local" on the same weights

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
# attn="flash" vs attn="local" on the bf16 model: p is rounded to bf16 at
# another point (running vs final max) and the error passes 8 layers;
# 0.25 is 8 bf16 ulps at the logits' magnitude (|logits| in [4, 8))
ATOL_LOGITS = 0.25
ATOL_LOSS = 1e-2

# the "472M" LM of bench.py (vocab 32768, dim 2048, 16 heads, seq 1024)
LM = dict(vocab_size=32768, dim=2048, num_heads=16, max_seq=1024)
LAYERS = 8
BATCH = 2
BATCHES = 4        # request batches scored on the main path


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
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


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def phase_build() -> None:
    from multiverso_tpu_torch.ops import _build
    t0 = time.perf_counter()
    results = _build.build_all()
    for name, (seconds, text) in results.items():
        log(f"build {name}: {seconds:.1f} s")
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"build total: {time.perf_counter() - t0:.1f} s")


def phase_kernel(dev) -> dict:
    """B1 against its plain version; returns the B1 record, whose
    ``launches`` the request phase fills in."""
    import torch
    import torch.nn.functional as F
    from multiverso_tpu_torch.ops import attention_kernels as ak

    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(shape, dtype):
        return [torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32).to(dtype) for _ in range(3)]

    slice_shape = (BATCH, LM["num_heads"], LM["max_seq"],
                   LM["dim"] // LM["num_heads"])
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for causal in (True, False):
            for lse in (False, True):
                cases.append((slice_shape, dtype, causal, lse, 128))
        for shape, blk in (((1, 4, 64, 64), 128), ((1, 4, 40, 64), 128),
                           ((1, 2, 96, 32), 32)):
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
    ms = cuda_ms(lambda: ak._flash_forward_cuda(q, k, v, True, False))
    plain_ms = cuda_ms(lambda: ak.flash_forward_plain(q, k, v, True, False),
                       iters=5)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    b, h, s, d = slice_shape
    nbytes = 4 * b * h * s * d * q.element_size()       # q, k, v read, o written
    flops = 4 * d * b * h * s * (s + 1) // 2             # unmasked pairs only
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    log(f"kernel flash_fwd {slice_shape} bf16 causal: {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
        f"{max(t_bytes, t_ops):.4f} ms ({nbytes} B, {flops} FLOP)")
    return {
        "name": "flash_fwd", "route": "cuda",
        "source": "multiverso_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "multiverso_tpu/ops/attention_kernels.py:138",
        "launches": None, "max_abs_err": slice_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }


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
    """Score request batches with attn="flash"; returns flash_fwd launches."""
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
    launches = ak.launch_counts()["flash_fwd"]
    if launches != layers * batches:
        raise AssertionError(f"flash_fwd launched {launches} times, expected "
                             f"{layers * batches}")
    tokens = batches * BATCH * cfg.max_seq
    log(f"request scored {batches} batches [{BATCH}, {cfg.max_seq}]: losses "
        f"{[round(l, 5) for l in losses]}, latency ms {[round(t, 3) for t in lat]}"
        f", p50 {float(np.median(lat)):.3f} ms; device span ms (CUDA events) "
        f"{[round(a.elapsed_time(b), 3) for a, b in events]}; {tokens} tokens "
        f"in "
        f"{run_s * 1e3:.3f} ms = {tokens / run_s:.0f} tokens/s; flash_fwd "
        f"launches {launches}")
    if not (torch.isfinite(first_logits).all() and np.isfinite(losses).all()):
        raise AssertionError("non-finite logits or loss")
    if first_logits.shape != (BATCH, cfg.max_seq, cfg.vocab_size):
        raise AssertionError(f"logits shape {tuple(first_logits.shape)}")

    model.cfg = cfg._replace(attn="local")
    ref_logits = tfm.forward(model, toks[0, :, :-1])
    ref_loss = float(tfm._nll(ref_logits, toks[0, :, 1:]))
    d_logits = max_err(first_logits, ref_logits)
    d_loss = abs(losses[0] - ref_loss)
    log(f"request flash vs local: max |logits diff| {d_logits:.4e} (logits "
        f"max |x| {float(ref_logits.float().abs().max()):.3f}), |loss diff| "
        f"{d_loss:.4e} (local loss {ref_loss:.5f})")
    if not (d_logits <= ATOL_LOGITS and d_loss <= ATOL_LOSS):
        raise AssertionError("attn='flash' disagrees with attn='local'")
    model.cfg = cfg
    profile_request(model, toks[0, :, :-1], toks[0, :, 1:])
    return launches


def profile_request(model, tok, tgt, top: int = 6) -> None:
    """Where one request's time goes: torch.profiler over one scored batch
    (after the counted run), device time by kernel and the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from multiverso_tpu_torch.models import transformer as tfm

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(tfm._nll(tfm.forward(model, tok), tgt))
        wall = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, memcpy); the CPU ops that launched
    # them carry the same time again as their own device time
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy = sum(ms for _, ms in rows)
    if busy == 0:
        log(f"request profile: wall {wall:.3f} ms, device time not measured "
            f"(the profiler saw no device activity)")
        return
    log(f"request profile (one batch, profiler on): wall {wall:.3f} ms, "
        f"device busy {busy:.3f} ms, idle share {max(0.0, 1 - busy / wall):.3f}")
    groups = {}
    for name, ms in rows:
        low = name.lower()
        group = ("flash_fwd" if "flash_fwd" in low else
                 "matmul" if any(t in low for t in ("gemm", "nvjet", "cutlass",
                                                    "sm90_xmma")) else
                 "elementwise/reduce/copy")
        groups[group] = groups.get(group, 0.0) + ms
    log("request profile by group: " + ", ".join(
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
    record = phase_kernel(torch.device("cuda", 0))
    mv.init()   # the card: no device argument
    dev = mv.device()
    shared = phase_ps(dev, LAYERS)
    record["launches"] = phase_request(dev, shared, LAYERS, BATCHES)
    mv.shutdown()
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
