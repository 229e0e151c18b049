"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so these tests are marked ``cuda`` and skip
where ``torch.cuda.is_available()`` is False. This file imports neither jax
nor multiverso_tpu, so it also runs where only the port is installed; on
the card run it without the repository's JAX conftest:

    python -m pytest -m cuda --noconftest tests/test_torch_kernels_cuda.py

Tolerances (max abs error against the plain version on the same card),
the same limits ``chip_smoke.py`` holds the kernels to:

* forward (B1): f32 2e-5 and bf16 8e-3 for the output (8e-3 is ~2x the
  largest error measured on an H100, one bf16 ulp at |out| in [0.5, 1)),
  1e-4 for the lse (f32 sums over up to 1024 keys in another order);
* backward (B2 dQ, B3 dK/dV): ``BWD_ATOL`` below, with its reason.
"""

import numpy as np
import pytest
import torch

from multiverso_tpu_torch.ops import attention_kernels as ak

ATOL = {"float32": 2e-5, "bfloat16": 8e-3}
# dq, dk, dv against the plain backward, the limits chip_smoke.py states
# with their reasons: f32 sums in another order; bf16 one ulp at |x| < 1
# (dk and dv are summed per 64-row q tile in the kernels and the plain
# version alike)
BWD_ATOL = {"float32": 4e-6, "bfloat16": 4e-3}

# (shape, block): S = 40 and S = 200 are not multiples of the kernels'
# tiles (the bf16 B1 and B2 take 128 q rows, and 128 or 64 k rows; the bf16
# B3 128 k rows and 64 q rows), and with several heads a tile read past the
# end of one head's S would take the next head's rows; head dim 32 over
# several tiles; head dim 64 at S = 1024; S = 320 leaves B3 a last k tile
# of 64 rows while 5 q tiles are live
SHAPES = (((2, 4, 256, 128), 128), ((1, 4, 40, 64), 128),
          ((2, 3, 200, 128), 200), ((1, 2, 96, 32), 32),
          ((2, 4, 1024, 64), 128), ((1, 2, 320, 128), 64))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels have no CPU mode")
    return torch.device("cuda")


def _randn(rng, shape, dev, dtype, n):
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .to(dev, dtype) for _ in range(n)]


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_matches_plain(cuda_device, dtype, causal):
    rng = np.random.default_rng(0)
    tdt = getattr(torch, dtype)
    for shape, blk in SHAPES:
        q, k, v = _randn(rng, shape, cuda_device, tdt, 3)
        before = ak.launch_counts()["flash_fwd"]
        out, lse = ak.flash_attention_with_lse(q, k, v, causal, blk, blk)
        assert ak.launch_counts()["flash_fwd"] == before + 1
        ref, ref_lse = ak.flash_forward_plain(q, k, v, causal, True)
        torch.cuda.synchronize()
        assert out.dtype == tdt and lse.shape == (shape[0] * shape[1], shape[2])
        assert _max_err(out, ref) <= ATOL[dtype]
        assert float((lse - ref_lse).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_matches_plain(cuda_device, dtype, causal):
    """B2 and B3 against flash_backward_plain on the forward kernel's out
    and lse, and the autograd path launches each once."""
    rng = np.random.default_rng(1)
    tdt = getattr(torch, dtype)
    for shape, blk in SHAPES:
        q, k, v, do = _randn(rng, shape, cuda_device, tdt, 4)
        out, lse = ak.flash_attention_with_lse(q, k, v, causal, blk, blk)
        dq = ak._flash_bwd_dq_cuda(q, k, v, out, lse, do, causal)
        dk, dv = ak._flash_bwd_dkv_cuda(q, k, v, out, lse, do, causal)
        ref = ak.flash_backward_plain(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            assert got.dtype == tdt and got.shape == q.shape
            assert torch.isfinite(got).all()
            print(f"{shape} {dtype} causal={causal} {name} max_abs_err "
                  f"{_max_err(got, want):.3e}")
            assert _max_err(got, want) <= BWD_ATOL[dtype]

        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        before = ak.launch_counts()
        o = ak.flash_attention(qg, kg, vg, causal, blk, blk)
        grads = torch.autograd.grad(o, (qg, kg, vg), do)
        after = ak.launch_counts()
        assert {n: after[n] - before[n] for n in after} == {
            "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
        for got, want in zip(grads, (dq, dk, dv)):
            assert torch.equal(got, want)   # deterministic: one owner a tile


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16])
def test_small_head_dims_are_padded(cuda_device, d):
    """Head dims below 32 are zero-padded to 32 on the way to the kernels
    (the example's LM has head dim 8): out and grads match the plain
    versions on the unpadded tensors."""
    rng = np.random.default_rng(2)
    shape = (2, 4, 32, d)
    q, k, v, do = _randn(rng, shape, cuda_device, torch.float32, 4)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = ak.flash_attention(qg, kg, vg, True)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    ref, lse = ak.flash_forward_plain(q, k, v, True, True)
    ref_grads = ak.flash_backward_plain(q, k, v, ref, lse, do, True)
    assert out.shape == shape
    assert _max_err(out.detach(), ref) <= ATOL["float32"]
    for got, want in zip(grads, ref_grads):
        assert got.shape == shape
        assert _max_err(got, want) <= BWD_ATOL["float32"]


@pytest.mark.cuda
def test_example_trains_on_the_card(cuda_device):
    """The PS training example on the card ends where its CPU run ends:
    f32, 10 steps at lr 0.3 with two syncs, final loss within 1e-3 (the
    kernels and cuBLAS sum in another order than the CPU)."""
    from multiverso_tpu_torch.examples import transformer_ps as tex
    torch.backends.cuda.matmul.allow_tf32 = False
    on_card = tex.main(steps=10, sync_every=5)
    on_cpu = tex.main(steps=10, sync_every=5, device="cpu")
    print(f"example final loss: card {on_card:.7f}, cpu {on_cpu:.7f}")
    assert np.isfinite(on_card) and abs(on_card - on_cpu) <= 1e-3


# ---------------------------------------------------------------------- #
# the telemetry plane's device readings
# ---------------------------------------------------------------------- #
@pytest.mark.cuda
def test_device_census_counts_live_bytes(cuda_device):
    """The memory ledger's census and the device plane's per-device
    rollup read the caching allocator: a live 64 MiB tensor shows on
    cuda:0 in both, and its table gauge equals its bytes."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.telemetry import devstats, memstats
    mv.init()
    try:
        t = mv.ArrayTable(16 << 20, name="census")   # f32: 64 MiB + 1 row
        nb = t._data.numel() * t._data.element_size()
        census = memstats.device_census()
        rollup = devstats.device_rollup()
        assert census["bytes"] >= nb and rollup["cuda:0"]["bytes"] >= nb
        assert census["top"][0]["device"] == "cuda:0"
        gauges = memstats.LEDGER.snapshot()["components"]["table[census]"]
        assert gauges["table_bytes"] == nb
    finally:
        mv.shutdown()


@pytest.mark.cuda
def test_profiling_trace_names_the_flash_kernels(cuda_device, tmp_path):
    """``utils.profiling.trace`` writes a Chrome trace of the region that
    holds each flash kernel's CUDA function as many times as the
    wrappers counted launches, inside the ``annotate`` regions."""
    from multiverso_tpu_torch.utils import profiling
    rng = np.random.default_rng(4)
    q, k, v = _randn(rng, (1, 2, 256, 128), cuda_device, torch.bfloat16, 3)
    for x in (q, k, v):
        x.requires_grad_(True)
    ak.flash_attention(q, k, v, causal=True).float().sum().backward()
    ak.reset_launch_counts()
    with profiling.trace("flash", trace_dir=str(tmp_path)) as path:
        with profiling.annotate("fwd"):
            out = ak.flash_attention(q, k, v, causal=True)
        with profiling.annotate("bwd"):
            out.float().sum().backward()
    counts = ak.launch_counts()
    import json
    events = json.load(open(path))["traceEvents"]
    names = [e.get("name", "") for e in events
             if e.get("cat") == "kernel"]
    for fn, key in (("flash_fwd_wgmma", "flash_fwd"),
                    ("flash_bwd_dq_wgmma", "flash_bwd_dq"),
                    ("flash_bwd_dkv_wgmma", "flash_bwd_dkv")):
        assert counts[key] >= 1
        assert sum(fn in n for n in names) == counts[key], (fn, counts)
    assert {"fwd", "bwd"} <= {e.get("name") for e in events}


@pytest.mark.cuda
def test_collectives_on_cuda_tensors(cuda_device):
    """parallel/collectives.py on CUDA tensors, two ranks on one card over
    gloo (NCCL refuses two ranks on one card): every op's values, and only
    ppermute (point-to-point sends, which gloo cannot take from device
    memory) staged through host buffers, each copy counted."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).parent))
    from multiverso_tpu_torch.parallel.mesh import spawn
    from torch_mesh_worker import cuda_collectives
    got = spawn(cuda_collectives, 2, "cuda", timeout=300)
    x = [np.arange(8, dtype=np.float32) + 100 * r for r in range(2)]
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g["all_reduce"], x[0] + x[1])
        np.testing.assert_array_equal(g["all_gather"], np.concatenate(x))
        np.testing.assert_array_equal(g["reduce_scatter"],
                                      (x[0] + x[1])[r * 4:(r + 1) * 4])
        np.testing.assert_array_equal(g["broadcast"], x[1])
        np.testing.assert_array_equal(
            g["all_to_all"], np.stack([x[0][r * 4:(r + 1) * 4],
                                       x[1][r * 4:(r + 1) * 4]]))
        np.testing.assert_array_equal(g["ppermute"], x[1 - r])
        np.testing.assert_array_equal(g["ppermute_grad"], np.ones(8))
        assert g["on_cuda"]
        # three ppermutes (one alone, one forward, its backward), each
        # 32 B down and 32 B up; every copy counted
        assert g["staged"] == {"ppermute": {"calls": 3, "bytes": 192}}
        assert g["transfers"]["d2h"] == {"ops": 3, "bytes": 96}
        assert g["transfers"]["h2d"] == {"ops": 3, "bytes": 96}


def _ps_world(tmp_path, n, sub, dev, updater, armed):
    """``n`` ranks in this process with their shards on ``dev``, both
    flags of the mesh data plane ``armed`` (or both off)."""
    from multiverso_tpu_torch.ps.service import (FileRendezvous, PSContext,
                                                 PSService)
    from multiverso_tpu_torch.ps.tables import AsyncMatrixTable
    from multiverso_tpu_torch.utils import config
    config.set_flag("ps_fanout", armed)
    config.set_flag("ps_spmd_stack", armed)
    rdv = FileRendezvous(str(tmp_path / sub))
    ctxs = [PSContext(r, n, PSService(r, n, rdv), device=dev)
            for r in range(n)]
    return ctxs, [AsyncMatrixTable(4096, 64, name=sub, updater=updater,
                                   ctx=c) for c in ctxs]


def _ps_close(*worlds):
    from multiverso_tpu_torch.ps import spmd
    from multiverso_tpu_torch.utils import config
    for ctxs in worlds:
        for c in ctxs:
            c.close()
    config.reset_flags()
    spmd.reset_registry()


@pytest.mark.cuda
@pytest.mark.parametrize("updater", ["default", "adagrad", "momentum_sgd"])
def test_stacked_shards_match_classic_on_the_card(cuda_device, tmp_path,
                                                  updater):
    """ps/spmd.py on cuda:0: four ranks' shards stack into one plane, and
    multi-owner adds from every rank's client leave the table equal to a
    1-shard classic world's on the card bit for bit, one dispatch an
    add."""
    from multiverso_tpu_torch.updaters import AddOption
    octxs, otab = _ps_world(tmp_path, 1, "o", cuda_device, updater, False)
    ctxs, tabs = _ps_world(tmp_path, 4, "g", cuda_device, updater, True)
    try:
        plane = tabs[0]._shard._plane
        assert plane is not None and plane.active
        assert len(plane.members) == 4
        assert plane.stack.device.type == cuda_device.type
        rng = np.random.default_rng(3)
        for step in range(6):
            ids = np.sort(rng.choice(4096, 512, replace=False))
            vals = rng.normal(size=(512, 64)).astype(np.float32)
            opt = AddOption(worker_id=step % 4, momentum=0.5,
                            learning_rate=0.5)
            tabs[step % 4].add_rows(ids, vals, opt)
            otab[0].add_rows(ids, vals, opt)
        assert plane._dispatches == 6
        np.testing.assert_array_equal(tabs[1].get(), otab[0].get())
        np.testing.assert_array_equal(tabs[2].get_rows(ids),
                                      otab[0].get_rows(ids))
    finally:
        _ps_close(ctxs, octxs)


@pytest.mark.cuda
def test_pinned_stacked_slab_survives_grouped_apply(cuda_device, tmp_path):
    """A reader's pinned slab of a grouped shard on the card is its own
    tensor: a grouped apply leaves it as it was; set_rows then evicts that
    member alone."""
    ctxs, tabs = _ps_world(tmp_path, 4, "al", cuda_device, "default", True)
    try:
        sh = tabs[1]._shard
        plane = sh._plane
        ones = np.ones((4096, 64), np.float32)
        tabs[0].add_rows(np.arange(4096), ones)
        pin = sh._pin_data()
        before = pin.data.clone()
        tabs[2].add_rows(np.arange(4096), ones)
        torch.cuda.synchronize()
        assert torch.equal(pin.data, before)
        assert not torch.equal(sh._data, before)
        sh._release_data(pin)
        tabs[0].set_rows(np.array([sh.lo]), np.zeros((1, 64), np.float32))
        assert sh._plane is None
        assert all(t._shard._plane is plane for i, t in enumerate(tabs)
                   if i != 1)
        want = np.full((4096, 64), 2.0, np.float32)
        want[sh.lo] = 0.0
        np.testing.assert_array_equal(tabs[3].get(), want)
    finally:
        _ps_close(ctxs)
