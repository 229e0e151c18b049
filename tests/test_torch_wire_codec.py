"""Port parity, the wire codec: multiverso_tpu_torch's ``ops/wire_codec``
(torch) against its own ``utils/filters.py`` (numpy) and against
multiverso_tpu's jitted ``ops/wire_codec``, bit for bit in the bits, the
scales, the top-k indices and values, and the error-feedback residuals;
then ``ArrayTable(wire_filter=...)`` against the JAX table over 8 adds.

Inputs cover sub-normals (flushed to zero by both codecs), ties in |x|
(which go to the lower index), sizes that are not a multiple of the
1-bit block, and k of 1 and of n.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.ops import wire_codec as jwc
from multiverso_tpu.utils import filters as jfilters
from multiverso_tpu_torch.ops import wire_codec as twc
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils import filters as tfilters
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard
from multiverso_tpu_torch.zoo import Zoo as TZoo

SIZES = (1, 7, 1000, 1024, 3001)


@pytest.fixture(autouse=True)
def _both_runtimes():
    jmv.init()
    tmv.init(device="cpu")
    yield
    zoo = TZoo.get()
    if zoo.started:
        zoo.stop()
    tconfig.reset_flags()
    TDashboard.reset()


def _payload(n, seed):
    """Normal values with sub-normals, exact zeros and |x| ties mixed in."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, n).astype(np.float32)
    x[::11] = np.float32(3e-39)            # sub-normal
    x[3::13] = 0.0
    x[5::7] = np.float32(0.5)              # ties in |x| ...
    x[6::7] = np.float32(-0.5)             # ... of both signs
    return x


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(a).dtype == np.asarray(b).dtype


def test_filters_copy_matches_the_jax_packages():
    """The port's numpy reference is a copy: same outputs."""
    x = _payload(3001, 0)
    _eq(tfilters.canon_f32(x), jfilters.canon_f32(x))
    for fn in ("onebit_encode_np", "topk_encode_np"):
        for a, b in zip(getattr(tfilters, fn)(x), getattr(jfilters, fn)(x)):
            _eq(a, b)
    bits, scales = tfilters.onebit_encode_np(x)
    _eq(tfilters.onebit_decode_np(bits, scales, x.size),
        jfilters.onebit_decode_np(bits, scales, x.size))
    f = tfilters.SparseFilter(clip=0.6)
    hdr, payload = f.filter_in(x)
    jhdr, jpayload = jfilters.SparseFilter(clip=0.6).filter_in(x)
    assert hdr == jhdr
    _eq(payload, jpayload)
    _eq(f.filter_out(hdr, payload), x * (np.abs(x) > 0.6))
    for n in (1, 100, 5000):
        assert tfilters.default_topk(n) == twc.default_topk(n) \
            == jwc.default_topk(n)
        assert twc.onebit_compressed_nbytes(n) == \
            jwc.onebit_compressed_nbytes(n)
        assert twc.topk_compressed_nbytes(n) == jwc.topk_compressed_nbytes(n)
    assert tfilters.OneBitsFilter(256).compression_ratio(4096) == \
        jfilters.OneBitsFilter(256).compression_ratio(4096)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("block", [8, 1024])
def test_onebit_matches_numpy_and_jax(n, block):
    """Three encodes with error feedback: bits, scales and residual equal
    to the numpy filter's and the JAX kernel's, bit for bit; the decode
    too."""
    ref = tfilters.OneBitsFilter(block=block)
    tres = torch.zeros(n)
    jres = jnp.zeros(n, jnp.float32)
    for step in range(3):
        x = _payload(n, step)
        _, bits, scales = ref.filter_in(x)
        tb, ts, tres = twc.onebit_encode(torch.from_numpy(x), tres, block)
        jb, js, jres = jwc.onebit_encode(x, jres, block=block)
        _eq(tb.numpy(), bits)
        _eq(ts.numpy(), scales)
        _eq(tres.numpy(), ref._residual)
        _eq(jb, bits)
        _eq(js, scales)
        _eq(np.asarray(jres), ref._residual)
        _eq(twc.onebit_decode(tb, ts, n, block).numpy(),
            tfilters.onebit_decode_np(bits, scales, n, block))
    with pytest.raises(ValueError):
        twc.onebit_encode(torch.zeros(8), torch.zeros(8), block=12)


@pytest.mark.parametrize("n", SIZES)
def test_topk_matches_numpy_and_jax(n):
    """k of 1, ~3% (the default), and n; three encodes with error
    feedback: indices (ties to the lower index), values and residual
    equal to the numpy filter's and the JAX kernel's, bit for bit."""
    for k in sorted({1, twc.default_topk(n), n}):
        ref = tfilters.TopKFilter(k)
        tres = torch.zeros(n)
        jres = jnp.zeros(n, jnp.float32)
        for step in range(3):
            x = _payload(n, 10 + step)
            _, idx, vals = ref.filter_in(x)
            ti, tv, tres = twc.topk_encode(torch.from_numpy(x), tres, k)
            ji, jv, jres = jwc.topk_encode(x, jres, k=k)
            _eq(ti.numpy(), idx)
            _eq(tv.numpy(), vals)
            _eq(tres.numpy(), ref._residual)
            _eq(ji, idx)
            _eq(jv, vals)
            _eq(np.asarray(jres), ref._residual)
            _eq(twc.topk_decode(ti, tv, n).numpy(),
                tfilters.topk_decode_np(idx, vals, n))


def test_ties_go_to_the_lower_index():
    x = np.array([0.5, -1.0, 1.0, -0.5, 1.0, 0.25], np.float32)
    ti, _, _ = twc.topk_encode(torch.from_numpy(x), torch.zeros(6), 4)
    assert ti.tolist() == [1, 2, 4, 0]
    ji, _, _ = jwc.topk_encode(x, jnp.zeros(6, jnp.float32), k=4)
    assert np.asarray(ji).tolist() == [1, 2, 4, 0]


def test_bits_pack_msb_first_and_canon_flushes_subnormals():
    mask = torch.tensor([1, 0, 0, 0, 0, 0, 0, 1, 0, 1, 0, 0, 0, 0, 0, 0],
                        dtype=torch.bool)
    packed = twc.packbits(mask)
    _eq(packed.numpy(), np.packbits(mask.numpy()))
    _eq(twc.unpackbits(packed, 16).numpy(), mask.numpy())
    x = np.array([1e-39, -1e-40, 1.2e-38, -2.0, 0.0], np.float32)
    _eq(twc.canon_f32(torch.from_numpy(x)).numpy(), tfilters.canon_f32(x))
    _eq(twc.bf16_cast(torch.from_numpy(x)).float().numpy(),
        np.asarray(jwc.bf16_cast(x).astype(np.float32)))


def test_fold_sum_and_block_scales_match_jax():
    rng = np.random.default_rng(3)
    blocks = rng.normal(size=(5, 24)).astype(np.float32)
    for n in (None, 100):
        tp, tps, tns = twc.block_scales(torch.from_numpy(blocks), n)
        jp, jps, jns = jwc.block_scales(jnp.asarray(blocks), n)
        _eq(tp.numpy(), jp)
        _eq(tps.numpy(), jps)
        _eq(tns.numpy(), jns)
    x = rng.normal(size=(3, 64)).astype(np.float32)
    _eq(twc.fold_sum(torch.from_numpy(x)).numpy(), tfilters._fold_sum(x))


@pytest.mark.parametrize("updater", ["default", "sgd"])
@pytest.mark.parametrize("wire", ["bf16", "1bit", "topk"])
def test_array_table_wire_filter_matches_jax(wire, updater):
    """8 blocking adds with error feedback through a compressed wire: the
    table equals the JAX table's bit for bit after each (the same codec
    bits, decoded and applied with one IEEE add per element), and Get
    reads bf16 in both."""
    n = 3001
    rng = np.random.default_rng(7)
    init = rng.normal(0.0, 1.0, n).astype(np.float32)
    jt = jmv.ArrayTable(n, updater=updater, init=init, name="jw",
                        wire_filter=wire)
    tt = tmv.ArrayTable(n, updater=updater, init=init, name="tw",
                        wire_filter=wire)
    for _ in range(8):
        delta = (rng.normal(0.0, 1.0, n) * 0.1).astype(np.float32)
        jt.add(delta)
        tt.add(delta)
        got, want = tt.get(), jt.get()
        _eq(got, want)
        # the exact table: f32 everywhere the wire does not round
        np.testing.assert_array_equal(
            tt.raw()[:n].numpy(), np.asarray(jt.raw())[:n])
    assert not np.any(got.view(np.uint32) & 0xFFFF)   # bf16 values
    with pytest.raises(ValueError):
        tmv.ArrayTable(8, wire_filter="2bit")
    with pytest.raises(ValueError):
        jmv.ArrayTable(8, wire_filter="2bit")
