"""Port parity: multiverso_tpu_torch.utils.threefry against jax.random
(threefry2x32, 64-bit types off, jax_threefry_partitionable on), bit for
bit: the hash itself on the Random123 known answers, ``key``, chains of
``split``, 32-bit ``random_bits`` and int32 ``randint``, at several seeds,
shapes and spans. Integer work: every comparison is exact. Then the f32
draws of the sampled decode, ``uniform`` and ``categorical``, also bit for
bit: the uniform is the bits' mantissa (exact), and the categorical is an
argmax over logits plus gumbel noise, whose two logs agree between XLA
and torch on these draws (a one-ulp disagreement could flip only an exact
near-tie)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu_torch.utils import threefry

SEEDS = [0, 1, 42, 2 ** 31 - 1, -5, 2 ** 32 + 3]


def _words(k) -> tuple:
    return tuple(int(w) for w in np.asarray(jax.random.key_data(k)))


def test_partitionable_is_the_setting_compared():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("k,x,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry2x32_known_answers_on_ints_and_tensors(k, x, want):
    assert threefry.threefry2x32(*k, *x) == want
    t = [torch.tensor([v], dtype=torch.int64) for v in (*k, *x)]
    got = threefry.threefry2x32(*t)
    assert (int(got[0]), int(got[1])) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_key_matches_jax(seed):
    assert threefry.key(seed) == _words(jax.random.key(seed))


@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_split_chains_match_jax(seed):
    jk, tk = jax.random.key(seed), threefry.key(seed)
    for _ in range(20):          # the epochs' chain: key, sub = split(key)
        jk, jsub = jax.random.split(jk)
        tk, tsub = threefry.split(tk)
        assert (tk, tsub) == (_words(jk), _words(jsub))
    assert (threefry.split(tk, 5)
            == [_words(k) for k in jax.random.split(jk, 5)])


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 4), (64, 5)])
@pytest.mark.parametrize("seed", [0, 3])
def test_random_bits_match_jax(seed, shape):
    want = np.asarray(jax.random.bits(jax.random.key(seed), shape,
                                      jnp.uint32)).astype(np.int64)
    got = threefry.random_bits([threefry.key(seed)], shape)
    assert got.dtype == torch.int64 and tuple(got.shape) == (1, *shape)
    got = got[0]
    np.testing.assert_array_equal(got.numpy(), want)


# spans: the epochs' 2^20, powers of two, spans that are not (below and
# above 2^16, where jax's multiplier wraps to 0), empty and reversed
# ranges, and the whole int32 range
@pytest.mark.parametrize("lo,hi", [
    (0, 1 << 20), (0, 1 << 16), (0, 1000), (0, 7), (3, 40000),
    (0, 65535), (0, 65537), (-50, 3000001), (5, 5), (9, 2),
    (-2 ** 31, 2 ** 31 - 1),
])
def test_randint_matches_jax(lo, hi):
    for seed, shape in ((0, (64, 5)), (11, (3, 7, 2))):
        want = np.asarray(jax.random.randint(jax.random.key(seed), shape, lo,
                                             hi))
        got = threefry.randint([threefry.key(seed)], shape, lo, hi)
        assert want.dtype == np.int32 and got.dtype == torch.int32
        np.testing.assert_array_equal(got[0].numpy(), want)


def test_a_batch_of_keys_draws_each_key_s_rows():
    keys = [threefry.key(s) for s in (3, 9, 4)]
    bits = threefry.random_bits(keys, (4, 5))
    ints = threefry.randint(keys, (4, 5), 0, 1000)
    assert tuple(bits.shape) == tuple(ints.shape) == (3, 4, 5)
    for j, k in enumerate(keys):
        assert torch.equal(bits[j], threefry.random_bits([k], (4, 5))[0])
        assert torch.equal(ints[j], threefry.randint([k], (4, 5), 0, 1000)[0])


def test_randint_needs_int32_bounds():
    with pytest.raises(ValueError, match="int32"):
        threefry.randint([threefry.key(0)], (2,), 0, 2 ** 31)


@pytest.mark.parametrize("shape", [(5,), (3, 7), (2, 32), (8, 4096)])
@pytest.mark.parametrize("seed", [0, 3, 99])
def test_uniform_matches_jax(seed, shape):
    tiny = float(np.finfo(np.float32).tiny)
    for lo, hi in ((0.0, 1.0), (tiny, 1.0), (-2.0, 3.5)):
        want = np.asarray(jax.random.uniform(jax.random.key(seed), shape,
                                             minval=lo, maxval=hi))
        got = threefry.uniform(threefry.key(seed), shape, lo, hi)
        assert got.dtype == torch.float32
        if hi - lo == 1.0:   # the draws generate makes: exact
            np.testing.assert_array_equal(got.numpy(), want)
        else:   # XLA fuses ``u * (hi - lo) + lo`` into one rounding: the
            # product's rounding, half an ulp of the range, is the gap
            atol = float(np.spacing(np.float32(hi - lo)))
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("shape", [(7,), (2, 32), (8, 4096)])
@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_categorical_matches_jax(seed, shape):
    logits = np.random.default_rng(seed).normal(0, 2, shape).astype(
        np.float32)
    # masked entries, as generate's nucleus filter leaves them
    logits.reshape(-1)[::5] = -1e30
    want = np.asarray(jax.random.categorical(jax.random.key(seed), logits))
    got = threefry.categorical(threefry.key(seed), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in f32 ulps: the distance of the two in the order of the
    f32 bit patterns (negative values mapped below zero)."""
    def ordered(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(
            np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


# threefry.normal against jax.random.normal: the uniform draw is equal bit
# for bit, the erfinv is XLA's f32 polynomial with its fused multiply-adds,
# and only log1p is each library's own (up to 2 ulps apart in
# w = -log1p(-u^2)). Measured on seeds 0-7 at these shapes (133,696 draws
# a seed): 0.91% to 1.00% of a seed's normals differ, 84 to 111 of them by
# 3 ulps, none by more; erfinv alone on the same u is within 2 ulps
NORMAL_MAX_ULPS = 3
NORMAL_MAX_SHARE = 0.015
NORMAL_SHAPES = [(7,), (3, 5), (64, 64), (256, 512)]


@pytest.mark.parametrize("seed", range(8))
def test_normal_matches_jax(seed):
    differ = total = 0
    for shape in NORMAL_SHAPES:
        want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
        got = threefry.normal(threefry.key(seed), shape)
        assert got.dtype == torch.float32 and got.shape == want.shape
        d = _ulps(got.numpy(), want)
        assert d.max() <= NORMAL_MAX_ULPS, (shape, int(d.max()))
        differ += int((d > 0).sum())
        total += d.size
    assert differ / total <= NORMAL_MAX_SHARE, differ / total


def test_erfinv_f32_matches_xla_and_its_edges():
    x = np.linspace(-1, 1, 20_001, dtype=np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.copy())))
    got = threefry.erfinv_f32(torch.from_numpy(x.copy())).numpy()
    assert got[0] == -np.inf and got[-1] == np.inf and got[10_000] == 0.0
    d = _ulps(got[1:-1], want[1:-1])
    assert d.max() <= NORMAL_MAX_ULPS, int(d.max())
