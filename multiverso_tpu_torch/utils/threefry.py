"""The parts of ``jax.random``'s threefry2x32 stream that the WordEmbedding
epochs and the LM's sampled decode draw from, bit for bit, as jax runs them with 64-bit types off (its
default) and ``jax_threefry_partitionable=True`` (its default since 0.5).

A key is a pair of Python ints ``(k1, k2)``, each a uint32: the words of
``jax.random.key_data(key)``. ``key`` and ``split`` run on the host (two
words per key: a chain of splits is cheap there and would be dozens of tiny
launches on a device); ``random_bits`` and ``randint`` return int64 tensors
on the device asked for, one row per key of a sequence of keys;
``uniform`` and ``categorical`` draw with one key, as ``generate`` does.

uint32 arithmetic runs on int64 tensors (or Python ints) masked with
``0xFFFFFFFF``: a sum of two masked words stays below 2^33, a left shift by
at most 29 below 2^61, and the modular product in ``randint`` below 2^62, so
nothing overflows int64. The same :func:`threefry2x32` serves both.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

Key = Tuple[int, int]
Word = Union[int, torch.Tensor]

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry2x32(k1: Word, k2: Word, x1: Word, x2: Word
                 ) -> Tuple[Word, Word]:
    """The Threefry-2x32 hash of the counter pair ``(x1, x2)`` under the key
    ``(k1, k2)``: 20 rounds, a key injection after every 4
    (``jax._src.prng._threefry2x32_lowering``). Every argument is a uint32
    held in a Python int or an int64 tensor; tensors broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _MASK32, (x2 + ks[1]) & _MASK32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x[0], x[1]


def key(seed: int) -> Key:
    """``jax.random.key(seed)``'s words: with 64-bit types off the seed is
    taken as a 32-bit integer, so the high word is 0 and the low word is
    the seed modulo 2^32."""
    return (0, int(seed) & _MASK32)


def split(k: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(k, num)``, the fold-like split of the
    partitionable setting: key i is the hash of the counter ``(0, i)``."""
    return [threefry2x32(k[0], k[1], 0, i) for i in range(num)]


def _iota(shape: Sequence[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flat row-major index of each element of ``shape`` as its high
    and low uint32 words (``iota_2x32_shape``)."""
    n = 1
    for s in shape:
        n *= int(s)
    flat = torch.arange(n, dtype=torch.int64, device=device)
    return flat >> 32, flat & _MASK32


def _words(keys: Sequence[Key], device
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The keys' words as (m, 1) int64 tensors."""
    w = torch.tensor(list(keys), dtype=torch.int64).reshape(-1, 2).to(device)
    return w[:, :1], w[:, 1:]


def random_bits(keys: Sequence[Key], shape: Sequence[int],
                device=None) -> torch.Tensor:
    """``jax.random.bits(k, shape, jnp.uint32)`` for each key k of
    ``keys``: ``bits1 ^ bits2`` of the hash of each element's index, as
    int64 in [0, 2^32), shaped (len(keys), *shape), row j drawn with key
    j."""
    k1, k2 = _words(keys, device)
    hi, lo = _iota(shape, device)
    b1, b2 = threefry2x32(k1, k2, hi[None, :], lo[None, :])
    return (b1 ^ b2).reshape((len(keys), *shape))


def randint(keys: Sequence[Key], shape: Sequence[int], minval: int,
            maxval: int, device=None) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` with its default
    int32 dtype (``jax._src.random._randint``) for each key k of ``keys``:
    the key splits in two, each half draws 32 bits an element, and ``(hi %
    span * (2^32 % span) + lo % span) % span`` is taken in wrapping uint32
    arithmetic. Returned as int32, shaped (len(keys), *shape).

    Where the multiplier is 0 (a span that divides 2^32, or any span above
    2^16, where jax's uint32 square of 2^16 wraps) the high draw cannot
    change the result, and it is not computed."""
    minval, maxval = int(minval), int(maxval)
    if not (-2 ** 31 <= minval < 2 ** 31 and -2 ** 31 <= maxval < 2 ** 31):
        raise ValueError(f"randint needs int32 bounds, got [{minval}, "
                         f"{maxval})")
    halves = [split(k) for k in keys]
    # maxval <= minval gives span 1, so every draw is minval
    span = max(maxval - minval, 1)
    # "2^32 mod span" in jax's two uint32 steps, (2^16 mod span)^2 mod
    # span: the square wraps to 0 for every span above 2^16, and then so
    # does the multiplier
    multiplier = (((2 ** 16 % span) ** 2) & _MASK32) % span

    def draw(j: int) -> torch.Tensor:
        return random_bits([h[j] for h in halves], shape, device) % span

    offset = draw(1)
    if multiplier:
        offset = (((draw(0) * multiplier) & _MASK32) + offset) & _MASK32
    return (offset % span + minval).to(torch.int32)


_F32_TINY = float(torch.finfo(torch.float32).tiny)


def uniform(k: Key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform(k, shape, jnp.float32, minval, maxval)``
    (``jax._src.random._uniform``): the top 23 of each element's 32 bits
    become the mantissa of a float in [1, 2), less 1, scaled to
    ``[minval, maxval)`` in f32 and floored at ``minval``. Bit for bit
    where ``maxval - minval`` is 1 (the draws ``categorical`` makes);
    for other ranges XLA may fuse the scaling's multiply-add into one
    rounding, and the two differ by up to an ulp of the range."""
    bits = random_bits([k], shape, device)[0]
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def categorical(k: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(k, logits)`` over the last axis for f32
    logits, in its default ``mode="low"``: the argmax of ``logits +
    gumbel``, ``gumbel = -log(-log(u))`` with ``u`` uniform on [tiny, 1).
    Returns int64 indices of shape ``logits.shape[:-1]``."""
    u = uniform(k, tuple(logits.shape), minval=_F32_TINY, maxval=1.0,
                device=logits.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(gumbel + logits.float(), dim=-1)
