"""Threefry2x32 keys and draws, bit for bit those of ``jax.random``.

The reference's seeded quantities — the stochastic sampler's batch rows
(``worker_ops.batch_indices``), AltMin's start ``U0`` and the §5
simulation data — are ``jax.random`` draws, so the port reproduces the
generator itself rather than substituting another: the same seed gives
the same rows, the same ``U0`` and the same data.  This module follows
jax 0.9.0 under its defaults, ``jax_default_prng_impl="threefry2x32"``
and ``jax_threefry_partitionable=True`` (``jax/_src/prng.py``:
``threefry_2x32``, ``threefry_seed``, ``_threefry_split_foldlike``,
``_threefry_fold_in``, ``_threefry_random_bits_partitionable``,
``iota_2x32_shape``; ``jax/_src/random.py``: ``_randint``,
``_uniform``, ``_normal_real``).

Representation: a key is an ``int64`` tensor of shape ``(..., 2)``
holding two uint32 words, on the device its draws run on.  Every uint32
value lives in an ``int64`` tensor masked to 32 bits (torch's
``uint32`` lacks most operations); all arithmetic is integer, and every
function is vectorised over a batch of keys and over all counters at
once.  A batch of keys ``(*K, 2)`` draws ``(*K, *shape)``, each key its
own stream, as ``jax.vmap`` over the keys would.

Everything integer (keys, ``random_bits``, ``randint``, ``uniform``) is
bitwise equal to ``jax.random``.  :func:`normal` evaluates XLA's own
float32 ``erf_inv`` (Giles' single-precision polynomials) on the same
uniforms; only ``log1p``/``sqrt`` and the sum order differ, so draws
agree to ~2.5e-7·max(1, |x|) (``torch.erfinv``, another approximation,
would differ by up to ~6e-6 in the tails).
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch

from .._device import DeviceLike, resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

IntLike = Union[int, torch.Tensor]


def _u32(x: IntLike, device: torch.device) -> torch.Tensor:
    """``x`` as uint32 words in an int64 tensor (negative ints wrap)."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _MASK


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & _MASK) | (x >> (32 - d))


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a * b mod 2**32`` for uint32 ``a`` and a Python int ``b`` < 2**32,
    without leaving int64 (the product is split at bit 16)."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds), elementwise and broadcasting
    over its four uint32 inputs; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _key_words(key: torch.Tensor, ndim: int):
    """The key's two words, shaped to broadcast over ``ndim`` trailing
    counter dimensions."""
    view = key.shape[:-1] + (1,) * ndim
    return key[..., 0].reshape(view), key[..., 1].reshape(view)


def _counters(shape: Sequence[int], device: torch.device):
    """``iota_2x32_shape``: the high and low words of a flat uint64 iota."""
    size = math.prod(shape)
    i = torch.arange(size, dtype=torch.int64, device=device).reshape(shape)
    return i >> 32, i & _MASK


def PRNGKey(seed: int, device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` without x64: the words
    ``[0, seed mod 2**32]``, on ``device`` (default: the card)."""
    dev = resolve_device(device)
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=dev)


def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter pair
    ``(0, data)``.  ``data`` may be a tensor of integers; it broadcasts
    against the key batch (a ``(2,)`` key and ``(L,)`` data give
    ``(L, 2)`` keys)."""
    d = _u32(data, key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): key ``i`` is the hash of the
    counter pair ``(0, i)``.  ``(*K, 2)`` -> ``(*K, num, 2)``."""
    hi, lo = _counters((num,), key.device)
    k0, k1 = _key_words(key, 1)
    y0, y1 = threefry2x32(k0, k1, hi, lo)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, bit_width: int,
                shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits`` at 32, 16 or 8 bits (partitionable): the XOR
    of the two hash words of each flat index, cut to its low
    ``bit_width`` bits.  Unsigned values in an int64 tensor of shape
    ``(*K, *shape)``."""
    if bit_width not in (8, 16, 32):
        raise ValueError(f"only 8-, 16- and 32-bit draws are ported, not "
                         f"{bit_width}")
    shape = tuple(int(s) for s in shape)
    hi, lo = _counters(shape, key.device)
    k0, k1 = _key_words(key, len(shape))
    y0, y1 = threefry2x32(k0, k1, hi, lo)
    return (y0 ^ y1) & ((1 << bit_width) - 1)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``:
    64 bits per value from the two halves of a split key, folded into
    the span by multiply-and-mod (biased like the reference's when the
    span is not a power of two).  Returns int32 ``(*K, *shape)``."""
    minval, maxval = int(minval), int(maxval)
    for v in (minval, maxval):
        if not -2 ** 31 <= v < 2 ** 31:
            raise ValueError(f"randint bounds must fit int32, got {v}")
    span = max(maxval - minval, 1)         # maxval <= minval gives minval
    keys = split(key)
    higher = random_bits(keys[..., 0, :], 32, shape)
    lower = random_bits(keys[..., 1, :], 32, shape)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _MASK) % span      # uint32 product wraps
    offset = ((_mul32(higher % span, mult) + lower % span) & _MASK) % span
    val = (offset + minval + 2 ** 31) & _MASK     # int32 wrap-around
    return (val - 2 ** 31).to(torch.int32)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, dtype: torch.dtype = torch.float32
            ) -> torch.Tensor:
    """``jax.random.uniform`` in float32 or bfloat16: the random mantissa
    bits under the exponent of 1.0, minus 1, scaled to ``[minval,
    maxval)``.  float32 takes 23 of 32 random bits; bfloat16, whose 7
    mantissa bits are fewer than 8, takes 7 of 8 (``_uniform``'s
    ``rng_bits``).

    In float32 XLA fuses the scaling ``floats * (maxval - minval) +
    minval`` into one fused multiply-add; the port forms it in float64
    (the product of two float32 values is exact there) and rounds once.
    In bfloat16 XLA rounds the product and the sum each, as the port
    does."""
    if dtype == torch.float32:
        bits = random_bits(key, 32, shape)
        fbits = (bits >> 9) | 0x3F800000
        floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    elif dtype == torch.bfloat16:
        bits = random_bits(key, 8, shape)
        fbits = ((bits >> 1) | 0x3F80).to(torch.int16)
        floats = fbits.view(torch.bfloat16) - 1.0
    else:
        raise ValueError(f"only float32 and bfloat16 draws are ported, "
                         f"not {dtype}")
    lo = torch.tensor(minval, dtype=dtype, device=key.device)
    span = torch.tensor(maxval, dtype=dtype, device=key.device) - lo
    if dtype == torch.bfloat16:
        return torch.maximum(lo, floats * span + lo)
    scaled = floats.double() * span.double() + lo.double()
    return torch.maximum(lo, scaled.to(dtype))


# XLA's float32 erf_inv: Giles, "Approximating the erfinv function"
# (GPU Computing Gems, 2011), in Horner order, highest degree first
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """erfinv on (-1, 1) as XLA evaluates it in float32."""
    w = -torch.log1p(-x * x)
    # float32 sqrt through float64: correctly rounded, as XLA's is
    w_lo, w_hi = w - 2.5, torch.sqrt(w.double()).to(x.dtype) - 3.0
    p_lo = torch.full_like(x, _ERFINV_W_LT_5[0])
    p_hi = torch.full_like(x, _ERFINV_W_GE_5[0])
    for c_lo, c_hi in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        p_lo = p_lo * w_lo + c_lo
        p_hi = p_hi * w_hi + c_hi
    return torch.where(w < 5.0, p_lo, p_hi) * x


def normal(key: torch.Tensor, shape: Sequence[int],
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``√2·erfinv(u)`` with ``u``
    uniform on ``(nextafter(-1, 0), 1)`` (``u`` bitwise the reference's,
    the result within ~2.5e-7·max(1, |x|))."""
    lo = float(torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                               torch.tensor(0.0, dtype=dtype)))
    u = uniform(key, shape, lo, 1.0, dtype)
    return torch.tensor(math.sqrt(2), dtype=dtype, device=key.device) \
        * _erfinv_f32(u)


def gumbel(key: torch.Tensor, shape: Sequence[int],
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.gumbel`` in its default ("low") mode:
    ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)`` in ``dtype``
    (``u`` bitwise the reference's).  The logarithms run in float32 and
    round once to ``dtype``; in float32 the draws agree with the
    reference's to ~1e-7 relative (the two ``log`` implementations)."""
    tiny = torch.finfo(dtype).tiny
    u = uniform(key, shape, tiny, 1.0, dtype)
    return (-torch.log(-torch.log(u.to(torch.float32)))).to(dtype)


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` with ``axis=-1`` and
    ``replace=True``: the Gumbel-max trick, ``argmax(logits + g)`` over
    the last axis with ``g`` a :func:`gumbel` draw of the logits' shape
    and dtype (first index on ties, as ``jnp.argmax``).  Returns int64
    indices of shape ``logits.shape[:-1]``."""
    g = gumbel(key, tuple(logits.shape), logits.dtype)
    return torch.argmax(g + logits, dim=-1)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` for an int ``n``: ``arange(n)``
    (int32) sorted by fresh 32-bit keys, once per round of
    ``ceil(3 ln n / ln(2**32 - 1))`` (``_shuffle``), each round's keys
    drawn from the second half of a split.  The sort is stable, as
    ``lax.sort_key_val``'s is, so equal keys keep their order."""
    n = int(n)
    x = torch.arange(n, dtype=torch.int32, device=key.device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(_MASK))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, 32, (n,)), stable=True).indices
        x = x[order]
    return x
