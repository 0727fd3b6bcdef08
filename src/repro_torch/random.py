"""JAX-exact counter-based PRNG: threefry2x32 with the partitionable
counter layout, over PyTorch tensors.

The envs draw randomness on the hot path (every finalize splits each
lane's key, every Atari emulator frame splits and draws a uniform), so
the port can only be held against ``repro`` if its draws are the same
bits as ``jax.random``'s.  This module reproduces the subset the envs
and the engine and the LM policy call — ``PRNGKey``, ``split``, ``fold_in``,
``bits``, ``uniform``, ``bernoulli``, ``normal``, ``randint``, ``gumbel``,
``categorical`` and the PPO epochs' ``permutation`` — for jax's default
``threefry2x32`` implementation with ``jax_threefry_partitionable``
on (the counter of element ``i`` of a draw of shape ``s`` is the 64-bit
flat index ``i`` split into (hi, lo) words).

Keys are ``(..., 2)`` tensors of uint32 values held in ``int64`` (torch's
``uint32`` lacks the shifts and bitwise ops this needs); every result
is masked back to 32 bits.  Leading dims are batch dims: a ``(N, 2)``
key tensor acts like ``jax.vmap`` over N keys, so ``split(keys, 3)`` is
``(N, 3, 2)`` and ``uniform(keys, (8,))`` is ``(N, 8)``.

``split``, ``fold_in``, ``bits``, ``uniform``, ``bernoulli``,
``randint`` and ``permutation`` are bitwise equal to ``jax.random``.
``normal`` follows XLA's f32 ``erf_inv`` polynomial op for op, but its
``log1p`` is torch's, and ``gumbel`` rounds a float64 ``log``, so both
are held to a tolerance (tests/test_torch_random.py); ``categorical``'s
samples are bitwise on the inputs tested there.

This is plain tensor code: one draw is some 150 small elementwise ops.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds), elementwise over
    broadcastable int64 tensors of uint32 values — the unrolled form of
    ``jax._src.prng._threefry2x32_lowering``."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x1 + ks[0]) & MASK32
    x1 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def PRNGKey(seed: int, device: torch.device | str | None = None
            ) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with x64 off: the seed is a 32-bit
    int, so the key is ``[0, seed mod 2^32]``."""
    seed = int(seed)
    if not -(2 ** 31) <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} does not fit in int32")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


def _counters(shape: tuple[int, ...], device) -> tuple[torch.Tensor, ...]:
    """(hi, lo) words of the 64-bit flat iota over ``shape``."""
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise NotImplementedError("draws of 2^32 or more elements")
    lo = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return torch.zeros_like(lo), lo


def _key_words(key: torch.Tensor, ndim: int):
    """The two key words, shaped to broadcast against ``ndim`` trailing
    draw dims."""
    if key.shape[-1:] != (2,):
        raise ValueError(
            f"keys must have a trailing dim of 2; got {tuple(key.shape)}")
    lead = key.shape[:-1] + (1,) * ndim
    return key[..., 0].reshape(lead), key[..., 1].reshape(lead)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``(..., 2) -> (..., num, 2)``: ``jax.random.split`` per key."""
    k1, k2 = _key_words(key, 1)
    hi, lo = _counters((num,), key.device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` per key: the hash of the
    counter pair ``(0, data mod 2^32)`` under ``key``."""
    k1, k2 = _key_words(key, 0)
    zero = torch.zeros_like(k1)
    b1, b2 = threefry2x32(k1, k2, zero, zero + (int(data) & MASK32))
    return torch.stack([b1, b2], dim=-1)


def bits(key: torch.Tensor, shape: tuple[int, ...] = ()) -> torch.Tensor:
    """32 random bits per element: ``(..., 2) -> (..., *shape)``."""
    shape = tuple(shape)
    k1, k2 = _key_words(key, len(shape))
    if shape:
        hi, lo = _counters(shape, key.device)
    else:
        hi = lo = torch.zeros((), dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: tuple[int, ...] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """float32 uniform on ``[minval, maxval)``, bitwise ``jax.random.
    uniform``: 23 random mantissa bits under exponent 0 give ``[1, 2)``;
    subtract 1, scale by ``maxval - minval`` (an f32), add ``minval``,
    then ``max(minval, .)``.

    XLA contracts the scale-and-shift into one fused multiply-add, so it
    rounds once.  Here the product and the sum are formed in float64
    and rounded once to f32 — the fused result, on every device, with no
    contraction left to the compiler.  Both are exact in float64 when
    ``minval`` and the span lie within a few binades of each other, as
    in every range the envs draw from: a 23-bit fraction times a 24-bit
    span, plus a 24-bit shift, then spans fewer than 53 bits."""
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    mant = (bits(key, shape) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    scaled = (floats.double() * span + float(lo)).float()
    return torch.clamp_min(scaled, float(lo))


def bernoulli(key: torch.Tensor, p: float = 0.5,
              shape: tuple[int, ...] = ()) -> torch.Tensor:
    """``jax.random.bernoulli`` (mode 'low'): ``uniform < p``."""
    return uniform(key, shape) < p


def _mul32(a: torch.Tensor, b: torch.Tensor | int) -> torch.Tensor:
    """``a * b mod 2^32`` for uint32 values held in int64: ``b`` is cut
    into 16-bit halves so that no partial product leaves int64."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def randint(key: torch.Tensor, shape: tuple[int, ...], minval: int,
            maxval: int) -> torch.Tensor:
    """int32 integers in ``[minval, maxval)``, bitwise
    ``jax.random.randint(key, shape, minval, maxval, jnp.int32)``.

    jax draws two 32-bit words per element from ``split(key)`` and folds
    them into the span with uint32 arithmetic that wraps:
    ``((hi % span) * (2^32 % span) + lo % span) % span``, where
    ``2^32 % span`` is formed as ``(2^16 % span)^2 % span``.  Here the
    words are int64 and every product and sum is masked back to 32
    bits, as uint32 would wrap."""
    lo_i32, hi_i32 = -(2 ** 31), 2 ** 31 - 1
    if not (lo_i32 <= minval <= hi_i32 and lo_i32 <= maxval <= hi_i32):
        raise OverflowError(f"randint bounds [{minval}, {maxval}) must fit "
                            "in int32")
    shape = tuple(shape)
    keys = split(key)
    higher = bits(keys[..., 0, :], shape)
    lower = bits(keys[..., 1, :], shape)
    span = (maxval - minval) & MASK32 if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK32) % span
    offset = (_mul32(higher % span, mult) + lower % span) & MASK32
    offset = offset % span
    return (minval + offset).to(torch.int32)


def gumbel(key: torch.Tensor, shape: tuple[int, ...] = ()) -> torch.Tensor:
    """float32 standard Gumbel, ``jax.random.gumbel`` in its default
    'low' mode: ``-log(-log(u))`` with ``u`` uniform on
    ``[tiny, 1)``.  Each ``log`` is taken in float64 and rounded once to
    f32, so the card and the CPU give the same bits; XLA's f32 ``log``
    differs from that in the last bit on about a quarter of draws."""
    tiny = float(np.finfo(np.float32).tiny)

    def log(x: torch.Tensor) -> torch.Tensor:
        return torch.log(x.double()).float()

    return -log(-log(uniform(key, shape, tiny, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis for
    one key: Gumbel-max, ``argmax(logits + gumbel)`` with the noise drawn
    at ``logits.shape`` in ``logits.dtype`` (float32 here)."""
    if logits.dtype != torch.float32:
        raise TypeError(f"categorical wants float32 logits; got "
                        f"{logits.dtype}")
    if key.shape != (2,):
        raise ValueError(f"categorical takes one key; got "
                         f"{tuple(key.shape)}")
    noise = gumbel(key, tuple(logits.shape))
    return torch.argmax(noise + logits, dim=-1)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` for one key, as int64 indices.

    jax shuffles ``arange(n)`` by ``ceil(3 ln(max(1, n)) / ln(2^32 - 1))``
    rounds (0 at n = 1, 1 up to n = 1625, 2 from 1626 to past 2^21); each
    round splits the key, draws 32 bits an element under the second half
    and sorts by them.  Equal 32-bit keys keep their order (the sort is
    stable), which decides the result wherever two of them collide:
    about 32 pairs at n = 524288."""
    if key.shape != (2,):
        raise ValueError(f"permutation takes one key; got {tuple(key.shape)}")
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(MASK32)))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(bits(sub, (n,)), stable=True).indices
        x = x.index_select(0, order)
    return x


# XLA's f32 erf_inv (Giles' single-precision approximation), coefficients
# highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(x.dtype)
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        # one Horner step, fused as XLA fuses it (product exact in f64)
        c = torch.where(lt, c_lt, c_ge).to(x.dtype).double()
        p = (p.double() * w + c).float()
    out = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, out)


def normal(key: torch.Tensor, shape: tuple[int, ...] = ()) -> torch.Tensor:
    """float32 standard normal, ``sqrt(2) * erf_inv(u)`` with ``u``
    uniform on ``(-1, 1)`` exactly as ``jax.random.normal`` draws it."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return _erf_inv(u) * float(np.float32(np.sqrt(2)))


__all__ = [
    "PRNGKey", "bernoulli", "bits", "categorical", "fold_in", "gumbel",
    "normal", "permutation", "randint", "split", "threefry2x32", "uniform",
]
