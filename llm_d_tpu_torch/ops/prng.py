"""Threefry-2x32 random numbers, bit for bit as ``jax.random`` draws them.

The JAX package samples with ``jax.random``'s default PRNG (threefry2x32,
``jax_threefry_partitionable=True``, 32-bit seeds).  The port derives the
same keys and the same Gumbel noise, so a seeded request gives the same
tokens on either package (the vLLM ``seed`` contract, across a mixed
fleet and across a stream resume).

A key is a pair ``(k0, k1)`` of unsigned 32-bit words.  Each word is a
Python ``int`` (the engine's per-step key: splitting it costs no device
work) or an int64 tensor holding the word (one key per row, on any
device); the arithmetic is the same code for both, in int64 masked to 32
bits, because ``torch.uint32`` lacks shifts and adds on CUDA in some
builds.

* ``prng_key(seed)`` is ``jax.random.PRNGKey(seed)``: ``(0, seed mod
  2**32)``.
* ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``, and ``split(key,
  n)[i]`` is ``fold_in(key, i)`` (the partitionable split).
* ``random_bits(key, n)`` hashes the counters ``(0, i)``, i < n, and XORs
  the two output words; ``uniform`` turns them into [0, 1) with the
  mantissa trick ``(bits >> 9) | 0x3F800000`` minus 1, and ``gumbel``
  does the same, clamps at ``finfo.tiny`` and takes ``-log(-log(u))``.

The logarithm is the one XLA's CPU backend emits (Cephes' polynomial with
its split ln 2, evaluated by fused multiply-adds), written out in f32
operations and exact f32 multiply-adds so that the CPU and the card round
alike; ``torch.log`` differs from it in the last bit for many inputs.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import torch

Word = Union[int, torch.Tensor]
Key = Tuple[Word, Word]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(key: Key, x0: Word, x1: Word) -> Key:
    """The threefry-2x32 hash of the counter pair ``(x0, x1)`` under
    ``key``, 20 rounds (words broadcast like tensors)."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` with 32-bit integers."""
    return 0, int(seed) & _M32


def fold_in(key: Key, data: Word) -> Key:
    """``jax.random.fold_in``: ``data`` is taken as an unsigned 32-bit
    word (an int32 tensor's bits)."""
    if isinstance(data, torch.Tensor):
        data = data.long()
    return threefry2x32(key, 0, data & _M32)


def split(key: Key, num: int = 2) -> List[Key]:
    """``jax.random.split`` (partitionable): key ``i`` is
    ``fold_in(key, i)``."""
    return [fold_in(key, i) for i in range(num)]


def random_bits(key: Key, n: int, device=None) -> torch.Tensor:
    """32 random bits ``[..., n]`` (int64) per key of shape ``[...]``
    (``jax.random.bits`` at uint32; for a shape of several dimensions
    the bits of its row-major flattening), on the keys' device or, for a
    key of ints, on ``device``."""
    k0, k1 = key
    dev = k0.device if isinstance(k0, torch.Tensor) else device
    counts = torch.arange(n, dtype=torch.int64, device=dev)
    k0 = k0[..., None] if isinstance(k0, torch.Tensor) else k0
    k1 = k1[..., None] if isinstance(k1, torch.Tensor) else k1
    o0, o1 = threefry2x32((k0, k1), 0, counts)
    return o0 ^ o1


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
             ) -> torch.Tensor:
    """``a * b + c`` of f32 tensors with one rounding.  The product is
    exact in f64; the f64 sum is rounded to odd (its exact error, by
    TwoSum, moves an even last bit one step toward the exact value),
    which makes the final f32 rounding the correct one."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    bits = s.view(torch.int64)
    away = (err != 0) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    s = torch.where(away, bits + step, bits).view(torch.float64)
    return s.float()


_F32_TINY = torch.finfo(torch.float32).tiny
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive finite f32 ``x`` as XLA's CPU backend
    computes it (inputs below the least normal are raised to it)."""
    f32 = torch.float32

    def c(v):
        # A fill, not a host-to-device copy: a captured graph may hold it.
        return torch.full((), v, dtype=f32, device=x.device)

    x = torch.maximum(x.float(), c(_F32_TINY))
    bits = x.view(torch.int32)
    frac = ((bits & 0x007FFFFF) | 0x3F000000).view(f32)     # [0.5, 1)
    e = (bits >> 23).to(f32) - 126.0
    low = frac < c(0.707106781186547524)
    e = e - low.to(f32)
    x = (frac - 1.0) + torch.where(low, frac, c(0.0))
    x2 = x * x
    x3 = x2 * x
    p = [c(v) for v in _LOG_P]
    y = _fma_f32(x, p[0], p[1])
    y1 = _fma_f32(x, p[3], p[4])
    y2 = _fma_f32(x, p[6], p[7])
    y = _fma_f32(y, x, p[2])
    y1 = _fma_f32(y1, x, p[5])
    y2 = _fma_f32(y2, x, p[8])
    y = _fma_f32(y, x3, y1)
    y = _fma_f32(y, x3, y2)
    y = _fma_f32(y, x3, e * c(-2.12194440e-4))
    x = x - x2 * 0.5
    x = x + y
    return x + e * c(0.693359375)


def _one_to_two(bits: torch.Tensor) -> torch.Tensor:
    """f32 in [1, 2) from the top 23 of 32-bit words."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(minval=tiny, maxval=1)`` from 32-bit words."""
    u = (_one_to_two(bits) - 1.0) + _F32_TINY  # (1 - tiny) rounds to 1
    return torch.clamp_min(u, _F32_TINY)


def uniform(key: Key, n: int, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32)`` (range [0, 1)): ``[...,
    n]`` f32 per key of shape ``[...]``."""
    return _one_to_two(random_bits(key, n, device)) - 1.0


def gumbel(key: Key, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` for each key of shape
    ``[...]``: ``[..., n]`` f32."""
    u = uniform_from_bits(random_bits(key, n))
    return -xla_log(-xla_log(u))
