"""A frozen copy of the random numbers the valuation is specified to draw.

The valuation's paths are defined by ``jax.random``'s threefry2x32 generator
in its partitionable bit layout: a key from the seed, ``fold_in`` per 16-step
draw block, the two hash words of each element's counter XORed into 32
random bits, 23 of them as a float32 uniform on [-1, 1), and the normal
``sqrt(2) erfinv(u)``.  This file writes that down in plain integer tensor
arithmetic (int64 masked to 32 bits).  The normal map is the exact
``erfinv`` of the uniform, in the reference's own precision: the program
evaluates XLA's polynomial in float32, which is an implementation of the
same map, not part of its definition.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
DRAW_BLOCK = 16


def threefry2x32(k1: int, k2: int, x1, x2):
    """Threefry-2x32 with 20 rounds (Salmon et al., SC'11) of the counter
    pair ``(x1, x2)`` under the key ``(k1, k2)``; ints or int64 tensors."""
    ks = (k1 & MASK32, k2 & MASK32, (k1 ^ k2 ^ 0x1BD11BDA) & MASK32)
    a, b = (x1 + ks[0]) & MASK32, (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK32
            b = (((b << r) | (b >> (32 - r))) & MASK32) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK32
        b = (b + ks[(i + 2) % 3] + i + 1) & MASK32
    return a, b


def prng_key(seed: int):
    seed = int(seed)
    return (seed >> 32) & MASK32, seed & MASK32


def fold_in(key, data: int):
    return threefry2x32(key[0], key[1], 0, int(data) & MASK32)


def uniform_pm1(key, shape, device) -> torch.Tensor:
    """float32 uniforms on [nextafter(-1, 0), 1): the top 23 of the 32
    random bits of each element as the mantissa of [1, 2), minus one,
    scaled, in float32 arithmetic."""
    size = int(np.prod(shape))
    counts = torch.arange(size, dtype=torch.int64, device=device)
    o1, o2 = threefry2x32(key[0], key[1], 0, counts)
    bits = (o1 ^ o2).reshape(shape)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo = torch.tensor(float(np.nextafter(np.float32(-1.0), np.float32(0.0))),
                      dtype=torch.float32, device=device)
    hi = torch.tensor(1.0, dtype=torch.float32, device=device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def uniform_pm1_64(key, shape, device) -> torch.Tensor:
    """float64 uniforms on [nextafter(-1, 0), 1), the draws of a float64
    valuation: the top 52 bits of the 64-bit word ``o1 << 32 | o2`` as the
    mantissa of [1, 2), minus one, scaled."""
    size = int(np.prod(shape))
    counts = torch.arange(size, dtype=torch.int64, device=device)
    o1, o2 = threefry2x32(key[0], key[1], 0, counts)
    mant = ((o1 << 20) | (o2 >> 12) | 0x3FF0000000000000).reshape(shape)
    floats = mant.view(torch.float64) - 1.0
    lo = float(np.nextafter(-1.0, 0.0))
    return torch.clamp(floats * (1.0 - lo) + lo, min=lo)


def normals(key, shape, device, dtype, draws="float32") -> torch.Tensor:
    """Standard normals ``sqrt(2) erfinv(u)`` of ``dtype`` for the key, from
    the uniforms of a ``draws`` valuation."""
    u = uniform_pm1(key, shape, device) if draws == "float32" else \
        uniform_pm1_64(key, shape, device)
    return torch.erfinv(u.to(dtype)) * math.sqrt(2.0)


def block_normals(key, b0: int, num_factors: int, num_sims: int, antithetic: bool, device,
                  dtype, draws="float32") -> torch.Tensor:
    """The ``[16, F, S]`` normals of the draw block starting at step ``b0``;
    antithetic sets draw half the sims and append their negations."""
    k = fold_in(key, b0)
    if antithetic:
        half = (num_sims + 1) // 2
        z = normals(k, (DRAW_BLOCK, num_factors, half), device, dtype, draws)
        return torch.cat([z, -z], dim=-1)[:, :, :num_sims]
    return normals(k, (DRAW_BLOCK, num_factors, num_sims), device, dtype, draws)
