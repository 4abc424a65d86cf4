"""Inventory-grid interpolation.

The engines hold value functions on per-period inventory grids and linearly
interpolate them at post-decision inventories.  The reference does this with a
per-query binary search (``StorageHelper.BisectInventorySpace``,
``StorageHelper.cs:280-314``) plus linear weights
(``LsmcStorageValuation.cs:722-741``).  The grids are **uniform (linspace)
per period**, so the bracketing index is O(1) arithmetic — ``(x - lo) / step``
— with no search and no data-dependent control flow.  The same arithmetic is
written out in the CUDA kernels (``csrc/storage_kernels.cuh::frac_index``).
"""
from __future__ import annotations

import numpy as np
import torch


def uniform_grids(lo: np.ndarray, hi: np.ndarray, num_points: int) -> np.ndarray:
    """Host: ``[n, G]`` linspace grids for per-period inventory spaces."""
    frac = np.linspace(0.0, 1.0, num_points)
    return lo[:, None] + (hi - lo)[:, None] * frac[None, :]


def fractional_index(x: torch.Tensor, lo, hi, num_points: int):
    """Continuous index of ``x`` on the uniform grid ``linspace(lo, hi, G)``.

    Returns ``(j, w)`` with integer (int64) lower index ``j`` in ``[0, G-2]``
    and weight ``w`` on the upper neighbour; constant grids return ``(0, 0)``.
    Inputs broadcast.
    """
    span = hi - lo
    step = span / (num_points - 1)
    pos = span > 0.0
    t = torch.where(pos, (x - lo) / torch.where(pos, step, torch.ones_like(step)),
                    torch.zeros_like(x))
    j = torch.floor(t).clamp(0, num_points - 2).to(torch.int64)
    w = (t - j.to(t.dtype)).clamp(0.0, 1.0)
    return j, w
