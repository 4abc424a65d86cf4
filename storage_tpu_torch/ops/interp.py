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

import functools

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


@functools.lru_cache(maxsize=8)
def _spline_inverse(num_points: int) -> torch.Tensor:
    """Inverse ``[G, G]`` (float64) of the natural spline's moment system:
    rows ``1 4 1`` inside, identity rows at both ends."""
    a = np.zeros((num_points, num_points))
    a[0, 0] = a[-1, -1] = 1.0
    idx = np.arange(1, num_points - 1)
    a[idx, idx - 1] = 1.0
    a[idx, idx] = 4.0
    a[idx, idx + 1] = 1.0
    return torch.from_numpy(np.linalg.inv(a))


def interp_columns(values: torch.Tensor, j: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of ``values[..., G]`` at fractional indices.

    ``j``/``w`` must broadcast against ``values[..., 0]``'s shape with
    trailing query dims appended — both are gathered along the last axis.
    """
    v_lo = torch.take_along_dim(values, j, dim=-1)
    v_hi = torch.take_along_dim(values, j + 1, dim=-1)
    return v_lo + (v_hi - v_lo) * w


def cubic_spline_moments(values: torch.Tensor, step) -> torch.Tensor:
    """Second-derivative 'moments' of a natural cubic spline on a uniform grid.

    Equivalent of the reference's ``NaturalCubicSplineInterpolatorFactory``
    (flagged there as performing poorly for value-function interpolation —
    provided for parity, linear remains the default).  Solves the standard
    tridiagonal system
    ``M[i-1] + 4 M[i] + M[i+1] = 6 (V[i-1] - 2 V[i] + V[i+1]) / h^2`` with
    natural boundary conditions.  The system's matrix depends on G only, so
    its inverse is formed once on the host in float64 and applied as one
    product; degenerate grids (step == 0) yield zero moments, i.e. linear
    behaviour.

    Args:
      values: ``[..., G]``.
      step: scalar grid spacing (a float or a 0-d tensor).

    Returns moments ``[..., G]``.
    """
    G = values.shape[-1]
    step = torch.as_tensor(step, dtype=values.dtype, device=values.device)
    safe_h = torch.where(step > 0.0, step, torch.ones_like(step))
    rhs = torch.zeros_like(values)
    rhs[..., 1:-1] = (6.0 * (values[..., :-2] - 2.0 * values[..., 1:-1] + values[..., 2:])
                      / safe_h**2)
    moments = rhs @ _spline_inverse(G).to(device=values.device, dtype=values.dtype).T
    return torch.where(step > 0.0, moments, torch.zeros_like(moments))


def interp_columns_cubic(values, moments, j, w, step) -> torch.Tensor:
    """Natural-cubic-spline interpolation of ``values[..., G]`` at fractional
    indices (same gather contract as :func:`interp_columns`)."""
    v_lo = torch.take_along_dim(values, j, dim=-1)
    v_hi = torch.take_along_dim(values, j + 1, dim=-1)
    m_lo = torch.take_along_dim(moments, j, dim=-1)
    m_hi = torch.take_along_dim(moments, j + 1, dim=-1)
    u = 1.0 - w
    h2_over_6 = step**2 / 6.0
    return (v_lo * u + v_hi * w
            + h2_over_6 * ((u**3 - u) * m_lo + (w**3 - w) * m_hi))
