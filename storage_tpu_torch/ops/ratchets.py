"""Inject/withdraw ratchet-rate lookup.

The reference dispatches on constraint class per period
(``ConstantInjectWithdrawConstraint`` / ``PiecewiseLinearInjectWithdrawConstraint`` /
``StepInjectWithdrawConstraint``; ``InjectWithdrawConstraints/*.cs``).  The
engines use a single dense pillar tensor ``[num_steps, P, 3]`` of
``(inventory, min_rate, max_rate)`` rows, padded by repeating the final pillar,
plus one interpolation mode for the whole storage.  Rate lookup is then a
branch-free gather/interp over any batch of inventories.

Host half (NumPy, float64): the interp constants, :func:`interp_rates_host`
and :func:`pad_pillars`.  Device half (torch): :func:`interp_rates`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..exceptions import not_ported

INTERP_LINEAR = 0  # piecewise-linear in inventory (reference PiecewiseLinear)
INTERP_STEP = 1  # piecewise-constant, floor lookup (reference Step)
INTERP_POLY = 2  # exact-fit polynomial (reference PolynomialInjectWithdrawConstraint)


def interp_rates(pillars: torch.Tensor, inventory: torch.Tensor, interp_kind: int):
    """Min/max inject-withdraw rates at ``inventory``.

    Args:
      pillars: ``[*batch, P, 3]`` tensor of (inventory, min_rate, max_rate)
        rows, sorted ascending by inventory and padded by repeating the last
        row.  The batch dimensions (periods, say) lead ``inventory``'s.
      inventory: tensor of shape ``[*batch, *query]``.
      interp_kind: INTERP_LINEAR or INTERP_STEP.

    Returns ``(min_rate, max_rate)`` with the shape of ``inventory``.

    Linear mode mirrors MathNet's ``LinearSpline`` over the pillar points
    (reference ``PiecewiseLinearInjectWithdrawConstraint.cs:67-72``); step mode
    mirrors the floor binary search (``StepInjectWithdrawConstraint.cs:72-79``).
    Out-of-range inventories clamp to the boundary pillar.
    """
    if interp_kind == INTERP_POLY:
        raise not_ported("POLY ratchet interpolation", "Queue 1 item 2")
    num_pillars = pillars.shape[-2]
    query_dims = inventory.dim() - (pillars.dim() - 2)
    shape = pillars.shape[:-2] + (1,) * query_dims + (num_pillars,)
    pillar_inv, pillar_min, pillar_max = (pillars[..., c].reshape(shape) for c in range(3))

    def take(vals, i):
        return torch.take_along_dim(vals, i[..., None], dim=-1)[..., 0]

    # Index of the segment whose lower pillar is <= inventory.
    idx = (pillar_inv <= inventory[..., None]).sum(dim=-1) - 1
    if interp_kind == INTERP_STEP:
        idx = idx.clamp(0, num_pillars - 1)
        return take(pillar_min, idx), take(pillar_max, idx)

    lo = idx.clamp(0, max(num_pillars - 2, 0))
    hi = (lo + 1).clamp(max=num_pillars - 1)
    inv_lo = take(pillar_inv, lo)
    seg = take(pillar_inv, hi) - inv_lo
    pos = seg > 0.0
    w = torch.where(pos, (inventory - inv_lo) / torch.where(pos, seg, torch.ones_like(seg)),
                    torch.zeros_like(seg))
    w = w.clamp(0.0, 1.0)

    def lerp(vals):
        v_lo = take(vals, lo)
        return v_lo + (take(vals, hi) - v_lo) * w

    return lerp(pillar_min), lerp(pillar_max)


def interp_rates_host(pillars: np.ndarray, inventory: float, interp_kind: int):
    """Host (NumPy, float64) single-point version of :func:`interp_rates`.

    Used by the inventory-space reduction, which runs once per valuation on the
    host (reference call site ``LsmcStorageValuation.cs:88``).
    """
    inv = pillars[:, 0]
    if interp_kind == INTERP_POLY:
        cmin = pillars[:, 3]
        cmax = pillars[:, 4]
        return float(np.polyval(cmin, inventory)), float(np.polyval(cmax, inventory))
    if interp_kind == INTERP_STEP:
        idx = int(np.searchsorted(inv, inventory, side="right")) - 1
        idx = min(max(idx, 0), len(inv) - 1)
        return float(pillars[idx, 1]), float(pillars[idx, 2])
    min_rate = float(np.interp(inventory, inv, pillars[:, 1]))
    max_rate = float(np.interp(inventory, inv, pillars[:, 2]))
    return min_rate, max_rate


def pad_pillars(tables, num_pillars: int | None = None) -> np.ndarray:
    """Stack per-step pillar tables ``[(P_k, C)]`` into ``[n, P, C]``.

    Columns are (inventory, min_rate, max_rate[, min_poly_coef, max_poly_coef]).
    Shorter tables pad the first three columns by repeating the last row (a
    no-op for rate lookup and bound solving) and any polynomial-coefficient
    columns with zeros (a no-op for Horner evaluation, which is degree-ordered
    highest first over the full padded height).
    """
    arrays = [np.asarray(t, dtype=np.float64) for t in tables]
    ncols = arrays[0].shape[1]
    max_p = num_pillars or max(a.shape[0] for a in arrays)
    out = np.zeros((len(arrays), max_p, ncols), dtype=np.float64)
    for k, a in enumerate(arrays):
        if a.shape[0] > max_p:
            raise ValueError("num_pillars smaller than a provided pillar table.")
        pad = max_p - a.shape[0]
        if ncols > 3 and pad:
            # Keep Horner order: the real table goes at the BOTTOM (so the
            # zero-padded COEFFICIENT rows above it are the highest powers)
            # and the padding's geometry columns repeat the FIRST geometry
            # row at the top — the inverse of the non-poly branch below.
            out[k, pad:, :] = a
            out[k, :pad, :3] = a[0, :3]
        else:
            out[k, : a.shape[0]] = a
            if pad:
                out[k, a.shape[0]:] = a[-1]
    return out
