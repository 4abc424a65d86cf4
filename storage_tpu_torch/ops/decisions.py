"""Bang-bang decision sets.

The reference computes a variable-length decision set per (period, inventory):
clipped {max-withdraw, 0, max-inject} plus ``extra_decisions`` equally-spaced
intermediate rates per side (``StorageHelper.CalculateBangBangDecisionSet``,
``StorageHelper.cs:109-204``).  The engines always use a fixed width
``2*extra + 3``; when the feasible range does not span zero (forced
injection/withdrawal) the missing zero decision and its side's extras are
replaced by duplicates of existing decisions, which leave the argmax over
decisions unchanged.

- :func:`bang_bang_decision_set` — exact host-side NumPy version with the
  reference's variable-length output and error behaviour.
- :func:`bang_bang_decisions_fixed` — fixed-width torch version used inside the
  valuation engines.
- :func:`clipped_decision_bounds` — the clipping both share with the forward
  CUDA kernel (``csrc/storage_kernels.cuh::clipped_decision_bounds`` is the
  same arithmetic, statement for statement).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def clipped_decision_bounds(
    min_rate,
    max_rate,
    inventory,
    inventory_loss,
    next_step_min_inventory,
    next_step_max_inventory,
):
    """Feasible (withdraw, inject) rates after clipping to next-step inventory bounds.

    Vectorised translation of the yield logic in ``StorageHelper.cs:117-165``.
    Where the reference throws when the constraint breach exceeds the numerical
    tolerance, this always clamps (the host-side inventory-space reduction has
    already validated feasibility; residual breaches are tolerance-level
    root-finding noise).
    """
    inv_after_loss = inventory - inventory_loss

    inv_after_max_withdraw = min_rate + inv_after_loss
    yielded_withdraw = torch.where(
        inv_after_max_withdraw > next_step_max_inventory,
        next_step_max_inventory - inv_after_loss,
        torch.where(
            inv_after_max_withdraw > next_step_min_inventory,
            min_rate,
            next_step_min_inventory - inv_after_loss,
        ),
    )

    inv_after_max_inject = max_rate + inv_after_loss
    yielded_inject = torch.where(
        inv_after_max_inject < next_step_min_inventory,
        next_step_min_inventory - inv_after_loss,
        torch.where(
            inv_after_max_inject < next_step_max_inventory,
            max_rate,
            next_step_max_inventory - inv_after_loss,
        ),
    )
    return yielded_withdraw, yielded_inject


def bang_bang_decisions_fixed(
    min_rate,
    max_rate,
    inventory,
    inventory_loss,
    next_step_min_inventory,
    next_step_max_inventory,
    extra_decisions: int = 0,
):
    """Fixed-width decision set of size ``2*extra_decisions + 3``.

    When the clipped range spans zero the layout is
    ``[withdraw, extras..., 0, extras..., inject]`` exactly as the reference
    builds it (``StorageHelper.cs:180-192``).  Otherwise the reference's
    ``extra + 2``-wide set ``[withdraw, extras..., inject]`` is padded to full
    width by repeating the inject decision — duplicates are argmax-neutral.

    All inputs broadcast; the decision axis is appended last.
    """
    extra = int(extra_decisions)
    if extra < 0:
        raise ValueError("extra_decisions must be non-negative.")
    yw, yi = clipped_decision_bounds(
        min_rate, max_rate, inventory, inventory_loss,
        next_step_min_inventory, next_step_max_inventory,
    )
    yw, yi = torch.broadcast_tensors(yw, yi)
    has_zero = (yw < 0.0) & (yi > 0.0)

    # Per-slot weights, the same float64 host constants as the reference
    # build, applied in the working dtype.
    side = np.linspace(0.0, 1.0, extra + 2)
    zero_w_weight = 1.0 - np.concatenate([side[:-1], np.zeros(1), np.zeros(extra + 1)])
    zero_w_weight[extra + 1:] = 0.0
    zero_i_weight = np.concatenate([np.zeros(extra + 1), np.zeros(1), side[1:]])
    nspan_frac = np.concatenate([np.linspace(0.0, 1.0, extra + 2), np.ones(extra + 1)])

    def const(a):
        return torch.as_tensor(a, dtype=yw.dtype, device=yw.device)

    yw_e = yw[..., None]
    yi_e = yi[..., None]
    zero_set = yw_e * const(zero_w_weight) + yi_e * const(zero_i_weight)
    nspan_set = yw_e * const(1.0 - nspan_frac) + yi_e * const(nspan_frac)
    return torch.where(has_zero[..., None], zero_set, nspan_set)


def bang_bang_decision_set(
    min_rate: float,
    max_rate: float,
    inventory: float,
    inventory_loss: float,
    next_step_min_inventory: float,
    next_step_max_inventory: float,
    numerical_tolerance: float,
    extra_decisions: int = 0,
) -> np.ndarray:
    """Exact variable-length decision set, matching the reference host semantics.

    Reference: ``StorageHelper.CalculateBangBangDecisionSet``
    (``StorageHelper.cs:109-197``) including its tolerance/exception behaviour.
    """
    if next_step_min_inventory > next_step_max_inventory:
        raise ValueError(
            "next_step_min_inventory value cannot be higher than next_step_max_inventory value."
        )
    if extra_decisions < 0:
        raise ValueError("extra_decisions must be non-negative.")

    inv_after_loss = inventory - inventory_loss

    inv_after_max_withdraw = min_rate + inv_after_loss
    if inv_after_max_withdraw > next_step_max_inventory:
        if inv_after_max_withdraw - next_step_max_inventory < numerical_tolerance:
            yielded_withdraw = next_step_max_inventory - inv_after_loss
        else:
            raise ValueError(
                "Inventory constraints cannot be fulfilled. This could potentially be "
                "fixed by increasing the numerical tolerance."
            )
    elif inv_after_max_withdraw > next_step_min_inventory:
        yielded_withdraw = min_rate
    else:
        yielded_withdraw = next_step_min_inventory - inv_after_loss

    inv_after_max_inject = max_rate + inv_after_loss
    if inv_after_max_inject < next_step_min_inventory:
        if next_step_min_inventory - inv_after_max_inject < numerical_tolerance:
            yielded_inject = next_step_min_inventory - inv_after_loss
        else:
            raise ValueError(
                "Inventory constraints cannot be fulfilled. This could potentially be "
                "fixed by increasing the numerical tolerance."
            )
    elif inv_after_max_inject < next_step_max_inventory:
        yielded_inject = max_rate
    else:
        yielded_inject = next_step_max_inventory - inv_after_loss

    def extras(lo: float, hi: float) -> np.ndarray:
        increment = (hi - lo) / (extra_decisions + 1)
        return lo + increment * np.arange(1, extra_decisions + 1)

    if yielded_withdraw >= 0.0 or yielded_inject <= 0.0:  # no zero decision
        return np.concatenate(
            [[yielded_withdraw], extras(yielded_withdraw, yielded_inject), [yielded_inject]]
        )
    return np.concatenate(
        [
            [yielded_withdraw],
            extras(yielded_withdraw, 0.0),
            [0.0],
            extras(0.0, yielded_inject),
            [yielded_inject],
        ]
    )


def max_value_and_index(values: np.ndarray) -> Tuple[float, int]:
    """First-occurrence argmax, reference ``StorageHelper.MaxValueAndIndex``
    (``StorageHelper.cs:206-221``)."""
    idx = int(np.argmax(values))
    return float(values[idx]), idx
