"""Decision economics shared by all valuation engines.

Centralises the immediate-NPV arithmetic of
``StorageHelper.StorageImmediateNpvForDecision`` (``StorageHelper.cs:224-248``)
and the engines' inlined copies (``LsmcStorageValuation.cs:304-330``,
``IntrinsicStorageValuation.cs:291-322``) in branch-free torch form:

    immediate_npv(d) = -d * price * df_settle                (buy/sell cmdty)
                       - cost_rate(d) * |d| * df_start       (inject/withdraw fee)
                       - consumed(d) * price * df_settle     (fuel consumed)
                       - inv_cost_rate * inventory * df_start (inventory cost)

where cash-flow timing follows the reference defaults: commodity flows settle
on the settlement-rule date, cost cash flows fall on the period's first day
(``CmdtyStorage.cs:334-341, 390-397, 552-557``).  Decision volumes exclude
consumed volumes, which are bought in the market
(note at ``StorageHelper.cs:242``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.decisions import bang_bang_decisions_fixed
from ..ops.ratchets import interp_rates


class StepEconomics(NamedTuple):
    """Per-decision quantities for one period, broadcast over the decision axis."""

    decisions: torch.Tensor  # feasible inject/withdraw volumes [..., D]
    inventory_after: torch.Tensor  # inventory after decision and loss [..., D]
    consumed: torch.Tensor  # cmdty volume consumed by the decision [..., D]
    cost_npv: torch.Tensor  # discounted inject/withdraw + inventory cost [..., D]
    price_coeff: torch.Tensor  # coefficient on the (simulated) price [..., D]

    def immediate_npv(self, price):
        """Immediate NPV for a given spot price (broadcasts)."""
        return self.price_coeff * price + (-self.cost_npv)


def step_economics(
    inventory,
    pillars,
    interp_kind: int,
    loss_rate,
    next_min,
    next_max,
    inject_cost,
    withdraw_cost,
    cons_inject,
    cons_withdraw,
    inv_cost_rate,
    df_settle,
    df_start,
    extra_decisions: int = 0,
) -> StepEconomics:
    """Fixed-width decision set + per-decision economics at ``inventory``.

    ``inventory`` may be any shape (grid points, simulations, ...); the
    decision axis is appended last.  Per-step scalars are tensors that
    broadcast against ``inventory`` (0-d for one period, ``[m, 1]`` against
    ``[m, G]`` grids of m periods).
    """
    min_rate, max_rate = interp_rates(pillars, inventory, interp_kind)
    inv_loss = loss_rate * inventory
    decisions = bang_bang_decisions_fixed(
        min_rate, max_rate, inventory, inv_loss, next_min, next_max, extra_decisions
    )
    inv_after = inventory[..., None] + decisions - inv_loss[..., None]

    is_inject = decisions > 0.0
    abs_d = decisions.abs()
    consumed = torch.where(is_inject, cons_inject[..., None] * abs_d,
                           cons_withdraw[..., None] * abs_d)
    iw_cost = torch.where(is_inject, inject_cost[..., None] * abs_d,
                          withdraw_cost[..., None] * abs_d)
    inv_cost = (inv_cost_rate * inventory)[..., None]
    cost_npv = (iw_cost + inv_cost) * df_start[..., None]
    # -(d + consumed) * price * df_settle
    price_coeff = -(decisions + consumed) * df_settle[..., None]
    return StepEconomics(decisions, inv_after, consumed, cost_npv, price_coeff)
