"""Intrinsic storage valuation.

Deterministic dynamic program on the forward curve only — no stochasticity.
Reference: ``IntrinsicStorageValuation<T>.Calculate``
(``IntrinsicValuation/IntrinsicStorageValuation.cs:120-322``) and the Python
wrapper ``intrinsic_value`` (``cmdty_storage/intrinsic.py:42-111``).

The backward induction runs in float32 torch ops on the valuation's device,
with the inventory-grid dimension vectorised, bang-bang decision sets in
fixed width and O(1) uniform-grid interpolation of the continuation value.
The forward sweep (one scalar inventory path through the saved value
functions) runs on the host in float64.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import pandas as pd
import torch

from ..compile import ValuationContext
from ..exceptions import not_ported
from ..ops.decisions import bang_bang_decision_set, max_value_and_index
from ..ops.interp import fractional_index
from ..ops.ratchets import interp_rates_host
from .common import step_economics

PROFILE_COLUMNS = [
    "inventory",
    "inject_withdraw_volume",
    "cmdty_consumed",
    "inventory_loss",
    "net_volume",
    "period_pv",
]


class IntrinsicValuationResults(NamedTuple):
    """NPV + storage profile (reference ``intrinsic.py:37-39``)."""

    npv: float
    profile: pd.DataFrame


def _backward_values(ctx: ValuationContext, terminal_values: np.ndarray, extra_decisions: int,
                     device) -> np.ndarray:
    """Backward induction (reference backward loop
    ``IntrinsicStorageValuation.cs:191-216``); returns the value function
    ``[n+1, G]`` on each period's grid."""
    n = ctx.n_steps
    G = ctx.num_grid_points

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32).to(device)

    grids, lo, hi, pillars = (t(ctx.grids), t(ctx.inv_space.min_inventory),
                              t(ctx.inv_space.max_inventory), t(ctx.pillars[..., :3]))
    loss, ic, wc, ci, cw, icr, dfs, df0, fwd = (t(a) for a in (
        ctx.inventory_loss, ctx.inject_cost, ctx.withdraw_cost, ctx.cons_inject,
        ctx.cons_withdraw, ctx.inventory_cost_rate, ctx.df_settle, ctx.df_cost, ctx.fwd))
    values = torch.empty((n + 1, G), dtype=torch.float32, device=device)
    values[n] = t(terminal_values)
    for k in range(n - 1, -1, -1):
        econ = step_economics(
            grids[k], pillars[k], ctx.interp_kind, loss[k], lo[k + 1], hi[k + 1], ic[k], wc[k],
            ci[k], cw[k], icr[k], dfs[k], df0[k], extra_decisions,
        )
        j, w = fractional_index(econ.inventory_after, lo[k + 1], hi[k + 1], G)
        v_next = values[k + 1]
        cont = v_next[j] * (1.0 - w) + v_next[j + 1] * w
        values[k] = (econ.immediate_npv(fwd[k]) + cont).max(dim=-1).values  # [G]
    return values.cpu().numpy()


def _forward_sweep(ctx: ValuationContext, values: np.ndarray, extra_decisions: int = 0):
    """Forward pass choosing optimal decisions from the starting inventory.

    Host float64 re-derivation of the optimal policy against the device value
    functions (reference ``IntrinsicStorageValuation.cs:218-259``).  The
    continuation is evaluated with the SAME interpolator the backward DP used
    (the reference applies its configured interpolator factory in both
    passes): linear.
    """
    n = ctx.n_steps
    rows = np.zeros((n + 1, len(PROFILE_COLUMNS)), dtype=np.float64)
    inv = ctx.inventory
    for k in range(n):
        min_rate, max_rate = interp_rates_host(
            ctx.storage.pillar_tables[
                (ctx.periods[0] - ctx.storage.start).n + k
            ],
            inv,
            ctx.interp_kind,
        )
        loss = float(ctx.inventory_loss[k]) * inv
        decisions = bang_bang_decision_set(
            min_rate, max_rate, inv, loss,
            float(ctx.inv_space.min_inventory[k + 1]),
            float(ctx.inv_space.max_inventory[k + 1]),
            ctx.numerical_tolerance,
            extra_decisions,
        )
        grid_next = ctx.grids[k + 1]
        v_next = values[k + 1]
        price = float(ctx.fwd[k])
        d_arr = np.asarray(decisions, dtype=np.float64)
        inv_after = inv + d_arr - loss
        cont = np.interp(inv_after, grid_next, v_next)
        abs_d = np.abs(d_arr)
        inject = d_arr > 0.0
        consumed_arr = np.where(
            inject, float(ctx.cons_inject[k]) * abs_d, float(ctx.cons_withdraw[k]) * abs_d
        )
        iw_cost = np.where(
            inject, float(ctx.inject_cost[k]) * abs_d, float(ctx.withdraw_cost[k]) * abs_d
        )
        inv_cost = float(ctx.inventory_cost_rate[k]) * inv
        period_pvs = (
            -(d_arr + consumed_arr) * price * float(ctx.df_settle[k])
            - (iw_cost + inv_cost) * float(ctx.df_cost[k])
        )
        totals = period_pvs + cont
        _, best = max_value_and_index(totals)
        d_opt = float(decisions[best])
        inv = inv + d_opt - loss
        net_volume = -d_opt - consumed_arr[best]
        rows[k] = (inv, d_opt, consumed_arr[best], loss, net_volume, period_pvs[best])

    # End-period row: no decision; terminal PV if the storage can hold inventory
    # (IntrinsicStorageValuation.cs:230-234).
    end_pv = 0.0
    if not ctx.storage.must_be_empty_at_end:
        end_pv = ctx.storage.terminal_storage_npv(float(ctx.fwd[n]), inv)
    rows[n] = (inv, 0.0, 0.0, 0.0, 0.0, end_pv)
    return rows


def intrinsic_value_with_ctx(
    ctx: ValuationContext, extra_decisions: int = 0, interpolation: str = "linear",
    device=None,
) -> IntrinsicValuationResults:
    """Intrinsic valuation on an already-compiled context (the LSMC entry point
    shares one context build between both engines)."""
    if interpolation != "linear":
        raise not_ported("Cubic-spline intrinsic interpolation", "Queue 1 item 2")
    n = ctx.n_steps
    grid_end = ctx.grids[n]
    if ctx.storage.terminal_npv_fn is None:
        terminal = np.zeros_like(grid_end)
    else:
        terminal = np.asarray(ctx.storage.terminal_npv_fn(ctx.fwd[n], grid_end), dtype=np.float64)
        terminal = np.broadcast_to(terminal, grid_end.shape)
    values = _backward_values(ctx, terminal, extra_decisions, device)
    rows = _forward_sweep(ctx, np.asarray(values, dtype=np.float64), extra_decisions)
    npv = float(rows[:, PROFILE_COLUMNS.index("period_pv")].sum())
    profile = pd.DataFrame(rows, columns=PROFILE_COLUMNS, index=ctx.periods)
    return IntrinsicValuationResults(npv, profile)
