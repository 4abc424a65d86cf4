"""Intrinsic storage valuation.

Deterministic dynamic program on the forward curve only — no stochasticity.
Reference: ``IntrinsicStorageValuation<T>.Calculate``
(``IntrinsicValuation/IntrinsicStorageValuation.cs:120-322``) and the Python
wrapper ``intrinsic_value`` (``cmdty_storage/intrinsic.py:42-111``).

The backward induction runs in float32 torch ops on the valuation's device,
with the inventory-grid dimension vectorised, bang-bang decision sets in
fixed width and O(1) uniform-grid interpolation of the continuation value.
The forward sweep (one scalar inventory path through the saved value
functions) runs on the host in float64.  ``interpolation="cubic"``
interpolates the continuation with a natural cubic spline in both passes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import pandas as pd
import torch

from ..compile import SettlementRule, ValuationContext, build_valuation_context
from ..exceptions import InventoryConstraintsCannotBeFulfilledError, not_ported
from ..ops.decisions import bang_bang_decision_set, max_value_and_index
from ..ops.interp import cubic_spline_moments, fractional_index, interp_columns_cubic
from ..ops.ratchets import interp_rates_host
from ..storage import CmdtyStorage
from ..utils.discount import DiscountFn
from ..utils.frequencies import PeriodLike, normalize_freq, to_period
from .common import step_economics

PROFILE_COLUMNS = [
    "inventory",
    "inject_withdraw_volume",
    "cmdty_consumed",
    "inventory_loss",
    "net_volume",
    "period_pv",
]


_GEOMETRY_CHUNK = 4096  # periods whose decision geometry is computed at once


class IntrinsicValuationResults(NamedTuple):
    """NPV + storage profile (reference ``intrinsic.py:37-39``)."""

    npv: float
    profile: pd.DataFrame


def _empty_profile(freq: str) -> pd.DataFrame:
    return pd.DataFrame(
        {c: [] for c in PROFILE_COLUMNS}, index=pd.PeriodIndex([], freq=freq)
    )


def _backward_values(ctx: ValuationContext, terminal_values: np.ndarray, extra_decisions: int,
                     device, cubic: bool = False) -> np.ndarray:
    """Backward induction (reference backward loop
    ``IntrinsicStorageValuation.cs:191-216``); returns the value function
    ``[n+1, G]`` on each period's grid.  ``cubic`` interpolates the
    continuation with a natural cubic spline (reference
    ``WithCubicSplineInventorySpaceInterpolation``); linear is the default
    and recommended, matching the reference's own warning."""
    n = ctx.n_steps
    G = ctx.num_grid_points

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32).to(device)

    grids, lo, hi, pillars = (t(ctx.grids), t(ctx.inv_space.min_inventory),
                              t(ctx.inv_space.max_inventory), t(ctx.pillars))
    loss, ic, wc, ci, cw, icr, dfs, df0, fwd = (t(a) for a in (
        ctx.inventory_loss, ctx.inject_cost, ctx.withdraw_cost, ctx.cons_inject,
        ctx.cons_withdraw, ctx.inventory_cost_rate, ctx.df_settle, ctx.df_cost, ctx.fwd))
    values = torch.empty((n + 1, G), dtype=torch.float32, device=device)
    values[n] = t(terminal_values)
    # The decision geometry and the immediate NPVs depend on no value
    # function, so they are computed for _GEOMETRY_CHUNK periods at once (a
    # few dozen launches per chunk instead of per period); only the gather of
    # the continuation and the max walk the periods one by one.
    for b in range(n, 0, -_GEOMETRY_CHUNK):
        a = max(0, b - _GEOMETRY_CHUNK)
        lo_c, hi_c = lo[a + 1:b + 1, None], hi[a + 1:b + 1, None]
        econ = step_economics(
            grids[a:b], pillars[a:b], ctx.interp_kind, loss[a:b, None], lo_c, hi_c,
            ic[a:b, None], wc[a:b, None], ci[a:b, None], cw[a:b, None], icr[a:b, None],
            dfs[a:b, None], df0[a:b, None], extra_decisions,
        )  # [c, G, D]
        j, w = fractional_index(econ.inventory_after, lo_c[..., None], hi_c[..., None], G)
        j_hi, w_lo = j + 1, 1.0 - w
        immediate = econ.immediate_npv(fwd[a:b, None, None])
        h = (hi[a + 1:b + 1] - lo[a + 1:b + 1]) / (G - 1)
        for k in range(b - 1, a - 1, -1):
            i = k - a
            v_next = values[k + 1]
            if cubic:
                moments = cubic_spline_moments(v_next, h[i])
                cont = interp_columns_cubic(v_next.expand(G, G), moments.expand(G, G), j[i],
                                            w[i], h[i])
            else:
                cont = v_next[j[i]] * w_lo[i] + v_next[j_hi[i]] * w[i]
            values[k] = (immediate[i] + cont).max(dim=-1).values  # [G]
    return values.cpu().numpy()


def _host_cubic_moments(y: np.ndarray, h: float) -> np.ndarray:
    """Float64 host mirror of ``ops.interp.cubic_spline_moments`` (natural
    boundary conditions, uniform grid)."""
    G = len(y)
    rhs = np.zeros(G)
    rhs[1:-1] = 6.0 * (y[:-2] - 2.0 * y[1:-1] + y[2:]) / h**2
    A = np.zeros((G, G))
    A[0, 0] = A[-1, -1] = 1.0
    idx = np.arange(1, G - 1)
    A[idx, idx - 1] = 1.0
    A[idx, idx] = 4.0
    A[idx, idx + 1] = 1.0
    return np.linalg.solve(A, rhs)


def _host_cubic_eval(x0: float, h: float, y: np.ndarray, m: np.ndarray, xq: float) -> float:
    t = (xq - x0) / h
    j = int(np.clip(np.floor(t), 0, len(y) - 2))
    w = float(np.clip(t - j, 0.0, 1.0))
    u = 1.0 - w
    return float(
        y[j] * u + y[j + 1] * w
        + h * h / 6.0 * ((u**3 - u) * m[j] + (w**3 - w) * m[j + 1])
    )


def _forward_sweep(ctx: ValuationContext, values: np.ndarray, extra_decisions: int = 0,
                   interpolation: str = "linear"):
    """Forward pass choosing optimal decisions from the starting inventory.

    Host float64 re-derivation of the optimal policy against the device value
    functions (reference ``IntrinsicStorageValuation.cs:218-259``).  The
    continuation is evaluated with the SAME interpolator the backward DP used
    (the reference applies its configured interpolator factory in both
    passes); with ``interpolation='cubic'`` that is the natural cubic spline.
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
        h_next = (grid_next[-1] - grid_next[0]) / max(len(grid_next) - 1, 1)
        use_cubic = interpolation == "cubic" and len(v_next) >= 3 and h_next > 0.0
        price = float(ctx.fwd[k])
        d_arr = np.asarray(decisions, dtype=np.float64)
        inv_after = inv + d_arr - loss
        if use_cubic:
            moments_next = _host_cubic_moments(v_next, h_next)
            cont = np.array([
                _host_cubic_eval(float(grid_next[0]), h_next, v_next, moments_next, q)
                for q in inv_after
            ])
        else:
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


def intrinsic_value(
    cmdty_storage: CmdtyStorage,
    val_date: PeriodLike,
    inventory: Union[float, int],
    forward_curve: pd.Series,
    interest_rates: Union[None, float, pd.Series, DiscountFn],
    settlement_rule: Optional[SettlementRule],
    num_inventory_grid_points: int = 100,
    numerical_tolerance: float = 1e-12,
    extra_decisions: int = 0,
    dtype=torch.float32,
    interpolation: str = "linear",
    device="cuda",
) -> IntrinsicValuationResults:
    """Intrinsic value of commodity storage (reference ``intrinsic.py:42-66``).

    ``interpolation``: 'linear' (default, reference
    ``WithLinearInventorySpaceInterpolation``) or 'cubic' (natural cubic
    spline, reference ``WithCubicSplineInventorySpaceInterpolation`` — which
    the reference itself warns performs poorly).

    Args:
      settlement_rule: maps each delivery ``pd.Period`` to its settlement date;
        ``None`` settles on the period start day (undiscounted within period).
      dtype: only float32 runs (the JAX package's float64 DP is not ported).
      device: where the float32 backward DP runs.
    """
    if dtype != torch.float32:
        raise not_ported(f"dtype={dtype} (only float32 runs)", "Queue 1 item 12")
    freq = normalize_freq(cmdty_storage.freq)
    val_period = to_period(val_date, freq)
    if val_period > cmdty_storage.end:
        return IntrinsicValuationResults(0.0, _empty_profile(freq))
    if val_period == cmdty_storage.end:
        if cmdty_storage.must_be_empty_at_end:
            if inventory > 0:
                raise InventoryConstraintsCannotBeFulfilledError(
                    "Storage must be empty at end, but inventory is greater than zero."
                )
            return IntrinsicValuationResults(0.0, _empty_profile(freq))
        if inventory < cmdty_storage.min_inventory(val_period):
            raise InventoryConstraintsCannotBeFulfilledError(
                "Current inventory is lower than the minimum allowed in the end period."
            )
        if inventory > cmdty_storage.max_inventory(val_period):
            raise InventoryConstraintsCannotBeFulfilledError(
                "Current inventory is greater than the maximum allowed in the end period."
            )
        price = float(forward_curve[val_period])
        npv = cmdty_storage.terminal_storage_npv(price, float(inventory))
        return IntrinsicValuationResults(npv, _empty_profile(freq))

    ctx = build_valuation_context(
        cmdty_storage, val_date, float(inventory), forward_curve, interest_rates,
        settlement_rule, num_inventory_grid_points, numerical_tolerance,
    )
    return intrinsic_value_with_ctx(ctx, extra_decisions, interpolation, device)


def intrinsic_value_with_ctx(
    ctx: ValuationContext, extra_decisions: int = 0, interpolation: str = "linear",
    device="cuda",
) -> IntrinsicValuationResults:
    """Intrinsic valuation on an already-compiled context (the LSMC entry point
    shares one context build between both engines)."""
    n = ctx.n_steps
    grid_end = ctx.grids[n]
    if ctx.storage.terminal_npv_fn is None:
        terminal = np.zeros_like(grid_end)
    else:
        terminal = np.asarray(ctx.storage.terminal_npv_fn(ctx.fwd[n], grid_end), dtype=np.float64)
        terminal = np.broadcast_to(terminal, grid_end.shape)
    values = _backward_values(ctx, terminal, extra_decisions, device,
                              cubic=interpolation == "cubic")
    rows = _forward_sweep(ctx, np.asarray(values, dtype=np.float64), extra_decisions,
                          interpolation)
    npv = float(rows[:, PROFILE_COLUMNS.index("period_pv")].sum())
    profile = pd.DataFrame(rows, columns=PROFILE_COLUMNS, index=ctx.periods)
    return IntrinsicValuationResults(npv, profile)
