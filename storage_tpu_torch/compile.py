"""Valuation-context compiler.

Everything the valuation engines need — active-window slices of the storage
arrays, the reduced inventory space, per-period inventory grids, forward
prices and discount factors — is assembled here **once, on the host, in
float64**, then handed to the jitted engines as dense arrays.  This collapses
the reference's per-period virtual calls (settle-rule delegate, discount
memoisation, grid calc, constraint dispatch — e.g.
``LsmcStorageValuation.cs:131-143, 209-242``) into array lookups.

Grid design note: the reference's ``FixedSpacingStateSpaceGridCalc`` steps a
global spacing from each period's lower bound and clamps the final point
(``FixedSpacingStateSpaceGridCalc.cs:45-62``), giving ragged per-period grid
lengths.  Ragged shapes don't jit, so this build uses a **fixed count of
linspace points per period** over the same reduced ranges: rectangular
``[n+1, G]`` tensors, and O(1) fractional-index interpolation instead of
binary search.  Both discretise the same value function; results agree to
grid-resolution tolerance.
"""
from __future__ import annotations

from dataclasses import dataclass
from datetime import date
from typing import Callable, Optional, Union

import numpy as np
import pandas as pd

from .ops.interp import uniform_grids
from .ops.inventory_space import InventorySpace, calculate_inventory_space
from .storage import CmdtyStorage
from .utils.discount import DiscountFn, discount_factors_for_spec
from .utils.frequencies import (
    PeriodLike,
    days_index,
    normalize_freq,
    period_start_day,
    to_day,
    to_period,
)

SettlementRule = Callable[[pd.Period], date]


@dataclass(frozen=True)
class ValuationContext:
    """Dense, step-indexed inputs for one valuation run.

    Step ``k`` is the k-th period of the *active window*
    ``[max(storage start, val date) .. storage end]``; decision steps are
    ``0..n-1`` and step ``n`` is the storage end period.
    """

    storage: CmdtyStorage
    freq: str
    val_period: pd.Period
    periods: pd.PeriodIndex  # [n+1]
    n_steps: int
    val_date_is_first_step: bool  # True when val date >= storage start
    inventory: float
    inv_space: InventorySpace  # arrays [n+1]
    grids: np.ndarray  # [n+1, G]
    num_grid_points: int
    pillars: np.ndarray  # [n, P, 3]
    interp_kind: int
    inject_cost: np.ndarray  # [n]
    withdraw_cost: np.ndarray  # [n]
    cons_inject: np.ndarray  # [n]
    cons_withdraw: np.ndarray  # [n]
    inventory_loss: np.ndarray  # [n]
    inventory_cost_rate: np.ndarray  # [n]
    df_settle: np.ndarray  # [n] discount from val day to settle day of step k
    df_cost: np.ndarray  # [n] discount from val day to the cost cash-flow day of step k
    fwd: np.ndarray  # [n+1] forward prices over the active window
    numerical_tolerance: float


def _sample_forward_curve(
    forward_curve: pd.Series, periods: pd.PeriodIndex
) -> np.ndarray:
    """Validate coverage and sample the forward curve over the active window.

    Reference checks: curve must start on or before the first active period
    and extend to the storage end (``LsmcStorageValuation.cs:91-95``).
    """
    if len(forward_curve) == 0:
        raise ValueError("Forward curve cannot be empty.")
    idx = forward_curve.index
    if not isinstance(idx, pd.PeriodIndex):
        raise ValueError("Forward curve must be indexed by a pandas PeriodIndex.")
    if idx.freqstr != periods.freqstr:
        raise ValueError("cmdty_storage and forward_curve have different frequencies.")
    if idx[0] > periods[0]:
        raise ValueError(
            f"Forward curve starts too late. Must start on or before the period {periods[0]}."
        )
    if idx[-1] < periods[-1]:
        raise ValueError("Forward curve does not extend until storage end period.")
    sampled = forward_curve.reindex(periods)
    if sampled.isna().any():
        missing = sampled[sampled.isna()].index[0]
        raise ValueError(f"Forward curve has no value for period {missing}.")
    return sampled.to_numpy(dtype=np.float64)


def _rule_days(rule, periods: pd.PeriodIndex) -> np.ndarray:
    """Cash-flow days (``datetime64[D]``) for each decision period.

    Scalar rules are the API contract (a callable of one period, reference
    ``utils.py:116-123``), but per-period pandas calls cost ~0.2 ms each —
    the single largest host item of the headline valuation.  Pandas-native
    rules (like ``d.asfreq('M').asfreq('D', 'end') + 20``) work unchanged on
    a whole ``PeriodIndex``, so the rule is first tried vectorised; the
    result only counts when it is index-like of the right length AND agrees
    with the scalar call on the first and last period (guarding rules whose
    Index behaviour differs from their elementwise one).  Any failure falls
    back to the per-period loop.
    """
    if rule is None:
        return days_index(periods)
    try:
        vec = rule(periods)
        if (
            not isinstance(vec, pd.Period)
            and hasattr(vec, "__len__")
            and len(vec) == len(periods)
        ):
            days = days_index(vec)
            ends = [0, len(periods) - 1]
            if all(
                days[i].astype(object) == to_day(rule(periods[i])) for i in ends
            ):
                return days
    except Exception:  # noqa: BLE001 - scalar fallback is the contract
        pass
    return days_index([to_day(rule(p)) for p in periods])


def build_valuation_context(
    storage: CmdtyStorage,
    val_date: PeriodLike,
    inventory: float,
    forward_curve: pd.Series,
    interest_rates: Union[None, float, pd.Series, DiscountFn],
    settlement_rule: Optional[SettlementRule],
    num_grid_points: int = 100,
    numerical_tolerance: float = 1e-12,
) -> ValuationContext:
    """Compile a valuation context.  Callers must have handled the expired and
    end-period edge cases (``LsmcStorageValuation.cs:61-84``) first."""
    if inventory < 0:
        raise ValueError("Inventory cannot be negative.")
    freq = normalize_freq(storage.freq)
    val_period = to_period(val_date, freq)
    if val_period > storage.end:
        raise ValueError("Storage has expired before the valuation date.")

    start_active = max(storage.start, val_period)
    start_offset = (start_active - storage.start).n
    periods = storage.periods[start_offset:]
    n = len(periods) - 1
    if n < 1:
        raise ValueError(
            "Valuation context requires at least one decision period; use the "
            "end-period result path instead."
        )

    pillar_tables = storage.pillar_tables[start_offset:]
    min_inv = storage.min_inventory_by_step[start_offset:]
    max_inv = storage.max_inventory_by_step[start_offset:]
    loss = storage.inventory_loss_by_step[start_offset:]

    inv_space = calculate_inventory_space(
        pillar_tables,
        storage.interp_kind,
        min_inv,
        max_inv,
        loss,
        float(inventory),
        storage.must_be_empty_at_end,
        numerical_tolerance=storage.numerical_tolerance,
    )

    grids = uniform_grids(inv_space.min_inventory, inv_space.max_inventory, num_grid_points)

    fwd = _sample_forward_curve(forward_curve, periods)

    present_day = period_start_day(val_period)
    decision_periods = periods[:-1]
    settle_days = _rule_days(settlement_rule, decision_periods)
    df_settle = discount_factors_for_spec(interest_rates, present_day, settle_days)
    cost_days = _rule_days(storage.cost_cash_flow_rule, decision_periods)
    df_cost = discount_factors_for_spec(interest_rates, present_day, cost_days)

    return ValuationContext(
        storage=storage,
        freq=freq,
        val_period=val_period,
        periods=periods,
        n_steps=n,
        val_date_is_first_step=val_period >= storage.start,
        inventory=float(inventory),
        inv_space=inv_space,
        grids=grids,
        num_grid_points=num_grid_points,
        pillars=storage.pillars_padded[start_offset:],
        interp_kind=storage.interp_kind,
        inject_cost=storage.injection_cost_by_step[start_offset:],
        withdraw_cost=storage.withdrawal_cost_by_step[start_offset:],
        cons_inject=storage.cmdty_consumed_inject_by_step[start_offset:],
        cons_withdraw=storage.cmdty_consumed_withdraw_by_step[start_offset:],
        inventory_loss=loss,
        inventory_cost_rate=storage.inventory_cost_by_step[start_offset:],
        df_settle=df_settle,
        df_cost=df_cost,
        fwd=fwd,
        numerical_tolerance=numerical_tolerance,
    )
