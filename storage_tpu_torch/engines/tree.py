"""Trinomial-tree storage valuation.

Reference: ``TreeStorageValuation<T>.Calculate``
(``TreeValuation/TreeStorageValuation.cs:143-342``) and the Python wrapper
``trinomial_value`` / ``trinomial_deltas`` (``cmdty_storage/trinomial.py``),
via the JAX package's ``engines/tree.py``.

The generic DP over a recombining tree walks the periods in reverse on the
valuation's device, carrying the value function ``V [K, G]`` (price levels x
inventory grid).  Per period: the expected continuation per CURRENT node is
a probability-weighted gather over the three branch destinations (linear in
V, so interchangeable with the reference's interpolate-then-weight order,
``TreeStorageValuation.cs:322-330``), then the same fixed-width bang-bang
decisions as the other engines, vectorised over (node, grid).  The decision
geometry and economics depend on no value function, so they are computed
for all periods at once before the walk (``_GEOMETRY_CHUNK`` periods per
batch).  The JAX package runs this DP as XLA code (a ``lax.scan``), with no
Pallas kernel, so here it is torch ops too.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import pandas as pd
import torch

from ..compile import SettlementRule, ValuationContext, build_valuation_context
from ..exceptions import InventoryConstraintsCannotBeFulfilledError
from ..models.trinomial import TrinomialTree, build_intrinsic_tree, build_trinomial_tree
from ..ops.csrc import check_dtype
from ..ops.interp import cubic_spline_moments, fractional_index
from ..storage import CmdtyStorage
from ..utils.discount import DiscountFn
from ..utils.frequencies import PeriodLike, normalize_freq, to_period
from .common import step_economics

_GEOMETRY_CHUNK = 4096  # periods whose decision geometry is computed at once


class TreeValuationResults(NamedTuple):
    """NPV + the dense tree + per-period value functions.

    Engine-level mirror of ``TreeStorageValuationResults<T>``
    (``TreeValuation/TreeStorageValuationResults.cs``): NPV, the tree itself,
    value-by-(level, inventory-grid) per period, and the inventory space.
    """

    npv: float
    tree: TrinomialTree
    values: np.ndarray  # [n+1, K, G] storage value per (period, level, grid pt)
    grids: np.ndarray  # [n+1, G]
    inv_space_min: np.ndarray  # [n+1]
    inv_space_max: np.ndarray  # [n+1]
    #: Optimal inject/withdraw volume per (period, level, grid point) — the
    #: reference's ``InjectWithdrawDecisions`` cube
    #: (``TreeStorageValuationResults.cs:41``).  [n, K, G]
    decisions: np.ndarray = None


def _tree_backward(
    terminal_values,  # [K, G]
    node_prices,  # [n, K] (decision steps)
    branch_center,  # [n, K] int64
    branch_probs,  # [n, K, 3]
    grids,  # [n, G]
    next_lo,  # [n]
    next_hi,  # [n]
    pillars,
    loss,
    inject_cost,
    withdraw_cost,
    cons_inject,
    cons_withdraw,
    inv_cost_rate,
    df_settle,
    df_start,
    interp_kind: int,
    num_grid_points: int,
    extra_decisions: int,
    cubic: bool = False,
):
    """Backward DP; returns ``(values [n+1, K, G], decisions [n, K, G])``
    (period-major), on the inputs' device and in their dtype.

    ``cubic`` switches the inventory interpolation of the expected
    continuation to a natural cubic spline per tree level (reference
    ``WithInterpolatorFactory`` + ``NaturalCubicSplineInterpolatorFactory``;
    linear remains the default, matching the reference's guidance).
    """
    n = node_prices.shape[0]
    K, G = terminal_values.shape
    values = terminal_values.new_empty((n + 1, K, G))
    decisions = terminal_values.new_empty((n, K, G))
    values[n] = terminal_values

    def col(x, a, b):  # per-period scalars of periods [a, b) as [c, 1]
        return x[a:b, None]

    for b in range(n, 0, -_GEOMETRY_CHUNK):
        a = max(0, b - _GEOMETRY_CHUNK)
        lo_c, hi_c = col(next_lo, a, b), col(next_hi, a, b)
        econ = step_economics(
            grids[a:b], pillars[a:b], interp_kind, col(loss, a, b), lo_c, hi_c,
            col(inject_cost, a, b), col(withdraw_cost, a, b), col(cons_inject, a, b),
            col(cons_withdraw, a, b), col(inv_cost_rate, a, b), col(df_settle, a, b),
            col(df_start, a, b), extra_decisions,
        )  # [c, G, D]
        j, w = fractional_index(econ.inventory_after, lo_c[..., None], hi_c[..., None],
                                num_grid_points)
        for k in range(b - 1, a - 1, -1):
            i = k - a
            v_next = values[k + 1]
            # Expected continuation per current node across its three
            # destinations, gathered as JAX gathers rows: a negative index
            # counts from the end, one past the end is clamped (only the
            # one-level intrinsic tree reaches either, with probability 0).
            center = branch_center[k]
            down, mid, up = (v_next[torch.where(c < 0, c + K, c).clamp(0, K - 1)]
                             for c in (center - 1, center, center + 1))
            probs = branch_probs[k]
            expected = (probs[:, 0, None] * down + probs[:, 1, None] * mid
                        + probs[:, 2, None] * up)  # [K, G]
            # Interpolate it at the post-decision inventories: [K, G', ] at [G, D].
            j_k, w_k = j[i], w[i]
            u = (1.0 - w_k)[None]
            ww = w_k[None]
            cont = expected[:, j_k] * u + expected[:, j_k + 1] * ww  # [K, G, D]
            if cubic:
                h = (next_hi[k] - next_lo[k]) / (num_grid_points - 1)
                moments = cubic_spline_moments(expected, h)  # [K, G']
                cont = cont + h**2 / 6.0 * (
                    (u**3 - u) * moments[:, j_k] + (ww**3 - ww) * moments[:, j_k + 1])
            immediate = (econ.price_coeff[i][None] * node_prices[k][:, None, None]
                         - econ.cost_npv[i][None])  # [K, G, D]
            total = immediate + cont
            best = torch.argmax(total, dim=-1, keepdim=True)  # first occurrence
            values[k] = total.gather(-1, best)[..., 0]
            # Optimal decision VOLUME at each (level, grid point): the
            # reference's InjectWithdrawDecisions cube entry for this period.
            decisions[k] = econ.decisions[i][None].expand_as(total).gather(-1, best)[..., 0]
    return values, decisions


def tree_value(
    ctx: ValuationContext,
    tree: TrinomialTree,
    extra_decisions: int = 0,
    dtype=torch.float32,
    interpolation: str = "linear",
    device="cuda",
) -> TreeValuationResults:
    """Run the tree DP for a compiled valuation context, in ``dtype`` on
    ``device``."""
    n = ctx.n_steps
    G = ctx.num_grid_points
    K = tree.num_levels
    if tree.values.shape[0] != n + 1:
        raise ValueError("Tree length must equal the number of active periods.")
    check_dtype("the tree DP", dtype)

    grid_end = ctx.grids[n]
    if ctx.storage.terminal_npv_fn is None:
        terminal = np.zeros((K, G), dtype=np.float64)
    else:
        terminal = np.broadcast_to(
            np.asarray(
                ctx.storage.terminal_npv_fn(tree.values[n][:, None], grid_end[None, :]),
                dtype=np.float64,
            ),
            (K, G),
        )

    def t(a, kind=dtype):
        return torch.tensor(np.asarray(a), dtype=kind, device=device)

    # Decision steps are 0..n-1; the tree's n branch rows are the
    # transitions out of them (the last one into the end period).
    values, decisions = _tree_backward(
        t(terminal), t(tree.values[:n]), t(tree.branch_center[:n], torch.int64),
        t(tree.branch_probs[:n]), t(ctx.grids[:n]), t(ctx.inv_space.min_inventory[1:]),
        t(ctx.inv_space.max_inventory[1:]), t(ctx.pillars), t(ctx.inventory_loss),
        t(ctx.inject_cost), t(ctx.withdraw_cost), t(ctx.cons_inject), t(ctx.cons_withdraw),
        t(ctx.inventory_cost_rate), t(ctx.df_settle), t(ctx.df_cost),
        interp_kind=ctx.interp_kind, num_grid_points=G, extra_decisions=extra_decisions,
        cubic=(interpolation == "cubic"),
    )
    values_np = values.cpu().numpy().astype(np.float64)

    # NPV: probability-weighted roll-up at the first active period over its
    # reachable nodes, at the starting inventory (grid[0] is degenerate at the
    # starting inventory, so any column works) — reference :272-280.
    npv = float(np.dot(tree.probs[0], values_np[0, :, 0]))
    return TreeValuationResults(
        npv=npv,
        tree=tree,
        values=values_np,
        grids=ctx.grids,
        inv_space_min=ctx.inv_space.min_inventory,
        inv_space_max=ctx.inv_space.max_inventory,
        decisions=decisions.cpu().numpy().astype(np.float64),
    )


def trinomial_value(
    cmdty_storage: CmdtyStorage,
    val_date: PeriodLike,
    inventory: float,
    forward_curve: pd.Series,
    spot_volatility: pd.Series,
    mean_reversion: float,
    time_step: float,
    interest_rates: Union[None, float, pd.Series, DiscountFn],
    settlement_rule: Optional[SettlementRule],
    num_inventory_grid_points: int = 100,
    numerical_tolerance: float = 1e-12,
    extra_decisions: int = 0,
    dtype=torch.float32,
    interpolation: str = "linear",
    device="cuda",
) -> float:
    """Storage value under a one-factor trinomial tree
    (reference ``trinomial.py:36-85``); ``interpolation`` may be 'linear'
    (default) or 'cubic' (natural spline, reference
    ``WithInterpolatorFactory``).  The DP runs in ``dtype`` on ``device``."""
    freq = normalize_freq(cmdty_storage.freq)
    if freq != normalize_freq(forward_curve.index.freqstr):
        raise ValueError("cmdty_storage and forward_curve have different frequencies.")
    if freq != normalize_freq(spot_volatility.index.freqstr):
        raise ValueError("cmdty_storage and spot_volatility have different frequencies.")
    val_period = to_period(val_date, freq)
    if val_period > cmdty_storage.end:
        return 0.0
    if val_period == cmdty_storage.end:
        if cmdty_storage.must_be_empty_at_end:
            if inventory > 0:
                raise InventoryConstraintsCannotBeFulfilledError(
                    "Storage must be empty at end, but inventory is greater than zero."
                )
            return 0.0
        return cmdty_storage.terminal_storage_npv(
            float(forward_curve[val_period]), float(inventory)
        )

    ctx = build_valuation_context(
        cmdty_storage, val_date, float(inventory), forward_curve, interest_rates,
        settlement_rule, num_inventory_grid_points, numerical_tolerance,
    )
    vols = spot_volatility.reindex(ctx.periods)
    if vols.isna().any():
        raise ValueError("spot_volatility must cover all storage periods.")
    tree = build_trinomial_tree(
        ctx.fwd, vols.to_numpy(dtype=np.float64), mean_reversion, time_step
    )
    return tree_value(ctx, tree, extra_decisions, dtype, interpolation, device).npv


def intrinsic_tree_value(
    cmdty_storage: CmdtyStorage,
    val_date: PeriodLike,
    inventory: float,
    forward_curve: pd.Series,
    interest_rates,
    settlement_rule,
    num_inventory_grid_points: int = 100,
    numerical_tolerance: float = 1e-12,
    device="cuda",
) -> float:
    """Tree DP over the degenerate intrinsic (forward-path) tree —
    reference ``WithIntrinsicTree`` (``TreeStorageValuationExtensions.cs:104-124``)."""
    ctx = build_valuation_context(
        cmdty_storage, val_date, float(inventory), forward_curve, interest_rates,
        settlement_rule, num_inventory_grid_points, numerical_tolerance,
    )
    tree = build_intrinsic_tree(ctx.fwd)
    return tree_value(ctx, tree, device=device).npv


def trinomial_deltas(
    cmdty_storage: CmdtyStorage,
    val_date: PeriodLike,
    inventory: float,
    forward_curve: pd.Series,
    spot_volatility: pd.Series,
    mean_reversion: float,
    time_step: float,
    interest_rates,
    settlement_rule,
    fwd_contracts,
    num_inventory_grid_points: int = 100,
    numerical_tolerance: float = 1e-12,
    delta_shift: Optional[float] = None,
    dtype=None,
    device="cuda",
):
    """Bump-and-revalue deltas per forward contract
    (reference ``trinomial.py:88-118``).

    By default (``dtype=None``) the revaluations run in float64 with the
    reference's 1e-5 bump (``trinomial.py:100``): bump-and-revalue accuracy
    is mantissa-bound.  ``dtype=torch.float32`` runs them in float32, where
    ``delta_shift`` defaults to 0.01 instead (1e-5 sits below a float32
    NPV's resolution).
    """
    from ..utils.contracts import to_period_range

    if dtype is None:
        dtype = torch.float64
    if delta_shift is None:
        delta_shift = 1e-5 if dtype == torch.float64 else 0.01
    freq = normalize_freq(cmdty_storage.freq)
    curve = forward_curve.copy()
    deltas = []
    for fwd_contract in fwd_contracts:
        start, end = to_period_range(freq, fwd_contract)
        base = forward_curve[start:end].copy()
        curve[start:end] = base + delta_shift
        up = trinomial_value(
            cmdty_storage, val_date, inventory, curve, spot_volatility, mean_reversion,
            time_step, interest_rates, settlement_rule, num_inventory_grid_points,
            numerical_tolerance, dtype=dtype, device=device,
        )
        curve[start:end] = base - delta_shift
        down = trinomial_value(
            cmdty_storage, val_date, inventory, curve, spot_volatility, mean_reversion,
            time_step, interest_rates, settlement_rule, num_inventory_grid_points,
            numerical_tolerance, dtype=dtype, device=device,
        )
        deltas.append((up - down) / (2.0 * delta_shift))
        curve[start:end] = base
    return deltas


class TreeSimulationResults(NamedTuple):
    """Replay results (reference ``TreeSimulationResults.cs``)."""

    npv: float
    decision_profile: pd.Series
    cmdty_consumed: pd.Series


def simulate_decisions(
    ctx: ValuationContext,
    valuation: TreeValuationResults,
    transition_path,
    extra_decisions: int = 0,
) -> TreeSimulationResults:
    """Replay the optimal policy along a user-supplied path of transition
    indices (0=down, 1=mid, 2=up per step), on the host in float64.

    Reference: ``TreeStorageValuation.SimulateDecisions`` /
    ``DecisionSimulator`` (``TreeStorageValuation.cs:344-433``): at each period
    the optimal decision is re-derived against the next period's value
    functions at the realised node, then the tree is advanced along the given
    transition index.
    """
    from ..ops.decisions import bang_bang_decision_set, max_value_and_index
    from ..ops.ratchets import interp_rates_host

    tree = valuation.tree
    n = ctx.n_steps
    transition_path = list(transition_path)
    if len(transition_path) < n:
        raise ValueError(f"transition_path must supply at least {n} transition indices.")

    level = int(np.argmax(tree.probs[0]))  # root: the only level with mass
    inventory = ctx.inventory
    start_offset = (ctx.periods[0] - ctx.storage.start).n
    npv = 0.0
    decisions_out = np.zeros(n)
    consumed_out = np.zeros(n)

    for k in range(n):
        price = float(tree.values[k, level])
        pillars = ctx.storage.pillar_tables[start_offset + k]
        min_rate, max_rate = interp_rates_host(pillars, inventory, ctx.interp_kind)
        loss = float(ctx.inventory_loss[k]) * inventory
        decision_set = bang_bang_decision_set(
            min_rate, max_rate, inventory, loss,
            float(ctx.inv_space.min_inventory[k + 1]),
            float(ctx.inv_space.max_inventory[k + 1]),
            ctx.numerical_tolerance, extra_decisions,
        )
        grid_next = valuation.grids[k + 1]
        center = int(tree.branch_center[k, level]) if tree.branch_center.shape[0] > k else 0
        probs = (tree.branch_probs[k, level] if tree.branch_probs.shape[0] > k
                 else np.array([0.0, 1.0, 0.0]))
        totals = np.empty(len(decision_set))
        imm = np.empty(len(decision_set))
        consumed_arr = np.empty(len(decision_set))
        for d_idx, d in enumerate(decision_set):
            q_after = inventory + d - loss
            cont = 0.0
            for off, p_col in ((-1, 0), (0, 1), (1, 2)):
                dest = min(max(center + off, 0), valuation.values.shape[1] - 1)
                cont += float(probs[p_col]) * float(
                    np.interp(q_after, grid_next, valuation.values[k + 1, dest])
                )
            consumed = (
                float(ctx.cons_inject[k]) * abs(d) if d > 0 else float(ctx.cons_withdraw[k]) * abs(d)
            )
            cost = (
                float(ctx.inject_cost[k]) * abs(d) if d > 0 else float(ctx.withdraw_cost[k]) * abs(d)
            )
            inv_cost = float(ctx.inventory_cost_rate[k]) * inventory
            immediate = (
                -(d + consumed) * price * float(ctx.df_settle[k])
                - (cost + inv_cost) * float(ctx.df_cost[k])
            )
            totals[d_idx] = immediate + cont
            imm[d_idx] = immediate
            consumed_arr[d_idx] = consumed
        _, best = max_value_and_index(totals)
        d_opt = float(decision_set[best])
        npv += imm[best]
        decisions_out[k] = d_opt
        consumed_out[k] = consumed_arr[best]
        inventory = inventory + d_opt - loss
        # Advance the tree along the supplied transition.
        t_idx = int(transition_path[k])
        if t_idx not in (0, 1, 2):
            raise ValueError("Transition indices must be 0 (down), 1 (mid) or 2 (up).")
        if k < tree.branch_center.shape[0]:
            level = int(np.clip(tree.branch_center[k, level] + (t_idx - 1), 0,
                                tree.values.shape[1] - 1))

    if not ctx.storage.must_be_empty_at_end:
        npv += ctx.storage.terminal_storage_npv(float(tree.values[n, level]), inventory)

    index = ctx.periods[:-1]
    return TreeSimulationResults(
        npv=float(npv),
        decision_profile=pd.Series(decisions_out, index=index),
        cmdty_consumed=pd.Series(consumed_out, index=index),
    )
