"""Least-Squares Monte Carlo storage valuation — the flagship engine.

Reference: ``LsmcStorageValuation.Calculate<T>``
(``LsmcValuation/LsmcStorageValuation.cs:55-617``), via the JAX package's
``engines/lsmc.py``.  This is its single-device, materialised route:

- **Backward induction** walks the periods in reverse carrying the value
  surface ``V [G, S]`` (sims contiguous).  Each period one launch of the
  ``backward_update`` CUDA kernel (:mod:`storage_tpu_torch.ops.backward`)
  updates ``V`` and emits the Gram/cross partials of the previous period's
  regression, which :func:`~storage_tpu_torch.ops.backward.assemble_regression`
  solves between launches — the design matrix never materialises.
- The **lower-bound estimator** is preserved: the argmax is taken over the
  *fitted* continuation but the realised value uses the *actual* simulated
  continuation of the chosen decision (reference :321-329).
- The **forward pass** is one launch of the ``forward_sim`` CUDA kernel
  (:mod:`storage_tpu_torch.ops.forward`) over the whole horizon, re-applying
  the saved regression to the independent valuation path set; per-period
  means, deltas and trigger prices come from its per-step sums, and the
  per-sim panels (``collect_panels``) are written by the kernel itself.
- With a progress or cancellation hook both passes run span by span
  (:func:`_chunk_bounds`, 20 spans): the value surface ``V`` is handed from
  one backward span to the next (each span solves its latest period
  directly, as the JAX package's chunked Pallas route does), the forward
  kernel hands on each sim's inventory and the PVs add up.  After each span
  the host waits for the device, checks the cancellation hook and reports
  progress, weighted 0.66 backward / 0.34 forward (reference
  ``LsmcStorageValuation.cs:46, 337-339, 488-490``).
- A path-set factory may return a
  :class:`~storage_tpu_torch.models.simulation.StreamingFactorSource`
  instead of a tensor (hourly horizons whose paths do not fit the device):
  both passes then walk the source's spans, reading each span's factors as
  it is regenerated from its checkpoint.
- :func:`fit_policy` runs the backward induction alone and returns the
  fitted :class:`LsmcPolicy`, which can be saved, loaded and handed to
  :func:`reprice` with fresh paths (intraday re-pricing).

Deviations from the reference are those of the JAX package: fixed-count
linspace grids, and the end-period terminal PV read from the valuation path
set (``LsmcStorageValuation.cs:567`` reads the regression sims).
"""
from __future__ import annotations

import logging
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..compile import ValuationContext
from ..exceptions import StorageError
from ..models.simulation import StreamingFactorSource
from ..ops.backward import assemble_regression, backward_update
from ..ops.forward import forward_sim, pack_scalars
from ..ops.interp import fractional_index
from ..ops.regression import (
    BasisSpec, design_matrix, fit_continuation, spot_from_factors, standardize_columns,
)
from .common import step_economics

NUM_TRIGGER_VOLUMES = 10  # reference numTriggerPriceVolumes (LsmcStorageValuation.cs:367)
BACKWARD_PCNT_TIME = 0.66  # reference progress weighting (LsmcStorageValuation.cs:46)
NUM_PROGRESS_CHUNKS = 20  # spans of each pass when progress/cancellation hooks are given

logger = logging.getLogger("storage_tpu_torch.lsmc")


class ValuationCancelledError(StorageError):
    """Raised when a cancellation callback requests a stop (reference:
    ``CancellationToken.ThrowIfCancellationRequested``, :339, :490)."""


PANEL_FIELDS = (
    "inventory",  # pre-decision inventory per period
    "inject_withdraw",
    "cmdty_consumed",
    "inventory_loss",
    "net_volume",
    "period_pv",
)


class LsmcArrays(NamedTuple):
    """Raw device outputs of one LSMC run (engine-level, pre-pandas)."""

    npv: torch.Tensor  # scalar — forward (lower-bound) estimate
    backward_npv: torch.Tensor  # scalar — backward estimate, diagnostic
    deltas: torch.Tensor  # [n+1] (last entry 0)
    profile_means: torch.Tensor  # [n+1, 6] per-period sim-means of PANEL_FIELDS
    panels: torch.Tensor  # [n+1, 6, S] per-sim panels ([n+1, 6, 0] when not collected)
    pv_by_sim: torch.Tensor  # [S]
    trigger_has_inject: torch.Tensor  # [n] bool
    trigger_has_withdraw: torch.Tensor  # [n] bool
    trigger_inject_volumes: torch.Tensor  # [n, 10]
    trigger_inject_prices: torch.Tensor  # [n, 10]
    trigger_withdraw_volumes: torch.Tensor  # [n, 10] (ordered |vol| increasing)
    trigger_withdraw_prices: torch.Tensor  # [n, 10]


class LsmcDeviceInputs(NamedTuple):
    """Step-indexed float32 tensors compiled from a :class:`ValuationContext`."""

    grids: torch.Tensor  # [n+1, G]
    space_lo: torch.Tensor  # [n+1]
    space_hi: torch.Tensor  # [n+1]
    pillars: torch.Tensor  # [n, P, 3], or [n, P, 5] with POLY coefficients
    loss: torch.Tensor  # [n]
    inject_cost: torch.Tensor
    withdraw_cost: torch.Tensor
    cons_inject: torch.Tensor
    cons_withdraw: torch.Tensor
    inv_cost_rate: torch.Tensor
    df_settle: torch.Tensor
    df_start: torch.Tensor
    fwd: torch.Tensor  # [n+1]
    inventory: torch.Tensor  # scalar


def device_inputs(ctx: ValuationContext, device, dtype=torch.float32) -> LsmcDeviceInputs:
    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype).to(device).contiguous()

    return LsmcDeviceInputs(
        grids=t(ctx.grids),
        space_lo=t(ctx.inv_space.min_inventory),
        space_hi=t(ctx.inv_space.max_inventory),
        pillars=t(ctx.pillars),
        loss=t(ctx.inventory_loss),
        inject_cost=t(ctx.inject_cost),
        withdraw_cost=t(ctx.withdraw_cost),
        cons_inject=t(ctx.cons_inject),
        cons_withdraw=t(ctx.cons_withdraw),
        inv_cost_rate=t(ctx.inventory_cost_rate),
        df_settle=t(ctx.df_settle),
        df_start=t(ctx.df_cost),
        fwd=t(ctx.fwd),
        inventory=t(ctx.inventory),
    )


def _step_slice(x: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """Per-step scalars ``x[a:b]`` as an ``[m, 1]`` column (broadcasts against
    ``[m, G]`` grids)."""
    return x[a:b, None]


# --------------------------------------------------------------------------- #
# Backward induction                                                          #
# --------------------------------------------------------------------------- #


def _decision_geometry(dev: LsmcDeviceInputs, first: int, m: int, interp_kind: int,
                       num_grid_points: int, extra_decisions: int):
    """Per-period decision geometry for decision steps ``first .. first+m-1``.

    Depends only on the grid/ratchet/cost structure — not on the value
    surface — so it is computed for all periods at once before the scan.
    Returns ``(j [m, D, G] int32, w [m, D, G], cost_npv [m, D, G],
    price_coeff [m, D, G])``.
    """
    a, b = first, first + m
    lo = _step_slice(dev.space_lo, a + 1, b + 1)
    hi = _step_slice(dev.space_hi, a + 1, b + 1)
    ic, wc, ci, cw, icr, dfs, df0 = (_step_slice(x, a, b) for x in (
        dev.inject_cost, dev.withdraw_cost, dev.cons_inject, dev.cons_withdraw,
        dev.inv_cost_rate, dev.df_settle, dev.df_start,
    ))
    econ = step_economics(
        dev.grids[a:b], dev.pillars[a:b], interp_kind, _step_slice(dev.loss, a, b), lo, hi,
        ic, wc, ci, cw, icr, dfs, df0, extra_decisions,
    )  # [m, G, D]
    j, w = fractional_index(econ.inventory_after, lo[..., None], hi[..., None], num_grid_points)

    def dg(x):
        return x.transpose(1, 2).contiguous()

    return dg(j).to(torch.int32), dg(w), dg(econ.cost_npv), dg(econ.price_coeff)


def decision_table(coeffs, vbar_next, geom_j, geom_w, cost, price) -> torch.Tensor:
    """The backward kernel's per-period table ``[D, G, B+2]``.

    Columns ``:B`` fold decision d's interpolation onto the next grid through
    the regression coefficients (``M_d @ coeffs'``, exact weights), column
    ``B`` is the shared affine offset ``M_d @ vbar_next - cost_npv`` and
    column ``B+1`` the coefficient on the spot price.  ``coeffs [B, G]``,
    ``vbar_next [G]``, geometry and economics ``[D, G]``.
    """
    j, w = geom_j.long(), geom_w
    c_t = coeffs.T  # [G, B]
    cwa_x = c_t[j] * (1.0 - w)[..., None] + c_t[j + 1] * w[..., None]
    vbar_d = vbar_next[j] * (1.0 - w) + vbar_next[j + 1] * w
    return torch.cat([cwa_x, (vbar_d - cost)[..., None], price[..., None]], dim=-1).contiguous()


def backward_scan(
    v_init: torch.Tensor,  # [G, S] value at the period after the last simulated step
    factors: torch.Tensor,  # [m, F, S] Markov factor states of the decision steps
    sim_vols: torch.Tensor,  # [m, F]
    sim_drift: torch.Tensor,  # [m]
    geometry,  # _decision_geometry(...) of the same m steps
    spec: BasisSpec,
):
    """Reverse scan over ``m`` periods with the structure of the JAX
    package's ``backward_scan_pallas``.

    The latest period's regression is solved directly (it has no kernel
    partials yet); every kernel launch then updates ``V`` for its period and
    returns the partials from which the previous period's regression is
    assembled.  Returns ``(v_final [G, S], coeffs [m, B, G], mus [m, B],
    sds [m, B], vbars [m, G])``.
    """
    G, S = v_init.shape
    m = factors.shape[0]
    B = spec.num_basis
    geom_j, geom_w, cost, price = geometry
    vols_prev = torch.cat([sim_vols[:1], sim_vols[:-1]], dim=0)
    drift_prev = torch.cat([sim_drift[:1], sim_drift[:-1]], dim=0)

    def kernel_step(k, coeffs, mu, sd, vbar_next, v_next):
        table = decision_table(coeffs, vbar_next, geom_j[k], geom_w[k], cost[k], price[k])
        musd = torch.stack([mu, sd]).contiguous()
        scal = torch.stack([
            torch.cat([sim_drift[k:k + 1], sim_vols[k]]),
            torch.cat([drift_prev[k:k + 1], vols_prev[k]]),
        ]).contiguous()
        v_this, graw, praw = backward_update(
            factors[k], factors[max(k - 1, 0)], v_next, table, vbar_next.contiguous(), musd,
            geom_j[k], geom_w[k], scal, spec=spec,
        )
        # New sim-mean from praw's ones row (centred row sums).
        return v_this, vbar_next + praw[B] / S, graw, praw, musd

    coeffs_all = torch.empty((m, B, G), dtype=v_init.dtype, device=v_init.device)
    mu_all = torch.empty((m, B), dtype=v_init.dtype, device=v_init.device)
    sd_all = torch.empty_like(mu_all)
    vbar_all = torch.empty((m, G), dtype=v_init.dtype, device=v_init.device)

    # Latest period (k = m-1), solved directly.
    vbar0 = v_init.mean(dim=1)
    f_last = factors[m - 1]
    spot = spot_from_factors(f_last, sim_vols[m - 1], sim_drift[m - 1])
    Xs, mu0, sd0 = standardize_columns(design_matrix(spec, spot, f_last))
    coeffs0 = fit_continuation(Xs, v_init.T - vbar0[None, :])
    coeffs_all[m - 1], mu_all[m - 1], sd_all[m - 1], vbar_all[m - 1] = coeffs0, mu0, sd0, vbar0

    v, vbar, graw, praw, musd = kernel_step(m - 1, coeffs0, mu0, sd0, vbar0, v_init)
    c_prev = vbar0
    for k in range(m - 2, -1, -1):
        # The partials were standardized with musd (period k+1's) and centred
        # on c_prev; assemble period k's exact regression from them.
        coeffs, mu, sd = assemble_regression(graw, praw, musd, vbar - c_prev, S)
        coeffs_all[k], mu_all[k], sd_all[k], vbar_all[k] = coeffs, mu, sd, vbar
        c_prev = vbar
        v, vbar, graw, praw, musd = kernel_step(k, coeffs, mu, sd, vbar, v)
    return v, coeffs_all, mu_all, sd_all, vbar_all


def _current_period_step(v_next, dev: LsmcDeviceInputs, interp_kind, num_grid_points,
                         extra_decisions):
    """Backward value at the deterministic current period (reference :171-181,
    :226-330 with simulatedPrices = forward price).  ``v_next`` is ``[G, S]``."""
    G = num_grid_points
    cont_mean = v_next.mean(dim=1)  # [G]
    econ = step_economics(
        dev.inventory.reshape(1), dev.pillars[0], interp_kind, dev.loss[0],
        dev.space_lo[1], dev.space_hi[1], dev.inject_cost[0], dev.withdraw_cost[0],
        dev.cons_inject[0], dev.cons_withdraw[0], dev.inv_cost_rate[0], dev.df_settle[0],
        dev.df_start[0], extra_decisions,
    )
    j, w = fractional_index(econ.inventory_after, dev.space_lo[1], dev.space_hi[1], G)
    fitted = cont_mean[j] * (1.0 - w) + cont_mean[j + 1] * w  # [1, D]
    immediate = econ.immediate_npv(dev.fwd[0])  # [1, D]
    best = torch.argmax(immediate + fitted, dim=1)  # [1], first occurrence
    j_b = j[0].gather(0, best)
    w_b = w[0].gather(0, best)
    # Per-sim actual continuation at the chosen decision.
    actual = v_next.index_select(0, j_b)[0] * (1.0 - w_b) + v_next.index_select(0, j_b + 1)[0] * w_b
    return immediate[0].gather(0, best) + actual, cont_mean


class _FactorAccess(NamedTuple):
    """Uniform span access over a materialised ``[m+1, F, S]`` tensor or a
    :class:`StreamingFactorSource` (``_factor_access`` of the JAX package)."""

    get: Callable[[int, int], torch.Tensor]  # (a, b) -> factors [b - a, F, S]
    last: Callable[[], torch.Tensor]  # () -> [F, S] of the final simulated period
    num_steps: int  # m + 1
    num_sims: int
    spans: Optional[List[Tuple[int, int]]]  # the source's aligned spans, or None


def _factor_access(factors_or_source) -> _FactorAccess:
    if isinstance(factors_or_source, StreamingFactorSource):
        src = factors_or_source
        return _FactorAccess(src.factors, src.last, src.num_steps, src.num_sims, src.spans())
    arr = factors_or_source
    return _FactorAccess(lambda a, b: arr[a:b], lambda: arr[-1], arr.shape[0], arr.shape[-1],
                         None)


def _refine_spans(m: int, num_chunks: int, source_spans) -> List[Tuple[int, int]]:
    """The spans of decision steps ``[0, m)`` a pass walks.

    Without a streaming source this is :func:`_chunk_bounds`.  With one, the
    source's aligned spans are the spans (each ``factors(a, b)`` read must
    stay within one of them), cut at ``m``: the source's last step is the end
    period, which no decision step reads.  They are not split further, with
    or without progress hooks.
    """
    if source_spans is None:
        return _chunk_bounds(m, num_chunks)
    return [(a, min(b, m)) for a, b in source_spans if a < m]


def _backward_program(reg_factors, sim_vols, sim_drift, dev: LsmcDeviceInputs,
                      spec: BasisSpec, interp_kind: int, num_grid_points: int,
                      extra_decisions: int, val_first: bool, terminal_fn,
                      num_chunks: int = 1,
                      after_span: Optional[Callable[[float], None]] = None):
    """Backward induction over the regression path set: a tensor
    ``[m+1, F, S]`` or a :class:`StreamingFactorSource` of as many steps.

    The spans (:func:`_refine_spans`: ``num_chunks`` spans of a tensor, the
    source's own of a source) are walked in reverse, each a
    :func:`backward_scan` handed the previous span's value surface;
    ``after_span(progress)`` runs after each.
    Returns ``(backward_npv, cont_mean0 [G], coeffs [m,B,G], mus, sds, vbars)``.
    ``cont_mean0`` is the current-period mean continuation when ``val_first``
    (reference :171-181), else zeros (unused).
    """
    G = num_grid_points
    reg = _factor_access(reg_factors)
    S = reg.num_sims
    m = reg.num_steps - 1  # simulated decision steps
    first = 1 if val_first else 0
    n = m + first

    # Terminal values on the end-period grid (reference :107-128), computed on
    # the regression path set like the backward induction itself.
    if terminal_fn is None:
        v = sim_vols.new_zeros((G, S))
    else:
        end_spots = spot_from_factors(reg.last(), sim_vols[-1], sim_drift[-1])
        v_end = torch.as_tensor(terminal_fn(end_spots[:, None], dev.grids[n][None, :]),
                                dtype=torch.float32, device=sim_vols.device)
        v = v_end.broadcast_to((S, G)).T.contiguous()

    if m:
        spans = _refine_spans(m, num_chunks, reg.spans)
        parts = []
        for i, (a, b) in enumerate(reversed(spans)):
            geometry = _decision_geometry(dev, first + a, b - a, interp_kind, G, extra_decisions)
            v, *policy = backward_scan(
                v, reg.get(a, b), sim_vols[a:b], sim_drift[a:b], geometry, spec)
            parts.insert(0, policy)
            if after_span is not None:
                after_span(BACKWARD_PCNT_TIME * (i + 1) / len(spans))
        coeffs, mus, sds, vbars = (torch.cat(x, dim=0) for x in zip(*parts))
    else:
        B = spec.num_basis
        coeffs = v.new_zeros((0, B, G))
        mus, sds, vbars = v.new_zeros((0, B)), v.new_zeros((0, B)), v.new_zeros((0, G))

    if val_first:
        v0, cont_mean0 = _current_period_step(v, dev, interp_kind, G, extra_decisions)
        backward_npv = v0.mean()
    else:
        cont_mean0 = v.new_zeros((G,))
        backward_npv = v[0].mean()
    return backward_npv, cont_mean0, coeffs, mus, sds, vbars


# --------------------------------------------------------------------------- #
# Forward simulation                                                          #
# --------------------------------------------------------------------------- #


def _trigger_calc(mean_cont, expected_inventory, pillars, interp_kind, loss_rate, next_lo,
                  next_hi, inject_cost, withdraw_cost, cons_inject, cons_withdraw,
                  inv_cost_rate, df_settle, df_start, num_grid_points, extra_decisions):
    """Trigger-price ladders at the expected inventory (reference :492-561),
    batched over a leading axis of ``M`` periods: ``mean_cont [M, G]``,
    ``expected_inventory [M]``, ``pillars [M, P, 3]``, scalars ``[M]``.

    Trigger price p solves  ΔContinuation − ΔCost = p · df · (ΔVolume + ΔConsumed)
    between a candidate volume and the 'alternative' (usually zero) decision.
    """
    col = [x[:, None] for x in (loss_rate, next_lo, next_hi, inject_cost, withdraw_cost,
                                cons_inject, cons_withdraw, inv_cost_rate, df_settle,
                                df_start)]
    (loss_c, lo_c, hi_c, ic_c, wc_c, ci_c, cw_c, icr_c, dfs_c, df0_c) = col
    econ = step_economics(
        expected_inventory[:, None], pillars, interp_kind, loss_c, lo_c, hi_c, ic_c, wc_c,
        ci_c, cw_c, icr_c, dfs_c, df0_c, extra_decisions,
    )
    decisions = econ.decisions[:, 0]  # [M, D]
    loss_amt = loss_rate * expected_inventory
    max_inject = decisions.max(dim=1).values
    max_withdraw = decisions.min(dim=1).values
    big = torch.finfo(decisions.dtype).max
    alt_inject = torch.where(decisions >= 0.0, decisions, torch.full_like(decisions, big)).min(dim=1).values
    alt_withdraw = torch.where(decisions <= 0.0, decisions, torch.full_like(decisions, -big)).max(dim=1).values

    def cont_at(volume):  # [M, K]
        after = expected_inventory[:, None] + volume - loss_amt[:, None]
        j, w = fractional_index(after, lo_c, hi_c, num_grid_points)
        return (torch.take_along_dim(mean_cont, j, dim=1) * (1.0 - w)
                + torch.take_along_dim(mean_cont, j + 1, dim=1) * w)

    def cost_of(volume):
        return torch.where(volume > 0.0, ic_c * volume, wc_c * (-volume)) * df0_c

    def consumed_of(volume):
        return torch.where(volume > 0.0, ci_c * volume, cw_c * (-volume))

    def trigger_price(volumes, alt):
        alt = alt[:, None]
        d_cont = cont_at(volumes) - cont_at(alt)
        d_cost = cost_of(volumes) - cost_of(alt)
        d_consumed = consumed_of(volumes) - consumed_of(alt)
        denom = dfs_c * (volumes - alt + d_consumed)
        # Zero headroom makes the denominator exactly 0; the has_* masks hide
        # those rows downstream, but emit 0 rather than NaN/Inf.
        nonzero = denom != 0.0
        safe = torch.where(nonzero, denom, torch.ones_like(denom))
        return torch.where(nonzero, (d_cont - d_cost) / safe, torch.zeros_like(denom))

    steps = torch.arange(1, NUM_TRIGGER_VOLUMES + 1, dtype=decisions.dtype,
                         device=decisions.device)
    inject_volumes = alt_inject[:, None] + steps * (max_inject - alt_inject)[:, None] / NUM_TRIGGER_VOLUMES
    inject_prices = trigger_price(inject_volumes, alt_inject)
    has_inject = (max_inject > 0.0) & (max_inject > alt_inject)

    withdraw_volumes = alt_withdraw[:, None] + steps * (max_withdraw - alt_withdraw)[:, None] / NUM_TRIGGER_VOLUMES
    withdraw_prices = trigger_price(withdraw_volumes, alt_withdraw)
    has_withdraw = (max_withdraw < 0.0) & (max_withdraw < alt_withdraw)
    return (has_inject, inject_volumes, inject_prices,
            has_withdraw, withdraw_volumes, withdraw_prices)


def _forward_step_core(inv, pv, spot, cont, k: int, dev: LsmcDeviceInputs, dfd_k,
                       interp_kind: int, num_grid_points: int, extra_decisions: int):
    """One forward-simulation period (reference :374-490) of decision step
    ``k`` against a dense per-sim continuation ``cont [S, G]`` on the next
    grid.  Returns ``((new_inv, new_pv), outputs)`` with the outputs shaped
    as one row of the stacked per-step outputs (leading axis of length 1)."""
    lo, hi = dev.space_lo[k + 1], dev.space_hi[k + 1]
    econ = step_economics(
        inv, dev.pillars[k], interp_kind, dev.loss[k], lo, hi, dev.inject_cost[k],
        dev.withdraw_cost[k], dev.cons_inject[k], dev.cons_withdraw[k],
        dev.inv_cost_rate[k], dev.df_settle[k], dev.df_start[k], extra_decisions,
    )  # decision axis last: [S, D]
    j, w = fractional_index(econ.inventory_after, lo, hi, num_grid_points)
    cont_d = (torch.take_along_dim(cont, j, dim=1) * (1.0 - w)
              + torch.take_along_dim(cont, j + 1, dim=1) * w)
    immediate = econ.immediate_npv(spot[:, None])  # [S, D]
    best = torch.argmax(immediate + cont_d, dim=1, keepdim=True)  # first occurrence

    def take(arr):
        return torch.take_along_dim(arr, best, dim=1)[:, 0]

    volume, consumed, imm_pv = take(econ.decisions), take(econ.consumed), take(immediate)
    loss_amt = dev.loss[k] * inv
    net_volume = -volume - consumed
    delta = (net_volume * spot).mean() / dev.fwd[k] * dfd_k
    expected_inventory = inv.mean()
    triggers = _trigger_calc(
        cont.mean(dim=0)[None], expected_inventory[None], dev.pillars[k][None], interp_kind,
        *(x[k:k + 1] for x in (dev.loss, dev.space_lo[1:], dev.space_hi[1:], dev.inject_cost,
                               dev.withdraw_cost, dev.cons_inject, dev.cons_withdraw,
                               dev.inv_cost_rate, dev.df_settle, dev.df_start)),
        num_grid_points, extra_decisions,
    )
    means = torch.stack([expected_inventory] + [x.mean() for x in (volume, consumed, loss_amt,
                                                                   net_volume, imm_pv)])
    outputs = (means[None], delta[None]) + triggers
    return (inv + volume - loss_amt, pv + imm_pv), outputs


def _step0_single_sim(cont_mean0, dev: LsmcDeviceInputs, dfd0, interp_kind: int,
                      num_grid_points: int, extra_decisions: int):
    """Deterministic current-period forward step on ONE representative sim.

    At the valuation date the price is the forward and the continuation is the
    sim-average, so every simulation takes the same decision — one sim
    suffices and its outputs are exact (reference :382-413).
    """
    (inv1, pv1), outputs0 = _forward_step_core(
        dev.inventory.reshape(1), cont_mean0.new_zeros((1,)), dev.fwd[0].reshape(1),
        cont_mean0[None, :], 0, dev, dfd0, interp_kind, num_grid_points, extra_decisions,
    )
    return inv1[0], pv1[0], outputs0


def _stacked_outputs(sums, xsums, tables, dev: LsmcDeviceInputs, dfd, first: int, n: int,
                     num_sims: int, interp_kind: int, num_grid_points: int,
                     extra_decisions: int):
    """Per-step means, deltas and trigger arrays from the forward kernel's
    reduced sums (``_pallas_stacked_outputs`` of the JAX package)."""
    means_rows = sums[:, :6] / num_sims  # PANEL_FIELDS order
    deltas_rows = sums[:, 6] / num_sims / dev.fwd[first:n] * dfd[first:n]
    # Trigger prices: sim-mean continuation per step from design-row sums.
    mean_cont = torch.einsum("mb,mbg->mg", xsums / num_sims, tables)  # [m, G]
    expected_inv = sums[:, 0] / num_sims
    trig = _trigger_calc(
        mean_cont, expected_inv, dev.pillars[first:n], interp_kind, dev.loss[first:n],
        dev.space_lo[first + 1:n + 1], dev.space_hi[first + 1:n + 1],
        dev.inject_cost[first:n], dev.withdraw_cost[first:n], dev.cons_inject[first:n],
        dev.cons_withdraw[first:n], dev.inv_cost_rate[first:n], dev.df_settle[first:n],
        dev.df_start[first:n], num_grid_points, extra_decisions,
    )
    return (means_rows, deltas_rows) + trig


def _forward_program(val_factors, sim_vols, sim_drift, cont_mean0, coeffs, mus, sds, vbars,
                     dev: LsmcDeviceInputs, backward_npv, spec: BasisSpec, interp_kind: int,
                     num_grid_points: int, extra_decisions: int, val_first: bool, terminal_fn,
                     discount_deltas: bool, collect_panels: bool = False,
                     num_chunks: int = 1,
                     after_span: Optional[Callable[[float], None]] = None) -> LsmcArrays:
    """Forward pass through the ``forward_sim`` kernel over the valuation
    path set (a tensor ``[m+1, F, S]`` or a :class:`StreamingFactorSource`),
    one launch per span (:func:`_refine_spans`; default: one span over the
    horizon), then result assembly (structure of the JAX package's
    ``_forward_program_pallas``).

    With ``collect_panels`` the kernel writes each span's rows of one
    ``[n+1, 6, S]`` buffer; the current-period row (every sim takes the same
    decision there) and the end row are filled here.
    """
    G = num_grid_points
    val = _factor_access(val_factors)
    S = val.num_sims
    m = val.num_steps - 1
    first = 1 if val_first else 0
    n = m + first
    dfd = dev.df_settle if discount_deltas else torch.ones_like(dev.df_settle)
    panels = sim_vols.new_empty((n + 1, 6, S if collect_panels else 0))

    if val_first:
        inv0, pv0, outputs0 = _step0_single_sim(cont_mean0, dev, dfd[0], interp_kind, G,
                                                 extra_decisions)
        if collect_panels:
            panels[0] = outputs0[0][0, :, None]  # the single sim's fields, for every sim
    else:
        inv0, pv0, outputs0 = dev.inventory, dev.inventory.new_zeros(()), None

    tables = torch.cat([coeffs, vbars[:, None, :]], dim=1).contiguous()  # [m, B+1, G]
    mus, sds = mus.contiguous(), sds.contiguous()
    pillars = dev.pillars[first:n].contiguous()
    scalars = pack_scalars(
        dev.space_lo[first + 1:n + 1], dev.space_hi[first + 1:n + 1], dev.loss[first:n],
        dev.inject_cost[first:n], dev.withdraw_cost[first:n], dev.cons_inject[first:n],
        dev.cons_withdraw[first:n], dev.inv_cost_rate[first:n], dev.df_settle[first:n],
        dev.df_start[first:n], sim_drift[:m], sim_vols[:m],
    )
    spans = _refine_spans(m, num_chunks, val.spans) if m else [(0, 0)]
    inv = inv0.reshape(1).expand(S).contiguous()
    pv_total = torch.zeros_like(inv)
    sums_parts, xsums_parts = [], []
    for i, (a, b) in enumerate(spans):
        sums, xsums, inv, pv = forward_sim(
            val.get(a, b), inv, tables[a:b], mus[a:b], sds[a:b], pillars[a:b],
            scalars[a:b], spec=spec, interp_kind=interp_kind, num_grid=G,
            extra_decisions=extra_decisions,
            panels=panels[first + a:first + b] if collect_panels else None,
        )
        pv_total = pv_total + pv
        sums_parts.append(sums)
        xsums_parts.append(xsums)
        if after_span is not None:
            after_span(BACKWARD_PCNT_TIME + (1.0 - BACKWARD_PCNT_TIME) * (i + 1) / len(spans))
    pv_by_sim = pv_total + pv0
    _check_forward_health(pv_by_sim, inv, backward_npv)
    stacked = _stacked_outputs(torch.cat(sums_parts), torch.cat(xsums_parts), tables, dev, dfd,
                               first, n, S, interp_kind, G, extra_decisions)
    if val_first:
        stacked = tuple(torch.cat([a, b], dim=0) for a, b in zip(outputs0, stacked))
    end_spots = spot_from_factors(val.last(), sim_vols[-1], sim_drift[-1])
    return _assemble_arrays(stacked, inv, pv_by_sim, end_spots, terminal_fn, backward_npv,
                            panels)


def _assemble_arrays(stacked, inv_final, pv_by_sim, end_spots, terminal_fn,
                     backward_npv, panels) -> LsmcArrays:
    (means_rows, deltas_rows, has_inj, inj_vols, inj_prices,
     has_wdr, wdr_vols, wdr_prices) = stacked
    S = inv_final.shape[0]

    # End-period terminal PV (reference :563-579; valuation sims here, see
    # module docstring).
    if terminal_fn is not None:
        terminal_pv = torch.as_tensor(terminal_fn(end_spots, inv_final), dtype=torch.float32,
                                      device=inv_final.device).broadcast_to((S,))
    else:
        terminal_pv = torch.zeros_like(inv_final)
    pv_by_sim = pv_by_sim + terminal_pv

    zero = inv_final.new_zeros(())
    end_means = torch.stack([inv_final.mean(), zero, zero, zero, zero, terminal_pv.mean()])
    if panels.shape[-1]:
        panels[-1] = 0.0
        panels[-1, 0] = inv_final
        panels[-1, 5] = terminal_pv
    return LsmcArrays(
        npv=pv_by_sim.mean(),
        backward_npv=backward_npv,
        deltas=torch.cat([deltas_rows, deltas_rows.new_zeros((1,))]),
        profile_means=torch.cat([means_rows, end_means[None]], dim=0),
        panels=panels,
        pv_by_sim=pv_by_sim,
        trigger_has_inject=has_inj,
        trigger_has_withdraw=has_wdr,
        trigger_inject_volumes=inj_vols,
        trigger_inject_prices=inj_prices,
        trigger_withdraw_volumes=wdr_vols,
        trigger_withdraw_prices=wdr_prices,
    )


# --------------------------------------------------------------------------- #
# Health checks and the engine driver                                         #
# --------------------------------------------------------------------------- #


def _check_backward_health(coeffs, vbars, fwd=None) -> None:
    """Post-run probe for a failed backward induction: non-finite regression
    coefficients or value-surface means, or a value surface that is
    identically zero for every period although the forward curve is not
    (``vbars`` is never NaN-sanitised upstream, so a blow-up reaches it).
    One device->host fetch."""
    fwd_zero = fwd is not None and not np.any(np.asarray(fwd))
    finite_c, finite_v, nonzero_v = torch.stack([
        torch.isfinite(coeffs).all(),
        torch.isfinite(vbars).all(),
        (vbars != 0.0).any() if vbars.numel() else torch.ones((), dtype=torch.bool,
                                                              device=vbars.device),
    ]).tolist()
    if not (finite_c and finite_v):
        raise StorageError(
            "Backward induction produced non-finite values "
            f"(regression coefficients finite: {finite_c}, value-surface "
            f"means finite: {finite_v})."
        )
    if vbars.numel() and not nonzero_v:
        msg = ("Backward induction value surface is identically zero for every "
               "period although the forward curve is not; a silently-wrong NPV "
               "must not be returned.")
        if fwd_zero:
            logger.warning(msg)
        else:
            raise StorageError(msg)


def _check_forward_health(pv, inv_final, backward_npv) -> None:
    """Forward-side twin of :func:`_check_backward_health`: non-finite per-sim
    PVs raise; so do PV and inventory paths that are identically zero while
    the backward estimate is not (a facility whose value is entirely
    terminal keeps a non-zero final inventory)."""
    finite_p, nonzero_p, inv_nonzero, back_zero = torch.stack([
        torch.isfinite(pv).all(),
        (pv != 0.0).any(),
        (inv_final != 0.0).any(),
        backward_npv.abs() < 1e-9,
    ]).tolist()
    if not finite_p:
        raise StorageError("Forward simulation produced non-finite per-simulation PVs.")
    if pv.numel() and not nonzero_p and not inv_nonzero and not back_zero:
        raise StorageError(
            "Forward simulation PV and inventory paths are identically zero while "
            "the backward estimate is not; a silently-wrong NPV must not be returned."
        )


def _chunk_bounds(n: int, num_chunks: int) -> List[Tuple[int, int]]:
    """Split range(n) into at most num_chunks contiguous spans (for progress
    reporting between kernel spans)."""
    num_chunks = max(1, min(num_chunks, n))
    edges = np.linspace(0, n, num_chunks + 1).astype(int)
    return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:]) if b > a]


def _span_hook(device, on_progress_update, cancelled) -> Callable[[float], None]:
    """The host's turn after each span: wait for the span's kernels (so that
    progress means work done and a cancel lands at once), check the
    cancellation hook, report progress."""

    def after_span(frac: float) -> None:
        if device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
            done.synchronize()
        if cancelled is not None and cancelled():
            raise ValuationCancelledError("Storage valuation was cancelled.")
        if on_progress_update is not None:
            on_progress_update(frac)

    return after_span


def _program_statics(ctx: ValuationContext, spec: BasisSpec, extra_decisions: int) -> dict:
    """The keyword arguments both programs take from the context."""
    return dict(
        spec=spec, interp_kind=ctx.interp_kind, num_grid_points=ctx.num_grid_points,
        extra_decisions=extra_decisions, val_first=ctx.val_date_is_first_step,
        terminal_fn=ctx.storage.terminal_npv_fn,
    )


def _on_device(x, device):
    """``x`` as a contiguous float32 tensor on ``device``; a streaming source
    (which lives on its own device) as it is."""
    if isinstance(x, StreamingFactorSource):
        return x
    return torch.as_tensor(x, dtype=torch.float32).to(device).contiguous()


def run_lsmc(
    ctx: ValuationContext,
    reg_sims,  # callable () -> factors [m+1, F, S] or a StreamingFactorSource, or either itself
    val_sims,  # the same for the valuation path set
    sim_vols,  # [m+1, F] spot-vol loadings per simulated period
    sim_drift,  # [m+1] ln F(0,t_k) - V_k/2 per simulated period
    spec: BasisSpec,
    discount_deltas: bool,
    extra_decisions: int = 0,
    device="cuda",
    on_progress_update: Optional[Callable[[float], None]] = None,
    cancelled: Optional[Callable[[], bool]] = None,
    collect_panels: bool = False,
    stopwatches=None,
) -> LsmcArrays:
    """Run backward induction + forward simulation on one device.

    ``reg_sims``/``val_sims`` are factories so the regression path set can be
    freed before the valuation set is simulated — at production path counts
    each set is GBs of device memory.  With ``on_progress_update`` or
    ``cancelled`` both passes run in ``NUM_PROGRESS_CHUNKS`` spans with the
    hooks between them (the JAX package's ``_run_lsmc_chunked``), and
    progress ends at 1.0; a cancel raises :class:`ValuationCancelledError`.
    A factory that returns a :class:`StreamingFactorSource` makes its pass
    walk the source's spans instead, with or without hooks.
    """
    device = torch.device(device)
    dev = device_inputs(ctx, device)
    statics = _program_statics(ctx, spec, extra_decisions)
    sim_vols, sim_drift = _on_device(sim_vols, device), _on_device(sim_drift, device)
    chunked = on_progress_update is not None or cancelled is not None
    num_chunks = NUM_PROGRESS_CHUNKS if chunked else 1
    after_span = _span_hook(device, on_progress_update, cancelled) if chunked else None

    reg_factors = reg_sims() if callable(reg_sims) else reg_sims
    if stopwatches is not None:
        stopwatches.start("BackwardInduction")
    backward_npv, cont_mean0, coeffs, mus, sds, vbars = _backward_program(
        reg_factors, sim_vols, sim_drift, dev, num_chunks=num_chunks, after_span=after_span,
        **statics)
    _check_backward_health(coeffs, vbars, ctx.fwd)
    if stopwatches is not None:
        stopwatches.stop("BackwardInduction")
    del reg_factors

    val_factors = val_sims() if callable(val_sims) else val_sims
    if stopwatches is not None:
        stopwatches.start("ForwardSimulation")
    arrays = _forward_program(
        val_factors, sim_vols, sim_drift, cont_mean0, coeffs, mus, sds, vbars, dev,
        backward_npv, discount_deltas=discount_deltas, collect_panels=collect_panels,
        num_chunks=num_chunks, after_span=after_span, **statics)
    if stopwatches is not None:
        stopwatches.synchronize()
        stopwatches.stop("ForwardSimulation")
    if on_progress_update is not None:
        on_progress_update(1.0)
    return arrays


# --------------------------------------------------------------------------- #
# Policy capture / repricing                                                  #
# --------------------------------------------------------------------------- #


class LsmcPolicy(NamedTuple):
    """A fitted exercise policy: everything the forward pass needs.

    The reference retains regression coefficients from the backward pass and
    reuses them in the forward pass within one calculation
    (``LsmcStorageValuation.cs:156, 206, 350, 394``).  A policy can be saved
    (``save``) and repriced against fresh path sets without re-running the
    backward induction — e.g. intraday re-pricing or standalone scenario
    runs.  The ``.npz`` file has the JAX package's six field names, so a file
    saved by either package loads in the other.
    """

    coeffs: torch.Tensor  # [m, B, G]
    mus: torch.Tensor  # [m, B]
    sds: torch.Tensor  # [m, B]
    vbars: torch.Tensor  # [m, G]
    cont_mean0: torch.Tensor  # [G]
    backward_npv: torch.Tensor  # scalar

    def save(self, path: str) -> None:
        np.savez(path, **{f: getattr(self, f).detach().cpu().numpy() for f in self._fields})

    @classmethod
    def from_numpy(cls, arrays, device="cuda") -> "LsmcPolicy":
        """The policy from a mapping or an object with the six fields (an
        ``.npz``, the JAX package's ``LsmcPolicy``, a dict of arrays), as
        float32 tensors on ``device``."""
        def field(name):
            a = getattr(arrays, name) if hasattr(arrays, "_fields") else arrays[name]
            return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)

        return cls(**{f: field(f) for f in cls._fields})

    @classmethod
    def load(cls, path: str, device="cuda") -> "LsmcPolicy":
        with np.load(path) as data:
            return cls.from_numpy(data, device)


def fit_policy(
    ctx: ValuationContext,
    reg_factors,  # [m+1, F, S] tensor (or array), or a StreamingFactorSource
    sim_vols,
    sim_drift,
    spec: BasisSpec,
    extra_decisions: int = 0,
    device="cuda",
) -> LsmcPolicy:
    """Run only the backward induction and capture the fitted policy."""
    device = torch.device(device)
    backward_npv, cont_mean0, coeffs, mus, sds, vbars = _backward_program(
        _on_device(reg_factors, device), _on_device(sim_vols, device), _on_device(sim_drift, device),
        device_inputs(ctx, device), **_program_statics(ctx, spec, extra_decisions))
    return LsmcPolicy(coeffs, mus, sds, vbars, cont_mean0, backward_npv)


def reprice(
    ctx: ValuationContext,
    policy: LsmcPolicy,
    val_factors,  # [m+1, F, S] tensor (or array), or a StreamingFactorSource
    sim_vols,
    sim_drift,
    spec: BasisSpec,
    discount_deltas: bool = False,
    extra_decisions: int = 0,
    collect_panels: bool = False,
    device="cuda",
) -> LsmcArrays:
    """Forward-simulate a previously fitted policy on a fresh path set."""
    device = torch.device(device)
    policy = LsmcPolicy(*(t.to(device) for t in policy))
    return _forward_program(
        _on_device(val_factors, device), _on_device(sim_vols, device), _on_device(sim_drift, device),
        policy.cont_mean0, policy.coeffs, policy.mus, policy.sds, policy.vbars,
        device_inputs(ctx, device), policy.backward_npv, discount_deltas=discount_deltas,
        collect_panels=collect_panels, **_program_statics(ctx, spec, extra_decisions))
