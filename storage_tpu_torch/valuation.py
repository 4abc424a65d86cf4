"""Multi-factor LSMC valuation — the pandas-facing API.

Mirrors ``multi_factor_value`` / ``three_factor_seasonal_value`` of the JAX
package (reference ``cmdty_storage/multi_factor.py:302-496``): runs the
intrinsic calculation first, then the LSMC engine on simulated paths, and
returns NPV, per-period deltas, the expected storage profile, trigger prices
and trigger volume/price profiles.  The device work runs on ``device``
(default ``"cuda"``): the two LSMC kernels launch there.  Per-sim panels are
not ported yet, so ``return_sim_panels`` must be ``False``.
"""
from __future__ import annotations

import logging
from typing import Callable, Iterable, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import pandas as pd
import torch

from .compile import SettlementRule, build_valuation_context
from .engines.intrinsic import intrinsic_value_with_ctx
from .engines.lsmc import LsmcArrays, run_lsmc
from .exceptions import InventoryConstraintsCannotBeFulfilledError, not_ported
from .models.multi_factor import (
    FactorCorrsType,
    FactorType,
    build_sim_coefficients,
    create_3_factor_season_params,
    validate_multi_factor_params,
)
from .models.simulation import fold_in, prng_key, simulate_factor_paths
from .ops.regression import basis_spec
from .storage import CmdtyStorage
from .types import TriggerPricePoint, TriggerPriceProfile
from .utils.basis import THREE_FACTOR_SEASONAL_ALIASES, BasisFunctionsType, as_monomials
from .utils.frequencies import PeriodLike, normalize_freq, to_period
from .utils.profiling import Stopwatches

logger: logging.Logger = logging.getLogger("storage_tpu_torch.multi_factor")


class MultiFactorValuationResults(NamedTuple):
    """Reference ``MultiFactorValuationResults`` (``multi_factor.py:302-321``)."""

    npv: float
    deltas: pd.Series
    expected_profile: pd.DataFrame
    intrinsic_npv: float
    intrinsic_profile: pd.DataFrame
    sim_spot_regress: pd.DataFrame
    sim_spot_valuation: pd.DataFrame
    sim_inventory: pd.DataFrame
    sim_inject_withdraw: pd.DataFrame
    sim_cmdty_consumed: pd.DataFrame
    sim_inventory_loss: pd.DataFrame
    sim_net_volume: pd.DataFrame
    sim_pv: pd.DataFrame
    trigger_prices: pd.DataFrame
    trigger_profiles: pd.Series

    @property
    def extrinsic_npv(self) -> float:
        return self.npv - self.intrinsic_npv


def _empty_results(freq: str, npv: float = 0.0, intrinsic_npv: float = 0.0):
    empty_idx = pd.PeriodIndex([], freq=freq)
    empty_df = pd.DataFrame(index=empty_idx)
    empty_series = pd.Series(index=empty_idx, dtype=np.float64)
    return MultiFactorValuationResults(
        npv, empty_series, empty_df, intrinsic_npv, empty_df, empty_df, empty_df,
        empty_df, empty_df, empty_df, empty_df, empty_df, empty_df, empty_df,
        pd.Series(index=empty_idx, dtype=object),
    )


def three_factor_seasonal_value(
    cmdty_storage: CmdtyStorage,
    val_date: PeriodLike,
    inventory: float,
    fwd_curve: pd.Series,
    interest_rates: Union[None, float, pd.Series],
    settlement_rule: Optional[SettlementRule],
    spot_mean_reversion: float,
    spot_vol: float,
    long_term_vol: float,
    seasonal_vol: float,
    num_sims: int,
    basis_funcs: BasisFunctionsType,
    discount_deltas: bool,
    seed: Optional[int] = None,
    fwd_sim_seed: Optional[int] = None,
    extra_decisions: Optional[int] = None,
    num_inventory_grid_points: int = 100,
    numerical_tolerance: float = 1e-12,
    on_progress_update: Optional[Callable[[float], None]] = None,
    antithetic: bool = False,
    cancelled: Optional[Callable[[], bool]] = None,
    dtype=torch.float32,
    mesh=None,
    return_sim_panels: bool = True,
    profile_sink: Optional[Callable[[Stopwatches], None]] = None,
    device="cuda",
) -> MultiFactorValuationResults:
    """Three-factor seasonal LSMC valuation (reference ``multi_factor.py:324-354``).

    Basis functions may reference the factors as ``x_st`` (short-term),
    ``x_lt`` (long-term) and ``x_sw`` (seasonal wave); spot as ``s``.  The
    same ``seed`` draws the same threefry paths as the JAX package.
    """
    factors, factor_corrs = create_3_factor_season_params(
        cmdty_storage.freq, spot_mean_reversion, spot_vol, long_term_vol, seasonal_vol,
        to_period(val_date, normalize_freq(cmdty_storage.freq)), cmdty_storage.end,
    )
    monomials = as_monomials(basis_funcs, THREE_FACTOR_SEASONAL_ALIASES)
    return _multi_factor_calc(
        cmdty_storage, val_date, inventory, fwd_curve, interest_rates, settlement_rule,
        factors, factor_corrs, num_sims, monomials, discount_deltas, seed, fwd_sim_seed,
        extra_decisions, num_inventory_grid_points, numerical_tolerance,
        on_progress_update, antithetic, cancelled, dtype, mesh, return_sim_panels,
        profile_sink, device,
    )


def multi_factor_value(
    cmdty_storage: CmdtyStorage,
    val_date: PeriodLike,
    inventory: float,
    fwd_curve: pd.Series,
    interest_rates: Union[None, float, pd.Series],
    settlement_rule: Optional[SettlementRule],
    factors: Iterable[FactorType],
    factor_corrs: FactorCorrsType,
    num_sims: int,
    basis_funcs: BasisFunctionsType,
    discount_deltas: bool,
    seed: Optional[int] = None,
    fwd_sim_seed: Optional[int] = None,
    extra_decisions: Optional[int] = None,
    num_inventory_grid_points: int = 100,
    numerical_tolerance: float = 1e-12,
    on_progress_update: Optional[Callable[[float], None]] = None,
    antithetic: bool = False,
    cancelled: Optional[Callable[[], bool]] = None,
    dtype=torch.float32,
    mesh=None,
    return_sim_panels: bool = True,
    profile_sink: Optional[Callable[[Stopwatches], None]] = None,
    device="cuda",
) -> MultiFactorValuationResults:
    """General multi-factor LSMC valuation (reference ``multi_factor.py:357-383``)."""
    factors = list(factors)
    factor_corrs = validate_multi_factor_params(factors, factor_corrs)
    if normalize_freq(cmdty_storage.freq) != normalize_freq(fwd_curve.index.freqstr):
        raise ValueError("cmdty_storage and forward_curve have different frequencies.")
    monomials = as_monomials(basis_funcs)
    return _multi_factor_calc(
        cmdty_storage, val_date, inventory, fwd_curve, interest_rates, settlement_rule,
        factors, factor_corrs, num_sims, monomials, discount_deltas, seed, fwd_sim_seed,
        extra_decisions, num_inventory_grid_points, numerical_tolerance,
        on_progress_update, antithetic, cancelled, dtype, mesh, return_sim_panels,
        profile_sink, device,
    )


def _check_slice_options(extra_decisions, on_progress_update, cancelled, dtype, mesh,
                         return_sim_panels) -> None:
    """Options of the JAX API that this port does not run yet raise, naming
    the ROADMAP item that ports them."""
    if return_sim_panels:
        raise not_ported("return_sim_panels=True (per-sim panels); pass return_sim_panels=False",
                      "Queue 1 item 7")
    if extra_decisions:
        raise not_ported("extra_decisions > 0", "Queue 1 item 4")
    if on_progress_update is not None or cancelled is not None:
        raise not_ported("on_progress_update / cancelled (the chunked driver)", "Queue 1 item 6")
    if mesh is not None:
        raise not_ported("mesh (multi-device paths)", "Queue 1 item 10")
    if dtype != torch.float32:
        raise not_ported(f"dtype={dtype} (only float32 runs)", "Queue 1 item 12")


def _multi_factor_calc(
    cmdty_storage: CmdtyStorage,
    val_date: PeriodLike,
    inventory: float,
    fwd_curve: pd.Series,
    interest_rates,
    settlement_rule,
    factors: Sequence[FactorType],
    factor_corrs: np.ndarray,
    num_sims: int,
    monomials,
    discount_deltas: bool,
    seed: Optional[int],
    fwd_sim_seed: Optional[int],
    extra_decisions: Optional[int],
    num_inventory_grid_points: int,
    numerical_tolerance: float,
    on_progress_update,
    antithetic: bool,
    cancelled,
    dtype,
    mesh=None,
    return_sim_panels: bool = True,
    profile_sink=None,
    device="cuda",
) -> MultiFactorValuationResults:
    _check_slice_options(extra_decisions, on_progress_update, cancelled, dtype, mesh,
                         return_sim_panels)
    device = torch.device(device)
    freq = normalize_freq(cmdty_storage.freq)
    val_period = to_period(val_date, freq)
    stopwatches = Stopwatches(device)
    # Genuine phase attribution needs device syncs at phase boundaries; only
    # pay for them when the caller asked for the profile.
    stopwatches.sync = profile_sink is not None
    stopwatches.start("All")

    if inventory < 0:
        raise ValueError("Inventory cannot be negative.")

    # Edge cases (reference LsmcStorageValuation.cs:64-84).
    if val_period > cmdty_storage.end:
        return _empty_results(freq)
    if val_period == cmdty_storage.end:
        if cmdty_storage.must_be_empty_at_end:
            if inventory > 0:
                raise InventoryConstraintsCannotBeFulfilledError(
                    "Storage must be empty at end, but inventory is greater than zero."
                )
            return _empty_results(freq)
        spot = float(fwd_curve[val_period])
        npv = cmdty_storage.terminal_storage_npv(spot, float(inventory))
        return _empty_results(freq, npv=npv, intrinsic_npv=npv)

    ctx = build_valuation_context(
        cmdty_storage, val_date, inventory, fwd_curve, interest_rates, settlement_rule,
        num_inventory_grid_points, numerical_tolerance,
    )

    # Intrinsic calc first (reference multi_factor.py:404-410), sharing the
    # compiled context with the LSMC run below.
    logger.info("Calculating intrinsic value.")
    intrinsic = intrinsic_value_with_ctx(ctx, device=device)
    logger.info("Calculation of intrinsic value complete.")
    first_sim_step = 1 if ctx.val_date_is_first_step else 0
    sim_periods = list(ctx.periods[first_sim_step:])

    spec = basis_spec(monomials, num_factors=len(factors))

    # Path simulation: regression set + independent valuation set, keyed as
    # in the JAX package so that the same seed draws the same paths.
    coeffs = build_sim_coefficients(
        factors, factor_corrs, val_period, fwd_curve, sim_periods
    )
    if seed is None:
        seed = int(np.random.SeedSequence().entropy % (2**62))
    reg_key = prng_key(int(seed))
    val_key = fold_in(reg_key, 1) if fwd_sim_seed is None else prng_key(int(fwd_sim_seed))

    # Factories: the engine simulates each path set lazily so the regression
    # set can be freed before the valuation set allocates.
    def simulate(key, phase):
        with stopwatches.time(phase):
            f = simulate_factor_paths(coeffs, num_sims, antithetic=antithetic, key=key,
                                      device=device)
            if stopwatches.sync:
                stopwatches.synchronize()
        return f

    logger.info("Calculating LSMC value.")
    arrays = run_lsmc(
        ctx,
        lambda: simulate(reg_key, "RegressionPriceSimulation"),
        lambda: simulate(val_key, "ValuationPriceSimulation"),
        coeffs.vols, coeffs.log_fwd_drift, spec,
        discount_deltas=discount_deltas,
        device=device,
        stopwatches=stopwatches,
    )
    logger.info("Calculation of LSMC value complete.")

    results, backward_npv = _assemble_results(ctx, arrays, intrinsic, sim_periods)
    logger.info(
        "Forward Pv: %s; Backward Pv: %s",
        f"{results.npv:,.2f}",
        f"{backward_npv:,.2f}",
    )
    stopwatches.stop("All")
    logger.info("Profiling Report:\n%s", stopwatches.generate_profile_report())
    if profile_sink is not None:
        profile_sink(stopwatches)
    return results


def _assemble_results(
    ctx, arrays: LsmcArrays, intrinsic, sim_periods,
) -> MultiFactorValuationResults:
    periods = ctx.periods
    freq = ctx.freq
    sim_index = pd.PeriodIndex(sim_periods, freq=freq)
    empty_panel = pd.DataFrame(index=periods)

    # One device->host transfer for every small output.
    small = [
        arrays.deltas, arrays.profile_means,
        arrays.trigger_has_inject, arrays.trigger_has_withdraw,
        arrays.trigger_inject_volumes, arrays.trigger_inject_prices,
        arrays.trigger_withdraw_volumes, arrays.trigger_withdraw_prices,
        arrays.npv, arrays.backward_npv,
    ]
    shapes = [tuple(a.shape) for a in small]
    flat = torch.cat([a.to(torch.float32).reshape(-1) for a in small]).cpu().numpy()
    flat = flat.astype(np.float64)
    fetched, off = [], 0
    for shp in shapes:
        size = int(np.prod(shp)) if shp else 1
        fetched.append(flat[off : off + size].reshape(shp))
        off += size
    (deltas_np, profile_means, has_inj_f, has_wdr_f, inj_vols, inj_prices,
     wdr_vols, wdr_prices, npv_arr, backward_npv_arr) = fetched

    deltas = pd.Series(deltas_np, index=periods)

    # Expected storage profile: reduced over sims ON DEVICE inside the engine;
    # only [n+1, 6] transits the host link (per-sim panels can be GBs at
    # production path counts).
    profile = pd.DataFrame(
        {
            "inventory": profile_means[:, 0],
            "inject_withdraw_volume": profile_means[:, 1],
            "cmdty_consumed": profile_means[:, 2],
            "inventory_loss": profile_means[:, 3],
            "net_volume": profile_means[:, 4],
            "period_pv": profile_means[:, 5],
        },
        index=periods,
    )

    # Trigger prices: scalar summary per decision period.  The reference keeps
    # the price at the max inject volume on the inject side, and the price of
    # the smallest withdrawal increment on the withdraw side
    # (LsmcStorageValuation.cs:525-526, 545-554).
    has_inj = has_inj_f > 0.5
    has_wdr = has_wdr_f > 0.5

    decision_index = periods[:-1]
    nan = np.nan
    trigger_prices = pd.DataFrame(
        {
            "inject_volume": np.where(has_inj, inj_vols[:, -1], nan),
            "inject_trigger_price": np.where(has_inj, inj_prices[:, -1], nan),
            "withdraw_volume": np.where(has_wdr, wdr_vols[:, -1], nan),
            "withdraw_trigger_price": np.where(has_wdr, wdr_prices[:, 0], nan),
        },
        index=decision_index,
    )

    profiles_list: List[TriggerPriceProfile] = []
    for k in range(len(decision_index)):
        inject_points = (
            [TriggerPricePoint(v, p) for v, p in zip(inj_vols[k], inj_prices[k])]
            if has_inj[k]
            else []
        )
        withdraw_points = (
            [TriggerPricePoint(v, p) for v, p in zip(wdr_vols[k], wdr_prices[k])]
            if has_wdr[k]
            else []
        )
        profiles_list.append(TriggerPriceProfile(inject_points, withdraw_points))
    trigger_profiles = pd.Series(profiles_list, index=decision_index, dtype=object)

    results = MultiFactorValuationResults(
        npv=float(npv_arr),
        deltas=deltas,
        expected_profile=profile,
        intrinsic_npv=intrinsic.npv,
        intrinsic_profile=intrinsic.profile,
        sim_spot_regress=pd.DataFrame(index=sim_index),
        sim_spot_valuation=pd.DataFrame(index=sim_index),
        sim_inventory=empty_panel,
        sim_inject_withdraw=empty_panel,
        sim_cmdty_consumed=empty_panel,
        sim_inventory_loss=empty_panel,
        sim_net_volume=empty_panel,
        sim_pv=empty_panel,
        trigger_prices=trigger_prices,
        trigger_profiles=trigger_profiles,
    )
    return results, float(backward_npv_arr)
