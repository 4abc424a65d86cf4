"""Multi-factor LSMC valuation — the pandas-facing API.

Mirrors ``multi_factor_value`` / ``three_factor_seasonal_value`` of the JAX
package (reference ``cmdty_storage/multi_factor.py:302-496``): runs the
intrinsic calculation first, then the LSMC engine on simulated paths, and
returns NPV, per-period deltas, the expected storage profile, trigger prices,
trigger volume/price profiles and (``return_sim_panels``, the default) the
per-sim panels.  The device work runs on ``device`` (default ``"cuda"``):
the LSMC and path kernels launch there, in ``dtype`` (float32 or float64:
each kernel has an instantiation of both).  With ``mesh`` (a
:class:`~storage_tpu_torch.parallel.mesh.PathsMesh`, e.g.
``paths_mesh(["cuda:0", "cuda:1"])``) the sims are split into equal shards
over its devices: each shard simulates its own window of both path sets and
runs the kernels on it, and the sums over the sims add the shards' partials
(the intrinsic value still runs on ``device``).  ``on_progress_update``/``cancelled``
run the engine span by span with the hooks between spans.  A path set larger
than the budget of ``STORAGE_TPU_MAX_PATH_BYTES`` (default 6e9) is streamed:
regenerated span by span from checkpointed factor states, never held whole.
"""
from __future__ import annotations

import functools
import logging
import os
from typing import Callable, Iterable, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import pandas as pd
import torch

from .compile import SettlementRule, build_valuation_context
from .engines.intrinsic import intrinsic_value_with_ctx
from .engines.lsmc import LsmcArrays, run_lsmc
from .exceptions import InventoryConstraintsCannotBeFulfilledError
from .models.multi_factor import (
    FactorCorrsType,
    FactorType,
    build_sim_coefficients,
    create_3_factor_season_params,
    validate_multi_factor_params,
)
from .models.simulation import (
    StreamingFactorSource, fold_in, prng_key, simulate_factor_paths, spots_from_factor_paths,
)
from .ops.csrc import check_dtype
from .ops.regression import basis_spec
from .parallel.mesh import replicate
from .storage import CmdtyStorage
from .types import TriggerPricePoint, TriggerPriceProfile
from .utils.basis import THREE_FACTOR_SEASONAL_ALIASES, BasisFunctionsType, as_monomials
from .utils.frequencies import PeriodLike, normalize_freq, to_period
from .utils.profiling import Stopwatches, active, host_wait, upload

logger: logging.Logger = logging.getLogger("storage_tpu_torch.multi_factor")

# Factor paths past this many bytes per path set are streamed (regenerated
# span by span from checkpoints) instead of materialised.  The variable's
# name is the JAX package's, so one setting governs both.
MAX_PATH_BYTES_ENV = "STORAGE_TPU_MAX_PATH_BYTES"
DEFAULT_MAX_PATH_BYTES = 6e9
# Longest streamed span, in steps.  The JAX package caps its spans at the
# 256 steps its forward kernel's on-chip memory allows; the CUDA kernels
# have no such limit, but the spans fix which periods are solved directly,
# so the same cap keeps NPV and progress values those of the JAX package.
STREAM_MAX_SPAN = 256


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


def _stream_span_length(max_path_bytes: float, per_step_bytes: int) -> int:
    """Steps per streamed span: ~1 GB of regenerated factors (and never more
    than a quarter of the budget, so a tiny budget still gives several
    spans), at least 64 and at most ``STREAM_MAX_SPAN`` steps.  The source
    rounds it up to a multiple of 16."""
    span_target = min(1e9, max_path_bytes / 4)
    return min(max(64, int(span_target // max(per_step_bytes, 1))), STREAM_MAX_SPAN)


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
    check_dtype("the valuation", dtype)
    device = torch.device(device)
    freq = normalize_freq(cmdty_storage.freq)
    val_period = to_period(val_date, freq)
    # A caller who asks for the profile gets the call's spans and counters,
    # and genuine phase attribution, which needs device syncs at phase
    # boundaries; only then are they paid for.
    stopwatches = Stopwatches(device, record=profile_sink is not None)
    stopwatches.sync = profile_sink is not None
    stopwatches.start("All")

    if inventory < 0:
        raise ValueError("Inventory cannot be negative.")
    if mesh is not None:
        ndev = int(np.prod(list(mesh.shape.values())))
        if num_sims % ndev:
            raise ValueError(
                f"num_sims ({num_sims}) must be divisible by the number of mesh "
                f"devices ({ndev}) so paths shard evenly."
            )

    # Edge cases (reference LsmcStorageValuation.cs:64-84).
    if val_period > cmdty_storage.end:
        if on_progress_update is not None:
            on_progress_update(1.0)
        return _empty_results(freq)
    if val_period == cmdty_storage.end:
        if cmdty_storage.must_be_empty_at_end:
            if inventory > 0:
                raise InventoryConstraintsCannotBeFulfilledError(
                    "Storage must be empty at end, but inventory is greater than zero."
                )
            if on_progress_update is not None:
                on_progress_update(1.0)
            return _empty_results(freq)
        spot = float(fwd_curve[val_period])
        npv = cmdty_storage.terminal_storage_npv(spot, float(inventory))
        if on_progress_update is not None:
            on_progress_update(1.0)
        return _empty_results(freq, npv=npv, intrinsic_npv=npv)

    with stopwatches.activate():
        with stopwatches.span("Compile"):
            ctx = build_valuation_context(
                cmdty_storage, val_date, inventory, fwd_curve, interest_rates, settlement_rule,
                num_inventory_grid_points, numerical_tolerance,
            )

        # Intrinsic calc first (reference multi_factor.py:404-410), sharing the
        # compiled context with the LSMC run below.
        logger.info("Calculating intrinsic value.")
        with stopwatches.span("Intrinsic"):
            intrinsic = intrinsic_value_with_ctx(ctx, device=device, dtype=dtype)
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
        # set can be freed before the valuation set allocates.  With panels, each
        # set's spot panel [m+1, S] is kept (on the device) as it is simulated.
        sims_cache = {}
        sim_vols = upload(coeffs.vols, device, dtype)
        sim_drift = upload(coeffs.log_fwd_drift, device, dtype)

        # Long-horizon x production-path configs (e.g. multi-year hourly) cannot
        # materialise the full [m+1, F, S] factor tensor on the device; past this
        # budget the engine streams paths span by span from checkpointed OU
        # states (the same draws bit for bit, see StreamingFactorSource).  Per-sim
        # panels are incompatible with streaming (they are O(n x S) themselves).
        # The budget counts bytes of the run's dtype, as the JAX package does.
        per_step_bytes = len(factors) * num_sims * torch.empty((), dtype=dtype).element_size()
        path_bytes = len(sim_periods) * per_step_bytes
        max_path_bytes = int(float(os.environ.get(MAX_PATH_BYTES_ENV, DEFAULT_MAX_PATH_BYTES)))
        streaming = path_bytes > max_path_bytes
        if streaming and return_sim_panels:
            raise ValueError(
                f"return_sim_panels=True requires materialising O(n_steps x "
                f"num_sims) panels, but this configuration's factor paths alone "
                f"({path_bytes / 1e9:.1f} GB) exceed the device budget "
                f"({max_path_bytes / 1e9:.1f} GB, {MAX_PATH_BYTES_ENV}); "
                "pass return_sim_panels=False."
            )
        if streaming:
            every = _stream_span_length(max_path_bytes, per_step_bytes)

            # The simulation stopwatches time the upfront CHECKPOINT pass only:
            # per-span regeneration is interleaved with consumption, so that part
            # of the simulation cost folds into BackwardInduction /
            # ForwardSimulation (unlike the materialised path's stopwatches).
            def simulate(key, phase, name):
                logger.info("Streaming %s path simulation (span=%d).", name, every)
                with stopwatches.time(phase):
                    return StreamingFactorSource(coeffs, num_sims, key, antithetic, every=every,
                                                 device=device, dtype=dtype, mesh=mesh).prepare()
        else:
            def simulate(key, phase, name):
                with stopwatches.time(phase):
                    f = simulate_factor_paths(coeffs, num_sims, antithetic=antithetic, key=key,
                                              device=device, dtype=dtype, mesh=mesh)
                    if stopwatches.sync:
                        stopwatches.synchronize()
                if return_sim_panels:
                    sims_cache[name] = _spot_panels(f, sim_vols, sim_drift)
                return f

        logger.info("Calculating LSMC value.")
        arrays = run_lsmc(
            ctx,
            lambda: simulate(reg_key, "RegressionPriceSimulation", "reg"),
            lambda: simulate(val_key, "ValuationPriceSimulation", "val"),
            sim_vols, sim_drift, spec,
            discount_deltas=discount_deltas,
            extra_decisions=int(extra_decisions or 0),
            device=device,
            on_progress_update=on_progress_update,
            cancelled=cancelled,
            collect_panels=return_sim_panels,
            stopwatches=stopwatches,
            dtype=dtype,
            mesh=mesh,
        )
        logger.info("Calculation of LSMC value complete.")

        with stopwatches.time("Assembly"):
            results, backward_npv = _assemble_results(
                ctx, arrays, intrinsic, sim_periods, sims_cache.get("reg"),
                sims_cache.get("val"))
        logger.info(
            "Forward Pv: %s; Backward Pv: %s",
            f"{results.npv:,.2f}",
            f"{backward_npv:,.2f}",
        )
        stopwatches.stop("All")
    if logger.isEnabledFor(logging.INFO):
        logger.info("Profiling Report:\n%s", stopwatches.generate_profile_report())
    if profile_sink is not None:
        profile_sink(stopwatches)
    return results


def _spot_panels(factors, sim_vols, sim_drift):
    """The spot panel ``[m+1, S]`` of a path set: one tensor, or one per shard
    (on its device) for a path set in shards."""
    if isinstance(factors, torch.Tensor):
        return spots_from_factor_paths(factors, sim_vols, sim_drift)
    devices = [f.device for f in factors]
    return [spots_from_factor_paths(f, vols, drift) for f, vols, drift in
            zip(factors, replicate(devices, sim_vols), replicate(devices, sim_drift))]


def _fetch_panel(panel, max_chunk_bytes: int = 256 * 2**20) -> np.ndarray:
    """Device->host copy of one ``[rows, S]`` panel, or of the list of its
    shards ``[rows, S_i]`` (concatenated in shard order), into a contiguous
    float64 host array, in blocks of rows of at most ``max_chunk_bytes``:
    each block is widened to float64 on the device and lands in its final
    place with one copy, so the host makes no second pass over the data (at
    1M paths a panel is 1.4 GB on the device and 2.7 GB on the host).

    In a recorded call it is a ``PanelFetch`` span and counts one
    ``panel_frames``, a ``panel_blocks`` for each block copied (each one
    ``host_wait``), the bytes the blocks carry to the host
    (``panel_d2h_bytes``) and the bytes of the host array
    (``panel_host_bytes``)."""
    sw = active()
    with sw.span("PanelFetch"):
        shards = [panel] if isinstance(panel, torch.Tensor) else list(panel)
        rows = shards[0].shape[0]
        S = sum(p.shape[1] for p in shards)
        out = np.empty((rows, S), dtype=np.float64)
        host = torch.from_numpy(out)
        step = max(1, max_chunk_bytes // max(S * out.itemsize, 1))
        col = 0
        for p in shards:
            dst = host[:, col:col + p.shape[1]]
            for a in range(0, rows, step):
                block = p[a:a + step]
                host_wait(dst[a:a + step].copy_, block.to(torch.float64))
                sw.count("panel_blocks")
                sw.count("panel_d2h_bytes", block.numel() * out.itemsize)
            col += p.shape[1]
    sw.count("panel_frames")
    sw.count("panel_host_bytes", out.nbytes)
    return out


def _panel_frame(panel, index) -> pd.DataFrame:
    """The frame of one per-sim panel (sims as columns; a tensor or the list
    of its shards), built on its host array without a copy; an empty frame
    when panels were not collected."""
    if panel is None:
        return pd.DataFrame(index=index)
    shards = [panel] if isinstance(panel, torch.Tensor) else panel
    if not sum(p.shape[-1] for p in shards):
        return pd.DataFrame(index=index)
    return pd.DataFrame(_fetch_panel(panel), index=index, copy=False)


def _assemble_results(
    ctx, arrays: LsmcArrays, intrinsic, sim_periods, reg_spots_sim=None, val_spots_sim=None,
) -> MultiFactorValuationResults:
    periods = ctx.periods
    freq = ctx.freq
    sim_index = pd.PeriodIndex(sim_periods, freq=freq)
    # Per-sim panels [n+1, 6, S] (or their shards): one contiguous host array per field.
    if isinstance(arrays.panels, torch.Tensor):
        fields = [arrays.panels[:, f] for f in range(6)]
    else:
        fields = [[p[:, f] for p in arrays.panels] for f in range(6)]
    panel_frames = [_panel_frame(field, periods) for field in fields]

    # One device->host transfer for every small output, in their promoted
    # dtype (float32 for a float32 run, float64 for a float64 one).
    small = [
        arrays.deltas, arrays.profile_means,
        arrays.trigger_has_inject, arrays.trigger_has_withdraw,
        arrays.trigger_inject_volumes, arrays.trigger_inject_prices,
        arrays.trigger_withdraw_volumes, arrays.trigger_withdraw_prices,
        arrays.npv, arrays.backward_npv,
    ]
    shapes = [tuple(a.shape) for a in small]
    batch_dtype = functools.reduce(torch.promote_types, (a.dtype for a in small))
    flat = host_wait(torch.cat([a.to(batch_dtype).reshape(-1) for a in small]).cpu).numpy()
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
        sim_spot_regress=_panel_frame(reg_spots_sim, sim_index),
        sim_spot_valuation=_panel_frame(val_spots_sim, sim_index),
        sim_inventory=panel_frames[0],
        sim_inject_withdraw=panel_frames[1],
        sim_cmdty_consumed=panel_frames[2],
        sim_inventory_loss=panel_frames[3],
        sim_net_volume=panel_frames[4],
        sim_pv=panel_frames[5],
        trigger_prices=trigger_prices,
        trigger_profiles=trigger_profiles,
    )
    return results, float(backward_npv_arr)
