"""Multi-factor forward-curve model: validation, closed-form analytics,
seasonal parameterisation, and the standalone path-simulator API.

Replaces the reference's ``cmdty_storage/multi_factor.py`` public surface
(``MultiFactorModel``, ``MultiFactorSpotSim``, ``create_3_factor_season_params``,
``_validate_multi_factor_params``) with the same semantics, ported from the
JAX package's ``models/multi_factor.py``.  The analytics are host-side
NumPy/pandas in float64; simulation runs through
:mod:`storage_tpu_torch.models.simulation` (the path kernel on a CUDA device).
"""
from __future__ import annotations

import math
from datetime import date, datetime
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import pandas as pd

from ..utils.daycount import act_365
from ..utils.frequencies import PeriodLike, normalize_freq, to_period
from .simulation import sim_coefficients, simulate_spot_paths

CurveType = Union[pd.Series, Dict]
FactorType = Tuple[float, CurveType]
FactorCorrsType = Optional[Union[float, int, np.ndarray]]
TimeFunctionType = object  # Callable[[date-like, date-like], float]

DAYS_PER_YEAR = 365.25
SECONDS_PER_YEAR = 60 * 60 * 24 * DAYS_PER_YEAR


def validate_multi_factor_params(
    factors: Sequence[FactorType], factor_corrs: FactorCorrsType
) -> np.ndarray:
    """Validate factors and coerce the correlation spec to a matrix.

    Reference: ``_validate_multi_factor_params`` (``multi_factor.py:112-147``):
    single factor defaults to [[1]], two factors accept a scalar correlation,
    the matrix must be square with unit diagonal and entries in [-1, 1], and
    mean reversions must be non-negative.
    """
    factors = list(factors)
    n = len(factors)
    if n == 0:
        raise ValueError("factors cannot be empty.")

    # Shorthand correlation specs: omitted for one factor, scalar for two.
    if factor_corrs is None and n == 1:
        factor_corrs = 1.0
    if isinstance(factor_corrs, (int, float)):
        c = float(factor_corrs)
        factor_corrs = np.full((n, n), c) if n == 2 else np.array([[c]])
        np.fill_diagonal(factor_corrs, 1.0)

    corr = np.asarray(factor_corrs, dtype=np.float64)
    if corr.ndim != 2 or corr.shape[0] != corr.shape[1]:
        raise ValueError(
            f"factor_corrs must be a square matrix; got an array of shape {corr.shape} "
            "(not square / not 2-D)."
        )
    if corr.shape[0] != n:
        raise ValueError(
            f"Correlation matrix is {corr.shape[0]}x{corr.shape[0]} but {n} factors "
            "were supplied; the sizes must agree."
        )

    bad_diag = np.flatnonzero(~np.isclose(np.diag(corr), 1.0))
    if bad_diag.size:
        i = int(bad_diag[0])
        raise ValueError(
            f"Every diagonal entry of factor_corrs must equal 1; entry ({i}, {i}) "
            f"is {corr[i, i]}."
        )
    off_mask = (np.abs(corr) > 1.0) & ~np.eye(n, dtype=bool)
    if off_mask.any():
        i, j = (int(a) for a in np.argwhere(off_mask)[0])
        raise ValueError(
            f"Off-diagonal correlation ({i}, {j}) = {corr[i, j]} lies outside [-1, 1]."
        )

    mean_reversions = np.array([mr for mr, _vol in factors], dtype=np.float64)
    neg = np.flatnonzero(mean_reversions < 0.0)
    if neg.size:
        i = int(neg[0])
        raise ValueError(
            f"Factor {i} has negative mean reversion {mean_reversions[i]}; "
            "mean reversions must be >= 0."
        )
    return corr


def _curve_lookup(vol_curve: CurveType, contract, factor_num: int) -> float:
    """Exact lookup of a vol-curve point (reference ``_get_factor_vol``,
    ``multi_factor.py:231-238``)."""
    if isinstance(vol_curve, pd.Series):
        freq = vol_curve.index.freqstr
        key = to_period(contract, freq) if not isinstance(contract, pd.Period) else contract
        if key in vol_curve.index:
            return float(vol_curve[key])
    else:
        if contract in vol_curve:
            return float(vol_curve[contract])
        # Date-like keys may be spelled differently; fall back to day equality.
        for k, v in vol_curve.items():
            try:
                if _as_day(k) == _as_day(contract):
                    return float(v)
            except (TypeError, ValueError):
                continue
    curve_name = "fwd curve" if factor_num < 0 else f"vol curve of factor {factor_num}"
    raise ValueError(f"No point in {curve_name} at contract {contract!r}.")


def _curve_sample(curve: CurveType, sim_periods, period_index, factor_num: int) -> np.ndarray:
    """Sample a curve at every simulated period.

    Fast path: a Series at the simulation frequency is sampled with one
    vectorised ``get_indexer`` (the per-period :func:`_curve_lookup` costs
    ~70 us each in pandas scalar plumbing).  Exact-lookup semantics are
    preserved: any period without a curve point raises the same error, via
    the scalar path so dict curves / date-spelled keys keep their fallbacks.
    """
    if (
        period_index is not None
        and isinstance(curve, pd.Series)
        and isinstance(curve.index, pd.PeriodIndex)
        and curve.index.freqstr == period_index.freqstr
        and not curve.index.has_duplicates
    ):
        indexer = curve.index.get_indexer(period_index)
        if (indexer >= 0).all():
            return curve.to_numpy(dtype=np.float64)[indexer]
        missing = period_index[int(np.flatnonzero(indexer < 0)[0])]
        curve_name = "fwd curve" if factor_num < 0 else f"vol curve of factor {factor_num}"
        raise ValueError(f"No point in {curve_name} at contract {missing!r}.")
    return np.array(
        [_curve_lookup(curve, p, factor_num) for p in sim_periods], dtype=np.float64
    )


def _as_day(date_like) -> date:
    if isinstance(date_like, pd.Period):
        ts = date_like.start_time
        return date(ts.year, ts.month, ts.day)
    if isinstance(date_like, str):
        ts = pd.Timestamp(date_like)
        return date(ts.year, ts.month, ts.day)
    if isinstance(date_like, datetime):
        return date_like.date()
    if isinstance(date_like, date):
        return date_like
    raise TypeError(type(date_like))


class MultiFactorModel:
    """Closed-form analytics of the multi-factor model.

    Reference: the pure-Python mirror class (``multi_factor.py:151-251``) —
    integrated covariance/variance/vol/correlation of forward contracts under

        dF(t,T)/F = sum_i sigma_i(T) e^{-alpha_i (T-t)} dW_i.
    """

    _corr_tolerance = 1e-10

    def __init__(
        self,
        freq: str,
        factors: Iterable[FactorType],
        factor_corrs: FactorCorrsType = None,
        time_func: Optional[TimeFunctionType] = None,
    ):
        factors = list(factors)
        self._factor_corrs = validate_multi_factor_params(factors, factor_corrs)
        self._factors = factors
        self._time_func = act_365 if time_func is None else time_func
        self._freq = freq

    @property
    def num_factors(self) -> int:
        return len(self._factors)

    def integrated_covar(self, obs_start, obs_end, fwd_contract_1, fwd_contract_2) -> float:
        """Covariance of ln F(., T1) and ln F(., T2) observed over
        [obs_start, obs_end] (``multi_factor.py:166-187``)."""
        obs_end_t = self._time_func(obs_start, obs_end)
        if obs_end_t < 0.0:
            raise ValueError("obs_end cannot be before obs_start.")
        fwd_1_t = self._time_func(obs_start, fwd_contract_1)
        fwd_2_t = self._time_func(obs_start, fwd_contract_2)

        # Vectorised over factor pairs: cov = sum_ij rho_ij v1_i v2_j
        #   e^{-a_i T1 - a_j T2} * integral_0^t e^{(a_i+a_j) u} du.
        mr = np.array([m for m, _ in self._factors])
        v1 = np.array([_curve_lookup(vc, fwd_contract_1, i) for i, (_, vc) in enumerate(self._factors)])
        v2 = np.array([_curve_lookup(vc, fwd_contract_2, j) for j, (_, vc) in enumerate(self._factors)])
        x = mr[:, None] + mr[None, :]
        with np.errstate(invalid="ignore"):
            time_term = np.where(x == 0.0, obs_end_t, np.expm1(x * obs_end_t) / np.where(x == 0.0, 1.0, x))
        decay = np.exp(-mr[:, None] * fwd_1_t - mr[None, :] * fwd_2_t)
        return float(np.sum(self._factor_corrs * np.outer(v1, v2) * decay * time_term))

    def integrated_variance(self, obs_start, obs_end, fwd_contract) -> float:
        return self.integrated_covar(obs_start, obs_end, fwd_contract, fwd_contract)

    def integrated_stan_dev(self, obs_start, obs_end, fwd_contract) -> float:
        return math.sqrt(self.integrated_variance(obs_start, obs_end, fwd_contract))

    def integrated_vol(self, val_date, expiry, fwd_contract) -> float:
        time_to_expiry = self._time_func(val_date, expiry)
        if time_to_expiry <= 0:
            raise ValueError("val_date must be before expiry.")
        return math.sqrt(
            self.integrated_variance(val_date, expiry, fwd_contract) / time_to_expiry
        )

    def integrated_corr(self, obs_start, obs_end, fwd_contract_1, fwd_contract_2) -> float:
        covariance = self.integrated_covar(obs_start, obs_end, fwd_contract_1, fwd_contract_2)
        var_1 = self.integrated_variance(obs_start, obs_end, fwd_contract_1)
        var_2 = self.integrated_variance(obs_start, obs_end, fwd_contract_2)
        corr = covariance / math.sqrt(var_1 * var_2)
        if 1.0 < corr < 1.0 + self._corr_tolerance:
            return 1.0
        if -1.0 - self._corr_tolerance < corr < -1.0:
            return -1.0
        return corr

    @staticmethod
    def for_3_factor_seasonal(
        freq: str,
        spot_mean_reversion: float,
        spot_vol: float,
        long_term_vol: float,
        seasonal_vol: float,
        start,
        end,
        time_func: Optional[TimeFunctionType] = None,
    ) -> "MultiFactorModel":
        factors, factor_corrs = create_3_factor_season_params(
            freq, spot_mean_reversion, spot_vol, long_term_vol, seasonal_vol, start, end
        )
        return MultiFactorModel(freq, factors, factor_corrs, time_func)


def create_3_factor_season_params(
    freq: str,
    spot_mean_reversion: float,
    spot_vol: float,
    long_term_vol: float,
    seasonal_vol: float,
    start: PeriodLike,
    end: PeriodLike,
) -> Tuple[List[FactorType], np.ndarray]:
    """Three-factor seasonal parameterisation.

    Reference: ``create_3_factor_season_params`` (``multi_factor.py:258-289``)
    and the .NET ``MultiFactorParameters.For3FactorSeasonal``: a mean-reverting
    spot factor, a zero-MR long-term factor, and a zero-MR seasonal factor
    whose vol is a sinusoid of amplitude ``seasonal_vol / 2`` peaking each
    Feb-1 (phase pi/2), all mutually uncorrelated.
    """
    factor_corrs = np.eye(3, dtype=np.float64)
    norm_freq = normalize_freq(freq)
    start_period = to_period(start, norm_freq)
    end_period = to_period(end, norm_freq)
    index = pd.period_range(start=start_period, end=end_period, freq=norm_freq)
    long_term_vol_curve = pd.Series(index=index, data=[long_term_vol] * len(index))
    spot_vol_curve = pd.Series(index=index.copy(), data=[spot_vol] * len(index))

    peak_period = pd.Period(year=start_period.year, month=2, day=1, freq=norm_freq)
    phase = np.pi / 2.0
    amplitude = seasonal_vol / 2.0
    # Vectorised (p.start_time - peak).total_seconds(): bit-equal to the
    # per-period loop (both divide the same integer-ns delta by 1e9) without
    # 342 pandas Period.start_time calls.
    t_from_peak = (
        (index.to_timestamp() - peak_period.start_time).total_seconds()
        / SECONDS_PER_YEAR
    ).to_numpy()
    seasonal_vol_curve = pd.Series(
        index=index.copy(), data=np.sin(2.0 * np.pi * t_from_peak + phase) * amplitude
    )
    factors: List[FactorType] = [
        (spot_mean_reversion, spot_vol_curve),
        (0.0, long_term_vol_curve),
        (0.0, seasonal_vol_curve),
    ]
    return factors, factor_corrs


def build_sim_coefficients(
    factors: Sequence[FactorType],
    factor_corrs: np.ndarray,
    current_date,
    fwd_curve: CurveType,
    sim_periods: Sequence[pd.Period],
    time_func=None,
):
    """Assemble :class:`SimCoefficients` for a list of simulation periods.

    Vol and forward curves are sampled by **exact lookup** per simulated
    period, mirroring the reference simulator's dictionary-curve contract.
    """
    if isinstance(sim_periods, pd.PeriodIndex):
        period_index = sim_periods
    elif (
        isinstance(sim_periods, (list, tuple))
        and sim_periods
        and all(isinstance(p, pd.Period) for p in sim_periods)
    ):
        period_index = pd.PeriodIndex(sim_periods)
    else:
        period_index = None
    if time_func is None and period_index is not None:
        # Vectorised act_365 over the whole index: bit-equal to the scalar
        # loop (same integer-ns delta / 1e9 / (86_400 * 365)).
        from ..utils.daycount import _to_timestamp

        times = (
            (period_index.to_timestamp() - _to_timestamp(current_date))
            .total_seconds()
            .to_numpy()
            / (86_400.0 * 365.0)
        )
    else:
        scalar_tf = time_func or act_365
        times = np.array(
            [scalar_tf(current_date, p) for p in sim_periods], dtype=np.float64
        )
    if np.any(times <= 0.0):
        raise ValueError("All simulated periods must be after the current date.")
    num_factors = len(factors)
    vols = np.empty((len(sim_periods), num_factors), dtype=np.float64)
    for f, (_mr, vol_curve) in enumerate(factors):
        vols[:, f] = _curve_sample(vol_curve, sim_periods, period_index, f)
    forwards = _curve_sample(fwd_curve, sim_periods, period_index, -1)
    mean_reversions = np.array([mr for mr, _ in factors], dtype=np.float64)
    return sim_coefficients(mean_reversions, vols, factor_corrs, times, forwards)


class MultiFactorSpotSim:
    """Standalone spot-price simulator returning a (periods x sims) DataFrame.

    API mirrors the reference class (``multi_factor.py:49-92``); the RNG is
    threefry (the JAX package's draws for the same seed) instead of Mersenne
    Twister, so seeded values differ from the reference but are deterministic
    per seed.  On a CUDA ``device`` (the default) the paths come from one
    launch of the path kernel.

    .. note:: Seeded values are reproducible **per release only**: a kernel
       re-layout may re-key the RNG stream at any minor version, so pin the
       package version next to any pinned seed values.
    """

    def __init__(
        self,
        freq: str,
        factors: Iterable[FactorType],
        factor_corrs: FactorCorrsType,
        current_date: Union[datetime, date, str, pd.Period],
        fwd_curve: CurveType,
        sim_periods: Iterable[Union[pd.Period, datetime, date, str]],
        seed: Optional[int] = None,
        antithetic: bool = False,
        time_func=None,
        device="cuda",
    ):
        factors = list(factors)
        factor_corrs = validate_multi_factor_params(factors, factor_corrs)
        norm_freq = normalize_freq(freq)
        self._sim_periods = [
            p if isinstance(p, pd.Period) else to_period(p, norm_freq) for p in sim_periods
        ]
        self._coeffs = build_sim_coefficients(
            factors, factor_corrs, current_date, fwd_curve, self._sim_periods, time_func
        )
        self._freq = norm_freq
        self._seed = seed
        self._antithetic = antithetic
        self._device = device
        self._num_factors = len(factors)

    def simulate(self, num_sims: int) -> pd.DataFrame:
        spots, _factors = self.simulate_with_factors(num_sims)
        period_index = pd.PeriodIndex(data=self._sim_periods, freq=self._freq)
        return pd.DataFrame(data=spots.cpu().numpy(), index=period_index)

    def simulate_with_factors(self, num_sims: int):
        """Spots and Markov factor states as tensors (``[n, S]``, ``[n, F, S]``)."""
        return simulate_spot_paths(
            self._coeffs, num_sims, self._seed, self._antithetic, device=self._device
        )
