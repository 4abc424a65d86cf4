"""Discounting utilities.

Host-side equivalent of the reference's Act/365 continuously-compounded
discounter factories (``StorageHelper.cs:251-276``) and the per-period
discount-factor memoisation inside the valuation engines
(``LsmcStorageValuation.cs:131-143``).  Because all cash-flow dates are known
up-front once a valuation is configured, discount factors are precomputed on
the host into dense per-step arrays which the jitted engines consume directly.
"""
from __future__ import annotations

import math
from datetime import date
from typing import Callable, Union

import numpy as np
import pandas as pd

from .frequencies import to_day

DiscountFn = Callable[[date, date], float]


def act365_discounter_from_rate(interest_rate: float) -> DiscountFn:
    """Flat-rate Act/365 continuously-compounded discounter.

    Reference: ``StorageHelper.CreateAct65ContCompDiscounter(double)``
    (``StorageHelper.cs:275-276``).
    """

    def discount(present_day: date, cash_flow_day: date) -> float:
        if cash_flow_day <= present_day:
            return 1.0
        t = (cash_flow_day - present_day).days / 365.0
        return math.exp(-t * interest_rate)

    return discount


def act365_discounter_from_series(interest_rates: pd.Series) -> DiscountFn:
    """Discounter reading the zero rate for the cash-flow day from a daily series.

    Reference: ``StorageHelper.CreateAct65ContCompDiscounterFromSeries``
    (``StorageHelper.cs:251-260``).  Raises if the curve has no point for a
    requested cash-flow date, like the reference.
    """
    # Normalise the index to dates for O(1) lookup.
    rate_by_day = {}
    for idx, value in interest_rates.items():
        rate_by_day[to_day(idx)] = float(value)

    def discount(present_day: date, cash_flow_day: date) -> float:
        if cash_flow_day <= present_day:
            return 1.0
        rate = rate_by_day.get(cash_flow_day)
        if rate is None:
            raise ValueError(f"No interest rate provided for {cash_flow_day}.")
        t = (cash_flow_day - present_day).days / 365.0
        return math.exp(-t * rate)

    return discount


def as_discounter(
    interest_rates: Union[None, float, pd.Series, DiscountFn],
) -> DiscountFn:
    """Coerce a rate spec (None / flat float / daily series / callable) to a discounter."""
    if interest_rates is None:
        return lambda present, cash_flow: 1.0
    if isinstance(interest_rates, (int, float)):
        return act365_discounter_from_rate(float(interest_rates))
    if isinstance(interest_rates, pd.Series):
        return act365_discounter_from_series(interest_rates)
    if callable(interest_rates):
        return interest_rates
    raise TypeError(
        f"Cannot interpret object of type {type(interest_rates)!r} as a discount spec."
    )


def _exp_bitexact(x: np.ndarray) -> np.ndarray:
    """``math.exp`` per element: bit-equal to the scalar discounters (SIMD
    ``np.exp`` drifts by 1 ulp on some inputs, which would un-pin golden
    NPVs).  The arrays here are one element per decision period — trivial."""
    return np.array([math.exp(v) for v in x], dtype=np.float64)


def discount_factors_for_spec(
    interest_rates: Union[None, float, pd.Series, DiscountFn],
    present_day: date,
    cash_flow_days: np.ndarray,  # datetime64[D]
) -> np.ndarray:
    """Vectorised discount factors straight from a rate SPEC.

    The per-day ``DiscountFn`` path costs ~0.1 ms per distinct day in pandas
    date plumbing (at daily resolution that is most of the host share of a
    valuation), so the three declarative specs — None, flat rate, zero-rate
    series — are priced with array arithmetic here.  A custom callable spec
    keeps the reference's exact ``(present_day, cash_flow_day) -> df``
    contract via :func:`discount_factors_for_days`.

    Semantics match the scalar discounters exactly: days on or before
    ``present_day`` discount to 1.0 without consulting the curve, and a
    missing curve point for a future day raises (``StorageHelper.cs:251-260``).
    """
    days = np.asarray(cash_flow_days, dtype="datetime64[D]")
    if interest_rates is None:
        return np.ones(len(days), dtype=np.float64)
    present64 = np.datetime64(to_day(present_day), "D")
    future = days > present64
    if isinstance(interest_rates, (int, float)):
        t = (days - present64).astype(np.int64) / 365.0
        return np.where(future, _exp_bitexact(-t * float(interest_rates)), 1.0)
    if isinstance(interest_rates, pd.Series):
        from .frequencies import days_index

        idx = pd.DatetimeIndex(days_index(interest_rates.index))
        rates = pd.Series(interest_rates.to_numpy(dtype=np.float64), index=idx)
        # Same day listed twice keeps the LAST value, like the dict build in
        # act365_discounter_from_series.
        if idx.has_duplicates:
            rates = rates[~rates.index.duplicated(keep="last")]
        indexer = rates.index.get_indexer(pd.DatetimeIndex(days))
        missing = future & (indexer < 0)
        if missing.any():
            missing_day = days[missing][0].astype(object)
            raise ValueError(f"No interest rate provided for {missing_day}.")
        rate = rates.to_numpy()[np.where(indexer >= 0, indexer, 0)]
        t = (days - present64).astype(np.int64) / 365.0
        return np.where(future, _exp_bitexact(-t * rate), 1.0)
    return discount_factors_for_days(
        as_discounter(interest_rates), to_day(present_day), days.astype(object)
    )


def discount_factors_for_days(
    discounter: DiscountFn, present_day: date, cash_flow_days
) -> np.ndarray:
    """Vector of discount factors from ``present_day`` to each cash-flow day.

    The host-side analogue of the engines' memoised ``DiscountToCurrentDay``
    (``LsmcStorageValuation.cs:134-143``): each distinct day is priced once.
    """
    cache = {}
    out = np.empty(len(cash_flow_days), dtype=np.float64)
    for i, d in enumerate(cash_flow_days):
        d = to_day(d)
        df = cache.get(d)
        if df is None:
            df = discounter(present_day, d)
            cache[d] = df
        out[i] = df
    return out
