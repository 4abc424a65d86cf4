"""Facility-schedule helpers: maintenance outages and inventory gates.

Equivalents of the reference repo's ``spec_helpers.py`` utilities:

- :func:`ratchets_with_maintenance` mirrors
  ``generate_ratchets_with_maintenances``: overlay maintenance days onto a
  ratchet schedule by scaling each day's inject/withdraw rates (0 = full
  outage), restoring the underlying schedule the following day.
- :func:`inventory_bounds_with_gates` mirrors
  ``generate_min_max_inventory_with_gates``: daily min/max inventory series
  with gate days where the facility must sit inside a tighter band (e.g.
  regulatory fill targets).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import pandas as pd

from .frequencies import PeriodLike, normalize_freq, to_period

RatchetTable = List[Tuple[float, float, float]]
RatchetSchedule = List[Tuple[PeriodLike, RatchetTable]]


def scale_ratchet_table(
    table: Iterable[Tuple[float, float, float]],
    withdraw_factor: float,
    inject_factor: float,
    inventory_factor: float = 1.0,
) -> RatchetTable:
    """Scale a single ratchet table's rates (and optionally inventories)."""
    return [
        (inv * inventory_factor, min_rate * withdraw_factor, max_rate * inject_factor)
        for inv, min_rate, max_rate in table
    ]


def ratchets_with_maintenance(
    base_ratchets: RatchetSchedule,
    maintenance: Iterable[Tuple[PeriodLike, float, float]],
    storage_end: PeriodLike,
    freq: str = "D",
) -> RatchetSchedule:
    """Overlay maintenance periods onto a ratchet schedule.

    Args:
      base_ratchets: ``[(period, [(inventory, min_rate, max_rate), ...]), ...]``
        — the normal operating schedule (each table applies from its period
        until the next).
      maintenance: ``[(period, inject_factor, withdraw_factor), ...]`` — on
        each maintenance period the applicable table's injection rates are
        scaled by ``inject_factor`` and withdrawal rates by
        ``withdraw_factor`` (0 = full outage).  The day after, the underlying
        schedule resumes.
      storage_end: the storage end period; a maintenance entry on the end
        period needs no resume entry.

    Returns a new schedule usable directly as ``CmdtyStorage(ratchets=...)``.
    """
    freq = normalize_freq(freq)
    base = sorted(
        ((to_period(p, freq), [tuple(r) for r in table]) for p, table in base_ratchets),
        key=lambda item: item[0],
    )
    if not base:
        raise ValueError("base_ratchets cannot be empty.")
    end_period = to_period(storage_end, freq)

    def table_at(period: pd.Period) -> RatchetTable:
        current = base[0][1]
        for p, table in base:
            if p <= period:
                current = table
            else:
                break
        return current

    schedule: Dict[pd.Period, RatchetTable] = {p: table for p, table in base}
    for period_like, inject_factor, withdraw_factor in maintenance:
        period = to_period(period_like, freq)
        if period < base[0][0]:
            raise ValueError(
                f"Maintenance period {period} precedes the first ratchet period {base[0][0]}."
            )
        underlying = table_at(period)
        schedule[period] = scale_ratchet_table(underlying, withdraw_factor, inject_factor)
        resume = period + 1
        # Add the resume entry unless the maintenance day itself is the
        # storage end (reference spec_helpers conditions on the maintenance
        # date, so a resume entry ON the end period is kept).
        if resume not in schedule and resume <= end_period:
            schedule[resume] = underlying

    return sorted(schedule.items(), key=lambda item: item[0])


def inventory_bounds_with_gates(
    storage_start: PeriodLike,
    storage_end: PeriodLike,
    max_inventory: float,
    gates: Iterable[Tuple[PeriodLike, float, float]],
    min_inventory: float = 0.0,
    freq: str = "D",
) -> Tuple[pd.Series, pd.Series]:
    """Min/max inventory series with gate-day bands.

    Args:
      gates: ``[(period, min_fraction, max_fraction), ...]`` — on each gate
        period the inventory must lie within
        ``[min_fraction * max_inventory, max_fraction * max_inventory]``.

    Returns ``(min_series, max_series)`` for ``CmdtyStorage(min_inventory=...,
    max_inventory=...)``.
    """
    freq = normalize_freq(freq)
    index = pd.period_range(
        start=to_period(storage_start, freq), end=to_period(storage_end, freq), freq=freq
    )
    min_series = pd.Series(float(min_inventory), index=index)
    max_series = pd.Series(float(max_inventory), index=index)
    for period_like, min_frac, max_frac in gates:
        period = to_period(period_like, freq)
        if period not in index:
            raise ValueError(f"Gate period {period} outside the storage range.")
        if not 0.0 <= min_frac <= max_frac <= 1.0:
            raise ValueError("Gate fractions must satisfy 0 <= min <= max <= 1.")
        min_series[period] = min_frac * max_inventory
        max_series[period] = max_frac * max_inventory
    return min_series, max_series
