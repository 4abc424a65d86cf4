"""Day-count conventions.

Replaces the reference's ``cmdty_storage/time_func.py`` (act_365) and the .NET
``TimeFunctions.Act365`` used by the spot-price simulator.
"""
from __future__ import annotations

import numpy as np
import pandas as pd

from .frequencies import PeriodLike


def _to_timestamp(date_like: PeriodLike) -> pd.Timestamp:
    """Full-resolution timestamp (periods map to their start time).

    Sub-day resolution matters for intra-day storage granularities: the
    reference's .NET ``TimeFunctions.Act365`` works on ``DateTime`` start
    times, not calendar days.
    """
    if isinstance(date_like, pd.Period):
        return date_like.start_time
    return pd.Timestamp(date_like)


def act_365(start: PeriodLike, end: PeriodLike) -> float:
    """Act/365 year fraction between two date-likes at timestamp resolution.

    Reference: ``cmdty_storage/time_func.py:30-33`` (Python wrapper, whole
    days) and .NET ``TimeFunctions.Act365`` (sub-day, used by the simulator).
    """
    delta = _to_timestamp(end) - _to_timestamp(start)
    return delta.total_seconds() / (86_400.0 * 365.0)


def act_365_array(start: PeriodLike, ends) -> np.ndarray:
    """Vectorised Act/365 year fractions from ``start`` to each element of ``ends``."""
    start_ts = _to_timestamp(start)
    return np.array(
        [(_to_timestamp(e) - start_ts).total_seconds() / (86_400.0 * 365.0) for e in ends],
        dtype=np.float64,
    )
