"""Forward-contract period-range helpers.

Reference: ``utils.to_period_range`` / ``_last_period``
(``cmdty_storage/utils.py:280-308``): a forward contract may be specified as a
single date-like, a (start, end) tuple, or a coarser-frequency ``pd.Period``
(e.g. a month within a daily curve).
"""
from __future__ import annotations

import re
from typing import Tuple

import pandas as pd

from .frequencies import normalize_freq, to_period


def _last_period(period: pd.Period, freq: str) -> pd.Period:
    """Last period of frequency ``freq`` inside ``period``."""
    if not freq[0].isdigit():
        return period.asfreq(freq, "e")
    match = re.match(r"(\d+)(\w+)", freq)
    num = int(match.group(1))
    sub_freq = match.group(2)
    return (period.asfreq(sub_freq, "e") - num + 1).asfreq(freq)


def to_period_range(freq: str, fwd_contract) -> Tuple[pd.Period, pd.Period]:
    """(start, end) periods of ``freq`` covered by the contract spec."""
    freq = normalize_freq(freq)
    if isinstance(fwd_contract, pd.Period):
        return fwd_contract.asfreq(freq, "s"), _last_period(fwd_contract, freq)
    if isinstance(fwd_contract, tuple):
        start, end = fwd_contract
    else:
        start = end = fwd_contract
    start_period = (
        start.asfreq(freq, "s") if isinstance(start, pd.Period) else to_period(start, freq)
    )
    end_period = (
        _last_period(end, freq) if isinstance(end, pd.Period) else to_period(end, freq)
    )
    return start_period, end_period
