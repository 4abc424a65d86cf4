"""Small public value types, mirroring the reference's (root of ``src/Cmdty.Storage/``)."""
from __future__ import annotations

import enum
from typing import List, NamedTuple


class InjectWithdrawRange(NamedTuple):
    """Validated (min, max) inject/withdraw rate pair.

    Reference: ``InjectWithdrawRange.cs`` and the Python mirror
    (``cmdty_storage.py:42-44``).  Negative rates are withdrawals.
    """

    min_inject_withdraw_rate: float
    max_inject_withdraw_rate: float


class RatchetInterp(enum.Enum):
    """Ratchet-table interpolation mode.

    LINEAR and STEP mirror the reference Python wrapper
    (``cmdty_storage.py:47-49``); POLYNOMIAL mirrors the C#-only
    ``InterpolationType.Polynomial`` (``PolynomialInjectWithdrawConstraint.cs``,
    exact-fit polynomial of order num_pillars - 1 through the ratchet points).
    """

    LINEAR = 1
    STEP = 2
    POLYNOMIAL = 3


class TriggerPricePoint(NamedTuple):
    """(volume, price) pair — reference ``multi_factor.py:292-294``."""

    volume: float
    price: float


class TriggerPriceProfile(NamedTuple):
    """Per-period ladders of inject/withdraw trigger points
    (reference ``multi_factor.py:297-299``)."""

    inject_triggers: List[TriggerPricePoint]
    withdraw_triggers: List[TriggerPricePoint]
