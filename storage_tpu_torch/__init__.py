"""storage_tpu_torch — commodity storage valuation in PyTorch with CUDA kernels.

The PyTorch port of ``storage_tpu`` (the JAX package beside it, which stays
the reference).  This slice runs the multi-factor LSMC main path —
``three_factor_seasonal_value`` / ``multi_factor_value`` — end to end on one
CUDA device: the host compile, the intrinsic DP, threefry path simulation
(the same draws as the JAX package for the same seed), and the backward and
forward LSMC passes through two hand-written CUDA kernels
(``ops/csrc/``).  CPU tensors run the kernels' plain PyTorch versions.
"""
from __future__ import annotations

import logging

from .exceptions import InventoryConstraintsCannotBeFulfilledError, StorageError
from .storage import CmdtyStorage
from .types import InjectWithdrawRange, RatchetInterp, TriggerPricePoint, TriggerPriceProfile
from .engines.intrinsic import IntrinsicValuationResults
from .models.multi_factor import create_3_factor_season_params
from .ops import launch_counts, reset_launch_counts
from .valuation import (
    MultiFactorValuationResults,
    multi_factor_value,
    three_factor_seasonal_value,
)

logger: logging.Logger = logging.getLogger("storage_tpu_torch")
logger.addHandler(logging.NullHandler())

__all__ = [
    "CmdtyStorage",
    "RatchetInterp",
    "InjectWithdrawRange",
    "TriggerPricePoint",
    "TriggerPriceProfile",
    "IntrinsicValuationResults",
    "MultiFactorValuationResults",
    "multi_factor_value",
    "three_factor_seasonal_value",
    "create_3_factor_season_params",
    "InventoryConstraintsCannotBeFulfilledError",
    "StorageError",
    "launch_counts",
    "reset_launch_counts",
]
