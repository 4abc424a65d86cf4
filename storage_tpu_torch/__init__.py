"""storage_tpu_torch — commodity storage valuation in PyTorch with CUDA kernels.

The PyTorch port of ``storage_tpu`` (the JAX package beside it, which stays
the reference).  It runs the multi-factor LSMC API —
``three_factor_seasonal_value`` / ``multi_factor_value`` with per-sim
panels, progress and cancellation (also through ``runtime.AsyncValuation``),
extra decisions and any ratchet interpolation — end to end on one CUDA
device: the host compile, the intrinsic DP, threefry path simulation (the
same draws as the JAX package for the same seed), and the backward and
forward LSMC passes through three hand-written CUDA kernels (``ops/csrc/``).
Horizons whose paths do not fit the device (hourly storage over years) are
streamed span by span from checkpointed factor states.  Beside it:
``intrinsic_value`` (linear or cubic-spline interpolation),
``MultiFactorModel`` (closed-form analytics), ``MultiFactorSpotSim`` (the
standalone simulator) and, in ``engines.lsmc``, ``fit_policy`` /
``LsmcPolicy`` / ``reprice`` (fit once, reprice many).  Every entry point
that takes ``device`` defaults to ``"cuda"``; on ``device="cpu"`` the
kernels' plain PyTorch versions run.  The tree engine, ``mesh`` and float64
are not ported yet.
"""
from __future__ import annotations

import logging

from .exceptions import InventoryConstraintsCannotBeFulfilledError, StorageError
from .storage import CmdtyStorage
from .types import InjectWithdrawRange, RatchetInterp, TriggerPricePoint, TriggerPriceProfile
from .engines.intrinsic import IntrinsicValuationResults, intrinsic_value
from .engines.lsmc import ValuationCancelledError
from .models.multi_factor import (
    MultiFactorModel,
    MultiFactorSpotSim,
    create_3_factor_season_params,
)
from .ops import launch_counts, reset_launch_counts
from .valuation import (
    MultiFactorValuationResults,
    multi_factor_value,
    three_factor_seasonal_value,
)
from .utils.frequencies import FREQ_TO_PERIOD_TYPE, SUPPORTED_FREQS
from .utils.basis import (
    Monomial,
    S,
    X,
    all_markov_powers_up_to,
    as_monomials,
    markov_factor_power,
    ones,
    parse_basis_functions,
    spot_price_power,
)

# The version of the JAX package this port tracks.
__version__ = "0.5.0"

logger: logging.Logger = logging.getLogger("storage_tpu_torch")
logger.addHandler(logging.NullHandler())



def numerics_provider() -> str:
    """Report the numerical backend (reference ``utils.numerics_provider``,
    which reported MKL vs managed — ``utils.py:311-312``): torch's version,
    its CUDA version and the first device's name, or that no CUDA device is
    visible."""
    import torch

    if torch.cuda.is_available():
        return (f"torch {torch.__version__} CUDA {torch.version.cuda} "
                f"device={torch.cuda.get_device_name(0)}")
    return f"torch {torch.__version__} (no CUDA device)"


__all__ = [
    "CmdtyStorage",
    "RatchetInterp",
    "InjectWithdrawRange",
    "TriggerPricePoint",
    "TriggerPriceProfile",
    "IntrinsicValuationResults",
    "intrinsic_value",
    "MultiFactorModel",
    "MultiFactorSpotSim",
    "MultiFactorValuationResults",
    "multi_factor_value",
    "three_factor_seasonal_value",
    "create_3_factor_season_params",
    "InventoryConstraintsCannotBeFulfilledError",
    "StorageError",
    "ValuationCancelledError",
    "FREQ_TO_PERIOD_TYPE",
    "SUPPORTED_FREQS",
    "parse_basis_functions",
    "as_monomials",
    "Monomial",
    "S",
    "X",
    "ones",
    "spot_price_power",
    "markov_factor_power",
    "all_markov_powers_up_to",
    "numerics_provider",
    "__version__",
    "launch_counts",
    "reset_launch_counts",
]
