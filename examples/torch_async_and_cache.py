"""Async valuation with progress streaming, cancellation and named caching on
storage_tpu_torch (the PyTorch port) — the inputs and output lines of
``examples/async_and_cache.py``: the notebook/service equivalent of the
reference Excel add-in's calc plumbing (``cmdty.StorageValueThreeFactor`` +
``cmdty.SubscribeProgress/Status``).

    python examples/torch_async_and_cache.py                # on the GPU
    python examples/torch_async_and_cache.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import pandas as pd

from storage_tpu_torch import CmdtyStorage, multi_factor_value
from storage_tpu_torch.runtime import AsyncValuation, default_cache

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
args = parser.parse_args()

storage = CmdtyStorage(
    "D", "2022-01-01", "2022-07-01",
    injection_cost=0.1, withdrawal_cost=0.2,
    min_inventory=0.0, max_inventory=10_000.0,
    max_injection_rate=300.0, max_withdrawal_rate=400.0,
)
default_cache.add("summer_storage", storage)

idx = pd.period_range("2022-01-01", "2022-07-01", freq="D")
fwd_curve = pd.Series(25.0 + 6.0 * np.sin(np.arange(len(idx)) / 30.0), index=idx)
vol_curve = pd.Series(0.8, index=idx)

task = AsyncValuation(
    multi_factor_value,
    default_cache.get("summer_storage"), "2022-01-01", 2_000.0, fwd_curve, None, None,
    factors=[(10.0, vol_curve), (0.0, vol_curve * 0.3)], factor_corrs=0.25,
    num_sims=5_000, basis_funcs="1 + s + x0 + x1 + x0**2", discount_deltas=True, seed=42,
    device=args.device,
)
task.subscribe_progress(lambda p: print(f"progress: {p:6.1%}"))
task.subscribe_status(lambda s: print(f"status:   {s.value}"))
default_cache.add("summer_calc", task.start())

results = task.result(timeout=1200)
print(f"NPV: {results.npv:,.0f}  (via cache: {default_cache.get_property('summer_calc', 'npv'):,.0f})")
