"""Path-sharded valuation over a device mesh on storage_tpu_torch (the
PyTorch port) — the inputs and output lines of
``examples/multichip_sharding.py``.

On a GPU machine the mesh spans every visible card (one shard a card); with
``--device cpu`` it is a mesh of eight ``cpu`` entries, which runs the same
split on one host (``--num-sims`` cuts the path count for such a run):

    python examples/torch_multichip_sharding.py
    python examples/torch_multichip_sharding.py --device cpu --num-sims 8192
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import pandas as pd

from storage_tpu_torch import CmdtyStorage, multi_factor_value
from storage_tpu_torch.parallel.mesh import paths_mesh

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda", help="cuda (every visible card) or cpu")
parser.add_argument("--num-sims", type=int, default=131_072, help="paths (default: 131,072)")
args = parser.parse_args()

storage = CmdtyStorage(
    "D", "2022-01-01", "2022-04-01",
    injection_cost=0.1, withdrawal_cost=0.2,
    min_inventory=0.0, max_inventory=5_000.0,
    max_injection_rate=200.0, max_withdrawal_rate=250.0,
)
idx = pd.period_range("2022-01-01", "2022-04-01", freq="D")
fwd_curve = pd.Series(30.0 + 5.0 * np.sin(np.arange(len(idx)) / 12.0), index=idx)
vol_curve = pd.Series(0.9, index=idx)

# 1-D mesh over all visible cards (or eight CPU entries), axis 'paths'.
mesh = paths_mesh(["cpu"] * 8) if args.device == "cpu" else paths_mesh()
print(f"mesh: {mesh}")

results = multi_factor_value(
    storage, "2022-01-01", 1_000.0, fwd_curve, None, None,
    factors=[(8.0, vol_curve)], factor_corrs=None,
    num_sims=args.num_sims, basis_funcs="1 + x0 + x0**2 + x0**3",
    discount_deltas=False, seed=7,
    mesh=mesh,  # sims shard over 'paths'; the regressions' sums add the shards'
    return_sim_panels=False,
    device=args.device,
)
print(f"NPV: {results.npv:,.0f}")
