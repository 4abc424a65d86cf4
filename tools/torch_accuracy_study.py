"""The 0.1 %-accuracy case on storage_tpu_torch: converged LSMC against a
fine-grid trinomial tree, and float32 against float64 at the same seed.

The port's counterpart of ``benchmarks/accuracy_study.py``, with its own
copies of that study's case and helpers (the same 1-factor OU storage, a
dense inventory grid ``GRID = 500`` for both engines, the quartic basis,
seeds 11 / 23 / 47, 262,144 paths):

* the tree is the quasi-exact benchmark: float64 trinomial DP on the grid;
* LSMC (float32, the CUDA kernels) is a lower-bound estimator of the same
  value, so the signed gap should sit slightly below zero; the study's
  criterion is |gap| <= 0.1 % for every seed;
* the drift leg prices the first seed in float32 and in float64 at the full
  path count.  The seed is the same, but a float64 normal takes both words
  of its threefry hash (as in the JAX package), so the two legs draw other
  paths: the drift holds the two legs' Monte-Carlo difference beside the
  precision error.

Run (GPU, or ``--device cpu`` at a cut size):

    python tools/torch_accuracy_study.py [--num-sims N] [--seeds 11 23 47] [--device cuda]

Prints one JSON line (the JAX study's keys, plus the card's name and power
limit as ``nvidia-smi`` gives them) and writes it to
``chiprun_out/torch_accuracy_study.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import pandas as pd
import torch

MEAN_REVERSION = 5.0
GRID = 500  # dense inventory grid for both engines
BASIS = "1 + x0 + x0**2 + x0**3 + x0**4"
NUM_SIMS = 262_144
SEEDS = (11, 23, 47)
GAP_MAX = 1e-3  # the study's criterion: |LSMC / tree - 1| per seed
OUT = os.path.join(os.path.dirname(__file__), "..", "chiprun_out", "torch_accuracy_study.json")


def build_case():
    """The 1-factor OU storage case both engines price identically
    (``benchmarks/accuracy_study.py::build_case``)."""
    from storage_tpu_torch import CmdtyStorage

    storage = CmdtyStorage(
        "D", "2021-01-01", "2021-03-01",
        injection_cost=0.3, withdrawal_cost=0.4,
        min_inventory=0.0, max_inventory=2000.0,
        max_injection_rate=60.0, max_withdrawal_rate=80.0,
    )
    idx = pd.period_range("2021-01-01", "2021-03-01", freq="D")
    fwd = pd.Series(20.0 + 3.0 * np.sin(np.arange(len(idx)) / 8.0), index=idx)
    vols = pd.Series(0.7, index=idx)
    return storage, fwd, vols


def tree_value(storage, fwd, vols, device="cuda", grid=GRID) -> float:
    """Quasi-exact benchmark: float64 trinomial DP on the dense grid."""
    from storage_tpu_torch import trinomial_value

    return float(trinomial_value(
        storage, "2021-01-01", 800.0, fwd, vols, MEAN_REVERSION, 1 / 365.0, None, None,
        num_inventory_grid_points=grid, dtype=torch.float64, device=device))


def lsmc_value(storage, fwd, vols, num_sims, seed, dtype=torch.float32, device="cuda",
               grid=GRID) -> float:
    from storage_tpu_torch import multi_factor_value

    res = multi_factor_value(
        storage, "2021-01-01", 800.0, fwd, None, None,
        factors=[(MEAN_REVERSION, vols)], factor_corrs=None,
        num_sims=num_sims, basis_funcs=BASIS, discount_deltas=False, seed=seed,
        num_inventory_grid_points=grid, return_sim_panels=False, dtype=dtype, device=device)
    return float(res.npv)


def card_name(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or the device."""
    if torch.device(device).type != "cuda":
        return str(device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"


def _timed(fn, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_study(num_sims=NUM_SIMS, seeds=SEEDS, device="cuda", log=None):
    """The study: the tree, LSMC per seed, and the float32-against-float64
    drift on the first seed at ``num_sims``.  Returns the JSON line's dict."""
    storage, fwd, vols = build_case()
    tree, tree_s = _timed(lambda: tree_value(storage, fwd, vols, device), device)
    if log:
        log(f"tree (float64, G={GRID}): {tree:,.4f} [{tree_s:.3f} s]")
    gaps = {}
    for seed in seeds:
        npv, wall = _timed(lambda: lsmc_value(storage, fwd, vols, num_sims, seed, device=device),
                           device)
        gaps[str(seed)] = {"npv": npv, "rel_gap": (npv - tree) / tree, "wall_s": wall}
        if log:
            log(f"lsmc float32 sims={num_sims:,} seed={seed}: {npv:,.4f} "
                f"rel={gaps[str(seed)]['rel_gap']:+.3e} [{wall:.3f} s]")
    npv64, wall64 = _timed(lambda: lsmc_value(storage, fwd, vols, num_sims, seeds[0],
                                              dtype=torch.float64, device=device), device)
    drift = (gaps[str(seeds[0])]["npv"] - npv64) / npv64
    if log:
        log(f"drift sims={num_sims:,} seed={seeds[0]}: float64 {npv64:,.4f} against float32 "
            f"{gaps[str(seeds[0])]['npv']:,.4f}, rel={drift:+.3e} [{wall64:.3f} s]")
    worst = max(abs(g["rel_gap"]) for g in gaps.values())
    return {
        "metric": (f"LSMC({num_sims:,} paths, float32) vs trinomial (float64, "
                   f"G={GRID}) on identical 1-factor OU dynamics, {len(seeds)} seeds, "
                   f"device={device}"),
        "tree_npv": tree,
        "tree_wall_s": tree_s,
        "per_seed": gaps,
        "worst_abs_rel_gap": worst,
        "f32_vs_f64_rel_drift": drift,
        "f64_npv": npv64,
        "f64_wall_s": wall64,
        "drift_leg_sims": num_sims,
        "passes_0p1pct": bool(worst <= GAP_MAX),
        "reference_tolerance": 0.005,
        "device": str(device),
        "card": card_name(device),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--num-sims", type=int, default=NUM_SIMS)
    parser.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    line = run_study(args.num_sims, tuple(args.seeds), args.device,
                     log=lambda msg: print(f"# {msg}", file=sys.stderr, flush=True))
    print(line["card"])
    print(json.dumps(line))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(line, f, indent=2)
        f.write("\n")
    return 0 if line["passes_0p1pct"] else 1


if __name__ == "__main__":
    sys.exit(main())
