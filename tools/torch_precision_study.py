"""Float32 against float64 on the same paths, on storage_tpu_torch.

The port's counterpart of ``benchmarks/precision_study.py``, with its own
copies of that study's two configurations and helpers.  The factor paths are
drawn once, in float64 (on a card: the path kernel's float64 one-launch
mode), and fed to ``run_lsmc`` twice on one device: in float64, and rounded
to float32 (with the spot-vol loadings and drifts) in float32.  Both legs see
the same paths, so every difference in the table is float32 rounding and
conditioning, not Monte-Carlo noise.  The port has no weight quantization:
both legs take the exact route.

The study's criterion (the accuracy study's): |NPV32 / NPV64 - 1| <= 1e-3
on both configurations.

Run (GPU, or ``--device cpu`` at a cut size):

    python tools/torch_precision_study.py [--num-sims N] [--device cuda] [--out PATH]

Prints the table (the JAX study's eight columns), each leg's wall and peak
device memory, the card's name and power limit as ``nvidia-smi`` gives them,
and one JSON line, which it also writes to ``--out`` (default
``chiprun_out/torch_precision_study.json``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

TOOLS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(TOOLS, "..")
sys.path[:0] = [ROOT, TOOLS]

import numpy as np
import pandas as pd
import torch

from torch_accuracy_study import card_name  # noqa: E402

NUM_SIMS = 1_000_000
REG_SEED, VAL_SEED = 11, 12
NPV_RTOL_MAX = 1e-3  # the criterion: |NPV32 / NPV64 - 1| per configuration
OUT = os.path.join(ROOT, "chiprun_out", "torch_precision_study.json")
HEADER = ("| config | NPV (f64) | NPV rel diff | bwd NPV rel | max delta diff (% of max delta) "
          "| mean delta diff | max E[inventory] diff (% of cap) | max inject-trigger rel |")


def _port():
    import storage_tpu_torch

    return storage_tpu_torch


# The headline case's inputs (``bench.py::build_case``): ratchet tables
# (inventory, withdraw rate, inject rate) by start date, the monthly forward
# curve from 2021-04 and the zero-rate pillars.
HEADLINE_RATCHETS = [
    ("2021-04-01", [(0.0, -150.0, 250.0), (2000.0, -200.0, 175.0),
                    (5000.0, -260.0, 155.0), (7000.0, -275.0, 132.0)]),
    ("2022-10-01", [(0.0, -130.0, 260.0), (2000.0, -190.0, 190.0),
                    (5000.0, -230.0, 165.0), (7000.0, -245.0, 148.0)]),
]
HEADLINE_MONTHLY_FWD = [
    16.61, 15.68, 15.42, 15.31, 15.27, 15.13, 15.96, 17.22, 17.32, 17.66,
    17.59, 16.81, 15.36, 14.49, 14.28, 14.25, 14.32, 14.33, 15.30, 16.58,
    16.64, 16.79, 16.64, 15.90, 14.63,
]
HEADLINE_RATE_PILLARS = [
    ("2021-04-25", 0.005), ("2021-06-01", 0.006), ("2021-08-01", 0.0072),
    ("2021-12-01", 0.0087), ("2022-04-01", 0.0101), ("2022-12-01", 0.0115),
    ("2023-12-01", 0.0126),
]


def build_case(pkg):
    """The headline case of ``bench.py::build_case`` for a package with the
    ``CmdtyStorage`` API: storage, forward curve, rate curve, settlement rule."""
    storage = pkg.CmdtyStorage(
        freq="D", storage_start="2021-04-01", storage_end="2022-04-01",
        injection_cost=0.01, withdrawal_cost=0.025,
        ratchets=HEADLINE_RATCHETS, ratchet_interp=pkg.RatchetInterp.LINEAR,
    )
    monthly_index = pd.period_range(start="2021-04-25", periods=25, freq="M")
    fwd_curve = pd.Series(HEADLINE_MONTHLY_FWD, index=monthly_index).resample("D").ffill()
    rates = pd.Series([r for _, r in HEADLINE_RATE_PILLARS],
                      index=pd.PeriodIndex(freq="D", data=[d for d, _ in HEADLINE_RATE_PILLARS]))
    ir_curve = rates.resample("D").asfreq().interpolate(method="linear")

    def settlement_rule(d):
        return d.asfreq("M").asfreq("D", "end") + 20

    return storage, fwd_curve, ir_curve, settlement_rule


def bench_config(num_sims, pkg=None):
    """The headline case: ratcheted, settlement lags, rates.  ``pkg``
    (default this port) is a package with the ``CmdtyStorage`` API, for the
    tests' JAX twin."""
    storage, fwd_curve, ir_curve, settlement_rule = build_case(pkg or _port())
    return dict(
        name=f"bench: ratcheted 3f seasonal, {num_sims:,} x 342",
        storage=storage, val_date="2021-04-25", inventory=1500.0,
        fwd=fwd_curve, rates=ir_curve, settlement=settlement_rule,
        mr=91.0, spot_vol=0.85, lt_vol=0.30, sw_vol=0.19,
        basis="1 + x_st + x_sw + x_lt + s + x_st**2 + x_sw**2 + x_lt**2 + s**2 + s * x_st",
        discount_deltas=True,
    )


def constant_rate_config(num_sims, pkg=None):
    """Constant rates, no ratchets, valued before the storage starts."""
    idx = pd.period_range("2021-04-01", "2022-04-01", freq="D")
    storage = (pkg or _port()).CmdtyStorage(
        "D", "2021-04-01", "2022-04-01",
        injection_cost=0.01, withdrawal_cost=0.025,
        min_inventory=0.0, max_inventory=1500.0,
        max_injection_rate=25.5, max_withdrawal_rate=30.9,
    )
    fwd = pd.Series(
        25.0 + 8.0 * np.sin(2 * np.pi * (np.arange(len(idx)) - 300) / 365.0), index=idx
    )
    return dict(
        name=f"constant-rate 3f seasonal, {num_sims:,} x 365",
        storage=storage, val_date="2021-03-15", inventory=300.0,
        fwd=fwd, rates=None, settlement=None,
        mr=17.0, spot_vol=1.1, lt_vol=0.2, sw_vol=0.4,
        basis="1 + x_st + x_st**2 + x_lt + x_lt**2 + x_sw + x_sw**2 + s + s**2",
        discount_deltas=False,
    )


CONFIGS = (constant_rate_config, bench_config)


def build(cfg):
    """``(ctx, coeffs, spec)`` of a configuration: the valuation context, the
    sim coefficients of its simulated periods and the basis."""
    from storage_tpu_torch.compile import build_valuation_context
    from storage_tpu_torch.models.multi_factor import (
        build_sim_coefficients,
        create_3_factor_season_params,
    )
    from storage_tpu_torch.ops.regression import basis_spec
    from storage_tpu_torch.utils.basis import THREE_FACTOR_SEASONAL_ALIASES, parse_basis_functions

    ctx = build_valuation_context(
        cfg["storage"], cfg["val_date"], cfg["inventory"], cfg["fwd"],
        cfg["rates"], cfg["settlement"],
    )
    factors, corrs = create_3_factor_season_params(
        "D", cfg["mr"], cfg["spot_vol"], cfg["lt_vol"], cfg["sw_vol"],
        ctx.val_period, ctx.periods[-1],
    )
    first_sim = 1 if ctx.val_date_is_first_step else 0
    coeffs = build_sim_coefficients(
        factors, corrs, ctx.val_period, cfg["fwd"], list(ctx.periods[first_sim:])
    )
    spec = basis_spec(parse_basis_functions(cfg["basis"], THREE_FACTOR_SEASONAL_ALIASES), 3)
    return ctx, coeffs, spec


def result_dict(arrays):
    """What the table reads of an ``LsmcArrays``, as float64 NumPy."""
    def host(t):
        return t.detach().cpu().double().numpy()

    return dict(
        npv=float(arrays.npv),
        backward_npv=float(arrays.backward_npv),
        deltas=host(arrays.deltas),
        inventory=host(arrays.profile_means[:, 0]),
        inj_trigger=host(arrays.trigger_inject_prices),
        has_inj=arrays.trigger_has_inject.detach().cpu().numpy(),
    )


def compare(name, f32, f64) -> dict:
    """The table's eight columns for one configuration (the JAX study's
    formulas); ``cap``, the inventory scale, is the largest float64 expected
    inventory, as the JAX study's contexts have no ``space_hi_np``."""
    cap = float(np.max(np.asarray(f64["inventory"]))) or 1.0
    max_rate = float(np.abs(f64["deltas"]).max())
    d_delta = np.abs(f32["deltas"] - f64["deltas"])
    d_inv = np.abs(f32["inventory"] - f64["inventory"])
    mask = f32["has_inj"] & f64["has_inj"]
    d_trig = np.abs(f32["inj_trigger"][mask] - f64["inj_trigger"][mask])
    trig_scale = np.abs(f64["inj_trigger"][mask]).max() if mask.any() else 1.0
    return {
        "config": name,
        "npv_f64": float(f64["npv"]),
        "npv_rel_diff": abs(f32["npv"] - f64["npv"]) / abs(f64["npv"]),
        "backward_npv_rel_diff": (abs(f32["backward_npv"] - f64["backward_npv"])
                                  / abs(f64["backward_npv"])),
        "max_delta_diff_pct": 100.0 * d_delta.max() / max_rate,
        "mean_delta_diff_pct": 100.0 * d_delta.mean() / max_rate,
        "max_inventory_diff_pct_of_cap": 100.0 * d_inv.max() / cap,
        "max_inject_trigger_rel": float(d_trig.max() / trig_scale) if mask.any()
        else float("nan"),
    }


def table_line(row) -> str:
    """One row of the table, formatted as the JAX study prints it."""
    return (f"| {row['config']} | {row['npv_f64']:,.2f} | {row['npv_rel_diff']:.2e} | "
            f"{row['backward_npv_rel_diff']:.2e} | {row['max_delta_diff_pct']:.3f}% | "
            f"{row['mean_delta_diff_pct']:.4f}% | {row['max_inventory_diff_pct_of_cap']:.3f}% | "
            f"{row['max_inject_trigger_rel']:.2e} |")


def _timed(fn, device):
    """``(out, wall s, peak device bytes or None)`` of one call of ``fn``."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated(device) if cuda else None


def _peak(nbytes):
    return "peak not measured" if nbytes is None else f"peak {nbytes / 2**30:.3f} GiB"


def draw(coeffs, num_sims, device="cuda"):
    """The regression and valuation path sets ``[m+1, 3, num_sims]`` in
    float64, each drawn once (seeds 11 and 12, the JAX study's)."""
    from storage_tpu_torch.models import simulation

    return {name: simulation.simulate_factor_paths(
        coeffs, num_sims, key=simulation.prng_key(seed), antithetic=False, device=device,
        dtype=torch.float64) for name, seed in (("reg", REG_SEED), ("val", VAL_SEED))}


def run_legs(case, paths, device="cuda"):
    """Both legs of one configuration on one device.

    ``case`` is ``(cfg, ctx, coeffs, spec)``; ``paths`` maps ``"reg"`` and
    ``"val"`` to the float64 path sets, which the legs take out of it: each
    is handed to the float64 ``run_lsmc`` by a factory that keeps its
    float32 rounding, so the float64 set is freed once its pass is done, and
    the float32 copies are freed in turn by the float32 leg.  Returns
    ``{"f64": ..., "f32": ...}``, each ``(result_dict, wall s, peak bytes)``.
    """
    from storage_tpu_torch.engines import lsmc

    cfg, ctx, coeffs, spec = case
    rounded = {}

    def handing(name):
        def take():
            x = paths.pop(name)
            rounded[name] = x.to(torch.float32)
            return x
        return take

    def leg(reg, val, vols, drift, dtype):
        arrays = lsmc.run_lsmc(ctx, reg, val, vols, drift, spec, cfg["discount_deltas"],
                               device=device, collect_panels=False, dtype=dtype)
        return result_dict(arrays)

    f64 = _timed(lambda: leg(handing("reg"), handing("val"), coeffs.vols, coeffs.log_fwd_drift,
                             torch.float64), device)
    f32 = _timed(lambda: leg(lambda: rounded.pop("reg"), lambda: rounded.pop("val"),
                             np.float32(coeffs.vols), np.float32(coeffs.log_fwd_drift),
                             torch.float32), device)
    return {"f64": f64, "f32": f32}


def run_study(num_sims=NUM_SIMS, device="cuda", log=None, around=None):
    """The study on both configurations; returns the JSON line's dict.
    ``around(make_cfg)``, if given, is a context manager that each
    configuration's draws and legs run inside (to count their launches)."""
    rows, legs = [], {}
    for make_cfg in CONFIGS:
        cfg = make_cfg(num_sims)
        ctx, coeffs, spec = build(cfg)
        with around(make_cfg) if around else contextlib.nullcontext():
            paths, draw_s, _ = _timed(lambda: draw(coeffs, num_sims, device), device)
            out = run_legs((cfg, ctx, coeffs, spec), paths, device)
            del paths
        row = compare(cfg["name"], out["f32"][0], out["f64"][0])
        row["npv_f32"] = out["f32"][0]["npv"]
        rows.append(row)
        legs[cfg["name"]] = leg = {
            "draw_s": draw_s,
            "f64_wall_s": out["f64"][1], "f64_peak_bytes": out["f64"][2],
            "f32_wall_s": out["f32"][1], "f32_peak_bytes": out["f32"][2],
        }
        if log:
            log(f"{cfg['name']}: float64 NPV {row['npv_f64']:,.6f}, float32 {row['npv_f32']:,.6f}, "
                f"rel {row['npv_rel_diff']:.3e}; draws {draw_s:.3f} s, float64 leg "
                f"{leg['f64_wall_s']:.3f} s ({_peak(leg['f64_peak_bytes'])}), float32 leg "
                f"{leg['f32_wall_s']:.3f} s ({_peak(leg['f32_peak_bytes'])})")
    return {
        "metric": (f"float32 against float64 LSMC on the same float64 paths ({num_sims:,} "
                   f"paths), two configurations, device={device}"),
        "rows": rows,
        "legs": legs,
        "num_sims": num_sims,
        "worst_npv_rel_diff": max(r["npv_rel_diff"] for r in rows),
        "passes_1e-3": all(r["npv_rel_diff"] <= NPV_RTOL_MAX for r in rows),
        "device": str(device),
        "card": card_name(device),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--num-sims", type=int, default=NUM_SIMS)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=OUT)
    args = parser.parse_args(argv)
    line = run_study(args.num_sims, args.device,
                     log=lambda msg: print(f"# {msg}", file=sys.stderr, flush=True))
    print(HEADER)
    print("|---|---|---|---|---|---|---|---|")
    for row in line["rows"]:
        print(table_line(row))
    print(line["card"])
    print(json.dumps(line))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(line, f, indent=2)
        f.write("\n")
    return 0 if line["passes_1e-3"] else 1


if __name__ == "__main__":
    sys.exit(main())
