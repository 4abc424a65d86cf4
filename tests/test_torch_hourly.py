"""The hourly configuration at cut sizes, streamed, in both packages.

The case of ``benchmarks/hourly_bench.py`` (hourly storage from 2021-01-01,
3-factor seasonal model, 7-term basis, antithetic paths, seed 13, deltas
discounted, no panels) cut in days and paths (``CASES``), streamed by a path
budget below its size (spans of 64 steps), through
``three_factor_seasonal_value`` of both packages on the CPU:

- the port against the JAX package's exact route (XLA code, interpolation
  weights unquantized): NPV within the case's ``npv_rtol``, the intrinsic
  value equal;
- the JAX package's quantized route (``STORAGE_TPU_QUANTIZE_WEIGHTS=1``: the
  interpolation weights its TPU kernels use, rounded to 1/128 of a grid
  step) against its exact route: lower by at least the case's ``loss_min``.
  An hourly decision moves the inventory by a seventh of a grid step, so the
  rounding costs policy value, and the loss grows with the horizon.  The
  port must stay with the exact route: its gap to it is held under a fifth
  of the quantization loss.

The first case runs with the quick tests.  The longer cuts are the series
that ties the full case's NPV on the card (``chip_smoke.py``'s ``hourly``
phase: 163,372 against the JAX package's quantized-route record 152,007) to
the quantization and not to a kernel fault; they carry the ``slow`` marker
(``pytest tests/test_torch_hourly.py -m slow -s`` prints the three NPVs of
each).  PERF.md records what they gave.
"""
import os
import sys
import time

import numpy as np
import pandas as pd
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import storage_tpu as jax_pkg  # noqa: E402
import storage_tpu_torch as torch_pkg  # noqa: E402
from chip_smoke import HOURLY_BASIS  # noqa: E402

torch.set_num_threads(2)

# (days, paths, npv_rtol and intrinsic_rtol of the port against the exact
# route, least relative loss of the quantized route against the exact one).
# The intrinsic values are equal up to a year; from there the two float32
# value functions' last bits flip a near-tie of the float64 sweep (measured
# 1.9e-5 at 365 days, 2.7e-6 at 730; tests/test_torch_intrinsic.py counts
# such rows on the daily case).
CASES = [
    pytest.param((30, 1024, 1e-4, 1e-9, 3e-4), id="30d-1024"),
    pytest.param((90, 2048, 1e-4, 1e-9, 1.5e-2), id="90d-2048", marks=pytest.mark.slow),
    pytest.param((180, 2048, 1e-4, 1e-9, 3e-2), id="180d-2048", marks=pytest.mark.slow),
    pytest.param((365, 2048, 1e-4, 1e-4, 4e-2), id="365d-2048", marks=pytest.mark.slow),
    pytest.param((730, 1024, 1e-4, 1e-4, 5e-2), id="730d-1024", marks=pytest.mark.slow),
]


def _value(pkg, days, sims, **kw):
    end = (pd.Period("2021-01-01", freq="D") + days).strftime("%Y-%m-%d")
    storage = pkg.CmdtyStorage(
        freq="h", storage_start="2021-01-01", storage_end=end, injection_cost=0.01,
        withdrawal_cost=0.025,
        ratchets=[("2021-01-01", [(0.0, -150.0 / 24, 250.0 / 24), (2000.0, -200.0 / 24, 175.0 / 24),
                                  (5000.0, -260.0 / 24, 155.0 / 24),
                                  (7000.0, -275.0 / 24, 132.0 / 24)])],
        ratchet_interp=pkg.RatchetInterp.LINEAR)
    idx = pd.period_range("2021-01-01", end, freq="h")
    i = np.arange(len(idx))
    fwd = pd.Series(16.0 + 2.0 * np.sin(2 * np.pi * i / 8760.0)
                    + 0.8 * np.sin(2 * np.pi * i / 24.0), index=idx)
    return pkg.three_factor_seasonal_value(
        cmdty_storage=storage, val_date="2021-01-01", inventory=1500.0, fwd_curve=fwd,
        interest_rates=0.01, settlement_rule=None, num_sims=sims, seed=13, antithetic=True,
        spot_mean_reversion=91.0, spot_vol=0.85, long_term_vol=0.30, seasonal_vol=0.19,
        basis_funcs=HOURLY_BASIS, discount_deltas=True, return_sim_panels=False, **kw)


@pytest.fixture(scope="module", params=CASES)
def runs(request):
    days, sims, npv_rtol, intrinsic_rtol, loss_min = request.param
    saved = {k: os.environ.get(k) for k in ("STORAGE_TPU_MAX_PATH_BYTES",
                                            "STORAGE_TPU_QUANTIZE_WEIGHTS")}
    os.environ["STORAGE_TPU_MAX_PATH_BYTES"] = "1000"
    os.environ.pop("STORAGE_TPU_QUANTIZE_WEIGHTS", None)
    seconds = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    try:
        out = {"port": timed("port", lambda: _value(torch_pkg, days, sims, device="cpu")),
               "exact": timed("exact", lambda: _value(jax_pkg, days, sims))}
        os.environ["STORAGE_TPU_QUANTIZE_WEIGHTS"] = "1"
        out["quantized"] = timed("quantized", lambda: _value(jax_pkg, days, sims))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    exact = out["exact"].npv
    print(f"\n[hourly pair] {days} days x {sims} paths: "
          + ", ".join(f"{k} {v.npv:.4f}" for k, v in out.items())
          + f"; intrinsic port {out['port'].intrinsic_npv:.4f}, exact "
          f"{out['exact'].intrinsic_npv:.4f}; port/exact - 1 = "
          f"{out['port'].npv / exact - 1:+.2e}, quantized/exact - 1 = "
          f"{out['quantized'].npv / exact - 1:+.4%}, exact/quantized - 1 = "
          f"{exact / out['quantized'].npv - 1:+.4%}; seconds {seconds}")
    return dict(out, days=days, npv_rtol=npv_rtol, intrinsic_rtol=intrinsic_rtol,
                loss_min=loss_min)


def test_port_matches_the_exact_jax_route(runs):
    assert runs["port"].npv == pytest.approx(runs["exact"].npv, rel=runs["npv_rtol"])
    assert runs["port"].intrinsic_npv == pytest.approx(runs["exact"].intrinsic_npv,
                                                       rel=runs["intrinsic_rtol"])
    assert runs["port"].npv > runs["port"].intrinsic_npv
    assert len(runs["port"].deltas) == 24 * runs["days"] + 1
    assert np.isfinite(runs["port"].deltas.to_numpy()).all()


def test_quantized_weights_cost_policy_value_at_hourly_steps(runs):
    exact, quantized = runs["exact"].npv, runs["quantized"].npv
    assert (exact - quantized) / exact > runs["loss_min"]
    assert abs(runs["port"].npv - exact) < 0.2 * (exact - quantized)
