"""The port's chunked driver (progress and cancellation) against the JAX package.

- Progress: the headline case cut to 2021-07-01 (G = 40, seed 12, 8,192
  paths) with ``on_progress_update``: the lists of reported values are
  equal, value for value (20 backward spans weighted 0.66, 20 forward spans
  weighted 0.34, then 1.0), and the chunked NPV agrees to 1e-4 relative.
  Each backward span solves its latest period directly (the structure of the
  JAX package's chunked Pallas route), so the port's chunked NPV differs
  from its unchunked one by float32 regression noise, not bit for bit.
- Cancellation: a ``cancelled`` hook that turns true after the k-th report
  stops both packages with ``ValuationCancelledError`` after the same k
  reports.
- The reference two-factor golden (``test_reference_goldens.py``: 8,000
  sims, progress on, panels on) through the port: within 0.5% of the
  reference's NPV and 1e-4 relative of the JAX package's, with the
  reference's structural assertions.
"""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import storage_tpu as jax_pkg  # noqa: E402
import storage_tpu_torch as torch_pkg  # noqa: E402
from chip_smoke import BASIS, build_case  # noqa: E402
from test_reference_goldens import (  # noqa: E402
    LONG_TERM_VOL, NUM_PERIODS, REF_2F_NPV, REF_INTRINSIC_NPV, SPOT_VOL, VAL_DATE,
    golden_market, twentieth_of_next_month,
)

torch.set_num_threads(2)

SIMS, GRID = 8192, 40
NPV_RTOL = 1e-4
DEVICE = {jax_pkg: {}, torch_pkg: {"device": "cpu"}}


def _value(pkg, num_sims, **kw):
    storage, fwd, ir, rule = build_case(pkg, storage_end="2021-07-01")
    return pkg.three_factor_seasonal_value(
        cmdty_storage=storage, val_date="2021-04-25", inventory=1500.0, fwd_curve=fwd,
        interest_rates=ir, settlement_rule=rule, num_sims=num_sims, seed=12,
        spot_mean_reversion=91.0, spot_vol=0.85, long_term_vol=0.30, seasonal_vol=0.19,
        basis_funcs=BASIS, discount_deltas=True, num_inventory_grid_points=GRID,
        return_sim_panels=False, **DEVICE[pkg], **kw)


@pytest.fixture(scope="module")
def progress_runs():
    runs = {}
    for pkg in (jax_pkg, torch_pkg):
        progress = []
        runs[pkg] = (_value(pkg, SIMS, on_progress_update=progress.append), progress)
    return runs


def test_progress_matches_jax_value_for_value(progress_runs):
    (_, ref), (_, got) = progress_runs[jax_pkg], progress_runs[torch_pkg]
    assert got == ref
    assert len(got) == 41 and got[-1] == 1.0
    assert got[19] == pytest.approx(0.66)


def test_chunked_npv_matches_jax(progress_runs):
    ref, got = progress_runs[jax_pkg][0], progress_runs[torch_pkg][0]
    assert got.npv == pytest.approx(ref.npv, rel=NPV_RTOL)


@pytest.mark.parametrize("stop_after", [0, 7, 25])
def test_cancellation_matches_jax(stop_after):
    reported = {}
    for pkg in (jax_pkg, torch_pkg):
        progress = []
        with pytest.raises(pkg.ValuationCancelledError):
            _value(pkg, 256, on_progress_update=progress.append,
                   cancelled=lambda: len(progress) >= stop_after)
        reported[pkg] = progress
    assert reported[torch_pkg] == reported[jax_pkg]
    assert len(reported[torch_pkg]) == stop_after


def _golden(pkg):
    fwd, ir = golden_market()
    storage = pkg.CmdtyStorage(
        "D", "2019-12-01", "2020-04-01", 1.23, 0.98, min_inventory=0.0,
        max_inventory=100_000.0, max_injection_rate=700.0, max_withdrawal_rate=700.0)
    progresses = []
    res = pkg.multi_factor_value(
        storage, VAL_DATE, 0.0, fwd, ir, twentieth_of_next_month,
        factors=[(0.0, LONG_TERM_VOL), (16.2, SPOT_VOL)], factor_corrs=0.64,
        num_sims=8_000, basis_funcs="1 + x0 + x0**2 + x1 + x1*x1",
        discount_deltas=False, seed=11, fwd_sim_seed=11,
        on_progress_update=progresses.append, **DEVICE[pkg])
    return res, progresses


def test_two_factor_golden_through_the_port():
    res, progresses = _golden(torch_pkg)
    ref, ref_progresses = _golden(jax_pkg)
    assert res.npv == pytest.approx(REF_2F_NPV, rel=0.005)
    assert res.npv == pytest.approx(ref.npv, rel=NPV_RTOL)
    assert res.intrinsic_npv >= REF_INTRINSIC_NPV
    assert res.extrinsic_npv > 0.0
    # The reference's seed-independent assertions (test_multi_factor.py:227-239).
    assert len(res.deltas) == NUM_PERIODS
    assert len(res.expected_profile) == NUM_PERIODS
    assert len(res.intrinsic_profile) == NUM_PERIODS
    for name in ("sim_spot_regress", "sim_spot_valuation", "sim_inventory",
                 "sim_inject_withdraw", "sim_cmdty_consumed", "sim_inventory_loss",
                 "sim_net_volume", "sim_pv"):
        assert getattr(res, name).shape == (NUM_PERIODS, 8_000), name
    assert progresses == ref_progresses
    assert progresses[-1] == 1.0
    assert all(b >= a for a, b in zip(progresses, progresses[1:]))
