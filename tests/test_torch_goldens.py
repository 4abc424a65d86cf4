"""The port against the JAX package's golden and accuracy anchors.

- ``tests/test_reference_goldens.py`` on the port (``device="cpu"``): the
  reference's pinned 122-day goldens at their bands (intrinsic at or above
  the reference's realized value and within 0.5% of it; 2-factor LSMC at
  8,000 paths within 0.5%; 3-factor within 1%), with the seed-independent
  structural assertions and the progress protocol.
- ``tests/test_readme_example.py``'s five tests on the port's results of the
  README example (2,000 paths, seed 12): the pinned levels keep the JAX
  test's tolerances (intrinsic 1e-3, NPV 5e-3), which the port's float32
  noise at 2,000 paths fits (~1e-4).
- ``tests/test_brute_force.py``'s bracket: the independent float64 NumPy DP
  (``benchmarks/brute_force_intrinsic.py``) on the port's own valuation
  context, against the port's intrinsic value.
- ``tools/torch_accuracy_study.py``'s helpers at a cut size (4,096 paths,
  G = 40): its float64 tree and float64 LSMC against the JAX study's helpers
  under ``jax.enable_x64``, within 1e-9.
- The cross-model 0.1% case (``TestCrossModelTenthPercent``) on the port, as
  a ``slow`` test: float32 LSMC at 65,536 paths against the float64 tree.
"""
import sys
from pathlib import Path

import pandas as pd
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
for path in (REPO, REPO / "tests", REPO / "benchmarks", REPO / "tools"):
    sys.path.insert(0, str(path))

import storage_tpu_torch as tt  # noqa: E402
import test_readme_example as readme  # noqa: E402
import test_reference_goldens as goldens  # noqa: E402
import torch_accuracy_study as study  # noqa: E402
from brute_force_intrinsic import brute_force_intrinsic_npv  # noqa: E402

torch.set_num_threads(2)

CPU = {"device": "cpu"}
STUDY_SIMS, STUDY_GRID = 4096, 40
STUDY_RTOL = 1e-9


def golden_storage():
    return tt.CmdtyStorage(
        "D", "2019-12-01", "2020-04-01", 1.23, 0.98,
        min_inventory=0.0, max_inventory=100_000.0,
        max_injection_rate=700.0, max_withdrawal_rate=700.0,
    )


def readme_storage():
    return tt.CmdtyStorage(
        freq="D", storage_start="2021-04-01", storage_end="2022-04-01",
        injection_cost=0.01, withdrawal_cost=0.025,
        ratchets=[("2021-04-01", [(0.0, -150.0, 250.0), (2000.0, -200.0, 175.0),
                                  (5000.0, -260.0, 155.0), (7000.0, -275.0, 132.0)]),
                  ("2022-10-01", [(0.0, -130.0, 260.0), (2000.0, -190.0, 190.0),
                                  (5000.0, -230.0, 165.0), (7000.0, -245.0, 148.0)])],
        ratchet_interp=tt.RatchetInterp.LINEAR)


class TestIntrinsicGolden:
    def test_intrinsic_bounds_reference(self):
        fwd, ir = goldens.golden_market()
        res = tt.intrinsic_value(golden_storage(), goldens.VAL_DATE, 0.0, fwd, ir,
                                 goldens.twentieth_of_next_month, **CPU)
        assert res.npv >= goldens.REF_INTRINSIC_NPV
        assert res.npv <= goldens.REF_INTRINSIC_NPV * 1.005
        assert len(res.profile) == goldens.NUM_PERIODS


class TestTwoFactorGolden:
    @pytest.fixture(scope="class")
    def result(self):
        fwd, ir = goldens.golden_market()
        progresses = []
        res = tt.multi_factor_value(
            golden_storage(), goldens.VAL_DATE, 0.0, fwd, ir, goldens.twentieth_of_next_month,
            factors=[(0.0, goldens.LONG_TERM_VOL), (16.2, goldens.SPOT_VOL)], factor_corrs=0.64,
            num_sims=8_000, basis_funcs="1 + x0 + x0**2 + x1 + x1*x1",
            discount_deltas=False, seed=11, fwd_sim_seed=11,
            on_progress_update=progresses.append, **CPU)
        return res, progresses

    def test_npv_within_band_of_golden(self, result):
        res, _ = result
        assert res.npv == pytest.approx(goldens.REF_2F_NPV, rel=0.005)
        assert res.intrinsic_npv >= goldens.REF_INTRINSIC_NPV
        assert res.extrinsic_npv > 0.0

    def test_structural_parity(self, result):
        res, _ = result
        n = goldens.NUM_PERIODS
        assert len(res.deltas) == len(res.expected_profile) == len(res.intrinsic_profile) == n
        for name in ("sim_spot_regress", "sim_spot_valuation", "sim_inventory",
                     "sim_inject_withdraw", "sim_cmdty_consumed", "sim_inventory_loss",
                     "sim_net_volume", "sim_pv"):
            assert getattr(res, name).shape == (n, 8_000), name

    def test_progress_protocol(self, result):
        _, progresses = result
        assert progresses[-1] == 1.0
        assert all(b >= a for a, b in zip(progresses, progresses[1:]))


class TestThreeFactorGolden:
    def test_npv_within_band_of_golden(self):
        fwd, ir = goldens.golden_market()
        res = tt.three_factor_seasonal_value(
            golden_storage(), goldens.VAL_DATE, 0.0, fwd, ir, goldens.twentieth_of_next_month,
            spot_mean_reversion=16.2, spot_vol=1.15, long_term_vol=0.14, seasonal_vol=0.18,
            num_sims=2_000, basis_funcs="1 + x_st + x_sw + x_lt + x_st**2 + x_sw**2 + x_lt**2",
            discount_deltas=False, seed=11, fwd_sim_seed=11, return_sim_panels=False, **CPU)
        assert res.npv == pytest.approx(goldens.REF_3F_NPV, rel=0.01)
        assert res.intrinsic_npv >= goldens.REF_INTRINSIC_NPV
        assert len(res.deltas) == goldens.NUM_PERIODS


@pytest.fixture(scope="module")
def readme_results():
    fwd_curve, ir_curve = readme.readme_market()
    return tt.three_factor_seasonal_value(
        cmdty_storage=readme_storage(), val_date="2021-04-25", inventory=1500.0,
        fwd_curve=fwd_curve, interest_rates=ir_curve, settlement_rule=readme.settlement_rule,
        num_sims=2000, seed=12, spot_mean_reversion=91.0, spot_vol=0.85, long_term_vol=0.30,
        seasonal_vol=0.19,
        basis_funcs="1 + x_st + x_sw + x_lt + s + x_st**2 + x_sw**2 + x_lt**2 + s**2 + s * x_st",
        discount_deltas=True, **CPU)


class TestReadmeExample:
    def test_intrinsic_beats_reference_and_near_optimum(self, readme_results):
        assert readme_results.intrinsic_npv > readme.REFERENCE_INTRINSIC_NPV
        assert readme_results.intrinsic_npv <= readme.BRUTE_FORCE_INTRINSIC_OPTIMUM * (1 + 1e-4)
        assert readme_results.intrinsic_npv == pytest.approx(readme.PINNED_INTRINSIC, rel=1e-3)

    def test_full_npv_beats_reference(self, readme_results):
        assert readme_results.npv > readme.REFERENCE_FULL_NPV
        assert readme_results.npv == pytest.approx(readme.PINNED_FULL_NPV, rel=5e-3)

    def test_extrinsic_positive_and_consistent(self, readme_results):
        assert readme_results.extrinsic_npv == pytest.approx(
            readme_results.npv - readme_results.intrinsic_npv)
        assert readme_results.extrinsic_npv > 0.0

    def test_result_shapes(self, readme_results):
        n_periods = len(pd.period_range("2021-04-25", "2022-04-01", freq="D"))
        assert len(readme_results.deltas) == n_periods
        assert len(readme_results.expected_profile) == n_periods
        assert readme_results.sim_inventory.shape == (n_periods, 2000)
        assert readme_results.sim_pv.shape == (n_periods, 2000)
        assert readme_results.sim_spot_regress.shape == (n_periods - 1, 2000)
        assert len(readme_results.trigger_prices) == n_periods - 1
        inv = readme_results.expected_profile["inventory"]
        assert inv.iloc[0] == pytest.approx(1500.0)
        assert inv.iloc[-1] == pytest.approx(0.0, abs=1e-3)

    def test_deltas_sane(self, readme_results):
        assert readme_results.deltas.abs().max() <= 275.0 + 1e-6


def test_engine_intrinsic_bracketed_by_brute_force():
    """``tests/test_brute_force.py::test_engine_intrinsic_bracketed`` on the
    port: the brute-force DP reads the port's own context."""
    from storage_tpu_torch.compile import build_valuation_context

    fwd_curve, ir_curve = readme.readme_market()
    ctx = build_valuation_context(readme_storage(), "2021-04-25", 1500.0, fwd_curve, ir_curve,
                                  readme.settlement_rule, 100, 1e-12)
    engine = tt.intrinsic_value(readme_storage(), "2021-04-25", 1500.0, fwd_curve, ir_curve,
                                readme.settlement_rule, **CPU)
    optimum = brute_force_intrinsic_npv(ctx, num_grid=3000, num_decisions=121)
    assert engine.npv <= optimum * (1 + 1e-4)
    assert engine.npv == pytest.approx(optimum, rel=1e-3)


@pytest.fixture(scope="module")
def jax_study():
    import accuracy_study  # benchmarks/accuracy_study.py

    return accuracy_study


@pytest.mark.parametrize("leg", ["tree", "lsmc"])
def test_study_helpers_equal_jax_float64(leg, jax_study, monkeypatch):
    """The port study's float64 helpers against the JAX study's at 4,096
    paths and G = 40 (the JAX helpers read the module's ``GRID``)."""
    import jax
    import jax.numpy as jnp

    monkeypatch.setattr(jax_study, "GRID", STUDY_GRID)
    storage, fwd, vols = study.build_case()
    jax_storage, jax_fwd, jax_vols = jax_study.build_case()
    pd.testing.assert_series_equal(fwd, jax_fwd)
    pd.testing.assert_series_equal(vols, jax_vols)
    if leg == "tree":
        got = study.tree_value(storage, fwd, vols, device="cpu", grid=STUDY_GRID)
        ref = jax_study.tree_value(jax_storage, jax_fwd, jax_vols)
    else:
        got = study.lsmc_value(storage, fwd, vols, STUDY_SIMS, 11, dtype=torch.float64,
                               device="cpu", grid=STUDY_GRID)
        with jax.enable_x64(True):
            ref = jax_study.lsmc_value(jax_storage, jax_fwd, jax_vols, STUDY_SIMS, 11,
                                       dtype=jnp.float64)
    assert got == pytest.approx(ref, rel=STUDY_RTOL)


def test_smoke_records_the_study_by_dtype():
    """``chip_smoke._recording`` of each dtype's first launches on the study
    at a cut size (512 paths, one seed): each kernel's calls counted by
    element type (58 backward steps, one forward pass and two path sets a
    valuation), and each type's recorded operands of that type at the
    study's shapes."""
    import chip_smoke

    with chip_smoke._recording(chip_smoke._first_launches(29)) as rec:
        study.run_study(512, (11,), "cpu")
    for dtype in ("float32", "float64"):
        assert {k: c for (k, t), c in rec.calls.items() if t == dtype} == {
            "K1": 58, "K2": 1, "K3": 2}
        (f, _, v_next, *_), kw = rec.recorded[("K1", dtype)]
        assert v_next.dtype == getattr(torch, dtype) and tuple(v_next.shape) == (study.GRID, 512)
        assert kw["spec"].num_basis == 5 and f.shape[0] == 1
        factors = rec.recorded[("K2", dtype)][0][0]
        assert factors.dtype == getattr(torch, dtype) and factors.shape[1:] == (1, 512)
        coeffs, num_sims, key, antithetic = rec.recorded[("K3", dtype)]
        assert num_sims == 512 and not antithetic and coeffs.decay.shape[1] == 1
    assert len(rec.recorded) == 6


@pytest.mark.slow
def test_lsmc_vs_fine_grid_tree_within_0p1pct():
    """``TestCrossModelTenthPercent`` on the port: float32 LSMC at 65,536
    paths against the float64 tree on the dense grid, |gap| <= 0.1% for seeds
    11 and 23."""
    storage, fwd, vols = study.build_case()
    tree = study.tree_value(storage, fwd, vols, device="cpu")
    for seed in (11, 23):
        npv = study.lsmc_value(storage, fwd, vols, 65_536, seed, device="cpu")
        rel = abs(npv - tree) / tree
        assert rel <= study.GAP_MAX, (seed, npv, tree, rel)
