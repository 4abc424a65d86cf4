"""The port's model analytics, standalone simulator and schedule helpers
against the JAX package.

- ``MultiFactorModel``: every integral (covariance, variance, standard
  deviation, vol, correlation) on the same factors and dates within 1e-12
  relative (host float64 in both packages), the same validation errors, and
  ``for_3_factor_seasonal``.
- ``MultiFactorSpotSim``: the spots of one seed against the JAX package's
  within 1e-5 relative (threefry draws bit for bit, normals within 4 ulp,
  ``test_torch_simulation.py``), for plain and antithetic draws; shapes,
  index and determinism; the martingale property within 4 standard errors.
- ``utils.contracts`` and ``utils.facility``: the same outputs on the same
  inputs (pure pandas in both packages).
- The package exports everything the JAX package exports, the tree engine too.
"""
import itertools
import os
import sys
from datetime import date

import numpy as np
import pandas as pd
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import storage_tpu as jax_pkg  # noqa: E402
import storage_tpu_torch as torch_pkg  # noqa: E402
from storage_tpu.models import multi_factor as jax_mf  # noqa: E402
from storage_tpu.utils import contracts as jax_contracts, facility as jax_facility  # noqa: E402
from storage_tpu_torch.models import multi_factor as torch_mf  # noqa: E402
from storage_tpu_torch.utils import contracts, facility  # noqa: E402

torch.set_num_threads(2)

SHORT_PLUS_LONG = pd.period_range(start="2020-09-01", periods=25, freq="D").append(
    pd.period_range(start="2030-09-01", periods=25, freq="D"))
TREE_NAMES = {"trinomial_value", "trinomial_deltas", "intrinsic_tree_value",
              "TreeValuationResults"}


def _models(mf):
    two = [(0.0, pd.Series(np.linspace(0.53, 0.487, 50), index=SHORT_PLUS_LONG)),
           (2.5, pd.Series(np.linspace(1.45, 1.065, 50), index=SHORT_PLUS_LONG))]
    return {
        "zero-mr-dict": mf.MultiFactorModel(
            "D", [(0.0, {"2020-09-01": 0.36, "2020-10-01": 0.29, "2020-11-01": 0.23})]),
        "pos-mr": mf.MultiFactorModel(
            "D", [(2.5, pd.Series(np.linspace(0.65, 0.38, 50), index=SHORT_PLUS_LONG))]),
        "two-factor": mf.MultiFactorModel("D", two, 0.87),
        "seasonal": mf.MultiFactorModel.for_3_factor_seasonal(
            "D", 91.0, 0.85, 0.30, 0.19, "2020-08-01", "2020-12-31"),
    }


CONTRACTS = {"zero-mr-dict": ["2020-09-01", "2020-10-01", "2020-11-01"],
             "pos-mr": list(SHORT_PLUS_LONG[[0, 3, 30]]),
             "two-factor": list(SHORT_PLUS_LONG[[0, 7, 49]]),
             "seasonal": ["2020-09-01", "2020-10-15", "2020-12-31"]}


@pytest.mark.parametrize("name", list(CONTRACTS))
def test_model_integrals_match_jax(name):
    """Tolerance 1e-12 relative: the same float64 NumPy formula."""
    ref, got = _models(jax_mf)[name], _models(torch_mf)[name]
    assert got.num_factors == ref.num_factors
    obs = (date(2020, 5, 1), date(2020, 8, 30))
    for c1, c2 in itertools.product(CONTRACTS[name], repeat=2):
        for method, args in (("integrated_covar", (*obs, c1, c2)),
                             ("integrated_corr", (*obs, c1, c2)),
                             ("integrated_variance", (*obs, c1)),
                             ("integrated_stan_dev", (*obs, c1)),
                             ("integrated_vol", (*obs, c1))):
            want = getattr(ref, method)(*args)
            assert getattr(got, method)(*args) == pytest.approx(want, rel=1e-12, abs=1e-300), (
                method, args)


def test_model_errors_match_jax():
    for mf in (jax_mf, torch_mf):
        model = _models(mf)["zero-mr-dict"]
        with pytest.raises(ValueError, match="No point in vol curve"):
            model.integrated_variance("2020-08-05", "2020-08-30", "2025-01-01")
        with pytest.raises(ValueError, match="obs_end cannot be before obs_start"):
            model.integrated_covar("2020-08-05", "2020-08-01", "2020-09-01", "2020-09-01")
        with pytest.raises(ValueError, match="val_date must be before expiry"):
            model.integrated_vol("2020-08-05", "2020-08-05", "2020-09-01")


def _spot_sim(mf, antithetic, **kw):
    periods = [pd.Period(p, freq="D") for p in ["2020-08-01", "2021-01-15", "2021-07-30"]]
    vol1 = dict(zip(periods, [0.35, 0.29, 0.32]))
    vol2 = dict(zip(periods, [0.95, 0.92, 0.89]))
    fwd = dict(zip(periods, [56.85, 59.08, 62.453]))
    sim = mf.MultiFactorSpotSim(
        "D", [(0.0, vol1), (2.5, vol2)], np.array([[1.0, 0.6], [0.6, 1.0]]),
        date(2020, 7, 27), fwd, periods, seed=12, antithetic=antithetic, **kw)
    return sim, periods, fwd


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "antithetic"])
def test_spot_sim_matches_jax_for_the_same_seed(antithetic):
    ref, periods, _ = _spot_sim(jax_mf, antithetic)
    got, _, _ = _spot_sim(torch_mf, antithetic, device="cpu")
    want, frame = ref.simulate(4097), got.simulate(4097)
    assert frame.shape == want.shape == (3, 4097)
    assert list(frame.index) == periods and frame.index.equals(want.index)
    np.testing.assert_allclose(frame.to_numpy(), want.to_numpy(), rtol=1e-5)
    spots, factors = got.simulate_with_factors(4097)
    ref_spots, ref_factors = ref.simulate_with_factors(4097)
    assert spots.shape == (3, 4097) and factors.shape == (3, 2, 4097)
    np.testing.assert_allclose(factors.numpy(), np.asarray(ref_factors), rtol=1e-5, atol=1e-5)
    pd.testing.assert_frame_equal(frame, got.simulate(4097))  # same seed -> same draws
    if antithetic:  # sim s + 2049 mirrors sim s; sim 2048 is unpaired
        assert torch.equal(factors[..., :2048], -factors[..., 2049:])


def test_spot_sim_is_a_martingale():
    sim, periods, fwd = _spot_sim(torch_mf, False, device="cpu")
    spots = sim.simulate(50_000)
    for p in periods:
        row = spots.loc[p].to_numpy()
        assert abs(row.mean() - fwd[p]) <= 4.0 * row.std() / np.sqrt(row.size)


def test_spot_sim_refuses_a_period_not_after_the_current_date():
    periods = [pd.Period("2020-07-27", freq="D")]
    with pytest.raises(ValueError, match="after the current date"):
        torch_mf.MultiFactorSpotSim("D", [(0.0, {periods[0]: 0.3})], None, date(2020, 7, 27),
                                    {periods[0]: 50.0}, periods, seed=1, device="cpu")


@pytest.mark.parametrize("freq,contract", [
    ("D", pd.Period("2021-03", freq="M")), ("D", ("2021-03-05", "2021-03-09")),
    ("D", "2021-03-05"), ("h", pd.Period("2021-03-05", freq="D")),
    ("D", (pd.Period("2021-03", freq="M"), pd.Period("2021-05", freq="M"))),
], ids=["month-in-days", "tuple", "single", "day-in-hours", "period-tuple"])
def test_contract_period_range_matches_jax(freq, contract):
    assert contracts.to_period_range(freq, contract) == jax_contracts.to_period_range(
        freq, contract)


BASE_RATCHETS = [
    ("2021-04-01", [(0.0, -150.0, 250.0), (7000.0, -275.0, 132.0)]),
    ("2021-10-01", [(0.0, -130.0, 260.0), (7000.0, -245.0, 148.0)]),
]


def test_maintenance_ratchets_match_jax():
    maintenance = [("2021-06-15", 0.0, 0.5), ("2021-11-05", 0.5, 1.0), ("2022-04-01", 0.0, 0.0)]
    got = facility.ratchets_with_maintenance(BASE_RATCHETS, maintenance, "2022-04-01")
    assert got == jax_facility.ratchets_with_maintenance(BASE_RATCHETS, maintenance,
                                                        "2022-04-01")
    assert dict(got)[pd.Period("2021-06-15", "D")][0] == (0.0, -75.0, 0.0)
    with pytest.raises(ValueError, match="precedes"):
        facility.ratchets_with_maintenance(BASE_RATCHETS, [("2021-01-01", 0.0, 0.0)],
                                           "2022-04-01")


def test_inventory_gates_match_jax():
    args = ("2021-04-01", "2022-04-01", 100.0)
    gates = [("2021-04-02", 0.25, 0.8), ("2022-01-05", 0.2, 0.5)]
    got = facility.inventory_bounds_with_gates(*args, gates=gates)
    want = jax_facility.inventory_bounds_with_gates(*args, gates=gates)
    for a, b in zip(got, want):
        pd.testing.assert_series_equal(a, b)
    with pytest.raises(ValueError, match="fractions"):
        facility.inventory_bounds_with_gates("2021-04-01", "2021-05-01", 100.0,
                                             gates=[("2021-04-10", 0.7, 0.5)])


def test_outage_day_through_the_port_intrinsic():
    schedule = facility.ratchets_with_maintenance(BASE_RATCHETS, [("2021-06-15", 0.0, 0.0)],
                                                  "2022-04-01")
    idx = pd.period_range("2021-04-01", "2022-04-01", freq="D")
    fwd = pd.Series(15.0 + 2.0 * np.sin(np.arange(len(idx)) / 30.0), index=idx)
    results = {}
    for pkg, kw in ((jax_pkg, {}), (torch_pkg, {"device": "cpu"})):
        storage = pkg.CmdtyStorage("D", "2021-04-01", "2022-04-01", injection_cost=0.01,
                                   withdrawal_cost=0.02, ratchets=schedule,
                                   ratchet_interp=pkg.RatchetInterp.LINEAR)
        results[pkg] = pkg.intrinsic_value(storage, "2021-04-01", 1000.0, fwd, None, None, **kw)
    got, ref = results[torch_pkg], results[jax_pkg]
    assert got.npv == pytest.approx(ref.npv, rel=1e-6)
    assert got.profile.loc[pd.Period("2021-06-15", "D"), "inject_withdraw_volume"] == 0.0


def test_package_exports_all_but_the_tree_engine():
    """Since the tree engine was ported the port exports every name of the
    JAX package (the test keeps its name)."""
    assert set(jax_pkg.__all__) <= set(torch_pkg.__all__)
    assert TREE_NAMES <= set(torch_pkg.__all__)
    for name in torch_pkg.__all__:
        assert hasattr(torch_pkg, name), name
    assert torch_pkg.__version__ == jax_pkg.__version__
    assert torch_pkg.SUPPORTED_FREQS == jax_pkg.SUPPORTED_FREQS
    assert torch_pkg.FREQ_TO_PERIOD_TYPE == jax_pkg.FREQ_TO_PERIOD_TYPE
    assert torch_pkg.numerics_provider().startswith(f"torch {torch.__version__}")
    assert str(torch_pkg.S * torch_pkg.X(1) ** 2) == str(jax_pkg.S * jax_pkg.X(1) ** 2)


def test_every_public_device_argument_defaults_to_cuda():
    import inspect

    from storage_tpu_torch import interop, valuation
    from storage_tpu_torch.engines import intrinsic, lsmc
    from storage_tpu_torch.models import simulation

    public = [
        valuation.three_factor_seasonal_value, valuation.multi_factor_value,
        intrinsic.intrinsic_value, intrinsic.intrinsic_value_with_ctx, lsmc.run_lsmc,
        lsmc.fit_policy, lsmc.reprice, lsmc.LsmcPolicy.load, lsmc.LsmcPolicy.from_numpy,
        simulation.simulate_factor_paths, simulation.simulate_spot_paths,
        simulation.StreamingFactorSource.__init__, torch_mf.MultiFactorSpotSim.__init__,
        interop.lsmc_policy_from_numpy,
    ]
    for fn in public:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
