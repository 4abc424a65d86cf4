"""Host compile of the PyTorch port against the JAX package.

``storage_tpu_torch.compile.build_valuation_context`` must produce the same
``ValuationContext`` as ``storage_tpu.compile.build_valuation_context`` on
the same inputs: the headline case (``bench.py::build_case``), the README
example's storage (the same facility valued on another curve) and the
reference-golden storage (constant rates, valued before its start), and
the hourly case of ``benchmarks/hourly_bench.py`` at its full 17,520 steps.
Arrays are compared exactly, except the reduced inventory space and the
grids built on it, which the JAX package may compute in its C++ host path
(another arithmetic order): those to 1e-12 relative.
"""
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import storage_tpu as jax_pkg  # noqa: E402
import storage_tpu_torch as torch_pkg  # noqa: E402
from chip_smoke import build_case, build_hourly_case  # noqa: E402
from storage_tpu.compile import build_valuation_context as jax_build  # noqa: E402
from storage_tpu_torch.compile import build_valuation_context as torch_build  # noqa: E402

torch.set_num_threads(2)

EXACT_ARRAYS = (
    "pillars", "inject_cost", "withdraw_cost", "cons_inject", "cons_withdraw",
    "inventory_loss", "inventory_cost_rate", "df_settle", "df_cost", "fwd",
)
SCALARS = (
    "freq", "val_period", "n_steps", "val_date_is_first_step", "inventory",
    "num_grid_points", "interp_kind", "numerical_tolerance",
)


def _headline(pkg):
    storage, fwd, ir, rule = build_case(pkg)
    return (storage, "2021-04-25", 1500.0, fwd, ir, rule, 100, 1e-12)


def _readme(pkg):
    # The README example's facility and market, valued a month later with a
    # flat 1% rate and settlement on the delivery day.
    storage, fwd, _ir, _rule = build_case(pkg)
    return (storage, "2021-05-25", 0.0, fwd, 0.01, None, 60, 1e-12)


def _golden(pkg):
    storage = pkg.CmdtyStorage(
        "D", "2019-12-01", "2020-04-01", 1.23, 0.98,
        min_inventory=0.0, max_inventory=100_000.0,
        max_injection_rate=700.0, max_withdrawal_rate=700.0,
    )
    val_date = "2019-08-29"
    idx = pd.PeriodIndex([pd.Period(d, freq="D") for d in (val_date, "2020-03-12", "2020-04-01")])
    fwd = pd.Series([23.87, 150.32, 150.32], idx).resample("D").ffill()
    ir = pd.Series(0.03, index=pd.period_range(val_date, "2020-06-01", freq="D"))

    def rule(period):
        return period.asfreq("M").asfreq("D", "end") + 20

    return (storage, val_date, 0.0, fwd, ir, rule, 100, 1e-12)


def _hourly(pkg):
    storage, fwd = build_hourly_case(pkg)
    return (storage, "2021-01-01", 1500.0, fwd, 0.01, None, 100, 1e-12)


@pytest.mark.parametrize("case", [_headline, _readme, _golden, _hourly],
                         ids=["headline", "readme", "golden", "hourly"])
def test_valuation_context_matches_jax(case):
    ref = jax_build(*case(jax_pkg))
    got = torch_build(*case(torch_pkg))
    for name in SCALARS:
        assert getattr(got, name) == getattr(ref, name), name
    assert got.periods.equals(ref.periods)
    for name in EXACT_ARRAYS:
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(ref, name))
        assert a.shape == b.shape and np.array_equal(a, b), name
    for a, b in (
        (got.inv_space.min_inventory, ref.inv_space.min_inventory),
        (got.inv_space.max_inventory, ref.inv_space.max_inventory),
        (got.grids, ref.grids),
    ):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * np.abs(b).max())


def test_storage_arrays_match_jax():
    ref, _fwd, _ir, _rule = build_case(jax_pkg)
    got, _fwd, _ir, _rule = build_case(torch_pkg)
    assert got.interp_kind == ref.interp_kind
    assert np.array_equal(got.pillars_padded, ref.pillars_padded)
    assert len(got.pillar_tables) == len(ref.pillar_tables)
    assert all(np.array_equal(a, b) for a, b in zip(got.pillar_tables, ref.pillar_tables))
    assert got.must_be_empty_at_end == ref.must_be_empty_at_end


def test_interop_context_at_hourly_depth():
    """``interop.context_from_numpy`` carries a 17,520-step context across
    array by array (no per-step Python work: it takes milliseconds)."""
    import time

    from storage_tpu_torch.interop import context_from_numpy

    ref = jax_build(*_hourly(jax_pkg))
    t0 = time.perf_counter()
    got = context_from_numpy(ref)
    elapsed = time.perf_counter() - t0
    assert got.n_steps == ref.n_steps == 17_520 and got.periods.equals(ref.periods)
    for name in EXACT_ARRAYS + ("grids",):
        assert np.array_equal(getattr(got, name), np.asarray(getattr(ref, name))), name
    assert np.array_equal(got.inv_space.max_inventory, ref.inv_space.max_inventory)
    assert elapsed < 1.0, f"context_from_numpy took {elapsed:.2f} s for 17,520 steps"
