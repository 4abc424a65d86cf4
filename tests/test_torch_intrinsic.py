"""Intrinsic engine of the PyTorch port against the JAX package.

Both packages run the float32 backward DP on the same compiled context (the
port's built from the JAX one through ``storage_tpu_torch.interop``) and the
float64 host forward sweep; NPV and profile agree to 1e-6 relative.

The two float32 value functions differ by a few ulp (XLA's fused CPU
arithmetic against torch's), which can flip a near-tie in the sweep: on the
headline case one injection moves by two days inside a flat-price month
(7 of 342 profile rows, NPV equal to 1e-8).  Such rows are counted, bounded
and must re-merge: the final row agrees (ROADMAP Queue 3).

The public ``intrinsic_value`` (its end-date edge cases included) and the
cubic-spline interpolation are held against the JAX package's too; the
cubic bound is stated at ``CUBIC_RTOL``.
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
from chip_smoke import build_case  # noqa: E402
from storage_tpu.compile import build_valuation_context  # noqa: E402
from storage_tpu.engines.intrinsic import intrinsic_value_with_ctx as jax_intrinsic  # noqa: E402
from storage_tpu_torch.engines.intrinsic import intrinsic_value_with_ctx  # noqa: E402
from storage_tpu_torch.interop import context_from_numpy  # noqa: E402

torch.set_num_threads(2)
RTOL = 1e-6
MAX_FLIPPED_ROWS = 0.03  # fraction of profile rows inside near-tie timing flips


def _headline_ctx():
    storage, fwd, ir, rule = build_case(jax_pkg)
    return build_valuation_context(storage, "2021-04-25", 1500.0, fwd, ir, rule, 100)


def _golden_ctx():
    storage = jax_pkg.CmdtyStorage(
        "D", "2019-12-01", "2020-04-01", 1.23, 0.98,
        min_inventory=0.0, max_inventory=100_000.0,
        max_injection_rate=700.0, max_withdrawal_rate=700.0,
    )
    val_date = "2019-08-29"
    idx = pd.PeriodIndex([pd.Period(d, freq="D") for d in (val_date, "2020-03-12", "2020-04-01")])
    fwd = pd.Series([23.87, 150.32, 150.32], idx).resample("D").ffill()
    ir = pd.Series(0.03, index=pd.period_range(val_date, "2020-06-01", freq="D"))
    return build_valuation_context(
        storage, val_date, 0.0, fwd, ir, lambda p: p.asfreq("M").asfreq("D", "end") + 20, 100)


@pytest.mark.parametrize("make_ctx", [_headline_ctx, _golden_ctx], ids=["headline", "golden"])
def test_intrinsic_matches_jax(make_ctx):
    ctx = make_ctx()
    ref = jax_intrinsic(ctx)
    got = intrinsic_value_with_ctx(context_from_numpy(ctx), device="cpu")
    assert got.npv == pytest.approx(ref.npv, rel=RTOL)
    assert list(got.profile.columns) == list(ref.profile.columns)
    assert got.profile.index.equals(ref.profile.index)
    a, b = got.profile.to_numpy(), ref.profile.to_numpy()
    tol = RTOL * np.abs(b) + RTOL * np.abs(b).max()
    flipped = (np.abs(a - b) > tol).any(axis=1)
    assert flipped.mean() <= MAX_FLIPPED_ROWS, f"{flipped.sum()} of {len(b)} rows differ"
    assert not flipped[-1], "inventory paths did not re-merge by the end period"


def _small_case(pkg):
    storage = pkg.CmdtyStorage(
        "D", "2021-01-01", "2021-03-01", injection_cost=0.3, withdrawal_cost=0.4,
        min_inventory=0.0, max_inventory=2000.0, max_injection_rate=60.0,
        max_withdrawal_rate=80.0)
    idx = pd.period_range("2021-01-01", "2021-03-01", freq="D")
    return storage, pd.Series(20.0 + 3.0 * np.sin(np.arange(len(idx)) / 8.0), index=idx)


# Cubic: the float32 DP solves the spline's moments by another route than
# XLA's tridiagonal solve (one product with the system's inverse).  The value
# functions then differ by 1.8e-6 of max|V| on the headline context and
# 5.6e-7 on the golden one (linear: 3.1e-7 and 3.7e-7); held to 1e-5.  The
# float64 host sweep is the same code in both packages and sums the period
# PVs of the decisions it picks, so NPV and profile agree exactly unless a
# near-tie flips a decision (none does at these sizes).
CUBIC_RTOL = 1e-5


@pytest.mark.parametrize("interpolation", ["linear", "cubic"])
def test_public_intrinsic_value_matches_jax(interpolation):
    (storage, fwd), (jstorage, _) = _small_case(torch_pkg), _small_case(jax_pkg)
    ref = jax_pkg.intrinsic_value(jstorage, "2021-01-01", 800.0, fwd, 0.02, None,
                                  num_inventory_grid_points=50, interpolation=interpolation)
    got = torch_pkg.intrinsic_value(storage, "2021-01-01", 800.0, fwd, 0.02, None,
                                    num_inventory_grid_points=50, interpolation=interpolation,
                                    device="cpu")
    assert got.npv == pytest.approx(ref.npv, rel=CUBIC_RTOL if interpolation == "cubic" else RTOL)
    assert got.profile.index.equals(ref.profile.index)
    a, b = got.profile.to_numpy(), ref.profile.to_numpy()
    flipped = (np.abs(a - b) > 1e-4 * np.abs(b) + 1e-4 * np.abs(b).max()).any(axis=1)
    assert flipped.mean() <= MAX_FLIPPED_ROWS, f"{flipped.sum()} of {len(b)} rows differ"
    assert not flipped[-1]


def test_cubic_on_the_headline_context_matches_jax():
    ctx = _headline_ctx()
    ref = jax_intrinsic(ctx, interpolation="cubic")
    got = intrinsic_value_with_ctx(context_from_numpy(ctx), interpolation="cubic", device="cpu")
    assert got.npv == pytest.approx(ref.npv, rel=CUBIC_RTOL)
    linear = intrinsic_value_with_ctx(context_from_numpy(ctx), device="cpu")
    assert got.npv == pytest.approx(linear.npv, rel=5e-3)


@pytest.mark.parametrize("make_ctx", [_headline_ctx, _golden_ctx], ids=["headline", "golden"])
@pytest.mark.parametrize("cubic", [False, True], ids=["linear", "cubic"])
def test_value_functions_match_jax(make_ctx, cubic):
    """The float32 backward DP's value functions ``[n+1, G]`` of both
    packages, within ``CUBIC_RTOL`` of max|V|."""
    from storage_tpu.engines.intrinsic import _backward_values as jax_values
    from storage_tpu_torch.engines.intrinsic import _backward_values

    ctx = make_ctx()
    terminal = np.zeros_like(ctx.grids[ctx.n_steps])
    ref = jax_values(
        *(np.asarray(a, np.float32) for a in (
            ctx.grids, ctx.inv_space.min_inventory, ctx.inv_space.max_inventory, ctx.pillars,
            ctx.inventory_loss, ctx.inject_cost, ctx.withdraw_cost, ctx.cons_inject,
            ctx.cons_withdraw, ctx.inventory_cost_rate, ctx.df_settle, ctx.df_cost, ctx.fwd,
            terminal)),
        interp_kind=ctx.interp_kind, num_grid_points=ctx.num_grid_points, cubic=cubic)
    got = _backward_values(context_from_numpy(ctx), terminal, 0, "cpu", cubic=cubic)
    assert got.shape == ref.shape == (ctx.n_steps + 1, ctx.num_grid_points)
    np.testing.assert_allclose(got, ref, rtol=0, atol=CUBIC_RTOL * np.abs(ref).max())


def test_spline_matches_jax_and_reproduces_a_smooth_function():
    import jax.numpy as jnp

    from storage_tpu.ops import interp as jax_interp
    from storage_tpu_torch.ops import interp

    grid = np.linspace(0.0, 10.0, 50)
    values = np.sin(grid).astype(np.float32)
    h = float(grid[1] - grid[0])
    queries = np.linspace(0.5, 9.5, 37)
    t = (queries - grid[0]) / h
    j = np.clip(t.astype(np.int64), 0, 48)
    w = (t - j).astype(np.float32)
    moments = interp.cubic_spline_moments(torch.from_numpy(values), h)
    ref_moments = np.asarray(jax_interp.cubic_spline_moments(jnp.asarray(values), h))
    # float32 solves by two routes: 1e-4 of the largest moment.
    np.testing.assert_allclose(moments.numpy(), ref_moments, rtol=0,
                               atol=1e-4 * np.abs(ref_moments).max())
    est = interp.interp_columns_cubic(
        torch.from_numpy(values).expand(37, 50), moments.expand(37, 50),
        torch.from_numpy(j)[:, None], torch.from_numpy(w)[:, None], h)[:, 0].numpy()
    np.testing.assert_allclose(est, np.sin(queries), atol=2e-4)
    lin = interp.interp_columns(torch.from_numpy(values).expand(37, 50),
                                torch.from_numpy(j)[:, None], torch.from_numpy(w)[:, None])[:, 0]
    assert np.abs(est - np.sin(queries)).max() < np.abs(lin.numpy() - np.sin(queries)).max()
    assert not interp.cubic_spline_moments(torch.from_numpy(values), 0.0).any()


@pytest.mark.parametrize("case", ["after-end", "at-end-empty", "at-end-inventory",
                                  "at-end-terminal", "at-end-above-max"])
def test_public_intrinsic_end_date_edges_match_jax(case):
    def run(pkg, **kw):
        terminal = case in ("at-end-terminal", "at-end-above-max")
        storage = pkg.CmdtyStorage(
            "D", "2021-01-01", "2021-03-01", injection_cost=0.3, withdrawal_cost=0.4,
            min_inventory=0.0, max_inventory=2000.0, max_injection_rate=60.0,
            max_withdrawal_rate=80.0,
            terminal_storage_npv=(lambda price, inv: price * inv - 5.0) if terminal else None)
        idx = pd.period_range("2021-01-01", "2021-03-05", freq="D")
        fwd = pd.Series(20.0, index=idx)
        val_date = "2021-03-03" if case == "after-end" else "2021-03-01"
        inventory = {"at-end-inventory": 10.0, "at-end-terminal": 10.0,
                     "at-end-above-max": 2500.0}.get(case, 0.0)
        return pkg.intrinsic_value(storage, val_date, inventory, fwd, None, None, **kw)

    if case in ("at-end-inventory", "at-end-above-max"):
        for pkg, kw in ((jax_pkg, {}), (torch_pkg, {"device": "cpu"})):
            with pytest.raises(pkg.InventoryConstraintsCannotBeFulfilledError):
                run(pkg, **kw)
        return
    ref, got = run(jax_pkg), run(torch_pkg, device="cpu")
    assert got.npv == ref.npv
    assert got.profile.empty and list(got.profile.columns) == list(ref.profile.columns)


def test_float64_intrinsic_names_its_roadmap_item():
    """float64 runs now (``test_torch_float64.py``); the test keeps its name
    and holds the refusal of a dtype the DP does not take, by name."""
    storage, fwd = _small_case(torch_pkg)
    with pytest.raises(ValueError, match="torch.float16"):
        torch_pkg.intrinsic_value(storage, "2021-01-01", 800.0, fwd, None, None,
                                  dtype=torch.float16, device="cpu")
