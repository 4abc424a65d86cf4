"""The port's trinomial-tree engine against the JAX package's, case by case.

Each test of ``tests/test_trinomial.py`` as a pair test: the same inputs
through ``storage_tpu_torch`` (on ``device="cpu"``) and ``storage_tpu`` (its
XLA route; under ``jax.enable_x64`` in float64), in float32 and in float64,
with the original test's own assertions held on the port's results.

- Trees (host NumPy, the same code in both packages): equal arrays.
- NPVs: within 1e-5 relative in float32 (XLA's CPU code contracts the DP's
  products and sums into FMAs, torch rounds each op: measured 2.4e-7 on the
  README oracle) and 1e-10 in float64 (measured: equal).
- Decision cubes: equal except at near-ties, where two decisions' totals
  agree to within ``TIE_RTOL`` under the port's own value functions (the
  host's float64 re-derivation); at most ``CUBE_TIES`` of the entries.
  Measured, of 171,100 entries: on the constant-rate case 1 in float32 and
  none in float64; on the ratcheted case (rates constant below 1,000, where
  the value function is linear in inventory and injecting ties holding
  exactly) 2,538 in float32 and 2,694 in float64; none on the intrinsic
  tree.
- Bump-and-revalue deltas: float64 (bump 1e-5) within 1e-6 of max|delta|
  (measured 1.8e-9: an NPV rounding divided by the bump); float32 (bump
  0.01) within 1e-2: an NPV of ~1.5e4 has float32 ulps of 2e-3, and one ulp
  over a bump of 2 x 0.01 moves a delta of 50 by 0.1 (measured 2.9e-3).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import storage_tpu as jax_pkg  # noqa: E402
import storage_tpu_torch as torch_pkg  # noqa: E402
from storage_tpu.compile import build_valuation_context as jax_context  # noqa: E402
from storage_tpu.engines import tree as jax_tree  # noqa: E402
from storage_tpu.models import trinomial as jax_trinomial  # noqa: E402
from storage_tpu_torch.compile import build_valuation_context as torch_context  # noqa: E402
from storage_tpu_torch.engines import tree as torch_tree  # noqa: E402
from storage_tpu_torch.models import trinomial as torch_trinomial  # noqa: E402
from storage_tpu_torch.ops.decisions import bang_bang_decision_set  # noqa: E402
from storage_tpu_torch.ops.ratchets import interp_rates_host  # noqa: E402

torch.set_num_threads(2)

CUBE_TIES = 0.03
DTYPES = [
    pytest.param((jnp.float32, torch.float32, 1e-5, 1e-2, 2e-4), id="float32"),
    pytest.param((jnp.float64, torch.float64, 1e-10, 1e-6, 1e-9), id="float64"),
]


@pytest.fixture(params=DTYPES)
def dt(request):
    """(JAX dtype, torch dtype, NPV rtol, delta tolerance of max|delta|,
    TIE_RTOL)."""
    return request.param


def _jax(dt, fn, *args, **kw):
    """``fn`` of the JAX package in ``dt``'s dtype (float64 under x64)."""
    with jax.enable_x64(dt[0] == jnp.float64):
        return fn(*args, dtype=dt[0], **kw)


def _port(dt, fn, *args, **kw):
    return fn(*args, dtype=dt[1], device="cpu", **kw)


def _assert_trees_equal(a, b):
    for name in a._fields:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


def _built_pair(*args):
    ref = jax_trinomial.build_trinomial_tree(*args)
    got = torch_trinomial.build_trinomial_tree(*args)
    _assert_trees_equal(got, ref)
    return got


# --------------------------------------------------------------------------- #
# TestTreeConstruction                                                        #
# --------------------------------------------------------------------------- #


def test_martingale_calibration():
    n = 60
    forwards = 50.0 + 10.0 * np.sin(np.arange(n) / 5.0)
    vols = 0.8 + 0.2 * np.sin(np.arange(n) / 7.0)
    tree = _built_pair(forwards, vols, 8.0, 1 / 365.0)
    np.testing.assert_allclose((tree.probs * tree.values).sum(axis=1), forwards, rtol=1e-10)


def test_probabilities_valid():
    n = 60
    tree = _built_pair(np.full(n, 50.0), np.full(n, 0.9), 5.5, 1 / 365.0)
    assert (tree.branch_probs >= 0).all()
    np.testing.assert_allclose(tree.branch_probs.sum(axis=-1), 1.0, atol=1e-12)
    np.testing.assert_allclose(tree.probs.sum(axis=1), 1.0, atol=1e-9)


def test_terminal_log_variance_matches_ou():
    n, a, sigma, dt = 200, 5.0, 0.7, 1 / 365.0
    tree = _built_pair(np.full(n, 40.0), np.full(n, sigma), a, dt)
    t = (n - 1) * dt
    expected_var = sigma**2 * (1 - np.exp(-2 * a * t)) / (2 * a)
    logs = np.log(tree.values[-1])
    mean = (tree.probs[-1] * logs).sum()
    var = (tree.probs[-1] * (logs - mean) ** 2).sum()
    assert var == pytest.approx(expected_var, rel=0.05)
    _assert_trees_equal(torch_trinomial.build_intrinsic_tree(np.arange(1.0, 9.0)),
                        jax_trinomial.build_intrinsic_tree(np.arange(1.0, 9.0)))


# --------------------------------------------------------------------------- #
# TestReadmeTrinomialOracle                                                   #
# --------------------------------------------------------------------------- #


def readme_tree_storage(pkg):
    """The README ratcheted storage (README.md:238-303)."""
    return pkg.CmdtyStorage(
        freq="D", storage_start="2019-09-01", storage_end="2019-10-01",
        injection_cost=0.48, withdrawal_cost=0.74,
        ratchets=[
            ("2019-09-01", [(0.0, -44.85, 56.8), (100.0, -45.01, 54.5), (300.0, -45.78, 52.01),
                            (600.0, -46.17, 51.9), (800.0, -46.99, 50.8),
                            (1000.0, -47.12, 50.01)]),
            ("2019-09-20", [(0.0, -31.41, 48.33), (100.0, -31.85, 43.05),
                            (300.0, -31.68, 41.22), (600.0, -32.78, 40.08),
                            (800.0, -33.05, 39.74), (1000.0, -34.8, 38.51)]),
        ],
        ratchet_interp=pkg.RatchetInterp.LINEAR,
    )


def readme_curves():
    idx = pd.period_range("2019-09-15", "2019-10-01", freq="D")
    low, spread = 56.6, 87.81
    fwd = pd.Series(np.where(idx < pd.Period("2019-09-23", "D"), low, low + spread), index=idx)
    vols = pd.Series([0.975, 0.97, 0.96, 0.91, 0.89, 0.895, 0.891, 0.89, 0.875, 0.872, 0.871,
                      0.870, 0.869, 0.868, 0.867, 0.866, 0.8655], index=idx)
    return fwd, vols


def readme_npv(engine, pkg, run, dt):
    fwd, vols = readme_curves()
    return run(dt, engine.trinomial_value, readme_tree_storage(pkg), "2019-09-15", 50.0, fwd,
               vols, mean_reversion=5.5, time_step=1 / 365.0, interest_rates=0.025,
               settlement_rule=lambda p: pd.Period("2019-10-20", "D"),
               num_inventory_grid_points=112)


def test_npv_close_to_reference(dt):
    got = readme_npv(torch_tree, torch_pkg, _port, dt)
    assert got == pytest.approx(readme_npv(jax_tree, jax_pkg, _jax, dt), rel=dt[2])
    # Reference prints 24,809.48 (README.md:448-452); tree geometry and grids
    # differ by construction, so agreement is to model tolerance.
    assert got == pytest.approx(24_809.48, rel=0.02)


# --------------------------------------------------------------------------- #
# TestTreeConsistency                                                         #
# --------------------------------------------------------------------------- #


def _setup(pkg):
    storage = pkg.CmdtyStorage(
        "D", "2021-01-01", "2021-03-01", injection_cost=0.3, withdrawal_cost=0.4,
        min_inventory=0.0, max_inventory=2000.0, max_injection_rate=60.0,
        max_withdrawal_rate=80.0,
    )
    idx = pd.period_range("2021-01-01", "2021-03-01", freq="D")
    fwd = pd.Series(20.0 + 3.0 * np.sin(np.arange(len(idx)) / 8.0), index=idx)
    return storage, fwd, pd.Series(0.7, index=idx)


def test_intrinsic_tree_equals_intrinsic_engine(dt):
    """The degenerate tree of either package, in the dtype, against the
    intrinsic engine (its float64 host sweep over the dtype's DP)."""
    rates = pd.Series(0.03, index=pd.period_range("2021-01-01", "2021-06-01", freq="D"))
    npvs = []
    for pkg, engine, run, context in ((jax_pkg, jax_tree, _jax, jax_context),
                                      (torch_pkg, torch_tree, _port, torch_context)):
        storage, fwd, _ = _setup(pkg)
        ctx = context(storage, "2021-01-01", 800.0, fwd, rates, None)
        tree = (jax_trinomial if pkg is jax_pkg else torch_trinomial).build_intrinsic_tree(ctx.fwd)
        npvs.append(run(dt, engine.tree_value, ctx, tree).npv)
    ref, got = npvs
    assert got == pytest.approx(ref, rel=dt[2])
    storage, fwd, _ = _setup(torch_pkg)
    intr = _port(dt, torch_pkg.intrinsic_value, storage, "2021-01-01", 800.0, fwd, rates, None)
    assert got == pytest.approx(intr.npv, rel=5e-4)
    if dt[1] == torch.float32:  # the public entry point runs the default dtype
        public = torch_tree.intrinsic_tree_value(storage, "2021-01-01", 800.0, fwd, rates, None,
                                                 device="cpu")
        assert public == got


def test_tiny_vol_tree_equals_intrinsic(dt):
    values = []
    for pkg, engine, run in ((jax_pkg, jax_tree, _jax), (torch_pkg, torch_tree, _port)):
        storage, fwd, _ = _setup(pkg)
        vols = pd.Series(1e-6, index=fwd.index)
        values.append(run(dt, engine.trinomial_value, storage, "2021-01-01", 800.0, fwd, vols,
                          5.0, 1 / 365.0, None, None))
    ref, got = values
    assert got == pytest.approx(ref, rel=dt[2])
    storage, fwd, _ = _setup(torch_pkg)
    intr = _port(dt, torch_pkg.intrinsic_value, storage, "2021-01-01", 800.0, fwd, None, None)
    assert got == pytest.approx(intr.npv, rel=1e-3)


def test_tree_vs_lsmc_same_dynamics(dt):
    """Cross-model consistency (reference tolerance 0.5%,
    ``Lsmc/LsmcStorageValuationTest.cs:422-526``): the port's tree against
    the JAX package's, and the port's LSMC (in the dtype) against the tree."""
    a = 5.0
    values = []
    for pkg, engine, run in ((jax_pkg, jax_tree, _jax), (torch_pkg, torch_tree, _port)):
        storage, fwd, vols = _setup(pkg)
        values.append(run(dt, engine.trinomial_value, storage, "2021-01-01", 800.0, fwd, vols, a,
                          1 / 365.0, None, None, num_inventory_grid_points=200))
    ref, tree_npv = values
    assert tree_npv == pytest.approx(ref, rel=dt[2])
    storage, fwd, vols = _setup(torch_pkg)
    lsmc = _port(dt, torch_pkg.multi_factor_value, storage, "2021-01-01", 800.0, fwd, None, None,
                 factors=[(a, vols)], factor_corrs=None, num_sims=20_000,
                 basis_funcs="1 + x0 + x0**2 + x0**3", discount_deltas=False, seed=42,
                 num_inventory_grid_points=200, return_sim_panels=False)
    assert lsmc.npv == pytest.approx(tree_npv, rel=0.01)
    # LSMC is a lower bound of the true optimum; allow small MC slack.
    assert lsmc.npv <= tree_npv * 1.005


def _itm_storage(pkg):
    return pkg.CmdtyStorage(
        "D", "2021-01-01", "2021-01-15", injection_cost=0.1, withdrawal_cost=0.1,
        min_inventory=0.0, max_inventory=500.0, max_injection_rate=50.0,
        max_withdrawal_rate=50.0,
    )


def _assert_deltas_pair(got, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def test_trinomial_deltas_deep_itm_matches_volumes(dt):
    idx = pd.period_range("2021-01-01", "2021-01-15", freq="D")
    fwd = pd.Series(np.where(np.arange(len(idx)) < 7, 10.0, 40.0), index=idx)
    vols = pd.Series(0.1, index=idx)
    contracts = [pd.Period("2021-01-02", "D"), pd.Period("2021-01-09", "D")]
    deltas = [run(dt, engine.trinomial_deltas, _itm_storage(pkg), "2021-01-01", 0.0, fwd, vols,
                  8.0, 1 / 365.0, None, None, fwd_contracts=contracts)
              for pkg, engine, run in ((jax_pkg, jax_tree, _jax), (torch_pkg, torch_tree, _port))]
    ref, got = deltas
    _assert_deltas_pair(got, ref, dt[3])
    # Big spread, low vol: buy 50 on cheap days, sell 50 on expensive days.
    assert got[0] == pytest.approx(-50.0, abs=1.5)
    assert got[1] == pytest.approx(50.0, abs=1.5)


def test_delta_bump_size_f64_honours_reference_default():
    """The default (float64, bump 1e-5), float64 at a 1e-3 bump and float32
    (bump 0.01) in both packages: each pair agrees, the float64 deltas are
    bump-robust, the default is float64, float32 recovers them to ~1e-3 of
    the max rate."""
    idx = pd.period_range("2021-01-01", "2021-01-15", freq="D")
    fwd = pd.Series(20.0 + 2.0 * np.sin(np.arange(len(idx)) / 2.0), index=idx)
    vols = pd.Series(0.7, index=idx)
    contracts = [pd.Period("2021-01-03", "D"), pd.Period("2021-01-10", "D")]
    out = {}
    for pkg, engine, kw in ((jax_pkg, jax_tree, {}), (torch_pkg, torch_tree, {"device": "cpu"})):
        args = (_itm_storage(pkg), "2021-01-01", 100.0, fwd, vols, 8.0, 1 / 365.0, None, None)
        f64 = jnp.float64 if pkg is jax_pkg else torch.float64
        f32 = jnp.float32 if pkg is jax_pkg else torch.float32
        with jax.enable_x64(pkg is jax_pkg):
            out[pkg, "d64"] = engine.trinomial_deltas(*args, fwd_contracts=contracts, dtype=f64,
                                                      **kw)
            out[pkg, "d64_mid"] = engine.trinomial_deltas(*args, fwd_contracts=contracts,
                                                          dtype=f64, delta_shift=1e-3, **kw)
        out[pkg, "d32"] = engine.trinomial_deltas(*args, fwd_contracts=contracts, dtype=f32, **kw)
        out[pkg, "default"] = engine.trinomial_deltas(*args, fwd_contracts=contracts, **kw)
    for name, tol in (("d64", 1e-6), ("d64_mid", 1e-6), ("d32", 1e-2), ("default", 1e-6)):
        _assert_deltas_pair(out[torch_pkg, name], out[jax_pkg, name], tol)
    got = {name: np.asarray(out[torch_pkg, name]) for name in ("d64", "d64_mid", "d32", "default")}
    np.testing.assert_allclose(got["d64"], got["d64_mid"], atol=5e-3)
    np.testing.assert_allclose(got["default"], got["d64"], atol=1e-9)
    np.testing.assert_allclose(got["d32"], got["d64"], atol=0.05)


# --------------------------------------------------------------------------- #
# TestDecisionSimulator                                                       #
# --------------------------------------------------------------------------- #


def _valuations(dt, make_tree, storage_of, fwd, val_date, inventory, rates=None):
    """Both packages' ``tree_value`` on their own contexts of the same case."""
    out = []
    for pkg, engine, run, context, trinomial in (
            (jax_pkg, jax_tree, _jax, jax_context, jax_trinomial),
            (torch_pkg, torch_tree, _port, torch_context, torch_trinomial)):
        ctx = context(storage_of(pkg), val_date, inventory, fwd, rates, None)
        out.append((ctx, run(dt, engine.tree_value, ctx, make_tree(trinomial, ctx))))
    return out


def host_total(ctx, valuation, k, level, inventory, d):
    """The host float64 total (immediate NPV + expected continuation) of
    decision ``d`` at period ``k``, tree level ``level`` and ``inventory``,
    on ``valuation``'s value functions (the decision simulator's logic)."""
    tree = valuation.tree
    K = tree.num_levels
    loss = float(ctx.inventory_loss[k]) * inventory
    q_after = inventory + d - loss
    center = int(tree.branch_center[k, level])
    probs = tree.branch_probs[k, level]
    cont = sum(float(probs[p_col]) * float(np.interp(
        q_after, valuation.grids[k + 1], valuation.values[k + 1, min(max(center + off, 0), K - 1)]))
        for off, p_col in ((-1, 0), (0, 1), (1, 2)))
    inject = d > 0
    consumed = float(ctx.cons_inject[k] if inject else ctx.cons_withdraw[k]) * abs(d)
    cost = float(ctx.inject_cost[k] if inject else ctx.withdraw_cost[k]) * abs(d)
    immediate = (-(d + consumed) * float(tree.values[k, level]) * float(ctx.df_settle[k])
                 - (cost + float(ctx.inventory_cost_rate[k]) * inventory)
                 * float(ctx.df_cost[k]))
    return immediate + cont


def _assert_valuations_match(got, ref, dt, ctx):
    """NPV, value functions and decision cube of the port against JAX's; a
    cube entry may differ only at a near-tie of the two decisions."""
    assert got.npv == pytest.approx(ref.npv, rel=dt[2])
    assert got.values.shape == ref.values.shape and got.decisions.shape == ref.decisions.shape
    scale = np.abs(ref.values).max()
    np.testing.assert_allclose(got.values, ref.values, rtol=0, atol=100 * dt[2] * scale)
    differ = np.argwhere(got.decisions != ref.decisions)
    assert len(differ) <= CUBE_TIES * ref.decisions.size, (
        f"{len(differ)} of {ref.decisions.size} cube entries differ")
    for k, level, g in differ:
        inventory = float(got.grids[k][g])
        a = host_total(ctx, got, k, level, inventory, float(got.decisions[k, level, g]))
        b = host_total(ctx, got, k, level, inventory, float(ref.decisions[k, level, g]))
        assert abs(a - b) <= dt[4] * max(1.0, abs(a)), (k, level, g, a, b)


def test_intrinsic_tree_replay_matches_intrinsic_plan(dt):
    idx = pd.period_range("2021-01-01", "2021-01-15", freq="D")
    fwd = pd.Series(np.where(np.arange(len(idx)) < 7, 10.0, 40.0), index=idx)
    rates = pd.Series(0.05, index=pd.period_range("2021-01-01", "2021-06-01", freq="D"))
    (jctx, ref), (ctx, got) = _valuations(
        dt, lambda trinomial, c: trinomial.build_intrinsic_tree(c.fwd), _itm_storage, fwd,
        "2021-01-01", 0.0, rates)
    _assert_valuations_match(got, ref, dt, ctx)
    sim = torch_tree.simulate_decisions(ctx, got, [1] * ctx.n_steps)
    sim_ref = jax_tree.simulate_decisions(jctx, ref, [1] * jctx.n_steps)
    assert sim.npv == pytest.approx(sim_ref.npv, rel=dt[2])
    np.testing.assert_array_equal(sim.decision_profile.to_numpy(),
                                  sim_ref.decision_profile.to_numpy())
    # Degenerate tree: replay along the only path == the intrinsic plan.
    intr = _port(dt, torch_pkg.intrinsic_value, _itm_storage(torch_pkg), "2021-01-01", 0.0, fwd,
                 rates, None)
    assert sim.npv == pytest.approx(intr.npv, rel=5e-4)
    np.testing.assert_allclose(sim.decision_profile.to_numpy(),
                               intr.profile["inject_withdraw_volume"].to_numpy()[:-1], atol=1e-3)


def _stochastic_tree(trinomial, ctx):
    _, _, vols = _setup(torch_pkg)
    return trinomial.build_trinomial_tree(ctx.fwd, vols.reindex(ctx.periods).to_numpy(), 5.0,
                                          1 / 365.0)


def test_stochastic_tree_replay_paths_differ(dt):
    _, fwd, _ = _setup(torch_pkg)
    (jctx, ref), (ctx, got) = _valuations(dt, _stochastic_tree, lambda pkg: _setup(pkg)[0], fwd,
                                          "2021-01-01", 800.0)
    _assert_valuations_match(got, ref, dt, ctx)
    sims = {}
    for path in (0, 2):
        sims[path] = torch_tree.simulate_decisions(ctx, got, [path] * ctx.n_steps)
        sim_ref = jax_tree.simulate_decisions(jctx, ref, [path] * jctx.n_steps)
        assert sims[path].npv == pytest.approx(sim_ref.npv, rel=dt[2])
    # Prices diverge, so realised values and plans must differ.
    assert sims[2].npv != pytest.approx(sims[0].npv, rel=1e-3)
    assert np.isfinite(sims[2].npv) and np.isfinite(sims[0].npv)


# --------------------------------------------------------------------------- #
# TestTreeCubicInterpolation                                                  #
# --------------------------------------------------------------------------- #


def test_cubic_close_to_linear(dt):
    out = {}
    for pkg, engine, run in ((jax_pkg, jax_tree, _jax), (torch_pkg, torch_tree, _port)):
        storage, fwd, _ = _setup(pkg)
        kw = dict(cmdty_storage=storage, val_date="2021-01-01", inventory=800.0,
                  forward_curve=fwd, spot_volatility=pd.Series(0.6, index=fwd.index),
                  mean_reversion=14.0, time_step=1.0 / 365.0, interest_rates=None,
                  settlement_rule=None)
        for interpolation in ("linear", "cubic"):
            out[pkg, interpolation] = run(dt, engine.trinomial_value, interpolation=interpolation,
                                          **kw)
    for interpolation in ("linear", "cubic"):
        # The JAX package solves the spline's moments with XLA's tridiagonal
        # solve, the port with one product by the system's inverse.
        assert out[torch_pkg, interpolation] == pytest.approx(out[jax_pkg, interpolation],
                                                              rel=dt[2])
    linear, cubic = out[torch_pkg, "linear"], out[torch_pkg, "cubic"]
    assert cubic == pytest.approx(linear, rel=5e-3)
    assert cubic != linear  # the option must actually change the DP


# --------------------------------------------------------------------------- #
# TestDecisionCube                                                            #
# --------------------------------------------------------------------------- #


def _ratcheted(pkg):
    return pkg.CmdtyStorage(
        "D", "2021-01-01", "2021-03-01", injection_cost=0.3, withdrawal_cost=0.4,
        ratchets=[("2021-01-01", [(0.0, -50.0, 70.0), (1000.0, -50.0, 70.0),
                                  (2000.0, -80.0, 40.0)])],
        ratchet_interp=pkg.RatchetInterp.LINEAR,
    )


def _cube_case(dt, ratcheted=False):
    _, fwd, _ = _setup(torch_pkg)
    storage_of = _ratcheted if ratcheted else (lambda pkg: _setup(pkg)[0])
    (jctx, ref), (ctx, got) = _valuations(dt, _stochastic_tree, storage_of, fwd, "2021-01-01",
                                          800.0)
    _assert_valuations_match(got, ref, dt, ctx)
    return ctx, got


def test_cube_shape_and_replay_first_decision(dt):
    ctx, valuation = _cube_case(dt)
    n, K, G = ctx.n_steps, valuation.tree.num_levels, ctx.num_grid_points
    assert valuation.decisions.shape == (n, K, G)
    assert np.all(np.isfinite(valuation.decisions))
    # The period-0 decision at the root level and the (degenerate) starting
    # inventory grid point equal the simulator's first replayed decision.
    root = int(np.argmax(valuation.tree.probs[0]))
    for path_idx in (0, 1, 2):
        sim = torch_tree.simulate_decisions(ctx, valuation, [path_idx] * n)
        assert sim.decision_profile.iloc[0] == pytest.approx(
            float(valuation.decisions[0, root, 0]), abs=1e-3)


@pytest.mark.parametrize("ratcheted", [False, True])
def test_cube_decisions_are_host_optimal(dt, ratcheted):
    """At sampled (period, level, grid) points the cube's decision attains
    the host float64 re-derivation's optimal total (robust to ties), for
    constant and inventory-varying (ratcheted) rates."""
    ctx, valuation = _cube_case(dt, ratcheted)
    n, K, G = ctx.n_steps, valuation.tree.num_levels, ctx.num_grid_points
    start_offset = (ctx.periods[0] - ctx.storage.start).n
    rng = np.random.default_rng(11)

    checked = 0
    for k in rng.choice(n, size=6, replace=False):
        k = int(k)
        for level in rng.choice(K, size=4, replace=False):
            level = int(level)
            for g in rng.choice(G, size=4, replace=False):
                g = int(g)
                inventory = float(valuation.grids[k][g])
                loss = float(ctx.inventory_loss[k]) * inventory
                min_rate, max_rate = interp_rates_host(
                    ctx.storage.pillar_tables[start_offset + k], inventory, ctx.interp_kind)
                dset = bang_bang_decision_set(
                    min_rate, max_rate, inventory, loss,
                    float(ctx.inv_space.min_inventory[k + 1]),
                    float(ctx.inv_space.max_inventory[k + 1]), ctx.numerical_tolerance, 0)
                best = max(host_total(ctx, valuation, k, level, inventory, float(d))
                           for d in dset)
                cube_total = host_total(ctx, valuation, k, level, inventory,
                                        float(valuation.decisions[k, level, g]))
                assert cube_total >= best - 2e-4 * max(1.0, abs(best))
                checked += 1
    assert checked >= 90


def test_tree_runs_on_the_cuda_default_device_only_when_asked():
    """Every tree entry point defaults to ``device="cuda"``; with no card a
    call without ``device`` fails rather than falling back to the CPU."""
    import inspect

    for fn in (torch_tree.tree_value, torch_tree.trinomial_value, torch_tree.intrinsic_tree_value,
               torch_tree.trinomial_deltas):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    if not torch.cuda.is_available():
        storage, fwd, vols = _setup(torch_pkg)
        with pytest.raises((RuntimeError, AssertionError)):
            torch_tree.trinomial_value(storage, "2021-01-01", 800.0, fwd, vols, 5.0, 1 / 365.0,
                                       None, None)
