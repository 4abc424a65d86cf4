"""Extra decisions and POLY ratchets in the PyTorch port, against the JAX package.

Cases: the headline case cut to 2021-07-01 (G = 40, seed 12) with
``extra_decisions`` 1 and 2 (D = 5, 7 decisions) on its LINEAR ratchets, and
with its pillars fitted as POLYNOMIAL ratchets (exact-fit cubics, as
``CmdtyStorage`` builds them) at ``extra_decisions`` 1.

- Forward pass at 2,048 paths under the JAX package's exact policy (carried
  across through ``interop``): the port's forward program (the plain version
  of the ``forward_sim`` kernel) against JAX ``forward_scan``; NPV to 1e-5
  relative, flipped paths (PV off by more than 1e-4 relative) at most 1e-4
  per decision, as ``test_torch_forward.py`` holds D = 3.
- Backward scan in float64 at 2,048 paths, as ``test_torch_backward.py``
  holds it: coefficients to 1e-3 of their max, standardization to 1e-5,
  sim-means to 1e-4 of their max, value surface to 1e-4 of max|V| outside at
  most 0.5% of entries.
- Whole valuations at 8,192 paths through ``three_factor_seasonal_value``:
  NPV to 1e-4 relative, intrinsic to 1e-6.

Also the two faults of the port's first slice that these options exposed:
the device inputs kept only the first three pillar columns (POLY's
coefficients ride in columns 3 and 4), and the early returns of the
valuation never reported progress 1.0.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import storage_tpu as jax_pkg  # noqa: E402
import storage_tpu.engines.lsmc as jl  # noqa: E402
import storage_tpu_torch as torch_pkg  # noqa: E402
from chip_smoke import BASIS, build_case  # noqa: E402
from storage_tpu.compile import build_valuation_context  # noqa: E402
from storage_tpu.models.multi_factor import build_sim_coefficients, create_3_factor_season_params  # noqa: E402
from storage_tpu.models.simulation import simulate_factor_paths  # noqa: E402
from storage_tpu.ops.regression import basis_spec  # noqa: E402
from storage_tpu.utils.basis import THREE_FACTOR_SEASONAL_ALIASES, as_monomials  # noqa: E402
import storage_tpu_torch.engines.lsmc as tl  # noqa: E402
from storage_tpu_torch.interop import context_from_numpy, lsmc_policy_from_numpy  # noqa: E402
from storage_tpu_torch.ops.regression import BasisSpec  # noqa: E402

torch.set_num_threads(2)


def _policy(coeffs, mus, sds, vbars, cont_mean0, bnpv):
    """The four per-step tensors of the JAX policy, through the port's interop."""
    return lsmc_policy_from_numpy(dict(coeffs=coeffs, mus=mus, sds=sds, vbars=vbars,
                                       cont_mean0=cont_mean0, backward_npv=bnpv),
                                  device="cpu")[:4]

SIMS, GRID, VAL_SIMS = 2048, 40, 8192
NPV_RTOL, FWD_NPV_RTOL, PV_RTOL, MAX_FLIPS_PER_DECISION = 1e-4, 1e-5, 1e-4, 1e-4
V_TOL, MAX_FLIPPED = 1e-4, 0.005
OPTIONS = {"extra1": ("LINEAR", 1), "extra2": ("LINEAR", 2), "poly": ("POLYNOMIAL", 1)}


class Case:
    """One option set on the cut headline case: the JAX context, both path
    sets and the JAX package's exact backward policy."""

    def __init__(self, interp, extra):
        storage, fwd, ir, rule = build_case(jax_pkg, "2021-07-01", interp)
        self.extra = extra
        self.ctx = build_valuation_context(storage, "2021-04-25", 1500.0, fwd, ir, rule, GRID)
        vp = self.ctx.val_period
        factors, corrs = create_3_factor_season_params("D", 91.0, 0.85, 0.30, 0.19, vp,
                                                       storage.end)
        self.sim = build_sim_coefficients(factors, corrs, vp, fwd, list(self.ctx.periods[1:]))
        self.spec = basis_spec(as_monomials(BASIS, THREE_FACTOR_SEASONAL_ALIASES), 3)
        key = jax.random.PRNGKey(12)
        self.reg = simulate_factor_paths(self.sim, SIMS, None, key=key)
        self.val = simulate_factor_paths(self.sim, SIMS, None, key=jax.random.fold_in(key, 1))
        self.m = self.reg.shape[0] - 1
        self.statics = dict(spec=self.spec, interp_kind=self.ctx.interp_kind,
                            num_grid_points=GRID, extra_decisions=extra,
                            val_first=self.ctx.val_date_is_first_step, terminal_fn=None)


@pytest.fixture(scope="module", params=list(OPTIONS), ids=list(OPTIONS))
def case(request):
    return Case(*OPTIONS[request.param])


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x, dtype=np.float64)


def test_forward_matches_jax(case):
    vols = jnp.asarray(case.sim.vols, jnp.float32)
    drift = jnp.asarray(case.sim.log_fwd_drift, jnp.float32)
    dev = jl.device_inputs(case.ctx, jnp.float32)
    bnpv, cont_mean0, coeffs, mus, sds, vbars = jl._backward_program_jit(
        case.reg, vols, drift, dev, quantize_weights=False, **case.statics)
    ref = jl._forward_program_jit(case.val, vols, drift, cont_mean0, coeffs, mus, sds, vbars,
                                  dev, bnpv, discount_deltas=True, collect_panels=False,
                                  **case.statics)
    got = tl._forward_program(
        torch.from_numpy(np.array(case.val)), torch.tensor(case.sim.vols, dtype=torch.float32),
        torch.tensor(case.sim.log_fwd_drift, dtype=torch.float32),
        torch.from_numpy(np.array(cont_mean0)), *_policy(coeffs, mus, sds, vbars, cont_mean0, bnpv),
        tl.device_inputs(context_from_numpy(case.ctx), "cpu"), torch.tensor(float(bnpv)),
        BasisSpec(*case.spec), case.ctx.interp_kind, GRID, case.extra,
        case.ctx.val_date_is_first_step, None, True)
    assert float(got.npv) == pytest.approx(float(ref.npv), rel=FWD_NPV_RTOL)
    a, b = _np(got.pv_by_sim), _np(ref.pv_by_sim)
    flipped = np.abs(a - b) > PV_RTOL * np.maximum(np.abs(b), 1e-6 * np.abs(b).max())
    assert flipped.sum() / (flipped.size * case.m) <= MAX_FLIPS_PER_DECISION, (
        f"{flipped.sum()} of {flipped.size} paths flipped over {case.m} steps")


def test_backward_scan_matches_jax_float64(case):
    factors = np.asarray(case.reg)
    m, first = case.m, 1
    with jax.enable_x64(True):
        dev = jl.device_inputs(case.ctx, jnp.float64)
        lo, hi = first, first + m
        v_ref, c_ref, mu_ref, sd_ref, vb_ref = (np.asarray(x) for x in jl.backward_scan(
            jnp.zeros((SIMS, GRID), jnp.float64), jnp.asarray(factors[:m], jnp.float64),
            jnp.asarray(case.sim.vols[:m], jnp.float64),
            jnp.asarray(case.sim.log_fwd_drift[:m], jnp.float64),
            dev.grids[lo:hi], dev.space_lo[lo + 1:hi + 1], dev.space_hi[lo + 1:hi + 1],
            dev.pillars[lo:hi], dev.loss[lo:hi], dev.inject_cost[lo:hi],
            dev.withdraw_cost[lo:hi], dev.cons_inject[lo:hi], dev.cons_withdraw[lo:hi],
            dev.inv_cost_rate[lo:hi], dev.df_settle[lo:hi], dev.df_start[lo:hi],
            spec=case.spec, interp_kind=case.ctx.interp_kind, num_grid_points=GRID,
            extra_decisions=case.extra, quantize_weights=False))
    tdev = tl.device_inputs(context_from_numpy(case.ctx), "cpu", torch.float64)
    geometry = tl._decision_geometry(tdev, first, m, case.ctx.interp_kind, GRID, case.extra)
    assert geometry[0].shape[1] == 2 * case.extra + 3
    v, c, mu, sd, vb = (x.numpy() for x in tl.backward_scan(
        torch.zeros((GRID, SIMS), dtype=torch.float64), torch.tensor(factors[:m], dtype=torch.float64),
        torch.tensor(case.sim.vols[:m], dtype=torch.float64),
        torch.tensor(case.sim.log_fwd_drift[:m], dtype=torch.float64), geometry,
        BasisSpec(*case.spec)))
    np.testing.assert_allclose(c, c_ref, rtol=1e-3, atol=1e-3 * np.abs(c_ref).max())
    np.testing.assert_allclose(mu, mu_ref, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(sd, sd_ref, rtol=1e-5)
    np.testing.assert_allclose(vb, vb_ref, rtol=0, atol=V_TOL * np.abs(vb_ref).max())
    flipped = np.abs(v - v_ref.T) > V_TOL * np.abs(v_ref).max()
    assert flipped.mean() <= MAX_FLIPPED, f"{flipped.sum()} of {flipped.size} entries flipped"


def _value(pkg, interp, extra, **kw):
    storage, fwd, ir, rule = build_case(pkg, "2021-07-01", interp)
    return pkg.three_factor_seasonal_value(
        cmdty_storage=storage, val_date="2021-04-25", inventory=1500.0, fwd_curve=fwd,
        interest_rates=ir, settlement_rule=rule, num_sims=VAL_SIMS, seed=12,
        spot_mean_reversion=91.0, spot_vol=0.85, long_term_vol=0.30, seasonal_vol=0.19,
        basis_funcs=BASIS, discount_deltas=True, num_inventory_grid_points=GRID,
        extra_decisions=extra, return_sim_panels=False, **kw)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_valuation_matches_jax(option):
    interp, extra = OPTIONS[option]
    ref = _value(jax_pkg, interp, extra)
    got = _value(torch_pkg, interp, extra, device="cpu")
    assert got.npv == pytest.approx(ref.npv, rel=NPV_RTOL)
    assert got.intrinsic_npv == pytest.approx(ref.intrinsic_npv, rel=1e-6)
    assert got.extrinsic_npv > 0.0


def test_device_inputs_keep_poly_coefficients():
    """POLY's coefficients ride in pillar columns 3 and 4: the port's context
    and device inputs keep every column of the JAX package's."""
    storage, fwd, ir, rule = build_case(jax_pkg, "2021-07-01", "POLYNOMIAL")
    ctx = build_valuation_context(storage, "2021-04-25", 1500.0, fwd, ir, rule, GRID)
    ported = context_from_numpy(ctx)
    assert ctx.pillars.shape[-1] == 5
    np.testing.assert_array_equal(ported.pillars, np.asarray(ctx.pillars))
    dev = tl.device_inputs(ported, "cpu")
    np.testing.assert_array_equal(dev.pillars.numpy(), np.asarray(ctx.pillars, np.float32))


@pytest.mark.parametrize("val_date,inventory,terminal", [
    ("2021-08-01", 0.0, None), ("2021-07-01", 0.0, None), ("2021-07-01", 10.0, 0.8),
], ids=["expired", "end_empty", "end_terminal"])
def test_early_returns_report_progress(val_date, inventory, terminal):
    """The valuation's early returns report 1.0, as the JAX package's do."""
    lists = []
    for pkg, kw in ((jax_pkg, {}), (torch_pkg, {"device": "cpu"})):
        storage, fwd, ir, rule = build_case(pkg, "2021-07-01")
        if terminal is not None:
            storage = pkg.CmdtyStorage(
                "D", "2021-04-01", "2021-07-01", 0.01, 0.025, min_inventory=0.0,
                max_inventory=7000.0, max_injection_rate=250.0, max_withdrawal_rate=275.0,
                terminal_storage_npv=lambda p, i: terminal * p * i)
        progress = []
        res = pkg.three_factor_seasonal_value(
            storage, val_date, inventory, fwd, ir, rule, 91.0, 0.85, 0.30, 0.19, 64, BASIS,
            True, seed=1, on_progress_update=progress.append, **kw)
        lists.append((progress, res.npv))
    assert lists[0] == lists[1]
    assert lists[1][0] == [1.0]
