"""Backward induction of the PyTorch port against the JAX package.

The port's backward scan has the structure of the JAX package's
``backward_scan_pallas`` (kernel partials, ``assemble_regression`` between
steps), with the plain PyTorch version of the ``backward_update`` kernel on
the CPU; the spec is the JAX package's exact XLA path,
``backward_scan(quantize_weights=False)``.

- ``assemble_regression`` on identical partials: 1e-5 relative.
- The whole scan in float64: the two formulations are algebraically the same,
  so coefficients, standardization, sim-means and the final value surface
  agree to the stated bounds.
- One step in float32 on the same value surface and coefficients: the value
  update agrees to 1e-4 of max|V| outside near-tie flips (<= 0.5%); in
  float64 every entry to 1e-12 of max|V| (no decision flips).
- The whole scan in float32: standardization and sim-means agree.  Raw
  float32 coefficients are not comparable across implementations (the
  standardized Gram's condition number is 1e5-3e6 here, so accumulation
  order alone moves them by percents, and the scan compounds it); that
  measurement is recorded in ROADMAP Queue 3.
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
from chip_smoke import BASIS, build_case  # noqa: E402
from storage_tpu.compile import build_valuation_context  # noqa: E402
from storage_tpu.models.multi_factor import build_sim_coefficients, create_3_factor_season_params  # noqa: E402
from storage_tpu.models.simulation import simulate_factor_paths  # noqa: E402
from storage_tpu.ops.pallas_backward import assemble_regression as jax_assemble  # noqa: E402
from storage_tpu.ops.regression import basis_spec  # noqa: E402
from storage_tpu.utils.basis import THREE_FACTOR_SEASONAL_ALIASES, as_monomials  # noqa: E402
import storage_tpu_torch.engines.lsmc as tl  # noqa: E402
from storage_tpu_torch.interop import context_from_numpy  # noqa: E402
from storage_tpu_torch.ops.backward import assemble_regression, backward_update_reference  # noqa: E402
from storage_tpu_torch.ops.regression import BasisSpec  # noqa: E402

torch.set_num_threads(2)

SIMS, GRID = 2048, 40
V_TOL, MAX_FLIPPED = 1e-4, 0.005


class Case:
    """The headline case cut to 2021-07-01 (66 simulated steps), its
    regression paths and the inputs of both packages' backward scans."""

    def __init__(self):
        storage, fwd, ir, rule = build_case(jax_pkg, storage_end="2021-07-01")
        self.ctx = build_valuation_context(storage, "2021-04-25", 1500.0, fwd, ir, rule, GRID)
        vp = self.ctx.val_period
        factors, corrs = create_3_factor_season_params("D", 91.0, 0.85, 0.30, 0.19, vp,
                                                       storage.end)
        self.sim = build_sim_coefficients(factors, corrs, vp, fwd, list(self.ctx.periods[1:]))
        self.spec = basis_spec(as_monomials(BASIS, THREE_FACTOR_SEASONAL_ALIASES), 3)
        self.factors = np.asarray(
            simulate_factor_paths(self.sim, SIMS, None, key=jax.random.PRNGKey(12)))
        self.m = self.factors.shape[0] - 1
        self.first = 1  # the valuation date lies inside the storage

    def jax_scan(self, dtype, a, b, v_init):
        """JAX ``backward_scan`` over decision steps [a, b)."""
        dev = jl.device_inputs(self.ctx, dtype)
        lo, hi = self.first + a, self.first + b
        return jl.backward_scan(
            jnp.asarray(v_init, dtype), jnp.asarray(self.factors[a:b], dtype),
            jnp.asarray(self.sim.vols[a:b], dtype), jnp.asarray(self.sim.log_fwd_drift[a:b], dtype),
            dev.grids[lo:hi], dev.space_lo[lo + 1:hi + 1], dev.space_hi[lo + 1:hi + 1],
            dev.pillars[lo:hi], dev.loss[lo:hi], dev.inject_cost[lo:hi],
            dev.withdraw_cost[lo:hi], dev.cons_inject[lo:hi], dev.cons_withdraw[lo:hi],
            dev.inv_cost_rate[lo:hi], dev.df_settle[lo:hi], dev.df_start[lo:hi],
            spec=self.spec, interp_kind=self.ctx.interp_kind, num_grid_points=GRID,
            extra_decisions=0, quantize_weights=False,
        )

    def torch_dev(self, dtype):
        return tl.device_inputs(context_from_numpy(self.ctx), "cpu", dtype)

    def torch_scan(self, dtype):
        dev = self.torch_dev(dtype)
        geometry = tl._decision_geometry(dev, self.first, self.m, self.ctx.interp_kind, GRID, 0)
        return tl.backward_scan(
            torch.zeros((GRID, SIMS), dtype=dtype),
            torch.tensor(self.factors[:self.m], dtype=dtype),
            torch.tensor(self.sim.vols[:self.m], dtype=dtype),
            torch.tensor(self.sim.log_fwd_drift[:self.m], dtype=dtype),
            geometry, BasisSpec(*self.spec),
        )


@pytest.fixture(scope="module")
def case():
    return Case()


def _assert_surface_close(got, expected):
    """Value surfaces within V_TOL of max|V|, except near-tie flips."""
    scale = np.abs(expected).max()
    flipped = np.abs(got - expected) > V_TOL * scale
    assert flipped.mean() <= MAX_FLIPPED, f"{flipped.sum()} of {flipped.size} entries flipped"


def test_assemble_regression_matches_jax():
    rng = np.random.default_rng(7)
    B, G, S = 10, 40, 2048
    z = rng.standard_normal((B, S)).astype(np.float32)
    z[0] = 1.0  # a constant column (the intercept), as the basis has
    z[1:] = z[1:] * np.linspace(0.5, 2.0, B - 1)[:, None] + 0.3 * z[2:3]
    zr = np.concatenate([z, np.ones((1, S), np.float32)])
    v = (rng.standard_normal((G, S)) * 50.0 + rng.standard_normal((G, 1)) * 5.0).astype(np.float32)
    graw = (zr @ zr.T).astype(np.float32)
    praw = (zr @ v.T).astype(np.float32)
    musd = np.stack([rng.standard_normal(B), rng.uniform(0.5, 2.0, B)]).astype(np.float32)
    musd[:, 0] = (0.0, 1.0)
    delta = rng.standard_normal(G).astype(np.float32)
    ref = [np.asarray(x) for x in jax_assemble(graw, praw, musd, delta, S)]
    got = [x.numpy() for x in assemble_regression(
        torch.from_numpy(graw), torch.from_numpy(praw), torch.from_numpy(musd),
        torch.from_numpy(delta), S)]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())


def test_backward_scan_matches_jax_float64(case):
    with jax.enable_x64(True):
        v_ref, c_ref, mu_ref, sd_ref, vb_ref = (
            np.asarray(x) for x in case.jax_scan(jnp.float64, 0, case.m, np.zeros((SIMS, GRID))))
    v, c, mu, sd, vb = (x.numpy() for x in case.torch_scan(torch.float64))
    np.testing.assert_allclose(c, c_ref, rtol=1e-3, atol=1e-3 * np.abs(c_ref).max())
    np.testing.assert_allclose(mu, mu_ref, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(sd, sd_ref, rtol=1e-5)
    np.testing.assert_allclose(vb, vb_ref, rtol=0, atol=V_TOL * np.abs(vb_ref).max())
    _assert_surface_close(v, v_ref.T)


def _step_pair(case, jdtype, dtype):
    """One period (``_backward_step_core`` against the plain version of K1)
    on the JAX scan's own surface and coefficients, in the given dtypes:
    ``(v_out [G, S], v_ref [G, S])``."""
    k = case.m // 2
    v_next = np.asarray(case.jax_scan(jdtype, k + 1, case.m, np.zeros((SIMS, GRID)))[0])
    _v, coeffs, mus, sds, vbars = case.jax_scan(jdtype, k, case.m, np.zeros((SIMS, GRID)))
    jdev = jl.device_inputs(case.ctx, jdtype)
    K = case.first + k
    f_k = jnp.asarray(case.factors[k], jdtype)
    spot = jl.spot_from_factors(f_k, jnp.asarray(case.sim.vols[k], jdtype),
                                jnp.asarray(case.sim.log_fwd_drift[k], jdtype))
    v_ref = np.asarray(jl._backward_step_core(
        jnp.asarray(v_next), spot, f_k, jdev.grids[K], jdev.space_lo[K + 1],
        jdev.space_hi[K + 1], jdev.pillars[K], jdev.loss[K], jdev.inject_cost[K],
        jdev.withdraw_cost[K], jdev.cons_inject[K], jdev.cons_withdraw[K],
        jdev.inv_cost_rate[K], jdev.df_settle[K], jdev.df_start[K], spec=case.spec,
        interp_kind=case.ctx.interp_kind, num_grid_points=GRID, extra_decisions=0,
        quantize_weights=False)[0])

    dev = case.torch_dev(dtype)
    gj, gw, cost, price = (g[k] for g in tl._decision_geometry(
        dev, case.first, case.m, case.ctx.interp_kind, GRID, 0))

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype)

    table = tl.decision_table(t(coeffs[0]), t(vbars[0]), gj, gw, cost, price)
    scal = t(np.stack([
        np.concatenate([case.sim.log_fwd_drift[k:k + 1], case.sim.vols[k]]),
        np.concatenate([case.sim.log_fwd_drift[k - 1:k], case.sim.vols[k - 1]]),
    ]))
    musd = torch.stack([t(mus[0]), t(sds[0])])
    v_out, _graw, _praw = backward_update_reference(
        t(case.factors[k]), t(case.factors[k - 1]), t(v_next.T.copy()), table, t(vbars[0]),
        musd, gj, gw, scal, BasisSpec(*case.spec))
    return v_out.numpy(), v_ref.T


def test_backward_step_matches_jax_float32(case):
    """One period on the JAX scan's own surface and coefficients."""
    _assert_surface_close(*_step_pair(case, jnp.float32, torch.float32))


def test_backward_step_matches_jax_float64(case):
    """The same period in float64: every sim takes JAX's decision at every
    grid point (no near-tie flips), and the values agree to 1e-12 of
    max|V|."""
    with jax.enable_x64(True):
        v_out, v_ref = _step_pair(case, jnp.float64, torch.float64)
    assert v_out.dtype == np.float64
    np.testing.assert_allclose(v_out, v_ref, rtol=0, atol=1e-12 * np.abs(v_ref).max())


def test_backward_scan_matches_jax_float32(case):
    _v, _c, mu_ref, sd_ref, vb_ref = (
        np.asarray(x) for x in case.jax_scan(jnp.float32, 0, case.m, np.zeros((SIMS, GRID))))
    _v, _c, mu, sd, vb = (x.numpy() for x in case.torch_scan(torch.float32))
    np.testing.assert_allclose(mu, mu_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sd, sd_ref, rtol=1e-5)
    np.testing.assert_allclose(vb, vb_ref, rtol=0, atol=V_TOL * np.abs(vb_ref).max())
