"""Fit once, reprice many: the port's ``fit_policy`` / ``LsmcPolicy`` /
``reprice`` against the JAX package's.

The headline case cut to 2021-07-01 (G = 40, seed 12, 2,048 paths), both
packages on the same factor paths (simulated by the JAX package, handed
over as numpy arrays):

- ``fit_policy``: backward NPV within 1e-4 relative and the current-period
  mean continuation within 1e-4 of its max (float32 regressions of condition
  number up to 3e6 fit other coefficients under another summation order,
  ROADMAP Queue 3, so coefficients are held in ``test_torch_backward.py`` in
  float64, not here).
- ``reprice`` under the JAX package's policy (through ``interop``): NPV
  within 1e-5 relative and deltas within 1e-3 of their max, as
  ``test_torch_options.py`` holds the forward pass.
- The port's ``fit_policy`` + ``reprice`` give ``run_lsmc``'s arrays exactly
  (the same programs); a saved and reloaded policy reprices to the same
  bits; a file written by either package loads in the other with equal
  arrays; per-sim panels on request; a streamed valuation set within 1e-6;
  a fresh valuation key within 4 standard errors.
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
from storage_tpu.ops.regression import basis_spec  # noqa: E402
from storage_tpu.utils.basis import THREE_FACTOR_SEASONAL_ALIASES, as_monomials  # noqa: E402
import storage_tpu_torch.engines.lsmc as tl  # noqa: E402
from storage_tpu_torch.interop import context_from_numpy, lsmc_policy_from_numpy  # noqa: E402
from storage_tpu_torch.models import simulation as torch_sim  # noqa: E402
from storage_tpu_torch.ops.regression import BasisSpec  # noqa: E402

torch.set_num_threads(2)

SIMS, GRID = 2048, 40
FIELDS = ("coeffs", "mus", "sds", "vbars", "cont_mean0", "backward_npv")


class Case:
    def __init__(self):
        storage, fwd, ir, rule = build_case(jax_pkg, "2021-07-01")
        self.ctx = build_valuation_context(storage, "2021-04-25", 1500.0, fwd, ir, rule, GRID)
        self.tctx = context_from_numpy(self.ctx)
        vp = self.ctx.val_period
        factors, corrs = create_3_factor_season_params("D", 91.0, 0.85, 0.30, 0.19, vp,
                                                       storage.end)
        self.sim = build_sim_coefficients(factors, corrs, vp, fwd, list(self.ctx.periods[1:]))
        self.spec = basis_spec(as_monomials(BASIS, THREE_FACTOR_SEASONAL_ALIASES), 3)
        self.tspec = BasisSpec(*self.spec)
        key = jax.random.PRNGKey(12)
        self.reg = simulate_factor_paths(self.sim, SIMS, None, key=key)
        self.val = simulate_factor_paths(self.sim, SIMS, None, key=jax.random.fold_in(key, 1))
        self.vols, self.drift = self.sim.vols, self.sim.log_fwd_drift
        # Both packages' policies on the regression set, and the repricings.
        self.jax_policy = jl.fit_policy(self.ctx, self.reg, self.vols, self.drift, self.spec)
        self.policy = tl.fit_policy(self.tctx, np.array(self.reg), self.vols, self.drift,
                                    self.tspec, device="cpu")
        self.repriced = self.reprice(self.policy)

    def reprice(self, policy, val=None, **kw):
        val = np.array(self.val) if val is None else val
        return tl.reprice(self.tctx, policy, val, self.vols, self.drift, self.tspec,
                          discount_deltas=True, device="cpu", **kw)


@pytest.fixture(scope="module")
def case():
    return Case()


def test_fit_policy_matches_jax(case):
    ref, got = case.jax_policy, case.policy
    for name in FIELDS:
        assert tuple(getattr(got, name).shape) == tuple(np.shape(getattr(ref, name))), name
        assert getattr(got, name).dtype == torch.float32
    assert float(got.backward_npv) == pytest.approx(float(ref.backward_npv), rel=1e-4)
    want = np.asarray(ref.cont_mean0)
    np.testing.assert_allclose(got.cont_mean0.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_reprice_under_the_jax_policy_matches_jax(case):
    ref = jl.reprice(case.ctx, case.jax_policy, case.val, case.vols, case.drift, case.spec,
                     discount_deltas=True)
    got = case.reprice(lsmc_policy_from_numpy(case.jax_policy, device="cpu"))
    assert float(got.npv) == pytest.approx(float(ref.npv), rel=1e-5)
    assert float(got.backward_npv) == float(ref.backward_npv)
    want = np.asarray(ref.deltas)
    np.testing.assert_allclose(got.deltas.numpy(), want, rtol=0, atol=1e-3 * np.abs(want).max())


def test_fit_then_reprice_is_run_lsmc(case):
    whole = tl.run_lsmc(case.tctx, torch.from_numpy(np.asarray(case.reg)),
                        torch.from_numpy(np.asarray(case.val)), case.vols, case.drift,
                        case.tspec, discount_deltas=True, device="cpu")
    for name in ("npv", "backward_npv", "deltas", "profile_means", "pv_by_sim"):
        assert torch.equal(getattr(case.repriced, name), getattr(whole, name)), name


def test_saved_policy_reloads_and_reprices_to_the_same_bits(case, tmp_path):
    path = str(tmp_path / "policy.npz")
    case.policy.save(path)
    loaded = tl.LsmcPolicy.load(path, device="cpu")
    for name in FIELDS:
        assert torch.equal(getattr(loaded, name), getattr(case.policy, name)), name
    assert torch.equal(case.reprice(loaded).pv_by_sim, case.repriced.pv_by_sim)


def test_port_policy_file_loads_in_jax(case, tmp_path):
    path = str(tmp_path / "port_policy.npz")
    case.policy.save(path)
    loaded = jl.LsmcPolicy.load(path)
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(loaded, name)),
                                      getattr(case.policy, name).numpy(), err_msg=name)
    ref = jl.reprice(case.ctx, loaded, case.val, case.vols, case.drift, case.spec,
                     discount_deltas=True)
    assert float(ref.npv) == pytest.approx(float(case.repriced.npv), rel=1e-5)


@pytest.mark.parametrize("how", ["load", "interop-path", "interop-object", "interop-mapping"])
def test_jax_policy_loads_in_the_port(case, tmp_path, how):
    path = str(tmp_path / "jax_policy.npz")
    case.jax_policy.save(path)
    loaded = {
        "load": lambda: tl.LsmcPolicy.load(path, device="cpu"),
        "interop-path": lambda: lsmc_policy_from_numpy(path, device="cpu"),
        "interop-object": lambda: lsmc_policy_from_numpy(case.jax_policy, device="cpu"),
        "interop-mapping": lambda: lsmc_policy_from_numpy(
            {f: np.asarray(getattr(case.jax_policy, f)) for f in FIELDS}, device="cpu"),
    }[how]()
    assert isinstance(loaded, tl.LsmcPolicy) and loaded._fields == jl.LsmcPolicy._fields
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(loaded, name).numpy(),
                                      np.asarray(getattr(case.jax_policy, name)), err_msg=name)


def test_reprice_collects_panels_on_request(case):
    got = case.reprice(case.policy, collect_panels=True)
    n = case.ctx.n_steps
    assert got.panels.shape == (n + 1, 6, SIMS)
    assert case.repriced.panels.shape == (n + 1, 6, 0)
    assert torch.equal(got.pv_by_sim, case.repriced.pv_by_sim)
    means, profile = got.panels.mean(dim=-1), got.profile_means
    assert float((means - profile).abs().max()) <= 1e-4 * float(profile.abs().max())


def test_reprice_takes_a_streamed_valuation_set(case):
    key = torch_sim.fold_in(torch_sim.prng_key(12), 1)
    whole = torch_sim.simulate_factor_paths(case.sim, SIMS, key=key, device="cpu")
    src = torch_sim.StreamingFactorSource(case.sim, SIMS, key, every=32, device="cpu")
    got = case.reprice(case.policy, val=src)
    ref = case.reprice(case.policy, val=whole)
    # The same paths and decisions; the per-span PV sums add in another order.
    assert float(got.npv) == pytest.approx(float(ref.npv), rel=1e-6)
    assert torch.allclose(got.deltas, ref.deltas, rtol=0, atol=1e-5 * float(ref.deltas.abs().max()))


def test_reprice_on_a_fresh_key_stays_within_the_sampling_error(case):
    fresh = torch_sim.simulate_factor_paths(case.sim, SIMS, seed=99, device="cpu")
    got = case.reprice(case.policy, val=fresh)
    pv = case.repriced.pv_by_sim.double()
    stderr = float(pv.std()) / np.sqrt(SIMS)
    assert abs(float(got.npv) - float(case.repriced.npv)) <= 4.0 * np.sqrt(2.0) * stderr
