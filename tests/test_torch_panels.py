"""Per-sim panels of the PyTorch port against the JAX package.

- The forward program with panels, at 2,048 paths on the headline case cut
  to 2021-07-01 (G = 40, seed 12), under the JAX package's exact policy
  (carried across through ``interop``): the port's program (the plain
  version of the ``forward_sim`` kernel writing each step's rows) against
  JAX ``_forward_program_jit(collect_panels=True)``.  Paths whose PV differs
  by more than 1e-4 relative, or any of whose volumes differ, took a flipped
  near-tie decision and are bounded per decision (1e-4); on the other paths
  every panel field agrees to 1e-5 of its max, including the current-period
  row (one decision for every sim) and the end row
  ``[inv_final, 0, 0, 0, 0, terminal_pv]``.
- The device->host panel fetch in row blocks: exact, into one contiguous
  float64 array.
- The API's defaults (``return_sim_panels=True``) through both packages at
  8,192 paths: every frame's index and shape, the two spot panels to 1e-5
  relative (the same threefry paths), NPV to 1e-4 relative, and the panels'
  own consistency (sim-means are the expected profile to 1e-5 of each
  column's max; NPV is the mean of the summed per-sim PVs to 1e-5).
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

SIMS, GRID, API_SIMS = 2048, 40, 8192
PANEL_TOL, PV_RTOL, MAX_FLIPS_PER_DECISION = 1e-5, 1e-4, 1e-4
SPOT_RTOL, NPV_RTOL = 1e-5, 1e-4

FRAMES = ("sim_spot_regress", "sim_spot_valuation", "sim_inventory", "sim_inject_withdraw",
          "sim_cmdty_consumed", "sim_inventory_loss", "sim_net_volume", "sim_pv")


@pytest.fixture(scope="module")
def programs():
    storage, fwd, ir, rule = build_case(jax_pkg, storage_end="2021-07-01")
    ctx = build_valuation_context(storage, "2021-04-25", 1500.0, fwd, ir, rule, GRID)
    vp = ctx.val_period
    factors, corrs = create_3_factor_season_params("D", 91.0, 0.85, 0.30, 0.19, vp, storage.end)
    sim = build_sim_coefficients(factors, corrs, vp, fwd, list(ctx.periods[1:]))
    spec = basis_spec(as_monomials(BASIS, THREE_FACTOR_SEASONAL_ALIASES), 3)
    key = jax.random.PRNGKey(12)
    reg = simulate_factor_paths(sim, SIMS, None, key=key)
    val = simulate_factor_paths(sim, SIMS, None, key=jax.random.fold_in(key, 1))
    vols = jnp.asarray(sim.vols, jnp.float32)
    drift = jnp.asarray(sim.log_fwd_drift, jnp.float32)
    dev = jl.device_inputs(ctx, jnp.float32)
    statics = dict(spec=spec, interp_kind=ctx.interp_kind, num_grid_points=GRID,
                   extra_decisions=0, val_first=ctx.val_date_is_first_step, terminal_fn=None)
    bnpv, cont_mean0, coeffs, mus, sds, vbars = jl._backward_program_jit(
        reg, vols, drift, dev, quantize_weights=False, **statics)
    ref = jl._forward_program_jit(val, vols, drift, cont_mean0, coeffs, mus, sds, vbars, dev,
                                  bnpv, discount_deltas=True, collect_panels=True, **statics)
    got = tl._forward_program(
        torch.from_numpy(np.array(val)), torch.tensor(sim.vols, dtype=torch.float32),
        torch.tensor(sim.log_fwd_drift, dtype=torch.float32),
        torch.from_numpy(np.array(cont_mean0)), *_policy(coeffs, mus, sds, vbars, cont_mean0, bnpv),
        tl.device_inputs(context_from_numpy(ctx), "cpu"), torch.tensor(float(bnpv)),
        BasisSpec(*spec), ctx.interp_kind, GRID, 0, ctx.val_date_is_first_step, None, True,
        collect_panels=True)
    return got, ref, val.shape[0] - 1


def test_forward_panels_match_jax(programs):
    got, ref, m = programs
    a, b = got.panels.numpy().astype(np.float64), np.asarray(ref.panels, np.float64)
    assert a.shape == b.shape == (m + 2, 6, SIMS)
    pv_a, pv_b = got.pv_by_sim.numpy(), np.asarray(ref.pv_by_sim)
    flipped = np.abs(pv_a - pv_b) > PV_RTOL * np.maximum(np.abs(pv_b), 1e-6 * np.abs(pv_b).max())
    flipped |= (np.abs(a[:, 1] - b[:, 1]) > PANEL_TOL * np.abs(b[:, 1]).max()).any(axis=0)
    assert flipped.sum() / (flipped.size * m) <= MAX_FLIPS_PER_DECISION
    ok = ~flipped
    for f, name in enumerate(tl.PANEL_FIELDS):
        scale = np.abs(b[:, f]).max()
        np.testing.assert_allclose(a[:, f, ok], b[:, f, ok], rtol=0, atol=PANEL_TOL * scale,
                                   err_msg=name)


def test_step0_and_end_rows(programs):
    got, ref, _m = programs
    a, b = got.panels.numpy(), np.asarray(ref.panels)
    # Current period: every sim takes the one decision of the forward price.
    np.testing.assert_array_equal(a[0], np.broadcast_to(a[0, :, :1], a[0].shape))
    np.testing.assert_allclose(a[0], b[0], rtol=1e-6, atol=1e-6)
    # End row: the inventory after the last decision (inventory + volume -
    # loss, as the kernel carries it), then zeros, then the terminal PV
    # (none here).
    np.testing.assert_array_equal(a[-1, 0], (a[-2, 0] + a[-2, 1]) - a[-2, 3])
    np.testing.assert_array_equal(a[-1, 1:], 0.0)
    np.testing.assert_allclose(a[-1, 0].mean(), float(got.profile_means[-1, 0]), rtol=1e-6)
    np.testing.assert_array_equal(b[-1, 1:], 0.0)


def test_fetch_panel_in_row_blocks():
    """A panel larger than one block is fetched block by block into one
    contiguous float64 host array; an uncollected panel gives an empty frame."""
    from storage_tpu_torch.valuation import _fetch_panel, _panel_frame

    panel = torch.from_numpy(np.random.default_rng(3).normal(size=(7, 5)).astype(np.float32))
    out = _fetch_panel(panel, max_chunk_bytes=2 * 5 * 8)  # 2 rows a block: 4 blocks
    assert out.dtype == np.float64 and out.flags.c_contiguous
    np.testing.assert_array_equal(out, panel.numpy().astype(np.float64))
    frame = _panel_frame(panel, range(7))
    np.testing.assert_array_equal(frame.to_numpy(), out)
    assert _panel_frame(panel[:, :0], range(7)).shape == (7, 0)


def _value(pkg, **kw):
    storage, fwd, ir, rule = build_case(pkg, storage_end="2021-07-01")
    return pkg.three_factor_seasonal_value(
        cmdty_storage=storage, val_date="2021-04-25", inventory=1500.0, fwd_curve=fwd,
        interest_rates=ir, settlement_rule=rule, num_sims=API_SIMS, seed=12,
        spot_mean_reversion=91.0, spot_vol=0.85, long_term_vol=0.30, seasonal_vol=0.19,
        basis_funcs=BASIS, discount_deltas=True, num_inventory_grid_points=GRID, **kw)


@pytest.fixture(scope="module")
def api_results():
    return _value(torch_pkg, device="cpu"), _value(jax_pkg)


def test_api_defaults_frames_match_jax(api_results):
    got, ref = api_results
    assert got.npv == pytest.approx(ref.npv, rel=NPV_RTOL)
    for name in FRAMES:
        a, b = getattr(got, name), getattr(ref, name)
        assert a.shape == b.shape, name
        assert a.index.equals(b.index), name
        assert a.to_numpy().dtype == np.float64, name
    assert got.sim_inventory.shape == (len(got.expected_profile), API_SIMS)
    for name in ("sim_spot_regress", "sim_spot_valuation"):
        a, b = getattr(got, name).to_numpy(), getattr(ref, name).to_numpy()
        np.testing.assert_allclose(a, b, rtol=SPOT_RTOL, err_msg=name)


def test_api_panels_consistent(api_results):
    got, _ref = api_results
    columns = ("inventory", "inject_withdraw_volume", "cmdty_consumed", "inventory_loss",
               "net_volume", "period_pv")
    for name, column in zip(FRAMES[2:], columns):
        expected = got.expected_profile[column].to_numpy()
        np.testing.assert_allclose(getattr(got, name).mean(axis=1).to_numpy(), expected,
                                   rtol=0, atol=PANEL_TOL * np.abs(expected).max(), err_msg=name)
    assert got.npv == pytest.approx(float(got.sim_pv.to_numpy().sum(axis=0).mean()), rel=1e-5)
