"""Forward pass of the PyTorch port against the JAX package.

Both packages run the same policy — the JAX package's exact backward pass,
handed to the port through ``storage_tpu_torch.interop`` — on the same
valuation paths: the port's forward program (plain version of the
``forward_sim`` kernel on the CPU, the current-period step, trigger prices,
result assembly) against JAX ``forward_scan`` with ``collect_panels=False``.

NPV agrees to 1e-5 relative.  A near-tie decision that rounds the other way
sends a path down another inventory path from that step on, so per-path PVs
are compared outside such flipped paths, which are counted and bounded per
decision (as ``chip_smoke.py`` bounds the kernel against its plain version).
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
from storage_tpu_torch.ops.forward import pack_records  # noqa: E402
from storage_tpu_torch.ops.regression import BasisSpec  # noqa: E402

torch.set_num_threads(2)

SIMS, GRID = 2048, 40
NPV_RTOL, PV_RTOL, MAX_FLIPS_PER_DECISION = 1e-5, 1e-4, 1e-4


@pytest.fixture(scope="module")
def results():
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
                                  bnpv, discount_deltas=True, collect_panels=False, **statics)

    tdev = tl.device_inputs(context_from_numpy(ctx), "cpu")
    policy = lsmc_policy_from_numpy(dict(coeffs=coeffs, mus=mus, sds=sds, vbars=vbars,
                                         cont_mean0=cont_mean0, backward_npv=bnpv),
                                    device="cpu")[:4]
    got = tl._forward_program(
        torch.from_numpy(np.array(val)), torch.tensor(sim.vols, dtype=torch.float32),
        torch.tensor(sim.log_fwd_drift, dtype=torch.float32),
        torch.from_numpy(np.array(cont_mean0)), *policy, tdev, torch.tensor(float(bnpv)),
        BasisSpec(*spec), ctx.interp_kind, GRID, 0, ctx.val_date_is_first_step, None, True)
    return got, ref, val.shape[0] - 1


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x, dtype=np.float64)


def test_npv_matches_jax(results):
    got, ref, _m = results
    assert float(got.npv) == pytest.approx(float(ref.npv), rel=NPV_RTOL)
    assert float(got.backward_npv) == pytest.approx(float(ref.backward_npv), rel=1e-7)


def test_pv_by_sim_matches_outside_flipped_paths(results):
    got, ref, m = results
    a, b = _np(got.pv_by_sim), _np(ref.pv_by_sim)
    flipped = np.abs(a - b) > PV_RTOL * np.maximum(np.abs(b), 1e-6 * np.abs(b).max())
    assert flipped.sum() / (flipped.size * m) <= MAX_FLIPS_PER_DECISION, (
        f"{flipped.sum()} of {flipped.size} paths flipped over {m} steps")


def test_deltas_and_profile_match(results):
    got, ref, _m = results
    for name in ("deltas", "profile_means"):
        a, b = _np(getattr(got, name)), _np(getattr(ref, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3 * np.abs(b).max(), err_msg=name)


def test_triggers_match(results):
    got, ref, _m = results
    for side in ("inject", "withdraw"):
        has_a = _np(getattr(got, f"trigger_has_{side}")).astype(bool)
        has_b = _np(getattr(ref, f"trigger_has_{side}")).astype(bool)
        assert np.array_equal(has_a, has_b), side
        for what in ("volumes", "prices"):
            a = _np(getattr(got, f"trigger_{side}_{what}"))[has_b]
            b = _np(getattr(ref, f"trigger_{side}_{what}"))[has_b]
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3 * np.abs(b).max(),
                                       err_msg=f"{side} {what}")


@pytest.mark.parametrize("B,F,P,C", [(3, 1, 1, 3), (10, 3, 4, 3), (11, 2, 4, 5), (12, 3, 2, 3),
                                     (16, 4, 4, 5)],
                         ids=["B3", "B10", "B11-poly", "B12", "B16-poly"])
def test_pack_records_layout(B, F, P, C):
    """The CUDA forward kernel's per-step records: table rows padded to the
    pitch the kernel names (12 floats up to B = 11, 20 beyond), then the (mu, sd)
    pairs, pillars and scalars at their offsets, zero-padded to a multiple of 4."""
    n, G = 3, 7
    g = torch.Generator().manual_seed(B)
    tables, mus, sds = (torch.randn(n, B + 1, G, generator=g), torch.randn(n, B, generator=g),
                        torch.rand(n, B, generator=g) + 0.5)
    pillars, scalars = torch.randn(n, P, C, generator=g), torch.randn(n, 11 + F, generator=g)
    pitch = 12 if B + 1 <= 12 else 20
    used = G * pitch + 2 * B + P * C + 11 + F
    rec = pack_records(tables, mus, sds, pillars, scalars, pitch)
    assert rec.shape == (n, -(-used // 4) * 4) and rec.is_contiguous()
    rows = rec[:, :G * pitch].reshape(n, G, pitch)
    assert torch.equal(rows[:, :, :B + 1], tables.transpose(1, 2))
    assert not rows[:, :, B + 1:].any()
    off = G * pitch
    musd = torch.stack([mus, sds], dim=2).reshape(n, -1)  # (mu_b, sd_b) pairs
    for part in (musd, pillars.reshape(n, -1), scalars):
        assert torch.equal(rec[:, off:off + part.shape[1]], part)
        off += part.shape[1]
    assert off == used and not rec[:, off:].any()
