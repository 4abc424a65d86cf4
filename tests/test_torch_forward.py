"""Forward pass of the PyTorch port against the JAX package.

Both packages run the same policy — the JAX package's exact backward pass,
handed to the port through ``storage_tpu_torch.interop`` — on the same
valuation paths: the port's forward program (plain version of the
``forward_sim`` kernel on the CPU, the current-period step, trigger prices,
result assembly) against JAX ``forward_scan`` with ``collect_panels=False``.

NPV agrees to 1e-5 relative (in float64: every path's PV to 1e-12, no
decision flips).  A near-tie decision that rounds the other way
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
from storage_tpu_torch.ops.forward import forward_sim_reference, pack_records  # noqa: E402
from storage_tpu_torch.ops.regression import BasisSpec  # noqa: E402

torch.set_num_threads(2)

SIMS, GRID = 2048, 40
NPV_RTOL, PV_RTOL, MAX_FLIPS_PER_DECISION = 1e-5, 1e-4, 1e-4


def _programs(jdtype, dtype):
    """Both packages' forward programs under the JAX package's exact policy,
    in the given dtypes: ``(port arrays, JAX arrays, decision steps)``."""
    storage, fwd, ir, rule = build_case(jax_pkg, storage_end="2021-07-01")
    ctx = build_valuation_context(storage, "2021-04-25", 1500.0, fwd, ir, rule, GRID)
    vp = ctx.val_period
    factors, corrs = create_3_factor_season_params("D", 91.0, 0.85, 0.30, 0.19, vp, storage.end)
    sim = build_sim_coefficients(factors, corrs, vp, fwd, list(ctx.periods[1:]))
    spec = basis_spec(as_monomials(BASIS, THREE_FACTOR_SEASONAL_ALIASES), 3)
    key = jax.random.PRNGKey(12)
    reg = simulate_factor_paths(sim, SIMS, None, False, jdtype, key=key)
    val = simulate_factor_paths(sim, SIMS, None, False, jdtype, key=jax.random.fold_in(key, 1))
    vols = jnp.asarray(sim.vols, jdtype)
    drift = jnp.asarray(sim.log_fwd_drift, jdtype)
    dev = jl.device_inputs(ctx, jdtype)
    statics = dict(spec=spec, interp_kind=ctx.interp_kind, num_grid_points=GRID,
                   extra_decisions=0, val_first=ctx.val_date_is_first_step, terminal_fn=None)
    bnpv, cont_mean0, coeffs, mus, sds, vbars = jl._backward_program_jit(
        reg, vols, drift, dev, quantize_weights=False, **statics)
    ref = jl._forward_program_jit(val, vols, drift, cont_mean0, coeffs, mus, sds, vbars, dev,
                                  bnpv, discount_deltas=True, collect_panels=False, **statics)

    tdev = tl.device_inputs(context_from_numpy(ctx), "cpu", dtype)
    policy = lsmc_policy_from_numpy(dict(coeffs=coeffs, mus=mus, sds=sds, vbars=vbars,
                                         cont_mean0=cont_mean0, backward_npv=bnpv),
                                    device="cpu", dtype=dtype)[:4]
    got = tl._forward_program(
        torch.from_numpy(np.array(val)), torch.tensor(sim.vols, dtype=dtype),
        torch.tensor(sim.log_fwd_drift, dtype=dtype),
        torch.from_numpy(np.array(cont_mean0)), *policy, tdev,
        torch.tensor(float(bnpv), dtype=dtype), BasisSpec(*spec), ctx.interp_kind, GRID, 0,
        ctx.val_date_is_first_step, None, True)
    return got, ref, val.shape[0] - 1


@pytest.fixture(scope="module")
def results():
    return _programs(jnp.float32, torch.float32)


@pytest.fixture(scope="module")
def results64():
    with jax.enable_x64(True):
        return _programs(jnp.float64, torch.float64)


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


def test_float64_program_takes_the_jax_decisions(results64):
    """In float64 no decision flips: every path's PV, the NPV, the deltas and
    the profile agree with the JAX package's to 1e-12 of their scale."""
    got, ref, _m = results64
    assert got.npv.dtype == torch.float64
    assert float(got.npv) == pytest.approx(float(ref.npv), rel=1e-12)
    for name in ("pv_by_sim", "deltas", "profile_means"):
        a, b = _np(getattr(got, name)), _np(getattr(ref, name))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * np.abs(b).max(), err_msg=name)
    for side in ("inject", "withdraw"):
        has = _np(getattr(ref, f"trigger_has_{side}")).astype(bool)
        assert np.array_equal(_np(getattr(got, f"trigger_has_{side}")).astype(bool), has)
        b = _np(getattr(ref, f"trigger_{side}_prices"))[has]
        np.testing.assert_allclose(_np(getattr(got, f"trigger_{side}_prices"))[has], b,
                                   rtol=1e-9, atol=1e-9 * np.abs(b).max())


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


@pytest.mark.parametrize("B", [3, 10, 16])
def test_pack_records_layout_float64(B):
    """The float64 forward kernel's records: table rows padded to the pitch
    its ``forward_sim_f64_row_pitch`` names, the float32 one (12 doubles up
    to B = 11, 20 beyond: whole quads of two double2 reads), then the
    (mu, sd) pairs, pillars and scalars, zero-padded to a multiple of 4, all
    float64."""
    n, G, P, C, F = 3, 7, 4, 3, 3
    g = torch.Generator().manual_seed(B)

    def r(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64)

    tables, mus, sds, pillars, scalars = (r(n, B + 1, G), r(n, B), r(n, B), r(n, P, C),
                                          r(n, 11 + F))
    pitch = 12 if B + 1 <= 12 else 20
    rec = pack_records(tables, mus, sds, pillars, scalars, pitch)
    used = G * pitch + 2 * B + P * C + 11 + F
    assert rec.dtype == torch.float64 and rec.shape == (n, -(-used // 4) * 4)
    rows = rec[:, :G * pitch].reshape(n, G, pitch)
    assert torch.equal(rows[:, :, :B + 1], tables.transpose(1, 2))
    assert not rows[:, :, B + 1:].any()
    assert torch.equal(rec[:, used - 11 - F:used], scalars) and not rec[:, used:].any()


def _read_records(rec, G, B, P, C, F, pitch):
    """The operands the forward kernel reads from its records: the first
    B + 1 elements of each table row, the (mu, sd) pairs, the pillars and
    the scalars, each at its offset."""
    n = rec.shape[0]
    tables = rec[:, :G * pitch].reshape(n, G, pitch)[:, :, :B + 1].transpose(1, 2)
    off = G * pitch
    musd = rec[:, off:off + 2 * B].reshape(n, B, 2)
    off += 2 * B
    pillars = rec[:, off:off + P * C].reshape(n, P, C)
    off += P * C
    scalars = rec[:, off:off + 11 + F]
    return [t.contiguous() for t in (tables, musd[..., 0], musd[..., 1], pillars, scalars)]


@pytest.mark.parametrize("B", [3, 10, 16])
def test_pack_records_float64_read_by_the_plain_version(B):
    """float64 records at the kernel's pitch (rows padded to whole quads),
    read back as the kernel reads them, give the plain version the operands
    they were packed from: its result equals, bit for bit, the one from the
    unpadded rows of B + 1 doubles the float64 kernel read before, and the
    one from the operands themselves."""
    n, G, P, C, F, S = 4, 9, 4, 3, 3, 256
    rng = np.random.default_rng(B)
    spec = BasisSpec(tuple(b % 3 for b in range(B)),
                     tuple(((b // 3) % 2, (b // 6) % 2, b % 2) for b in range(B)))
    pil_inv = np.linspace(0.0, 7000.0, P)
    pillars = np.stack([np.stack([pil_inv, -150.0 - 0.02 * pil_inv, 250.0 - 0.015 * pil_inv],
                                 1)] * n)
    scalars = np.zeros((n, 11 + F))
    scalars[:, 1] = np.linspace(2000.0, 7000.0, n)  # SC_HI
    scalars[:, 2:10] = [1e-4, 0.01, 0.025, 0.01, 0.005, 0.0, 0.99, 0.99]
    scalars[:, 10] = 2.7
    scalars[:, 11:] = rng.uniform(0.0, 0.3, (n, F))
    tables = rng.normal(0.0, 30.0, (n, B + 1, G))
    tables[:, B, :] += np.linspace(0.0, 20_000.0, G)
    ops = [torch.tensor(a, dtype=torch.float64) for a in (
        tables, rng.normal(0.0, 0.3, (n, B)), rng.uniform(0.5, 1.5, (n, B)), pillars, scalars)]
    factors = torch.tensor(rng.normal(0.0, 0.5, (n, F, S)))
    inv0 = torch.full((S,), 1500.0, dtype=torch.float64)

    def run(operands):
        return forward_sim_reference(factors, inv0, *operands, spec, 0, G)

    want = run(ops)
    for pitch in (B + 1, 12 if B + 1 <= 12 else 20):
        read = _read_records(pack_records(*ops, pitch), G, B, P, C, F, pitch)
        assert all(torch.equal(a, b) for a, b in zip(read, ops))
        for a, b in zip(run(read), want):
            assert torch.equal(a, b)
