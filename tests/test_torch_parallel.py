"""The paths mesh of the PyTorch port (``storage_tpu_torch.parallel.mesh``).

Counterparts of ``tests/test_parallel.py``'s cases, the port on a mesh of
``cpu`` entries against the JAX package on ``paths_mesh()`` over the eight
virtual CPU devices of ``tests/conftest.py``, at that file's sizes and
bounds: NPV within 2.5e-4 relative at 512 sims, the deltas' sum within 2% of
their absolute sum, the inventory profile's ends; the ratcheted 3-factor
case's per-period deltas within 5% of the largest rate (mean 1%) and its
profile within 2% of the largest inventory.  The device-count and
Pallas-eligibility cases become the mesh's own shape, placement and
divisibility checks; the interpret-mode Pallas cases run the JAX side as
that file runs it (``STORAGE_TPU_PALLAS=interpret``, weights quantized),
against the port's plain K1 and K2 run per shard with their partials
summed.  Measured: NPV 4.2e-5 / 1.4e-4 off the JAX mesh, 1.7e-4 / 9.0e-5
off its Pallas route.

The port against itself at 1, 2, 3, 4 and 8 shards: every shard's paths,
checkpoints, spans and ``last()`` equal the one-device set's columns bit for
bit (float32 and float64, plain and antithetic; 13 sims a shard at 8
shards, and 39 sims over 3 shards, where an antithetic pair's partners lie
in different shards); in float64 the ratcheted 3-factor valuation's NPV
within 1e-10 relative and its deltas within 1e-8 of max|delta| of the
one-device run, on the materialised and the streamed routes (measured: NPV
within 2.2e-16, deltas within 2.1e-14 of a max|delta| of 69.6); progress
values as on one device.
"""
import os
import sys

import jax
import numpy as np
import pandas as pd
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import storage_tpu as jax_pkg  # noqa: E402
import storage_tpu_torch as torch_pkg  # noqa: E402
from storage_tpu.parallel.mesh import paths_mesh as jax_paths_mesh  # noqa: E402
from storage_tpu_torch.models import simulation as torch_sim  # noqa: E402
from storage_tpu_torch.parallel import mesh as torch_mesh  # noqa: E402
from storage_tpu_torch.parallel.mesh import PathsMesh, paths_mesh  # noqa: E402

torch.set_num_threads(2)

MAX_RATE = 80.0  # the largest ratchet rate of the ratcheted case


def _cpu_mesh(n=8):
    return paths_mesh(["cpu"] * n)


def _port_kw(pkg, **kw):
    return dict(kw, device="cpu") if pkg is torch_pkg else kw


def _valuation(pkg, mesh=None, num_sims=512, **kw):
    """``tests/test_parallel.py::_valuation`` in either package."""
    storage = pkg.CmdtyStorage(
        "D", "2021-01-01", "2021-03-01",
        injection_cost=0.3, withdrawal_cost=0.4,
        min_inventory=0.0, max_inventory=2000.0,
        max_injection_rate=60.0, max_withdrawal_rate=80.0,
    )
    idx = pd.period_range("2021-01-01", "2021-03-01", freq="D")
    fwd = pd.Series(20.0 + 3.0 * np.sin(np.arange(len(idx)) / 8.0), index=idx)
    vol = pd.Series(0.7, index=idx)
    return pkg.multi_factor_value(
        storage, "2021-01-01", 800.0, fwd, None, None,
        factors=[(5.0, vol)], factor_corrs=None,
        num_sims=num_sims, basis_funcs="1 + x0 + x0**2", discount_deltas=False,
        seed=5, mesh=mesh, **_port_kw(pkg, **kw),
    )


def _ratchet_3f_valuation(pkg, mesh=None, num_sims=512, return_sim_panels=True, **kw):
    """``tests/test_parallel.py::_ratchet_3f_valuation`` in either package."""
    storage = pkg.CmdtyStorage(
        "D", "2021-01-01", "2021-04-01",
        injection_cost=0.1, withdrawal_cost=0.2,
        ratchets=[("2021-01-01",
                   [(0.0, -50.0, 70.0), (1000.0, -50.0, 70.0), (2500.0, -80.0, 40.0)])],
        ratchet_interp=pkg.RatchetInterp.LINEAR,
    )
    idx = pd.period_range("2021-01-01", "2021-04-01", freq="D")
    fwd = pd.Series(18.0 + 4.0 * np.cos(np.arange(len(idx)) / 10.0), index=idx)
    return pkg.three_factor_seasonal_value(
        storage, "2021-01-01", 500.0, fwd, 0.03, None,
        spot_mean_reversion=12.0, spot_vol=0.8, long_term_vol=0.2, seasonal_vol=0.4,
        num_sims=num_sims, basis_funcs="1 + s + x_st + x_lt + x_sw + s**2",
        discount_deltas=False, seed=7, mesh=mesh, return_sim_panels=return_sim_panels,
        **_port_kw(pkg, **kw),
    )


def _assert_agrees(multi, single, rel=2.5e-4):
    """``test_single_vs_multi_device_valuation_agrees``'s bounds."""
    assert multi.npv == pytest.approx(single.npv, rel=rel)
    assert float(multi.deltas.sum()) == pytest.approx(
        float(single.deltas.sum()), abs=0.02 * single.deltas.abs().sum())
    assert multi.expected_profile["inventory"].iloc[0] == pytest.approx(
        single.expected_profile["inventory"].iloc[0])
    assert multi.expected_profile["inventory"].iloc[-1] == pytest.approx(
        single.expected_profile["inventory"].iloc[-1], abs=1.0)


def _assert_ratchet_agrees(multi, single, rel=2.5e-4):
    """``test_ratcheted_three_factor_single_vs_multi_device``'s bounds."""
    assert multi.npv == pytest.approx(single.npv, rel=rel)
    diff = (multi.deltas - single.deltas).abs()
    assert float(diff.max()) <= 0.05 * MAX_RATE
    assert float(diff.mean()) <= 0.01 * MAX_RATE
    prof_diff = (multi.expected_profile["inventory"]
                 - single.expected_profile["inventory"]).abs()
    assert float(prof_diff.max()) <= 0.02 * 2500.0


# --------------------------------------------------------------------------- #
# Counterparts of tests/test_parallel.py                                     #
# --------------------------------------------------------------------------- #


def test_mesh_shape_and_devices(monkeypatch):
    """The mesh counts its devices as the JAX package's does (``shape``,
    read by ``valuation.py``), in order; ``paths_mesh()`` takes every CUDA
    card and, with none, raises rather than fall back to the CPU, as does a
    mesh naming a card that is not there."""
    assert jax.device_count() >= 8
    mesh = _cpu_mesh()
    assert mesh.shape == dict(jax_paths_mesh().shape) == {torch_mesh.PATHS_AXIS: 8}
    assert int(np.prod(list(mesh.shape.values()))) == mesh.size == 8
    assert mesh.devices == (torch.device("cpu"),) * 8
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paths_mesh()
    with pytest.raises(RuntimeError, match="no such CUDA device"):
        PathsMesh(["cuda:0", "cuda:0"])


def test_single_vs_multi_device_valuation_agrees():
    """The port on 8 shards against the JAX package on its 8-device mesh."""
    _assert_agrees(_valuation(torch_pkg, mesh=_cpu_mesh()),
                   _valuation(jax_pkg, mesh=jax_paths_mesh()))


def test_single_vs_multi_device_convergence_at_4096():
    """The port on 1 against 8 shards at 4,096 sims, with the bounds of the
    JAX package's case (NPV 5e-5 relative, deltas 1% of the largest rate);
    on the CPU it is fast enough to run with the rest."""
    single = _valuation(torch_pkg, num_sims=4096)
    multi = _valuation(torch_pkg, mesh=_cpu_mesh(), num_sims=4096)
    assert multi.npv == pytest.approx(single.npv, rel=5e-5)
    diff = (multi.deltas - single.deltas).abs()
    assert float(diff.max()) <= 0.01 * MAX_RATE


def test_shard_sims_places_on_all_devices():
    """``shard_sims`` cuts equal contiguous shards, one on each entry;
    ``replicate`` gives each entry a copy, made once per device;
    ``sum_shards`` adds in shard order; ``sims_mean`` is the mean over all."""
    mesh = _cpu_mesh()
    x = torch.arange(16 * 100, dtype=torch.float64).reshape(16, 100)
    shards = torch_mesh.shard_sims(mesh, x, 0)
    assert len(shards) == 8 and all(s.shape == (2, 100) for s in shards)
    assert all(s.device == d for s, d in zip(shards, mesh.devices))
    assert torch.equal(torch.cat(shards), x)
    cols = torch_mesh.shard_sims(mesh, x[:, :96], 1)
    assert [c.shape for c in cols] == [(16, 12)] * 8 and torch.equal(torch.cat(cols, 1), x[:, :96])
    copies = torch_mesh.replicate(mesh, x)
    assert len(copies) == 8 and all(c is x for c in copies)
    assert torch.equal(torch_mesh.sum_shards([x.sum(0) for x in shards]), x.sum(0))
    assert torch_mesh.sims_mean(shards, 0).tolist() == pytest.approx(x.mean(0).tolist())
    assert torch_mesh.sims_mean(shards).item() == pytest.approx(x.mean().item())


def test_ratcheted_three_factor_single_vs_multi_device():
    """The ratcheted 3-factor case: the port on 8 shards against the JAX
    package on its 8-device mesh (measured NPV 1.4e-4, deltas 1.6 / 0.20,
    profile 4.2)."""
    _assert_ratchet_agrees(_ratchet_3f_valuation(torch_pkg, mesh=_cpu_mesh()),
                           _ratchet_3f_valuation(jax_pkg, mesh=jax_paths_mesh()))


def test_num_sims_must_divide_the_mesh():
    """The counterpart of the JAX package's Pallas eligibility under a mesh
    (513 sims do not shard over 8 devices): the mesh's windows are equal and
    contiguous, and a valuation whose sims do not divide evenly raises the
    JAX package's ``ValueError``, its message word for word."""
    assert _cpu_mesh().windows(512) == [(64 * i, 64) for i in range(8)]
    with pytest.raises(ValueError) as jax_err:
        _valuation(jax_pkg, mesh=jax_paths_mesh(), num_sims=513)
    with pytest.raises(ValueError) as port_err:
        _valuation(torch_pkg, mesh=_cpu_mesh(), num_sims=513)
    assert str(port_err.value) == str(jax_err.value)
    assert "divisible by the number of mesh devices (8)" in str(port_err.value)


class TestPallasUnderMesh:
    """The JAX package's Pallas kernels run per shard in interpret mode (with
    the quantized weights they always take) against the port's K1 and K2,
    whose plain versions run per shard on the CPU with their partials added
    over the shards."""

    def test_mesh_pallas_parity_constant_rates(self, monkeypatch):
        """NPV and the deltas' mean held as in the JAX package's case (5e-4,
        2% of the largest rate; measured 1.7e-4 and 0.71).  Its largest
        per-period delta difference (10% of the largest rate) compares two
        quantized routes; the JAX package's own exact route lies 10.7 off its
        Pallas route here (the quantization's effect), so the port, which has
        exact weights, is held to that bound against the exact route on the
        same mesh (measured 1.9)."""
        monkeypatch.setenv("STORAGE_TPU_QUANTIZE_WEIGHTS", "1")
        monkeypatch.setenv("STORAGE_TPU_PALLAS", "interpret")
        pallas = _valuation(jax_pkg, mesh=jax_paths_mesh(), num_sims=512)
        monkeypatch.delenv("STORAGE_TPU_QUANTIZE_WEIGHTS")
        monkeypatch.delenv("STORAGE_TPU_PALLAS")
        exact = _valuation(jax_pkg, mesh=jax_paths_mesh(), num_sims=512)
        port = _valuation(torch_pkg, mesh=_cpu_mesh(), num_sims=512)
        assert port.npv == pytest.approx(pallas.npv, rel=5e-4)
        assert float((port.deltas - pallas.deltas).abs().mean()) <= 0.02 * MAX_RATE
        assert float((port.deltas - exact.deltas).abs().max()) <= 0.10 * MAX_RATE

    def test_mesh_pallas_parity_ratcheted_three_factor(self, monkeypatch):
        """The JAX package's bound (NPV 1e-3; measured 9.0e-5) and finite
        trigger prices, without panels as there."""
        monkeypatch.setenv("STORAGE_TPU_QUANTIZE_WEIGHTS", "1")
        monkeypatch.setenv("STORAGE_TPU_PALLAS", "interpret")
        pallas = _ratchet_3f_valuation(jax_pkg, mesh=jax_paths_mesh(), return_sim_panels=False)
        port = _ratchet_3f_valuation(torch_pkg, mesh=_cpu_mesh(), return_sim_panels=False)
        assert port.npv == pytest.approx(pallas.npv, rel=1e-3)
        assert np.isfinite(port.trigger_prices["inject_trigger_price"]).any()


# --------------------------------------------------------------------------- #
# The port against itself                                                     #
# --------------------------------------------------------------------------- #


def _coeffs(num_factors=3, n=37):
    """Simulation coefficients of ``num_factors`` factors over ``n`` irregular
    steps (past whole 16-step draw blocks)."""
    rng = np.random.default_rng(10 * num_factors + n)
    alphas = np.array([0.0, 2.5, 16.2])[:num_factors]
    corrs = np.array([[1.0, 0.6, 0.3], [0.6, 1.0, 0.4], [0.3, 0.4, 1.0]])[:num_factors,
                                                                         :num_factors]
    times = np.cumsum(rng.uniform(0.5, 3.0, n)) / 365.0
    return torch_sim.sim_coefficients(alphas, rng.uniform(0.1, 0.9, (n, num_factors)), corrs,
                                      times, rng.uniform(10.0, 20.0, n))


SHARDINGS = [(104, 1), (104, 2), (104, 4), (104, 8), (39, 3)]


def _bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "antithetic"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("num_sims,shards", SHARDINGS,
                         ids=[f"{s}x{n}" for s, n in SHARDINGS])
def test_shard_paths_equal_one_device_columns(num_sims, shards, dtype, antithetic):
    """Each shard's paths, checkpoints, spans and ``last()`` equal the same
    columns of the one-device set bit for bit."""
    coeffs, key = _coeffs(), torch_sim.prng_key(21)
    mesh = _cpu_mesh(shards)
    whole = torch_sim.simulate_factor_paths(coeffs, num_sims, key=key, antithetic=antithetic,
                                            device="cpu", dtype=dtype)
    parts = torch_sim.simulate_factor_paths(coeffs, num_sims, key=key, antithetic=antithetic,
                                            device="cpu", dtype=dtype, mesh=mesh)
    assert len(parts) == shards and all(p.dtype == dtype for p in parts)
    assert torch.equal(_bits(torch.cat(parts, dim=2)), _bits(whole))
    one = torch_sim.StreamingFactorSource(coeffs, num_sims, key, antithetic, every=16,
                                          device="cpu", dtype=dtype)
    src = torch_sim.StreamingFactorSource(coeffs, num_sims, key, antithetic, every=16,
                                          device="cpu", dtype=dtype, mesh=mesh)
    assert torch.equal(_bits(torch.cat(src._checkpoints(), dim=2)), _bits(one._checkpoints()))
    for a, b in src.spans():
        got = src.factors(a, b)
        assert len(got) == shards
        assert torch.equal(_bits(torch.cat(got, dim=2)), _bits(whole[a:b]))
    assert torch.equal(_bits(torch.cat(src.last(), dim=1)), _bits(whole[-1]))


def _f64_pair(shards, streamed, monkeypatch):
    """The ratcheted 3-factor case in float64 on one device and on a mesh;
    streamed under a budget below one path set (2 spans of 64 steps)."""
    if streamed:
        monkeypatch.setenv("STORAGE_TPU_MAX_PATH_BYTES", "2e4")
    kw = dict(dtype=torch.float64, return_sim_panels=not streamed)
    return (_ratchet_3f_valuation(torch_pkg, **kw),
            _ratchet_3f_valuation(torch_pkg, mesh=_cpu_mesh(shards), **kw))


@pytest.mark.parametrize("streamed", [False, True], ids=["materialised", "streamed"])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_mesh_valuation_float64_matches_one_device(shards, streamed, monkeypatch):
    """In float64 the sharded run agrees with the one-device run to the
    rounding of its sums' order: NPV within 1e-10 relative, deltas within
    1e-8 of max|delta|, the profile likewise, intrinsic equal, and the
    per-sim panels (materialised) within 1e-10 of each frame's largest
    value."""
    one, multi = _f64_pair(shards, streamed, monkeypatch)
    assert multi.npv == pytest.approx(one.npv, rel=1e-10)
    scale = float(one.deltas.abs().max())
    assert float((multi.deltas - one.deltas).abs().max()) <= 1e-8 * scale
    prof = one.expected_profile.to_numpy()
    np.testing.assert_allclose(multi.expected_profile.to_numpy(), prof, rtol=0,
                               atol=1e-8 * np.abs(prof).max())
    assert multi.intrinsic_npv == one.intrinsic_npv
    if not streamed:
        for name in ("sim_pv", "sim_inventory", "sim_spot_regress", "sim_spot_valuation"):
            a, b = getattr(multi, name).to_numpy(), getattr(one, name).to_numpy()
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-10 * np.abs(b).max())


def test_mesh_progress_and_launches_as_one_device(monkeypatch):
    """With progress and cancellation hooks the sharded run reports the
    one-device run's progress values, and its NPV; a cancel raises."""
    def run(mesh):
        progress = []
        res = _valuation(torch_pkg, mesh=mesh, num_sims=256, return_sim_panels=False,
                         on_progress_update=progress.append, cancelled=lambda: False)
        return res, progress

    one, p_one = run(None)
    multi, p_multi = run(_cpu_mesh(4))
    assert p_multi == p_one and p_one[-1] == 1.0 and len(p_one) > 20
    assert multi.npv == pytest.approx(one.npv, rel=2.5e-4)
    with pytest.raises(torch_pkg.ValuationCancelledError):
        _valuation(torch_pkg, mesh=_cpu_mesh(4), num_sims=256, return_sim_panels=False,
                   cancelled=lambda: True)
