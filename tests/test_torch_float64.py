"""float64 in the port, against the JAX package under ``jax.enable_x64``.

The port runs on ``device="cpu"`` (the kernels' plain versions), the JAX
package on its XLA route, both on the CPU, from the same seeds.

- Draws: the 64-bit words (both hash words) and the float64 uniforms equal
  JAX's bit for bit.  The float64 normals go through the same expansions
  (XLA's ``erf_inv`` and ``log1p``) rounded as XLA's CPU code rounds them:
  each polynomial step one fused multiply-add (the port's ``_fma``, exact
  in separately rounded torch ops; the CUDA path kernel takes the card's
  DFMA, so kernel and plain version still agree bit for bit), every other
  step on its own.  Measured on 196,752 draws at seeds 12 and 13: 11 and 6
  draws differ, by at most 2 ulp, all on ``log1p``'s ``log(1 + x)`` branch
  or through the outer ranges' square root; given JAX's own ``log`` and a
  correctly rounded ``sqrt`` (torch's float64 ``log`` and ``sqrt`` on the
  CPU are not correctly rounded on every argument), every draw is equal.
  (Before the draws fused their steps: 92.6% equal, 3 ulp.)
- Factor paths: XLA fuses the OU update of two and more factors as
  ``inc = c0 z0``, ``inc = fma(c_g, z_g, inc)``, ``y = fma(decay, y, inc)``,
  which the port computes, so a path equals JAX's bit for bit until its sim
  meets a draw that differs.  Those elements, and every element of one
  factor (XLA fuses the one-factor update differently by the step's place
  in its scan), are held to ``PATH_EPS`` x eps x the magnitude that flowed
  into the element (``decay |m_prev| + sum |chol| |z|``, accumulated over
  the steps): an element near zero is held to the size of its own inputs,
  not to the largest state's, in one launch, from checkpoints and in
  spans, in both antithetic modes (measured 1.62, at one factor; 2.55
  before the fusion, with the bound at 3).  A bound in ulp of each element
  cannot hold: where a path crosses zero, one rounding of its inputs is
  many ulp of the result.
- The slice in float64 at 2,048 paths (the headline case cut to
  2021-07-01): NPV within 1e-9 relative, deltas within 1e-6 of max|delta|,
  intrinsic within 1e-12 (measured: equal, 1.5e-16, equal).  Float32 held
  the deltas only to 1e-2 of max|delta| at this size
  (``test_torch_slice.py``): with the float32 regressions' accumulation
  order gone, they agree, so that bound was float32 noise.  Streamed, both
  packages take the same span count (the budget counts 8-byte elements).
- ``intrinsic_value`` in float64 (linear and cubic) within 1e-12; the hourly
  365-day intrinsic (``test_torch_hourly.py``'s case), where the two float32
  DPs part by 1.9e-5: the float64 DPs agree, and the port's float32 value
  lies nearer them than the JAX package's.
- ``fit_policy`` / ``reprice`` in float64, and float64 policy files written by
  either package loading in the other.
- ``tests/test_float64_mode.py``'s two cases as pair tests.
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
import storage_tpu.engines.lsmc as jl  # noqa: E402
import storage_tpu_torch as torch_pkg  # noqa: E402
import storage_tpu_torch.engines.lsmc as tl  # noqa: E402
from chip_smoke import BASIS, build_case  # noqa: E402
from storage_tpu.compile import build_valuation_context  # noqa: E402
from storage_tpu.models import simulation as jax_sim  # noqa: E402
from storage_tpu.models.multi_factor import build_sim_coefficients, create_3_factor_season_params  # noqa: E402
from storage_tpu.ops.regression import basis_spec  # noqa: E402
from storage_tpu.utils.basis import THREE_FACTOR_SEASONAL_ALIASES, as_monomials  # noqa: E402
from storage_tpu_torch import valuation as torch_valuation  # noqa: E402
from storage_tpu_torch.interop import context_from_numpy, lsmc_policy_from_numpy  # noqa: E402
from storage_tpu_torch.models import simulation as torch_sim  # noqa: E402
from storage_tpu_torch.ops.regression import BasisSpec  # noqa: E402
from test_torch_intrinsic import _small_case  # noqa: E402
from test_torch_simulation import NORMAL_SHAPE, factor_case  # noqa: E402

torch.set_num_threads(2)

EPS = np.finfo(np.float64).eps
NORMAL_ULPS, PATH_EPS = 2, 2
NORMAL_EQUAL = 0.999  # share of draws equal to JAX's, bit for bit
SIMS, GRID = 2048, 40
NPV_RTOL, DELTA_TOL, INTRINSIC_RTOL = 1e-9, 1e-6, 1e-12
FIELDS = ("coeffs", "mus", "sds", "vbars", "cont_mean0", "backward_npv")


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_log():
    """torch's CPU log is not bit-stable on its first multithreaded call in a
    process (one thread's chunk can come out less accurate): call it once
    before any test reads its bits."""
    torch.log(torch.linspace(0.5, 2.0, 1 << 18, dtype=torch.float64))


def _ulps(a, b):
    return np.abs(a.view(np.int64) - b.view(np.int64))


def _key(seed):
    key = torch_sim.fold_in(torch_sim.prng_key(seed), 1)
    return key, jnp.asarray(np.array(key, dtype=np.uint32))


def _xla(fn):
    """The JAX function ``fn`` (``jnp.log``, ``jnp.sqrt``) as a torch one."""
    return lambda t: torch.from_numpy(np.array(fn(jnp.asarray(t.numpy()))))


def _path_magnitudes(coeffs, num_sims, key, antithetic):
    """``[n, F, S]``: the magnitude that flowed into each path element,
    ``m_k = decay_k m_{k-1} + |chol_k| |z_k|`` from ``m = 0``, on the port's
    float64 normals: the scale of the rounding errors the element carries."""
    n, num_factors = coeffs.decay.shape
    z = np.concatenate([
        torch_sim._block_normals(key, b0, num_factors, num_sims, antithetic, "cpu",
                                 torch.float64).numpy() for b0 in range(0, n, 16)])[:n]
    out, m = np.empty((n, num_factors, num_sims)), np.zeros((num_factors, num_sims))
    for k in range(n):
        m = coeffs.decay[k][:, None] * m + np.abs(coeffs.chol[k]) @ np.abs(z[k])
        out[k] = m
    return out


def _draws_differ(n, num_factors, num_sims, key, jkey, antithetic):
    """``[n, F, S]`` bool: whether the element's sim has met, at this step
    or before, a draw of the port that differs from JAX's."""
    differ = []
    for b0 in range(0, n, 16):
        with jax.enable_x64(True):
            want = np.asarray(jax_sim._block_normals(jkey, b0, num_factors, num_sims, antithetic,
                                                     jnp.float64))
        got = torch_sim._block_normals(key, b0, num_factors, num_sims, antithetic, "cpu",
                                       torch.float64).numpy()
        differ.append((got != want).any(axis=1))
    met = np.logical_or.accumulate(np.concatenate(differ)[:n], axis=0)
    return np.broadcast_to(met[:, None, :], (n, num_factors, num_sims))


def _assert_paths_close(got, expected, magnitudes, exact=None):
    """Every element of ``exact`` equal bit for bit, the others within
    PATH_EPS x eps of their magnitude (see the module docstring)."""
    assert got.shape == expected.shape == magnitudes.shape and got.dtype == np.float64
    if exact is not None:
        assert exact.mean() > 0.75  # most elements: the check is not vacuous
        np.testing.assert_array_equal(got[exact], expected[exact])
    err = np.abs(got - expected) / (EPS * np.where(magnitudes > 0, magnitudes, 1.0))
    assert err.max() <= PATH_EPS and (got[magnitudes == 0] == expected[magnitudes == 0]).all()


def _exact(n, num_factors, num_sims, key, jkey, antithetic):
    """The path elements that must equal JAX's bit for bit: those whose sim
    met no differing draw, for two and more factors (the module docstring)."""
    if num_factors == 1:
        return None
    return ~_draws_differ(n, num_factors, num_sims, key, jkey, antithetic)


# --------------------------------------------------------------------------- #
# Draws                                                                       #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", [12, 13])
def test_bits_and_uniforms_float64_bit_exact(seed):
    key, jkey = _key(seed)
    with jax.enable_x64(True):
        bits = np.asarray(jax.random.bits(jkey, NORMAL_SHAPE, jnp.uint64))
        lo = float(np.nextafter(-1.0, 0.0))
        uniform = np.asarray(jax.random.uniform(jkey, NORMAL_SHAPE, jnp.float64, lo, 1.0))
    words = torch_sim._hash_words(key, NORMAL_SHAPE, "cpu")
    got = (words[0] << 32) | words[1]  # a 64-bit word in two's complement
    np.testing.assert_array_equal(got.numpy().view(np.uint64), bits)
    np.testing.assert_array_equal(torch_sim.uniform_from_words64(*words, lo, 1.0).numpy(),
                                  uniform)


@pytest.mark.parametrize("seed", [12, 13])
def test_normals_float64_within_3_ulp(seed):
    """The normals fuse their polynomial steps as XLA does: at least
    NORMAL_EQUAL of them equal JAX's, the rest within NORMAL_ULPS (measured:
    11 and 6 of 196,752 differ, by 2 ulp at most), each of those through
    torch's ``log`` or ``sqrt`` (``log1p``'s log branch, or an outer range)."""
    key, jkey = _key(seed)
    with jax.enable_x64(True):
        expected = np.asarray(jax.random.normal(jkey, NORMAL_SHAPE, jnp.float64))
    got = torch_sim.normal(key, NORMAL_SHAPE, "cpu", torch.float64).numpy()
    assert got.dtype == np.float64
    ulps = _ulps(got, expected)
    assert ulps.max() <= NORMAL_ULPS
    assert (ulps == 0).mean() >= NORMAL_EQUAL
    lo = float(np.nextafter(-1.0, 0.0))
    u = torch_sim.uniform_from_words64(*torch_sim._hash_words(key, NORMAL_SHAPE, "cpu"), lo,
                                       1.0).numpy()
    assert (u[ulps > 0] ** 2 >= torch_sim._LOG1P_SMALL).all()


@pytest.mark.parametrize("seed", [12, 13])
def test_normals_float64_equal_given_xla_log_and_sqrt(seed):
    """Given JAX's ``log`` and a correctly rounded ``sqrt`` on the same
    arguments (torch's on the CPU are not correctly rounded on every one),
    every draw of the plain version equals JAX's, bit for bit."""
    key, jkey = _key(seed)
    lo = float(np.nextafter(-1.0, 0.0))
    u = torch_sim.uniform_from_words64(*torch_sim._hash_words(key, NORMAL_SHAPE, "cpu"), lo, 1.0)
    with jax.enable_x64(True):
        expected = np.asarray(jax.random.normal(jkey, NORMAL_SHAPE, jnp.float64))
        got = torch_sim._erf_inv_f64(u, _xla(jnp.log), _xla(jnp.sqrt)) * float(np.sqrt(2))
    np.testing.assert_array_equal(got.numpy(), expected)


def test_erf_inv_float64_covers_its_three_ranges():
    """XLA's float64 erf_inv at points of all three ranges of w = -log1p(-x^2)
    (below 6.25, below 16, beyond) and both branches of log1p: within
    NORMAL_ULPS, and equal to JAX's on 99% (two thirds of the points lie in
    the outer ranges, through torch's ``log`` and ``sqrt``; measured 99.49%),
    and on every point given JAX's ``log`` and ``sqrt``."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(-1, 1, 20000), 1 - 10.0 ** -rng.uniform(1, 16, 20000),
                        -1 + 10.0 ** -rng.uniform(1, 16, 20000)])
    w = -np.log1p(-x * x)
    assert (w < 6.25).any() and ((w >= 6.25) & (w < 16)).any() and (w >= 16).any()
    with jax.enable_x64(True):
        expected = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
        given = torch_sim._erf_inv_f64(torch.from_numpy(x), _xla(jnp.log), _xla(jnp.sqrt))
    got = torch_sim._erf_inv_f64(torch.from_numpy(x)).numpy()
    ulps = _ulps(got, expected)
    assert ulps.max() <= NORMAL_ULPS and (ulps == 0).mean() >= 0.99
    np.testing.assert_array_equal(given.numpy(), expected)
    with pytest.raises(ValueError, match="float16"):
        torch_sim.normal((0, 1), (4,), "cpu", torch.float16)


def test_log1p_inner_sum_is_xla_form():
    """Which products of ``log1p``'s rational branch XLA fuses, settled on
    4,000,000 arguments of ``(-(sqrt(2) - 1), 0]`` (half uniform, half
    log-uniform down to 1e-12): the plain version (Horner steps fused, the
    inner sum ``-0.5 x^2 + x^3 P / Q`` rounded on its own, the same as
    ``fma(-0.5, x^2, x^3 P / Q)``) equals XLA's ``log1p`` on every one;
    ``fma(x^3, P / Q, -0.5 x^2)`` does not (measured 0.59% apart, 1 ulp)."""
    rng = np.random.default_rng(5)
    half = 2_000_000
    x = np.concatenate([-rng.uniform(0, torch_sim._LOG1P_SMALL, half),
                        -10.0 ** -rng.uniform(0.383, 12, half)])
    x = x[np.abs(x) < torch_sim._LOG1P_SMALL]
    with jax.enable_x64(True):
        want = np.asarray(jax.jit(jnp.log1p)(jnp.asarray(x)))
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(torch_sim._xla_log1p(t).numpy(), want)

    def horner(coefs):
        p = torch.zeros_like(t)
        for c in coefs:
            p = torch_sim._fma(p, t, torch.full_like(t, c))
        return p

    x2 = t * t
    other = t + torch_sim._fma(t * x2, horner(torch_sim._LOG1P_P) / horner(torch_sim._LOG1P_Q),
                               -0.5 * x2)
    assert (other.numpy() != want).mean() > 1e-3


@pytest.mark.parametrize("num_factors", [1, 2, 3])
def test_ou_update_fuses_as_xla_does(num_factors):
    """Each step of JAX's float64 paths from JAX's previous state and JAX's
    draws: with two and more factors XLA computes ``inc = c0 z0``,
    ``inc = fma(c_g, z_g, inc)``, ``y = fma(decay, y, inc)`` (the port's
    form) at every step; with one factor it fuses by the step's place in
    its scan of 16-step blocks, ``fma(c0, z0, decay y)`` inside a block and
    the port's form at a block's first step (the unrolled tail of 5 steps
    mixes both), so one-factor paths are held only to PATH_EPS."""
    n, num_sims = 37, 1023
    key, jkey = _key(12)
    jc = factor_case(jax_sim, num_factors, n)
    with jax.enable_x64(True):
        paths = np.array(jax_sim.simulate_factor_paths(jc, num_sims, None, False, jnp.float64,
                                                       key=jkey))
        z = np.concatenate([np.asarray(jax_sim._block_normals(jkey, b0, num_factors, num_sims,
                                                              False, jnp.float64))
                            for b0 in range(0, n, 16)])[:n]
    decay, chol = torch.as_tensor(jc.decay), torch.as_tensor(jc.chol)
    z, paths = torch.from_numpy(z), torch.from_numpy(paths)
    for k in range(1, 32):  # the scan's two whole blocks
        y = paths[k - 1]
        inc = chol[k, :, 0, None] * z[k, 0]
        for g in range(1, num_factors):
            inc = torch_sim._fma(chol[k, :, g, None], z[k, g], inc)
        port = torch_sim._fma(decay[k, :, None], y, inc)
        if num_factors > 1 or k % 16 == 0:
            assert torch.equal(port, paths[k]), k
        else:
            inside = torch_sim._fma(chol[k, :, 0, None], z[k, 0], decay[k, :, None] * y)
            assert torch.equal(inside, paths[k]) and not torch.equal(port, paths[k]), k


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "antithetic"])
@pytest.mark.parametrize("num_factors", [1, 2, 3])
def test_factor_paths_float64_match_jax(num_factors, antithetic):
    n, num_sims = 37, 1023
    key, jkey = _key(12)
    jc, tc = factor_case(jax_sim, num_factors, n), factor_case(torch_sim, num_factors, n)
    with jax.enable_x64(True):
        expected = np.asarray(jax_sim.simulate_factor_paths(jc, num_sims, None, antithetic,
                                                            jnp.float64, key=jkey))
    got = torch_sim.simulate_factor_paths(tc, num_sims, antithetic=antithetic, key=key,
                                          device="cpu", dtype=torch.float64).numpy()
    _assert_paths_close(got, expected, _path_magnitudes(tc, num_sims, key, antithetic),
                        _exact(n, num_factors, num_sims, key, jkey, antithetic))


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "antithetic"])
def test_streamed_factor_paths_float64_match_jax(antithetic):
    """Checkpoints and spans of both packages' streaming sources, and the
    port's spans against its own one-pass paths (bit for bit)."""
    n, num_sims, every = 103, 64, 32
    key, jkey = _key(42)
    jc, tc = factor_case(jax_sim, 3, n), factor_case(torch_sim, 3, n)
    src = torch_sim.StreamingFactorSource(tc, num_sims, key, antithetic, every=every,
                                          device="cpu", dtype=torch.float64)
    mono = torch_sim.simulate_factor_paths(tc, num_sims, antithetic=antithetic, key=key,
                                           device="cpu", dtype=torch.float64).numpy()
    with jax.enable_x64(True):
        jsrc = jax_sim.StreamingFactorSource(jc, num_sims, jkey, antithetic, jnp.float64,
                                             every=every)
        spans = [(np.asarray(jsrc.factors(a, b)), a, b) for a, b in jsrc.spans()]
        jckpt = np.asarray(jsrc._checkpoints())
    mags = _path_magnitudes(tc, num_sims, key, antithetic)
    exact = _exact(n, 3, num_sims, key, jkey, antithetic)
    assert src.spans() == [(a, b) for _, a, b in spans]
    entering = np.concatenate([np.zeros_like(mags[:1]), mags[every - 1::every]])
    exact_entering = np.concatenate([np.ones_like(exact[:1]), exact[every - 1::every]])
    _assert_paths_close(src._checkpoints().numpy(), jckpt, entering[:len(jckpt)],
                        exact_entering[:len(jckpt)])
    for expected, a, b in spans:
        got = src.factors(a, b).numpy()
        np.testing.assert_array_equal(got, mono[a:b])
        _assert_paths_close(got, expected, mags[a:b], exact[a:b])
    np.testing.assert_array_equal(src.last().numpy(), mono[-1])


def test_spot_sim_float64_matches_jax():
    """``MultiFactorSpotSim`` with ``dtype``: the same float64 spots."""
    idx = pd.period_range("2021-01-01", periods=40, freq="D")
    fwd = pd.Series(np.linspace(20.0, 24.0, 40), index=idx)

    def sim(pkg, dtype, **kw):
        factors, corrs = pkg.create_3_factor_season_params("D", 16.2, 1.15, 0.14, 0.18,
                                                           "2020-12-31", idx[-1])
        return pkg.MultiFactorSpotSim("D", factors, corrs, "2020-12-31", fwd, list(idx),
                                      seed=7, dtype=dtype, **kw).simulate(1000)

    with jax.enable_x64(True):
        expected = sim(jax_pkg, jnp.float64).to_numpy()
    got = sim(torch_pkg, torch.float64, device="cpu").to_numpy()
    np.testing.assert_allclose(got, expected, rtol=64 * EPS)


# --------------------------------------------------------------------------- #
# The slice                                                                   #
# --------------------------------------------------------------------------- #


def _value(pkg, sims=SIMS, **kw):
    storage, fwd, ir, rule = build_case(pkg, storage_end="2021-07-01")
    return pkg.three_factor_seasonal_value(
        cmdty_storage=storage, val_date="2021-04-25", inventory=1500.0, fwd_curve=fwd,
        interest_rates=ir, settlement_rule=rule, num_sims=sims, seed=12,
        spot_mean_reversion=91.0, spot_vol=0.85, long_term_vol=0.30, seasonal_vol=0.19,
        basis_funcs=BASIS, discount_deltas=True, num_inventory_grid_points=GRID,
        return_sim_panels=False, **kw)


def _pair(**kw):
    with jax.enable_x64(True):
        ref = _value(jax_pkg, dtype=jnp.float64, **kw)
    return _value(torch_pkg, dtype=torch.float64, device="cpu", **kw), ref


def _assert_slice_match(got, ref):
    assert got.npv == pytest.approx(ref.npv, rel=NPV_RTOL)
    assert got.intrinsic_npv == pytest.approx(ref.intrinsic_npv, rel=INTRINSIC_RTOL)
    a, b = got.deltas.to_numpy(), ref.deltas.to_numpy()
    np.testing.assert_allclose(a, b, rtol=0, atol=DELTA_TOL * np.abs(b).max())
    np.testing.assert_allclose(got.expected_profile.to_numpy(), ref.expected_profile.to_numpy(),
                               rtol=1e-9, atol=1e-9 * np.abs(ref.expected_profile.to_numpy()).max())


@pytest.fixture(scope="module")
def slice_pair():
    return _pair()


def test_slice_float64_matches_jax(slice_pair):
    got, ref = slice_pair
    _assert_slice_match(got, ref)
    assert got.npv > got.intrinsic_npv


def test_float64_deltas_settle_the_float32_bound(slice_pair):
    """``test_torch_slice.py`` holds the float32 deltas to 1e-2 of
    max|delta| (measured 1.1e-2 at 2,048 paths, 2.0e-3 at 8,192; ROADMAP
    Queue 3).  In float64 the same case's deltas agree to 1e-6 (measured
    1.5e-16): the float32 gap was accumulation-order noise of
    ill-conditioned float32 regressions, not a fault of the port."""
    got, ref = slice_pair
    a, b = got.deltas.to_numpy(), ref.deltas.to_numpy()
    assert np.abs(a - b).max() <= DELTA_TOL * np.abs(b).max()
    f32 = _value(torch_pkg, device="cpu")
    with jax.enable_x64(False):
        f32_ref = _value(jax_pkg)
    gap32 = np.abs(f32.deltas.to_numpy() - f32_ref.deltas.to_numpy()).max() / np.abs(b).max()
    assert gap32 > 1e3 * np.abs(a - b).max() / np.abs(b).max()


def test_streamed_slice_float64_takes_jax_span_count(monkeypatch):
    """A path budget below the float64 path set (66 x 3 x 2,048 x 8 B =
    3.2 MB) streams both packages, with the span length reckoned from
    8-byte elements: the same spans, the same NPV."""
    spans = {}

    def recording(cls, name):
        class Recording(cls):
            def prepare(self):
                spans.setdefault(name, []).append(self.spans())
                return super().prepare()
        return Recording

    monkeypatch.setenv("STORAGE_TPU_MAX_PATH_BYTES", "1e6")
    monkeypatch.setattr(jax_sim, "StreamingFactorSource",
                        recording(jax_sim.StreamingFactorSource, "jax"))
    monkeypatch.setattr(torch_valuation, "StreamingFactorSource",
                        recording(torch_sim.StreamingFactorSource, "port"))
    got, ref = _pair()
    assert len(spans["port"]) == len(spans["jax"]) == 2
    assert spans["port"] == spans["jax"] and len(spans["port"][0]) > 1
    _assert_slice_match(got, ref)


# --------------------------------------------------------------------------- #
# Intrinsic                                                                   #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("interpolation", ["linear", "cubic"])
def test_intrinsic_value_float64_matches_jax(interpolation):
    (storage, fwd), (jstorage, _) = _small_case(torch_pkg), _small_case(jax_pkg)
    with jax.enable_x64(True):
        ref = jax_pkg.intrinsic_value(jstorage, "2021-01-01", 800.0, fwd, 0.02, None,
                                      num_inventory_grid_points=50, dtype=jnp.float64,
                                      interpolation=interpolation)
    got = torch_pkg.intrinsic_value(storage, "2021-01-01", 800.0, fwd, 0.02, None,
                                    num_inventory_grid_points=50, dtype=torch.float64,
                                    interpolation=interpolation, device="cpu")
    assert got.npv == pytest.approx(ref.npv, rel=INTRINSIC_RTOL)
    np.testing.assert_allclose(got.profile.to_numpy(), ref.profile.to_numpy(), rtol=1e-12,
                               atol=1e-12 * np.abs(ref.profile.to_numpy()).max())


def test_hourly_365_day_intrinsic_float64_settles_the_near_tie():
    """``test_torch_hourly.py``'s 365-day case: the two float32 DPs part by
    1.9e-5 (66,303.53 against 66,302.27; ROADMAP Queue 3).  The float64 DPs
    of both packages agree (measured 4.4e-16, 66,304.146) and the port's
    float32 value is the nearer to them (-9.3e-6 against -2.8e-5)."""
    values = {}
    for pkg, f64, kw in ((jax_pkg, jnp.float64, {}), (torch_pkg, torch.float64, {"device": "cpu"})):
        end = (pd.Period("2021-01-01", freq="D") + 365).strftime("%Y-%m-%d")
        storage = pkg.CmdtyStorage(
            freq="h", storage_start="2021-01-01", storage_end=end, injection_cost=0.01,
            withdrawal_cost=0.025,
            ratchets=[("2021-01-01", [(0.0, -150.0 / 24, 250.0 / 24),
                                      (2000.0, -200.0 / 24, 175.0 / 24),
                                      (5000.0, -260.0 / 24, 155.0 / 24),
                                      (7000.0, -275.0 / 24, 132.0 / 24)])],
            ratchet_interp=pkg.RatchetInterp.LINEAR)
        idx = pd.period_range("2021-01-01", end, freq="h")
        i = np.arange(len(idx))
        fwd = pd.Series(16.0 + 2.0 * np.sin(2 * np.pi * i / 8760.0)
                        + 0.8 * np.sin(2 * np.pi * i / 24.0), index=idx)
        args = (storage, "2021-01-01", 1500.0, fwd, 0.01, None)
        values[pkg, 32] = pkg.intrinsic_value(*args, **kw).npv
        with jax.enable_x64(pkg is jax_pkg):
            values[pkg, 64] = pkg.intrinsic_value(*args, dtype=f64, **kw).npv
    exact = values[jax_pkg, 64]
    assert values[torch_pkg, 64] == pytest.approx(exact, rel=INTRINSIC_RTOL)
    port_gap = abs(values[torch_pkg, 32] / exact - 1)
    jax_gap = abs(values[jax_pkg, 32] / exact - 1)
    assert port_gap < jax_gap < 1e-4


# --------------------------------------------------------------------------- #
# Policies                                                                    #
# --------------------------------------------------------------------------- #


class PolicyCase:
    """``test_torch_policy.py``'s case in float64: the headline case cut to
    2021-07-01, both packages on the JAX package's float64 paths."""

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
        self.vols, self.drift = self.sim.vols, self.sim.log_fwd_drift
        with jax.enable_x64(True):
            key = jax.random.PRNGKey(12)
            self.reg = np.asarray(jax_sim.simulate_factor_paths(self.sim, SIMS, None, False,
                                                                jnp.float64, key=key))
            self.val = np.asarray(jax_sim.simulate_factor_paths(
                self.sim, SIMS, None, False, jnp.float64, key=jax.random.fold_in(key, 1)))
            self.jax_policy = jl.fit_policy(self.ctx, self.reg, self.vols, self.drift,
                                            self.spec, dtype=jnp.float64)
            self.jax_repriced = jl.reprice(self.ctx, self.jax_policy, self.val, self.vols,
                                           self.drift, self.spec, discount_deltas=True,
                                           dtype=jnp.float64)
        self.policy = tl.fit_policy(self.tctx, self.reg, self.vols, self.drift, self.tspec,
                                    device="cpu", dtype=torch.float64)
        self.repriced = self.reprice(self.policy)

    def reprice(self, policy):
        return tl.reprice(self.tctx, policy, self.val, self.vols, self.drift, self.tspec,
                          discount_deltas=True, device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def policy_case():
    return PolicyCase()


def test_fit_policy_and_reprice_float64_match_jax(policy_case):
    case = policy_case
    for name in FIELDS:
        got, ref = getattr(case.policy, name), np.asarray(getattr(case.jax_policy, name))
        assert got.dtype == torch.float64 and ref.dtype == np.float64, name
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9,
                                   atol=1e-9 * max(np.abs(ref).max(), 1.0), err_msg=name)
    assert float(case.repriced.npv) == pytest.approx(float(case.jax_repriced.npv), rel=NPV_RTOL)
    want = np.asarray(case.jax_repriced.deltas)
    np.testing.assert_allclose(case.repriced.deltas.numpy(), want, rtol=0,
                               atol=DELTA_TOL * np.abs(want).max())


def test_float64_policy_files_load_in_either_package(policy_case, tmp_path):
    case = policy_case
    port_path, jax_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    case.policy.save(port_path)
    case.jax_policy.save(jax_path)
    with jax.enable_x64(True):
        in_jax = jl.LsmcPolicy.load(port_path, jnp.float64)
        repriced = jl.reprice(case.ctx, in_jax, case.val, case.vols, case.drift, case.spec,
                              discount_deltas=True, dtype=jnp.float64)
    in_port = lsmc_policy_from_numpy(jax_path, device="cpu", dtype=torch.float64)
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(in_jax, name)),
                                      getattr(case.policy, name).numpy(), err_msg=name)
        assert getattr(in_port, name).dtype == torch.float64
        np.testing.assert_array_equal(getattr(in_port, name).numpy(),
                                      np.asarray(getattr(case.jax_policy, name)), err_msg=name)
    assert float(repriced.npv) == pytest.approx(float(case.repriced.npv), rel=NPV_RTOL)
    assert torch.equal(case.reprice(tl.LsmcPolicy.load(port_path, device="cpu",
                                                       dtype=torch.float64)).pv_by_sim,
                       case.repriced.pv_by_sim)


# --------------------------------------------------------------------------- #
# tests/test_float64_mode.py as pair tests                                    #
# --------------------------------------------------------------------------- #


def _mode_case(pkg):
    storage = pkg.CmdtyStorage(
        "D", "2021-01-01", "2021-02-01",
        injection_cost=0.3, withdrawal_cost=0.4,
        min_inventory=0.0, max_inventory=500.0,
        max_injection_rate=50.0, max_withdrawal_rate=50.0,
    )
    idx = pd.period_range("2021-01-01", "2021-02-01", freq="D")
    fwd = pd.Series(20.0 + 3.0 * np.sin(np.arange(len(idx)) / 4.0), index=idx)
    vol = pd.Series(0.6, index=idx)
    return storage, fwd, vol


def test_intrinsic_float64_matches_float32_pair():
    values = {}
    for pkg, f64, kw in ((jax_pkg, jnp.float64, {}), (torch_pkg, torch.float64, {"device": "cpu"})):
        storage, fwd, _ = _mode_case(pkg)
        values[pkg, 32] = pkg.intrinsic_value(storage, "2021-01-01", 100.0, fwd, None, None,
                                              **kw).npv
        with jax.enable_x64(pkg is jax_pkg):
            values[pkg, 64] = pkg.intrinsic_value(storage, "2021-01-01", 100.0, fwd, None, None,
                                                  dtype=f64, **kw).npv
    for pkg in (jax_pkg, torch_pkg):
        assert values[pkg, 64] == pytest.approx(values[pkg, 32], rel=1e-4)
    assert values[torch_pkg, 64] == pytest.approx(values[jax_pkg, 64], rel=INTRINSIC_RTOL)


def test_lsmc_float64_runs_and_matches_pair():
    def run(pkg, dtype, **kw):
        storage, fwd, vol = _mode_case(pkg)
        return pkg.multi_factor_value(
            storage, "2021-01-01", 100.0, fwd, None, None,
            factors=[(3.0, vol)], factor_corrs=None,
            num_sims=512, basis_funcs="1 + x0 + x0**2", discount_deltas=False,
            seed=4, dtype=dtype, return_sim_panels=False, **kw)

    f32 = run(torch_pkg, torch.float32, device="cpu")
    f64 = run(torch_pkg, torch.float64, device="cpu")
    with jax.enable_x64(True):
        ref = run(jax_pkg, jnp.float64)
    # float64 normals consume other random bits than float32 ones: the two
    # dtypes agree to Monte-Carlo error at 512 sims; the packages in float64
    # to rounding.
    assert np.isfinite(f64.npv)
    assert f64.npv == pytest.approx(f32.npv, rel=0.03)
    assert f64.npv == pytest.approx(ref.npv, rel=NPV_RTOL)


def test_kernels_refuse_other_dtypes_by_name():
    """Each kernel has a float32 and a float64 instantiation; its wrapper
    refuses any other dtype by name before it looks at the device."""
    from storage_tpu_torch.ops.backward import _backward_update_cuda
    from storage_tpu_torch.ops.csrc import check_dtype
    from storage_tpu_torch.ops.forward import _forward_sim_cuda

    F, S, G, D, B, n, P = 3, 256, 8, 3, 2, 4, 2
    spec = BasisSpec((0, 1), ((0, 0, 0), (0, 0, 0)))

    def z(*shape, dtype=torch.float16):
        return torch.zeros(shape, dtype=dtype)

    with pytest.raises(ValueError, match="torch.float16"):
        _backward_update_cuda(z(F, S), z(F, S), z(G, S), z(D, G, B + 2), z(G), z(2, B),
                              z(D, G, dtype=torch.int32), z(D, G), z(2, 1 + F), spec)
    with pytest.raises(ValueError, match="torch.bfloat16"):
        _forward_sim_cuda(z(n, F, S, dtype=torch.bfloat16), z(S), z(n, B + 1, G), z(n, B),
                          z(n, B), z(n, P, 3), z(n, 11 + F), spec, 0, G)
    with pytest.raises(ValueError, match="torch.float16"):
        check_dtype("path_sim", torch.float16)
    for ok in (torch.float32, torch.float64):
        check_dtype("path_sim", ok)
