"""Path simulator of the PyTorch port against the JAX package.

The port reproduces ``jax.random``'s threefry2x32 generator with integer
tensor ops: keys, ``fold_in`` and the random bits must be bit-exact, the
uniforms too.  Normals go through XLA's float32 ``erf_inv`` polynomial,
rounded as XLA's CPU code rounds it: each Horner step one FMA, XLA's own
``log1p`` (its upper branch XLA's own float32 ``log``, Cephes' ``logf``) and
a correctly rounded square root.  So the float32 normals equal JAX's bit for
bit (before that repair ~95% did, within 4 ulp), and so do the factor paths
of two and more factors; one factor's OU update XLA fuses by the step's
place in its scan, so it is held to 2 float32 eps of the paths' magnitude
(measured 1.93).  Spot prices agree to 1e-5 relative.

The draws and the OU update round some steps as one fused multiply-add, as
XLA's CPU code does: the plain version's ``_fma`` (float64) and ``_fma32``
(float32), written in separately rounded float64 torch ops, must equal the
exactly rounded ``a * b + c`` (a ``fractions.Fraction`` oracle) on every
triple.
"""
import os
import re
import sys
from datetime import date
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from storage_tpu.models import multi_factor as jax_mf  # noqa: E402
from storage_tpu.models import simulation as jax_sim  # noqa: E402
from storage_tpu_torch.models import multi_factor as torch_mf  # noqa: E402
from storage_tpu_torch.models import simulation as torch_sim  # noqa: E402

torch.set_num_threads(2)

SEEDS = [0, 12, 13, 2**31 - 1]
NORMAL_SHAPE = (16, 3, 4099)  # one draw block at an odd sim count


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_in_bit_exact(seed):
    key = jax.random.PRNGKey(seed)
    assert tuple(int(v) for v in np.asarray(key)) == torch_sim.prng_key(seed)
    for data in (0, 1, 16, 320, 2**31 + 5):
        expected = tuple(int(v) for v in np.asarray(jax.random.fold_in(key, data)))
        assert torch_sim.fold_in(torch_sim.prng_key(seed), data) == expected


def _key_pair(seed):
    key = torch_sim.fold_in(torch_sim.prng_key(seed), 1)
    return key, jnp.asarray(np.array(key, dtype=np.uint32))


@pytest.mark.parametrize("seed", [12, 13])
def test_bits_and_uniforms_bit_exact(seed):
    key, jkey = _key_pair(seed)
    bits = torch_sim.random_bits(key, NORMAL_SHAPE, "cpu")
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(jax.random.bits(jkey, NORMAL_SHAPE)).astype(np.int64))
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    expected = np.asarray(jax.random.uniform(jkey, NORMAL_SHAPE, jnp.float32, lo, 1.0))
    got = torch_sim.uniform_from_bits(bits, lo, 1.0).numpy()
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("seed", [12, 13])
def test_normals_equal_jax(seed):
    """Every float32 normal equals ``jax.random.normal``'s, bit for bit
    (measured: all 196,752 at both seeds; ~95% within 4 ulp before the map
    rounded as XLA's CPU code does)."""
    key, jkey = _key_pair(seed)
    expected = np.asarray(jax.random.normal(jkey, NORMAL_SHAPE, jnp.float32))
    got = torch_sim.normal(key, NORMAL_SHAPE, "cpu").numpy()
    ulps = _ulps(got, expected)
    assert ulps.max() == 0


def _fma_triples(kind, rng, n=3000):
    """``n`` float64 triples ``(a, b, c)`` of one kind."""
    if kind == "horner":  # erf_inv's and log1p's steps: p w + c, |c| from 1e-21 to 5
        return (rng.standard_normal(n) * 10.0 ** rng.uniform(-21, 1, n),
                rng.uniform(-4.0, 4.0, n), rng.standard_normal(n) * 10.0 ** rng.uniform(-21, 1, n))
    a = rng.standard_normal(n) * 10.0 ** rng.uniform(-8, 8, n)
    b = rng.standard_normal(n) * 10.0 ** rng.uniform(-8, 8, n)
    if kind == "cancel":  # c = -a b rounded: the result is the product's rounding error
        return a, b, -(a * b)
    if kind == "ties":  # a b exactly half an ulp of c, or three quarters of one
        c = np.ldexp(1.0 + rng.integers(0, 2**52, n) * 2.0**-52, rng.integers(-30, 30, n))
        half = np.ldexp(1.0, np.frexp(c)[1] - 54)
        scale = np.where(np.arange(n) % 2 == 0, 1.0, 1.5)
        return half * scale, np.where(np.arange(n) % 3 == 0, -1.0, 1.0), c
    # zeros: a zero product with c of either sign and zero, and zero sums
    a[: n // 2] = np.where(np.arange(n // 2) % 2 == 0, 0.0, -0.0)
    c = np.where(np.arange(n) % 3 == 0, -0.0, np.where(np.arange(n) % 3 == 1, 0.0, -(a * b)))
    return a, b, c


@pytest.mark.parametrize("kind", ["horner", "cancel", "ties", "zeros"])
def test_fma_rounds_once(kind):
    """``_fma`` equals ``a * b + c`` rounded once (IEEE round to nearest
    even, an exactly zero sum +0 unless both addends are -0) on every
    triple, with its sign of zero."""
    a, b, c = _fma_triples(kind, np.random.default_rng(len(kind)))
    got = torch_sim._fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    midpoints = 0
    for i in range(len(a)):
        exact = Fraction(a[i]) * Fraction(b[i]) + Fraction(c[i])
        if exact == 0:
            both_negative = np.signbit(a[i] * b[i]) and np.signbit(c[i]) and a[i] * b[i] == 0
            want = -0.0 if both_negative else 0.0
        else:
            want = float(exact)  # Fraction -> float rounds to nearest even
        assert got[i] == want and np.signbit(got[i]) == np.signbit(want), (a[i], b[i], c[i])
        midpoints += 2 * abs(exact - Fraction(want)) == Fraction(float(np.spacing(abs(want))))
    if kind == "ties":  # half of them lie exactly between two doubles
        assert midpoints >= 0.4 * len(a)


def _round_to_float32(exact: Fraction) -> np.float32:
    """``exact`` rounded once to float32, to nearest even (going through
    float64 would round twice)."""
    near = np.float32(float(exact))
    cands = [np.nextafter(near, np.float32(-np.inf)), near, np.nextafter(near, np.float32(np.inf))]
    errs = [abs(Fraction(float(c)) - exact) for c in cands]
    best = min(errs)
    ties = [c for c, e in zip(cands, errs) if e == best]
    return ties[0] if len(ties) == 1 else next(c for c in ties if not c.view(np.int32) & 1)


def _fma32_triples(kind, rng, n=2000):
    """``n`` float32 triples ``(a, b, c)`` of one kind."""
    f32 = np.float32
    if kind == "horner":  # erf_inv's, log1p's and logf's steps: p w + c
        return ((rng.standard_normal(n) * 10.0 ** rng.uniform(-8, 1, n)).astype(f32),
                rng.uniform(-4.0, 4.0, n).astype(f32),
                (rng.standard_normal(n) * 10.0 ** rng.uniform(-8, 1, n)).astype(f32))
    a = (rng.standard_normal(n) * 10.0 ** rng.uniform(-4, 4, n)).astype(f32)
    b = (rng.standard_normal(n) * 10.0 ** rng.uniform(-4, 4, n)).astype(f32)
    if kind == "cancel":  # c = -a b rounded: the result is the product's rounding error
        return a, b, -(a * b)
    if kind == "ties":  # a b exactly half an ulp of c, or three quarters of one
        c = np.ldexp(1.0 + rng.integers(0, 2**23, n) * 2.0**-23,
                     rng.integers(-30, 30, n)).astype(f32)
        half = np.ldexp(1.0, np.frexp(c)[1] - 25).astype(f32)
        scale = np.where(np.arange(n) % 2 == 0, 1.0, 1.5).astype(f32)
        return half * scale, np.where(np.arange(n) % 3 == 0, -1.0, 1.0).astype(f32), c
    # zeros: a zero product with c of either sign and zero, and zero sums
    a[: n // 2] = np.where(np.arange(n // 2) % 2 == 0, 0.0, -0.0)
    c = np.where(np.arange(n) % 3 == 0, -0.0, np.where(np.arange(n) % 3 == 1, 0.0, -(a * b)))
    return a, b, c.astype(f32)


@pytest.mark.parametrize("kind", ["horner", "cancel", "ties", "zeros"])
def test_fma32_rounds_once(kind):
    """``_fma32`` equals float32 ``a * b + c`` rounded once (to nearest even,
    an exactly zero sum +0 unless both addends are -0) on every triple, with
    its sign of zero."""
    a, b, c = _fma32_triples(kind, np.random.default_rng(len(kind) + 100))
    got = torch_sim._fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    assert got.dtype == np.float32
    midpoints = 0
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        if exact == 0:
            both_negative = np.signbit(a[i] * b[i]) and np.signbit(c[i]) and a[i] * b[i] == 0
            want = np.float32(-0.0 if both_negative else 0.0)
        else:
            want = _round_to_float32(exact)
        assert got[i] == want and np.signbit(got[i]) == np.signbit(want), (a[i], b[i], c[i])
        if exact != 0:
            gap = Fraction(float(np.spacing(np.abs(want))))
            midpoints += 2 * abs(exact - Fraction(float(want))) == gap
    if kind == "ties":  # half of them lie exactly between two floats
        assert midpoints >= 0.4 * len(a)


def _draw_arguments(seed):
    """The uniforms of the seed's float32 draws and the arguments ``-u u`` of
    their ``log1p``."""
    key, _ = _key_pair(seed)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = torch_sim.uniform_from_bits(torch_sim.random_bits(key, NORMAL_SHAPE, "cpu"), lo, 1.0)
    return u, -u * u


def _xla(fn, t):
    return np.asarray(jax.jit(fn)(jnp.asarray(t.numpy())))


@pytest.mark.parametrize("seed", [12, 13])
def test_float32_map_equals_xla_steps(seed):
    """The repaired float32 map against XLA's, step by step, on every
    argument the seed's draws meet: ``_xla_log1p`` equals ``jnp.log1p``
    (its rational branch on 64% of them, its ``log`` branch on the rest,
    where ``_xla_logf`` equals ``jnp.log`` of ``1 + x``), and ``_erf_inv_f32``
    equals ``jax.lax.erf_inv``.  Each repaired step is needed: torch's
    ``log1p``, its ``log``, its float32 ``sqrt`` or separately rounded Horner
    steps each leave draws that differ (measured: ~85%, ~83%, 99.4% and ~98%
    of the arguments they meet equal)."""
    u, x = _draw_arguments(seed)
    small = (x.abs() < torch_sim._LOG1P_SMALL).numpy()
    assert 0.5 < small.mean() < 0.8  # both branches are met
    np.testing.assert_array_equal(torch_sim._xla_log1p(x).numpy(), _xla(jnp.log1p, x))
    np.testing.assert_array_equal(torch_sim._xla_logf(x + 1.0).numpy(),
                                  _xla(jnp.log, x + 1.0))
    np.testing.assert_array_equal(torch_sim._erf_inv_f32(u).numpy(),
                                  _xla(jax.lax.erf_inv, u))
    big = ~small
    assert (torch.log(x + 1.0).numpy() != _xla(jnp.log, x + 1.0))[big].any()
    w = torch.from_numpy(np.linspace(5.0, 16.0, 200_001, dtype=np.float32))
    assert (torch.sqrt(w).numpy() != _xla(jnp.sqrt, w)).any()
    np.testing.assert_array_equal(torch.sqrt(w.double()).float().numpy(), _xla(jnp.sqrt, w))


def test_path_kernel_class_threshold_is_the_plain_branch_test():
    """The float64 path kernel sorts a draw into ``log1p``'s rational branch
    by ``|u| <= kRationalMaxU``; the plain version by ``|-u u| < sqrt(2) - 1``
    on the rounded square. The constant is the largest double whose rounded
    square lies below the bound, so both tests agree on every uniform."""
    src = open(os.path.join(os.path.dirname(__file__), "..", "storage_tpu_torch", "ops", "csrc",
                            "path_sim.cu")).read()
    t = float.fromhex(re.search(r"kRationalMaxU = (0x[0-9a-fp.+-]+);", src).group(1))
    bound = torch_sim._LOG1P_SMALL
    assert t * t < bound and np.nextafter(t, 2.0) ** 2 >= bound
    near = np.nextafter(t, np.array([0.0, 2.0]))
    u = np.concatenate([near, -near, [t, -t], torch_sim.uniform_from_words64(
        *torch_sim._hash_words(torch_sim.prng_key(12), NORMAL_SHAPE, "cpu"),
        float(np.nextafter(-1.0, 0.0)), 1.0).numpy().ravel()])
    np.testing.assert_array_equal(np.abs(u) <= t, np.abs(-u * u) < bound)


def _seasonal_coeffs(mf):
    """Simulation coefficients of the headline 3-factor seasonal model over
    70 daily steps (four full 16-step draw blocks and a tail)."""
    periods = pd.period_range("2021-04-26", periods=70, freq="D")
    fwd = pd.Series(np.linspace(16.6, 15.3, 70), index=periods)
    factors, corrs = mf.create_3_factor_season_params(
        "D", 91.0, 0.85, 0.30, 0.19, pd.Period("2021-04-25", freq="D"), periods[-1])
    return mf.build_sim_coefficients(factors, corrs, pd.Period("2021-04-25", freq="D"), fwd,
                                     list(periods))


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "antithetic"])
def test_factor_paths_match_jax(antithetic):
    jc, tc = _seasonal_coeffs(jax_mf), _seasonal_coeffs(torch_mf)
    for name in ("decay", "chol", "vols", "log_fwd_drift"):
        np.testing.assert_array_equal(getattr(tc, name), getattr(jc, name))
    expected = np.asarray(jax_sim.simulate_factor_paths(jc, 2048, 12, antithetic))
    got = torch_sim.simulate_factor_paths(tc, 2048, 12, antithetic, device="cpu").numpy()
    assert got.shape == expected.shape == (70, 3, 2048)
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-5 * np.abs(expected).max())


def _float32_path_error(got, expected):
    """max |got - expected| in float32 eps of max |expected|."""
    return float(np.abs(got - expected).max() / (np.finfo(np.float32).eps * np.abs(expected).max()))


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "antithetic"])
@pytest.mark.parametrize("num_factors", [1, 2, 3])
def test_factor_paths_float32_equal_jax(num_factors, antithetic):
    """With the draws equal and the OU update fused as XLA fuses it
    (``inc = c0 z0; inc = fma(c_g, z_g, inc); y = fma(decay, y, inc)``),
    paths of two and more factors equal JAX's bit for bit; one factor's
    update XLA fuses by the step's place in its scan, so it is held to 2
    float32 eps of the paths' magnitude (measured 1.93 at 70 steps)."""
    key = torch_sim.fold_in(torch_sim.prng_key(12), 1)
    for n in (37, 70):
        jc, tc = factor_case(jax_sim, num_factors, n), factor_case(torch_sim, num_factors, n)
        expected = np.asarray(jax_sim.simulate_factor_paths(
            jc, 1023, None, antithetic, key=jnp.asarray(np.array(key, dtype=np.uint32))))
        got = torch_sim.simulate_factor_paths(tc, 1023, antithetic=antithetic, key=key,
                                              device="cpu").numpy()
        if num_factors > 1:
            np.testing.assert_array_equal(got, expected)
        else:
            assert _float32_path_error(got, expected) <= 2.0


def factor_case(mod, num_factors, n):
    """Simulation coefficients of an ``num_factors``-factor model over ``n``
    irregular steps, from ``mod.sim_coefficients`` (either package's)."""
    rng = np.random.default_rng(100 * num_factors + n)
    alphas = np.array([0.0, 2.5, 16.2])[:num_factors]
    corrs = np.array([[1.0, 0.6, 0.3], [0.6, 1.0, 0.4], [0.3, 0.4, 1.0]])[:num_factors,
                                                                         :num_factors]
    times = np.cumsum(rng.uniform(0.5, 3.0, n)) / 365.0
    return mod.sim_coefficients(alphas, rng.uniform(0.1, 0.9, (n, num_factors)), corrs, times,
                                rng.uniform(10.0, 20.0, n))


# The contract the fused CUDA path kernel is held to on the card (there
# against the plain version, bit for bit): every factor count the kernel is
# instantiated for below its maximum, horizons shorter than, equal to and
# past whole 16-step draw blocks, an odd sim count, with and without
# antithetic pairs.  Here the public function takes the plain version.
@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "antithetic"])
@pytest.mark.parametrize("n", [5, 16, 37])
@pytest.mark.parametrize("num_factors", [1, 2, 3])
def test_factor_paths_shapes_match_jax(num_factors, n, antithetic):
    num_sims = 1023
    jc, tc = factor_case(jax_sim, num_factors, n), factor_case(torch_sim, num_factors, n)
    key = torch_sim.fold_in(torch_sim.prng_key(12), 1)
    expected = np.asarray(jax_sim.simulate_factor_paths(
        jc, num_sims, None, antithetic, key=jnp.asarray(np.array(key, dtype=np.uint32))))
    got = torch_sim.simulate_factor_paths(tc, num_sims, antithetic=antithetic, key=key,
                                          device="cpu").numpy()
    assert got.shape == expected.shape == (n, num_factors, num_sims)
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-5 * np.abs(expected).max())


def test_cuda_binding_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        torch_sim._simulate_factor_paths_cuda(factor_case(torch_sim, 2, 5), 8, (0, 1), False,
                                              "cpu")


def test_spot_goldens():
    """``tests/test_golden.py``'s pinned spot prices (seed 12, 4 sims)."""
    golden = {
        0: [48.22341537475586, 52.962684631347656, 71.82847595214844],
        1: [62.216041564941406, 60.40741729736328, 61.58184051513672],
        2: [53.616703033447266, 45.66847610473633, 108.35804748535156],
        3: [54.27455520629883, 37.887332916259766, 67.95614624023438],
    }
    factors = [
        (0.0, {date(2020, 8, 1): 0.35, "2021-01-15": 0.29, date(2021, 7, 30): 0.32}),
        (2.5, pd.Series(data=[0.15, 0.18, 0.21], index=pd.PeriodIndex(
            data=["2020-08-01", "2021-01-15", "2021-07-30"], freq="D"))),
        (16.2, {date(2020, 8, 1): 0.95, "2021-01-15": 0.92, date(2021, 7, 30): 0.89}),
    ]
    corrs = torch_mf.validate_multi_factor_params(
        factors, np.array([[1.0, 0.6, 0.3], [0.6, 1.0, 0.4], [0.3, 0.4, 1.0]]))
    fwd = {"2020-08-01": 56.85, pd.Period("2021-01-15", freq="D"): 59.08,
           date(2021, 7, 30): 62.453}
    periods = [pd.Period("2020-08-01", freq="D"), pd.Period("2021-01-15", freq="D"),
               pd.Period("2021-07-30", freq="D")]
    coeffs = torch_mf.build_sim_coefficients(factors, corrs, date(2020, 7, 27), fwd, periods)
    paths = torch_sim.simulate_factor_paths(coeffs, 4, 12, device="cpu")
    spots = torch_sim.spots_from_factor_paths(
        paths, torch.tensor(coeffs.vols, dtype=torch.float32),
        torch.tensor(coeffs.log_fwd_drift, dtype=torch.float32)).numpy()
    for col, expected in golden.items():
        np.testing.assert_allclose(spots[:, col], expected, rtol=1e-5)
