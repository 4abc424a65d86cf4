"""Path simulator of the PyTorch port against the JAX package.

The port reproduces ``jax.random``'s threefry2x32 generator with integer
tensor ops: keys, ``fold_in`` and the random bits must be bit-exact, the
uniforms too.  Normals go through XLA's float32 ``erf_inv`` polynomial; the
``log1p``/``sqrt`` inside differ by an ulp between XLA and torch, so
normals agree to 4 ulp and mostly bit for bit.  Factor paths and spot
prices then agree to 1e-5 relative.
"""
import os
import sys
from datetime import date

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
def test_normals_within_4_ulp(seed):
    key, jkey = _key_pair(seed)
    expected = np.asarray(jax.random.normal(jkey, NORMAL_SHAPE, jnp.float32))
    got = torch_sim.normal(key, NORMAL_SHAPE, "cpu").numpy()
    ulps = _ulps(got, expected)
    assert ulps.max() <= 4
    assert (ulps == 0).mean() >= 0.90


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
