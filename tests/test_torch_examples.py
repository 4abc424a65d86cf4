"""The port's example scripts (``examples/torch_*.py``) on the CPU.

Each script runs in a subprocess (``--device cpu``, two threads, a timeout
of its own), the three at once, and must exit 0 and print its JAX
counterpart's lines with the NPV of the JAX script's call on the same
inputs, computed here in-process: the README example (2,000 paths), the
async example (5,000 paths, two factors, through ``AsyncValuation``: the
chunked driver in both packages) and the mesh example at a cut path count
(``--num-sims 8192``: a mesh of eight ``cpu`` entries against the JAX
package's ``paths_mesh()`` over conftest's eight virtual CPU devices).  The
NPVs are float32 LSMC at 2,000-8,192 paths, printed to the unit: they are
held within ``NPV_RTOL`` (measured up to 2.6e-4, the async example).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))

import storage_tpu as jax_pkg  # noqa: E402

NPV_RTOL = 1e-3
TIMEOUT_S = 300
MESH_SIMS = 8192
SCRIPTS = {
    "readme": ["examples/torch_readme_example.py"],
    "async": ["examples/torch_async_and_cache.py"],
    "mesh": ["examples/torch_multichip_sharding.py", "--num-sims", str(MESH_SIMS)],
}


@pytest.fixture(scope="module")
def runs():
    """The three scripts' (return code, stdout, stderr), run at once."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = {name: subprocess.Popen([sys.executable, *argv, "--device", "cpu"], cwd=REPO,
                                    env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
             for name, argv in SCRIPTS.items()}
    out = {}
    for name, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        out[name] = (proc.returncode, stdout, stderr)
    return out


def _number(pattern, text):
    match = re.search(pattern, text, re.MULTILINE)
    assert match, f"{pattern!r} not in output:\n{text}"
    return float(match.group(1).replace(",", ""))


def _ran(runs, name):
    rc, stdout, stderr = runs[name]
    assert rc == 0, f"{SCRIPTS[name][0]} exited {rc}:\n{stderr[-3000:]}"
    return stdout


def test_readme_example(runs):
    from test_readme_example import readme_market, readme_storage, settlement_rule

    stdout = _ran(runs, "readme")
    fwd_curve, ir_curve = readme_market()
    ref = jax_pkg.three_factor_seasonal_value(
        cmdty_storage=readme_storage(), val_date="2021-04-25", inventory=1500.0,
        fwd_curve=fwd_curve, interest_rates=ir_curve, settlement_rule=settlement_rule,
        num_sims=2000, seed=12, spot_mean_reversion=91.0, spot_vol=0.85, long_term_vol=0.30,
        seasonal_vol=0.19,
        basis_funcs="1 + x_st + x_sw + x_lt + s + x_st**2 + x_sw**2 + x_lt**2 + s**2 + s * x_st",
        discount_deltas=True)
    npv = _number(r"^Full NPV:\t([\d,]+)$", stdout)
    intrinsic = _number(r"^Intrinsic NPV:\t([\d,]+)$", stdout)
    extrinsic = _number(r"^Extrinsic NPV:\t([\d,]+)$", stdout)
    assert npv == pytest.approx(ref.npv, rel=NPV_RTOL)
    assert intrinsic == round(ref.intrinsic_npv)
    assert extrinsic == pytest.approx(ref.extrinsic_npv, abs=NPV_RTOL * ref.npv)
    for header in ("Deltas (head):", "Expected profile (head):",
                   "Trigger prices (first rows with both sides):"):
        assert header in stdout


def test_async_and_cache_example(runs):
    stdout = _ran(runs, "async")
    storage = jax_pkg.CmdtyStorage(
        "D", "2022-01-01", "2022-07-01", injection_cost=0.1, withdrawal_cost=0.2,
        min_inventory=0.0, max_inventory=10_000.0, max_injection_rate=300.0,
        max_withdrawal_rate=400.0)
    idx = pd.period_range("2022-01-01", "2022-07-01", freq="D")
    fwd_curve = pd.Series(25.0 + 6.0 * np.sin(np.arange(len(idx)) / 30.0), index=idx)
    vol_curve = pd.Series(0.8, index=idx)
    ref = jax_pkg.multi_factor_value(
        storage, "2022-01-01", 2_000.0, fwd_curve, None, None,
        factors=[(10.0, vol_curve), (0.0, vol_curve * 0.3)], factor_corrs=0.25,
        num_sims=5_000, basis_funcs="1 + s + x0 + x1 + x0**2", discount_deltas=True, seed=42,
        on_progress_update=lambda p: None)
    npv = _number(r"^NPV: ([\d,]+)  \(via cache: [\d,]+\)$", stdout)
    cached = _number(r"^NPV: [\d,]+  \(via cache: ([\d,]+)\)$", stdout)
    assert cached == npv
    assert npv == pytest.approx(ref.npv, rel=NPV_RTOL)
    progress = [float(p) for p in re.findall(r"^progress:\s+([\d.]+)%$", stdout, re.MULTILINE)]
    assert progress[0] == 0.0 and progress[-1] == 100.0
    assert all(b >= a for a, b in zip(progress, progress[1:]))
    statuses = re.findall(r"^status:   (\w+)$", stdout, re.MULTILINE)
    assert statuses == ["pending", "running", "success"]


def test_multichip_sharding_example(runs):
    from storage_tpu.parallel.mesh import paths_mesh

    stdout = _ran(runs, "mesh")
    assert "mesh: PathsMesh(['cpu', 'cpu', 'cpu', 'cpu', 'cpu', 'cpu', 'cpu', 'cpu'])" in stdout
    storage = jax_pkg.CmdtyStorage(
        "D", "2022-01-01", "2022-04-01", injection_cost=0.1, withdrawal_cost=0.2,
        min_inventory=0.0, max_inventory=5_000.0, max_injection_rate=200.0,
        max_withdrawal_rate=250.0)
    idx = pd.period_range("2022-01-01", "2022-04-01", freq="D")
    fwd_curve = pd.Series(30.0 + 5.0 * np.sin(np.arange(len(idx)) / 12.0), index=idx)
    vol_curve = pd.Series(0.9, index=idx)
    ref = jax_pkg.multi_factor_value(
        storage, "2022-01-01", 1_000.0, fwd_curve, None, None,
        factors=[(8.0, vol_curve)], factor_corrs=None, num_sims=MESH_SIMS,
        basis_funcs="1 + x0 + x0**2 + x0**3", discount_deltas=False, seed=7,
        mesh=paths_mesh(), return_sim_panels=False)
    assert _number(r"^NPV: ([\d,]+)$", stdout) == pytest.approx(ref.npv, rel=NPV_RTOL)
