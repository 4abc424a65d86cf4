"""``tools/torch_precision_study.py`` against the JAX package on the same paths.

For each of the study's two configurations the factor paths are drawn once,
at 2,048 sims, by the JAX package's ``simulate_factor_paths`` under
``jax.enable_x64`` (seeds 11 and 12, the study's), and fed to the JAX
package's ``run_lsmc`` and to the port study's ``run_legs`` on the CPU.
The port's own float64 draws are not used here: torch's CPU float64 ``log``
and ``sqrt`` part from XLA's on a few draws (ROADMAP Queue 3), so both
packages must see one path set.

- float64 leg: NPV, backward NPV, deltas, expected inventory and the inject
  triggers within 1e-10 (relative; arrays of their largest magnitude);
- float32 leg, on the same paths rounded to float32: bit for bit the port's
  float32 ``run_lsmc`` on the JAX study's float32 inputs (the paths and the
  spot-vol loadings and drifts rounded by NumPy).  Against the JAX package's
  float32 leg, and each float32 leg against the shared float64 NPV, the NPV
  is held to the study's criterion, 1e-3, at 2,048 paths;
- the float32 pair at 8,192 paths (``test_torch_slice.py``'s path count):
  the port's float32 NPV within ``test_torch_slice.py``'s NPV bound, 1e-4,
  of the JAX package's on one path set (measured 5.3e-5 / 2.4e-5,
  constant-rate / bench).  At 2,048 paths the pair parts by more (NPV
  7.1e-5 / 2.5e-4): the two packages' float32 regressions accumulate in
  other orders, and each package's float32 leg lies as far from the shared
  float64 leg as the other's (the port 1.4e-4 / 1.1e-5, JAX 6.8e-5 /
  2.4e-4).  The float32 deltas are not held against JAX: the pair's largest
  delta gap is 1.07e-2 / 6.6e-3 of max|delta| at 8,192 paths (4.2e-2 /
  1.7e-2 at 2,048), above ``test_torch_slice.py``'s 1e-2 on the
  constant-rate configuration; each package's float32 deltas lie as far
  from the float64 ones (at 2,048: the port 2.4e-2 / 1.8e-2, JAX 4.7e-2 /
  1.7e-2).  The deltas are held by the float64 leg;
- the bench configuration is ``bench.py::build_case``'s headline case;
- the table's columns against the JAX study's formulas
  (``benchmarks/precision_study.py:174-192``, written out here: that module
  reconfigures JAX when imported) on hand-made inputs;
- the tool's ``main`` at 2,048 sims on the CPU exits 0;
- ``chip_smoke``'s recording of the study's float64 launches at a cut size.
"""
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
for path in (REPO, REPO / "tools"):
    sys.path.insert(0, str(path))

import storage_tpu as jax_pkg  # noqa: E402
import storage_tpu.engines.lsmc as jl  # noqa: E402
import storage_tpu_torch.engines.lsmc as tl  # noqa: E402
import torch_precision_study as study  # noqa: E402
from storage_tpu.compile import build_valuation_context  # noqa: E402
from storage_tpu.models.multi_factor import build_sim_coefficients, create_3_factor_season_params  # noqa: E402
from storage_tpu.models.simulation import simulate_factor_paths  # noqa: E402
from storage_tpu.ops.regression import basis_spec  # noqa: E402
from storage_tpu.utils.basis import THREE_FACTOR_SEASONAL_ALIASES, parse_basis_functions  # noqa: E402

torch.set_num_threads(2)

SIMS = 2048
F64_RTOL = 1e-10
F32_NPV_RTOL = study.NPV_RTOL_MAX
PAIR_SIMS = 8192  # test_torch_slice.py's SIMS
PAIR_NPV_RTOL = 1e-4  # test_torch_slice.py's NPV_RTOL


def jax_build(cfg):
    """``benchmarks/precision_study.py::build`` on the JAX package."""
    ctx = build_valuation_context(cfg["storage"], cfg["val_date"], cfg["inventory"], cfg["fwd"],
                                  cfg["rates"], cfg["settlement"])
    factors, corrs = create_3_factor_season_params(
        "D", cfg["mr"], cfg["spot_vol"], cfg["lt_vol"], cfg["sw_vol"], ctx.val_period,
        ctx.periods[-1])
    first_sim = 1 if ctx.val_date_is_first_step else 0
    coeffs = build_sim_coefficients(factors, corrs, ctx.val_period, cfg["fwd"],
                                    list(ctx.periods[first_sim:]))
    spec = basis_spec(parse_basis_functions(cfg["basis"], THREE_FACTOR_SEASONAL_ALIASES), 3)
    return ctx, coeffs, spec


def jax_paths(coeffs, num_sims):
    """The regression and valuation path sets, float64, drawn by the JAX package."""
    with jax.enable_x64(True):
        return [np.asarray(simulate_factor_paths(coeffs, num_sims, seed=seed, dtype=jnp.float64))
                for seed in (study.REG_SEED, study.VAL_SEED)]


def jax_result(arrays):
    """``benchmarks/precision_study.py::result_dict``."""
    return dict(
        npv=np.float64(arrays.npv),
        backward_npv=np.float64(arrays.backward_npv),
        deltas=np.asarray(arrays.deltas, np.float64),
        inventory=np.asarray(arrays.profile_means[:, 0], np.float64),
        inj_trigger=np.asarray(arrays.trigger_inject_prices, np.float64),
        has_inj=np.asarray(arrays.trigger_has_inject),
    )


@pytest.fixture(scope="module", params=study.CONFIGS, ids=["constant_rate", "bench"])
def legs(request):
    """Per configuration: the JAX package's two legs and the port study's, on
    one float64 path set drawn by the JAX package."""
    make_cfg = request.param
    cfg = make_cfg(SIMS, jax_pkg)
    ctx, coeffs, spec = jax_build(cfg)
    reg, val = jax_paths(coeffs, SIMS)
    with jax.enable_x64(True):
        ref64 = jax_result(jl.run_lsmc(
            ctx, reg, val, np.float64(coeffs.vols), np.float64(coeffs.log_fwd_drift), spec,
            discount_deltas=cfg["discount_deltas"], dtype=jnp.float64, collect_panels=False))
    ref32 = jax_result(jl.run_lsmc(
        ctx, reg.astype(np.float32), val.astype(np.float32), np.float32(coeffs.vols),
        np.float32(coeffs.log_fwd_drift), spec, discount_deltas=cfg["discount_deltas"],
        dtype=jnp.float32, collect_panels=False))
    port_cfg = make_cfg(SIMS)
    case = (port_cfg, *study.build(port_cfg))
    out = study.run_legs(case, {"reg": torch.from_numpy(reg.copy()),
                                "val": torch.from_numpy(val.copy())}, "cpu")
    _, tctx, tcoeffs, tspec = case
    direct32 = study.result_dict(tl.run_lsmc(
        tctx, torch.from_numpy(reg.astype(np.float32)), torch.from_numpy(val.astype(np.float32)),
        np.float32(tcoeffs.vols), np.float32(tcoeffs.log_fwd_drift), tspec,
        port_cfg["discount_deltas"], device="cpu", dtype=torch.float32))
    return {"f64": (out["f64"][0], ref64), "f32": (out["f32"][0], ref32), "direct32": direct32}


def _close(got, ref, rtol, name):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    scale = max(float(np.nanmax(np.abs(ref))) if ref.size else 0.0, 1e-300)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale, equal_nan=True,
                               err_msg=name)


def test_float64_leg_equals_jax(legs):
    got, ref = legs["f64"]
    for name in ("npv", "backward_npv", "deltas", "inventory"):
        _close(got[name], ref[name], F64_RTOL, name)
    np.testing.assert_array_equal(got["has_inj"], ref["has_inj"])
    mask = ref["has_inj"]
    assert mask.any()
    _close(got["inj_trigger"][mask], ref["inj_trigger"][mask], F64_RTOL, "inj_trigger")


def test_float32_leg_is_the_float32_engine_on_the_rounded_paths(legs):
    got, direct = legs["f32"][0], legs["direct32"]
    for name in ("npv", "backward_npv", "deltas", "inventory", "inj_trigger", "has_inj"):
        np.testing.assert_array_equal(got[name], direct[name], err_msg=name)


def test_float32_leg_within_the_criterion_of_jax(legs):
    got, ref = legs["f32"]
    f64 = float(legs["f64"][1]["npv"])
    assert got["npv"] == pytest.approx(float(ref["npv"]), rel=F32_NPV_RTOL)
    assert got["npv"] == pytest.approx(f64, rel=F32_NPV_RTOL)
    assert float(ref["npv"]) == pytest.approx(f64, rel=F32_NPV_RTOL)
    assert got["npv"] != f64  # the leg ran in float32


@pytest.mark.parametrize("make_cfg", study.CONFIGS, ids=["constant_rate", "bench"])
def test_float32_pair_within_the_slice_bound(make_cfg):
    """At 8,192 paths, on one float64 path set drawn by the JAX package and
    rounded to float32, the port's float32 NPV within 1e-4 of the JAX
    package's float32 NPV."""
    cfg = make_cfg(PAIR_SIMS, jax_pkg)
    ctx, coeffs, spec = jax_build(cfg)
    reg, val = (p.astype(np.float32) for p in jax_paths(coeffs, PAIR_SIMS))
    ref = float(jl.run_lsmc(ctx, reg, val, np.float32(coeffs.vols),
                            np.float32(coeffs.log_fwd_drift), spec,
                            discount_deltas=cfg["discount_deltas"], dtype=jnp.float32,
                            collect_panels=False).npv)
    port_cfg = make_cfg(PAIR_SIMS)
    tctx, tcoeffs, tspec = study.build(port_cfg)
    got = float(tl.run_lsmc(tctx, torch.from_numpy(reg), torch.from_numpy(val),
                            np.float32(tcoeffs.vols), np.float32(tcoeffs.log_fwd_drift), tspec,
                            port_cfg["discount_deltas"], device="cpu", collect_panels=False,
                            dtype=torch.float32).npv)
    assert got == pytest.approx(ref, rel=PAIR_NPV_RTOL)


def test_bench_config_is_the_headline_case():
    """The tool's copy of the headline case builds, on the JAX package, the
    valuation context of ``bench.py::build_case``."""
    import dataclasses

    import bench

    storage, fwd, rates, rule = bench.build_case()
    cfg = study.bench_config(SIMS, jax_pkg)
    pd.testing.assert_series_equal(cfg["fwd"], fwd)
    pd.testing.assert_series_equal(cfg["rates"], rates)
    ours = build_valuation_context(cfg["storage"], cfg["val_date"], cfg["inventory"], cfg["fwd"],
                                   cfg["rates"], cfg["settlement"])
    theirs = build_valuation_context(storage, cfg["val_date"], cfg["inventory"], fwd, rates, rule)

    def assert_same(a, b, name):
        if dataclasses.is_dataclass(a):
            for f in dataclasses.fields(a):
                assert_same(getattr(a, f.name), getattr(b, f.name), f"{name}.{f.name}")
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)

    for f in dataclasses.fields(ours):  # the storage object itself aside: its tables are here
        if f.name != "storage":
            assert_same(getattr(ours, f.name), getattr(theirs, f.name), f.name)


def jax_row(f32, f64):
    """``benchmarks/precision_study.py:174-192`` as it stands, returning the
    numbers it prints ("nan" where no trigger step is shared)."""
    cap = float(np.max(np.asarray(f64["inventory"]))) or 1.0
    max_rate = float(np.abs(f64["deltas"]).max())
    d_delta = np.abs(f32["deltas"] - f64["deltas"])
    d_inv = np.abs(f32["inventory"] - f64["inventory"])
    mask = f32["has_inj"] & f64["has_inj"]
    d_trig = np.abs(f32["inj_trigger"][mask] - f64["inj_trigger"][mask])
    trig_scale = np.abs(f64["inj_trigger"][mask]).max() if mask.any() else 1.0
    return [
        float(f64["npv"]),
        abs(f32["npv"] - f64["npv"]) / abs(f64["npv"]),
        abs(f32["backward_npv"] - f64["backward_npv"]) / abs(f64["backward_npv"]),
        100.0 * d_delta.max() / max_rate,
        100.0 * d_delta.mean() / max_rate,
        100.0 * d_inv.max() / cap,
        d_trig.max() / trig_scale if mask.any() else float("nan"),
    ]


def _hand_made(shared_trigger_steps):
    rng = np.random.default_rng(7)
    n = 6

    def leg(npv, bwd, has_inj):
        return dict(npv=npv, backward_npv=bwd, deltas=rng.normal(0, 40, n + 1),
                    inventory=np.abs(rng.normal(500, 200, n + 1)),
                    inj_trigger=rng.normal(20, 2, (n, 10)), has_inj=np.array(has_inj))

    f64 = leg(1234.5, 1250.0, [True, True, False, True, False, True])
    f32 = leg(1234.25, 1249.5, [True, False, True, True, False, True] if shared_trigger_steps
              else [False, False, True, False, True, False])
    return f32, f64


@pytest.mark.parametrize("shared", [True, False], ids=["shared_triggers", "no_shared_trigger"])
def test_table_columns_follow_the_jax_formulas(shared):
    f32, f64 = _hand_made(shared)
    row = study.compare("case", f32, f64)
    got = [row[k] for k in ("npv_f64", "npv_rel_diff", "backward_npv_rel_diff",
                            "max_delta_diff_pct", "mean_delta_diff_pct",
                            "max_inventory_diff_pct_of_cap", "max_inject_trigger_rel")]
    np.testing.assert_array_equal(got, jax_row(f32, f64))
    assert np.isnan(row["max_inject_trigger_rel"]) == (not shared)
    cells = study.table_line(row).strip("| ").split(" | ")
    assert len(cells) == 8 and cells[0] == "case" and cells[1] == "1,234.50"
    assert len(study.HEADER.strip("| ").split(" | ")) == 8


def test_main_runs_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "study.json"
    assert study.main(["--device", "cpu", "--num-sims", str(SIMS), "--out", str(out)]) == 0
    line = json.loads(out.read_text())
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == study.HEADER and json.loads(printed[-1]) == line
    assert [r["config"] for r in line["rows"]] == [
        f"constant-rate 3f seasonal, {SIMS:,} x 365", f"bench: ratcheted 3f seasonal, {SIMS:,} x 342"]
    assert line["passes_1e-3"] and line["card"] == "cpu"
    for leg in line["legs"].values():
        assert leg["f64_peak_bytes"] is None and leg["f64_wall_s"] > 0


def test_smoke_records_the_study_in_float64():
    """``chip_smoke.record_precision`` at a cut size (256 sims): the
    constant-rate configuration's float64 K1 launch at B = 9, the bench
    configuration's float64 K2 launch over its whole horizon and its first
    float64 path set; every launch counted by element type, per
    configuration (the float32 leg draws no path set), as
    ``chip_smoke.count_precision`` counts the study's own run."""
    import chip_smoke
    from storage_tpu_torch.models.simulation import prng_key

    recorded, calls = chip_smoke.record_precision(256, "cpu")
    line, counted = chip_smoke.count_precision(256, "cpu")
    assert counted == calls and len(line["rows"]) == 2
    (f, _, v_next, *_), kw = recorded["K1"]
    assert v_next.dtype == torch.float64 and kw["spec"].num_basis == 9
    factors = recorded["K2"][0][0]
    assert factors.dtype == torch.float64 and tuple(factors.shape) == (340, 3, 256)
    coeffs, num_sims, key, antithetic = recorded["K3"]
    assert coeffs.decay.shape == (341, 3) and num_sims == 256 and not antithetic
    assert key == prng_key(study.REG_SEED)
    for name, steps in (("constant_rate_config", 365), ("bench_config", 340)):
        assert {k: c for (k, t), c in calls[name].items() if t == "float64"} == {
            "K1": steps, "K2": 1, "K3": 2}, name
        assert calls[name][("K2", "float32")] == 1 and ("K3", "float32") not in calls[name]
