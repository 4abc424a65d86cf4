#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its own line (every failure exits non-zero):

1. device  — a CUDA device must be present; prints ``nvidia-smi``'s name and
   power limit.
2. build   — compiles both CUDA kernels from ``storage_tpu_torch/ops/csrc``.
3. capture — one valuation of the headline case (``bench.py::build_case``:
   daily storage 2021-04-01 -> 2022-04-01, 3-factor seasonal model, 10-term
   basis, G = 100, 1,000,000 paths, seed 13), recording the inputs of one
   mid-horizon backward kernel launch and of the forward kernel launch.
4. K1 / K2 — each kernel against its plain PyTorch version on the recorded
   inputs restricted to 65,536 sims, then both timed at the main path's
   shapes (1M sims) with CUDA events.
5. main    — launch counts reset, the valuation timed once more; the counts
   must show both kernels ran, and NPV and intrinsic value must match the
   JAX reference's record for this case and seed.

Prints the kernel table as one JSON line, then the result as the last line:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

NUM_SIMS = 1_000_000
SEED = 13
COMPARE_SIMS = 65_536
# The JAX package's record for this case and seed (round-5 TPU run, same
# threefry paths): NPV 78,373 (its kernels quantize, moving NPV by ~3e-5),
# intrinsic 40,976.
REF_NPV, NPV_RTOL = 78_373.0, 1e-3
REF_INTRINSIC, INTRINSIC_ATOL = 40_976.0, 5.0
BASIS = "1 + x_st + x_sw + x_lt + s + x_st**2 + x_sw**2 + x_lt**2 + s**2 + s * x_st"
# Kernel vs plain version (rounding differs: nvcc contracts a*b+c into FMA,
# which flips near-tie decisions).  K1: V entries off by more than V_TOL
# relative count as flipped, at most FLIP_FRAC_MAX of them.  K2: a path
# whose PV is off by more than 1e-4 relative took a flipped decision at some
# step and diverged from there, so flips are bounded per decision
# (flipped paths / (sims x steps) <= FLIP_FRAC_MAX / 10) together with their
# NPV effect (<= FWD_NPV_RTOL); at 341 steps one flip per 3e4 decisions
# already flips 1% of paths (ROADMAP Queue 3).
V_TOL, FLIP_FRAC_MAX, PARTIALS_RTOL, FWD_NPV_RTOL = 1e-5, 1e-3, 1e-4, 1e-5


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def build_case(pkg, storage_end="2022-04-01"):
    """The headline case of ``bench.py::build_case`` for a package with the
    ``CmdtyStorage``/``RatchetInterp`` API (this port or the JAX one)."""
    import pandas as pd

    storage = pkg.CmdtyStorage(
        freq="D",
        storage_start="2021-04-01",
        storage_end=storage_end,
        injection_cost=0.01,
        withdrawal_cost=0.025,
        ratchets=[
            ("2021-04-01", [(0.0, -150.0, 250.0), (2000.0, -200.0, 175.0),
                            (5000.0, -260.0, 155.0), (7000.0, -275.0, 132.0)]),
            ("2022-10-01", [(0.0, -130.0, 260.0), (2000.0, -190.0, 190.0),
                            (5000.0, -230.0, 165.0), (7000.0, -245.0, 148.0)]),
        ],
        ratchet_interp=pkg.RatchetInterp.LINEAR,
    )
    monthly_index = pd.period_range(start="2021-04-25", periods=25, freq="M")
    monthly_fwd = [
        16.61, 15.68, 15.42, 15.31, 15.27, 15.13, 15.96, 17.22, 17.32, 17.66,
        17.59, 16.81, 15.36, 14.49, 14.28, 14.25, 14.32, 14.33, 15.30, 16.58,
        16.64, 16.79, 16.64, 15.90, 14.63,
    ]
    fwd_curve = pd.Series(monthly_fwd, index=monthly_index).resample("D").ffill()
    rates = pd.Series(
        [0.005, 0.006, 0.0072, 0.0087, 0.0101, 0.0115, 0.0126],
        index=pd.PeriodIndex(freq="D", data=[
            "2021-04-25", "2021-06-01", "2021-08-01", "2021-12-01",
            "2022-04-01", "2022-12-01", "2023-12-01",
        ]),
    )
    ir_curve = rates.resample("D").asfreq().interpolate(method="linear")

    def settlement_rule(d):
        return d.asfreq("M").asfreq("D", "end") + 20

    return storage, fwd_curve, ir_curve, settlement_rule


def value_case(pkg, num_sims, seed, **kw):
    storage, fwd_curve, ir_curve, settlement_rule = build_case(pkg)
    return pkg.three_factor_seasonal_value(
        cmdty_storage=storage, val_date="2021-04-25", inventory=1500.0,
        fwd_curve=fwd_curve, interest_rates=ir_curve, settlement_rule=settlement_rule,
        num_sims=num_sims, seed=seed, spot_mean_reversion=91.0, spot_vol=0.85,
        long_term_vol=0.30, seasonal_vol=0.19, basis_funcs=BASIS, discount_deltas=True,
        return_sim_panels=False, **kw,
    )


def cuda_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch

    fn()  # warm up
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def phase_device():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from storage_tpu_torch.ops import csrc

    t0 = time.perf_counter()
    path = csrc.build(verbose=True)
    csrc.kernels()
    print(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s")


def phase_capture():
    """One 1M-path valuation recording one backward and the forward launch."""
    import storage_tpu_torch as tt
    from storage_tpu_torch.engines import lsmc

    captured = {}
    real_bwd, real_fwd = lsmc.backward_update, lsmc.forward_sim
    calls = {"bwd": 0}

    def record_bwd(*args, **kw):
        calls["bwd"] += 1
        if calls["bwd"] == 170:  # a mid-horizon period
            captured["bwd"] = (args, kw)
        return real_bwd(*args, **kw)

    def record_fwd(*args, **kw):
        captured["fwd"] = (args, kw)
        return real_fwd(*args, **kw)

    lsmc.backward_update, lsmc.forward_sim = record_bwd, record_fwd
    try:
        t0 = time.perf_counter()
        res = value_case(tt, NUM_SIMS, SEED, device="cuda")
        wall = time.perf_counter() - t0
    finally:
        lsmc.backward_update, lsmc.forward_sim = real_bwd, real_fwd
    check("bwd" in captured and "fwd" in captured, "capture run did not reach both kernels")
    print(f"[capture] warm-up valuation {wall:.3f} s, NPV {res.npv:.4f}, "
          f"{calls['bwd']} backward launches")
    return captured


def _slice_sims(t, n):
    return t[..., :n].contiguous()


def phase_backward(captured):
    import torch
    from storage_tpu_torch.ops import backward

    args, kw = captured["bwd"]
    (f, fp, v_next, table, vbar, musd, gj, gw, scal) = args
    spec = kw["spec"]
    small = (_slice_sims(f, COMPARE_SIMS), _slice_sims(fp, COMPARE_SIMS),
             _slice_sims(v_next, COMPARE_SIMS), table, vbar, musd, gj, gw, scal)
    v_k, graw_k, praw_k = backward._backward_update_cuda(*small, spec=spec)
    v_r, graw_r, praw_r = backward.backward_update_reference(*small, spec=spec)
    torch.cuda.synchronize()
    scale = float(v_r.abs().max())
    diff = (v_k - v_r).abs()
    flipped = diff > V_TOL * scale
    frac = float(flipped.float().mean())
    max_ok = float(diff[~flipped].max()) if bool((~flipped).any()) else 0.0
    e_graw, e_praw = rel_err(graw_k, graw_r), rel_err(praw_k, praw_r)
    ms = cuda_ms(lambda: backward._backward_update_cuda(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: backward.backward_update_reference(*args, **kw), 3)
    print(f"[K1 backward_update] {COMPARE_SIMS} sims G={v_r.shape[0]} B={spec.num_basis} "
          f"D={table.shape[0]}: V max|diff| {float(diff.max()):.3e} (max|V| {scale:.3e}), "
          f"outside flips {max_ok:.3e}, flipped {int(flipped.sum())} = {frac:.2e}; "
          f"graw rel {e_graw:.2e}, praw rel {e_praw:.2e}; "
          f"{v_next.shape[1]} sims: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    check(frac <= FLIP_FRAC_MAX, f"K1 flipped fraction {frac:.2e} > {FLIP_FRAC_MAX}")
    check(e_graw <= PARTIALS_RTOL and e_praw <= PARTIALS_RTOL,
          f"K1 partials disagree: graw {e_graw:.2e}, praw {e_praw:.2e}")
    return dict(max_abs_err=float(diff.max()), ms=ms, plain_ms=plain_ms)


def phase_forward(captured):
    import torch
    from storage_tpu_torch.ops import forward

    args, kw = captured["fwd"]
    (factors, inv0, tables, mus, sds, pillars, scalars) = args
    small = (_slice_sims(factors, COMPARE_SIMS), _slice_sims(inv0, COMPARE_SIMS),
             tables, mus, sds, pillars, scalars)
    s_k, x_k, inv_k, pv_k = forward._forward_sim_cuda(*small, **kw)
    s_r, x_r, inv_r, pv_r = forward.forward_sim_reference(*small, **kw)
    torch.cuda.synchronize()
    e_sums, e_xsums = rel_err(s_k, s_r), rel_err(x_k, x_r)
    pv_diff = (pv_k - pv_r).abs()
    flipped = pv_diff > 1e-4 * pv_r.abs().clamp_min(1e-6 * float(pv_r.abs().max()))
    frac = float(flipped.float().mean())
    per_decision = frac / factors.shape[0]
    npv_effect = abs(float(pv_k.mean() - pv_r.mean())) / abs(float(pv_r.mean()))
    max_ok = float(pv_diff[~flipped].max()) if bool((~flipped).any()) else 0.0
    ms = cuda_ms(lambda: forward._forward_sim_cuda(*args, **kw), 5)
    plain_ms = cuda_ms(lambda: forward.forward_sim_reference(*args, **kw), 1)
    print(f"[K2 forward_sim] {COMPARE_SIMS} sims x {factors.shape[0]} steps: sums rel "
          f"{e_sums:.2e}, xsums rel {e_xsums:.2e}, pv max|diff| {float(pv_diff.max()):.3e} "
          f"(outside flips {max_ok:.3e}), flipped paths {int(flipped.sum())} = {frac:.2e} "
          f"= {per_decision:.2e} per decision, NPV effect {npv_effect:.2e}; "
          f"{factors.shape[2]} sims: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    check(per_decision <= FLIP_FRAC_MAX / 10,
          f"K2 flips {per_decision:.2e} per decision > {FLIP_FRAC_MAX / 10}")
    check(npv_effect <= FWD_NPV_RTOL, f"K2 NPV effect {npv_effect:.2e} > {FWD_NPV_RTOL}")
    check(e_sums <= PARTIALS_RTOL and e_xsums <= PARTIALS_RTOL,
          f"K2 sums disagree: sums {e_sums:.2e}, xsums {e_xsums:.2e}")
    return dict(max_abs_err=float(pv_diff.max()), ms=ms, plain_ms=plain_ms)


def phase_main():
    import numpy as np
    import torch
    import storage_tpu_torch as tt

    phases = {}

    def sink(sw):
        phases.update({p: sw.elapsed(p) for p in sw.PHASES + ("All",)})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tt.reset_launch_counts()
    t0 = time.perf_counter()
    res = value_case(tt, NUM_SIMS, SEED, device="cuda", profile_sink=sink)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = tt.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_steps = len(res.expected_profile) - 1
    print(f"[main] 1 x {NUM_SIMS} paths x {n_steps} steps: wall {wall:.3f} s; phases "
          + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()))
    print(f"[main] NPV {res.npv:.4f} (record {REF_NPV:.0f}, rel "
          f"{abs(res.npv - REF_NPV) / REF_NPV:.2e}), intrinsic {res.intrinsic_npv:.4f} "
          f"(record {REF_INTRINSIC:.0f}), peak device memory {peak / 2**30:.3f} GiB, "
          f"launches {counts}")
    deltas = res.deltas.to_numpy()
    check(deltas.shape == (n_steps + 1,) and np.isfinite(deltas).all(), "deltas not finite")
    check(np.isfinite(res.expected_profile.to_numpy()).all(), "expected profile not finite")
    check(np.isfinite(res.npv), "NPV not finite")
    check(counts["backward_update"] >= n_steps - 1,
          f"backward kernel ran {counts['backward_update']} times for {n_steps} steps")
    check(counts["forward_sim"] >= 1, "forward kernel never ran")
    check(abs(res.intrinsic_npv - REF_INTRINSIC) <= INTRINSIC_ATOL,
          f"intrinsic {res.intrinsic_npv} outside {REF_INTRINSIC} +- {INTRINSIC_ATOL}")
    check(abs(res.npv - REF_NPV) <= NPV_RTOL * REF_NPV,
          f"NPV {res.npv} outside {REF_NPV} +- {NPV_RTOL:.0e}")
    return counts


def main() -> int:
    try:
        import torch

        card = phase_device()
        import storage_tpu_torch  # noqa: F401  (fails outside a checkout)

        phase_build()
        captured = phase_capture()
        k1 = phase_backward(captured)
        k2 = phase_forward(captured)
        del captured
        torch.cuda.empty_cache()
        counts = phase_main()
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    except ImportError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    kernels = [
        dict(name="backward_update", route="cuda",
             source="storage_tpu_torch/ops/csrc/backward_update.cu",
             replaces="storage_tpu/ops/pallas_backward.py:114",
             launches=counts["backward_update"], **k1),
        dict(name="forward_sim", route="cuda",
             source="storage_tpu_torch/ops/csrc/forward_sim.cu",
             replaces="storage_tpu/ops/pallas_forward.py:96",
             launches=counts["forward_sim"], **k2),
    ]
    print(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
