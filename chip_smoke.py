#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its own line (every failure exits non-zero):

1. device  — a CUDA device must be present; prints ``nvidia-smi``'s name and
   power limit, and the host's memory.
2. build   — compiles both CUDA kernels from ``storage_tpu_torch/ops/csrc``.
3. capture — one valuation of the headline case (``bench.py::build_case``:
   daily storage 2021-04-01 -> 2022-04-01, 3-factor seasonal model, 10-term
   basis, G = 100, 1,000,000 paths, seed 13), recording the inputs of one
   mid-horizon backward kernel launch (and of its decision table) and of
   the forward kernel launch.
4. K1 / K2 — each kernel against its plain PyTorch version on the recorded
   inputs restricted to 65,536 sims, then both timed at the main path's
   shapes (1M sims) with CUDA events; then the same for K1 at D = 5
   (``extra_decisions=1`` geometry) and for K2's variants: per-sim panels,
   D = 5, and POLY ratchets (cubics fitted through the recorded pillars).
5. main    — launch counts reset, the valuation timed once more; the counts
   must show both kernels ran, and NPV and intrinsic value must match the
   JAX reference's record for this case and seed.
6. async   — the API's defaults through ``runtime.AsyncValuation``: per-sim
   panels and the chunked driver (progress, cancellation hook) at 1M paths;
   status, progress values, NPV, panel means, frame shapes and launch
   counts are checked.
7. cancel  — the same run cancelled from its first progress report: it must
   end CANCELLED and give its device memory back.
8. options — POLY ratchets with ``extra_decisions=1`` at 1M paths.

Prints the kernel table as one JSON line, then the result as the last line:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX.
"""
from __future__ import annotations

import gc
import json
import resource
import subprocess
import sys
import time

NUM_SIMS = 1_000_000
SEED = 13
COMPARE_SIMS = 65_536
CAPTURE_LAUNCH = 170  # the backward launch recorded: a mid-horizon period
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
# Per-sim panels, kernel against plain version: every element outside the
# flipped paths within PANEL_RTOL of its field's max.  The chunked (async)
# run against the main one: NPV within ASYNC_NPV_RTOL (float32 regression
# noise: each span solves its latest period directly); panel sim-means
# against the expected profile within PROFILE_RTOL of each column's max, and
# the mean of the per-sim PV sums against the NPV within SIM_PV_RTOL.
PANEL_RTOL, ASYNC_NPV_RTOL, PROFILE_RTOL, SIM_PV_RTOL = 1e-5, 1e-4, 1e-4, 1e-5
NUM_SPANS, BACKWARD_SHARE = 20, 0.66  # the chunked driver's spans and progress weighting
CANCEL_MEM_SLACK = 64 * 2**20  # bytes a cancelled run may leave allocated


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def build_case(pkg, storage_end="2022-04-01", ratchet_interp="LINEAR"):
    """The headline case of ``bench.py::build_case`` for a package with the
    ``CmdtyStorage``/``RatchetInterp`` API (this port or the JAX one);
    ``ratchet_interp`` names the ``RatchetInterp`` of its pillars."""
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
        ratchet_interp=getattr(pkg.RatchetInterp, ratchet_interp),
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


def case_kwargs(pkg, num_sims, seed, ratchet_interp="LINEAR"):
    """Keyword arguments of ``three_factor_seasonal_value`` for the headline case."""
    storage, fwd_curve, ir_curve, settlement_rule = build_case(
        pkg, ratchet_interp=ratchet_interp)
    return dict(
        cmdty_storage=storage, val_date="2021-04-25", inventory=1500.0,
        fwd_curve=fwd_curve, interest_rates=ir_curve, settlement_rule=settlement_rule,
        num_sims=num_sims, seed=seed, spot_mean_reversion=91.0, spot_vol=0.85,
        long_term_vol=0.30, seasonal_vol=0.19, basis_funcs=BASIS, discount_deltas=True,
    )


def value_case(pkg, num_sims, seed, ratchet_interp="LINEAR", **kw):
    return pkg.three_factor_seasonal_value(
        **case_kwargs(pkg, num_sims, seed, ratchet_interp), return_sim_panels=False, **kw)


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
    with open("/proc/meminfo") as f:
        mem_total = next(line.split(":")[1].strip() for line in f if line.startswith("MemTotal"))
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; host MemTotal {mem_total}")
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
    real = (lsmc.backward_update, lsmc.forward_sim, lsmc.decision_table, lsmc.device_inputs)
    calls = {"bwd": 0, "table": 0}

    def record_bwd(*args, **kw):
        calls["bwd"] += 1
        if calls["bwd"] == CAPTURE_LAUNCH:
            captured["bwd"] = (args, kw)
        return real[0](*args, **kw)

    def record_fwd(*args, **kw):
        captured["fwd"] = (args, kw)
        return real[1](*args, **kw)

    def record_table(*args):  # one table per backward launch, built just before it
        calls["table"] += 1
        if calls["table"] == CAPTURE_LAUNCH:
            captured["table"] = args
        return real[2](*args)

    def record_dev(*args, **kw):
        captured["dev"] = real[3](*args, **kw)
        return captured["dev"]

    lsmc.backward_update, lsmc.forward_sim, lsmc.decision_table, lsmc.device_inputs = (
        record_bwd, record_fwd, record_table, record_dev)
    try:
        t0 = time.perf_counter()
        res = value_case(tt, NUM_SIMS, SEED, device="cuda")
        wall = time.perf_counter() - t0
    finally:
        lsmc.backward_update, lsmc.forward_sim, lsmc.decision_table, lsmc.device_inputs = real
    check(all(k in captured for k in ("bwd", "fwd", "table", "dev")),
          "capture run did not reach both kernels")
    captured["num_bwd"] = calls["bwd"]
    print(f"[capture] warm-up valuation {wall:.3f} s, NPV {res.npv:.4f}, "
          f"{calls['bwd']} backward launches")
    return captured


def _slice_sims(t, n):
    return t[..., :n].contiguous()


def _check_backward(label, args, kw):
    """K1 against its plain version at COMPARE_SIMS sims, then both timed at
    the recorded width (1M sims)."""
    import torch
    from storage_tpu_torch.ops import backward

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
    print(f"[{label}] {COMPARE_SIMS} sims G={v_r.shape[0]} B={spec.num_basis} "
          f"D={table.shape[0]}: V max|diff| {float(diff.max()):.3e} (max|V| {scale:.3e}), "
          f"outside flips {max_ok:.3e}, flipped {int(flipped.sum())} = {frac:.2e}; "
          f"graw rel {e_graw:.2e}, praw rel {e_praw:.2e}; "
          f"{v_next.shape[1]} sims: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    check(frac <= FLIP_FRAC_MAX, f"{label} flipped fraction {frac:.2e} > {FLIP_FRAC_MAX}")
    check(e_graw <= PARTIALS_RTOL and e_praw <= PARTIALS_RTOL,
          f"{label} partials disagree: graw {e_graw:.2e}, praw {e_praw:.2e}")
    return dict(max_abs_err=float(diff.max()), ms=ms, plain_ms=plain_ms)


def phase_backward(captured):
    args, kw = captured["bwd"]
    return _check_backward("K1 backward_update", args, kw)


def phase_backward_d5(captured):
    """K1 on the recorded period with the decision geometry and table of
    ``extra_decisions=1`` (D = 5), built as the engine builds them."""
    from storage_tpu_torch.engines import lsmc
    from storage_tpu_torch.ops.ratchets import INTERP_LINEAR

    args, kw = captured["bwd"]
    coeffs, vbar_next = captured["table"][:2]
    dev = captured["dev"]
    G = args[2].shape[0]
    period = 1 + captured["num_bwd"] - CAPTURE_LAUNCH  # the launch's decision step
    geometry = lsmc._decision_geometry(dev, period, 1, INTERP_LINEAR, G, 0)
    check(bool((geometry[0][0] == args[6]).all()) and bool((geometry[1][0] == args[7]).all()),
          "K1 D=5: the recorded launch's D=3 geometry could not be rebuilt")
    j, w, cost, price = (g[0] for g in lsmc._decision_geometry(dev, period, 1, INTERP_LINEAR,
                                                                G, 1))
    table = lsmc.decision_table(coeffs, vbar_next, j, w, cost, price)
    check(table.shape[0] == 5, f"K1 D=5 table has {table.shape[0]} decisions")
    d5_args = args[:3] + (table,) + args[4:6] + (j, w) + args[8:]
    return _check_backward("K1 backward_update D=5", d5_args, kw)


def _check_forward(label, args, kw, panels=False):
    """K2 against its plain version at COMPARE_SIMS sims (with per-sim panels
    when ``panels``), then both timed at the recorded width (1M sims)."""
    import torch
    from storage_tpu_torch.ops import forward

    (factors, inv0, tables, mus, sds, pillars, scalars) = args
    n = factors.shape[0]
    kw = dict(kw, panels=None)
    small = (_slice_sims(factors, COMPARE_SIMS), _slice_sims(inv0, COMPARE_SIMS),
             tables, mus, sds, pillars, scalars)
    out_k = out_r = None
    if panels:
        out_k = torch.full((n, 6, COMPARE_SIMS), float("nan"), device=factors.device)
        out_r = torch.empty_like(out_k)
    s_k, x_k, inv_k, pv_k = forward._forward_sim_cuda(*small, **dict(kw, panels=out_k))
    s_r, x_r, inv_r, pv_r = forward.forward_sim_reference(*small, **dict(kw, panels=out_r))
    torch.cuda.synchronize()
    e_sums, e_xsums = rel_err(s_k, s_r), rel_err(x_k, x_r)
    pv_diff = (pv_k - pv_r).abs()
    flipped = pv_diff > 1e-4 * pv_r.abs().clamp_min(1e-6 * float(pv_r.abs().max()))
    panel_note = ""
    if panels:
        # A flipped near-tie decision can also leave the PV within 1e-4 (the
        # path rejoins, or the tie was exact): with panels a path counts as
        # flipped where any of its volumes differ.
        vol_k, vol_r = out_k[:, 1], out_r[:, 1]
        flipped |= ((vol_k - vol_r).abs() > PANEL_RTOL * vol_r.abs().max()).any(dim=0)
    frac = float(flipped.float().mean())
    per_decision = frac / n
    npv_effect = abs(float(pv_k.mean() - pv_r.mean())) / abs(float(pv_r.mean()))
    max_ok = float(pv_diff[~flipped].max()) if bool((~flipped).any()) else 0.0
    if panels:
        check(bool(torch.isfinite(out_k).all()), f"{label}: the kernel left panel entries unwritten")
        e_panel = max(rel_err(out_k[:, f][:, ~flipped], out_r[:, f][:, ~flipped])
                      for f in range(6))
        panel_note = f", panels outside flips rel {e_panel:.2e}"
        check(e_panel <= PANEL_RTOL, f"{label} panels disagree: {e_panel:.2e} > {PANEL_RTOL}")
        del out_k, out_r
        full = torch.empty((n, 6, factors.shape[2]), device=factors.device)
        kw = dict(kw, panels=full)
    ms = cuda_ms(lambda: forward._forward_sim_cuda(*args, **kw), 5)
    plain_ms = cuda_ms(lambda: forward.forward_sim_reference(*args, **kw), 1)
    print(f"[{label}] {COMPARE_SIMS} sims x {n} steps: sums rel "
          f"{e_sums:.2e}, xsums rel {e_xsums:.2e}, pv max|diff| {float(pv_diff.max()):.3e} "
          f"(outside flips {max_ok:.3e}), flipped paths {int(flipped.sum())} = {frac:.2e} "
          f"= {per_decision:.2e} per decision, NPV effect {npv_effect:.2e}{panel_note}; "
          f"{factors.shape[2]} sims: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    check(per_decision <= FLIP_FRAC_MAX / 10,
          f"{label} flips {per_decision:.2e} per decision > {FLIP_FRAC_MAX / 10}")
    check(npv_effect <= FWD_NPV_RTOL, f"{label} NPV effect {npv_effect:.2e} > {FWD_NPV_RTOL}")
    check(e_sums <= PARTIALS_RTOL and e_xsums <= PARTIALS_RTOL,
          f"{label} sums disagree: sums {e_sums:.2e}, xsums {e_xsums:.2e}")
    return dict(max_abs_err=float(pv_diff.max()), ms=ms, plain_ms=plain_ms)


def phase_forward(captured):
    args, kw = captured["fwd"]
    return _check_forward("K2 forward_sim", args, kw)


def _poly_pillars(pillars):
    """POLY pillars ``[n, P, 5]`` from LINEAR ones: exact-fit polynomials
    through each step's pillars (``np.polyfit`` of degree P - 1, highest
    power first), as ``CmdtyStorage`` builds them for RatchetInterp.POLYNOMIAL."""
    import numpy as np
    import torch

    tables = pillars.double().cpu().numpy()
    deg = tables.shape[1] - 1
    coefs = [np.stack([np.polyfit(t[:, 0], t[:, c], deg) for t in tables]) for c in (1, 2)]
    out = np.concatenate([tables, coefs[0][..., None], coefs[1][..., None]], axis=-1)
    return torch.tensor(out, dtype=torch.float32, device=pillars.device)


def phase_forward_variants(captured):
    """K2's options on the recorded forward launch: per-sim panels, D = 5
    and POLY ratchets."""
    from storage_tpu_torch.ops.ratchets import INTERP_POLY

    args, kw = captured["fwd"]
    poly_args = args[:5] + (_poly_pillars(args[5]),) + args[6:]
    return {
        "panels": _check_forward("K2 forward_sim panels", args, kw, panels=True),
        "D5": _check_forward("K2 forward_sim D=5", args, dict(kw, extra_decisions=1)),
        "poly": _check_forward("K2 forward_sim POLY", poly_args,
                               dict(kw, interp_kind=INTERP_POLY)),
    }


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
    return counts, res.npv


def _host_peak_gib():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20  # ru_maxrss is in KiB


def phase_async(main_npv):
    """The slice's path: ``AsyncValuation`` with the API's defaults (per-sim
    panels; progress and cancellation wired, so the chunked driver) at 1M."""
    import numpy as np
    import torch
    import storage_tpu_torch as tt
    from storage_tpu_torch import valuation
    from storage_tpu_torch.runtime import AsyncValuation, CalcStatus

    task = AsyncValuation(tt.three_factor_seasonal_value,
                          **case_kwargs(tt, NUM_SIMS, SEED), device="cuda")
    progress = []
    task.subscribe_progress(progress.append)  # reads 0.0 at once
    assembly = {}
    real_assemble = valuation._assemble_results

    def timed_assemble(*args):  # the host side: frames from the device arrays
        t = time.perf_counter()
        out = real_assemble(*args)
        assembly["s"] = time.perf_counter() - t
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tt.reset_launch_counts()
    valuation._assemble_results = timed_assemble
    t0 = time.perf_counter()
    try:
        task.start()
        res = task.result(timeout=900)
        torch.cuda.synchronize()
    finally:
        valuation._assemble_results = real_assemble
    wall = time.perf_counter() - t0
    counts = tt.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_steps = len(res.expected_profile) - 1
    expected = ([BACKWARD_SHARE * i / NUM_SPANS for i in range(1, NUM_SPANS + 1)]
                + [BACKWARD_SHARE + (1.0 - BACKWARD_SHARE) * i / NUM_SPANS
                   for i in range(1, NUM_SPANS + 1)] + [1.0])
    profile = res.expected_profile.to_numpy()
    frames = ("sim_inventory", "sim_inject_withdraw", "sim_cmdty_consumed",
              "sim_inventory_loss", "sim_net_volume", "sim_pv")
    shapes = {name: getattr(res, name).shape for name in frames
              + ("sim_spot_regress", "sim_spot_valuation")}
    profile_err = max(
        float(np.abs(getattr(res, name).to_numpy().mean(axis=1) - profile[:, c]).max()
              / max(np.abs(profile[:, c]).max(), 1e-30))
        for c, name in enumerate(frames))
    sim_pv_npv = float(res.sim_pv.to_numpy().sum(axis=0).mean())
    print(f"[async] AsyncValuation defaults, {NUM_SIMS} paths x {n_steps} steps: wall "
          f"{wall:.3f} s (result assembly {assembly['s']:.3f} s), device peak "
          f"{peak / 2**30:.3f} GiB, host peak RSS "
          f"{_host_peak_gib():.3f} GiB; NPV {res.npv:.4f} (main {main_npv:.4f}, rel "
          f"{abs(res.npv - main_npv) / abs(main_npv):.2e}), panel means vs profile rel "
          f"{profile_err:.2e}, mean sim_pv sum {sim_pv_npv:.4f}; {len(progress) - 1} progress "
          f"reports; frames {shapes}; launches {counts}")
    check(task.status == CalcStatus.SUCCESS, f"async status {task.status}")
    check(progress[0] == 0.0 and progress[1:] == expected,
          f"async progress {progress} != {expected}")
    check(abs(res.npv - REF_NPV) <= NPV_RTOL * REF_NPV,
          f"async NPV {res.npv} outside {REF_NPV} +- {NPV_RTOL:.0e}")
    check(abs(res.npv - main_npv) <= ASYNC_NPV_RTOL * abs(main_npv),
          f"async NPV {res.npv} differs from the main NPV {main_npv} by > {ASYNC_NPV_RTOL}")
    check(profile_err <= PROFILE_RTOL, f"panel means vs profile {profile_err:.2e}")
    check(abs(sim_pv_npv - res.npv) <= SIM_PV_RTOL * abs(res.npv),
          f"mean sim_pv sum {sim_pv_npv} vs NPV {res.npv}")
    check(all(shapes[name] == (n_steps + 1, NUM_SIMS) for name in frames)
          and shapes["sim_spot_regress"] == shapes["sim_spot_valuation"] == (n_steps, NUM_SIMS),
          f"frame shapes {shapes}")
    check(counts == {"backward_update": n_steps - 1, "forward_sim": NUM_SPANS},
          f"async launches {counts}")
    return counts


def phase_cancel():
    """The async path cancelled from its first progress report."""
    import torch
    import storage_tpu_torch as tt
    from storage_tpu_torch.runtime import AsyncValuation, CalcStatus

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    task = AsyncValuation(tt.three_factor_seasonal_value,
                          **case_kwargs(tt, NUM_SIMS, SEED), device="cuda")
    task.subscribe_progress(lambda p: p > 0.0 and task.cancel())
    tt.reset_launch_counts()
    t0 = time.perf_counter()
    task.start()
    try:
        task.result(timeout=900)
        raised = False
    except tt.ValuationCancelledError:
        raised = True
    wall = time.perf_counter() - t0
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    print(f"[cancel] status {task.status.name} after {wall:.3f} s, progress {task.progress}, "
          f"launches {tt.launch_counts()}, device memory {before / 2**20:.1f} MiB before, "
          f"{after / 2**20:.1f} MiB after")
    check(task.status == CalcStatus.CANCELLED and raised,
          f"cancel: status {task.status}, result() raised ValuationCancelledError: {raised}")
    check(after - before <= CANCEL_MEM_SLACK,
          f"cancelled run kept {(after - before) / 2**20:.1f} MiB of device memory")


def phase_options(main_npv):
    """POLY ratchets (cubics through the headline pillars) and
    ``extra_decisions=1`` at 1M paths, without panels."""
    import numpy as np
    import torch
    import storage_tpu_torch as tt

    tt.reset_launch_counts()
    t0 = time.perf_counter()
    res = value_case(tt, NUM_SIMS, SEED, ratchet_interp="POLYNOMIAL", extra_decisions=1,
                     device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = tt.launch_counts()
    n_steps = len(res.expected_profile) - 1
    print(f"[options] POLY + extra_decisions=1, {NUM_SIMS} paths: wall {wall:.3f} s, NPV "
          f"{res.npv:.4f} (LINEAR D=3 {main_npv:.4f}), intrinsic {res.intrinsic_npv:.4f}, "
          f"launches {counts}")
    check(np.isfinite(res.npv) and np.isfinite(res.deltas.to_numpy()).all(),
          "options: NPV or deltas not finite")
    check(counts == {"backward_update": n_steps - 1, "forward_sim": 1},
          f"options launches {counts}")
    return counts


def main() -> int:
    try:
        import torch

        card = phase_device()
        import storage_tpu_torch  # noqa: F401  (fails outside a checkout)

        phase_build()
        captured = phase_capture()
        k1 = phase_backward(captured)
        k1_d5 = phase_backward_d5(captured)
        k2 = phase_forward(captured)
        k2_variants = phase_forward_variants(captured)
        del captured
        gc.collect()
        torch.cuda.empty_cache()
        counts, main_npv = phase_main()
        async_counts = phase_async(main_npv)
        gc.collect()
        phase_cancel()
        options_counts = phase_options(main_npv)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    except ImportError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    paths = {"main": counts, "async": async_counts, "options": options_counts}
    kernels = [
        dict(name="backward_update", route="cuda",
             source="storage_tpu_torch/ops/csrc/backward_update.cu",
             replaces="storage_tpu/ops/pallas_backward.py:114",
             launches=counts["backward_update"], **k1,
             launches_by_path={p: c["backward_update"] for p, c in paths.items()},
             variants={"D5": k1_d5}),
        dict(name="forward_sim", route="cuda",
             source="storage_tpu_torch/ops/csrc/forward_sim.cu",
             replaces="storage_tpu/ops/pallas_forward.py:96",
             launches=counts["forward_sim"], **k2,
             launches_by_path={p: c["forward_sim"] for p, c in paths.items()},
             variants=k2_variants),
    ]
    print(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
