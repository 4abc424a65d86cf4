#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its own line (every failure exits non-zero):

1. device  — a CUDA device must be present; prints ``nvidia-smi``'s name and
   power limit, and the host's memory.
2. build   — compiles the three CUDA kernels from ``storage_tpu_torch/ops/csrc``.
3. capture — one valuation of the headline case (``bench.py::build_case``:
   daily storage 2021-04-01 -> 2022-04-01, 3-factor seasonal model, 10-term
   basis, G = 100, 1,000,000 paths, seed 13), recording the inputs of one
   mid-horizon backward kernel launch (and of its decision table), of the
   forward kernel launch and of the two path-set simulations.
4. K1 / K2 — each kernel against its plain PyTorch version on the recorded
   inputs (K1 at their full 1M sims, where each block of its persistent grid
   carries its partials across several tiles; K2 restricted to 65,536 sims),
   then both timed at the main path's shapes (1M sims) with CUDA events,
   beside the least time the card could take (``bound_ms``, from the byte
   and operation counts of ``k1_bound`` and ``k2_bound``); K1 with
   ``torch.matmul`` of its ``[B+1, S] x [S, G]`` partial product timed as a
   yardstick of the reduction alone; then the same for K1 at D = 5
   (``extra_decisions=1`` geometry), K1 at G = 700, D = 5 on random inputs
   (65,536 sims; a grid the PR-1 kernel refused), and K2's variants:
   per-sim panels, D = 5, and POLY ratchets (cubics fitted through the
   recorded pillars).
   K3 — the path kernel against its plain version, bit for bit, at the main
   path's ``[341, 3, 1M]`` for both path-set keys, then at 100,001 sims x 37
   steps in antithetic mode for 1 to 4 factors (an odd sim count, a ragged
   last draw block); timed at the main path's shape beside ``k3_bound``.
5. main    — launch counts reset, the valuation timed once more; the counts
   must show all three kernels ran (340 / 1 / 2 launches), and NPV and
   intrinsic value must match the JAX reference's record for this case and
   seed, and the NPV the port's own record.
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
# The port's own record for this case and seed on an H100, from before the
# path simulator was a kernel: the fused kernel draws the same paths bit for
# bit, so the NPV moves only by near-tie decisions and reduction order.
# A change to a kernel's rounding or reduction order may move it past this
# bound while every kernel still holds its flip bounds against its plain
# version: then the record is read anew from this run, and PERF.md
# says which change moved it and by how much.
PORT_NPV, PORT_NPV_RTOL = 78_377.3750, 1e-5
PATH_SETS = 2  # path-set simulations (= path kernel launches) per valuation
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
# Published H100 SXM peaks (NVIDIA's data sheet, at 700 W): HBM3 bytes/s and
# float32 flop/s outside the tensor cores. A bound is the larger of the
# times for the bytes a kernel must move and the operations it must do.
# Integer operations: an SM has 64 int32 lanes beside its 128 float32 lanes
# (Hopper architecture white paper), and the float32 peak counts two flops
# per lane and clock, so the int32 peak is a quarter of it in operations/s.
PEAK_BYTES_PER_S, PEAK_FP32_FLOPS = 3.35e12, 67e12
PEAK_INT32_OPS = PEAK_FP32_FLOPS / 4
SMALL_PATH_SIMS, SMALL_PATH_STEPS = 100_001, 37  # the path kernel's antithetic check
LARGE_G, LARGE_G_EXTRA = 700, 1  # the random-input K1 phase: G = 700, D = 5


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


def _bound(nbytes, flops, int_ops=0):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(flops / PEAK_FP32_FLOPS, int_ops / PEAK_INT32_OPS) * 1e3  # separate pipes
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(S, G, D, B, F):
    """(ms, "bytes" or "operations") for one K1 launch: V_next read and V_out
    written once, both factor rows, the table and geometry read once, the
    partials written once; per sim D G (2B + 3) flops for the fitted totals,
    10 G for the winning decision's actual total and its centred value (the
    function needs it once per grid point), and 2 (B+1)(G + B+1) for the
    partials."""
    B1 = B + 1
    nbytes = 4 * (2 * F * S + 2 * G * S + D * G * (B + 2) + 2 * D * G + G + B1 * (G + B1))
    flops = S * (D * G * (2 * B + 3) + 10 * G + 2 * B1 * (G + B1))
    return _bound(nbytes, flops)


def k2_bound(n, S, F, B, D, panels):
    """(ms, "bytes" or "operations") for one K2 launch over n steps: the
    factor paths read once, inventories in and out, PVs out, the panels
    written once when asked for; per sim and step 5B + 2F + 30 flops for the
    spot, design row and rates, D (5(B+1) + 23) for the decisions (the
    interpolated continuation is 5 flops per basis term) and B + 8 for the
    sums."""
    nbytes = 4 * (n * F * S + 3 * S + (24 * S * n if panels else 0))
    flops = n * S * (5 * B + 2 * F + 30 + D * (5 * (B + 1) + 23) + B + 8)
    return _bound(nbytes, flops)


def k3_bound(n, S, F, draw_sims):
    """(ms, "bytes" or "operations") for one K3 launch: the paths written
    once; per drawn element (n F draw_sims of them) 75 integer operations
    (threefry2x32's 20 rounds of add, rotate and xor, 11 key additions and
    the final xor: 72; the counter and the mantissa: 3) and 29 flops (the
    uniform map 4, the Giles polynomial 25 with log1pf counted as one; the
    square root of the tail branch is not counted), and per path element
    2F + 1 flops of the OU update."""
    draws = n * F * draw_sims
    return _bound(4 * n * F * S, 29 * draws + (2 * F + 1) * n * F * S, 75 * draws)


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
    from storage_tpu_torch import valuation

    real = (lsmc.backward_update, lsmc.forward_sim, lsmc.decision_table, lsmc.device_inputs)
    real_sim = valuation.simulate_factor_paths
    calls = {"bwd": 0, "table": 0}
    captured["sim"] = []

    def record_sim(coeffs, num_sims, **kw):  # once per path set: regression, valuation
        captured["sim"].append((coeffs, num_sims, kw))
        return real_sim(coeffs, num_sims, **kw)

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
    valuation.simulate_factor_paths = record_sim
    try:
        t0 = time.perf_counter()
        res = value_case(tt, NUM_SIMS, SEED, device="cuda")
        wall = time.perf_counter() - t0
    finally:
        lsmc.backward_update, lsmc.forward_sim, lsmc.decision_table, lsmc.device_inputs = real
        valuation.simulate_factor_paths = real_sim
    check(all(k in captured for k in ("bwd", "fwd", "table", "dev"))
          and len(captured["sim"]) == PATH_SETS, "capture run did not reach every kernel")
    captured["num_bwd"] = calls["bwd"]
    print(f"[capture] warm-up valuation {wall:.3f} s, NPV {res.npv:.4f}, "
          f"{calls['bwd']} backward launches")
    return captured


def _check_backward(label, args, kw, min_tiles_per_block=1):
    """K1 against its plain version on ``args`` at their full width, then both
    timed there, beside the bound and the partial product alone. Each block
    of the kernel's persistent grid must walk at least ``min_tiles_per_block``
    128-sim tiles, so that the comparison covers the partials it carries from
    one tile to the next."""
    import torch
    from storage_tpu_torch.ops import backward, csrc

    (f, fp, v_next, table, vbar, musd, gj, gw, scal) = args
    spec = kw["spec"]
    S, G, D, B, F = v_next.shape[1], v_next.shape[0], table.shape[0], spec.num_basis, f.shape[0]
    blocks = backward._persistent_grid(csrc.kernels(), v_next.device, S, D, B)
    tiles_per_block = -(-S // 128) // blocks  # the fewest a block walks
    check(tiles_per_block >= min_tiles_per_block,
          f"{label}: {S} sims give {blocks} blocks {tiles_per_block} tiles each, "
          f"fewer than {min_tiles_per_block}")
    v_k, graw_k, praw_k = backward._backward_update_cuda(*args, **kw)
    v_r, graw_r, praw_r = backward.backward_update_reference(*args, **kw)
    torch.cuda.synchronize()
    scale = float(v_r.abs().max())
    diff = (v_k - v_r).abs()
    flipped = diff > V_TOL * scale
    n_flipped = int(flipped.sum())
    frac = n_flipped / flipped.numel()
    max_err = float(diff.max())
    max_ok = float(diff[~flipped].max()) if n_flipped < flipped.numel() else 0.0
    e_graw, e_praw = rel_err(graw_k, graw_r), rel_err(praw_k, praw_r)
    del v_k, v_r, diff, flipped
    ms = cuda_ms(lambda: backward._backward_update_cuda(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: backward.backward_update_reference(*args, **kw), 3)
    # The reduction alone as one library call (the port never calls it).
    xr = torch.randn(B + 1, S, device=v_next.device)
    vc_t = (v_next - vbar[:, None]).T
    praw_matmul_ms = cuda_ms(lambda: torch.matmul(xr, vc_t), 20)
    del xr, vc_t
    bound_ms, bound_by = k1_bound(S, G, D, B, F)
    print(f"[{label}] {S} sims G={G} B={B} D={D}, {blocks} blocks of >= {tiles_per_block} "
          f"tiles: V max|diff| {max_err:.3e} (max|V| {scale:.3e}), outside flips "
          f"{max_ok:.3e}, flipped {n_flipped} = {frac:.2e}; graw rel {e_graw:.2e}, praw rel "
          f"{e_praw:.2e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({bound_by}), share {bound_ms / ms:.3f}; torch.matmul of the partial product "
          f"{praw_matmul_ms:.3f} ms")
    check(frac <= FLIP_FRAC_MAX, f"{label} flipped fraction {frac:.2e} > {FLIP_FRAC_MAX}")
    check(e_graw <= PARTIALS_RTOL and e_praw <= PARTIALS_RTOL,
          f"{label} partials disagree: graw {e_graw:.2e}, praw {e_praw:.2e}")
    # library_ms: no single torch call computes K1's function (an argmax over
    # decisions with interpolation, fused with the regression partials).
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, share=bound_ms / ms, library_ms=None,
                praw_matmul_ms=praw_matmul_ms)


def phase_backward(captured):
    args, kw = captured["bwd"]
    return _check_backward("K1 backward_update", args, kw, min_tiles_per_block=2)


def d5_args(captured):
    """The recorded K1 launch's operands with the decision geometry and table
    of ``extra_decisions=1`` (D = 5), built as the engine builds them."""
    from storage_tpu_torch.engines import lsmc
    from storage_tpu_torch.ops.ratchets import INTERP_LINEAR

    args = captured["bwd"][0]
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
    return args[:3] + (table,) + args[4:6] + (j, w) + args[8:]


def phase_backward_d5(captured):
    return _check_backward("K1 backward_update D=5", d5_args(captured), captured["bwd"][1],
                           min_tiles_per_block=2)


def phase_backward_large_grid(captured):
    """K1 at G = 700, D = 5 (past the PR-1 kernel's shared-memory limit) on
    random inputs at COMPARE_SIMS sims, with the recorded launch's basis:
    decisions move inventory by at most 4 grid points, as on the main path."""
    import torch

    args, kw = captured["bwd"]
    spec = kw["spec"]
    F, B, G, D, S = args[0].shape[0], spec.num_basis, LARGE_G, 3 + 2 * LARGE_G_EXTRA, COMPARE_SIMS
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    v_next = r(G, S, scale=50.0) + torch.linspace(0, 400, G, device="cuda")[:, None]
    step = torch.randint(-4, 5, (D, G), generator=gen, device="cuda")
    j = (torch.arange(G, device="cuda") + step).clamp(0, G - 2).to(torch.int32)
    musd = torch.stack([r(B, scale=0.3), torch.rand(B, generator=gen, device="cuda") + 0.5])
    scal = torch.cat([torch.full((2, 1), 2.7, device="cuda"),
                      torch.rand(2, F, generator=gen, device="cuda") * 0.3], 1)
    large = (r(F, S, scale=0.5), r(F, S, scale=0.5), v_next, r(D, G, B + 2, scale=20.0),
             v_next.mean(dim=1), musd, j, torch.rand(D, G, generator=gen, device="cuda"), scal)
    return _check_backward(f"K1 backward_update G={G} D={D}", large, kw)


def _check_forward(label, args, kw, panels=False, min_tiles_per_block=2):
    """K2 against its plain version on ``args`` at their full width (with
    per-sim panels when ``panels``), then both timed there.  Each block of the
    kernel's persistent grid must walk at least ``min_tiles_per_block`` tiles,
    so that the comparison covers what a block carries from one tile to the
    next: partials accumulated in place, the hand-over of the staged records
    and the inventories and PVs set anew."""
    import torch
    from storage_tpu_torch.ops import csrc, forward

    (factors, inv0, tables, mus, sds, pillars, scalars) = args
    n, F, S = factors.shape
    spec = kw["spec"]
    D = 3 + 2 * kw.get("extra_decisions", 0)
    blocks = forward.grid_blocks(csrc.kernels(), factors.device, spec, S, kw["num_grid"],
                                 spec.num_basis, F, pillars.shape[1], pillars.shape[2], D)
    tiles_per_block = -(-S // forward.TILE_SIMS) // blocks  # the fewest a block walks
    check(tiles_per_block >= min_tiles_per_block,
          f"{label}: {S} sims give {blocks} blocks {tiles_per_block} tiles each, "
          f"fewer than {min_tiles_per_block}")
    kw = dict(kw, panels=None)
    out_k = out_r = None
    if panels:
        out_k = torch.full((n, 6, S), float("nan"), device=factors.device)
        out_r = torch.empty_like(out_k)
    s_k, x_k, inv_k, pv_k = forward._forward_sim_cuda(*args, **dict(kw, panels=out_k))
    s_r, x_r, inv_r, pv_r = forward.forward_sim_reference(*args, **dict(kw, panels=out_r))
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
    npv_effect = abs(float(pv_k.double().mean() - pv_r.double().mean())) / abs(float(pv_r.mean()))
    max_ok = float(pv_diff[~flipped].max()) if bool((~flipped).any()) else 0.0
    if panels:
        check(bool(torch.isfinite(out_k).all()), f"{label}: the kernel left panel entries unwritten")
        e_panel = max(rel_err(out_k[:, f][:, ~flipped], out_r[:, f][:, ~flipped])
                      for f in range(6))
        panel_note = f", panels outside flips rel {e_panel:.2e}"
        check(e_panel <= PANEL_RTOL, f"{label} panels disagree: {e_panel:.2e} > {PANEL_RTOL}")
        del out_r, vol_k, vol_r
        kw = dict(kw, panels=out_k)
    ms = cuda_ms(lambda: forward._forward_sim_cuda(*args, **kw), 5)
    plain_ms = cuda_ms(lambda: forward.forward_sim_reference(*args, **kw), 1)
    bound_ms, bound_by = k2_bound(n, S, F, spec.num_basis, D, panels)
    print(f"[{label}] {S} sims x {n} steps, {blocks} blocks of >= {tiles_per_block} tiles: sums rel "
          f"{e_sums:.2e}, xsums rel {e_xsums:.2e}, pv max|diff| {float(pv_diff.max()):.3e} "
          f"(outside flips {max_ok:.3e}), flipped paths {int(flipped.sum())} = {frac:.2e} "
          f"= {per_decision:.2e} per decision, NPV effect {npv_effect:.2e}{panel_note}; "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({bound_by}), share {bound_ms / ms:.3f}")
    check(per_decision <= FLIP_FRAC_MAX / 10,
          f"{label} flips {per_decision:.2e} per decision > {FLIP_FRAC_MAX / 10}")
    check(npv_effect <= FWD_NPV_RTOL, f"{label} NPV effect {npv_effect:.2e} > {FWD_NPV_RTOL}")
    check(e_sums <= PARTIALS_RTOL and e_xsums <= PARTIALS_RTOL,
          f"{label} sums disagree: sums {e_sums:.2e}, xsums {e_xsums:.2e}")
    # library_ms: no single torch call computes K2's function (a sequential
    # argmax policy over the horizon).
    return dict(max_abs_err=float(pv_diff.max()), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, share=bound_ms / ms, library_ms=None)


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


def _compare_paths(label, coeffs, num_sims, key, antithetic):
    """The path kernel against its plain version on one case, bit for bit;
    returns max |diff|."""
    import torch
    from storage_tpu_torch.models import simulation

    got = simulation._simulate_factor_paths_cuda(coeffs, num_sims, key, antithetic, "cuda")
    ref = simulation.simulate_factor_paths_reference(coeffs, num_sims, key, antithetic, "cuda")
    torch.cuda.synchronize()
    check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
          f"{label}: paths {tuple(got.shape)} not finite or not {tuple(ref.shape)}")
    differ = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
    max_err = float((got - ref).abs().max())
    print(f"[{label}] {tuple(got.shape)}{' antithetic' if antithetic else ''}: {differ} of "
          f"{got.numel()} elements differ from the plain version, max|diff| {max_err:.3e}")
    check(differ == 0, f"{label}: {differ} path elements differ from the plain version")
    return max_err


def phase_path_sim(captured):
    """K3 against its plain version (tolerance: none, every path element bit
    for bit) at the main path's shape for both path-set keys and at a small
    antithetic shape for every factor count; then timed at the main path's."""
    import numpy as np
    from storage_tpu_torch.models import simulation

    max_err = 0.0
    for (coeffs, num_sims, kw), name in zip(captured["sim"], ("regression", "valuation")):
        check(not kw.get("antithetic"), "the main path is not antithetic")
        max_err = max(max_err, _compare_paths(f"K3 path_sim {name} set", coeffs, num_sims,
                                              kw["key"], False))
    rng = np.random.default_rng(SEED)
    for F in (1, 2, 3, 4):
        n = SMALL_PATH_STEPS
        small = simulation.SimCoefficients(
            decay=rng.uniform(0.9, 1.0, (n, F)), chol=np.tril(rng.uniform(-0.2, 0.2, (n, F, F))),
            vols=np.ones((n, F)), log_fwd_drift=np.zeros(n))
        max_err = max(max_err, _compare_paths(f"K3 path_sim F={F}", small, SMALL_PATH_SIMS,
                                              simulation.prng_key(SEED + F), True))
    coeffs, num_sims, kw = captured["sim"][0]
    n, F = coeffs.decay.shape
    ms = cuda_ms(lambda: simulation._simulate_factor_paths_cuda(
        coeffs, num_sims, kw["key"], False, "cuda"), 5)
    plain_ms = cuda_ms(lambda: simulation.simulate_factor_paths_reference(
        coeffs, num_sims, kw["key"], False, "cuda"), 1)
    bound_ms, bound_by = k3_bound(n, num_sims, F, num_sims)
    print(f"[K3 path_sim] {n} steps x {F} factors x {num_sims} sims: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), share {bound_ms / ms:.3f}")
    # library_ms: no single torch call draws threefry normals and runs the OU
    # recursion (torch's generators are Philox and give other numbers).
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, share=bound_ms / ms, library_ms=None)


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
    check(counts["path_sim"] == PATH_SETS,
          f"path kernel ran {counts['path_sim']} times for {PATH_SETS} path sets")
    check(abs(res.intrinsic_npv - REF_INTRINSIC) <= INTRINSIC_ATOL,
          f"intrinsic {res.intrinsic_npv} outside {REF_INTRINSIC} +- {INTRINSIC_ATOL}")
    check(abs(res.npv - REF_NPV) <= NPV_RTOL * REF_NPV,
          f"NPV {res.npv} outside {REF_NPV} +- {NPV_RTOL:.0e}")
    check(abs(res.npv - PORT_NPV) <= PORT_NPV_RTOL * PORT_NPV,
          f"NPV {res.npv} outside the port's record {PORT_NPV} +- {PORT_NPV_RTOL:.0e}")
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
    check(counts == {"backward_update": n_steps - 1, "forward_sim": NUM_SPANS,
                     "path_sim": PATH_SETS}, f"async launches {counts}")
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
    check(counts == {"backward_update": n_steps - 1, "forward_sim": 1, "path_sim": PATH_SETS},
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
        k1_large = phase_backward_large_grid(captured)
        k2 = phase_forward(captured)
        k2_variants = phase_forward_variants(captured)
        k3 = phase_path_sim(captured)
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
             variants={"D5": k1_d5, f"G{LARGE_G}_D{3 + 2 * LARGE_G_EXTRA}": k1_large}),
        dict(name="forward_sim", route="cuda",
             source="storage_tpu_torch/ops/csrc/forward_sim.cu",
             replaces="storage_tpu/ops/pallas_forward.py:96",
             launches=counts["forward_sim"], **k2,
             launches_by_path={p: c["forward_sim"] for p, c in paths.items()},
             variants=k2_variants),
        dict(name="path_sim", route="cuda",
             source="storage_tpu_torch/ops/csrc/path_sim.cu",
             replaces="storage_tpu/models/simulation.py:264 (XLA code, no Pallas kernel)",
             launches=counts["path_sim"], **k3,
             launches_by_path={p: c["path_sim"] for p, c in paths.items()}),
    ]
    print(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
