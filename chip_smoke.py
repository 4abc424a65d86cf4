#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its own line (every failure exits non-zero):

1. device  — a CUDA device must be present; prints ``nvidia-smi``'s name and
   power limit, and the host's memory.
2. build   — compiles the three CUDA kernels from ``storage_tpu_torch/ops/csrc``;
   native — builds the C++ host op (``csrc/storage_host_ops.cpp``, ``g++``
   with the JAX package's flags) and computes the daily and hourly cases'
   valuation contexts through it and through the NumPy reduction: entries
   that differ and their largest gap, both contexts timed, and the hourly
   intrinsic value's DP and float64 sweep timed apart.
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
   (65,536 sims; a grid the first K1 refused), in float32 and in float64,
   and K2's variants:
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
   excel — the Excel facade (``storage_tpu_torch.excel``) on the card: the
   headline case as worksheet ranges through ``create_storage`` and
   ``storage_value_three_factor``, polled through ``subscribe_status`` /
   ``subscribe_progress`` to ``success`` and 1.0, its NPV equal to the async
   phase's bit for bit; the intrinsic, decision-profile, tree and
   intrinsic-tree UDFs against the direct calls and the port on the CPU,
   and four of them at once from four threads against their sequential
   values.  Any ``#ERROR!`` string fails it.
8. options — POLY ratchets with ``extra_decisions=1`` at 1M paths.
9. path_sim_stream — the path kernel's entering state, first step and
   checkpoint mode: spans from ``StreamingFactorSource(every=64)`` against
   the one-launch paths at ``[341, 3, 1M]`` for both keys and antithetic at 1
   to 4 factors, the checkpoint pass against its plain version, ``last()``,
   the refusal of a read across spans, all bit for bit; both variants timed
   at the hourly case's shapes beside their bounds.
10. stream_main — the 1M daily case forced to stream by a path budget of 1e9
   bytes, against the materialised run of phase 5.
11. hourly — the second configuration at full width and depth (the case of
   ``benchmarks/hourly_bench.py``): hourly storage 2021-01-01 -> 2023-01-01,
   17,520 steps, 250,000 antithetic paths, a path budget of 1.5e9 bytes, run
   twice (seed 12 to warm, seed 13 timed); NPV against the port's own record
   and the JAX package's (quantized-route) record, peak device memory and
   launch counts reckoned from the spans; then K1 and K2 against their plain
   versions on launches recorded from the warm-up run (a mid-horizon backward
   launch, a mid-horizon span's forward launch and the tail span's), timed
   there beside their bounds.
12. reprice — ``fit_policy`` on the 1M daily case's regression set, ``save``,
   ``load``, ``reprice`` on the valuation set and on a fresh key.
13. spot_sim — ``MultiFactorSpotSim.simulate`` at 1M x 341 (a martingale
   check against the forward curve).
14. f64_main — the headline case in float64 at 1M paths and the default path
   budget (the path sets stream: 6 spans of 64), run twice with seed 13. The
   first run records what the float64 kernels are held against in phase 15:
   a mid-horizon backward launch, the forward launches of a mid-horizon span
   and of the tail span (both entered with the inventories the spans before
   them left) and both streaming sources. The second is timed: launch counts
   reckoned from the spans, no plain version called, NPV within 1% of the
   float32 record and against the port's float64 record, intrinsic within
   1e-5 of the float32 one.
15. f64_kernels — each float64 kernel against its plain float64 version on
   what phase 14 recorded, timed beside its float64 bound: K1 on the
   backward launch, K2 on the span's and the tail's forward launches; K3 bit
   for bit for both sources in all three modes (one launch at
   ``[341, 3, 1M]`` on its first 64 steps, the checkpoint pass, spans
   resumed from checkpoints against the one launch and a span against the
   plain version), and antithetic at 100,001 x 37 for 1 to 4 factors; the
   checkpoint pass, one span and one whole path set timed.
16. mesh — the headline case over a paths mesh of two shards on the one
   card (``paths_mesh(["cuda:0"] * 2)``): float32 on the materialised route,
   a recording run and a timed one, against phase 5's one-device run (NPV
   within 1e-5, intrinsic equal, peak device memory within 1.1x, launches
   twice phase 5's, no plain version called); float64 at the default path
   budget (streamed per shard) against the float64 record and phase 14's
   run; then K1 and K2 against their plain versions on the last shard's
   recorded launches, and K3's window mode bit for bit against its plain
   version and the one-launch columns: both types, both path sets, the
   checkpoint pass and spans, and antithetic windows across the partners'
   boundary at 1 to 4 factors; the window timed at a shard's shape.
17. tree — the trinomial tree on the card against the port on the CPU: the
   README oracle, the headline storage through a one-factor tree (float32 and
   float64), the intrinsic tree, float64 deltas of 12 monthly contracts.
18. accuracy — ``tools/torch_accuracy_study.py`` at full size: the float64
   tree at G = 500 against float32 LSMC at 262,144 paths for three seeds
   (each |gap| within 1e-3), and float32 against float64 at the same seed.
19. examples — the three ``examples/torch_*.py`` scripts in subprocesses on
   the card, started together, each with its own timeout; the README
   example's printed NPV against an in-process call.
20. precision — ``tools/torch_precision_study.py`` at full size: both
   configurations' float64 path sets drawn once at 1M paths (the path
   kernel's float64 one-launch mode) and valued by ``run_lsmc`` in float64
   and, rounded, in float32 (each |NPV32 / NPV64 - 1| within 1e-3); then the
   float64 kernels against their plain versions on launches of this route
   recorded from a second run: K1 at B = 9 (the constant-rate basis), K2 in
   one launch over the bench configuration's whole horizon, K3's one-launch
   path set over the whole horizon bit for bit.
21. gui — ``examples/torch_storage_gui.py``'s test data at 1M paths through
   the background task its Calculate button starts (``AsyncValuation``,
   per-sim panels on): success, progress ending at 1.0, the NPV equal bit
   for bit to a direct call on the same route; the same run cancelled.
22. notebooks — each ``examples/torch_*.ipynb``'s code cells in order in one
   namespace with ``DEVICE = "cuda"``, read with ``json``; the cells tagged
   ``needs-<module>`` for a module the machine lacks are left out.

``python3 chip_smoke.py --all-cards`` runs phases 1, 2, 5, 14 and the mesh
phase over ``paths_mesh()``, one shard on each visible card.

Prints the kernel table as one JSON line, then the result as the last line:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX.
"""
from __future__ import annotations

import gc
import json
import os
import resource
import subprocess
import sys
import tempfile
import time

NUM_SIMS = 1_000_000
SEED = 13
COMPARE_SIMS = 65_536
CAPTURE_LAUNCH = 170  # the backward launch recorded: a mid-horizon period
D5_TABLE_RTOL = 1e-6  # the recorded D=3 table against one rebuilt from the policy
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
# says which change moved it and by how much (read anew when the float32
# draws took XLA's rounding: 78,377.3750 -> 78,377.4375).
PORT_NPV, PORT_NPV_RTOL = 78_377.4375, 1e-5
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
# float64 outside the tensor cores: half the float32 rate (NVIDIA's data
# sheet: 34 TFLOP/s for the H100 SXM).  A float64 kernel's bound takes this
# peak and 8-byte elements.
PEAK_FP64_FLOPS = 34e12
SMALL_PATH_SIMS, SMALL_PATH_STEPS = 100_001, 37  # the path kernel's antithetic check
LARGE_G, LARGE_G_EXTRA = 700, 1  # the random-input K1 phase: G = 700, D = 5
# Streaming: the variable that sets the path budget (read by the port), the
# span length of the path kernel's stream check, the budget that forces the
# 1M daily case to stream and the bound on its NPV against the materialised
# run (each span solves its latest period directly: float32 regression noise).
MAX_PATH_BYTES_ENV = "STORAGE_TPU_MAX_PATH_BYTES"
STREAM_CHECK_EVERY = 64
STREAM_MAIN_BUDGET, STREAM_NPV_RTOL = 1e9, 1e-4
# The hourly configuration (benchmarks/hourly_bench.py::build_case(2) and its
# call): 2-year hourly storage, 250,000 antithetic paths, seed 12 to warm and
# seed 13 timed, a path budget of 1.5e9 bytes.  The JAX package's record for
# seed 13 (BENCH_hourly_20260819T202508.json) is NPV 152,007, taken on its TPU
# route, which rounds interpolation weights to 1/128 of a grid step.  An hourly
# decision moves the inventory by a seventh of a grid step, so that rounding
# costs policy value, more the longer the horizon.  On the CPU
# (tests/test_torch_hourly.py, the cases marked slow) the JAX package's exact
# route lies above its quantized route by 2.31% at 90 days, 4.68% at 180,
# 6.01% at 365 (2,048 paths each) and 7.43% at the full 730 days (1,024
# paths: exact 161,909.44, quantized 150,707.30), while this port stays
# within 3e-5 of the exact route at every size (161,904.61 at 730 days).  So
# the port's NPV is held to its own record for this case and seed on an H100
# (reruns are bit-identical; see PORT_NPV above for when it is re-read), and
# must lie above the quantized record by what the full-depth CPU pair gave,
# 7.43%, give or take one point for its 1,024 paths.
HOURLY_YEARS, HOURLY_SIMS, HOURLY_BUDGET = 2, 250_000, 1.5e9
HOURLY_PORT_NPV, HOURLY_NPV_RTOL = 163_372.4062, 1e-4  # 163,372.3750 before XLA's float32 rounding
HOURLY_QUANTIZED_NPV, HOURLY_QUANTIZED_BAND = 152_007.0, (0.0643, 0.0843)
HOURLY_BASIS = "1 + x_st + x_sw + x_lt + s + x_st**2 + s**2"
HOURLY_PEAK_BYTES_MAX = 6 * 2**30
HOURLY_CAPTURE_LAUNCH = 8_760  # the backward launch recorded: a mid-horizon period
REPRICE_NPV_RTOL = 1e-6  # a saved and reloaded policy against the whole run
# float64 (the f64_main and f64_kernels phases).  f64_main runs at the
# default path budget (6e9), where the two float64 path sets (8.2 GB each)
# stream; the kernels are held against their plain versions on the launches
# it makes.  Kernel against plain version in float64 (see the kernels' sources): K1 V
# entries within F64_V_TOL of max|V| outside near-tie flips (its fitted
# totals are an FMA chain, torch's a matrix product), at most
# F64_FLIP_FRAC_MAX of them, partials within F64_PARTIALS_RTOL; K2 rounds as
# torch rounds, so per-sim PVs within F64_PV_RTOL, at most F64_FLIP_FRAC_MAX
# / 10 flipped paths per decision, an NPV effect within F64_NPV_RTOL; K3 bit
# for bit.  The float64 NPV draws other paths than the float32 one (float64
# normals consume both hash words), so it agrees with the float32 record
# only to Monte-Carlo and policy error (F64_VS_F32_RTOL); the intrinsic
# value (float64 DP against float32 DP, one float64 sweep) to
# F64_INTRINSIC_RTOL.  PORT_NPV_F64 is the port's float64 record for this
# case and seed on an H100 (its first chip run; re-read it, as PORT_NPV, when
# a change to a kernel's rounding or reduction order moves it), held to
# PORT_NPV_F64_RTOL.
F64_V_TOL, F64_FLIP_FRAC_MAX, F64_PARTIALS_RTOL = 1e-12, 1e-6, 1e-12
F64_PV_RTOL, F64_NPV_RTOL = 1e-12, 1e-12
F64_VS_F32_RTOL, F64_INTRINSIC_RTOL = 1e-2, 1e-5
PORT_NPV_F64, PORT_NPV_F64_RTOL = 78_362.144839, 1e-6
F64_PLAIN_STEPS = 64  # the steps of a one-launch float64 path set held against its plain version
DEFAULT_PATH_BUDGET = 6e9  # the port's (and the JAX package's) default path budget
F64_SOURCES = {"K1": "storage_tpu_torch/ops/csrc/backward_update.cu (float64 instantiation)",
               "K2": "storage_tpu_torch/ops/csrc/forward_sim.cu (float64 instantiation)",
               "K3": "storage_tpu_torch/ops/csrc/path_sim.cu (float64 instantiation)"}
# The tree phase: the README oracle (tests/test_trinomial.py), 24,809.48 within
# 2%; the headline storage through a one-factor tree (spot vol 0.85, mean
# reversion 5.5, daily steps); the intrinsic tree against the intrinsic
# engine within 5e-4 (the tree DP reads its value function at the starting
# inventory, the engine sums the float64 sweep's period PVs: 3.9e-4 apart on
# this case in float64 too); the card against the port on the CPU: NPV
# within TREE_NPV_RTOL per dtype, deltas within TREE_DELTA_TOL of max|delta|.
README_TREE_NPV, README_TREE_RTOL = 24_809.48, 0.02
TREE_MEAN_REVERSION, TREE_INTRINSIC_RTOL = 5.5, 5e-4
TREE_NPV_RTOL = {"float32": 1e-5, "float64": 1e-10}
TREE_DELTA_TOL = 1e-6
# The mesh phase: the headline case over a paths mesh of MESH_SHARDS shards
# on the one card (``--all-cards``: one shard on each card).  Its float32 NPV
# within MESH_NPV_RTOL of the same process's one-device run (the shards'
# partials are added in another order: float32 regression noise), its
# float64 NPV within MESH_F64_NPV_RTOL of the float64 record, intrinsic
# equal, peak device memory (the most on one device) within MESH_PEAK_RATIO
# of the one-device run's.  K3's window mode at the small antithetic shape
# takes MESH_SMALL_WINDOW, a window across the partners' boundary.
MESH_SHARDS = 2
MESH_NPV_RTOL, MESH_F64_NPV_RTOL, MESH_PEAK_RATIO = 1e-5, 1e-9, 1.1
MESH_SMALL_WINDOW = (33_333, 40_000)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# The headline case's inputs (bench.py::build_case, the README example's):
# ratchet tables (inventory, withdraw rate, inject rate) by start date, the
# monthly forward curve from 2021-04 and the zero-rate pillars.
HEADLINE_RATCHETS = [
    ("2021-04-01", [(0.0, -150.0, 250.0), (2000.0, -200.0, 175.0),
                    (5000.0, -260.0, 155.0), (7000.0, -275.0, 132.0)]),
    ("2022-10-01", [(0.0, -130.0, 260.0), (2000.0, -190.0, 190.0),
                    (5000.0, -230.0, 165.0), (7000.0, -245.0, 148.0)]),
]
HEADLINE_MONTHLY_FWD = [
    16.61, 15.68, 15.42, 15.31, 15.27, 15.13, 15.96, 17.22, 17.32, 17.66,
    17.59, 16.81, 15.36, 14.49, 14.28, 14.25, 14.32, 14.33, 15.30, 16.58,
    16.64, 16.79, 16.64, 15.90, 14.63,
]
HEADLINE_RATE_PILLARS = [
    ("2021-04-25", 0.005), ("2021-06-01", 0.006), ("2021-08-01", 0.0072),
    ("2021-12-01", 0.0087), ("2022-04-01", 0.0101), ("2022-12-01", 0.0115),
    ("2023-12-01", 0.0126),
]


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
        ratchets=HEADLINE_RATCHETS,
        ratchet_interp=getattr(pkg.RatchetInterp, ratchet_interp),
    )
    monthly_index = pd.period_range(start="2021-04-25", periods=25, freq="M")
    fwd_curve = pd.Series(HEADLINE_MONTHLY_FWD, index=monthly_index).resample("D").ffill()
    rates = pd.Series([r for _, r in HEADLINE_RATE_PILLARS],
                      index=pd.PeriodIndex(freq="D", data=[d for d, _ in HEADLINE_RATE_PILLARS]))
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


def timed_once(fn):
    """(milliseconds, result) of one call of ``fn`` (CUDA events): for the
    plain versions, whose first call is their comparison as well."""
    import torch

    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


def _bound(nbytes, flops, int_ops=0, itemsize=4):
    """The larger of the times for the bytes and for the operations; float
    operations at the float32 peak, or the float64 one for ``itemsize`` 8."""
    peak_flops = PEAK_FP64_FLOPS if itemsize == 8 else PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(flops / peak_flops, int_ops / PEAK_INT32_OPS) * 1e3  # separate pipes
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(S, G, D, B, F, itemsize=4):
    """(ms, "bytes" or "operations") for one K1 launch: V_next read and V_out
    written once, both factor rows, the table and geometry read once, the
    partials written once; per sim D G (2B + 3) flops for the fitted totals,
    10 G for the winning decision's actual total and its centred value (the
    function needs it once per grid point), and 2 (B+1)(G + B+1) for the
    partials.  ``itemsize`` 8: float64 elements and the float64 peak (j
    stays int32)."""
    B1 = B + 1
    nbytes = (itemsize * (2 * F * S + 2 * G * S + D * G * (B + 2) + D * G + G + B1 * (G + B1))
              + 4 * D * G)
    flops = S * (D * G * (2 * B + 3) + 10 * G + 2 * B1 * (G + B1))
    return _bound(nbytes, flops, itemsize=itemsize)


def k2_bound(n, S, F, B, D, panels, itemsize=4):
    """(ms, "bytes" or "operations") for one K2 launch over n steps: the
    factor paths read once, inventories in and out, PVs out, the panels
    written once when asked for; per sim and step 5B + 2F + 30 flops for the
    spot, design row and rates, D (5(B+1) + 23) for the decisions (the
    interpolated continuation is 5 flops per basis term) and B + 8 for the
    sums.  ``itemsize`` 8: float64 elements and the float64 peak."""
    nbytes = itemsize * (n * F * S + 3 * S + (6 * S * n if panels else 0))
    flops = n * S * (5 * B + 2 * F + 30 + D * (5 * (B + 1) + 23) + B + 8)
    return _bound(nbytes, flops, itemsize=itemsize)


def k3_bound(n, S, F, draw_sims, rows=None, entering_state=False, itemsize=4):
    """(ms, "bytes" or "operations") for one K3 launch over n steps: the
    ``rows`` (default n) states ``[F, S]`` it writes, each once (all n in path
    mode, the checkpoints in checkpoint mode), and the entering state of the
    drawn sims read once when given; per drawn element (n F draw_sims of
    them) 75 integer operations (threefry2x32's 20 rounds of add, rotate and
    xor, 11 key additions and the final xor: 72; the counter and the
    mantissa: 3) and 55 flops (the uniform map 4, -u u 1, XLA's log1p 31 on
    either branch (the rational one: 12 FMA and 7 other operations; the log
    one, Cephes' logf: 9 FMA and 14 others), the Giles polynomial 8 FMA and
    1, the scaling 2; the square root of the tail branch is not counted), and
    per path element (n F S) 2F + 1 flops of the OU update.
    ``itemsize`` 8, the float64 mode: 8-byte states at the float64 peak, and
    85 flops per draw (the uniform map 4, XLA's log1p 34 on its rational
    branch, the 23-term Giles polynomial 47; log and the square root of the
    outer ranges are not counted)."""
    rows = n if rows is None else rows
    draws = n * F * draw_sims
    nbytes = itemsize * (rows * F * S + (F * draw_sims if entering_state else 0))
    per_draw = 85 if itemsize == 8 else 55
    return _bound(nbytes, per_draw * draws + (2 * F + 1) * n * F * S, 75 * draws,
                  itemsize=itemsize)


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
    """One 1M-path valuation recording one backward and the forward launch,
    the path sets, and the backward program's device inputs and policy."""
    import storage_tpu_torch as tt
    from storage_tpu_torch.engines import lsmc

    real = lsmc._backward_program
    programs = []

    def program(*args, **kw):  # its device inputs and what it returns
        programs.append((args[3], real(*args, **kw)))
        return programs[-1][1]

    lsmc._backward_program = program
    try:
        with _recording({"bwd": ("K1", "float32", CAPTURE_LAUNCH),
                         "fwd": ("K2", "float32", 1)}) as rec:
            t0 = time.perf_counter()
            res = value_case(tt, NUM_SIMS, SEED, device="cuda")
            wall = time.perf_counter() - t0
    finally:
        lsmc._backward_program = real
    num_bwd = rec.calls.get(("K1", "float32"), 0)
    check(sorted(rec.recorded) == ["bwd", "fwd"] and rec.calls.get(("K2", "float32")) == 1
          and len(rec.path_sets) == PATH_SETS and len(programs) == 1,
          "capture run did not reach every kernel")
    ((dev, (_, _, coeffs, _, _, vbars)),) = programs
    row = num_bwd - CAPTURE_LAUNCH  # the recorded launch's row of the policy
    print(f"[capture] warm-up valuation {wall:.3f} s, NPV {res.npv:.4f}, "
          f"{num_bwd} backward launches")
    return dict(rec.recorded, sim=rec.path_sets, dev=dev, coeffs=coeffs[row], vbar=vbars[row],
                num_bwd=num_bwd)


def _check_backward(label, args, kw, min_tiles_per_block=1):
    """K1 against its plain version on ``args`` at their full width, then both
    timed there, beside the bound and the partial product alone. Each block
    of the kernel's persistent grid must walk at least ``min_tiles_per_block``
    128-sim tiles, so that the comparison covers the partials it carries from
    one tile to the next.  float64 operands go to the float64 kernel, held
    to the float64 tolerances."""
    import torch
    from storage_tpu_torch.ops import backward, csrc

    (f, fp, v_next, table, vbar, musd, gj, gw, scal) = args
    spec = kw["spec"]
    S, G, D, B, F = v_next.shape[1], v_next.shape[0], table.shape[0], spec.num_basis, f.shape[0]
    f64 = v_next.dtype == torch.float64
    v_tol, flip_max, partials_rtol = ((F64_V_TOL, F64_FLIP_FRAC_MAX, F64_PARTIALS_RTOL) if f64
                                      else (V_TOL, FLIP_FRAC_MAX, PARTIALS_RTOL))
    blocks = backward._persistent_grid(csrc.kernels(), v_next.device, S, D, B, v_next.dtype)
    tiles_per_block = -(-S // 128) // blocks  # the fewest a block walks
    check(tiles_per_block >= min_tiles_per_block,
          f"{label}: {S} sims give {blocks} blocks {tiles_per_block} tiles each, "
          f"fewer than {min_tiles_per_block}")

    def kernel():  # K1 and the reduction of its partials
        v_out, partials = backward._backward_update_cuda(*args, **kw)
        return (v_out, *backward.reduce_partials(partials, G))

    v_k, graw_k, praw_k = kernel()
    v_r, graw_r, praw_r = backward.backward_update_reference(*args, **kw)
    torch.cuda.synchronize()
    scale = float(v_r.abs().max())
    diff = (v_k - v_r).abs()
    flipped = diff > v_tol * scale
    n_flipped = int(flipped.sum())
    frac = n_flipped / flipped.numel()
    max_err = float(diff.max())
    max_ok = float(diff[~flipped].max()) if n_flipped < flipped.numel() else 0.0
    e_graw, e_praw = rel_err(graw_k, graw_r), rel_err(praw_k, praw_r)
    del v_k, v_r, diff, flipped
    ms = cuda_ms(kernel, 20)
    plain_ms = cuda_ms(lambda: backward.backward_update_reference(*args, **kw), 3)
    # The reduction alone as one library call (the port never calls it).
    xr = torch.randn(B + 1, S, device=v_next.device, dtype=v_next.dtype)
    vc_t = (v_next - vbar[:, None]).T
    praw_matmul_ms = cuda_ms(lambda: torch.matmul(xr, vc_t), 20)
    del xr, vc_t
    bound_ms, bound_by = k1_bound(S, G, D, B, F, itemsize=v_next.element_size())
    print(f"[{label}] {S} sims G={G} B={B} D={D}, {blocks} blocks of >= {tiles_per_block} "
          f"tiles: V max|diff| {max_err:.3e} (max|V| {scale:.3e}), outside flips "
          f"{max_ok:.3e}, flipped {n_flipped} = {frac:.2e}; graw rel {e_graw:.2e}, praw rel "
          f"{e_praw:.2e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({bound_by}), share {bound_ms / ms:.3f}; torch.matmul of the partial product "
          f"{praw_matmul_ms:.3f} ms")
    check(frac <= flip_max, f"{label} flipped fraction {frac:.2e} > {flip_max}")
    check(e_graw <= partials_rtol and e_praw <= partials_rtol,
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
    of ``extra_decisions=1`` (D = 5), built as the engine builds them from
    the policy's row of the launch's decision step."""
    import torch
    from storage_tpu_torch.engines import lsmc
    from storage_tpu_torch.ops.ratchets import INTERP_LINEAR

    args = captured["bwd"][0]
    coeffs, vbar_next, dev = captured["coeffs"], captured["vbar"], captured["dev"]
    G = args[2].shape[0]
    period = 1 + captured["num_bwd"] - CAPTURE_LAUNCH  # the launch's decision step
    geometry = [g[0] for g in lsmc._decision_geometry(dev, period, 1, INTERP_LINEAR, G, 0)]
    check(bool((geometry[0] == args[6]).all()) and bool((geometry[1] == args[7]).all()),
          "K1 D=5: the recorded launch's D=3 geometry could not be rebuilt")
    table_err = rel_err(lsmc.decision_table(coeffs, vbar_next, *geometry), args[3])
    check(torch.equal(vbar_next, args[4]) and table_err <= D5_TABLE_RTOL,
          f"K1 D=5: the policy's row does not rebuild the recorded launch's table "
          f"(rel {table_err:.2e})")
    j, w, cost, price = (g[0] for g in lsmc._decision_geometry(dev, period, 1, INTERP_LINEAR,
                                                                G, 1))
    table = lsmc.decision_table(coeffs, vbar_next, j, w, cost, price)
    check(table.shape[0] == 5, f"K1 D=5 table has {table.shape[0]} decisions")
    return args[:3] + (table,) + args[4:6] + (j, w) + args[8:]


def phase_backward_d5(captured):
    return _check_backward("K1 backward_update D=5", d5_args(captured), captured["bwd"][1],
                           min_tiles_per_block=2)


def phase_backward_large_grid(captured, dtype=None):
    """K1 at G = 700, D = 5 (past the PR-1 kernel's shared-memory limit) on
    random inputs at COMPARE_SIMS sims, with the recorded launch's basis:
    decisions move inventory by at most 4 grid points, as on the main path.
    With ``dtype`` float64 the same inputs go to the float64 instantiation."""
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
    if dtype is not None:
        large = tuple(a.to(dtype) if a.is_floating_point() else a for a in large)
    name = "" if dtype is None else f" {str(dtype).split('.')[-1]}"
    return _check_backward(f"K1 backward_update{name} G={G} D={D}", large, kw)


def forward_flips(args, kw, panels=False):
    """K2 against its plain version on ``args``: the near-tie flips and the
    agreement that ``_check_forward`` holds to its bounds.  A path whose PV
    is off by more than its dtype's tolerance took a flipped decision; with
    ``panels`` a path also counts as flipped where any of its volumes differ
    (a flip can leave the PV within the tolerance: the path rejoins, or the
    tie was exact)."""
    import torch
    from storage_tpu_torch.ops import forward

    factors = args[0]
    n, _, S = factors.shape
    pv_rtol = F64_PV_RTOL if factors.dtype == torch.float64 else 1e-4
    kw = dict(kw, panels=None)
    out_k = out_r = None
    if panels:
        out_k = torch.full((n, 6, S), float("nan"), device=factors.device, dtype=factors.dtype)
        out_r = torch.empty_like(out_k)
    s_k, x_k, inv_k, pv_k = forward._forward_sim_cuda(*args, **dict(kw, panels=out_k))
    s_r, x_r, inv_r, pv_r = forward.forward_sim_reference(*args, **dict(kw, panels=out_r))
    torch.cuda.synchronize()
    pv_diff = (pv_k - pv_r).abs()
    flipped = pv_diff > pv_rtol * pv_r.abs().clamp_min(1e-6 * float(pv_r.abs().max()))
    out = dict(e_sums=rel_err(s_k, s_r), e_xsums=rel_err(x_k, x_r),
               pv_max_diff=float(pv_diff.max()))
    if panels:
        vol_k, vol_r = out_k[:, 1], out_r[:, 1]
        flipped |= ((vol_k - vol_r).abs() > PANEL_RTOL * vol_r.abs().max()).any(dim=0)
        out.update(panels_finite=bool(torch.isfinite(out_k).all()),
                   e_panel=max(rel_err(out_k[:, f][:, ~flipped], out_r[:, f][:, ~flipped])
                               for f in range(6)))
    frac = float(flipped.float().mean())
    out.update(
        flipped=int(flipped.sum()), frac=frac, per_decision=frac / n,
        npv_effect=abs(float(pv_k.double().mean() - pv_r.double().mean()))
        / abs(float(pv_r.mean())),
        max_ok=float(pv_diff[~flipped].max()) if bool((~flipped).any()) else 0.0)
    return out


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
    f64 = factors.dtype == torch.float64
    flip_max, npv_rtol, sums_rtol = (
        (F64_FLIP_FRAC_MAX, F64_NPV_RTOL, F64_PARTIALS_RTOL) if f64
        else (FLIP_FRAC_MAX, FWD_NPV_RTOL, PARTIALS_RTOL))
    blocks = forward.grid_blocks(csrc.kernels(), factors.device, spec, S, kw["num_grid"],
                                 spec.num_basis, F, pillars.shape[1], pillars.shape[2], D,
                                 dtype=factors.dtype)
    tiles_per_block = -(-S // forward.TILE_SIMS) // blocks  # the fewest a block walks
    check(tiles_per_block >= min_tiles_per_block,
          f"{label}: {S} sims give {blocks} blocks {tiles_per_block} tiles each, "
          f"fewer than {min_tiles_per_block}")
    fl = forward_flips(args, kw, panels)
    panel_note = ""
    kw = dict(kw, panels=None)
    if panels:
        check(fl["panels_finite"], f"{label}: the kernel left panel entries unwritten")
        panel_note = f", panels outside flips rel {fl['e_panel']:.2e}"
        check(fl["e_panel"] <= PANEL_RTOL,
              f"{label} panels disagree: {fl['e_panel']:.2e} > {PANEL_RTOL}")
        kw = dict(kw, panels=torch.empty((n, 6, S), device=factors.device, dtype=factors.dtype))
    ms = cuda_ms(lambda: forward._forward_sim_cuda(*args, **kw), 5)
    plain_ms = cuda_ms(lambda: forward.forward_sim_reference(*args, **kw), 1)
    bound_ms, bound_by = k2_bound(n, S, F, spec.num_basis, D, panels,
                                  itemsize=factors.element_size())
    print(f"[{label}] {S} sims x {n} steps, {blocks} blocks of >= {tiles_per_block} tiles: sums rel "
          f"{fl['e_sums']:.2e}, xsums rel {fl['e_xsums']:.2e}, pv max|diff| "
          f"{fl['pv_max_diff']:.3e} (outside flips {fl['max_ok']:.3e}), flipped paths "
          f"{fl['flipped']} = {fl['frac']:.2e} = {fl['per_decision']:.2e} per decision, NPV "
          f"effect {fl['npv_effect']:.2e}{panel_note}; kernel {ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms, bound {bound_ms:.3f} ms ({bound_by}), share {bound_ms / ms:.3f}")
    check(fl["per_decision"] <= flip_max / 10,
          f"{label} flips {fl['per_decision']:.2e} per decision > {flip_max / 10}")
    check(fl["npv_effect"] <= npv_rtol, f"{label} NPV effect {fl['npv_effect']:.2e} > {npv_rtol}")
    check(fl["e_sums"] <= sums_rtol and fl["e_xsums"] <= sums_rtol,
          f"{label} sums disagree: sums {fl['e_sums']:.2e}, xsums {fl['e_xsums']:.2e}")
    # library_ms: no single torch call computes K2's function (a sequential
    # argmax policy over the horizon).
    return dict(max_abs_err=fl["pv_max_diff"], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
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


def _compare_paths(label, coeffs, num_sims, key, antithetic, dtype=None, steps=None):
    """The path kernel against its plain version on one case, bit for bit
    (float32, or the float64 mode); with ``steps``, the kernel's one-launch
    paths over the horizon on their first ``steps`` steps. Returns max |diff|."""
    import torch
    from storage_tpu_torch.models import simulation

    dtype = torch.float32 if dtype is None else dtype
    got = simulation._simulate_factor_paths_cuda(coeffs, num_sims, key, antithetic, "cuda", dtype)
    if steps is not None:
        got = got[:steps]
    ref = simulation.simulate_factor_paths_reference(coeffs, num_sims, key, antithetic, "cuda",
                                                     dtype=dtype, num_steps=steps)
    return _paths_agree(label, got, ref, antithetic)


def _paths_agree(label, got, ref, antithetic):
    """``got`` (the kernel's paths) equal to ``ref`` (its plain version's) bit
    for bit; returns max |diff|."""
    import torch

    torch.cuda.synchronize()
    check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
          f"{label}: paths {tuple(got.shape)} not finite or not {tuple(ref.shape)}")
    differ = _bits_differ(got, ref)
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
    for (coeffs, num_sims, key, antithetic, _), name in zip(captured["sim"],
                                                            ("regression", "valuation")):
        check(not antithetic, "the main path is not antithetic")
        max_err = max(max_err, _compare_paths(f"K3 path_sim {name} set", coeffs, num_sims,
                                              key, False))
    rng = np.random.default_rng(SEED)
    for F in (1, 2, 3, 4):
        n = SMALL_PATH_STEPS
        small = simulation.SimCoefficients(
            decay=rng.uniform(0.9, 1.0, (n, F)), chol=np.tril(rng.uniform(-0.2, 0.2, (n, F, F))),
            vols=np.ones((n, F)), log_fwd_drift=np.zeros(n))
        max_err = max(max_err, _compare_paths(f"K3 path_sim F={F}", small, SMALL_PATH_SIMS,
                                              simulation.prng_key(SEED + F), True))
    coeffs, num_sims, key, _, _ = captured["sim"][0]
    n, F = coeffs.decay.shape
    ms = cuda_ms(lambda: simulation._simulate_factor_paths_cuda(
        coeffs, num_sims, key, False, "cuda"), 5)
    plain_ms = cuda_ms(lambda: simulation.simulate_factor_paths_reference(
        coeffs, num_sims, key, False, "cuda"), 1)
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
    return counts, res.npv, res.intrinsic_npv, peak


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
    return counts, res.npv


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


def _bits_differ(a, b):
    import torch

    bits = torch.int64 if a.dtype == torch.float64 else torch.int32
    return int((a.view(bits) != b.view(bits)).sum())


def _check_stream(label, coeffs, num_sims, key, antithetic, every, dtype=None):
    """Spans regenerated from checkpoints against the one-launch paths, the
    checkpoint pass against its plain version, ``last()`` and the refusal of
    a read across spans, in ``dtype`` (default float32): tolerance none,
    every element bit for bit."""
    import torch
    from storage_tpu_torch.models import simulation

    dtype = torch.float32 if dtype is None else dtype
    mono = simulation._simulate_factor_paths_cuda(coeffs, num_sims, key, antithetic, "cuda",
                                                  dtype)
    src = simulation.StreamingFactorSource(coeffs, num_sims, key, antithetic, every=every,
                                           device="cuda", dtype=dtype).prepare()
    spans = src.spans()
    differ = sum(_bits_differ(src.factors(a, b), mono[a:b]) for a, b in spans)
    differ_last = _bits_differ(src.last(), mono[-1])
    del mono
    ckpts = simulation.factor_checkpoints_reference(coeffs, num_sims, key, antithetic,
                                                    src.every, "cuda", dtype)
    differ_ckpt = _bits_differ(src._checkpoints(), ckpts)
    torch.cuda.synchronize()
    try:
        src.factors(spans[0][1] - 1, spans[0][1] + 1)
        refused = len(spans) < 2
    except ValueError:
        refused = True
    n, F = coeffs.decay.shape
    print(f"[{label}] [{n}, {F}, {num_sims}]{' antithetic' if antithetic else ''}, "
          f"{len(spans)} spans of {src.every}: {differ} path elements differ from the one-launch "
          f"paths, {differ_last} of last(), {differ_ckpt} of {ckpts.numel()} checkpoint "
          f"elements from the plain version; cross-span read refused: {refused}")
    check(differ == 0 and differ_last == 0,
          f"{label}: {differ} span elements and {differ_last} of last() differ")
    check(differ_ckpt == 0, f"{label}: {differ_ckpt} checkpoint elements differ")
    check(refused, f"{label}: a read across two spans was not refused")


def phase_path_sim_stream(captured, hourly_coeffs):
    """K3's entering state, first step and checkpoint mode, bit for bit, then
    both variants timed at the hourly case's shapes: the checkpoint pass over
    the whole horizon and one span resumed from a checkpoint."""
    import numpy as np
    from storage_tpu_torch.models import simulation
    from storage_tpu_torch.valuation import _stream_span_length

    for (coeffs, num_sims, key, _, _), name in zip(captured["sim"], ("regression", "valuation")):
        _check_stream(f"K3 stream {name} set", coeffs, num_sims, key, False,
                      STREAM_CHECK_EVERY)
    rng = np.random.default_rng(SEED)
    for F in (1, 2, 3, 4):
        n = SMALL_PATH_STEPS
        small = simulation.SimCoefficients(
            decay=rng.uniform(0.9, 1.0, (n, F)), chol=np.tril(rng.uniform(-0.2, 0.2, (n, F, F))),
            vols=np.ones((n, F)), log_fwd_drift=np.zeros(n))
        _check_stream(f"K3 stream F={F}", small, SMALL_PATH_SIMS,
                      simulation.prng_key(SEED + F), True, 16)

    # Timed at the hourly shapes: [17520 -> 137, 3, 250k] and [128, 3, 250k].
    F = hourly_coeffs.decay.shape[1]
    return _time_stream_modes("K3", hourly_coeffs, HOURLY_SIMS, simulation.prng_key(SEED), True,
                              _stream_span_length(HOURLY_BUDGET, 4 * F * HOURLY_SIMS))


def _time_stream_modes(label, coeffs, num_sims, key, antithetic, every, dtype=None):
    """K3's checkpoint pass over the horizon and one span resumed from the
    middle checkpoint, in ``dtype`` (default float32): each timed beside its
    bound, and against its plain version bit for bit (the plain version's one
    timed call is its comparison)."""
    import torch
    from storage_tpu_torch.models import simulation

    dtype = torch.float32 if dtype is None else dtype
    itemsize = torch.empty((), dtype=dtype).element_size()
    n, F = coeffs.decay.shape
    S, draw = num_sims, (num_sims + 1) // 2 if antithetic else num_sims
    src = simulation.StreamingFactorSource(coeffs, S, key, antithetic, every=every,
                                           device="cuda", dtype=dtype).prepare()
    every, num_ckpt = src.every, len(src.spans())
    tables, ckpts = src._tables_on(src.device), src._checkpoints()
    out_c = torch.empty_like(ckpts)
    ms_c = cuda_ms(lambda: simulation._launch_path_sim(tables, out_c, S, antithetic,
                                                       every=every), 3)
    plain_c, plain = timed_once(lambda: simulation.factor_checkpoints_reference(
        coeffs, S, key, antithetic, every, "cuda", dtype))
    differ, err_c = _bits_differ(out_c, plain), float((out_c - plain).abs().max())
    check(differ == 0, f"{label} checkpoints: {differ} elements differ from the plain version")
    steps_c = (num_ckpt - 1) * every  # the pass stops at the last checkpoint
    bound_c, by_c = k3_bound(steps_c, S, F, draw, rows=num_ckpt, itemsize=itemsize)
    i = num_ckpt // 2
    out_s = torch.empty((every, F, S), device="cuda", dtype=dtype)
    span = dict(y0=ckpts[i], step0=i * every, num_steps=every)
    ms_s = cuda_ms(lambda: simulation._launch_path_sim(tables, out_s, S, antithetic, **span), 20)
    plain_s, plain = timed_once(lambda: simulation.simulate_factor_paths_reference(
        coeffs, S, key, antithetic, "cuda", dtype=dtype, **span))
    differ, err_s = _bits_differ(out_s, plain), float((out_s - plain).abs().max())
    check(differ == 0, f"{label} span: {differ} elements differ from the plain version")
    del plain
    bound_s, by_s = k3_bound(every, S, F, draw, entering_state=True, itemsize=itemsize)
    mode = " antithetic" if antithetic else ""
    print(f"[{label} checkpoints] [{n} -> {num_ckpt}, {F}, {S}]{mode}, every {every}, bit-equal "
          f"to the plain version: kernel {ms_c:.3f} ms, plain {plain_c:.3f} ms, bound "
          f"{bound_c:.3f} ms ({by_c}), share {bound_c / ms_c:.3f}")
    print(f"[{label} span] [{every}, {F}, {S}]{mode} from checkpoint {i}, bit-equal to the plain "
          f"version: kernel {ms_s:.3f} ms, plain {plain_s:.3f} ms, bound {bound_s:.3f} ms "
          f"({by_s}), share {bound_s / ms_s:.3f}")
    return {
        "checkpoints": dict(max_abs_err=err_c, ms=ms_c, plain_ms=plain_c, bound_ms=bound_c,
                            bound_by=by_c, share=bound_c / ms_c, library_ms=None),
        "span": dict(max_abs_err=err_s, ms=ms_s, plain_ms=plain_s, bound_ms=bound_s,
                     bound_by=by_s, share=bound_s / ms_s, library_ms=None),
    }


class _path_budget:
    """The path budget set for one phase, as a user sets it (the port reads
    the variable on each valuation), and put back after it."""

    def __init__(self, nbytes):
        self.value = repr(float(nbytes))

    def __enter__(self):
        self.old = os.environ.get(MAX_PATH_BYTES_ENV)
        os.environ[MAX_PATH_BYTES_ENV] = self.value

    def __exit__(self, *exc):
        if self.old is None:
            del os.environ[MAX_PATH_BYTES_ENV]
        else:
            os.environ[MAX_PATH_BYTES_ENV] = self.old


def _stream_counts(num_sim_steps, num_sims, num_factors, budget, itemsize=4):
    """The launches a streamed valuation must make, reckoned from the source's
    spans (their length from the budget and elements of ``itemsize`` bytes,
    as the JAX package reckons them): K1 once per simulated decision step, K2
    once per span that holds a decision step, K3 one checkpoint pass and one
    launch per span for each path set (``last()`` reads the span the
    one-slot cache holds)."""
    from storage_tpu_torch.valuation import _stream_span_length

    every = -(-_stream_span_length(budget, itemsize * num_factors * num_sims) // 16) * 16
    spans = -(-num_sim_steps // every)
    m = num_sim_steps - 1
    fwd_spans = sum(1 for a in range(0, num_sim_steps, every) if a < m)
    return {"backward_update": m, "forward_sim": fwd_spans,
            "path_sim": PATH_SETS * (1 + spans)}, every, spans


def phase_stream_main(main_npv, main_intrinsic, main_peak):
    """The 1M daily case forced to stream, against the materialised main run."""
    import torch
    import storage_tpu_torch as tt

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tt.reset_launch_counts()
    t0 = time.perf_counter()
    with _path_budget(STREAM_MAIN_BUDGET):
        res = value_case(tt, NUM_SIMS, SEED, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, peak = tt.launch_counts(), torch.cuda.max_memory_allocated()
    n_steps = len(res.expected_profile) - 1
    expected, every, spans = _stream_counts(n_steps, NUM_SIMS, 3, STREAM_MAIN_BUDGET)
    rel = abs(res.npv - main_npv) / abs(main_npv)
    print(f"[stream_main] budget {STREAM_MAIN_BUDGET:.1e} B, {spans} spans of {every}: wall "
          f"{wall:.3f} s, NPV {res.npv:.4f} (materialised {main_npv:.4f}, rel {rel:.2e}), "
          f"intrinsic {res.intrinsic_npv:.4f}, peak device memory {peak / 2**30:.3f} GiB "
          f"(materialised {main_peak / 2**30:.3f}), launches {counts}")
    check(rel <= STREAM_NPV_RTOL, f"streamed NPV {res.npv} vs materialised {main_npv}: {rel:.2e}")
    check(res.intrinsic_npv == main_intrinsic, "streamed intrinsic differs from the main run's")
    check(peak < main_peak, f"streamed peak {peak} not below the materialised {main_peak}")
    check(counts == expected, f"stream_main launches {counts}, expected {expected}")
    return counts


def build_hourly_case(pkg, years=HOURLY_YEARS):
    """The case of ``benchmarks/hourly_bench.py::build_case`` for a package
    with the ``CmdtyStorage``/``RatchetInterp`` API: hourly storage from
    2021-01-01 over ``years`` years and its forward curve."""
    import numpy as np
    import pandas as pd

    end = f"{2021 + years}-01-01"
    storage = pkg.CmdtyStorage(
        freq="h", storage_start="2021-01-01", storage_end=end, injection_cost=0.01,
        withdrawal_cost=0.025,
        ratchets=[("2021-01-01", [(0.0, -150.0 / 24, 250.0 / 24), (2000.0, -200.0 / 24, 175.0 / 24),
                                  (5000.0, -260.0 / 24, 155.0 / 24),
                                  (7000.0, -275.0 / 24, 132.0 / 24)])],
        ratchet_interp=pkg.RatchetInterp.LINEAR)
    idx = pd.period_range("2021-01-01", end, freq="h")
    i = np.arange(len(idx))
    fwd = pd.Series(16.0 + 2.0 * np.sin(2 * np.pi * i / 8760.0)  # seasonal shape
                    + 0.8 * np.sin(2 * np.pi * i / 24.0), index=idx)  # intraday shape
    return storage, fwd


def value_hourly(pkg, num_sims, seed, years=HOURLY_YEARS, **kw):
    """The call of ``benchmarks/hourly_bench.py``."""
    storage, fwd = build_hourly_case(pkg, years)
    return pkg.three_factor_seasonal_value(
        cmdty_storage=storage, val_date="2021-01-01", inventory=1500.0, fwd_curve=fwd,
        interest_rates=0.01, settlement_rule=None, num_sims=num_sims, seed=seed,
        antithetic=True, spot_mean_reversion=91.0, spot_vol=0.85, long_term_vol=0.30,
        seasonal_vol=0.19, basis_funcs=HOURLY_BASIS, discount_deltas=True,
        return_sim_panels=False, **kw)


def hourly_sim_coefficients():
    """The hourly case's simulation coefficients (what the valuation builds)."""
    import storage_tpu_torch as tt
    from storage_tpu_torch.models.multi_factor import (
        build_sim_coefficients, create_3_factor_season_params)
    from storage_tpu_torch.utils.frequencies import to_period

    storage, fwd = build_hourly_case(tt)
    val = to_period("2021-01-01", "h")
    factors, corrs = create_3_factor_season_params("h", 91.0, 0.85, 0.30, 0.19, val, storage.end)
    return build_sim_coefficients(factors, corrs, val, fwd, fwd.index[1:])


def phase_hourly():
    """The hourly configuration at full width and depth, streamed: a warm-up
    run (seed 12), which also records one mid-horizon backward launch, the
    forward launch of a mid-horizon span (entered with the inventories the
    spans before it left) and that of the shorter tail span; the timed run
    (seed 13); then K1 and K2 against their plain versions on the recorded
    launches, and timed there.  Returns the launch counts of the timed run
    and the two kernels' ``hourly`` variants."""
    import numpy as np
    import torch
    import storage_tpu_torch as tt
    from storage_tpu_torch.engines import lsmc

    phases, health = {}, []
    real_health = lsmc._check_forward_health
    n_sim_steps = 8760 * HOURLY_YEARS

    def sink(sw):
        phases.update({p: sw.elapsed(p) for p in sw.PHASES + ("All",)})

    def counted_health(*args):  # raises unless forward and backward NPV are consistent
        real_health(*args)
        health.append(float(args[2]))

    lsmc._check_forward_health = counted_health
    try:
        with _path_budget(HOURLY_BUDGET):
            with _streamed_recording("float32", HOURLY_CAPTURE_LAUNCH, _stream_counts(
                    n_sim_steps, HOURLY_SIMS, 3, HOURLY_BUDGET)[0]["forward_sim"]) as rec:
                t0 = time.perf_counter()
                warm = value_hourly(tt, HOURLY_SIMS, 12, device="cuda")
                torch.cuda.synchronize()
                warm_wall = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            tt.reset_launch_counts()
            t0 = time.perf_counter()
            res = value_hourly(tt, HOURLY_SIMS, SEED, device="cuda", profile_sink=sink)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        lsmc._check_forward_health = real_health
    counts, peak = tt.launch_counts(), torch.cuda.max_memory_allocated()
    n_steps = len(res.expected_profile) - 1
    expected, every, spans = _stream_counts(n_steps, HOURLY_SIMS, 3, HOURLY_BUDGET)
    rel = abs(res.npv - HOURLY_PORT_NPV) / HOURLY_PORT_NPV
    above = res.npv / HOURLY_QUANTIZED_NPV - 1.0
    print(f"[hourly] {HOURLY_SIMS} antithetic paths x {n_steps} hourly steps, budget "
          f"{HOURLY_BUDGET:.1e} B, {spans} spans of {every}: warm-up (seed 12) {warm_wall:.3f} s, "
          f"NPV {warm.npv:.4f}; timed (seed {SEED}) wall {wall:.3f} s; phases "
          + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()))
    print(f"[hourly] NPV {res.npv:.4f} (the port's record {HOURLY_PORT_NPV:.4f}, rel {rel:.2e}; "
          f"{above:+.2%} on the JAX package's quantized-route record "
          f"{HOURLY_QUANTIZED_NPV:.0f}), backward "
          f"NPV {health[-1]:.4f}, intrinsic {res.intrinsic_npv:.4f}, peak device memory "
          f"{peak / 2**30:.3f} GiB, host peak RSS {_host_peak_gib():.3f} GiB, launches {counts}")
    deltas = res.deltas.to_numpy()
    check(n_steps == n_sim_steps, f"hourly case has {n_steps} steps")
    check(np.isfinite(res.npv) and deltas.shape == (n_steps + 1,) and np.isfinite(deltas).all(),
          "hourly NPV or deltas not finite")
    check(np.isfinite(res.expected_profile.to_numpy()).all(), "hourly profile not finite")
    check(res.npv > res.intrinsic_npv, f"hourly NPV {res.npv} <= intrinsic {res.intrinsic_npv}")
    check(len(health) == 2, f"the forward health check ran {len(health)} times in 2 runs")
    check(rel <= HOURLY_NPV_RTOL,
          f"hourly NPV {res.npv} outside the port's record {HOURLY_PORT_NPV} +- {HOURLY_NPV_RTOL}")
    check(HOURLY_QUANTIZED_BAND[0] <= above <= HOURLY_QUANTIZED_BAND[1],
          f"hourly NPV {res.npv} is {above:+.2%} on the quantized record {HOURLY_QUANTIZED_NPV}")
    check(peak < HOURLY_PEAK_BYTES_MAX, f"hourly peak device memory {peak / 2**30:.3f} GiB")
    check(counts == expected, f"hourly launches {counts}, expected {expected}")
    # The kernels at this path's shapes (S = 250,000, the 7-term basis, spans
    # of `every` steps and the tail) against their plain versions, with the
    # flip bounds of the daily case.  A block of either grid walks one or two
    # tiles at this width.
    k1, k2_span, k2_tail = _check_recorded("hourly", rec.recorded, n_steps, every, spans, 1)
    return counts, {"hourly": k1}, {"hourly_span": k2_span, "hourly_tail": k2_tail}


class _recording:
    """While it is open, watch what the engine hands its kernels: count each
    K1 (``lsmc.backward_update``), K2 (``lsmc.forward_sim``) and K3 launch
    by element type in ``calls`` (``{(kernel, dtype): n}``, a path set
    counting as one K3 launch), keep each path set's ``(coeffs, num_sims,
    key, antithetic, every)`` in ``path_sets`` (``every`` None where it is
    drawn whole), and keep in ``recorded[label]`` the launch that
    ``wanted[label] = (kernel, dtype, n)`` names, its kernel's ``n``-th in
    ``dtype``: its operands ``(args, kw)``, copied at call time to ``to``
    (their own device where None), since the backward scan's steps
    overwrite K1's table, ``vbar`` and ``[mu; sd]`` in place (K1's partials
    buffer left out); a path set's first four fields.  Path sets are seen
    where ``draws_from`` (default ``storage_tpu_torch.valuation``) calls
    ``path_sim``: ``simulate_factor_paths``, or ``StreamingFactorSource``
    in a streamed run.  Entered again, it counts on."""

    def __init__(self, wanted, to=None, draws_from=None, path_sim="simulate_factor_paths"):
        self.wanted, self.to, self.draws_from, self.path_sim = wanted, to, draws_from, path_sim
        self.recorded, self.calls, self.path_sets = {}, {}, []

    def __enter__(self):
        import inspect
        from storage_tpu_torch import valuation
        from storage_tpu_torch.engines import lsmc

        self.draws_from = self.draws_from or valuation
        self.real = (lsmc.backward_update, lsmc.forward_sim,
                     getattr(self.draws_from, self.path_sim))
        signature = inspect.signature(self.real[2])

        def note(kernel, dtype, operands):
            key = (kernel, str(dtype).split(".")[-1])
            self.calls[key] = self.calls.get(key, 0) + 1
            for label, want in self.wanted.items():
                if want == (*key, self.calls[key]):
                    self.recorded[label] = operands()

        def launching(kernel, tensor_arg, real):
            def call(*args, **kw):
                note(kernel, args[tensor_arg].dtype, lambda: (
                    tuple(a.to(self.to or a.device, copy=True) for a in args),
                    {k: v for k, v in kw.items() if k != "partials"}))
                return real(*args, **kw)
            return call

        def drawing(*args, **kw):
            out = self.real[2](*args, **kw)
            bound = signature.bind(*args, **kw)
            bound.apply_defaults()
            a = bound.arguments
            path_set = (a["coeffs"], a["num_sims"], a["key"], a["antithetic"],
                        getattr(out, "every", None))
            self.path_sets.append(path_set)
            note("K3", a["dtype"], lambda: path_set[:4])
            return out

        lsmc.backward_update = launching("K1", 2, self.real[0])
        lsmc.forward_sim = launching("K2", 0, self.real[1])
        setattr(self.draws_from, self.path_sim, drawing)
        return self

    def __exit__(self, *exc):
        from storage_tpu_torch.engines import lsmc

        lsmc.backward_update, lsmc.forward_sim = self.real[:2]
        setattr(self.draws_from, self.path_sim, self.real[2])


def _streamed_recording(dtype, backward_launch, fwd_spans):
    """A :class:`_recording` of a streamed run with ``fwd_spans`` forward
    launches, kept on the host: its ``backward_launch``-th K1 launch ("K1"),
    the K2 launch of its middle span ("K2 span", entered with the
    inventories the spans before it left) and of its last ("K2 tail"), and
    its streaming sources."""
    return _recording({"K1": ("K1", dtype, backward_launch),
                       "K2 span": ("K2", dtype, fwd_spans // 2 + 1),
                       "K2 tail": ("K2", dtype, fwd_spans)},
                      to="cpu", path_sim="StreamingFactorSource")


def _first_launches(backward_launch, dtypes=("float32", "float64")):
    """``wanted`` of a :class:`_recording` for each of ``dtypes``: the
    ``backward_launch``-th K1 launch, the first K2 launch and the first path
    set, under ``(kernel, dtype)``."""
    return {(kernel, dtype): (kernel, dtype, n) for dtype in dtypes
            for kernel, n in (("K1", backward_launch), ("K2", 1), ("K3", 1))}


def _check_recorded(label, recorded, n_steps, every, spans, min_tiles_per_block):
    """K1 and K2 against their plain versions on the launches a
    :func:`_streamed_recording` kept, moved back to the card, and timed
    there."""
    check(sorted(recorded) == ["K1", "K2 span", "K2 tail"],
          f"the {label} run recorded {sorted(recorded)}")

    def on_card(name):
        args, kw = recorded.pop(name)
        return tuple(a.cuda() for a in args), kw

    k1 = _check_backward(f"K1 backward_update {label}", *on_card("K1"),
                         min_tiles_per_block=min_tiles_per_block)
    span_args, span_kw = on_card("K2 span")
    inv0 = span_args[1]
    check(span_args[0].shape[0] == every and float(inv0.max() - inv0.min()) > 0.0,
          f"the recorded span has {span_args[0].shape[0]} steps and enters with inventories "
          f"in [{float(inv0.min())}, {float(inv0.max())}]")
    k2_span = _check_forward(f"K2 forward_sim {label} span", span_args, span_kw,
                             min_tiles_per_block=min_tiles_per_block)
    del span_args, inv0
    tail_args, tail_kw = on_card("K2 tail")
    check(tail_args[0].shape[0] == n_steps - 1 - (spans - 1) * every,
          f"the recorded tail span has {tail_args[0].shape[0]} steps")
    k2_tail = _check_forward(f"K2 forward_sim {label} tail", tail_args, tail_kw,
                             min_tiles_per_block=min_tiles_per_block)
    return k1, k2_span, k2_tail


def phase_reprice(main_npv):
    """Fit once, reprice many, on the 1M daily case through the engine-level
    entry points a re-pricing service would call."""
    import numpy as np
    import torch
    import storage_tpu_torch as tt
    from storage_tpu_torch.compile import build_valuation_context
    from storage_tpu_torch.engines.lsmc import LsmcPolicy, fit_policy, reprice
    from storage_tpu_torch.models.multi_factor import (
        build_sim_coefficients, create_3_factor_season_params)
    from storage_tpu_torch.models.simulation import fold_in, prng_key, simulate_factor_paths
    from storage_tpu_torch.ops.regression import basis_spec
    from storage_tpu_torch.utils.basis import THREE_FACTOR_SEASONAL_ALIASES, as_monomials

    storage, fwd_curve, ir_curve, settlement_rule = build_case(tt)
    ctx = build_valuation_context(storage, "2021-04-25", 1500.0, fwd_curve, ir_curve,
                                  settlement_rule, 100, 1e-12)
    factors, corrs = create_3_factor_season_params("D", 91.0, 0.85, 0.30, 0.19, ctx.val_period,
                                                   storage.end)
    coeffs = build_sim_coefficients(factors, corrs, ctx.val_period, fwd_curve,
                                    list(ctx.periods[1:]))
    spec = basis_spec(as_monomials(BASIS, THREE_FACTOR_SEASONAL_ALIASES), num_factors=3)
    reg_key = prng_key(SEED)

    def timed(fn):
        torch.cuda.synchronize()
        tt.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, tt.launch_counts()

    def fit():
        reg = simulate_factor_paths(coeffs, NUM_SIMS, key=reg_key)
        return fit_policy(ctx, reg, coeffs.vols, coeffs.log_fwd_drift, spec)

    def price(policy, key):
        val = simulate_factor_paths(coeffs, NUM_SIMS, key=key)
        return reprice(ctx, policy, val, coeffs.vols, coeffs.log_fwd_drift, spec,
                       discount_deltas=True)

    policy, fit_s, fit_counts = timed(fit)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "policy.npz")
        policy.save(path)
        size = os.path.getsize(path)
        loaded = LsmcPolicy.load(path)
    del policy
    arrays, price_s, price_counts = timed(lambda: price(loaded, fold_in(reg_key, 1)))
    npv = float(arrays.npv)
    pv = arrays.pv_by_sim.double()
    stderr = float(pv.std()) / np.sqrt(NUM_SIMS)
    fresh, fresh_s, _ = timed(lambda: price(loaded, prng_key(SEED + 1000)))
    fresh_npv = float(fresh.npv)
    rel = abs(npv - main_npv) / abs(main_npv)
    n_steps = ctx.n_steps
    print(f"[reprice] fit_policy {fit_s:.3f} s, launches {fit_counts}; policy file "
          f"{size / 2**20:.2f} MiB; reprice {price_s:.3f} s, launches {price_counts}, NPV "
          f"{npv:.4f} (main {main_npv:.4f}, rel {rel:.2e}); fresh key {fresh_s:.3f} s, NPV "
          f"{fresh_npv:.4f} ({abs(fresh_npv - npv) / stderr:.2f} standard errors of {stderr:.4f})")
    check(rel <= REPRICE_NPV_RTOL, f"repriced NPV {npv} vs main {main_npv}: {rel:.2e}")
    check(fit_counts == {"backward_update": n_steps - 1, "forward_sim": 0, "path_sim": 1},
          f"fit_policy launches {fit_counts}")
    check(price_counts == {"backward_update": 0, "forward_sim": 1, "path_sim": 1},
          f"reprice launches {price_counts}")
    check(abs(fresh_npv - npv) <= 4.0 * np.sqrt(2.0) * stderr,
          f"fresh-key NPV {fresh_npv} vs {npv}: more than 4 standard errors of the difference")
    return {k: fit_counts[k] + price_counts[k] for k in fit_counts}


def phase_spot_sim():
    """``MultiFactorSpotSim.simulate`` at the main case's 1M x 341: one launch
    of the path kernel, and the mean spot of each period within 4 standard
    errors of the forward curve (the simulated spot is a martingale)."""
    import numpy as np
    import torch
    import storage_tpu_torch as tt

    storage, fwd_curve, _, _ = build_case(tt)
    periods = fwd_curve.index[(fwd_curve.index > "2021-04-25") & (fwd_curve.index <= storage.end)]
    factors, corrs = tt.create_3_factor_season_params("D", 91.0, 0.85, 0.30, 0.19, "2021-04-25",
                                                      storage.end)
    sim = tt.MultiFactorSpotSim("D", factors, corrs, "2021-04-25", fwd_curve, periods, seed=SEED)
    torch.cuda.synchronize()
    tt.reset_launch_counts()
    t0 = time.perf_counter()
    frame = sim.simulate(NUM_SIMS)
    wall = time.perf_counter() - t0
    counts = tt.launch_counts()
    spots = frame.to_numpy()
    mean = spots.mean(axis=1, dtype=np.float64)
    stderr = spots.std(axis=1, dtype=np.float64) / np.sqrt(NUM_SIMS)
    z = np.abs(mean - fwd_curve[periods].to_numpy()) / stderr
    print(f"[spot_sim] MultiFactorSpotSim.simulate {frame.shape}: wall {wall:.3f} s, launches "
          f"{counts}; mean spot against the forward curve: at most {z.max():.2f} standard "
          f"errors (period {int(z.argmax())})")
    check(frame.shape == (len(periods), NUM_SIMS) == (341, NUM_SIMS) and np.isfinite(spots).all(),
          f"spot frame {frame.shape} not finite or not (341, {NUM_SIMS})")
    check(counts == {"backward_update": 0, "forward_sim": 0, "path_sim": 1},
          f"spot_sim launches {counts}")
    check(z.max() <= 4.0, f"mean spot {z.max():.2f} standard errors from the forward curve")
    return counts


def phase_f64_main(main_npv, main_intrinsic):
    """The headline case at 1M paths in float64 at the default path budget,
    where its path sets (8.2 GB each) stream: a first run (seed 13) recording
    what phase f64_kernels holds the kernels against, then the same run
    timed, its launch counts reckoned from the spans, no plain version
    called.  Returns the timed run's counts, what was recorded, and the span
    length and count."""
    import numpy as np
    import torch
    import storage_tpu_torch as tt
    from storage_tpu_torch.models import simulation
    from storage_tpu_torch.ops import backward, forward

    phases, plain_calls = {}, []

    def sink(sw):
        phases.update({p: sw.elapsed(p) for p in sw.PHASES + ("All",)})

    plain = [(backward, "backward_update_reference"), (forward, "forward_sim_reference"),
             (simulation, "simulate_factor_paths_reference"),
             (simulation, "factor_checkpoints_reference")]
    saved = [getattr(mod, name) for mod, name in plain]

    def counting(name, fn):
        def call(*args, **kw):
            plain_calls.append(name)
            return fn(*args, **kw)
        return call

    n_sim_steps = 341  # bench.py::build_case valued 2021-04-25
    fwd_spans = _stream_counts(n_sim_steps, NUM_SIMS, 3, DEFAULT_PATH_BUDGET,
                               itemsize=8)[0]["forward_sim"]
    for (mod, name), fn in zip(plain, saved):
        setattr(mod, name, counting(name, fn))
    try:
        with _path_budget(DEFAULT_PATH_BUDGET):
            with _streamed_recording("float64", CAPTURE_LAUNCH, fwd_spans) as rec:
                t0 = time.perf_counter()
                first = value_case(tt, NUM_SIMS, SEED, device="cuda", dtype=torch.float64)
                torch.cuda.synchronize()
                first_wall = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            tt.reset_launch_counts()
            t0 = time.perf_counter()
            res = value_case(tt, NUM_SIMS, SEED, device="cuda", dtype=torch.float64,
                             profile_sink=sink)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = tt.launch_counts()
    finally:
        for (mod, name), fn in zip(plain, saved):
            setattr(mod, name, fn)
    peak = torch.cuda.max_memory_allocated()
    n_steps = len(res.expected_profile) - 1
    expected, every, spans = _stream_counts(n_steps, NUM_SIMS, 3, DEFAULT_PATH_BUDGET, itemsize=8)
    gap = res.npv / PORT_NPV - 1.0
    intrinsic_rel = abs(res.intrinsic_npv / main_intrinsic - 1.0)
    print(f"[f64_main] float64, {NUM_SIMS} paths x {n_steps} steps, default budget "
          f"{DEFAULT_PATH_BUDGET:.0e} B: {spans} spans of {every}; recording run {first_wall:.3f} s, "
          f"NPV {first.npv:.6f}; timed run wall {wall:.3f} s; phases "
          + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()))
    print(f"[f64_main] NPV {res.npv:.6f} (float32 record {PORT_NPV:.4f}, gap {gap:+.3e}; this "
          f"run's float32 NPV {main_npv:.4f}; float64 record {PORT_NPV_F64:.6f}), intrinsic "
          f"{res.intrinsic_npv:.6f} (float32 {main_intrinsic:.6f}, rel {intrinsic_rel:.2e}), peak "
          f"device memory {peak / 2**30:.3f} GiB, launches {counts}, plain-version calls "
          f"{len(plain_calls)}")
    deltas = res.deltas.to_numpy()
    check(n_steps == n_sim_steps, f"f64_main case has {n_steps} steps")
    check(np.isfinite(res.npv) and deltas.shape == (n_steps + 1,) and np.isfinite(deltas).all(),
          "f64_main NPV or deltas not finite")
    check(counts == expected, f"f64_main launches {counts}, expected {expected}")
    check(not plain_calls, f"f64_main called plain versions: {sorted(set(plain_calls))}")
    check(abs(gap) <= F64_VS_F32_RTOL, f"float64 NPV {res.npv} is {gap:+.2e} off the float32 "
          f"record {PORT_NPV}")
    check(intrinsic_rel <= F64_INTRINSIC_RTOL,
          f"float64 intrinsic {res.intrinsic_npv} vs float32 {main_intrinsic}: {intrinsic_rel:.2e}")
    for run in (first, res):
        check(abs(run.npv / PORT_NPV_F64 - 1.0) <= PORT_NPV_F64_RTOL,
              f"float64 NPV {run.npv} outside the port's float64 record {PORT_NPV_F64} "
              f"+- {PORT_NPV_F64_RTOL}")
    check(len(rec.path_sets) == PATH_SETS and all(src[4] == every for src in rec.path_sets),
          f"the recording run streamed {len(rec.path_sets)} path sets")
    return counts, rec, every, spans, peak


def phase_f64_kernels(rec, every, spans):
    """The float64 kernels against their plain float64 versions on what
    f64_main's recording run kept, each timed beside its float64 bound: K1 on
    its mid-horizon launch, K2 on the middle span's and the tail's launches;
    K3 bit for bit for both streaming sources (its one launch at
    ``[341, 3, 1M]`` on the first F64_PLAIN_STEPS steps, its checkpoint pass
    over the horizon, its spans resumed from the checkpoints against the one
    launch over the whole horizon), and antithetic at 100,001 sims x 37 steps
    for 1 to 4 factors in all three modes; K3's three modes timed at
    f64_main's shapes. The plain float64 K3 emulates the kernel's fused
    multiply-adds exactly, which makes it about six times slower than the
    separately rounded steps it had, so the one-launch path sets are held on
    their first steps: the checkpoint pass and a span are held against the
    plain version in full, and every span against the one launch."""
    import numpy as np
    import torch
    from storage_tpu_torch.models import simulation

    f64 = torch.float64
    recorded, sources = rec.recorded, rec.path_sets
    check(recorded["K1"][0][2].dtype == f64 and recorded["K2 span"][0][0].dtype == f64,
          "the float64 run recorded operands of another dtype")
    n_steps = sources[0][0].decay.shape[0]
    k1, k2_span, k2_tail = _check_recorded("f64", recorded, n_steps, every, spans, 2)
    max_err = 0.0
    for (coeffs, num_sims, key, antithetic, src_every), name in zip(
            sources, ("regression", "valuation")):
        check(not antithetic, "the main path is not antithetic")
        max_err = max(max_err, _compare_paths(f"K3 path_sim f64 {name} set", coeffs, num_sims,
                                              key, False, f64, steps=F64_PLAIN_STEPS))
        _check_stream(f"K3 stream f64 {name} set", coeffs, num_sims, key, False, src_every, f64)
    rng = np.random.default_rng(SEED)
    for F in (1, 2, 3, 4):
        n = SMALL_PATH_STEPS
        small = simulation.SimCoefficients(
            decay=rng.uniform(0.9, 1.0, (n, F)), chol=np.tril(rng.uniform(-0.2, 0.2, (n, F, F))),
            vols=np.ones((n, F)), log_fwd_drift=np.zeros(n))
        key = simulation.prng_key(SEED + F)
        max_err = max(max_err, _compare_paths(f"K3 path_sim f64 F={F}", small, SMALL_PATH_SIMS,
                                              key, True, f64))
        _check_stream(f"K3 stream f64 F={F}", small, SMALL_PATH_SIMS, key, True, 16, f64)
    coeffs, num_sims, key, _, src_every = sources[0]
    n, F = coeffs.decay.shape
    ms = cuda_ms(lambda: simulation._simulate_factor_paths_cuda(
        coeffs, num_sims, key, False, "cuda", f64), 5)
    plain_ms, _ = timed_once(lambda: simulation.simulate_factor_paths_reference(
        coeffs, num_sims, key, False, "cuda", dtype=f64))
    bound_ms, bound_by = k3_bound(n, num_sims, F, num_sims, itemsize=8)
    print(f"[K3 path_sim f64] {n} steps x {F} factors x {num_sims} sims: kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), share "
          f"{bound_ms / ms:.3f}")
    k3 = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
              bound_by=bound_by, share=bound_ms / ms, library_ms=None)
    modes = _time_stream_modes("K3 f64", coeffs, num_sims, key, False, src_every, f64)
    return ({"f64": k1}, {"f64": k2_span, "f64_tail": k2_tail},
            {"f64": k3, "f64_checkpoints": modes["checkpoints"], "f64_span": modes["span"]})


class _plain_calls:
    """While it is open, count the calls of every kernel's plain version."""

    PLAIN = (("ops.backward", "backward_update_reference"),
             ("ops.forward", "forward_sim_reference"),
             ("models.simulation", "simulate_factor_paths_reference"),
             ("models.simulation", "factor_checkpoints_reference"))

    def __enter__(self):
        import importlib

        self.calls = []
        self.saved = []
        for mod_name, name in self.PLAIN:
            mod = importlib.import_module(f"storage_tpu_torch.{mod_name}")
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def call(*args, _fn=fn, _name=name, **kw):
                self.calls.append(_name)
                return _fn(*args, **kw)
            setattr(mod, name, call)
        return self.calls

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _check_window(label, coeffs, num_sims, key, antithetic, window, dtype=None, steps=None,
                  every=None):
    """K3's window mode against its plain version (the whole block drawn and
    sliced; with ``steps``, on the first ``steps`` steps) and against the same
    columns of the one-launch paths over the whole set, bit for bit; with
    ``every``, also the window's checkpoint pass against its plain version
    and every span resumed from its checkpoints against the one-launch
    columns.  Returns max |diff| against the plain version."""
    import torch
    from storage_tpu_torch.models import simulation

    dtype = torch.float32 if dtype is None else dtype
    a, w = window
    tables = simulation._path_kernel_tables(coeffs, key, "cuda", dtype)
    whole = simulation._simulate_factor_paths_cuda(coeffs, num_sims, key, antithetic, "cuda",
                                                   dtype, tables=tables)
    got = simulation._simulate_factor_paths_cuda(coeffs, num_sims, key, antithetic, "cuda",
                                                 dtype, window=window, tables=tables)
    differ_whole = _bits_differ(got, whole[..., a:a + w].contiguous())
    ref = simulation.simulate_factor_paths_reference(coeffs, num_sims, key, antithetic, "cuda",
                                                     dtype=dtype, num_steps=steps, window=window)
    got_steps = got if steps is None else got[:steps]
    differ_plain = _bits_differ(got_steps, ref)
    max_err = float((got_steps - ref).abs().max())
    del ref, got_steps
    note = ""
    if every:
        n, F = coeffs.decay.shape
        num_ckpt = -(-n // every)
        ckpts = torch.empty((num_ckpt, F, w), dtype=dtype, device="cuda")
        simulation._launch_path_sim(tables, ckpts, num_sims, antithetic, every=every,
                                    window=window)
        plain_ckpts = simulation.factor_checkpoints_reference(
            coeffs, num_sims, key, antithetic, every, "cuda", dtype, window)
        differ_ckpt = _bits_differ(ckpts, plain_ckpts)
        del plain_ckpts
        differ_span = 0
        for i in range(num_ckpt):
            s0, s1 = i * every, min((i + 1) * every, n)
            span = torch.empty((s1 - s0, F, w), dtype=dtype, device="cuda")
            simulation._launch_path_sim(tables, span, num_sims, antithetic, y0=ckpts[i],
                                        step0=s0, num_steps=s1 - s0, window=window)
            differ_span += _bits_differ(span, whole[s0:s1, :, a:a + w].contiguous())
        note = (f"; {differ_ckpt} checkpoint elements from the plain version, {differ_span} "
                f"elements of {num_ckpt} spans from the one-launch columns")
        check(differ_ckpt == 0 and differ_span == 0,
              f"{label}: window checkpoints {differ_ckpt}, spans {differ_span} elements differ")
    torch.cuda.synchronize()
    print(f"[{label}] window [{a}, {a + w}) of {num_sims}{' antithetic' if antithetic else ''}"
          f" {tuple(got.shape)}: {differ_whole} elements differ from the one-launch columns, "
          f"{differ_plain} from the plain version"
          f"{'' if steps is None else f' (first {steps} steps)'}{note}")
    check(differ_whole == 0 and differ_plain == 0,
          f"{label}: window paths differ: {differ_whole} from the one launch, {differ_plain} from "
          "the plain version")
    return max_err


def _time_window(label, coeffs, num_sims, key, window, dtype):
    """K3's window mode timed at one shard's shape, beside its bound."""
    import torch
    from storage_tpu_torch.models import simulation

    n, F = coeffs.decay.shape
    tables = simulation._path_kernel_tables(coeffs, key, "cuda", dtype)
    ms = cuda_ms(lambda: simulation._simulate_factor_paths_cuda(
        coeffs, num_sims, key, False, "cuda", dtype, window=window, tables=tables), 5)
    # The plain window draws the whole block and slices it.
    plain_ms, _ = timed_once(lambda: simulation.simulate_factor_paths_reference(
        coeffs, num_sims, key, False, "cuda", dtype=dtype, window=window))
    itemsize = torch.empty((), dtype=dtype).element_size()
    bound_ms, bound_by = k3_bound(n, window[1], F, window[1], itemsize=itemsize)
    print(f"[{label}] window [{n}, {F}, {window[1]}] of {num_sims} sims: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), share {bound_ms / ms:.3f}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                share=bound_ms / ms, library_ms=None)


def _peak_over(devices):
    import torch

    return max(torch.cuda.max_memory_allocated(d) for d in devices)


def _mesh_run(label, mesh, expected, plain_calls, dtype=None):
    """One timed valuation of the headline case over ``mesh``: wall, phases,
    the peak over its devices, launches against ``expected``, no plain
    version called.  Returns (result, peak, launch counts)."""
    import numpy as np
    import torch
    import storage_tpu_torch as tt

    phases = {}

    def sink(sw):
        phases.update({p: sw.elapsed(p) for p in sw.PHASES + ("All",)})

    devices = sorted(set(mesh.devices), key=str)
    for d in devices:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    tt.reset_launch_counts()
    del plain_calls[:]
    kw = {} if dtype is None else dict(dtype=dtype)
    t0 = time.perf_counter()
    res = value_case(tt, NUM_SIMS, SEED, device="cuda", mesh=mesh, profile_sink=sink, **kw)
    for d in devices:
        torch.cuda.synchronize(d)
    wall = time.perf_counter() - t0
    counts = tt.launch_counts()
    peak = _peak_over(devices)
    print(f"[{label}] {mesh}: wall {wall:.3f} s; phases "
          + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()))
    print(f"[{label}] NPV {res.npv:.6f}, intrinsic {res.intrinsic_npv:.6f}, peak device memory "
          f"{peak / 2**30:.3f} GiB (the most on one of {len(devices)} devices), launches "
          f"{counts}, plain-version calls {len(plain_calls)}")
    check(counts == expected, f"{label} launches {counts}, expected {expected}")
    check(not plain_calls, f"{label} called plain versions: {sorted(set(plain_calls))}")
    check(np.isfinite(res.npv) and np.isfinite(res.deltas.to_numpy()).all(),
          f"{label}: NPV or deltas not finite")
    return res, peak, counts


def phase_mesh(mesh, main, f64_main):
    """The headline case over a paths mesh (by default two shards on the one
    card): float32 on the materialised route (a recording run, then a timed
    one) against this process's one-device run, float64 at the default path
    budget (streamed, so the source runs per shard) against the port's
    float64 record; launches the one-device run's times the shards, no plain
    version called, peak device memory within MESH_PEAK_RATIO of the
    one-device run's. Then K1 and K2 against their plain versions on a
    shard's recorded launches, and K3's window mode (both types, both path
    sets, checkpoints and spans, antithetic) bit for bit."""
    import numpy as np
    import torch
    import storage_tpu_torch as tt
    from storage_tpu_torch.models import simulation

    main_counts, main_npv, main_intrinsic, main_peak = main
    f64_counts, f64_peak = f64_main
    shards = len(mesh.devices)
    times = {k: v * shards for k, v in main_counts.items()}
    times64 = {k: v * shards for k, v in f64_counts.items()}
    shard = shards - 1  # the last shard's launches are held against the plain versions
    with _plain_calls() as plain_calls:
        # The last shard's K1 launch at period launch CAPTURE_LAUNCH (each
        # period launches K1 once a shard, in shard order) and its first K2.
        with _recording({"K1": ("K1", "float32", (CAPTURE_LAUNCH - 1) * shards + shard + 1),
                         "K2": ("K2", "float32", shard + 1)}, to="cpu") as rec:
            t0 = time.perf_counter()
            first = value_case(tt, NUM_SIMS, SEED, device="cuda", mesh=mesh)
            first_wall = time.perf_counter() - t0
        print(f"[mesh] recording run {first_wall:.3f} s, NPV {first.npv:.4f}")
        res, peak, counts = _mesh_run("mesh", mesh, times, plain_calls)
        with _path_budget(DEFAULT_PATH_BUDGET):
            res64, peak64, counts64 = _mesh_run("mesh f64", mesh, times64, plain_calls,
                                                torch.float64)
    rel = abs(res.npv / main_npv - 1.0)
    rel64 = abs(res64.npv / PORT_NPV_F64 - 1.0)
    print(f"[mesh] float32 NPV {res.npv:.4f} against the one-device {main_npv:.4f}: rel "
          f"{rel:.2e}; float64 NPV {res64.npv:.6f} against the record {PORT_NPV_F64:.6f}: rel "
          f"{rel64:.2e}; peaks {peak / 2**30:.3f} / {peak64 / 2**30:.3f} GiB against one device's "
          f"{main_peak / 2**30:.3f} / {f64_peak / 2**30:.3f} GiB")
    check(rel <= MESH_NPV_RTOL, f"mesh float32 NPV {res.npv} vs one device {main_npv}: {rel:.2e}")
    check(first.npv == res.npv, f"mesh reruns differ: {first.npv} and {res.npv}")
    check(rel64 <= MESH_F64_NPV_RTOL,
          f"mesh float64 NPV {res64.npv} vs the record {PORT_NPV_F64}: {rel64:.2e}")
    check(res.intrinsic_npv == main_intrinsic,
          f"mesh intrinsic {res.intrinsic_npv} vs one device {main_intrinsic}")
    check(peak <= MESH_PEAK_RATIO * main_peak and peak64 <= MESH_PEAK_RATIO * f64_peak,
          f"mesh peaks {peak} / {peak64} B against one device's {main_peak} / {f64_peak} B")
    recorded = rec.recorded
    check(sorted(recorded) == ["K1", "K2"] and len(rec.path_sets) == PATH_SETS,
          f"the mesh recording run kept {sorted(recorded)} and {len(rec.path_sets)} path sets")

    def on_card(name):
        args, kw = recorded.pop(name)
        return tuple(a.cuda() for a in args), kw

    k1_args, k1_kw = on_card("K1")
    check(k1_args[2].shape[1] == NUM_SIMS // shards,
          f"the recorded K1 launch has {k1_args[2].shape[1]} sims")
    k1 = _check_backward(f"K1 backward_update mesh shard {shard}", k1_args, k1_kw)
    del k1_args
    k2 = _check_forward(f"K2 forward_sim mesh shard {shard}", *on_card("K2"),
                        min_tiles_per_block=1)
    windows = mesh.windows(NUM_SIMS)
    window = windows[shard]
    max_err = 0.0
    for (coeffs, num_sims, key, antithetic, _), name in zip(rec.path_sets,
                                                            ("regression", "valuation")):
        for dtype in (torch.float32, torch.float64):
            tag = "" if dtype == torch.float32 else " f64"
            f64 = dtype == torch.float64
            max_err = max(max_err, _check_window(
                f"K3 window{tag} {name} set", coeffs, num_sims, key, antithetic, window, dtype,
                steps=F64_PLAIN_STEPS if f64 else None,
                every=STREAM_CHECK_EVERY if name == "regression" else None))
    rng = np.random.default_rng(SEED)
    for F in (1, 2, 3, 4):
        n = SMALL_PATH_STEPS
        small = simulation.SimCoefficients(
            decay=rng.uniform(0.9, 1.0, (n, F)), chol=np.tril(rng.uniform(-0.2, 0.2, (n, F, F))),
            vols=np.ones((n, F)), log_fwd_drift=np.zeros(n))
        # A window across the antithetic partners' boundary (sim 50,001).
        for dtype in (torch.float32, torch.float64):
            tag = "" if dtype == torch.float32 else " f64"
            max_err = max(max_err, _check_window(
                f"K3 window{tag} F={F}", small, SMALL_PATH_SIMS, simulation.prng_key(SEED + F),
                True, MESH_SMALL_WINDOW, dtype, every=16))
    coeffs, num_sims, key, _, _ = rec.path_sets[0]
    k3 = dict(_time_window("K3 window", coeffs, num_sims, key, window, torch.float32),
              max_abs_err=max_err)
    k3_f64 = dict(_time_window("K3 window f64", coeffs, num_sims, key, window, torch.float64),
                  max_abs_err=max_err)
    return counts, counts64, {"mesh_shard": k1}, {"mesh_shard": k2}, \
        {"window": k3, "f64_window": k3_f64}


def readme_tree_case(pkg):
    """The README ratcheted storage and curves of ``tests/test_trinomial.py``
    (README.md:238-303, 448-452), valued 2019-09-15 at inventory 50."""
    import numpy as np
    import pandas as pd

    storage = pkg.CmdtyStorage(
        freq="D", storage_start="2019-09-01", storage_end="2019-10-01",
        injection_cost=0.48, withdrawal_cost=0.74,
        ratchets=[
            ("2019-09-01", [(0.0, -44.85, 56.8), (100.0, -45.01, 54.5), (300.0, -45.78, 52.01),
                            (600.0, -46.17, 51.9), (800.0, -46.99, 50.8),
                            (1000.0, -47.12, 50.01)]),
            ("2019-09-20", [(0.0, -31.41, 48.33), (100.0, -31.85, 43.05),
                            (300.0, -31.68, 41.22), (600.0, -32.78, 40.08),
                            (800.0, -33.05, 39.74), (1000.0, -34.8, 38.51)]),
        ],
        ratchet_interp=pkg.RatchetInterp.LINEAR)
    idx = pd.period_range("2019-09-15", "2019-10-01", freq="D")
    fwd = pd.Series(np.where(idx < pd.Period("2019-09-23", "D"), 56.6, 56.6 + 87.81), index=idx)
    vols = pd.Series([0.975, 0.97, 0.96, 0.91, 0.89, 0.895, 0.891, 0.89, 0.875, 0.872, 0.871,
                      0.870, 0.869, 0.868, 0.867, 0.866, 0.8655], index=idx)
    return dict(cmdty_storage=storage, val_date="2019-09-15", inventory=50.0, forward_curve=fwd,
                spot_volatility=vols, mean_reversion=5.5, time_step=1 / 365.0,
                interest_rates=0.025, settlement_rule=lambda p: pd.Period("2019-10-20", "D"),
                num_inventory_grid_points=112)


def phase_tree(main_intrinsic):
    """The trinomial-tree engine on the card against the port on the CPU:
    the README oracle, the headline storage through a one-factor tree in
    float32 and float64, the intrinsic tree, and float64 deltas of the
    headline storage's monthly contracts.  The tree DP is torch ops (the
    JAX package has no kernel for it): no kernel launches."""
    import numpy as np
    import pandas as pd
    import torch
    import storage_tpu_torch as tt
    from storage_tpu_torch.compile import build_valuation_context
    from storage_tpu_torch.engines import tree
    from storage_tpu_torch.models.trinomial import build_trinomial_tree

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    tt.reset_launch_counts()
    readme = {}
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        for device in ("cuda", "cpu"):
            readme[name, device] = tt.trinomial_value(**readme_tree_case(tt), dtype=dtype,
                                                      device=device)
    storage, fwd_curve, ir_curve, settlement_rule = build_case(tt)
    ctx = build_valuation_context(storage, "2021-04-25", 1500.0, fwd_curve, ir_curve,
                                  settlement_rule, 100, 1e-12)
    vols = pd.Series(0.85, index=fwd_curve.index)
    headline_tree = build_trinomial_tree(ctx.fwd, vols.reindex(ctx.periods).to_numpy(),
                                         TREE_MEAN_REVERSION, 1 / 365.0)
    K = headline_tree.num_levels
    headline, seconds = {}, {}
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        for device in ("cuda", "cpu"):
            tree_value = (lambda dt=dtype, dv=device: tree.tree_value(
                ctx, headline_tree, dtype=dt, device=dv))
            tree_value()  # warm
            res, seconds[name, device] = timed(tree_value)
            headline[name, device] = res.npv
    intrinsic_tree, seconds["intrinsic_tree"] = timed(lambda: tt.intrinsic_tree_value(
        storage, "2021-04-25", 1500.0, fwd_curve, ir_curve, settlement_rule, device="cuda"))
    contracts = list(pd.period_range("2021-04", "2022-03", freq="M"))

    def deltas(device):
        return np.array(tt.trinomial_deltas(
            storage, "2021-04-25", 1500.0, fwd_curve, vols, TREE_MEAN_REVERSION, 1 / 365.0,
            ir_curve, settlement_rule, contracts, device=device))

    card_deltas, seconds["deltas", "cuda"] = timed(lambda: deltas("cuda"))
    cpu_deltas, seconds["deltas", "cpu"] = timed(lambda: deltas("cpu"))
    counts = tt.launch_counts()
    delta_err = float(np.abs(card_deltas - cpu_deltas).max() / np.abs(cpu_deltas).max())
    intrinsic_rel = intrinsic_tree / main_intrinsic - 1.0
    print(f"[tree] README oracle: float32 card {readme['float32', 'cuda']:.4f} / cpu "
          f"{readme['float32', 'cpu']:.4f}, float64 card {readme['float64', 'cuda']:.6f} / cpu "
          f"{readme['float64', 'cpu']:.6f} (reference {README_TREE_NPV})")
    print(f"[tree] headline storage, {ctx.n_steps} steps, G = {ctx.num_grid_points}, one-factor "
          f"tree of K = {K} levels (spot vol 0.85, mean reversion {TREE_MEAN_REVERSION}): float32 "
          f"card {headline['float32', 'cuda']:.4f} in {seconds['float32', 'cuda']:.3f} s, cpu "
          f"{headline['float32', 'cpu']:.4f} in {seconds['float32', 'cpu']:.3f} s; float64 card "
          f"{headline['float64', 'cuda']:.6f} in {seconds['float64', 'cuda']:.3f} s, cpu "
          f"{headline['float64', 'cpu']:.6f} in {seconds['float64', 'cpu']:.3f} s")
    print(f"[tree] intrinsic tree {intrinsic_tree:.4f} in {seconds['intrinsic_tree']:.3f} s "
          f"against intrinsic_value {main_intrinsic:.4f} (rel {intrinsic_rel:+.2e}); float64 "
          f"deltas of {len(contracts)} monthly contracts: card {seconds['deltas', 'cuda']:.3f} s, "
          f"cpu {seconds['deltas', 'cpu']:.3f} s, card against cpu {delta_err:.2e} of max|delta| "
          f"({np.round(card_deltas, 3).tolist()}); launches {counts}")
    for name in ("float32", "float64"):
        rtol = TREE_NPV_RTOL[name]
        for label, vals in (("README", readme), ("headline", headline)):
            rel = abs(vals[name, "cuda"] / vals[name, "cpu"] - 1.0)
            check(rel <= rtol, f"tree {label} {name}: card against cpu {rel:.2e} > {rtol}")
        check(abs(readme[name, "cuda"] / README_TREE_NPV - 1.0) <= README_TREE_RTOL,
              f"README tree NPV {readme[name, 'cuda']} outside {README_TREE_NPV} "
              f"+- {README_TREE_RTOL:.0%}")
    check(abs(intrinsic_rel) <= TREE_INTRINSIC_RTOL,
          f"intrinsic tree {intrinsic_tree} vs intrinsic_value {main_intrinsic}")
    check(np.isfinite(card_deltas).all() and delta_err <= TREE_DELTA_TOL,
          f"tree deltas card against cpu {delta_err:.2e} > {TREE_DELTA_TOL}")
    check(all(v == 0 for v in counts.values()), f"the tree launched kernels: {counts}")
    return counts


def _inventory_space_gap(a, b):
    """(entries that differ, largest absolute gap) of two inventory spaces."""
    import numpy as np

    pairs = ((a.min_inventory, b.min_inventory), (a.max_inventory, b.max_inventory))
    return (sum(int((x != y).sum()) for x, y in pairs),
            max(float(np.abs(x - y).max()) for x, y in pairs))


def _inventory_space(ctx, use_native):
    """``ctx``'s inventory space computed anew through the C++ host op or the
    NumPy reduction, from the inputs ``build_valuation_context`` gives it."""
    from storage_tpu_torch.ops.inventory_space import calculate_inventory_space

    storage = ctx.storage
    offset = (ctx.periods[0] - storage.start).n
    return calculate_inventory_space(
        storage.pillar_tables[offset:], storage.interp_kind,
        storage.min_inventory_by_step[offset:], storage.max_inventory_by_step[offset:],
        storage.inventory_loss_by_step[offset:], float(ctx.inventory),
        storage.must_be_empty_at_end, use_native, storage.numerical_tolerance)


def phase_native():
    """The C++ host op (``csrc/storage_host_ops.cpp``, built with ``g++`` from
    the checkout, outside every timed phase): the daily and hourly cases'
    valuation contexts built on the default route, their inventory spaces
    computed anew through the C++ op and through the NumPy reduction,
    compared and timed, and the hourly intrinsic value's two parts (the DP on
    the card, the float64 sweep on the host) timed."""
    import numpy as np
    import torch
    import storage_tpu_torch as tt
    from storage_tpu_torch import native
    from storage_tpu_torch.compile import build_valuation_context
    from storage_tpu_torch.engines import intrinsic

    t0 = time.perf_counter()
    loaded = native.native_available()
    load_s = time.perf_counter() - t0
    check(loaded, "the native inventory-space library did not load (no g++, or the build failed)")

    def timed(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t

    storage, fwd_curve, ir_curve, settlement_rule = build_case(tt)
    hourly_storage, hourly_fwd = build_hourly_case(tt)
    cases = {"daily": (storage, "2021-04-25", 1500.0, fwd_curve, ir_curve, settlement_rule,
                       100, 1e-12),
             "hourly": (hourly_storage, "2021-01-01", 1500.0, hourly_fwd, 0.01, None, 100,
                        1e-12)}
    lines, contexts = [], {}
    for label, args in cases.items():
        build_valuation_context(*args)  # warm: first calls of the pandas paths
        ctx, ctx_s = timed(build_valuation_context, *args)
        fast, fast_s = timed(_inventory_space, ctx, True)
        slow, slow_s = timed(_inventory_space, ctx, False)
        differ, gap = _inventory_space_gap(fast, slow)
        scale = float(np.abs(fast.max_inventory).max())
        lines.append(f"{label}: {differ} of {2 * (ctx.n_steps + 1)} entries differ, largest "
                     f"gap {gap:.3e}; reachability {fast_s:.3f} s (C++) against {slow_s:.3f} s "
                     f"(NumPy); build_valuation_context {ctx_s:.3f} s")
        check(_inventory_space_gap(fast, ctx.inv_space)[0] == 0,
              f"{label}: the context's inventory space is not the C++ op's")
        check(gap <= 1e-12 * scale, f"{label}: C++ and NumPy inventory spaces {gap:.3e} apart")
        contexts[label] = ctx, ctx_s
    ctx, compile_s = contexts["hourly"]
    terminal = np.zeros_like(ctx.grids[ctx.n_steps])
    intrinsic._backward_values(ctx, terminal, 0, "cuda")  # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    values = intrinsic._backward_values(ctx, terminal, 0, "cuda")
    torch.cuda.synchronize()
    dp_s = time.perf_counter() - t
    t = time.perf_counter()
    intrinsic._forward_sweep(ctx, np.asarray(values, dtype=np.float64))
    sweep_s = time.perf_counter() - t
    print(f"[native] {native.library_path().name} loaded in {load_s:.3f} s "
          f"(g++ {' '.join(native.GXX_FLAGS)}); " + "; ".join(lines))
    print(f"[native] hourly host parts: compile {compile_s:.3f} s, "
          f"intrinsic DP {dp_s:.3f} s (card), float64 sweep {sweep_s:.3f} s (host)")


EXCEL_SETTLE_MONTHS = 25  # the settlement table: 2021-04 .. 2023-04
EXCEL_CONCURRENT = 4


def excel_ranges():
    """The headline case as worksheet ranges: the ratchets (both date groups,
    withdraw rates positive), the daily forward curve, the rate pillars and
    the settlement table (each month to the 20th of the next)."""
    import pandas as pd
    import storage_tpu_torch as tt

    _, fwd_curve, _, _ = build_case(tt)
    ratchets = [[date, inv, inject, -withdraw]
                for date, table in HEADLINE_RATCHETS for inv, withdraw, inject in table]
    months = pd.period_range("2021-04", periods=EXCEL_SETTLE_MONTHS, freq="M")
    settle = [[str(m), str(m.asfreq("D", "end") + 20)] for m in months]
    return dict(ratchets=ratchets,
                fwd=[[str(p), float(v)] for p, v in fwd_curve.items()],
                rates=[[d, r] for d, r in HEADLINE_RATE_PILLARS],
                settle=settle,
                vols=[[str(p), 0.85] for p in fwd_curve.index])


def phase_excel(async_npv, async_counts, main_intrinsic):
    """The Excel facade on the card: the headline case passed in as worksheet
    ranges through ``create_storage`` and ``storage_value_three_factor``
    (``AsyncValuation``, panels on: the async phase's route), polled through
    the subscription UDFs; then the synchronous UDFs on the card against the
    direct calls and the port on the CPU, and four of them at once from four
    threads against their sequential values."""
    from concurrent.futures import ThreadPoolExecutor
    import torch
    import storage_tpu_torch as tt
    from storage_tpu_torch import excel

    r = excel_ranges()
    # Each tolerance at its API default: the storage's 1e-9, the valuation's
    # 1e-12 (a blank cell would give the add-in's 1e-10 to both).
    handle = excel.create_storage("xl_headline", "2021-04-01", "2022-04-01", r["ratchets"],
                                  "PiecewiseLinear", 0.01, 0.0, 0.025, 0.0,
                                  numerical_tolerance=1e-9)
    check(handle == "xl_headline", f"create_storage returned {handle!r}")
    torch.cuda.synchronize()
    tt.reset_launch_counts()
    t0 = time.perf_counter()
    name = excel.storage_value_three_factor(
        "xl_calc", "xl_headline", "2021-04-25", 1500.0, r["fwd"], r["rates"],
        spot_vol=0.85, spot_mean_reversion=91.0, long_term_vol=0.30, seasonal_vol=0.19,
        discount_deltas=True, settle_dates=r["settle"], num_sims=NUM_SIMS,
        basis_functions=BASIS, seed=SEED, num_grid_points=100, numerical_tolerance=1e-12,
        device="cuda")
    check(name == "xl_calc", f"storage_value_three_factor returned {name!r}")
    statuses, progress = [], []
    while True:
        status, value = excel.subscribe_status(name), excel.subscribe_progress(name)
        check(not str(status).startswith("#") and not str(value).startswith("#"),
              f"subscription UDFs returned {status!r} / {value!r}")
        if not statuses or statuses[-1] != status:
            statuses.append(status)
        if not progress or progress[-1] != value:
            progress.append(value)
        if status not in ("pending", "running"):
            break
        time.sleep(0.02)
    wall = time.perf_counter() - t0
    npv = excel.subscribe_result_property(name, "npv")
    torch.cuda.synchronize()
    counts = tt.launch_counts()
    excel.calc_cache.remove(name)  # the result holds ~22 GB of panels on the host
    gc.collect()
    print(f"[excel] storage_value_three_factor ({NUM_SIMS} paths, panels on): statuses "
          f"{statuses}, {len(progress)} progress values read ({progress[:3]} ... "
          f"{progress[-2:]}), wall {wall:.3f} s to the last status; NPV {npv} (async phase "
          f"{async_npv}); launches {counts}")
    check(statuses[-1] == "success", f"excel calc ended {statuses[-1]!r}")
    check(progress[-1] == 1.0 and all(b >= a for a, b in zip(progress, progress[1:])),
          f"excel progress {progress}")
    check(isinstance(npv, float) and npv == async_npv,
          f"excel NPV {npv!r} differs from the async phase's {async_npv!r}")
    check(counts == async_counts, f"excel launches {counts}, async {async_counts}")

    storage, fwd_curve, ir_curve, settlement_rule = build_case(tt)
    common = ("2021-04-25", "2021-04-01", "2022-04-01", r["ratchets"], "PiecewiseLinear",
              0.01, 0.0, 0.025, 0.0, 1500.0, r["fwd"])
    tail = dict(num_grid_points=100, numerical_tolerance=1e-12)
    calls = {
        "intrinsic": lambda dv: excel.storage_intrinsic_value(
            *common, r["rates"], **tail, device=dv),
        "profile": lambda dv: excel.storage_intrinsic_decision_profile(
            *common, r["rates"], **tail, device=dv),
        "tree": lambda dv: excel.storage_value_trinomial_tree(
            *common, r["vols"], TREE_MEAN_REVERSION, r["rates"], **tail, device=dv),
        "intrinsic_tree": lambda dv: excel.storage_value_intrinsic(
            *common, r["rates"], **tail, device=dv),
    }
    seconds, card, cpu = {}, {}, {}
    for label, call in calls.items():
        call("cuda")  # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        card[label] = call("cuda")
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t
        cpu[label] = call("cpu")
        for out in (card[label], cpu[label]):
            check(not (isinstance(out, str) and out.startswith("#")), f"excel {label}: {out}")
    with ThreadPoolExecutor(max_workers=EXCEL_CONCURRENT) as pool:
        futures = {label: pool.submit(call, "cuda") for label, call in calls.items()}
        concurrent = {label: f.result() for label, f in futures.items()}
    direct = tt.intrinsic_value(storage, "2021-04-25", 1500.0, fwd_curve, ir_curve, None,
                                100, 1e-12, device="cuda")
    settled = tt.intrinsic_value(storage, "2021-04-25", 1500.0, fwd_curve, ir_curve,
                                 settlement_rule, 100, 1e-12, device="cuda")
    profile = direct.profile
    direct_table = [[period.start_time.to_pydatetime(),
                     float(profile["inject_withdraw_volume"].iloc[i]),
                     float(profile["cmdty_consumed"].iloc[i])]
                    for i, period in enumerate(profile.index)]
    tree_rel = abs(card["tree"] / cpu["tree"] - 1.0)
    itree_rel = abs(card["intrinsic_tree"] / cpu["intrinsic_tree"] - 1.0)
    print(f"[excel] sync UDFs on the card: intrinsic {card['intrinsic']!r} (direct call "
          f"{direct.npv!r}; settled as the main phase {settled.npv!r}), decision profile "
          f"{len(card['profile'])} rows, tree {card['tree']:.4f} (cpu {cpu['tree']:.4f}, rel "
          f"{tree_rel:.2e}), intrinsic tree {card['intrinsic_tree']:.4f} (cpu "
          f"{cpu['intrinsic_tree']:.4f}, rel {itree_rel:.2e}); seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
          + f"; {EXCEL_CONCURRENT} threads at once equal to sequential: "
          f"{all(concurrent[k] == card[k] for k in calls)}")
    check(card["intrinsic"] == direct.npv,
          f"excel intrinsic {card['intrinsic']} != direct {direct.npv}")
    check(card["profile"] == direct_table, "excel decision profile differs from the direct call's")
    check(settled.npv == main_intrinsic,
          f"intrinsic_value settled as the main phase {settled.npv} != its {main_intrinsic}")
    check(tree_rel <= TREE_NPV_RTOL["float32"], f"excel tree card against cpu {tree_rel:.2e}")
    check(itree_rel <= TREE_NPV_RTOL["float32"],
          f"excel intrinsic tree card against cpu {itree_rel:.2e}")
    for label in calls:
        check(concurrent[label] == card[label],
              f"excel {label} from {EXCEL_CONCURRENT} threads differs from its sequential value")
    return counts



def _tool(name):
    """A module of ``tools/``."""
    import importlib

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    return importlib.import_module(name)


ACCURACY_GAP_MAX = 1e-3  # the study's own criterion, per seed
ACCURACY_CAPTURE_LAUNCH = 29  # the backward launch recorded: mid-horizon of 58


def _check_path_set(label, coeffs, num_sims, key, antithetic, dtype, plain_once=False):
    """K3 against its plain version on one path set, bit for bit, then both
    timed there beside the bound.  With ``plain_once`` the plain version runs
    once, timed and compared (the float64 one, which emulates the kernel's
    fused multiply-adds, takes ~13 s at ``[341, 3, 1M]``)."""
    import torch
    from storage_tpu_torch.models import simulation

    def plain():
        return simulation.simulate_factor_paths_reference(coeffs, num_sims, key, antithetic,
                                                          "cuda", dtype=dtype)

    if plain_once:
        plain_ms, ref = timed_once(plain)
        max_err = _paths_agree(label, simulation._simulate_factor_paths_cuda(
            coeffs, num_sims, key, antithetic, "cuda", dtype), ref, antithetic)
        del ref
    else:
        max_err = _compare_paths(label, coeffs, num_sims, key, antithetic, dtype)
        plain_ms = cuda_ms(plain, 1)
    n, F = coeffs.decay.shape
    ms = cuda_ms(lambda: simulation._simulate_factor_paths_cuda(
        coeffs, num_sims, key, antithetic, "cuda", dtype), 5)
    bound_ms, bound_by = k3_bound(n, num_sims, F, num_sims // 2 if antithetic else num_sims,
                                  itemsize=torch.empty((), dtype=dtype).element_size())
    print(f"[{label}] {n} steps x {F} factors x {num_sims} sims: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), share {bound_ms / ms:.3f}")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, share=bound_ms / ms, library_ms=None)


def phase_accuracy():
    """``tools/torch_accuracy_study.py`` at full size on the card: the float64
    tree at G = 500, float32 LSMC at 262,144 paths for seeds 11 / 23 / 47
    (K1 at G = 500), and the float32-against-float64 drift on seed 11 at the
    full path count.  Then each kernel against its plain version, in both
    element types, on the launches the study made (the one-factor quartic
    basis at G = 500): K1 on the first valuation's mid-horizon launch, K2 on
    its forward pass, K3 bit for bit on its first path set.  Returns the
    study's launch counts and, per kernel, the variants with their launches
    in the study by element type."""
    import math
    import torch
    import storage_tpu_torch as tt

    study = _tool("torch_accuracy_study")
    tt.reset_launch_counts()
    t0 = time.perf_counter()
    with _recording(_first_launches(ACCURACY_CAPTURE_LAUNCH)) as rec:
        line = study.run_study(study.NUM_SIMS, study.SEEDS, "cuda")
    wall = time.perf_counter() - t0
    counts = tt.launch_counts()
    per_seed = ", ".join(f"seed {k}: {v['npv']:.4f} (gap {v['rel_gap']:+.3e}, {v['wall_s']:.3f} s)"
                         for k, v in line["per_seed"].items())
    print(f"[accuracy] tree (float64, G = {study.GRID}) {line['tree_npv']:.6f} in "
          f"{line['tree_wall_s']:.3f} s; LSMC float32 at {line['drift_leg_sims']} paths: {per_seed}; "
          f"worst |gap| {line['worst_abs_rel_gap']:.3e}; float64 {line['f64_npv']:.6f} in "
          f"{line['f64_wall_s']:.3f} s, float32 against float64 drift "
          f"{line['f32_vs_f64_rel_drift']:+.3e} at {line['drift_leg_sims']} paths; wall "
          f"{wall:.3f} s; launches {counts}, by element type {rec.calls}")
    print(json.dumps(line))
    check(all(math.isfinite(v["npv"]) for v in line["per_seed"].values())
          and math.isfinite(line["tree_npv"]) and math.isfinite(line["f64_npv"]),
          "accuracy study values not finite")
    for seed, v in line["per_seed"].items():
        check(abs(v["rel_gap"]) <= ACCURACY_GAP_MAX,
              f"accuracy seed {seed}: |gap| {abs(v['rel_gap']):.3e} > {ACCURACY_GAP_MAX}")
    check(all(c > 0 for c in counts.values()), f"accuracy launches {counts}")
    names = {"K1": "backward_update", "K2": "forward_sim", "K3": "path_sim"}
    for kernel, name in names.items():
        by_type = {t: c for (k, t), c in rec.calls.items() if k == kernel}
        check(sorted(by_type) == ["float32", "float64"] and sum(by_type.values()) == counts[name],
              f"accuracy {kernel} launches by element type {by_type}, in all {counts[name]}")
    check(sorted(rec.recorded) == sorted((k, t) for k in names for t in ("float32", "float64")),
          f"the accuracy run recorded {sorted(rec.recorded)}")
    variants = {}
    for dtype in ("float32", "float64"):
        suffix = "" if dtype == "float32" else " f64"
        prefix = "" if dtype == "float32" else "f64_"
        checked = {
            "K1": _check_backward(f"K1 backward_update accuracy{suffix}",
                                  *rec.recorded.pop(("K1", dtype)), min_tiles_per_block=2),
            "K2": _check_forward(f"K2 forward_sim accuracy{suffix}",
                                 *rec.recorded.pop(("K2", dtype)), min_tiles_per_block=1),
            "K3": _check_path_set(f"K3 path_sim accuracy{suffix}",
                                  *rec.recorded.pop(("K3", dtype)), getattr(torch, dtype)),
        }
        for kernel, m in checked.items():
            extra = {} if dtype == "float32" else {"source": F64_SOURCES[kernel]}
            variants.setdefault(kernel, {})[f"{prefix}accuracy"] = dict(
                m, **extra, launches_accuracy=rec.calls[(kernel, dtype)])
    return counts, variants


EXAMPLES = {  # script, arguments, timeout (s)
    "readme": (["examples/torch_readme_example.py"], 300),
    "async_and_cache": (["examples/torch_async_and_cache.py"], 300),
    "multichip_sharding": (["examples/torch_multichip_sharding.py"], 300),
}


def phase_examples():
    """The three ``examples/torch_*.py`` scripts on the card, in subprocesses
    started together, each with its own timeout; the README example's printed
    NPV against an in-process call on the same inputs."""
    import re
    import storage_tpu_torch as tt

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, *argv], cwd=root, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, (argv, _) in EXAMPLES.items()}
    outputs = {}
    try:
        for name, proc in procs.items():
            try:
                outputs[name] = proc.communicate(timeout=EXAMPLES[name][1])
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                raise SmokeFailure(f"example {name} timed out after {EXAMPLES[name][1]} s")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    for name, (stdout, stderr) in outputs.items():
        check(procs[name].returncode == 0,
              f"example {name} exited {procs[name].returncode}:\n{stderr[-2000:]}")
    npv_lines = {name: [line for line in out.splitlines() if "NPV" in line]
                 for name, (out, _) in outputs.items()}
    res = tt.three_factor_seasonal_value(**case_kwargs(tt, 2000, 12), device="cuda")
    expected = f"Full NPV:\t{res.npv:,.0f}"
    print(f"[examples] three scripts on the card at once in {wall:.3f} s; "
          + "; ".join(f"{name}: {lines}" for name, lines in npv_lines.items())
          + f"; in-process README call {res.npv:.4f}")
    check(expected in outputs["readme"][0].splitlines(),
          f"README example printed {npv_lines['readme']}, the in-process call {expected!r}")
    check(re.search(r"^mesh: PathsMesh\(\['cuda:0'", outputs["multichip_sharding"][0],
                    re.MULTILINE) is not None, "the mesh example did not build a mesh of cards")
    check(re.search(r"^status:   success$", outputs["async_and_cache"][0], re.MULTILINE)
          is not None, "the async example did not end in success")


PRECISION_NPV_RTOL = 1e-3  # the study's criterion (the accuracy study's), per configuration
PRECISION_CAPTURE_LAUNCH = 182  # the constant-rate K1 launch recorded: mid-horizon of 365


def count_precision(num_sims, device="cuda"):
    """The precision study once, each configuration's launches counted by
    kernel and element type.  Returns the study's line and, per
    configuration (its function's name), those counts."""
    import contextlib
    from storage_tpu_torch.models import simulation

    calls = {}

    @contextlib.contextmanager
    def counting(make_cfg):
        with _recording({}, draws_from=simulation) as rec:
            yield
        calls[make_cfg.__name__] = rec.calls

    return _tool("torch_precision_study").run_study(num_sims, device, around=counting), calls


def record_precision(num_sims, device="cuda"):
    """The precision study's route once more, keeping on the device (cloned)
    the float64 operands the kernels are held against: the constant-rate
    configuration's mid-horizon K1 launch (B = 9), and the bench
    configuration's K2 launch (one over its whole horizon) and its first
    float64 path set.  Returns those ("K1", "K2", "K3") and, per
    configuration, each kernel's launches by element type in this run."""
    from storage_tpu_torch.models import simulation

    study = _tool("torch_precision_study")
    recorded, calls = {}, {}
    for make_cfg, wanted in (
            (study.constant_rate_config, {"K1": ("K1", "float64", PRECISION_CAPTURE_LAUNCH)}),
            (study.bench_config, {"K2": ("K2", "float64", 1), "K3": ("K3", "float64", 1)})):
        cfg = make_cfg(num_sims)
        ctx, coeffs, spec = study.build(cfg)
        with _recording(wanted, draws_from=simulation) as rec:
            study.run_legs((cfg, ctx, coeffs, spec), study.draw(coeffs, num_sims, device), device)
        recorded.update(rec.recorded)
        calls[make_cfg.__name__] = rec.calls
    return recorded, calls


def phase_precision():
    """``tools/torch_precision_study.py`` at full size on the card: both
    configurations at 1M paths, the float64 path sets drawn once (K3's
    float64 one-launch mode) and valued by ``run_lsmc`` in float64 and,
    rounded, in float32; each |NPV32 / NPV64 - 1| within PRECISION_NPV_RTOL.
    The launches are counted per configuration in this run.  Then the
    float64 kernels against their plain versions on launches of this route,
    which no other path makes, kept by a second run that must launch as the
    first did: K1 at B = 9, K2 in one launch over the whole horizon, K3's
    one-launch path set over the whole horizon bit for bit (its plain
    version run once, compared and timed).  Returns the study's launch
    counts and the new variants."""
    import math
    import torch
    import storage_tpu_torch as tt

    study = _tool("torch_precision_study")
    tt.reset_launch_counts()
    t0 = time.perf_counter()
    line, calls = count_precision(study.NUM_SIMS)
    wall = time.perf_counter() - t0
    counts = tt.launch_counts()
    for row in line["rows"]:
        print(f"[precision] {study.table_line(row)}")
    for name, leg in line["legs"].items():
        print(f"[precision] {name}: draws {leg['draw_s']:.3f} s; float64 leg "
              f"{leg['f64_wall_s']:.3f} s, peak {leg['f64_peak_bytes'] / 2**30:.3f} GiB; float32 "
              f"leg {leg['f32_wall_s']:.3f} s, peak {leg['f32_peak_bytes'] / 2**30:.3f} GiB")
    print(f"[precision] study wall {wall:.3f} s on {line['card']}; launches {counts}, by "
          f"configuration and element type {calls}")
    print(json.dumps(line))
    for row in line["rows"]:
        check(math.isfinite(row["npv_f64"]) and math.isfinite(row["npv_rel_diff"]),
              f"precision {row['config']}: NPVs not finite")
        check(row["npv_rel_diff"] <= PRECISION_NPV_RTOL,
              f"precision {row['config']}: |NPV32 / NPV64 - 1| {row['npv_rel_diff']:.3e} > "
              f"{PRECISION_NPV_RTOL}")
    names = {"K1": "backward_update", "K2": "forward_sim", "K3": "path_sim"}
    for kernel, name in names.items():
        by_type = {t: sum(c.get((kernel, t), 0) for c in calls.values())
                   for t in ("float32", "float64")}
        check(by_type["float64"] > 0 and sum(by_type.values()) == counts[name],
              f"precision {kernel} launches by element type {by_type}, in all {counts[name]}")
    check(not any(("K3", "float32") in c for c in calls.values()),
          "precision drew float32 path sets")

    recorded, recorded_calls = record_precision(study.NUM_SIMS)
    check(sorted(recorded) == ["K1", "K2", "K3"], f"the precision run recorded {sorted(recorded)}")
    check(recorded_calls == calls,
          f"precision recording run launched {recorded_calls}, the study {calls}")
    k1_args, k1_kw = recorded.pop("K1")
    check(k1_args[2].dtype == torch.float64 and k1_kw["spec"].num_basis == 9,
          "precision K1: not the float64 B = 9 launch")
    k1 = _check_backward("K1 backward_update precision f64 B=9", k1_args, k1_kw,
                         min_tiles_per_block=2)
    del k1_args
    k2_args, k2_kw = recorded.pop("K2")
    check(k2_args[0].dtype == torch.float64 and k2_args[0].shape[0] == 340,
          f"precision K2: {tuple(k2_args[0].shape)} {k2_args[0].dtype}, not the bench "
          f"configuration's 340 float64 steps")
    k2 = _check_forward("K2 forward_sim precision f64 horizon", k2_args, k2_kw,
                        min_tiles_per_block=2)
    del k2_args
    gc.collect()
    torch.cuda.empty_cache()
    k3 = _check_path_set("K3 path_sim precision f64", *recorded.pop("K3"), torch.float64,
                         plain_once=True)
    const, bench = calls["constant_rate_config"], calls["bench_config"]
    variants = {
        "K1": {"f64_precision": dict(k1, source=F64_SOURCES["K1"],
                                     launches_precision=const[("K1", "float64")])},
        "K2": {"f64_horizon": dict(k2, source=F64_SOURCES["K2"],
                                   launches_precision=bench[("K2", "float64")])},
        "K3": {"launches_precision": const[("K3", "float64")] + bench[("K3", "float64")],
               "precision": k3},
    }
    return counts, variants


GUI_CAPTURE_LAUNCH = 182  # the K1 launch recorded: mid-horizon of the GUI run's 364
NOTEBOOK_CAPTURE_LAUNCH = 170  # the K1 launch recorded: mid-horizon of the first notebook's 340


def _hold_recorded(label, rec, counts, min_tiles_per_block):
    """The float32 launches that a phase's run kept (a :class:`_recording`
    of :func:`_first_launches`) held against their plain versions: K1, K2
    (with per-sim panels where the run wrote them), K3 bit for bit.  The run's launches, counted by element
    type, must all be float32 and be the phase's.  Returns per kernel the
    variant ``label`` with its launches in the run (``launches_<label>``)."""
    import torch

    names = {"K1": "backward_update", "K2": "forward_sim", "K3": "path_sim"}
    for kernel, name in names.items():
        check(rec.calls.get((kernel, "float32"), 0) == counts[name]
              and (kernel, "float64") not in rec.calls,
              f"{label} {kernel} launches by element type {rec.calls}, in all {counts[name]}")
    check(sorted(rec.recorded) == sorted((k, "float32") for k in names),
          f"the {label} run recorded {sorted(rec.recorded)}")
    k2_args, k2_kw = rec.recorded.pop(("K2", "float32"))
    panels = k2_kw.get("panels") is not None
    checked = {
        "K1": _check_backward(f"K1 backward_update {label}", *rec.recorded.pop(("K1", "float32")),
                              min_tiles_per_block=min_tiles_per_block),
        "K2": _check_forward(f"K2 forward_sim {label}", k2_args, dict(k2_kw, panels=None),
                             panels=panels, min_tiles_per_block=min_tiles_per_block),
        "K3": _check_path_set(f"K3 path_sim {label}", *rec.recorded.pop(("K3", "float32")),
                              torch.float32),
    }
    return {kernel: {label: dict(m, **{f"launches_{label}": rec.calls[(kernel, "float32")]})}
            for kernel, m in checked.items()}


def phase_gui():
    """``examples/torch_storage_gui.py``'s valuation on the card: the GUI's
    test data at 1M paths through ``valuation_task`` (the background run its
    Calculate button starts, on the port's ``AsyncValuation``), its progress
    and status seen as the button's subscribers see them; the NPV equal bit
    for bit to a direct ``three_factor_seasonal_value`` call on the same
    route (hooks, so the chunked driver; per-sim panels on); then the same
    run cancelled from its first progress report.  Each kernel is held
    against its plain version on a launch of the run: K1 mid-horizon, K2's
    first span (with panels), K3's first path set.  Returns the run's
    launches and the variants ``gui``."""
    import dataclasses
    import torch
    import storage_tpu_torch as tt
    from storage_tpu_torch.runtime import CalcStatus

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples"))
    import torch_storage_gui as gui

    inputs = dataclasses.replace(gui.test_data_inputs(), num_sims=NUM_SIMS)
    task = gui.valuation_task(inputs, device="cuda")
    progress, statuses = [], []
    task.subscribe_progress(progress.append)
    task.subscribe_status(statuses.append)
    tt.reset_launch_counts()
    t0 = time.perf_counter()
    with _recording(_first_launches(GUI_CAPTURE_LAUNCH, ("float32",))) as rec:
        res = task.start().result(timeout=900)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = tt.launch_counts()
    npv, intrinsic, n_steps = res.npv, res.intrinsic_npv, len(res.expected_profile) - 1
    del res
    gc.collect()
    variants = _hold_recorded("gui", rec, counts, min_tiles_per_block=2)
    del rec
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    direct = tt.three_factor_seasonal_value(**gui.valuation_kwargs(inputs),
                                            on_progress_update=lambda p: None, device="cuda")
    direct_wall = time.perf_counter() - t0
    direct_npv = direct.npv
    del direct
    gc.collect()
    cancelled = gui.valuation_task(inputs, device="cuda")
    cancelled.subscribe_progress(lambda p: p > 0.0 and cancelled.cancel())
    t0 = time.perf_counter()
    try:
        cancelled.start().result(timeout=900)
        raised = False
    except tt.ValuationCancelledError:
        raised = True
    cancel_wall = time.perf_counter() - t0
    print(f"[gui] test data at {NUM_SIMS} paths x {n_steps} steps through valuation_task: "
          f"wall {wall:.3f} s, status {statuses[-1].name}, {len(progress) - 1} progress reports "
          f"ending at {progress[-1]}, NPV {npv:.4f}, intrinsic {intrinsic:.4f}, launches "
          f"{counts}; direct call NPV {direct_npv:.4f} in {direct_wall:.3f} s; cancelled run "
          f"{cancelled.status.name} after {cancel_wall:.3f} s")
    check(statuses[-1] == CalcStatus.SUCCESS and task.status == CalcStatus.SUCCESS,
          f"gui status {statuses}")
    check(progress[-1] == 1.0 and progress == sorted(progress), f"gui progress {progress}")
    check(npv == direct_npv, f"gui NPV {npv!r} differs from the direct call's {direct_npv!r}")
    check(counts == {"backward_update": n_steps - 1, "forward_sim": NUM_SPANS,
                     "path_sim": PATH_SETS}, f"gui launches {counts}")
    check(cancelled.status == CalcStatus.CANCELLED and raised,
          f"cancelled gui run: status {cancelled.status}, raised {raised}")
    return counts, variants


NOTEBOOKS = ("torch_storage_valuation_walkthrough.ipynb", "torch_multi_factor_gui.ipynb",
             "torch_creating_storage_instances.ipynb")


def notebook_cells(path, device):
    """The code cells of the notebook at ``path`` to run: the ``parameters``
    cell as ``DEVICE = device``, and no cell tagged ``needs-<module>`` for a
    module that does not import here.  Returns (sources, left-out tags)."""
    import importlib.util

    with open(path) as f:
        nb = json.load(f)
    sources, left_out = [], []
    for cell in nb["cells"]:
        if cell["cell_type"] != "code":
            continue
        tags = cell.get("metadata", {}).get("tags", [])
        missing = [t for t in tags if t.startswith("needs-")
                   and importlib.util.find_spec(t[len("needs-"):]) is None]
        if missing:
            left_out += missing
            continue
        source = "".join(cell["source"])
        sources.append(f"DEVICE = {device!r}" if "parameters" in tags else source)
    return sources, left_out


def run_notebook(path, device):
    """The notebook's code cells in order in one namespace, from the
    notebook's folder (as a kernel runs them); returns (namespace, what they
    printed, left-out tags)."""
    import contextlib
    import io

    sources, left_out = notebook_cells(path, device)
    folder = os.path.dirname(os.path.abspath(path))
    namespace, out, cwd = {"__name__": "__main__"}, io.StringIO(), os.getcwd()
    sys.path.insert(0, folder)
    os.chdir(folder)
    try:
        with contextlib.redirect_stdout(out):
            for source in sources:
                exec(compile(source, path, "exec"), namespace)
    finally:
        os.chdir(cwd)
        sys.path.remove(folder)
    return namespace, out.getvalue(), left_out


def phase_notebooks():
    """Each ``examples/torch_*.ipynb`` (written by
    ``examples/_make_torch_notebooks.py``) run in one namespace with
    ``DEVICE = "cuda"``, read with ``json``; the cells that need a module
    missing here (ipywidgets, matplotlib) are left out.  Then each kernel
    against its plain version on a launch of the first valuation (K1
    mid-horizon, K2's first, K3's first path set).  Returns the launches of
    all three and the variants ``notebooks``."""
    import math
    import storage_tpu_torch as tt

    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples")
    tt.reset_launch_counts()
    npvs = {}
    rec = _recording(_first_launches(NOTEBOOK_CAPTURE_LAUNCH, ("float32",)))
    for name in NOTEBOOKS:
        t0 = time.perf_counter()
        with rec:
            namespace, printed, left_out = run_notebook(os.path.join(folder, name), "cuda")
        wall = time.perf_counter() - t0
        npv_lines = [line.strip() for line in printed.splitlines()
                     if "NPV" in line or line.startswith(("Trinomial", "LSMC"))]
        print(f"[notebooks] {name}: {wall:.3f} s, left out {left_out or 'nothing'}; {npv_lines}")
        results = namespace.get("results")
        if results is not None:
            npvs[name] = results.npv
            check(math.isfinite(results.npv) and results.deltas.notna().all(),
                  f"{name}: NPV or deltas not finite")
    counts = tt.launch_counts()
    check(sorted(npvs) == sorted(NOTEBOOKS[:2]), f"the notebooks valued {sorted(npvs)}")
    check(all(c > 0 for c in counts.values()), f"notebook launches {counts}")
    return counts, _hold_recorded("notebooks", rec, counts, min_tiles_per_block=1)


def main(argv) -> int:
    all_cards = "--all-cards" in argv
    started = time.perf_counter()
    try:
        import torch

        card = phase_device()
        import storage_tpu_torch  # noqa: F401  (fails outside a checkout)
        from storage_tpu_torch.parallel.mesh import paths_mesh

        phase_build()
        phase_native()
        if all_cards:
            return main_all_cards(card)
        captured = phase_capture()
        k1 = phase_backward(captured)
        k1_d5 = phase_backward_d5(captured)
        k1_large = phase_backward_large_grid(captured)
        k1_large_f64 = phase_backward_large_grid(captured, torch.float64)
        k2 = phase_forward(captured)
        k2_variants = phase_forward_variants(captured)
        k3 = phase_path_sim(captured)
        k3_variants = phase_path_sim_stream(captured, hourly_sim_coefficients())
        del captured
        gc.collect()
        torch.cuda.empty_cache()
        main_run = phase_main()
        counts, main_npv, main_intrinsic, main_peak = main_run
        async_counts, async_npv = phase_async(main_npv)
        gc.collect()
        phase_cancel()
        excel_counts = phase_excel(async_npv, async_counts, main_intrinsic)
        gc.collect()
        options_counts = phase_options(main_npv)
        stream_counts = phase_stream_main(main_npv, main_intrinsic, main_peak)
        hourly_counts, k1_hourly, k2_hourly = phase_hourly()
        reprice_counts = phase_reprice(main_npv)
        spot_counts = phase_spot_sim()
        gc.collect()
        torch.cuda.empty_cache()
        f64_counts, recorded64, f64_every, f64_spans, f64_peak = phase_f64_main(
            main_npv, main_intrinsic)
        k1_f64, k2_f64, k3_f64 = phase_f64_kernels(recorded64, f64_every, f64_spans)
        k1_f64[f"f64_G{LARGE_G}_D{3 + 2 * LARGE_G_EXTRA}"] = k1_large_f64
        del recorded64
        gc.collect()
        torch.cuda.empty_cache()
        mesh_counts, mesh64_counts, k1_mesh, k2_mesh, k3_mesh = phase_mesh(
            paths_mesh(["cuda:0"] * MESH_SHARDS), main_run, (f64_counts, f64_peak))
        gc.collect()
        torch.cuda.empty_cache()
        tree_counts = phase_tree(main_intrinsic)
        accuracy_counts, accuracy_variants = phase_accuracy()
        gc.collect()
        torch.cuda.empty_cache()
        phase_examples()
        precision_counts, precision_variants = phase_precision()
        gc.collect()
        torch.cuda.empty_cache()
        gui_counts, gui_variants = phase_gui()
        gc.collect()
        notebook_counts, notebook_variants = phase_notebooks()
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    except ImportError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    paths = {"main": counts, "async": async_counts, "options": options_counts,
             "stream_main": stream_counts, "hourly": hourly_counts, "reprice": reprice_counts,
             "spot_sim": spot_counts, "f64_main": f64_counts, "mesh": mesh_counts,
             "mesh_f64": mesh64_counts, "tree": tree_counts, "excel": excel_counts,
             "accuracy": accuracy_counts, "precision": precision_counts, "gui": gui_counts,
             "notebooks": notebook_counts}
    # The float64 variants' launches on f64_main, by mode: K2 once per span,
    # the tail one of them; K3 one checkpoint pass and then spans per path set.
    f64_launches = {
        "K1": {"f64": f64_counts["backward_update"],
               f"f64_G{LARGE_G}_D{3 + 2 * LARGE_G_EXTRA}": 0},
        "K2": {"f64": f64_counts["forward_sim"] - 1, "f64_tail": 1},
        "K3": {"f64": 0, "f64_checkpoints": PATH_SETS,
               "f64_span": f64_counts["path_sim"] - PATH_SETS}}

    def f64_variants(kernel, measured):
        return {name: dict(m, source=F64_SOURCES[kernel],
                           launches_f64_main=f64_launches[kernel][name])
                for name, m in measured.items()}

    # The mesh variants' launches on the mesh paths, every shard's: a float32
    # variant's on the materialised float32 run (K3's window mode there is
    # its one-launch path sets), a float64 one's on the streamed float64 run
    # (K3's window mode there: checkpoint passes and spans).
    def mesh_variants(kernel, measured):
        return {name: dict(m, launches_mesh=0 if name.startswith("f64") else mesh_counts[kernel],
                           launches_mesh_f64=mesh64_counts[kernel] if name.startswith("f64")
                           else 0)
                for name, m in measured.items()}

    # The precision study's float64 launches: K3's one-launch path sets go to
    # the "f64" variant (its first launches on a path), with the full-horizon
    # comparison's numbers.
    k3_precision = precision_variants["K3"]
    k3_f64["f64"].update(launches_precision=k3_precision["launches_precision"],
                         **{f"{k}_precision": v for k, v in k3_precision["precision"].items()
                            if k in ("max_abs_err", "ms", "plain_ms", "bound_ms")})
    kernels = [
        dict(name="backward_update", route="cuda",
             source="storage_tpu_torch/ops/csrc/backward_update.cu",
             replaces="storage_tpu/ops/pallas_backward.py:114",
             launches=counts["backward_update"], **k1,
             launches_by_path={p: c["backward_update"] for p, c in paths.items()},
             variants={"D5": k1_d5, f"G{LARGE_G}_D{3 + 2 * LARGE_G_EXTRA}": k1_large,
                       **k1_hourly, **f64_variants("K1", k1_f64),
                       **mesh_variants("backward_update", k1_mesh),
                       **accuracy_variants["K1"], **precision_variants["K1"],
                       **gui_variants["K1"], **notebook_variants["K1"]}),
        dict(name="forward_sim", route="cuda",
             source="storage_tpu_torch/ops/csrc/forward_sim.cu",
             replaces="storage_tpu/ops/pallas_forward.py:96",
             launches=counts["forward_sim"], **k2,
             launches_by_path={p: c["forward_sim"] for p, c in paths.items()},
             variants={**k2_variants, **k2_hourly, **f64_variants("K2", k2_f64),
                       **mesh_variants("forward_sim", k2_mesh), **accuracy_variants["K2"],
                       **precision_variants["K2"], **gui_variants["K2"],
                       **notebook_variants["K2"]}),
        dict(name="path_sim", route="cuda",
             source="storage_tpu_torch/ops/csrc/path_sim.cu",
             replaces="storage_tpu/models/simulation.py:264 (XLA code, no Pallas kernel)",
             launches=counts["path_sim"], **k3,
             launches_by_path={p: c["path_sim"] for p, c in paths.items()},
             variants={**k3_variants, **f64_variants("K3", k3_f64),
                       **mesh_variants("path_sim", k3_mesh), **accuracy_variants["K3"],
                       **gui_variants["K3"], **notebook_variants["K3"]}),
    ]
    print(f"[wall] chip_smoke {time.perf_counter() - started:.3f} s, the build included")
    print(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main_all_cards(card) -> int:
    """``--all-cards``: the mesh phase over ``paths_mesh()``, one shard on
    each card, after the one-device runs it is held against (main, f64_main)."""
    import torch
    from storage_tpu_torch.parallel.mesh import paths_mesh

    try:
        main_run = phase_main()
        f64_counts, recorded64, _, _, f64_peak = phase_f64_main(main_run[1], main_run[2])
        del recorded64
        gc.collect()
        torch.cuda.empty_cache()
        mesh = paths_mesh()
        out = phase_mesh(mesh, main_run, (f64_counts, f64_peak))
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(f"[card] {card}")
    print(json.dumps({"mesh": str(mesh), "launches": {"mesh": out[0], "mesh_f64": out[1]},
                      "K1": out[2], "K2": out[3], "K3": out[4]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
