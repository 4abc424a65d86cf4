#!/usr/bin/env python3
"""Time the forward kernel K2, the path kernel K3 and the whole valuation on
one GPU against what the main path ran before them, in turns in one
process, then trace one warm valuation.

    python3 tools/kernel_turns.py [--parent DIR] [--variant NAME=DIR ...]
                                  [--no-wall] [--no-trace] [--sass]
                                  [--out chiprun_out/kernel_turns.json]
    python3 tools/kernel_turns.py --hourly [--out chiprun_out/hourly_trace.json]

DIR (default ``storage_tpu_torch/_build/parent``, which git ignores) holds an
earlier commit's ``forward_sim.cu`` and ``storage_kernels.cuh``, written
there with ``git show <commit>:storage_tpu_torch/ops/csrc/<name> > DIR/<name>``.
It is built with ``csrc.compile_library`` and called through the C interface
that kernel had before its redesign (one thread per sim, 256-sim blocks, one
partial per block and step). K3's parent is the plain PyTorch path
simulation, which is what the main path ran before the kernel existed.
``--variant NAME=DIR`` (repeatable) builds another ``forward_sim.cu`` with
the current C interface from DIR (an edited copy of the current sources: one
constant changed, such as ``kR`` and ``kFwdMinBlocks`` for another number of
sims per thread, or one part taken out) and times it beside the others.

1. build   — the current library, the parent and the variants, together.
2. capture — ``chip_smoke.phase_capture``: one 1M-path valuation of the
   headline case recording the forward launch and the path-set simulations.
3. K2      — at D = 3, with per-sim panels and at D = 5: every version in
   turn, then in reverse order; 5 launches each, CUDA events, wrappers
   included. Versions: parent, current, and the variants. Outputs against
   the current kernel's.
4. K3      — plain version, kernel, kernel, plain version at ``[341, 3, 1M]``.
5. wall    — the headline valuation at 1M paths as it ran before (parent K2,
   plain path simulation) and now, in the same order; wall and phases.
6. trace   — ``torch.profiler`` over one more (warm) valuation: the top
   device operations, K1's, K2's and K3's device totals, the other kernels
   launched between the first and the last K1 launch (the backward
   induction's per-step glue), and the device's idle share of the traced wall.

``--sass`` adds what the compiler made of the two kernels (``cuobjdump
-sass`` of the current library): instructions in all, the loops (backward
branches) with their sizes, and the commonest opcodes.

``--hourly`` does none of the above: it builds the library, runs the streamed
hourly case of ``chip_smoke.value_hourly`` (17,520 steps x 250,000 antithetic
paths, a path budget of 1.5e9 bytes) once to warm up and once untraced with
phase syncs, times the host compile, the intrinsic DP and its float64 sweep
alone, and traces a third run (device activity only: the run makes ~2M
launches), with the same summary as the trace above.

Prints one line per measurement and writes them all to ``--out`` as JSON.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the repo root's smoke script: capture and timing helpers)

REPS = 5


def build_parent(parent: Path):
    """Build the earlier forward kernel from ``parent``; None if absent."""
    from storage_tpu_torch.ops import csrc

    if not (parent / "forward_sim.cu").exists():
        return None
    out = parent / "libparent_forward.so"
    csrc.compile_library(parent, ("forward_sim.cu",), out)
    lib = ctypes.CDLL(str(out))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.forward_sim_launch.argtypes = [p] * 13 + [ll, i, i, i, i, i, i, i, i, p, p, i, p]
    lib.forward_sim_launch.restype = i
    return lib


def parent_forward(lib):
    """The earlier wrapper on library ``lib``: one launch, one partial per
    256-sim block and step, summed; called like ``forward_sim``."""
    import torch
    from storage_tpu_torch.ops.csrc import basis_arrays
    from storage_tpu_torch.ops.decisions import decision_weights

    def run(factors, inv0, tables, mus, sds, pillars, scalars, spec, interp_kind, num_grid,
            extra_decisions=0, panels=None):
        n, F, S = factors.shape
        B, (P, C), dev = spec.num_basis, pillars.shape[1:], factors.device
        weights = torch.tensor(decision_weights(extra_decisions), dtype=torch.float32, device=dev)
        tables_gb = tables.transpose(1, 2).contiguous()
        nblk = -(-S // 256)
        sums_part = torch.empty((nblk, n, 7), device=dev)
        xsums_part = torch.empty((nblk, n, B + 1), device=dev)
        inv_out, pv_out = torch.empty((S,), device=dev), torch.empty((S,), device=dev)
        spot_pow, fac_pow = basis_arrays(spec)
        err = lib.forward_sim_launch(
            factors.data_ptr(), inv0.data_ptr(), tables_gb.data_ptr(), mus.data_ptr(),
            sds.data_ptr(), pillars.data_ptr(), scalars.data_ptr(), weights.data_ptr(),
            sums_part.data_ptr(), xsums_part.data_ptr(), inv_out.data_ptr(), pv_out.data_ptr(),
            None if panels is None else panels.data_ptr(), S, n, num_grid, P, C,
            int(interp_kind), weights.shape[1], B, F, spot_pow, fac_pow, 256,
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"parent launch failed: cudaError {err}")
        return sums_part.sum(dim=0), xsums_part.sum(dim=0), inv_out, pv_out
    return run


def build_variant(src: Path):
    """Build ``forward_sim.cu`` from ``src`` (current C interface)."""
    from storage_tpu_torch.ops import csrc

    out = src / "libvariant_forward.so"
    csrc.compile_library(src, ("forward_sim.cu",), out, verbose=True)
    lib = ctypes.CDLL(str(out))
    cur = csrc.kernels()
    for name in ("forward_sim_launch", "forward_sim_blocks", "forward_sim_row_pitch",
                 "storage_kernels_error_string"):
        getattr(lib, name).argtypes = getattr(cur, name).argtypes
        getattr(lib, name).restype = getattr(cur, name).restype
    return lib


def on_library(lib):
    """``_forward_sim_cuda`` launching from ``lib`` instead of the package's
    library."""
    from storage_tpu_torch.ops import csrc, forward

    def run(*args, **kw):
        saved = csrc._lib
        csrc._lib = lib
        try:
            return forward._forward_sim_cuda(*args, **kw)
        finally:
            csrc._lib = saved
    return run


def turns(label, versions, reference, call, reps=REPS):
    """Each version timed in turn, then in reverse order; the first two
    outputs against ``reference``'s."""
    import torch

    ref = call(versions[reference])
    torch.cuda.synchronize()
    agreement = {}
    for name, fn in versions.items():
        out = call(fn)
        torch.cuda.synchronize()
        agreement[name] = [chip_smoke.rel_err(a, b) for a, b in zip(out[:2], ref[:2])]
        del out
    order = list(versions) + list(reversed(versions))
    times = {name: [] for name in versions}
    for name in order:
        times[name].append(chip_smoke.cuda_ms(lambda: call(versions[name]), reps))
    for name in versions:
        print(f"[turns {label}] {name}: {' / '.join(f'{t:.4f}' for t in times[name])} ms "
              f"(mean {sum(times[name]) / 2:.4f}); sums, xsums rel against {reference}: "
              + ", ".join(f"{e:.2e}" for e in agreement[name]))
    return dict(order=order, ms=times, agreement=agreement)


def k3_turns(captured):
    import torch
    from storage_tpu_torch.models import simulation

    coeffs, num_sims, kw = captured["sim"][0]
    versions = {
        "plain": lambda: simulation.simulate_factor_paths_reference(
            coeffs, num_sims, kw["key"], False, "cuda"),
        "kernel": lambda: simulation._simulate_factor_paths_cuda(
            coeffs, num_sims, kw["key"], False, "cuda"),
    }
    order = ["plain", "kernel", "kernel", "plain"]
    times = {name: [] for name in versions}
    for name in order:
        times[name].append(chip_smoke.cuda_ms(versions[name], 1 if name == "plain" else 10))
    torch.cuda.empty_cache()
    shape = coeffs.decay.shape + (num_sims,)
    print(f"[turns K3 {shape}] " + "; ".join(
        f"{name}: {' / '.join(f'{t:.3f}' for t in ts)} ms" for name, ts in times.items()))
    return dict(order=order, ms=times)


def wall_turns(parent_fwd):
    """The headline valuation as it ran before (parent K2, plain path
    simulation) and now, in turns (each version, then the reverse order)."""
    import torch
    import storage_tpu_torch as tt
    from storage_tpu_torch import valuation
    from storage_tpu_torch.engines import lsmc
    from storage_tpu_torch.models import simulation

    def plain_sim(coeffs, num_sims, antithetic=False, key=None, device=None):
        return simulation.simulate_factor_paths_reference(coeffs, num_sims, key, antithetic,
                                                          device)

    real = (lsmc.forward_sim, valuation.simulate_factor_paths)
    versions = {"parent": (parent_fwd, plain_sim), "current": real}
    order = list(versions) + list(reversed(versions))
    runs = []
    try:
        for name in order:
            phases = {}

            def sink(sw, phases=phases):
                phases.update({p: sw.elapsed(p) for p in sw.PHASES + ("All",)})

            lsmc.forward_sim, valuation.simulate_factor_paths = versions[name]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = chip_smoke.value_case(tt, chip_smoke.NUM_SIMS, chip_smoke.SEED, device="cuda",
                                        profile_sink=sink)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            runs.append(dict(version=name, wall_s=wall, npv=res.npv, phases_s=phases,
                             peak_gib=peak))
            print(f"[wall] {name}: {wall:.3f} s, NPV {res.npv:.4f}, peak {peak:.3f} GiB, phases "
                  + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()))
    finally:
        lsmc.forward_sim, valuation.simulate_factor_paths = real
    return runs


def trace(value=None, host_activity=True):
    """torch.profiler over one warm valuation: ``value(profile_sink=...)``,
    by default the headline case."""
    import torch
    import storage_tpu_torch as tt
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if value is None:
        def value(**kw):
            return chip_smoke.value_case(tt, chip_smoke.NUM_SIMS, chip_smoke.SEED,
                                         device="cuda", **kw)
    phases = {}

    def sink(sw):
        phases.update({p: sw.elapsed(p) for p in sw.PHASES + ("All",)})

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_activity else [])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        res = value(profile_sink=sink)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device activities as (start us, end us, name), from Kineto's own event
    # list: prof.events() builds a Python tree of every event, which takes ten
    # minutes for a run of 3M launches.
    dev = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA)
    out = dict(wall_s=wall, npv=res.npv, phases_s=phases, device_events=len(dev))
    if not dev:
        print("[trace] no device events in the trace")
        return out
    busy, cur_s, cur_e = 0.0, dev[0][0], dev[0][1]
    for s, e, _ in dev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s

    def by_name(events):
        totals = {}
        for s, e, n in events:
            t = totals.setdefault(n[:80], [0, 0.0])
            t[0] += 1
            t[1] += (e - s) / 1e3
        return sorted(([n, c, t] for n, (c, t) in totals.items()), key=lambda x: -x[2])

    def total(fragment):
        hits = [(s, e) for s, e, n in dev if fragment in n]
        return dict(launches=len(hits), ms=sum(e - s for s, e in hits) / 1e3), hits

    k1_total, k1 = total("backward_update_kernel")
    first, last = k1[0][0], k1[-1][1]
    glue = [(s, e, n) for s, e, n in dev
            if first <= s <= last and "backward_update_kernel" not in n]
    out.update(
        device_busy_ms=busy / 1e3, idle_share=1.0 - busy / 1e3 / (wall * 1e3),
        k1=k1_total, k2=total("forward_sim_kernel")[0], k3=total("path_sim_kernel")[0],
        backward_window_ms=(last - first) / 1e3,
        glue_launches=len(glue), glue_device_ms=sum(e - s for s, e, _ in glue) / 1e3,
        glue_top=by_name(glue)[:12], top=by_name(dev)[:15])
    print(f"[trace] wall {wall:.3f} s, NPV {res.npv:.4f}, phases {phases}; device busy "
          f"{out['device_busy_ms']:.1f} ms, idle share {out['idle_share']:.4f}; K1 {out['k1']}, "
          f"K2 {out['k2']}, K3 {out['k3']}; backward window {out['backward_window_ms']:.1f} ms "
          f"holds {out['glue_launches']} other kernels, {out['glue_device_ms']:.2f} ms of "
          f"device time")
    print(f"[trace] glue kernels {out['glue_top']}")
    print(f"[trace] top kernels {out['top']}")
    return out


def hourly(out_path, card):
    """The streamed hourly case: a warm-up run, an untraced run with phase
    syncs, its host-side parts alone, then a traced run."""
    import numpy as np
    import torch
    import storage_tpu_torch as tt
    from storage_tpu_torch.compile import build_valuation_context
    from storage_tpu_torch.engines import intrinsic

    def value(seed=chip_smoke.SEED, **kw):
        with chip_smoke._path_budget(chip_smoke.HOURLY_BUDGET):
            return chip_smoke.value_hourly(tt, chip_smoke.HOURLY_SIMS, seed, device="cuda", **kw)

    t0 = time.perf_counter()
    warm = value(seed=12)
    torch.cuda.synchronize()
    result = dict(card=card, device=torch.cuda.get_device_name(0),
                  warm_s=time.perf_counter() - t0, warm_npv=warm.npv)
    phases = {}
    torch.cuda.reset_peak_memory_stats()
    tt.reset_launch_counts()
    t0 = time.perf_counter()
    res = value(profile_sink=lambda sw: phases.update(
        {p: sw.elapsed(p) for p in sw.PHASES + ("All",)}))
    torch.cuda.synchronize()
    result.update(wall_s=time.perf_counter() - t0, npv=res.npv, phases_s=phases,
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                  host_peak_rss_gib=chip_smoke._host_peak_gib(), launches=tt.launch_counts())
    print(f"[hourly] warm-up {result['warm_s']:.3f} s; untraced wall {result['wall_s']:.3f} s, "
          f"NPV {res.npv:.4f}, peak {result['peak_gib']:.3f} GiB, host peak RSS "
          f"{result['host_peak_rss_gib']:.3f} GiB, launches "
          f"{result['launches']}, phases "
          + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()))

    # "Other" split: the host compile, the intrinsic DP and its host sweep.
    storage, fwd = chip_smoke.build_hourly_case(tt)
    t0 = time.perf_counter()
    ctx = build_valuation_context(storage, "2021-01-01", 1500.0, fwd, 0.01, None, 100, 1e-12)
    t1 = time.perf_counter()
    values = intrinsic._backward_values(ctx, np.zeros(100), 0, torch.device("cuda"))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    intrinsic._forward_sweep(ctx, values.astype(np.float64))
    t3 = time.perf_counter()
    result["host_parts_s"] = dict(compile=t1 - t0, intrinsic_dp=t2 - t1, intrinsic_sweep=t3 - t2)
    print(f"[hourly] alone: host compile {t1 - t0:.3f} s, intrinsic DP {t2 - t1:.3f} s, "
          f"its float64 sweep {t3 - t2:.3f} s")
    result["trace"] = trace(value, host_activity=False)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(result, indent=1))
    return result


def sass_summary(fragment):
    """Instruction counts of the current library's kernel whose mangled name
    holds ``fragment``: total, loops (start, end, instructions), top opcodes."""
    import re
    import subprocess
    from collections import Counter
    from storage_tpu_torch.ops import csrc

    cuobjdump = Path(csrc._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(csrc.library_path())],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if fragment not in name:
            continue
        ins = [(int(m.group(1), 16), re.sub(r"^@!?U?P\d+\s+", "", m.group(2)))
               for m in re.finditer(r"/\*([0-9a-f]{4,5})\*/\s+(.*?);", block)]
        loops = []
        for addr, op in ins:
            m = re.search(r"BRA\S*\s+(?:\S+,\s*)?0x([0-9a-f]+)", op)
            if m and int(m.group(1), 16) < addr:
                loops.append([int(m.group(1), 16), addr, (addr - int(m.group(1), 16)) // 16 + 1])
        ops = Counter(op.split()[0].split(".")[0] for _, op in ins)
        out[name] = dict(instructions=len(ins), loops=loops, top=ops.most_common(14))
        print(f"[sass] {name}: {len(ins)} instructions; loops (start, end, size) {loops}; "
              f"{ops.most_common(14)}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=ROOT / "storage_tpu_torch/_build/parent")
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=DIR",
                    help="another forward_sim.cu with the current interface (repeatable)")
    ap.add_argument("--no-wall", action="store_true", help="skip the valuation turns")
    ap.add_argument("--no-trace", action="store_true", help="skip the profiler trace")
    ap.add_argument("--sass", action="store_true", help="summarise the kernels' machine code")
    ap.add_argument("--hourly", action="store_true",
                    help="only the streamed hourly case: untraced, its host parts, traced")
    ap.add_argument("--out", type=Path, default=None,
                    help="default chiprun_out/kernel_turns.json (hourly_trace.json with --hourly)")
    opts = ap.parse_args()
    if opts.out is None:
        opts.out = ROOT / "chiprun_out" / ("hourly_trace.json" if opts.hourly
                                           else "kernel_turns.json")

    import torch
    from storage_tpu_torch.ops import csrc, forward

    card = chip_smoke.phase_device()
    if opts.hourly:
        csrc.build()
        csrc.kernels()
        hourly(opts.out, card)
        print(f"[card] {card}")
        return 0
    variant_dirs = dict(v.split("=", 1) for v in opts.variant)
    t0 = time.perf_counter()
    csrc.build(True)
    csrc.kernels()
    with ThreadPoolExecutor(1 + len(variant_dirs)) as pool:
        par = pool.submit(build_parent, opts.parent)
        var = {name: pool.submit(build_variant, Path(d)) for name, d in variant_dirs.items()}
        parent = par.result()
        variants = {name: f.result() for name, f in var.items()}
    print(f"[build] {time.perf_counter() - t0:.2f} s; parent kernel "
          f"{'built' if parent else 'absent'}; variants {list(variants)}")

    versions = {}
    if parent is not None:
        versions["parent"] = parent_forward(parent)
    versions["current"] = forward._forward_sim_cuda
    versions.update({name: on_library(lib) for name, lib in variants.items()})
    reference = "current"

    captured = chip_smoke.phase_capture()
    args, kw = captured["fwd"]
    n, _, S = args[0].shape
    result = dict(card=card, device=torch.cuda.get_device_name(0), default=reference)
    full_panels = torch.empty((n, 6, S), device="cuda")
    cases = {"D3": dict(kw, panels=None), "panels": dict(kw, panels=full_panels),
             "D5": dict(kw, panels=None, extra_decisions=1)}
    for label, case_kw in cases.items():
        result[f"K2_{label}"] = turns(f"K2 {label}", versions, reference,
                                      lambda fn, case_kw=case_kw: fn(*args, **case_kw))
    del full_panels, cases
    result["K3"] = k3_turns(captured)
    del captured, args
    torch.cuda.empty_cache()
    if parent is not None and not opts.no_wall:
        result["wall"] = wall_turns(versions["parent"])
    if not opts.no_trace:
        result["trace"] = trace()
    if opts.sass:
        result["sass"] = {**sass_summary("forward_sim_kernelILi3"),
                          **sass_summary("path_sim_kernelILi3")}
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text(json.dumps(result, indent=1))
    print(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
