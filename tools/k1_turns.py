#!/usr/bin/env python3
"""Time the backward kernel K1 on one GPU against an earlier build of it, in
turns, then trace one warm valuation.

    python3 tools/k1_turns.py [--parent DIR] [--no-trace]
                              [--out chiprun_out/k1_turns.json]

DIR (default ``storage_tpu_torch/_build/parent``, which git ignores) holds an
earlier commit's ``backward_update.cu`` and ``storage_kernels.cuh``, written
there with ``git show <commit>:storage_tpu_torch/ops/csrc/<name> > DIR/<name>``.
It is built with ``csrc.compile_library`` and called through the PR-1
launcher's C interface (one partial per 128-sim block, ``block`` as its last
int argument). Without DIR only the current kernel is timed.

1. build   — the current library and the earlier kernel, built together.
2. capture — ``chip_smoke.phase_capture``: one 1M-path valuation of the
   headline case recording one mid-horizon K1 launch; its D = 5 operands.
3. turns   — at D = 3 and D = 5: earlier, current, current, earlier; 20
   launches each, CUDA events, each including the wrapper's partial sums;
   the earlier kernel's outputs against the current one's.
4. wall    — the headline valuation at 1M paths with each K1 as the engine's
   ``backward_update``, in the same order; wall and stopwatch phases.
5. trace   — ``torch.profiler`` over one more (warm) valuation: K1's device
   total, the other kernels launched between the first and the last K1
   launch (the backward induction's per-step glue: count and device time),
   the device's idle share of the traced wall, and the stopwatch phases.

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

REPS = 20


def build_parent(parent: Path):
    """Build the earlier kernel from ``parent`` into a library; None if absent."""
    from storage_tpu_torch.ops import csrc

    if not (parent / "backward_update.cu").exists():
        return None
    out = parent / "libparent_backward.so"
    csrc.compile_library(parent, ("backward_update.cu",), out)
    lib = ctypes.CDLL(str(out))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.backward_update_launch.argtypes = [p] * 12 + [ll, i, i, i, i, p, p, i, p]
    lib.backward_update_launch.restype = i
    return lib


def parent_update(lib):
    """The earlier wrapper on library ``lib``: one launch, one partial per
    128-sim block, summed; called like ``backward_update``."""
    import torch
    from storage_tpu_torch.ops.csrc import basis_arrays

    def run(f, fp, v_next, table, vbar, musd, gj, gw, scal, spec):
        F, S = f.shape
        G, D, B = v_next.shape[0], table.shape[0], spec.num_basis
        nblk = -(-S // 128)
        v_out = torch.empty_like(v_next)
        graw_part = torch.empty((nblk, B + 1, B + 1), device=v_next.device)
        praw_part = torch.empty((nblk, B + 1, G), device=v_next.device)
        spot_pow, fac_pow = basis_arrays(spec)
        err = lib.backward_update_launch(
            f.data_ptr(), fp.data_ptr(), v_next.data_ptr(), v_out.data_ptr(), table.data_ptr(),
            vbar.data_ptr(), musd.data_ptr(), gj.data_ptr(), gw.data_ptr(), scal.data_ptr(),
            graw_part.data_ptr(), praw_part.data_ptr(), S, G, D, B, F, spot_pow, fac_pow, 128,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent launch failed: cudaError {err}")
        return v_out, graw_part.sum(dim=0), praw_part.sum(dim=0)
    return run


def turns(label, versions, args, spec):
    """Each version timed in turn, then in reverse order; outputs against the
    current kernel's."""
    import torch

    ref = versions["current"](*args, spec=spec)
    torch.cuda.synchronize()
    agreement = {}
    for name, fn in versions.items():
        v, graw, praw = fn(*args, spec=spec)
        torch.cuda.synchronize()
        agreement[name] = dict(
            v_max_abs_diff=float((v - ref[0]).abs().max()),
            graw_rel=chip_smoke.rel_err(graw, ref[1]), praw_rel=chip_smoke.rel_err(praw, ref[2]))
        del v, graw, praw
    order = list(versions) + list(reversed(versions))
    times = {name: [] for name in versions}
    for name in order:
        times[name].append(chip_smoke.cuda_ms(lambda: versions[name](*args, spec=spec), REPS))
    for name in versions:
        print(f"[turns {label}] {name}: {' / '.join(f'{t:.4f}' for t in times[name])} ms "
              f"(mean {sum(times[name]) / 2:.4f}); against current: {agreement[name]}")
    return dict(order=order, ms=times, agreement=agreement)


def wall_turns(versions):
    """The headline valuation with each K1 as the engine's backward_update,
    in turns (each version, then the reverse order)."""
    import torch
    import storage_tpu_torch as tt
    from storage_tpu_torch.engines import lsmc

    real = lsmc.backward_update
    order = list(versions) + list(reversed(versions))
    runs = []
    try:
        for name in order:
            phases = {}

            def sink(sw, phases=phases):
                phases.update({p: sw.elapsed(p) for p in sw.PHASES + ("All",)})

            lsmc.backward_update = versions[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = chip_smoke.value_case(tt, chip_smoke.NUM_SIMS, chip_smoke.SEED, device="cuda",
                                        profile_sink=sink)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs.append(dict(version=name, wall_s=wall, npv=res.npv, phases_s=phases))
            print(f"[wall] {name}: {wall:.3f} s, NPV {res.npv:.4f}, phases "
                  + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()))
    finally:
        lsmc.backward_update = real
    return runs


def trace(num_sims, seed):
    """torch.profiler over one warm valuation of the headline case."""
    import torch
    import storage_tpu_torch as tt
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    phases = {}

    def sink(sw):
        phases.update({p: sw.elapsed(p) for p in sw.PHASES + ("All",)})

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = chip_smoke.value_case(tt, num_sims, seed, device="cuda", profile_sink=sink)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = sorted(((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == DeviceType.CUDA), key=lambda x: x[0])
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

    k1 = [(s, e) for s, e, n in dev if "backward_update_kernel" in n]
    first, last = k1[0][0], k1[-1][1]
    glue = [(s, e, n) for s, e, n in dev
            if first <= s <= last and "backward_update_kernel" not in n]
    out.update(
        device_busy_ms=busy / 1e3, idle_share=1.0 - busy / 1e3 / (wall * 1e3),
        k1_launches=len(k1), k1_total_ms=sum(e - s for s, e in k1) / 1e3,
        backward_window_ms=(last - first) / 1e3,
        glue_launches=len(glue), glue_device_ms=sum(e - s for s, e, _ in glue) / 1e3,
        glue_top=by_name(glue)[:12], top=by_name(dev)[:15])
    print(f"[trace] wall {wall:.3f} s, NPV {res.npv:.4f}, phases {phases}; device busy "
          f"{out['device_busy_ms']:.1f} ms, idle share {out['idle_share']:.4f}; K1 "
          f"{out['k1_launches']} launches, {out['k1_total_ms']:.2f} ms; backward window "
          f"{out['backward_window_ms']:.1f} ms holds {out['glue_launches']} other kernels, "
          f"{out['glue_device_ms']:.2f} ms of device time")
    print(f"[trace] glue kernels {out['glue_top']}")
    print(f"[trace] top kernels {out['top']}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=ROOT / "storage_tpu_torch/_build/parent")
    ap.add_argument("--no-trace", action="store_true", help="skip the profiler trace")
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out/k1_turns.json")
    opts = ap.parse_args()

    import torch
    from storage_tpu_torch.ops import backward, csrc

    card = chip_smoke.phase_device()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        cur = pool.submit(csrc.build, True)
        par = pool.submit(build_parent, opts.parent)
        cur.result()
        parent = par.result()
    csrc.kernels()
    print(f"[build] {time.perf_counter() - t0:.2f} s; parent kernel "
          f"{'built' if parent else 'absent'}")
    versions = {}
    if parent is not None:
        versions["parent"] = parent_update(parent)
    versions["current"] = backward._backward_update_cuda
    captured = chip_smoke.phase_capture()
    args, kw = captured["bwd"]
    result = dict(card=card, device=torch.cuda.get_device_name(0))
    result["D3"] = turns("D=3", versions, args, kw["spec"])
    result["D5"] = turns("D=5", versions, chip_smoke.d5_args(captured), kw["spec"])
    del captured, args
    torch.cuda.empty_cache()
    if parent is not None:
        result["wall"] = wall_turns(versions)
    if not opts.no_trace:
        result["trace"] = trace(chip_smoke.NUM_SIMS, chip_smoke.SEED)
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text(json.dumps(result, indent=1))
    print(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
