#!/usr/bin/env python3
"""Time the kernels on one GPU against what the main path ran before them,
in turns in one process, compare their machine code, and trace the main path.

    python3 tools/kernel_turns.py [--parent DIR] [--variant NAME=DIR ...]
                                  [--no-wall] [--no-trace] [--sass]
    python3 tools/kernel_turns.py --f64 [--parent DIR] [--variant NAME=DIR ...]
                                  [--no-wall] [--no-trace]
    python3 tools/kernel_turns.py --flips [--parent DIR]
    python3 tools/kernel_turns.py --hourly
    (each with [--out FILE]; default chiprun_out/<mode>.json)

DIR (default ``storage_tpu_torch/_build/parent``, which git ignores) holds an
earlier commit's sources, written there with
``git show <commit>:storage_tpu_torch/ops/csrc/<name> > DIR/<name>``:
``backward_update.cu``, ``forward_sim.cu``, ``path_sim.cu`` and
``storage_kernels.cuh`` (the float32 kernels, any of them may be absent),
and for ``--f64`` the float64 sources: the separate ones the port had before
its kernels were templated on the element type (``backward_update_f64.cu``,
``forward_sim_f64.cu``, ``storage_kernels_f64.cuh``) where DIR has them, else
the templated ``backward_update.cu`` and ``forward_sim.cu``, and
``path_sim.cu`` (K3's float64 mode). Each is built with
``csrc.compile_library`` and called through the current C interface: its
entry points stand in for the package's own, the others stay the
package's. A parent ``forward_sim.cu`` that still divides its grid step
(``span / (float)(G - 1)``) is built and compared with the product by the
reciprocal that torch computes (``GSTEP_REPAIR``), except under ``--flips``,
which counts the flips of both. ``--variant NAME=DIR`` (repeatable) builds
an edited copy of the current ``backward_update.cu`` / ``forward_sim.cu``
(under ``--f64`` also ``path_sim.cu``) and ``storage_kernels.cuh`` from DIR
(one constant changed, such as K2's ``kR``, K1's roles, registers or
ring depth, or K3's ``K3F64`` sizes, or one part taken out) and times it
beside the others.

Default (float32):
1. build   — the current library, the parent and the variants, together.
2. capture — ``chip_smoke.phase_capture``: one 1M-path valuation of the
   headline case recording K1's launch 170, the forward launch and the
   path-set simulations.
3. K1      — on launch 170 (``k1_turns``): every version in turn, then in
   reverse order, 20 launches each; V_out against the current kernel's
   byte for byte, the partials' largest gap over their column's largest
   value.
   K2      — at D = 3, with per-sim panels and at D = 5: every version in
   turn, then in reverse order; 5 launches each, CUDA events, wrappers
   included; outputs against the current kernel's.
4. K3      — at ``[341, 3, 1M]``: the plain version, the kernel and the parent
   K3 in turn, then in reverse order; the parent's paths against the
   kernel's, bit for bit.
5. wall    — the headline valuation at 1M paths with the parent's kernels and
   with the current ones, in turns; wall and phases.
6. trace   — ``torch.profiler`` over one more (warm) valuation: the top
   device operations, K1's, K2's and K3's device totals (K3 in either
   mode), the other kernels launched between the first and the last K1
   launch but the streamed spans' K3 launches (the backward induction's
   per-step glue), and the device's idle share of the traced wall.
7. ``--sass`` — instruction counts of the current K2 and K3, float32 and
   float64 (``cuobjdump -sass``: total, loops, commonest opcodes), and every
   float32 kernel of the parent's K1, K2 and K3 sources against the current
   float32 instantiation of the same name, instruction line by instruction
   line (raw dumps ``DIR/parent_<source>.sass`` and
   ``DIR/current_<source>.sass``). The tool exits 1 if a line differs or the
   parent's K3 paths differ.

``--f64``: f64_main's configuration (the headline case in float64 at 1M
paths and the default path budget, streamed) run once recording its K1
launch 170, the forward launch of its middle 64-step span and of its 20-step
tail and its streaming sources; K1 on launch 170 (``k1_turns``) and K2 on
both launches timed in turns (parent, current, variants, then in reverse
order; 20 and 5 launches each) with their outputs against the current
kernel's; K3's
float64 mode (``path_sim_f64_launch`` of the parent's ``path_sim.cu`` and of
variants holding one) on the regression source in its three modes (one
launch at ``[341, 3, 1M]``, the checkpoint pass, a 64-step span), in turns,
each version's paths against the current kernel's in ulp (a parent that
rounds every step on its own, unfused, lies an ulp or so away);
the f64_main wall with the parent's float64 kernels and with the current
ones, in turns; then a trace of one warm f64_main with the summary of step 6.

``--flips``: the near-tie flips of the float32 K2 against its plain version
(``chip_smoke.forward_flips``) with the parent's ``forward_sim.cu`` as it is
and with the current one, on chip_smoke's recorded forward launch at D = 3,
with panels, at D = 5 and with POLY ratchets, and on the hourly case's
middle span and tail launch (recorded from a warm-up run, seed 12).

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
import re
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the repo root's smoke script: capture and timing helpers)

REPS = 5
CSRC = ROOT / "storage_tpu_torch" / "ops" / "csrc"
# The float32 K2's grid step as it divided, and as torch computes it.
GSTEP_DIVIDED = "span / (float)(G - 1)"
GSTEP_REPAIR = "__fmul_rn(span, 1.0f / (float)(G - 1))"


class Overlay:
    """A kernel library whose entry points come from ``lib`` where it has
    them (declared like the package's of the same name), else from ``base``."""

    def __init__(self, lib, base):
        self._lib, self._base = lib, base

    def has(self, name):
        """Whether ``lib`` itself has the entry point ``name``."""
        return hasattr(self._lib, name)

    def __getattr__(self, name):
        try:
            fn = getattr(self._lib, name)
        except AttributeError:
            return getattr(self._base, name)
        own = getattr(self._base, name, None)
        if own is not None:
            fn.argtypes, fn.restype = own.argtypes, own.restype
        return fn


def build_library(src_dir: Path, sources, name: str, verbose=False):
    """``sources`` of ``src_dir`` that exist, compiled into one library over
    the package's (an :class:`Overlay`); None if none exists."""
    from storage_tpu_torch.ops import csrc

    present = [s for s in sources if (src_dir / s).exists()]
    if not present:
        return None
    out = src_dir / f"lib{name}.so"
    csrc.compile_library(src_dir, present, out, verbose=verbose)
    return Overlay(ctypes.CDLL(str(out)), csrc.kernels())


def repaired_forward(parent: Path) -> Path:
    """A directory holding the parent's K2 with its grid step rounded as
    torch rounds it (the parent itself if it needs no repair)."""
    src = (parent / "forward_sim.cu").read_text()
    if GSTEP_DIVIDED not in src:
        return parent
    out = parent / "gstep_repaired"
    out.mkdir(exist_ok=True)
    (out / "forward_sim.cu").write_text(src.replace(GSTEP_DIVIDED, GSTEP_REPAIR))
    (out / "storage_kernels.cuh").write_text((parent / "storage_kernels.cuh").read_text())
    return out


class library:
    """Every kernel launch inside the block goes to ``lib`` (None: the
    package's own); K1's cached grids are dropped on the way in and out."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        from storage_tpu_torch.ops import backward, csrc

        self.saved = csrc.kernels()
        backward._GRIDS.clear()
        if self.lib is not None:
            csrc._lib = self.lib

    def __exit__(self, *exc):
        from storage_tpu_torch.ops import backward, csrc

        csrc._lib = self.saved
        backward._GRIDS.clear()


def on_library(lib, fn):
    """``fn`` (a kernel wrapper) launching from ``lib``."""
    def run(*args, **kw):
        with library(lib):
            return fn(*args, **kw)
    return run


def rel_errors(out, ref):
    """The first two outputs' relative errors against the reference's, and
    their description."""
    errs = [chip_smoke.rel_err(a, b) for a, b in zip(out[:2], ref[:2])]
    return errs, "first outputs rel " + ", ".join(f"{e:.2e}" for e in errs)


def turns(label, versions, reference, call, reps=REPS, agree=rel_errors):
    """Each version timed in turn, then in reverse order; its outputs against
    ``reference``'s by ``agree(out, ref)``, which returns what is recorded
    and its description (by default ``rel_errors``)."""
    import torch

    ref = call(versions[reference])
    torch.cuda.synchronize()
    agreement, described = {}, {}
    for name, fn in versions.items():
        out = call(fn)
        torch.cuda.synchronize()
        agreement[name], described[name] = agree(out, ref)
        del out
    del ref
    order = list(versions) + list(reversed(versions))
    times = {name: [] for name in versions}
    for name in order:
        times[name].append(chip_smoke.cuda_ms(lambda: call(versions[name]), reps))
    for name in versions:
        print(f"[turns {label}] {name}: {' / '.join(f'{t:.4f}' for t in times[name])} ms "
              f"(mean {sum(times[name]) / 2:.4f}); against {reference}: {described[name]}")
    return dict(order=order, ms=times, agreement=agreement)


def column_gap(a, b):
    """The largest gap of ``a`` from ``b`` over the largest |b| of its column."""
    import torch

    scale = b.abs().amax(dim=0).clamp_min(torch.finfo(b.dtype).tiny)
    return float(((a - b).abs().amax(dim=0) / scale).max())


def k1_agreement(out, ref):
    """K1's ``(v_out, graw, praw, blocks)`` against the reference's: V_out
    byte for byte, the partials' largest gap over their column's largest
    value (``column_gap``), and the blocks it ran."""
    import torch

    ints = torch.int64 if out[0].dtype == torch.float64 else torch.int32
    bits, ref_bits = out[0].view(ints), ref[0].view(ints)
    a = dict(blocks=out[3], v_out_bytes_equal=torch.equal(bits, ref_bits),
             v_out_differ=int((bits != ref_bits).sum()),
             graw_gap=column_gap(out[1], ref[1]), praw_gap=column_gap(out[2], ref[2]))
    return a, (f"V_out {'equal byte for byte' if a['v_out_bytes_equal'] else 'differs'} "
               f"({a['v_out_differ']} entries), graw gap {a['graw_gap']:.2e}, praw gap "
               f"{a['praw_gap']:.2e}, {a['blocks']} blocks")


def k1_turns(label, libs, args, kw, reps=20):
    """K1 on one recorded launch with each library of ``libs`` (name ->
    library, None for the package's) in ``turns``, against the current
    kernel by ``k1_agreement``."""
    from storage_tpu_torch.ops import backward

    def call(lib):
        with library(lib):
            v_out, partials = backward._backward_update_cuda(*args, **kw)
        return (v_out, *backward.reduce_partials(partials, v_out.shape[0]), partials.shape[0])

    return turns(label, libs, "current", call, reps, agree=k1_agreement)


def parent_paths(lib):
    """One path set from the parent's path kernel, called like
    ``_simulate_factor_paths_cuda`` (float32, one launch)."""
    import torch
    from storage_tpu_torch.models import simulation
    from storage_tpu_torch.ops.csrc import check_launch

    def run(coeffs, num_sims, key, antithetic, device):
        tables = simulation._path_kernel_tables(coeffs, key, device)
        n, F = coeffs.decay.shape
        out = torch.empty((n, F, num_sims), device=device)
        draw = (num_sims + 1) // 2 if antithetic else num_sims
        check_launch("path_sim (parent)", lib.path_sim_launch(
            tables.keys.data_ptr(), tables.coef.data_ptr(), None, out.data_ptr(), num_sims,
            draw, 0, n, F, 0, torch.cuda.current_stream(device).cuda_stream))
        return out
    return run


def k3_turns(captured, parent=None):
    import torch
    from storage_tpu_torch.models import simulation

    coeffs, num_sims, key, _, _ = captured["sim"][0]
    versions = {"plain": simulation.simulate_factor_paths_reference,
                "kernel": simulation._simulate_factor_paths_cuda}
    if parent is not None:
        versions["parent"] = parent_paths(parent)

    def call(name):
        return versions[name](coeffs, num_sims, key, False, "cuda")

    out = dict()
    if parent is not None:
        out["paths_differ"] = chip_smoke._bits_differ(call("parent"), call("kernel"))
        print(f"[K3 parent] {out['paths_differ']} path elements differ from the kernel's")
    order = list(versions) + list(reversed(versions))
    times = {name: [] for name in versions}
    for name in order:
        times[name].append(chip_smoke.cuda_ms(lambda: call(name), 1 if name == "plain" else 10))
    torch.cuda.empty_cache()
    shape = coeffs.decay.shape + (num_sims,)
    print(f"[turns K3 {shape}] " + "; ".join(
        f"{name}: {' / '.join(f'{t:.3f}' for t in ts)} ms" for name, ts in times.items()))
    return dict(out, order=order, ms=times)


def wall_turns(libs, value, label="wall"):
    """``value(profile_sink=...)`` with each library of ``libs`` (name ->
    library, None for the package's), in turns (each, then the reverse)."""
    import torch

    order = list(libs) + list(reversed(libs))
    runs = []
    for name in order:
        phases = {}

        def sink(sw, phases=phases):
            phases.update({p: sw.elapsed(p) for p in sw.PHASES + ("All",)})

        with library(libs[name]):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = value(profile_sink=sink)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs.append(dict(version=name, wall_s=wall, npv=res.npv, phases_s=phases,
                         peak_gib=peak))
        print(f"[{label}] {name}: {wall:.3f} s, NPV {res.npv:.6f}, peak {peak:.3f} GiB, phases "
              + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()))
    return runs


def value_main(**kw):
    """The headline case at 1M paths (float32, materialised)."""
    import storage_tpu_torch as tt

    return chip_smoke.value_case(tt, chip_smoke.NUM_SIMS, chip_smoke.SEED, device="cuda", **kw)


def value_f64(**kw):
    """f64_main's configuration: the headline case at 1M paths in float64 at
    the default path budget (streamed)."""
    import torch
    import storage_tpu_torch as tt

    with chip_smoke._path_budget(chip_smoke.DEFAULT_PATH_BUDGET):
        return chip_smoke.value_case(tt, chip_smoke.NUM_SIMS, chip_smoke.SEED, device="cuda",
                                     dtype=torch.float64, **kw)


def trace(value=value_main, host_activity=True):
    """torch.profiler over one warm valuation: ``value(profile_sink=...)``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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

    def total(*fragments):
        hits = [(s, e) for s, e, n in dev if any(f in n for f in fragments)]
        return dict(launches=len(hits), ms=sum(e - s for s, e in hits) / 1e3), hits

    # K3: the float32 path kernel and the float64 one (path_sim_f64_kernel).
    k3_names = ("path_sim_kernel", "path_sim_f64_kernel")
    k1_total, k1 = total("backward_update_kernel")
    first, last = k1[0][0], k1[-1][1]
    # The glue: every other kernel of the backward window but the streamed
    # spans' path kernel launches.
    glue = [(s, e, n) for s, e, n in dev
            if first <= s <= last and "backward_update_kernel" not in n
            and not any(f in n for f in k3_names)]
    out.update(
        device_busy_ms=busy / 1e3, idle_share=1.0 - busy / 1e3 / (wall * 1e3),
        k1=k1_total, k2=total("forward_sim_kernel")[0], k3=total(*k3_names)[0],
        backward_window_ms=(last - first) / 1e3,
        glue_launches=len(glue), glue_device_ms=sum(e - s for s, e, _ in glue) / 1e3,
        glue_top=by_name(glue)[:12], top=by_name(dev)[:15])
    print(f"[trace] wall {wall:.3f} s, NPV {res.npv:.6f}, phases {phases}; device busy "
          f"{out['device_busy_ms']:.1f} ms, idle share {out['idle_share']:.4f}; K1 {out['k1']}, "
          f"K2 {out['k2']}, K3 {out['k3']}; backward window {out['backward_window_ms']:.1f} ms "
          f"holds {out['glue_launches']} other kernels, {out['glue_device_ms']:.2f} ms of "
          f"device time")
    print(f"[trace] glue kernels {out['glue_top']}")
    print(f"[trace] top kernels {out['top']}")
    return out


def hourly(card):
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
    return result


def sass_summary(fragment):
    """Instruction counts of the current library's kernels whose mangled name
    holds ``fragment``: total, loops (start, end, instructions), top opcodes."""
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


_ADDRESS = re.compile(r"/\*[0-9a-f]{4,}\*/")


def kernel_key(demangled: str):
    """(name, element type) of a demangled kernel: its qualified name and
    template arguments without the element type argument and without its
    parameter list, and that type, "float" or "double". A kernel with no
    type argument is "double" if a parameter is a double pointer (the
    float64 path kernel, ``path_sim_f64_kernel<3, false>``), else "float"
    (the float32 kernels before the templates).
    ``storage_kernels::backward_update_kernel<double, 3>(...)`` gives
    ``("storage_kernels::backward_update_kernel<3>", "double")``."""
    head = demangled.split(">(")[0] + ">" if ">(" in demangled else demangled.split("(")[0]
    m = re.search(r"<(float|double), ", head)
    if m is None:
        params = demangled[len(head):]
        return head, "double" if re.search(r"\bdouble\b", params) else "float"
    return head[:m.start() + 1] + head[m.end():], m.group(1)


def disassemble(src: Path, dump: Path) -> dict:
    """{(name, element type): [instruction lines]} of the cubin of ``src``
    (see :func:`kernel_key`); the raw disassembly is written to ``dump``."""
    import subprocess
    from storage_tpu_torch.ops.csrc import NVCC_FLAGS, _nvcc

    bindir = Path(_nvcc()).parent
    cubin = dump.with_suffix(".cubin")
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-cubin", "-o", str(cubin), str(src)], check=True)
    sass = subprocess.run([str(bindir / "cuobjdump"), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    dump.write_text(sass)
    out, key = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :", 1)[1].strip()
            demangled = subprocess.run([str(bindir / "cu++filt"), mangled], check=True,
                                       capture_output=True, text=True).stdout.strip()
            key = kernel_key(demangled)
            out[key] = []
        elif key is not None and _ADDRESS.search(line):
            # cuobjdump pads its columns to the file's longest instruction.
            out[key].append(" ".join(_ADDRESS.sub("", line).split()))
    return out


def compare_sass(parent: Path, dumps: Path = None) -> list:
    """Every float32 kernel of the parent's K1, K2 and K3 sources against the
    current float32 instantiation of the same name, instruction line by
    instruction line (the parent's K2 with its grid step repaired); the raw
    dumps go to ``dumps`` (default ``parent``)."""
    dumps = parent if dumps is None else dumps
    dumps.mkdir(parents=True, exist_ok=True)
    rows = []
    for source in ("backward_update.cu", "forward_sim.cu", "path_sim.cu"):
        if not (parent / source).exists():
            continue
        src_dir = repaired_forward(parent) if source == "forward_sim.cu" else parent
        stem = Path(source).stem
        before = disassemble(src_dir / source, dumps / f"parent_{stem}.sass")
        after = disassemble(CSRC / source, dumps / f"current_{stem}.sass")
        for key in sorted(k for k in before if k[1] == "float"):
            a, b = before[key], after.get(key, [])
            differ = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
            rows.append(dict(source=source, kernel=key[0], instructions=[len(a), len(b)],
                             differing=differ))
            print(f"[sass parent {source}] {key[0]}: {len(a)} -> {len(b)} instruction lines, "
                  f"{differ} differ")
    return rows


def build_all(opts, parent_sources, variant_sources):
    """The current library (verbose), the parent's and the variants', in
    parallel. Returns (parent or None, {name: variant})."""
    from storage_tpu_torch.ops import csrc

    t0 = time.perf_counter()
    csrc.build(True)
    csrc.kernels()
    variant_dirs = dict(v.split("=", 1) for v in opts.variant)
    with ThreadPoolExecutor(1 + len(variant_dirs)) as pool:
        par = pool.submit(build_library, *parent_sources)
        var = {name: pool.submit(build_library, Path(d), variant_sources, f"variant_{name}", True)
               for name, d in variant_dirs.items()}
        parent = par.result()
        variants = {name: f.result() for name, f in var.items()}
    print(f"[build] {time.perf_counter() - t0:.2f} s; parent "
          f"{'built' if parent else 'absent'}; variants {list(variants)}")
    return parent, variants


def main_f32(opts, result):
    import torch
    from storage_tpu_torch.ops import forward

    parent_dir = repaired_forward(opts.parent) if (opts.parent / "forward_sim.cu").exists() \
        else opts.parent
    parent, variants = build_all(
        opts, (parent_dir, ("backward_update.cu", "forward_sim.cu"), "parent_f32"),
        ("backward_update.cu", "forward_sim.cu"))
    parent_k3 = build_library(opts.parent, ("path_sim.cu",), "parent_path_sim")
    libs = ({"parent": parent} if parent else {}) | {"current": None} | variants
    versions = {name: on_library(lib, forward._forward_sim_cuda) for name, lib in libs.items()}

    captured = chip_smoke.phase_capture()
    result["K1"] = k1_turns(f"K1 launch {chip_smoke.CAPTURE_LAUNCH}", libs, *captured["bwd"])
    args, kw = captured["fwd"]
    n, _, S = args[0].shape
    full_panels = torch.empty((n, 6, S), device="cuda")
    cases = {"D3": dict(kw, panels=None), "panels": dict(kw, panels=full_panels),
             "D5": dict(kw, panels=None, extra_decisions=1)}
    for label, case_kw in cases.items():
        result[f"K2_{label}"] = turns(f"K2 {label}", versions, "current",
                                      lambda fn, case_kw=case_kw: fn(*args, **case_kw))
    del full_panels, cases
    result["K3"] = k3_turns(captured, parent_k3)
    del captured, args
    torch.cuda.empty_cache()
    if parent is not None and not opts.no_wall:
        result["wall"] = wall_turns({"parent": parent, "current": None}, value_main)
    if not opts.no_trace:
        result["trace"] = trace()
    if opts.sass:
        result["sass"] = {**sass_summary("forward_sim_kernelIfLi3"),
                          **sass_summary("path_sim_kernelIfLi3E"),
                          **sass_summary("path_sim_f64_kernelILi3ELb0")}
        result["sass_parent"] = compare_sass(opts.parent)
    k3 = result["K3"].get("paths_differ", 0)
    sass_differ = sum(r["differing"] for r in result.get("sass_parent", []))
    return 1 if k3 or sass_differ else 0


def f64_sources(parent: Path) -> tuple:
    """The sources of ``parent`` that hold the float64 kernels: K1 and K2 in
    the separate ``*_f64.cu`` files where it has them (the port before its
    kernels were templated on the element type), else in the templated
    ``backward_update.cu`` and ``forward_sim.cu``; K3's float64 mode always
    in ``path_sim.cu``."""
    split = tuple(s for s in ("backward_update_f64.cu", "forward_sim_f64.cu")
                  if (parent / s).exists())
    return (split or ("backward_update.cu", "forward_sim.cu")) + ("path_sim.cu",)


def ulps_apart(a, b):
    """(equal share, max ulp) of two float64 tensors of one shape, on the card."""
    import torch

    d = (a.view(torch.int64) - b.view(torch.int64)).abs()
    return float((d == 0).double().mean()), int(d.max())


def k3_f64_turns(source, versions, reps=5):
    """K3 float64 on one of f64_main's streaming sources, in its three modes
    (one launch over the horizon, the checkpoint pass, the span from the
    middle checkpoint): each version in turn, then in reverse order, its
    outputs against the current kernel's in ulp (bit for bit only where the
    versions round alike)."""
    import torch
    from storage_tpu_torch.models import simulation

    coeffs, S, key, antithetic, every = source
    n, F = coeffs.decay.shape
    f64 = torch.float64
    tables = simulation._path_kernel_tables(coeffs, key, "cuda", f64)
    num_ckpt = -(-n // every)
    mid = num_ckpt // 2
    outs = {"paths": torch.empty((n, F, S), dtype=f64, device="cuda"),
            "checkpoints": torch.empty((num_ckpt, F, S), dtype=f64, device="cuda"),
            "span": torch.empty((every, F, S), dtype=f64, device="cuda")}
    ckpts = torch.empty_like(outs["checkpoints"])
    with library(None):
        simulation._launch_path_sim(tables, ckpts, S, antithetic, every=every)
    kw = {"paths": {}, "checkpoints": dict(every=every),
          "span": dict(y0=ckpts[mid], step0=mid * every, num_steps=every)}

    def call(lib, mode):
        with library(lib):
            return simulation._launch_path_sim(tables, outs[mode], S, antithetic, **kw[mode])

    rows = {}
    for mode in outs:
        ref = call(versions["current"], mode).clone()
        apart = {name: ulps_apart(call(lib, mode), ref) for name, lib in versions.items()}
        order = list(versions) + list(reversed(versions))
        times = {name: [] for name in versions}
        for name in order:
            times[name].append(chip_smoke.cuda_ms(lambda: call(versions[name], mode),
                                                  4 * reps if mode == "span" else reps))
        del ref
        for name in versions:
            print(f"[turns K3 f64 {mode} {tuple(outs[mode].shape)}] {name}: "
                  f"{' / '.join(f'{t:.4f}' for t in times[name])} ms; against current: "
                  f"{apart[name][0]:.6f} equal, max {apart[name][1]} ulp")
        rows[mode] = dict(order=order, ms=times, equal_share={k: v[0] for k, v in apart.items()},
                          max_ulp={k: v[1] for k, v in apart.items()})
    del outs, ckpts
    torch.cuda.empty_cache()
    return rows


def main_f64(opts, result):
    import torch
    import storage_tpu_torch as tt
    from storage_tpu_torch.ops import forward

    parent, variants = build_all(
        opts, (opts.parent, f64_sources(opts.parent), "parent_f64"),
        ("backward_update.cu", "forward_sim.cu", "path_sim.cu"))
    libs = ({"parent": parent} if parent else {}) | {"current": None} | variants

    def having(entry):  # the versions whose own library has the entry point
        return {name: lib for name, lib in libs.items() if lib is None or lib.has(entry)}

    fwd_spans = chip_smoke._stream_counts(341, chip_smoke.NUM_SIMS, 3,
                                          chip_smoke.DEFAULT_PATH_BUDGET, itemsize=8)[0]
    with chip_smoke._streamed_recording("float64", chip_smoke.CAPTURE_LAUNCH,
                                        fwd_spans["forward_sim"]) as rec:
        t0 = time.perf_counter()
        first = value_f64()
        torch.cuda.synchronize()
    print(f"[f64 capture] recording run {time.perf_counter() - t0:.3f} s, NPV {first.npv:.6f}")

    recorded = rec.recorded

    def on_card(name):
        args, kw = recorded.pop(name)
        return tuple(a.cuda() for a in args), kw

    result["K1_f64"] = k1_turns(f"K1 f64 launch {chip_smoke.CAPTURE_LAUNCH}",
                                having("backward_update_f64_launch"), *on_card("K1"))
    for label in ("K2 span", "K2 tail"):
        args, kw = on_card(label)
        result[label.replace(" ", "_") + "_f64"] = turns(
            f"{label} f64 ({args[0].shape[0]} steps)",
            {name: on_library(lib, forward._forward_sim_cuda)
             for name, lib in having("forward_sim_f64_launch").items()},
            "current", lambda fn, args=args, kw=kw: fn(*args, **kw))
        del args
    result["K3_f64"] = k3_f64_turns(rec.path_sets[0], having("path_sim_f64_launch"))
    del rec, recorded
    torch.cuda.empty_cache()
    if not opts.no_wall:
        result["wall_f64"] = wall_turns({name: libs[name] for name in ("parent", "current")
                                         if name in libs}, value_f64, "wall f64")
    if not opts.no_trace:
        tt.reset_launch_counts()
        result["trace_f64"] = trace(value_f64)
        result["trace_f64"]["launches"] = tt.launch_counts()
    return 0


def main_flips(opts, result):
    """The float32 K2's near-tie flips with the parent's source as it is and
    with the current one."""
    import storage_tpu_torch as tt
    from storage_tpu_torch.ops.ratchets import INTERP_POLY

    parent, _ = build_all(opts, (opts.parent, ("forward_sim.cu",), "parent_flips"), ())
    libs = {"parent": parent, "current": None}

    def count(label, args, kw, panels=False):
        row = {}
        for name, lib in libs.items():
            with library(lib):
                fl = chip_smoke.forward_flips(args, kw, panels)
            row[name] = dict(flipped=fl["flipped"], per_decision=fl["per_decision"],
                             npv_effect=fl["npv_effect"])
        print(f"[flips {label}] " + "; ".join(
            f"{name} {r['flipped']} paths ({r['per_decision']:.2e} per decision, NPV effect "
            f"{r['npv_effect']:.2e})" for name, r in row.items()))
        result[label] = row

    captured = chip_smoke.phase_capture()
    args, kw = captured["fwd"]
    poly_args = args[:5] + (chip_smoke._poly_pillars(args[5]),) + args[6:]
    count("D3", args, kw)
    count("panels", args, kw, panels=True)
    count("D5", args, dict(kw, extra_decisions=1))
    count("POLY", poly_args, dict(kw, interp_kind=INTERP_POLY))
    del captured, args, poly_args
    n_sim_steps = 8760 * chip_smoke.HOURLY_YEARS
    fwd_spans = chip_smoke._stream_counts(n_sim_steps, chip_smoke.HOURLY_SIMS, 3,
                                          chip_smoke.HOURLY_BUDGET)[0]["forward_sim"]
    with chip_smoke._path_budget(chip_smoke.HOURLY_BUDGET):
        with chip_smoke._streamed_recording("float32", chip_smoke.HOURLY_CAPTURE_LAUNCH,
                                            fwd_spans) as rec:
            chip_smoke.value_hourly(tt, chip_smoke.HOURLY_SIMS, 12, device="cuda")
    for label in ("K2 span", "K2 tail"):
        args, kw = rec.recorded.pop(label)
        count(f"hourly {label.split()[1]}", tuple(a.cuda() for a in args), kw)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=ROOT / "storage_tpu_torch/_build/parent")
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=DIR",
                    help="an edited copy of the current sources (repeatable)")
    ap.add_argument("--no-wall", action="store_true", help="skip the valuation turns")
    ap.add_argument("--no-trace", action="store_true", help="skip the profiler trace")
    ap.add_argument("--sass", action="store_true", help="compare the kernels' machine code")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--f64", action="store_true", help="the float64 kernels and f64_main")
    mode.add_argument("--flips", action="store_true", help="the float32 K2's near-tie flips")
    mode.add_argument("--hourly", action="store_true",
                      help="only the streamed hourly case: untraced, its host parts, traced")
    ap.add_argument("--out", type=Path, default=None,
                    help="default chiprun_out/<mode>.json (kernel_turns, f64_turns, "
                         "k2_flips, hourly_trace)")
    opts = ap.parse_args()
    name = ("f64_turns" if opts.f64 else "k2_flips" if opts.flips
            else "hourly_trace" if opts.hourly else "kernel_turns")
    out = opts.out or ROOT / "chiprun_out" / f"{name}.json"

    import torch
    from storage_tpu_torch.ops import csrc

    card = chip_smoke.phase_device()
    result = dict(card=card, device=torch.cuda.get_device_name(0))
    if opts.hourly:
        csrc.build()
        csrc.kernels()
        result.update(hourly(card))
        rc = 0
    else:
        rc = (main_f64 if opts.f64 else main_flips if opts.flips else main_f32)(opts, result)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(f"[card] {card}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
