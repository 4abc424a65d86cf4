"""Split the traced calls of a benchmark cell by the program's own spans.

    python3 tools/trace_spans.py --workload <cell> --seed <n> [--calls N] [--out PATH]

Runs the cell's program on a CUDA card as ``portbench``'s traced run does
(its set-up and warm-up call, then the traffic file's traced calls under
``torch.profiler`` with device activity only and the harness's synchronised
spans on), but hands every call of the program a ``profile_sink`` (the
valuation entry, and ``engines.lsmc.reprice``, which the harness calls
without one) and keeps each call's spans and counters
(``storage_tpu_torch.utils.profiling``).  Prints, and writes as JSON
(default ``chiprun_out/trace_spans_<cell>.json``):

- per span name its time and self time per call, and the counters
  (``host_syncs``, ``uploads``, ``decision_steps``; where the backward
  scan's glue is a CUDA graph, ``glue_graph_captures`` and
  ``glue_graph_replays``; where path sets stream, ``stream_checkpoints`` and
  ``streamed_spans``, beside the path kernel's launches a call counted on
  the device, ``k3_launches``; where per-sim panels are fetched, the
  ``PanelFetch`` spans and ``panel_frames``, ``panel_blocks``,
  ``panel_d2h_bytes`` and ``panel_host_bytes``);
- the device's idle time under each innermost span (a ``Wait`` or ``Sync``
  named with its parent; time outside every call: ``outside the program``),
  which adds up to the traced window's idle time;
- each of the ten longest idle gaps with the span most of it falls under;
- the readings of the span metrics PERF.md section 7 proposes, with the
  backward scan's host time a decision step (``BackwardScan``) beside K1's
  device time a step.

Spans are timed on ``time.time_ns()``, the clock of the profiler's device
events, so both are compared as they are.  Nothing here changes the
benchmark; it imports ``portbench`` to make the same calls.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.yardstick import is_k1  # noqa: E402
from storage_tpu_torch.utils.profiling import Stopwatches, self_times_ns  # noqa: E402

OUTSIDE = "outside the program"
FRONT_END = ("Compile", "Intrinsic", "DeviceInputs", "Assembly")
PANEL_COUNTERS = ("panel_frames", "panel_blocks", "panel_d2h_bytes", "panel_host_bytes")

Event = Tuple[float, float, str]  # device activity: (start us, end us, name)


# --------------------------------------------------------------------------- #
# Span arithmetic (no device needed)                                          #
# --------------------------------------------------------------------------- #

def _label(spans: Sequence, i: int) -> str:
    """A span's name in the split: a ``Wait`` or ``Sync`` with its parent's."""
    s = spans[i]
    if s.name in ("Wait", "Sync") and s.parent >= 0:
        return f"{spans[s.parent].name}/{s.name}"
    return s.name


def segments(calls: Sequence[Sequence], t0: int, t1: int) -> List[Tuple[int, int, int, int]]:
    """``[t0, t1)`` (ns) cut where the innermost open span changes:
    ``(start, end, call index, span index)``, span index -1 outside every
    call.  Each call's spans nest (a call's ``spans`` list)."""
    edges = []  # (time, order, call, span, opening)
    for c, spans in enumerate(calls):
        for i, s in enumerate(spans):
            edges.append((s.start_ns, 1, c, i, True))
            edges.append((s.end_ns, 0, c, i, False))
    edges.sort()
    out, stack, cur = [], [], t0
    for t, _, c, i, opening in edges:
        t = min(max(t, t0), t1)
        if t > cur:
            out.append((cur, t, *(stack[-1] if stack else (-1, -1))))
            cur = t
        if opening:
            stack.append((c, i))
        elif (c, i) in stack:
            stack.remove((c, i))
    if t1 > cur:
        out.append((cur, t1, *(stack[-1] if stack else (-1, -1))))
    return out


def idle_intervals(events: Sequence[Event], t0: int, t1: int) -> List[Tuple[int, int]]:
    """The device's idle intervals (ns) within ``[t0, t1)``: the window less
    the union of its activity."""
    out, cur = [], t0
    for s, e, _ in sorted(events):
        s, e = int(s * 1e3), int(e * 1e3)
        if s > cur:
            out.append((cur, min(s, t1)))
        cur = max(cur, e)
        if cur >= t1:
            break
    if cur < t1:
        out.append((cur, t1))
    return [(a, b) for a, b in out if b > a]


def _overlaps(segs, idle):
    """(segment, idle ns inside it) for every segment that meets an idle interval."""
    j = 0
    for seg in segs:
        a, b = seg[0], seg[1]
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        k, got = j, 0
        while k < len(idle) and idle[k][0] < b:
            got += min(b, idle[k][1]) - max(a, idle[k][0])
            k += 1
        if got:
            yield seg, got


def idle_by_span(calls, events, t0: int, t1: int) -> Dict[str, float]:
    """Seconds of device idle under each innermost span (``_label``), the
    rest ``OUTSIDE``; the values add up to the window's idle time."""
    out: Dict[str, float] = defaultdict(float)
    for (a, b, c, i), got in _overlaps(segments(calls, t0, t1), idle_intervals(events, t0, t1)):
        out[OUTSIDE if i < 0 else _label(calls[c], i)] += got / 1e9
    return dict(out)


def idle_under(calls, events, t0: int, t1: int, names: Sequence[str]) -> float:
    """Seconds of device idle under any span named in ``names`` or below one."""
    total = 0
    for (a, b, c, i), got in _overlaps(segments(calls, t0, t1), idle_intervals(events, t0, t1)):
        while i >= 0 and calls[c][i].name not in names:
            i = calls[c][i].parent
        total += got if i >= 0 else 0
    return total / 1e9


def named_gaps(calls, events, t0: int, t1: int, k: int = 10) -> List[Tuple[str, float]]:
    """The ``k`` longest idle intervals, each with the span that holds most of it."""
    segs = segments(calls, t0, t1)
    out = []
    for a, b in sorted(idle_intervals(events, t0, t1), key=lambda g: g[0] - g[1])[:k]:
        share: Dict[str, int] = defaultdict(int)
        for (sa, sb, c, i), got in _overlaps(segs, [(a, b)]):
            share[OUTSIDE if i < 0 else _label(calls[c], i)] += got
        out.append((max(share, key=share.get)[:63], (b - a) / 1e9))
    return out


def span_times(calls) -> Dict[str, Dict[str, float]]:
    """Per span label: its time and self time, in s per call (summed over a
    call's spans of that label)."""
    tot: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0.0])
    for spans in calls:
        own = self_times_ns(spans)
        for i, s in enumerate(spans):
            row = tot[_label(spans, i)]
            row[0] += (s.end_ns - s.start_ns) / 1e9
            row[1] += own[i] / 1e9
    n = max(len(calls), 1)
    return {k: {"s": v[0] / n, "self_s": v[1] / n} for k, v in tot.items()}


def readings(entry: str, calls, counters, events, t0: int, t1: int) -> Dict[str, float]:
    """The proposed per-layer readings of the calls (means per call)."""
    times = span_times(calls)
    n = len(calls)

    def t(name, key="s"):
        return times.get(name, {}).get(key, 0.0)

    def per_call(key):  # a count every call makes alike; NaN where calls differ
        got = {c.get(key, 0) for c in counters}
        return got.pop() if len(got) == 1 else float("nan")

    out = {"host_syncs": per_call("host_syncs"), "uploads": per_call("uploads"),
           "device_inputs_s": t("DeviceInputs")}
    if any("stream_checkpoints" in c for c in counters):  # streamed path sets
        out.update(stream_checkpoints=per_call("stream_checkpoints"),
                   streamed_spans=per_call("streamed_spans"),
                   stream_checkpoints_s=t("StreamCheckpoints"), stream_span_s=t("StreamSpan"))
    if any("panel_frames" in c for c in counters):  # per-sim panels fetched
        out.update({k: per_call(k) for k in PANEL_COUNTERS}, panel_fetch_s=t("PanelFetch"))
    if any("glue_graph_replays" in c for c in counters):  # the glue as a CUDA graph
        out.update(glue_graph_captures=per_call("glue_graph_captures"),
                   glue_graph_replays=per_call("glue_graph_replays"))
    steps = sum(c.get("decision_steps", 0) for c in counters)
    if steps:
        out["backward_step_host_us"] = 1e6 * t("BackwardScan") * n / steps
        out["k1_step_device_us"] = sum(e - s for s, e, name in events if is_k1(name)) / steps
    if entry == "value":
        out.update(compile_s=t("Compile"), intrinsic_s=t("Intrinsic"),
                   assembly_s=t("Assembly"),
                   front_end_idle_s=idle_under(calls, events, t0, t1, FRONT_END) / n,
                   progress_wait_s=t("Progress/Wait"),
                   host_other_s=t("All") - sum(t(p) for p in Stopwatches.CORE_PHASES))
        out["front_end_s"] = sum(t(x) for x in FRONT_END)
    else:
        out.update(triggers_s=t("StackedOutputs", "self_s"),
                   program_idle_s=idle_under(calls, events, t0, t1, ("All",)) / n)
    return out


# --------------------------------------------------------------------------- #
# The traced run                                                              #
# --------------------------------------------------------------------------- #

def traced(workload: str, seed: int, calls: int = 0) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from unittest import mock

    from portbench import driver, trace, yardstick
    from portbench.cases import cell
    from storage_tpu_torch.engines import lsmc

    row = cell(workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    program = driver.Program(row["cfg"], row["mix"], seed, "cuda")
    program.call(-1)
    torch.cuda.synchronize()
    calls = calls or int(row["mix"]["trace_calls"])
    got = []

    def sink(sw):
        got.append(sw)

    program.profile_sink = sink
    program.span_sync = True
    repricing = mock.patch.object(lsmc, "reprice", functools.partial(lsmc.reprice,
                                                                     profile_sink=sink))
    with repricing, profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0, w0 = time.time_ns(), time.perf_counter()
        for i in range(calls):
            program.call(i)
        torch.cuda.synchronize()
        t1, window = time.time_ns(), time.perf_counter() - w0
    events = trace._device_events(prof)
    spans = [sw.spans for sw in got]
    counters = [dict(sw.counters) for sw in got]
    idle = idle_by_span(spans, events, t0, t1)
    busy = yardstick.busy_us(events) / 1e6
    return {
        "workload": workload, "seed": seed, "calls": calls, "window_s": window,
        "device": torch.cuda.get_device_name(0),
        "idle_s": window - busy, "device_idle_pct": 100.0 * (1.0 - busy / window),
        "k3_launches": sum(yardstick.is_k3(n) for _, _, n in events) / calls,
        "counters": counters, "spans": span_times(spans),
        "idle_by_span": sorted(idle.items(), key=lambda kv: -kv[1])[:10],
        "idle_by_span_total_s": sum(idle.values()),
        "named_gaps": named_gaps(spans, events, t0, t1),
        "readings": readings(row["mix"]["entry"], spans, counters, events, t0, t1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=0, help="traced calls (default: the mix's)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("trace_spans: needs a CUDA device; no result", file=sys.stderr)
        return 2
    res = traced(args.workload, args.seed, args.calls)
    out = Path(args.out or ROOT / "chiprun_out" / f"trace_spans_{args.workload}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    print(f"{res['workload']}: {res['calls']} calls, window {res['window_s']:.4f} s, idle "
          f"{res['idle_s']:.4f} s ({res['device_idle_pct']:.2f}%), split "
          f"{res['idle_by_span_total_s']:.4f} s; K3 launches a call {res['k3_launches']}; "
          f"counters {res['counters'][0]}")
    for name, v in sorted(res["spans"].items(), key=lambda kv: -kv[1]["s"]):
        print(f"  span {name:<34} {v['s']:.6f} s  self {v['self_s']:.6f} s")
    for name, v in res["idle_by_span"]:
        print(f"  idle {name:<34} {v:.6f} s")
    for name, v in res["named_gaps"]:
        print(f"  gap  {name:<34} {v:.6f} s")
    got = res["readings"]
    if "backward_step_host_us" in got:
        print(f"  backward step: host {got['backward_step_host_us']:.3f} us (BackwardScan), "
              f"K1 device {got['k1_step_device_us']:.3f} us; glue graph captures "
              f"{got.get('glue_graph_captures', 0)}, replays {got.get('glue_graph_replays', 0)} "
              "a call")
    if "panel_frames" in got:
        print(f"  panels: {got['panel_frames']} frames, {got['panel_blocks']} blocks, "
              f"{got['panel_d2h_bytes']} bytes to the host, {got['panel_host_bytes']} bytes "
              f"of host arrays, PanelFetch {got['panel_fetch_s']:.6f} s a call")
    print("  readings " + json.dumps(res["readings"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
