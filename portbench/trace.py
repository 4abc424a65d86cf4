"""The traced run: a fixed number of calls under ``torch.profiler`` (device
activity only, so that host events neither slow the launches nor flood the
trace), the program's phase stopwatches (``profile_sink``) and the
harness's own spans, then the per-layer metrics read from them.

Each per-layer metric is a file ``metrics/<name>.py`` with a function
``read(t: Trace) -> float | None``; ``None`` means the metric found nothing
to read in this run and is left out of the result line.
"""
from __future__ import annotations

import importlib.util
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from . import yardstick
from .cases import HERE


@dataclass
class Trace:
    events: List[yardstick.Event]  # device activity (start us, end us, name)
    window_s: float  # host wall of the traced calls
    calls: int
    steps: int  # decision steps of one call
    phases: List[Dict[str, float]]  # the program's stopwatches, per value call
    spans: List[tuple]  # the harness's own (name, seconds), per reprice call
    bounds: Dict[str, float]  # least ms of one call's K1 / K2 / K3 work

    def kernels(self, pred) -> List[yardstick.Event]:
        return [e for e in self.events if pred(e[2])]

    def roofline(self, kernel: str, pred) -> Optional[float]:
        """The least time of the traced calls' work of ``kernel`` over its
        launches' summed device time, in percent; None when the call gives
        the kernel no work or the trace holds no launch of it."""
        got = self.kernels(pred)
        if not got or self.bounds[kernel] <= 0:
            return None
        device_ms = sum(e - s for s, e, _ in got) / 1e3
        return 100.0 * self.bounds[kernel] * self.calls / device_ms

    def busy_s(self) -> float:
        return yardstick.busy_us(self.events) / 1e6

    def backward_windows(self) -> Optional[List[List[yardstick.Event]]]:
        """Per call, the device events between its first and last K1 launch;
        None when the K1 launches do not split evenly over the calls."""
        k1 = sorted(self.kernels(yardstick.is_k1))
        per = len(k1) // self.calls
        if not per or len(k1) != per * self.calls:
            return None
        out = []
        for c in range(self.calls):
            first, last = k1[c * per][0], k1[(c + 1) * per - 1][1]
            out.append([e for e in self.events if first <= e[0] <= last])
        return out


def _device_events(prof) -> List[yardstick.Event]:
    from torch.autograd import DeviceType

    # Kineto's own event list: prof.events() builds a Python tree of every
    # event, which takes minutes at millions of launches.
    return sorted((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA)


def traced_calls(program, sample, calls: int):
    """Make ``calls`` calls under the profiler; returns the raw pieces."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    phases = []

    def sink(sw):
        phases.append({p: sw.elapsed(p) for p in sw.PHASES + ("All",)})

    program.profile_sink = sink
    program.span_sync = True
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(calls):
            sample.offer(i, program.call(i))
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    program.profile_sink = None
    program.span_sync = False
    return _device_events(prof), window, phases, list(program.spans)


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer(t: Trace, metrics: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = reader(m["name"])(t)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def breakdown(t: Trace) -> dict:
    """The ten device operations that took most time and the ten longest idle
    gaps, each gap named by the kernels either side of it."""
    totals: Dict[str, float] = {}
    for s, e, n in t.events:
        k = yardstick.short_name(n)
        totals[k] = totals.get(k, 0.0) + (e - s) / 1e6
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    gap_list = sorted(yardstick.gaps(t.events), key=lambda g: -g[1])[:10]
    idle = [[f"after {yardstick.short_name(a)} before {yardstick.short_name(b)}", length / 1e6]
            for _, length, a, b in gap_list]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}
