"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run: load the program (``storage_tpu_torch``; its CUDA kernels and host
op are built into ``storage_tpu_torch/_build/`` on a checkout's first run),
build the cell's inputs from its configuration file, make one warm-up call
at the cell's shapes, reset the device's peak-memory count, then drive the
cell's traffic in a closed loop with one caller for ``--seconds`` (``--trace
0``: the end-to-end metrics) or trace the traffic file's fixed number of
calls (``--trace 1``: the per-layer metrics).  After the window it frees the
program's state, recomputes calls drawn from the seed with the plain
reference (``portbench/reference``) and prints each compared number beside
its limit on standard error, then one JSON line on standard output.

It needs a CUDA device (exit 2 without one, no result) and refuses to
report a run in which JAX or the JAX package was loaded (exit 3).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = {"jax", "jaxlib", "flax", "storage_tpu"}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _metric_rows(section: str, cell: str) -> list:
    from portbench.cases import benchmark

    return [m for m in benchmark()[section] if cell in m.get("workloads", [cell])]


def run(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
        num_sims=None, max_calls=None, cfg_overrides=None) -> dict:
    """One run of ``workload``; returns the result line as a dict."""
    import numpy as np
    import pandas as pd
    import torch

    from portbench import compare, driver, yardstick
    from portbench import check as checker
    from portbench import trace as tracing
    from portbench.cases import cell as load_cell

    row = load_cell(workload)
    cfg, mix, limits = dict(row["cfg"]), row["mix"], row["limits"]
    cfg.update(cfg_overrides or {})
    cuda = torch.device(device).type == "cuda"
    # The configurations state float32 with TF32 off, whatever the environment.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    program = driver.Program(cfg, mix, seed, device, num_sims)
    S = program.num_sims
    program.call(-1)  # warm-up: every kernel and shape of the cell
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START

    sample = driver.Sample(seed, mix.get("check_calls", 1))
    failed = 0
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu", "count": 1}
    metrics, breakdown = {}, None
    if trace:
        events, window, phases, spans = tracing.traced_calls(program, sample,
                                                             int(mix["trace_calls"]))
        attempted = int(mix["trace_calls"])
        storage = program.kw["cmdty_storage"]
        n_sim = (storage.end - pd.Period(cfg["val_date"], freq=storage.periods.freqstr)).n
        t = tracing.Trace(
            events=events, window_s=window, calls=attempted, steps=n_sim - 1, phases=phases,
            spans=spans, bounds=yardstick.call_bounds(mix["entry"], n_sim, S, cfg,
                                                      bool(mix.get("panels"))))
        metrics = tracing.per_layer(t, _metric_rows("per_layer", workload))
        breakdown = tracing.breakdown(t)
        dev.update(busy_s=t.busy_s(), window_s=window)
    else:
        lat, wall, failed = driver.closed_loop(program, seconds, sample, max_calls)
        attempted = len(lat)
        q = np.percentile(lat, [0, 50, 95, 100])
        print(f"portbench: {attempted} calls in {wall:.3f} s; latency min {q[0]:.4f} "
              f"median {q[1]:.4f} max {q[3]:.4f} s", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    dev["memory_peak_bytes"] = int(peak)
    if not trace:
        done = max(attempted - failed, 1)
        values = {"setup_s": (setup_s, "s"), "valuation_s": (wall / done, "s"),
                  "reprice_ms": (1e3 * wall / done, "ms"), "reprice_p95_ms": (1e3 * q[2], "ms"),
                  "peak_device_gib": (peak / 2**30, "GiB")}
        for m in _metric_rows("end_to_end", workload):
            v, unit = values[m["name"]]
            metrics[m["name"]] = {"value": float(v), "unit": unit}

    # The window is closed: free the program's state, then the reference.
    sampled = list(sample.items)
    del program, sample
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    nums = checker.check(cfg, mix, seed, sampled, device, S) if sampled else {}
    print(f"portbench: reference for calls {[i for i, _ in sampled]} took "
          f"{time.perf_counter() - t_check:.3f} s; unlimited numbers "
          f"{ {k: v for k, v in nums.items() if k not in limits} }", file=sys.stderr)
    correct = failed == 0 and bool(sampled) and compare.judge(nums, limits)
    checked = compare.report(nums, limits)
    line = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checked"] = checked
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from portbench.cases import cell as load_cell

    chips = int(load_cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}; no result",
              file=sys.stderr)
        return 2
    line = run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for name, (value, limit) in line["checked"].items():
        print(f"checked {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
