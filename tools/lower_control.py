"""The control of a benchmark cell where ``portbench/control.py`` cannot read
it: the reference computed one precision down, its uniforms kept inside
(-1, 1), optionally in bfloat16.

    python3 tools/lower_control.py --workload daily_value_1m_f64 --control-seeds 901,902,903 [--out PATH]
    python3 tools/lower_control.py --workload daily_value_131k_panels --dtype bfloat16 --control-seeds 7,8,9

Without ``--dtype`` the control is the one the cell's file names; with it,
the reference in that dtype (``bfloat16``: where the cell's control reads no
further from the float64 reference than the program does, so that a limit
cannot lie between the two).  Two parts of the reference are given a form of
their own, for this process only:

- each uniform, once rounded to the control's dtype, is clamped to the
  largest value of the dtype inside (-1, 1).  The reference rounds uniforms
  before ``erfinv`` (``portbench/reference/threefry.py::normals``), and one
  within 2**-25 of +-1 in float32 (2**-9 in bfloat16) rounds onto it and
  draws an infinite normal, about thirty in a 1M-path float64 valuation, so
  ``control.py`` reads NaN there;
- in bfloat16, the normal equations of each regression are solved in
  float32 (``torch.linalg`` has no bfloat16 solver), the solution rounded to
  bfloat16.

Each control seed's answer (call 0 of a run with that seed) is compared with
the float64 reference, drawn as before, by ``portbench/compare.py``.  Prints
one JSON line per seed, as ``control.py`` does, and writes them to ``--out``
(default ``chiprun_out/lower_control_<cell>.jsonl``).  Nothing of the
benchmark is changed on disk.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def normals_kept_inside(key, shape, device, dtype, draws="float32"):
    """``threefry.normals`` with the uniform, once in ``dtype``, clamped to
    the largest magnitude of ``dtype`` below one."""
    import torch

    from portbench.reference import threefry

    u = threefry.uniform_pm1(key, shape, device) if draws == "float32" else \
        threefry.uniform_pm1_64(key, shape, device)
    u = u.to(dtype)
    if dtype != torch.float64:
        one = torch.ones((), dtype=dtype, device=u.device)
        below = torch.nextafter(one, torch.zeros_like(one))
        u = torch.maximum(torch.minimum(u, below), -below)
    return torch.erfinv(u) * math.sqrt(2.0)


@contextlib.contextmanager
def kept_inside():
    """Within the block, the reference draws through :func:`normals_kept_inside`."""
    from portbench.reference import threefry

    saved = threefry.normals
    threefry.normals = normals_kept_inside
    try:
        yield
    finally:
        threefry.normals = saved


@contextlib.contextmanager
def bfloat16_solves():
    """Within the block, ``torch.linalg.solve_ex`` of bfloat16 operands
    solves in float32 and rounds its solution to bfloat16."""
    import torch

    solve = torch.linalg.solve_ex

    def solve_ex(a, b, **kw):
        if a.dtype != torch.bfloat16:
            return solve(a, b, **kw)
        x, info = solve(a.float(), b.float(), **kw)
        return x.to(torch.bfloat16), info

    torch.linalg.solve_ex = solve_ex
    try:
        yield
    finally:
        torch.linalg.solve_ex = solve


def readings(workload: str, seeds, dtype=None, device="cuda", num_sims=None):
    """Per seed, the numbers of the control (the cell's own, or the
    reference in ``dtype``) against the float64 reference."""
    import torch

    from portbench import check, compare, control
    from portbench.cases import cell

    row = cell(workload)
    cfg, mix = row["cfg"], row["mix"]
    ctrl = row["control"] if dtype is None else {"dtype": dtype}
    S = int(num_sims or mix["num_sims"])
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        with kept_inside(), (bfloat16_solves() if ctrl["dtype"] == "bfloat16"
                             else contextlib.nullcontext()):
            got = control.control_answer(ctrl, cfg, mix, seed, [0], device, S)[0]
        control_s = time.perf_counter() - t0
        ref = check.reference(cfg, mix, seed, [0], device, torch.float64, S)[0]
        rec = {"kind": "control " + json.dumps(ctrl), "seed": seed, "control_s": control_s,
               **compare.numbers(got, ref)}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("lower_control: needs a CUDA device", file=sys.stderr)
        return 2
    out = readings(args.workload, [int(x) for x in args.control_seeds.split(",") if x],
                   args.dtype)
    path = Path(args.out or ROOT / "chiprun_out" / f"lower_control_{args.workload}.jsonl")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(json.dumps(r) + "\n" for r in out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
