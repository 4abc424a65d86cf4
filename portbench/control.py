"""The readings that the limits of a cell are set from, in one process.

    python3 portbench/control.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9 [--out F]

For each of ``--seeds``: one call of the timed path at the cell's own size
(call 0 of a run with that seed), the float64 reference for it, and the
numbers of :mod:`portbench.compare` (the lower readings).  For each of
``--control-seeds``: the reference put in the program's place and computed
one precision below what the configuration states, as the cell file's
``control`` names it (``dtype``, ``tf32`` for matrix products in TF32, and
``intrinsic_dtype`` for the intrinsic dynamic program, which has no matrix
product for TF32 to reach), compared with the float64 reference the same
way (the upper readings).  Prints one JSON line per seed and writes them
all to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_answer(control: dict, cfg, mix, seed, calls, device, num_sims):
    """The control's answers: the reference in ``control["dtype"]``, its
    matrix products in TF32 where ``control["tf32"]``, its intrinsic in
    ``control["intrinsic_dtype"]`` (default the same dtype)."""
    import torch

    from portbench import check

    dtype = getattr(torch, control["dtype"])
    intrinsic = getattr(torch, control.get("intrinsic_dtype", control["dtype"]))
    torch.backends.cuda.matmul.allow_tf32 = bool(control.get("tf32"))
    try:
        return check.reference(cfg, mix, seed, calls, device, dtype, num_sims, intrinsic)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def readings(workload, seeds, control_seeds, device="cuda", num_sims=None, cfg_overrides=None):
    import gc

    import torch

    from portbench import check, compare, driver
    from portbench.cases import cell as load_cell

    row = load_cell(workload)
    cfg, mix = dict(row["cfg"]), row["mix"]
    cfg.update(cfg_overrides or {})
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for seed in seeds:
        program = driver.Program(cfg, mix, seed, device, num_sims)
        S = program.num_sims
        t0 = time.perf_counter()
        got = program.call(0)
        call_s = time.perf_counter() - t0
        del program
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ref = check.reference(cfg, mix, seed, [0], device, torch.float64, S)[0]
        rec = {"kind": "program", "seed": seed, "call_s": call_s,
               "reference_s": time.perf_counter() - t0, **compare.numbers(got, ref)}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    for seed in control_seeds:
        S = int(num_sims or mix["num_sims"])
        t0 = time.perf_counter()
        got = control_answer(row["control"], cfg, mix, seed, [0], device, S)[0]
        control_s = time.perf_counter() - t0
        ref = check.reference(cfg, mix, seed, [0], device, torch.float64, S)[0]
        rec = {"kind": "control " + json.dumps(row["control"]), "seed": seed,
               "control_s": control_s,
               **compare.numbers(got, ref)}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    def ints(text):
        return [int(x) for x in text.split(",") if x]

    out = readings(args.workload, ints(args.seeds), ints(args.control_seeds))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
