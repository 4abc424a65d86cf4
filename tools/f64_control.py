"""The float32 control of a float64 benchmark cell, its uniforms kept inside (-1, 1).

    python3 tools/f64_control.py --workload daily_value_1m_f64 --control-seeds 901,902,903 [--out PATH]

A float64 configuration draws float64 uniforms.  ``portbench``'s reference
rounds them to the control's dtype before ``erfinv``
(``portbench/reference/threefry.py::normals``), and a uniform within 2**-25
of +-1 rounds onto it and draws an infinite normal, about thirty in a 1M-path
valuation; so ``portbench/control.py`` reads NaN npv and deltas in such a
cell.  This tool makes the same readings with each rounded uniform clamped
to the largest value of the dtype inside (-1, 1): the reference computed one
precision down on the same paths.  The float64 reference it is compared
with is drawn as before, bit for bit.  Prints one JSON line per control seed,
as ``control.py`` does, and writes them to ``--out`` (default
``chiprun_out/f64_control_<cell>.jsonl``).  Nothing of the benchmark is
changed on disk.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    from portbench import control

    if not torch.cuda.is_available():
        print("f64_control: needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(x) for x in args.control_seeds.split(",") if x]
    with kept_inside():
        out = control.readings(args.workload, [], seeds)
    path = Path(args.out or ROOT / "chiprun_out" / f"f64_control_{args.workload}.jsonl")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(json.dumps(r) + "\n" for r in out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
