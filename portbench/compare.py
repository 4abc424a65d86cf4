"""The comparison that decides ``correct``: the numbers that set what the
timed path produced beside the reference's answer for the same call, each
held to the limit its cell's file gives (``cells/<cell>.json``).

Each number is a gap relative to the reference's own scale, so that it
reads the same on every seed:

- ``npv``: |NPV - ref| / |ref|.
- ``deltas``: the largest gap of a period's delta over the largest |delta|.
- ``profile``: over the six expected-profile columns, the largest gap of a
  period over that column's largest |value|.
- ``triggers``: over the four trigger columns (inject volume and price,
  withdraw volume and price), the largest gap of a period where the
  reference gives a value, over that column's largest |value|; where the
  reference gives one and the program none, the program's is taken as 0.
- ``trigger_rows``: the periods and sides where the program gives a trigger
  and the reference none, counted; an exact comparison, limit 0.  Not
  counted is a side blocked by the edge of the next period's inventory
  space, where the reference's expected inventory lies within ``EDGE``
  times the capacity of that edge and the program's trigger volume within
  as much of zero: there the clipped move is zero up to rounding, which
  float32 can leave above zero where float64 makes it zero, and its price
  is a quotient of two roundings.
- ``intrinsic``: |intrinsic NPV - ref| / |ref|.
- ``panels``: the per-sim panels.  For both sets' spots, the mean absolute
  gap over the mean absolute spot; for each of the six decision panels
  (inventory, volume, consumed, loss, net volume, PV), the largest gap of a
  period's sim-mean over that panel's largest |sim-mean|; the largest of
  these.  Sim by sim the panels cannot be compared: at 2,000 paths nearly
  every sim meets a near tie somewhere in 340 periods, which float32 and
  float64 decide apart, so the panels are held by their spots and their
  sim-means, which the program writes sim by sim and the reference works
  out again.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

EDGE = 1e-5  # of the capacity: an inventory this close to an edge is on it


def _rel_max(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max() if b.size else 0.0
    gap = np.abs(a - b).max() if b.size else 0.0
    return float(gap / scale) if scale > 0 else float(gap)


def numbers(got: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> Dict[str, float]:
    out = {"npv": abs(float(got["npv"]) - float(ref["npv"])) / abs(float(ref["npv"]))}
    if "intrinsic_npv" in got:
        out["intrinsic"] = abs(float(got["intrinsic_npv"]) - float(ref["intrinsic_npv"])) / \
            abs(float(ref["intrinsic_npv"]))
    out["deltas"] = _rel_max(got["deltas"], ref["deltas"])
    gp, rp = np.asarray(got["profile"]), np.asarray(ref["profile"])
    out["profile"] = max(_rel_max(gp[:, c], rp[:, c]) for c in range(rp.shape[1]))
    gt, rt = np.asarray(got["triggers"]), np.asarray(ref["triggers"])
    has = ~np.isnan(rt)
    tol = EDGE * float(ref["capacity"])
    rows = 0
    for side in range(2):  # inject (volume column 0), withdraw (column 2)
        vol = gt[:, 2 * side]
        extra = ~has[:, 2 * side] & ~np.isnan(vol)
        on_edge = (np.asarray(ref["headroom"])[:, side] <= tol) & \
            (np.abs(np.nan_to_num(vol)) <= tol)
        rows += int((extra & ~on_edge).sum())
    out["trigger_rows"] = float(rows)
    gt = np.where(np.isnan(gt), 0.0, gt)
    out["triggers"] = max(_rel_max(gt[has[:, c], c], rt[has[:, c], c]) for c in range(4))
    if "panels" in ref:
        gaps = []
        for key in ("spots_reg", "spots_val"):
            gaps.append(np.abs(got[key] - ref[key]).mean() / np.abs(ref[key]).mean())
        r_mean, g_mean = ref["panels"].mean(axis=2), got["panels"].mean(axis=2)
        gaps += [_rel_max(g_mean[:, f], r_mean[:, f]) for f in range(r_mean.shape[1])]
        out["panels"] = float(max(gaps))
    return out


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number with a limit within it (a number that is not finite
    fails), and no limit without its number."""
    return all(k in nums and np.isfinite(nums[k]) and nums[k] <= lim for k, lim in limits.items())


def report(nums: Dict[str, float], limits: Dict[str, float]) -> Dict[str, list]:
    """``{name: [number, limit]}`` for the result line, in the limits' order."""
    return {k: [nums.get(k, float("nan")), lim] for k, lim in limits.items()}
