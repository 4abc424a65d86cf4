"""The benchmark's yardstick: the card's published peaks, each kernel's
least time from the operations and bytes its launch needs, the least time
of the work of one call, and the arithmetic on a device trace (busy
intervals, idle gaps, the backward window's other kernels).

The bound functions are copies of ``chip_smoke.py::k1_bound`` / ``k2_bound``
/ ``k3_bound`` (each input byte read once, each output byte written once;
operations counted per element from the kernels' arithmetic); the trace
arithmetic follows ``tools/kernel_turns.py::trace``.  Copies, so that a
change to either file does not move the benchmark.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit: HBM3 bytes per
# second, float32 and float64 operations outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_FP64_FLOPS = 34e12
# Not published: 32-bit integer operations taken at a quarter of the float32
# rate (the integer pipes' share of an SM's issue), the repository's own figure.
PEAK_INT32_OPS = PEAK_FP32_FLOPS / 4

K1_NAME = "backward_update_kernel"
K2_NAME = "forward_sim_kernel"
K3_NAMES = ("path_sim_kernel", "path_sim_f64_kernel")


def _bound(nbytes, flops, int_ops=0, itemsize=4):
    peak_flops = PEAK_FP64_FLOPS if itemsize == 8 else PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(flops / peak_flops, int_ops / PEAK_INT32_OPS) * 1e3  # separate pipes
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(S, G, D, B, F, itemsize=4):
    """(ms, by) of one K1 launch: V_next read and V_out written once, both
    factor rows, the table and geometry read once, the partials written
    once; per sim D G (2B + 3) flops for the fitted totals, 10 G for the
    winner's actual total and centred value, 2 (B+1)(G + B+1) for the
    partials."""
    B1 = B + 1
    nbytes = (itemsize * (2 * F * S + 2 * G * S + D * G * (B + 2) + D * G + G + B1 * (G + B1))
              + 4 * D * G)
    flops = S * (D * G * (2 * B + 3) + 10 * G + 2 * B1 * (G + B1))
    return _bound(nbytes, flops, itemsize=itemsize)


def k2_bound(n, S, F, B, D, panels, itemsize=4):
    """(ms, by) of one K2 launch over n steps: the factor paths read once,
    inventories in and out, PVs out, the panels written once when asked for;
    per sim and step 5B + 2F + 30 flops for the spot, design row and rates,
    D (5(B+1) + 23) for the decisions and B + 8 for the sums."""
    nbytes = itemsize * (n * F * S + 3 * S + (6 * S * n if panels else 0))
    flops = n * S * (5 * B + 2 * F + 30 + D * (5 * (B + 1) + 23) + B + 8)
    return _bound(nbytes, flops, itemsize=itemsize)


def k3_bound(n, S, F, draw_sims, rows=None, entering_state=False, itemsize=4):
    """(ms, by) of one K3 launch over n steps: the ``rows`` (default n)
    states ``[F, S]`` written once, the entering state read once when given;
    per drawn element 75 integer operations (threefry2x32 and the counter)
    and 55 flops (uniform map, log1p, the Giles polynomial, scaling), per
    path element 2F + 1 flops of the OU update."""
    rows = n if rows is None else rows
    draws = n * F * draw_sims
    nbytes = itemsize * (rows * F * S + (F * draw_sims if entering_state else 0))
    per_draw = 85 if itemsize == 8 else 55
    return _bound(nbytes, per_draw * draws + (2 * F + 1) * n * F * S, 75 * draws,
                  itemsize=itemsize)


# --------------------------------------------------------------------------- #
# The work of one call                                                        #
# --------------------------------------------------------------------------- #

NUM_FACTORS = 3  # the three-factor seasonal model


def call_bounds(entry: str, n_sim: int, S: int, cfg: dict, panels: bool) -> Dict[str, float]:
    """The least time (ms) of each kernel's work in one call, from the work
    the call needs and not from how the program splits it into launches:
    ``entry`` "value" (a full valuation over ``n_sim`` simulated periods,
    ``n_sim - 1`` of them decisions) or "reprice" (one path set and one
    forward pass).  K1: one backward update of every decision step; K2: one
    forward pass over the decision steps; K3: each path set drawn once over
    the horizon and, where the set is larger than the configuration's path
    budget (so it cannot be held and its spans are drawn again), once more
    without writing the paths."""
    F, G = NUM_FACTORS, int(cfg["num_inventory_grid_points"])
    D = 3 + 2 * int(cfg.get("extra_decisions") or 0)
    B = len(cfg["basis"].split("+"))
    itemsize = 8 if cfg["dtype"] == "float64" else 4
    m = n_sim - 1
    draw = (S + 1) // 2 if cfg["antithetic"] else S
    path_set = k3_bound(n_sim, S, F, draw, itemsize=itemsize)[0]
    budget = cfg.get("max_path_bytes")
    if budget is not None and n_sim * F * S * itemsize > budget:
        path_set += k3_bound(n_sim, S, F, draw, rows=0, itemsize=itemsize)[0]
    k2 = k2_bound(m, S, F, B, D, panels, itemsize)[0]
    if entry == "reprice":
        return {"k1": 0.0, "k2": k2, "k3": path_set}
    return {"k1": m * k1_bound(S, G, D, B, F, itemsize)[0], "k2": k2, "k3": 2 * path_set}


# --------------------------------------------------------------------------- #
# Trace arithmetic                                                            #
# --------------------------------------------------------------------------- #

Event = Tuple[float, float, str]  # (start us, end us, name)


def busy_us(events: Sequence[Event]) -> float:
    """Length of the union of the events' intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e, _ in sorted(events):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def gaps(events: Sequence[Event]) -> List[Tuple[float, float, str, str]]:
    """Idle gaps between the union's intervals: (start us, length us, the
    kernel before, the kernel after)."""
    out, cur_e, cur_n = [], None, None
    for s, e, n in sorted(events):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s - cur_e, cur_n, n))
        if cur_e is None or e >= cur_e:
            cur_e, cur_n = e, n
    return out


def is_k1(name: str) -> bool:
    return K1_NAME in name


def is_k2(name: str) -> bool:
    return K2_NAME in name


def is_k3(name: str) -> bool:
    return any(k in name for k in K3_NAMES)


def short_name(name: str) -> str:
    """A kernel's name without template arguments and parameters."""
    for k in (K1_NAME, K2_NAME) + K3_NAMES:
        if k in name:
            return k
    return name.split("(")[0].split("<")[0].strip()[:80]
