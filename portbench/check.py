"""Recompute sampled calls with the plain reference and compare.

The reference runs after the window has closed and the program's state has
been freed, in float64 on the same device.  For a reprice cell it fits its
own policy on the run seed's regression set (the program's policy is never
read) and prices each sampled call's valuation set.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from . import compare
from .cases import call_seed
from .reference import context as ref_context
from .reference import lsmc as ref_lsmc
from .reference.threefry import prng_key


def reference(cfg: dict, mix: dict, seed: int, calls: List[int], device, dtype,
              num_sims: int, intrinsic_dtype=None) -> Dict[int, Dict[str, np.ndarray]]:
    """The reference's answer to each of ``calls`` of a run with ``seed``,
    computed in ``dtype``, its intrinsic value in ``intrinsic_dtype``
    (default ``dtype``)."""
    ctx = ref_context.build(cfg)
    anti, dd, draws = cfg["antithetic"], cfg["discount_deltas"], cfg["dtype"]
    out = {}
    if mix["entry"] == "reprice":
        reg = ref_lsmc.factor_paths(ctx, prng_key(seed), num_sims, anti, device, dtype, draws)
        policy = ref_lsmc.fit(ctx, reg)
        del reg
        for i in calls:
            val = ref_lsmc.factor_paths(ctx, prng_key(call_seed(seed, i)), num_sims, anti, device,
                                        dtype, draws)
            out[i] = ref_lsmc.reprice(ctx, policy, val, dd)
            del val
        return out
    for i in calls:
        out[i] = ref_lsmc.value(ctx, call_seed(seed, i), num_sims, anti, dd, device, dtype,
                                panels=bool(mix.get("panels")), draws=draws,
                                intrinsic_dtype=intrinsic_dtype)
    return out


def worst(per_call: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's worst reading over the sampled calls."""
    keys = per_call[0].keys()
    return {k: max(float(d[k]) for d in per_call) for k in keys}


def check(cfg: dict, mix: dict, seed: int, sampled, device, num_sims: int) -> Dict[str, float]:
    """``sampled``: [(call, result)] of the program; returns the worst numbers."""
    import torch

    refs = reference(cfg, mix, seed, [i for i, _ in sampled], device, torch.float64, num_sims)
    return worst([compare.numbers(got, refs[i]) for i, got in sampled])
