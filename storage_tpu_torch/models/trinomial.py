"""One-factor trinomial tree construction (host NumPy, float64).

The port's own copy of the JAX package's ``models/trinomial.py``: the
replacement for the reference's native (NuGet)
``Cmdty.Core.Trees.OneFactorTrinomialTree.CreateTree`` (call site:
``TreeStorageValuationExtensions.cs:93-102``): a recombining trinomial tree on
an Ornstein-Uhlenbeck log-spot deviation process with seasonal (per-period)
spot volatility, drift-calibrated so the probability-weighted node price
equals the forward curve in every period.

Representation is dense arrays instead of linked ``TreeNode`` objects
(SURVEY.md §2.2): with K = 2*j_max + 1 price levels,

- ``values [n, K]``      node spot prices,
- ``probs [n, K]``       unconditional node probabilities (0 for unreachable),
- ``branch_center [n, K]`` central destination level index per node,
- ``branch_probs [n, K, 3]`` down/mid/up transition probabilities,

which the tree engine's DP (``engines/tree.py``) consumes directly.
Construction follows the standard Hull-White trinomial method: node spacing
``dx = sigma_max * sqrt(3 dt)``,
branching matched to the exact OU conditional mean/variance with the central
destination ``round(E[x']/dx)`` (which yields Hull's alternative branching at
the trimmed edges), and a per-period additive log-drift fitted to the forward.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


class TrinomialTree(NamedTuple):
    """Dense recombining trinomial tree over the storage periods."""

    values: np.ndarray  # [n, K] node spot prices
    probs: np.ndarray  # [n, K] unconditional node probabilities
    branch_center: np.ndarray  # [n-1, K] central destination level per node
    branch_probs: np.ndarray  # [n-1, K, 3] (down, mid, up) probabilities

    @property
    def num_levels(self) -> int:
        return self.values.shape[1]


def build_trinomial_tree(
    forwards: np.ndarray,  # [n] forward prices per period
    spot_vols: np.ndarray,  # [n] spot volatility per period
    mean_reversion: float,
    time_delta: float,  # one-period year fraction (reference onePeriodTimeDelta)
) -> TrinomialTree:
    """Build the calibrated tree (host, float64; runs once per valuation)."""
    forwards = np.asarray(forwards, dtype=np.float64)
    spot_vols = np.asarray(spot_vols, dtype=np.float64)
    n = len(forwards)
    if len(spot_vols) != n:
        raise ValueError("forwards and spot_vols must have equal length.")
    a = float(mean_reversion)
    dt = float(time_delta)
    if dt <= 0:
        raise ValueError("time_delta must be positive.")

    sigma_max = float(spot_vols.max())
    if sigma_max <= 0:
        raise ValueError("Spot volatility must be positive.")
    dx = sigma_max * math.sqrt(3.0 * dt)

    # Hull's trimming: mean reversion pulls levels back, bounding the tree.
    if a > 0:
        j_max = max(2, math.ceil(0.184 / (a * dt)))
    else:
        j_max = n  # no reversion: tree can spread one level per step
    j_max = min(j_max, n + 1)
    K = 2 * j_max + 1
    levels = (np.arange(K) - j_max) * dx  # x values per level index

    branch_center = np.zeros((max(n - 1, 0), K), dtype=np.int32)
    branch_probs = np.zeros((max(n - 1, 0), K, 3), dtype=np.float64)
    probs = np.zeros((n, K), dtype=np.float64)
    probs[0, j_max] = 1.0

    decay = math.exp(-a * dt)
    for k in range(n - 1):
        var = spot_vols[k] ** 2 * (
            (1.0 - math.exp(-2.0 * a * dt)) / (2.0 * a) if a > 0 else dt
        )
        mean_next = levels * decay  # exact OU conditional mean per level
        center = np.rint(mean_next / dx).astype(np.int64)
        center = np.clip(center, -j_max + 1, j_max - 1)  # keep all 3 branches in range
        eta = mean_next - center * dx  # offset of the true mean from the center node
        v_plus_eta2 = var + eta**2
        p_up = 0.5 * (v_plus_eta2 / dx**2 + eta / dx)
        p_down = 0.5 * (v_plus_eta2 / dx**2 - eta / dx)
        p_mid = 1.0 - p_up - p_down
        # Strongly seasonal vol on fixed spacing can push a branch probability
        # slightly negative (possible when sigma_k / sigma_max < ~0.87);
        # clamp-and-renormalise, which perturbs only the stressed nodes.
        stacked = np.stack([p_down, p_mid, p_up], axis=-1)
        stacked = np.clip(stacked, 0.0, None)
        stacked /= stacked.sum(axis=-1, keepdims=True)
        branch_center[k] = (center + j_max).astype(np.int32)
        branch_probs[k] = stacked
        # Propagate unconditional probabilities.
        nxt = np.zeros(K, dtype=np.float64)
        for offset, col in ((-1, 0), (0, 1), (1, 2)):
            np.add.at(nxt, branch_center[k] + offset, probs[k] * branch_probs[k, :, col])
        probs[k + 1] = nxt

    # Drift calibration: probability-weighted node price == forward each period
    # (risk-neutral martingale match, the role of the reference tree's drift).
    exp_levels = np.exp(levels)
    values = np.empty((n, K), dtype=np.float64)
    for k in range(n):
        mean_exp = float(np.dot(probs[k], exp_levels))
        shift = math.log(forwards[k]) - math.log(mean_exp)
        values[k] = np.exp(levels + shift)

    return TrinomialTree(
        values=values, probs=probs, branch_center=branch_center, branch_probs=branch_probs
    )


def build_intrinsic_tree(forwards: np.ndarray) -> TrinomialTree:
    """Degenerate single-node-per-period tree: the deterministic forward path.

    Reference: ``TreeStorageValuationExtensions.WithIntrinsicTree``
    (``TreeStorageValuationExtensions.cs:104-124``).
    """
    forwards = np.asarray(forwards, dtype=np.float64)
    n = len(forwards)
    values = forwards[:, None]
    probs = np.ones((n, 1), dtype=np.float64)
    branch_center = np.zeros((max(n - 1, 0), 1), dtype=np.int32)
    branch_probs = np.zeros((max(n - 1, 0), 1, 3), dtype=np.float64)
    branch_probs[:, :, 1] = 1.0
    return TrinomialTree(values, probs, branch_center, branch_probs)
