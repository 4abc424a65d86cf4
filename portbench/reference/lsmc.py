"""Plain least-squares Monte Carlo storage valuation (Boogert and de Jong's
method with the lower-bound estimator), the benchmark's reference.

Given a :class:`~portbench.reference.context.Context` it values the storage
as specified, in plain tensor operations of ``dtype`` (float64 for the
reference; the lower-precision control runs it in float32 with TF32
matrix products):

- Paths: the regression set from ``prng_key(seed)``, the valuation set from
  ``fold_in(key, 1)``, each drawn block by block (:mod:`.threefry`) and
  stepped through the exact OU update.
- Backward induction over the regression set, period by period from the
  end: the next period's values on its grid are regressed on the basis of
  this period's spot and factors (columns standardised over the sims, the
  target centred on its sim-mean, a ridge of ``1e-6 S``, the zero fit where
  the system is singular); each grid point
  takes the decision (full withdrawal, none, full injection, clipped to the
  next period's space) that maximises the immediate cash flow plus the
  fitted continuation, and is worth its immediate cash flow plus the
  simulated continuation of that decision (linear interpolation on the
  next grid).
- The valuation period is deterministic: one decision against the
  sim-mean of the next values.
- Forward pass over the valuation set with the fitted regressions: each sim
  takes the best decision by immediate cash flow plus fitted continuation;
  NPV is the mean of the summed cash flows, deltas the discounted mean net
  volume times spot over forward, the expected profile the sim-means, and
  trigger prices come from the sim-mean fitted continuation at the expected
  inventory.
- Intrinsic value: the same dynamic program on the forward curve, in
  ``intrinsic_dtype`` (float64 for the reference; the control runs it in
  bfloat16, the step below float32 for work with no matrix product).

It imports nothing of the program under test.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .context import Context, capacity
from .threefry import DRAW_BLOCK, block_normals, fold_in, prng_key

RIDGE = 1e-6
NUM_TRIGGER_VOLUMES = 10


# --------------------------------------------------------------------------- #
# Paths                                                                       #
# --------------------------------------------------------------------------- #


def factor_paths(ctx: Context, key, num_sims: int, antithetic: bool, device, dtype,
                 draws="float32"):
    """``[m+1, F, S]`` factor states of the simulated periods, from the
    uniforms of a ``draws`` (the configuration's precision) valuation."""
    n_sim, F = ctx.decay.shape
    decay = torch.as_tensor(ctx.decay, dtype=dtype, device=device)
    chol = torch.as_tensor(ctx.chol, dtype=dtype, device=device)
    out = torch.empty((n_sim, F, num_sims), dtype=dtype, device=device)
    y = torch.zeros((F, num_sims), dtype=dtype, device=device)
    for b0 in range(0, n_sim, DRAW_BLOCK):
        z = block_normals(key, b0, F, num_sims, antithetic, device, dtype, draws)
        for c in range(min(DRAW_BLOCK, n_sim - b0)):
            k = b0 + c
            # The correlated increment written out, so no matrix product
            # (and no TF32 in the control) touches the paths.
            inc = chol[k, :, 0, None] * z[c, 0]
            for f in range(1, F):
                inc = inc + chol[k, :, f, None] * z[c, f]
            y = decay[k, :, None] * y + inc
            out[k] = y
        del z
    return out


def spots(ctx: Context, factors, k: int):
    vols = torch.as_tensor(ctx.vols[k], dtype=factors.dtype, device=factors.device)
    return torch.exp(float(ctx.drift[k]) + (vols[:, None] * factors[k]).sum(dim=0))


def design(ctx: Context, factors, k: int, spot) -> torch.Tensor:
    """``[S, B]`` basis columns of period ``k``."""
    cols = []
    for sp, fp in ctx.basis:
        col = torch.ones_like(spot)
        if sp:
            col = col * spot ** sp
        for f, p in enumerate(fp):
            if p:
                col = col * factors[k, f] ** p
        cols.append(col)
    return torch.stack(cols, dim=1)


def standardise(x):
    mean = x.mean(dim=0)
    sd = torch.sqrt(((x - mean) ** 2).mean(dim=0))
    const = sd <= 1e-12 * (1.0 + mean.abs())
    mean = torch.where(const, torch.zeros_like(mean), mean)
    sd = torch.where(const, torch.ones_like(sd), sd)
    return mean, sd


# --------------------------------------------------------------------------- #
# Decisions                                                                   #
# --------------------------------------------------------------------------- #


def rates(table: np.ndarray, inv):
    """Min and max rates at inventories ``inv`` (a tensor): linear between
    pillars, constant beyond the ends."""
    x, lo_r, hi_r = (torch.as_tensor(np.ascontiguousarray(table[:, c]), dtype=inv.dtype,
                                     device=inv.device)
                     for c in range(3))
    i = torch.clamp(torch.searchsorted(x, inv.contiguous(), right=True) - 1, 0, len(x) - 2)
    w = torch.clamp((inv - x[i]) / (x[i + 1] - x[i]), 0.0, 1.0)
    return lo_r[i] + (lo_r[i + 1] - lo_r[i]) * w, hi_r[i] + (hi_r[i + 1] - hi_r[i]) * w


def decisions(table, inv, next_lo: float, next_hi: float):
    """``[..., 3]`` candidate volumes: full withdrawal, none, full injection,
    each clipped to the next period's space (no zero when the space forces a
    move: the injection is repeated)."""
    min_r, max_r = rates(table, inv)
    w = torch.where(inv + min_r > next_hi, next_hi - inv, torch.where(
        inv + min_r > next_lo, min_r, next_lo - inv))
    i = torch.where(inv + max_r < next_lo, next_lo - inv, torch.where(
        inv + max_r < next_hi, max_r, next_hi - inv))
    has_zero = (w < 0) & (i > 0)
    mid = torch.where(has_zero, torch.zeros_like(w), i)
    return torch.stack([w, mid, i], dim=-1)


def index_on_grid(x, lo: float, hi: float, G: int):
    """Lower grid index ``j`` in [0, G-2] and weight ``w`` of ``x`` on
    ``linspace(lo, hi, G)``; a one-point space gives (0, 0)."""
    if hi - lo <= 0:
        return torch.zeros_like(x, dtype=torch.int64), torch.zeros_like(x)
    t = (x - lo) / ((hi - lo) / (G - 1))
    j = torch.clamp(torch.floor(t), 0, G - 2).to(torch.int64)
    return j, torch.clamp(t - j.to(x.dtype), 0.0, 1.0)


def cash(ctx: Context, k: int, volume, price):
    """Immediate discounted cash flow of injecting ``volume`` (negative:
    withdrawing) at ``price`` in decision period ``k``."""
    cost = torch.where(volume > 0, ctx.inject_cost * volume, -ctx.withdraw_cost * volume)
    return -volume * price * float(ctx.df_settle[k]) - cost * float(ctx.df_cost[k])


# --------------------------------------------------------------------------- #
# Backward induction                                                          #
# --------------------------------------------------------------------------- #


@dataclass
class Policy:
    coeffs: list  # per simulated decision period, [B, G]
    means: list  # [B]
    sds: list  # [B]
    vbars: list  # [G] sim-mean of the next period's values
    cont_mean0: torch.Tensor  # [G] sim-mean of the first simulated period's values


def fit(ctx: Context, factors) -> Policy:
    """Backward induction over the regression set ``[m+1, F, S]``."""
    dtype, device = factors.dtype, factors.device
    m = factors.shape[0] - 1
    G, S = ctx.num_grid, factors.shape[2]
    v = torch.zeros((G, S), dtype=dtype, device=device)  # empty at the end: worth nothing
    coeffs, means, sds, vbars = [None] * m, [None] * m, [None] * m, [None] * m
    for k in range(m - 1, -1, -1):
        p = ctx.first + k  # the decision period
        spot = spots(ctx, factors, k)
        x = design(ctx, factors, k, spot)
        mean, sd = standardise(x)
        xs = (x - mean) / sd
        vbar = v.mean(dim=1)
        vc = v - vbar[:, None]
        gram = xs.T @ xs + RIDGE * S * torch.eye(xs.shape[1], dtype=dtype, device=device)
        # A singular system gives the zero fit (the continuation's sim-mean).
        beta, info = torch.linalg.solve_ex(gram, (vc @ xs).T)
        ok = torch.isfinite(beta) & (info == 0)
        beta = torch.where(ok, beta, torch.zeros_like(beta))  # [B, G]
        coeffs[k], means[k], sds[k], vbars[k] = beta, mean, sd, vbar
        fitted = vbar[:, None] + beta.T @ xs.T  # [G, S] on the next grid
        grid = torch.as_tensor(ctx.grids[p], dtype=dtype, device=device)
        vols = decisions(ctx.pillars[p], grid, float(ctx.lo[p + 1]), float(ctx.hi[p + 1]))
        best_fit = best_val = None
        for d in range(vols.shape[1]):
            j, w = index_on_grid(grid + vols[:, d], float(ctx.lo[p + 1]), float(ctx.hi[p + 1]), G)
            imm = cash(ctx, p, vols[:, d, None], spot[None, :])
            tot = imm + fitted[j] * (1 - w)[:, None] + fitted[j + 1] * w[:, None]
            val = imm + v[j] * (1 - w)[:, None] + v[j + 1] * w[:, None]
            if best_fit is None:
                best_fit, best_val = tot, val
            else:
                better = tot > best_fit
                best_fit = torch.where(better, tot, best_fit)
                best_val = torch.where(better, val, best_val)
        v = best_val
    return Policy(coeffs, means, sds, vbars, v.mean(dim=1))


# --------------------------------------------------------------------------- #
# Forward pass                                                                #
# --------------------------------------------------------------------------- #


def _interp(values, j, w):
    return values[..., j] * (1 - w) + values[..., j + 1] * w


def triggers(ctx: Context, p: int, mean_cont, inv: float):
    """Trigger volumes and prices at the expected inventory of decision
    period ``p`` against the sim-mean continuation ``mean_cont [G]``:
    the price at which each of ten volumes up to the largest injection
    (withdrawal) is worth as much as the smallest move on that side."""
    dtype, device = mean_cont.dtype, mean_cont.device
    x = torch.tensor([inv], dtype=dtype, device=device)
    d = decisions(ctx.pillars[p], x, float(ctx.lo[p + 1]), float(ctx.hi[p + 1]))[0]
    big = torch.finfo(dtype).max
    max_i, max_w = d.max(), d.min()
    alt_i = torch.where(d >= 0, d, torch.full_like(d, big)).min()
    alt_w = torch.where(d <= 0, d, torch.full_like(d, -big)).max()
    steps = torch.arange(1, NUM_TRIGGER_VOLUMES + 1, dtype=dtype, device=device)
    G = ctx.num_grid

    def cont(vol):
        return _interp(mean_cont, *index_on_grid(inv + vol, float(ctx.lo[p + 1]),
                                                 float(ctx.hi[p + 1]), G))

    def cost(vol):
        return torch.where(vol > 0, ctx.inject_cost * vol, -ctx.withdraw_cost * vol) * \
            float(ctx.df_cost[p])

    def price(vols, alt):
        denom = float(ctx.df_settle[p]) * (vols - alt)
        num = cont(vols) - cont(alt) - (cost(vols) - cost(alt))
        return torch.where(denom != 0, num / torch.where(denom != 0, denom, 1.0),
                           torch.zeros_like(denom))

    vi = alt_i + steps * (max_i - alt_i) / NUM_TRIGGER_VOLUMES
    vw = alt_w + steps * (max_w - alt_w) / NUM_TRIGGER_VOLUMES
    has_i = bool((max_i > 0) & (max_i > alt_i))
    has_w = bool((max_w < 0) & (max_w < alt_w))
    nan = float("nan")
    return [float(vi[-1]) if has_i else nan, float(price(vi, alt_i)[-1]) if has_i else nan,
            float(vw[-1]) if has_w else nan, float(price(vw, alt_w)[0]) if has_w else nan]


def reprice(ctx: Context, policy: Policy, factors, discount_deltas: bool, panels: bool = False):
    """Forward pass of ``policy`` over the valuation set ``[m+1, F, S]``.
    Returns a dict of float64 NumPy arrays: ``npv``, ``deltas [n+1]``,
    ``profile [n+1, 6]``, ``triggers [n, 4]``, ``headroom [n, 2]`` (the next
    period's space above and below the expected inventory, where the
    triggers are taken), ``capacity`` and, with ``panels``, the per-sim
    panels ``[n+1, 6, S]``."""
    dtype, device = factors.dtype, factors.device
    m, S, G, n = factors.shape[0] - 1, factors.shape[2], ctx.num_grid, ctx.n
    dfd = ctx.df_settle if discount_deltas else np.ones(n)
    profile = np.zeros((n + 1, 6))
    deltas = np.zeros(n + 1)
    trig = np.zeros((n, 4))
    headroom = np.zeros((n, 2))
    panel = np.zeros((n + 1, 6, S)) if panels else None

    # The valuation period: every sim takes the same decision.
    inv0 = ctx.inventory
    d0 = decisions(ctx.pillars[0], torch.tensor([inv0], dtype=dtype, device=device),
                   float(ctx.lo[1]), float(ctx.hi[1]))[0]
    j, w = index_on_grid(inv0 + d0, float(ctx.lo[1]), float(ctx.hi[1]), G)
    imm0 = cash(ctx, 0, d0, float(ctx.fwd[0]))
    best = int(torch.argmax(imm0 + _interp(policy.cont_mean0, j, w)))
    vol0, pv0 = float(d0[best]), float(imm0[best])
    profile[0] = (inv0, vol0, 0.0, 0.0, -vol0, pv0)
    deltas[0] = -vol0 * dfd[0]
    trig[0] = triggers(ctx, 0, policy.cont_mean0, inv0)
    headroom[0] = (ctx.hi[1] - inv0, inv0 - ctx.lo[1])
    if panels:
        panel[0] = np.array(profile[0])[:, None]

    inv = torch.full((S,), inv0 + vol0, dtype=dtype, device=device)
    pv = torch.zeros((S,), dtype=dtype, device=device)
    for k in range(m):
        p = ctx.first + k
        spot = spots(ctx, factors, k)
        xs = (design(ctx, factors, k, spot) - policy.means[k]) / policy.sds[k]
        fitted = policy.vbars[k][None, :] + xs @ policy.coeffs[k]  # [S, G]
        lo, hi = float(ctx.lo[p + 1]), float(ctx.hi[p + 1])
        vols = decisions(ctx.pillars[p], inv, lo, hi)  # [S, 3]
        best_tot = best_vol = best_imm = None
        for d in range(vols.shape[1]):
            j, w = index_on_grid(inv + vols[:, d], lo, hi, G)
            cont = fitted.gather(1, j[:, None])[:, 0] * (1 - w) + \
                fitted.gather(1, (j + 1)[:, None])[:, 0] * w
            imm = cash(ctx, p, vols[:, d], spot)
            tot = imm + cont
            if best_tot is None:
                best_tot, best_vol, best_imm = tot, vols[:, d], imm
            else:
                better = tot > best_tot
                best_tot = torch.where(better, tot, best_tot)
                best_vol = torch.where(better, vols[:, d], best_vol)
                best_imm = torch.where(better, imm, best_imm)
        mean_inv = float(inv.mean())
        profile[p] = (mean_inv, float(best_vol.mean()), 0.0, 0.0, float(-best_vol.mean()),
                      float(best_imm.mean()))
        deltas[p] = float((-best_vol * spot).mean()) / ctx.fwd[p] * dfd[p]
        trig[p] = triggers(ctx, p, fitted.mean(dim=0), mean_inv)
        headroom[p] = (hi - mean_inv, mean_inv - lo)
        if panels:
            panel[p] = torch.stack([inv, best_vol, torch.zeros_like(inv), torch.zeros_like(inv),
                                    -best_vol, best_imm]).double().cpu().numpy()
        inv = inv + best_vol
        pv = pv + best_imm
    profile[n, 0] = float(inv.mean())
    if panels:
        panel[n, 0] = inv.double().cpu().numpy()
    out = dict(npv=pv0 + float(pv.double().mean()), deltas=deltas, profile=profile, triggers=trig,
               headroom=headroom, capacity=capacity(ctx))
    if panels:
        out["panels"] = panel
    return out


# --------------------------------------------------------------------------- #
# Intrinsic value                                                             #
# --------------------------------------------------------------------------- #


def intrinsic(ctx: Context, dtype=torch.float64) -> float:
    """The dynamic program on the forward curve, in ``dtype`` on the host:
    values on each period's grid from the end back, then the path from the
    starting inventory; the NPV is its summed cash flows."""
    n, G = ctx.n, ctx.num_grid

    def best(k, inv, v_next):
        lo, hi = float(ctx.lo[k + 1]), float(ctx.hi[k + 1])
        d = decisions(ctx.pillars[k], inv, lo, hi)
        j, w = index_on_grid(inv[:, None] + d, lo, hi, G)
        imm = cash(ctx, k, d, float(ctx.fwd[k]))
        return d, imm, imm + v_next[j] * (1 - w) + v_next[j + 1] * w

    values = [None] * n + [torch.zeros(G, dtype=dtype)]
    for k in range(n - 1, -1, -1):
        _, _, tot = best(k, torch.as_tensor(ctx.grids[k], dtype=dtype), values[k + 1])
        values[k] = tot.max(dim=1).values
    inv = torch.tensor([ctx.inventory], dtype=dtype)
    npv = torch.zeros((), dtype=dtype)
    for k in range(n):
        d, imm, tot = best(k, inv, values[k + 1])
        i = int(torch.argmax(tot[0]))
        inv, npv = inv + d[0, i], npv + imm[0, i]
    return float(npv)


# --------------------------------------------------------------------------- #
# The calls the benchmark times                                               #
# --------------------------------------------------------------------------- #


def keys(seed: int):
    reg = prng_key(seed)
    return reg, fold_in(reg, 1)


def value(ctx: Context, seed: int, num_sims: int, antithetic: bool, discount_deltas: bool,
          device, dtype=torch.float64, panels: bool = False, draws="float32",
          intrinsic_dtype=None):
    """The valuation of ``three_factor_seasonal_value`` for ``seed``: NPV,
    deltas, expected profile, trigger prices and intrinsic NPV (and with
    ``panels`` the per-sim panels and both sets' spots), in ``dtype`` and the
    intrinsic in ``intrinsic_dtype`` (default ``dtype``)."""
    reg_key, val_key = keys(seed)
    reg = factor_paths(ctx, reg_key, num_sims, antithetic, device, dtype, draws)
    policy = fit(ctx, reg)
    extra = {}
    if panels:
        extra["spots_reg"] = torch.stack([spots(ctx, reg, k) for k in range(reg.shape[0])]) \
            .double().cpu().numpy()
    del reg
    val = factor_paths(ctx, val_key, num_sims, antithetic, device, dtype, draws)
    out = reprice(ctx, policy, val, discount_deltas, panels)
    if panels:
        extra["spots_val"] = torch.stack([spots(ctx, val, k) for k in range(val.shape[0])]) \
            .double().cpu().numpy()
    del val
    out.update(extra)
    out["intrinsic_npv"] = intrinsic(ctx, intrinsic_dtype or dtype)
    return out
