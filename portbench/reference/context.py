"""The storage deployment of a configuration file, worked out from its raw
numbers in NumPy float64: the active periods, the ratchet tables per
period, the reachable inventory space, the inventory grids, forward prices,
discount factors and the three-factor model's exact discretisation.

Semantics (those of the valuation under test, written down independently):

- Periods run from the valuation period to the storage end; each but the
  last is a decision period.  A ratchet table applies from its date until
  the next table's; a period's inventory bounds are its table's lowest and
  highest pillar.  A storage with no terminal value must be empty at the end.
- The inventory space is the intersection of forward reachability from the
  starting inventory and backward reachability from the end bounds; the
  backward bounds are the roots of ``x (1 - loss) + rate(x) = bound``, found
  here by bisection.
- Each period's grid is ``G`` evenly spaced points over its space.
- Commodity cash flows settle on the settlement rule's day, costs on the
  period's own day; a flow on a later day than the valuation day is
  discounted by ``exp(-r t)``, ``t`` in days / 365, ``r`` the rate curve's
  value on the flow's day.
- The model is three uncorrelated factors (spot mean-reverting, long-term,
  seasonal with a sinusoidal vol peaking on 1 February), simulated exactly:
  ``y_k = e^{-a dt} y_{k-1} + L_k z_k`` and ``ln S_k = ln F_k - V_k / 2 +
  sum_f sigma_f y_f``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SECONDS_PER_YEAR_MODEL = 365.25 * 86400.0
SECONDS_PER_YEAR_ACT365 = 365.0 * 86400.0


def _unit(freq: str) -> str:
    return {"D": "D", "h": "h"}[freq]


def _period(text: str, freq: str) -> np.datetime64:
    return np.datetime64(text, _unit(freq))


def _seconds(periods) -> np.ndarray:
    return periods.astype("datetime64[s]").astype(np.int64).astype(np.float64)


def _days(periods) -> np.ndarray:
    return periods.astype("datetime64[D]")


@dataclass
class Context:
    periods: np.ndarray  # [n+1] datetime64 of the active periods
    first: int  # 1 when the valuation period is a decision period (solved exactly)
    inventory: float
    pillars: list  # per decision period, [P, 3] (inventory, min rate, max rate)
    lo: np.ndarray  # [n+1] inventory space
    hi: np.ndarray
    grids: np.ndarray  # [n+1, G]
    fwd: np.ndarray  # [n+1]
    inject_cost: float
    withdraw_cost: float
    df_settle: np.ndarray  # [n]
    df_cost: np.ndarray  # [n]
    decay: np.ndarray  # [m+1, F] per simulated period
    chol: np.ndarray  # [m+1, F, F]
    vols: np.ndarray  # [m+1, F]
    drift: np.ndarray  # [m+1]
    basis: list  # [(spot power, (factor powers...)), ...]
    num_grid: int

    @property
    def n(self) -> int:
        return len(self.periods) - 1


def _ratchet_tables(cfg, periods, freq):
    dated = sorted((_period(d, freq), np.array(rows, dtype=np.float64))
                   for d, rows in cfg["ratchets"])
    tables = []
    for p in periods:
        current = None
        for d, t in dated:
            if d <= p:
                current = t[np.argsort(t[:, 0])]
        if current is None:
            raise ValueError(f"no ratchet table covers {p}")
        tables.append(current)
    return tables


def rate_at(table: np.ndarray, x: float):
    """(min rate, max rate) at inventory ``x``: linear between pillars,
    constant beyond the end pillars."""
    return (float(np.interp(x, table[:, 0], table[:, 1])),
            float(np.interp(x, table[:, 0], table[:, 2])))


def _bisect(f, a: float, b: float) -> float:
    fa = f(a)
    for _ in range(200):
        mid = 0.5 * (a + b)
        if mid in (a, b):
            break
        fm = f(mid)
        if (fm > 0) == (fa > 0):
            a, fa = mid, fm
        else:
            b = mid
    return 0.5 * (a + b)


def inventory_space(tables, min_inv, max_inv, loss, start, empty_at_end):
    n = len(tables)
    fmin = np.empty(n + 1)
    fmax = np.empty(n + 1)
    fmin[0] = fmax[0] = start
    for k in range(n):
        fmin[k + 1] = max(fmin[k] * (1 - loss) + rate_at(tables[k], fmin[k])[0], min_inv[k + 1])
        fmax[k + 1] = min(fmax[k] * (1 - loss) + rate_at(tables[k], fmax[k])[1], max_inv[k + 1])
    bmin = np.empty(n + 1)
    bmax = np.empty(n + 1)
    bmin[n] = 0.0 if empty_at_end else min_inv[n]
    bmax[n] = 0.0 if empty_at_end else max_inv[n]
    for k in range(n - 1, 0, -1):
        t = tables[k]
        lo_k, hi_k = min_inv[k], max_inv[k]
        after_min = lambda x: x * (1 - loss) + rate_at(t, x)[0]  # noqa: E731
        after_max = lambda x: x * (1 - loss) + rate_at(t, x)[1]  # noqa: E731
        # Highest inventory from which a full withdrawal reaches the next
        # period's maximum; lowest from which a full injection reaches its minimum.
        if after_min(hi_k) <= bmax[k + 1] and bmin[k + 1] <= after_max(hi_k):
            bmax[k] = hi_k
        else:
            bmax[k] = _bisect(lambda x: after_min(x) - bmax[k + 1], t[0, 0], hi_k)
        if after_min(lo_k) <= bmax[k + 1] and bmin[k + 1] <= after_max(lo_k):
            bmin[k] = lo_k
        else:
            bmin[k] = _bisect(lambda x: after_max(x) - bmin[k + 1], lo_k, t[-1, 0])
    bmin[0] = bmax[0] = start
    lo = np.maximum(fmin, bmin)
    hi = np.minimum(fmax, bmax)
    lo[0] = hi[0] = start
    if np.any(lo > hi):
        raise ValueError("inventory constraints cannot be met")
    return lo, hi


def forward_curve(spec, periods):
    if spec["kind"] == "monthly_ffill":
        months = periods.astype("datetime64[M]")
        idx = (months - np.datetime64(spec["start"], "M")).astype(np.int64)
        return np.asarray(spec["values"], dtype=np.float64)[idx]
    raise ValueError(f"unknown forward curve kind {spec['kind']!r}")


def rates_on(spec, days) -> np.ndarray:
    if spec is None:
        return np.zeros(len(days))
    if spec["kind"] == "daily_linear":
        pd_ = np.array([np.datetime64(d, "D") for d, _ in spec["pillars"]])
        x = (pd_ - pd_[0]).astype(np.int64).astype(np.float64)
        q = (days - pd_[0]).astype(np.int64).astype(np.float64)
        if np.any(q < 0) or np.any(q > x[-1]):
            raise ValueError("cash-flow day outside the rate curve")
        return np.interp(q, x, [r for _, r in spec["pillars"]])
    raise ValueError(f"unknown rate curve kind {spec['kind']!r}")


def settle_days(rule, periods) -> np.ndarray:
    days = _days(periods)
    if rule is None:
        return days
    if rule["kind"] == "month_end_plus_days":
        month_end = (periods.astype("datetime64[M]") + 1).astype("datetime64[D]") - 1
        return month_end + int(rule["days"])
    raise ValueError(f"unknown settlement rule {rule['kind']!r}")


def discount(rates_spec, present_day, days) -> np.ndarray:
    t = (days - present_day).astype(np.int64) / 365.0
    return np.where(days > present_day, np.exp(-t * rates_on(rates_spec, days)), 1.0)


def parse_basis(text: str):
    """Monomials of ``s`` and the three factors, as (spot power, (x_st, x_lt,
    x_sw) powers)."""
    names = {"x_st": 0, "x_lt": 1, "x_sw": 2}
    out = []
    for term in text.replace(" ", "").split("+"):
        sp, fp = 0, [0, 0, 0]
        for factor in term.replace("**", "^").split("*"):
            base, _, power = factor.partition("^")
            p = int(power) if power else 1
            if base == "1":
                continue
            if base == "s":
                sp += p
            else:
                fp[names[base]] += p
        out.append((sp, tuple(fp)))
    return out


def _cont_ext(x, t):
    x = np.asarray(x, dtype=np.float64)
    safe = np.where(x == 0.0, 1.0, x)
    return np.where(x == 0.0, t, (1.0 - np.exp(-safe * t)) / safe)


def build(cfg) -> Context:
    freq = cfg["freq"]
    start, end = _period(cfg["storage_start"], freq), _period(cfg["storage_end"], freq)
    val = _period(cfg["val_date"], freq)
    if not start <= val < end:
        raise ValueError("the reference values a storage between its start and end only")
    periods = np.arange(val, end + 1)
    first = 1
    tables = _ratchet_tables(cfg, periods, freq)
    min_inv = np.array([t[0, 0] for t in tables])
    max_inv = np.array([t[-1, 0] for t in tables])
    if cfg.get("extra_decisions"):
        raise ValueError("the reference values the three decisions (withdraw, hold, inject) only")
    if cfg.get("terminal") != "empty":
        raise ValueError("the reference values storages that must be empty at the end")
    max_inv[-1] = 0.0
    loss = 0.0
    inventory = float(cfg["inventory"])
    lo, hi = inventory_space(tables[:-1], min_inv, max_inv, loss, inventory, True)
    G = int(cfg["num_inventory_grid_points"])
    grids = lo[:, None] + (hi - lo)[:, None] * np.linspace(0.0, 1.0, G)[None, :]
    fwd = forward_curve(cfg["fwd_curve"], periods)
    present = _days(periods[:1])[0]
    decision = periods[:-1]
    df_settle = discount(cfg.get("interest_rates"), present, settle_days(cfg.get("settlement_rule"),
                                                                          decision))
    df_cost = discount(cfg.get("interest_rates"), present, _days(decision))

    # Three-factor seasonal model over the simulated periods.
    model = cfg["model"]
    sim = periods[first:]
    sec = _seconds(sim)
    times = (sec - _seconds(periods[:1])[0]) / SECONDS_PER_YEAR_ACT365
    peak = _seconds(np.array([np.datetime64(f"{str(val)[:4]}-02-01T00", "s")]))[0]
    t_peak = (sec - peak) / SECONDS_PER_YEAR_MODEL
    vols = np.stack([np.full(len(sim), model["spot_vol"]), np.full(len(sim), model["long_term_vol"]),
                     np.sin(2 * np.pi * t_peak + np.pi / 2) * model["seasonal_vol"] / 2], axis=1)
    alphas = np.array([model["spot_mean_reversion"], 0.0, 0.0])
    a_sum = alphas[:, None] + alphas[None, :]
    dts = times - np.concatenate([[0.0], times[:-1]])
    decay = np.exp(-alphas[None, :] * dts[:, None])
    corr = np.eye(3)
    cov = corr[None] * _cont_ext(a_sum[None], dts[:, None, None])
    chol = np.linalg.cholesky(cov)
    variance = np.einsum("kf,kg,fg,kfg->k", vols, vols, corr, _cont_ext(a_sum[None],
                                                                          times[:, None, None]))
    drift = np.log(fwd[first:]) - 0.5 * variance
    return Context(periods=periods, first=first, inventory=inventory, pillars=tables[:-1], lo=lo,
                   hi=hi, grids=grids, fwd=fwd, inject_cost=float(cfg["injection_cost"]),
                   withdraw_cost=float(cfg["withdrawal_cost"]), df_settle=df_settle,
                   df_cost=df_cost, decay=decay, chol=chol, vols=vols, drift=drift,
                   basis=parse_basis(cfg["basis"]), num_grid=G)


def capacity(ctx: Context) -> float:
    return float(max(t[-1, 0] for t in ctx.pillars))
