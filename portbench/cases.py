"""Configuration and traffic files, and the program's inputs built from a
configuration's raw numbers.

Everything here is looked up by name: ``configs/<config>.json`` (the
deployment), ``traffic/<mix>.json`` (the calls a run makes) and
``cells/<cell>.json`` (the limits of the comparison that decides
``correct``, and the control they were set against), with the cell's row
in ``BENCHMARK.json`` naming the config and the mix.
"""
from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(name: str) -> dict:
    """The cell's row of ``BENCHMARK.json`` with its configuration, traffic
    and limits loaded: ``{"name", "config", "traffic", "limits", ...}``."""
    rows = [w for w in benchmark()["workloads"] if w["name"] == name]
    if not rows:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    row = dict(rows[0])
    row["cfg"] = load_json("configs", row["config"])
    row["mix"] = load_json("traffic", row["traffic"])
    limits = load_json("cells", name)
    row["limits"], row["control"] = limits["limits"], limits["control"]
    return row


def port_case(cfg: dict) -> dict:
    """The keyword arguments of ``storage_tpu_torch.three_factor_seasonal_value``
    for a configuration, but for the call's own (sims, seed, device, hooks)."""
    import pandas as pd
    import storage_tpu_torch as st

    freq = cfg["freq"]
    storage = st.CmdtyStorage(
        freq=freq, storage_start=cfg["storage_start"], storage_end=cfg["storage_end"],
        injection_cost=cfg["injection_cost"], withdrawal_cost=cfg["withdrawal_cost"],
        ratchets=[(d, [tuple(r) for r in rows]) for d, rows in cfg["ratchets"]],
        ratchet_interp=getattr(st.RatchetInterp, cfg["ratchet_interp"]),
    )
    spec = cfg["fwd_curve"]
    if spec["kind"] == "monthly_ffill":
        months = pd.period_range(start=spec["start"], periods=len(spec["values"]), freq="M")
        fwd = pd.Series(spec["values"], index=months).resample("D").ffill()
    else:
        raise ValueError(f"unknown forward curve kind {spec['kind']!r}")
    rates = cfg.get("interest_rates")
    if rates is None:
        ir = None
    elif rates["kind"] == "daily_linear":
        pillars = pd.Series([r for _, r in rates["pillars"]],
                            index=pd.PeriodIndex([d for d, _ in rates["pillars"]], freq="D"))
        ir = pillars.resample("D").asfreq().interpolate(method="linear")
    else:
        raise ValueError(f"unknown rate curve kind {rates['kind']!r}")
    rule = cfg.get("settlement_rule")
    if rule is None:
        settle = None
    elif rule["kind"] == "month_end_plus_days":
        days = int(rule["days"])

        def settle(d):
            return d.asfreq("M").asfreq("D", "end") + days
    else:
        raise ValueError(f"unknown settlement rule {rule['kind']!r}")
    model = cfg["model"]
    return dict(
        cmdty_storage=storage, val_date=cfg["val_date"], inventory=cfg["inventory"],
        fwd_curve=fwd, interest_rates=ir, settlement_rule=settle,
        spot_mean_reversion=model["spot_mean_reversion"], spot_vol=model["spot_vol"],
        long_term_vol=model["long_term_vol"], seasonal_vol=model["seasonal_vol"],
        basis_funcs=cfg["basis"], discount_deltas=cfg["discount_deltas"],
        antithetic=cfg["antithetic"], num_inventory_grid_points=cfg["num_inventory_grid_points"],
        extra_decisions=cfg.get("extra_decisions"),
    )


def call_seed(seed: int, i: int) -> int:
    """The seed of a run's call ``i`` (``i = -1``: the warm-up call): a
    different seed for every call, the same for the same run seed."""
    return (int(seed) * 1_000_003 + 7_919 * (i + 2)) % (2 ** 62)
