"""Generate the notebooks of ``examples/_make_notebooks.py`` on storage_tpu_torch.

    python examples/_make_torch_notebooks.py [OUT_DIR]

Writes ``torch_storage_valuation_walkthrough.ipynb``,
``torch_multi_factor_gui.ipynb`` and ``torch_creating_storage_instances.ipynb``
into OUT_DIR (default: this file's directory), unexecuted.  The cells are
the JAX notebooks' with ``storage_tpu_torch`` imports.  A notebook that
values starts with a cell tagged ``parameters``, ``DEVICE = "cuda"``, which
every valuation call takes: set it to ``"cpu"`` to run without a card.  A
cell that needs a module beyond the package's own is tagged
``needs-<module>`` (``needs-matplotlib``, ``needs-ipywidgets``), so that a
headless run can leave it out.  Cell ids are fixed, so the files do not
change from one run to the next.
"""
import os
import sys

import nbformat as nbf

HERE = os.path.dirname(os.path.abspath(__file__))
NOTEBOOKS = ("torch_storage_valuation_walkthrough.ipynb", "torch_multi_factor_gui.ipynb",
             "torch_creating_storage_instances.ipynb")
KERNELSPEC = {"display_name": "Python 3", "language": "python", "name": "python3"}
md = nbf.v4.new_markdown_cell


def code(source, *tags):
    cell = nbf.v4.new_code_cell(source)
    if tags:
        cell["metadata"]["tags"] = list(tags)
    return cell


def device_cell():
    return code('DEVICE = "cuda"  # the torch device of every valuation: "cuda", or "cpu"',
                "parameters")


def notebook(cells, stem):
    nb = nbf.v4.new_notebook()
    for i, cell in enumerate(cells):
        cell["id"] = f"{stem}-{i}"
    nb["cells"] = cells
    nb["metadata"]["kernelspec"] = KERNELSPEC
    return nb


def walkthrough():
    return notebook([
        md("""# Valuing a gas storage facility with `storage_tpu_torch`

End-to-end walkthrough of the storage-valuation library's PyTorch port: define
a ratcheted storage facility, build forward/interest-rate curves, value it
under the 3-factor seasonal spot model with least-squares Monte Carlo (LSMC),
and inspect deltas, the expected operation profile and trigger prices.  The
inputs mirror the reference README worked example
(`examples/torch_readme_example.py`).

The same notebook runs on a CUDA card (`DEVICE = "cuda"`: the path
simulation, backward induction and forward pass are hand-written CUDA
kernels) or on the CPU (`DEVICE = "cpu"`, slower: the kernels' plain PyTorch
versions)."""),
        device_cell(),
        code("""import os, sys
sys.path.insert(0, os.path.join(os.getcwd(), ".."))

import numpy as np
import pandas as pd

from storage_tpu_torch import (
    CmdtyStorage, RatchetInterp,
    three_factor_seasonal_value, intrinsic_value, trinomial_value,
)"""),
        md("""## 1. The storage facility

Injection/withdrawal rates depend on inventory through **ratchet tables**
(piecewise-linear in inventory, stepwise in time).  Negative rates are
withdrawals.  Cost parameters are per unit of commodity moved."""),
        code("""storage = CmdtyStorage(
    freq="D",
    storage_start="2021-04-01",
    storage_end="2022-04-01",
    injection_cost=0.01,
    withdrawal_cost=0.025,
    ratchets=[
        ("2021-04-01", [          # applies until the next table
            (0.0,    -150.0, 250.0),
            (2000.0, -200.0, 175.0),
            (5000.0, -260.0, 155.0),
            (7000.0, -275.0, 132.0),
        ]),
        ("2022-10-01", [
            (0.0,    -130.0, 260.0),
            (2000.0, -190.0, 190.0),
            (5000.0, -230.0, 165.0),
            (7000.0, -245.0, 148.0),
        ]),
    ],
    ratchet_interp=RatchetInterp.LINEAR,
)
print(f"{storage.start} .. {storage.end}, "
      f"max inventory {storage.max_inventory(storage.start):,.0f}")"""),
        md("""## 2. Market data

A monthly forward curve forward-filled to daily granularity, and a zero-rate
curve interpolated to daily pillars.  Cash flows settle on the 20th of the
month after delivery."""),
        code("""monthly_index = pd.period_range(start="2021-04-25", periods=25, freq="M")
monthly_fwd_prices = [
    16.61, 15.68, 15.42, 15.31, 15.27, 15.13, 15.96, 17.22, 17.32, 17.66,
    17.59, 16.81, 15.36, 14.49, 14.28, 14.25, 14.32, 14.33, 15.30, 16.58,
    16.64, 16.79, 16.64, 15.90, 14.63,
]
fwd_curve = pd.Series(monthly_fwd_prices, index=monthly_index).resample("D").ffill()

rates = pd.Series(
    [0.005, 0.006, 0.0072, 0.0087, 0.0101, 0.0115, 0.0126],
    index=pd.PeriodIndex(freq="D", data=[
        "2021-04-25", "2021-06-01", "2021-08-01", "2021-12-01",
        "2022-04-01", "2022-12-01", "2023-12-01",
    ]),
)
ir_curve = rates.resample("D").asfreq().interpolate(method="linear")

def settlement_rule(delivery_date):
    return delivery_date.asfreq("M").asfreq("D", "end") + 20"""),
        code("""import matplotlib.pyplot as plt
fwd_curve.plot(figsize=(9, 2.6), title="Daily forward curve")
plt.tight_layout(); plt.show()""", "needs-matplotlib"),
        md("""## 3. LSMC valuation under the 3-factor seasonal model

The spot model has a fast mean-reverting factor, a long-term (non-reverting)
factor and a seasonal factor whose vol peaks each February.  `basis_funcs` is
the regression-basis DSL: monomials in the factor states (`x_st`, `x_lt`,
`x_sw`) and the spot price (`s`)."""),
        code("""results = three_factor_seasonal_value(
    cmdty_storage=storage,
    val_date="2021-04-25",
    inventory=1500.0,
    fwd_curve=fwd_curve,
    interest_rates=ir_curve,
    settlement_rule=settlement_rule,
    num_sims=2000,
    seed=12,
    spot_mean_reversion=91.0,
    spot_vol=0.85,
    long_term_vol=0.30,
    seasonal_vol=0.19,
    basis_funcs="1 + x_st + x_sw + x_lt + s + x_st**2 + x_sw**2 + x_lt**2 + s**2 + s * x_st",
    discount_deltas=True,
    device=DEVICE,
)
print(f"Full NPV:      {results.npv:,.0f}")
print(f"Intrinsic NPV: {results.intrinsic_npv:,.0f}")
print(f"Extrinsic NPV: {results.extrinsic_npv:,.0f}")"""),
        md("""## 4. Risk and operation outputs

* **Deltas** — forward-position equivalents per delivery period (hedge ratios).
* **Expected profile** — sim-average inventory and traded volume paths.
* **Trigger prices** — the spot level at which injecting (resp. withdrawing)
  becomes optimal at the expected inventory, per period."""),
        code("""fig, axes = plt.subplots(1, 3, figsize=(13, 3))
results.deltas.plot(ax=axes[0], title="Deltas")
results.expected_profile["inventory"].plot(ax=axes[1], title="Expected inventory")
tp = results.trigger_prices
tp["inject_trigger_price"].plot(ax=axes[2], label="inject")
tp["withdraw_trigger_price"].plot(ax=axes[2], label="withdraw")
fwd_curve.reindex(tp.index).plot(ax=axes[2], label="forward", linestyle="--")
axes[2].set_title("Trigger prices"); axes[2].legend()
plt.tight_layout(); plt.show()""", "needs-matplotlib"),
        code("""results.expected_profile.head()"""),
        md("""## 5. Cross-checks: intrinsic and trinomial-tree values

The intrinsic engine values the storage on the forward curve alone
(deterministic DP — a lower bound that ignores extrinsic optionality); the
trinomial engine prices a one-factor model on a recombining tree.  All three
engines share the facility/curve plumbing."""),
        code("""intrinsic = intrinsic_value(storage, "2021-04-25", 1500.0, fwd_curve,
                            ir_curve, settlement_rule, device=DEVICE)
spot_vol_curve = pd.Series(0.85, index=pd.period_range("2021-04-25", "2022-04-01", freq="D"))
tree = trinomial_value(storage, "2021-04-25", 1500.0, fwd_curve,
                       spot_volatility=spot_vol_curve, mean_reversion=14.5,
                       time_step=1.0 / 365.0,
                       interest_rates=ir_curve, settlement_rule=settlement_rule,
                       device=DEVICE)
print(f"Intrinsic : {intrinsic.npv:,.0f}")
print(f"Trinomial : {tree:,.0f}")
print(f"LSMC      : {results.npv:,.0f}")"""),
        md("""## 6. Where to go next

* `examples/torch_storage_gui.py` — interactive ipywidgets GUI with editable
  curve and ratchet tables (`torch_multi_factor_gui.ipynb` launches it).
* `examples/torch_async_and_cache.py` — async valuation with
  progress/cancellation.
* `examples/torch_multichip_sharding.py` — the path axis over a mesh of cards.
* `tools/torch_precision_study.py` — float32 against float64 on the same
  paths."""),
    ], "walkthrough")


def gui():
    return notebook([
        md("""# Multi-factor storage valuation GUI

Interactive front-end over `three_factor_seasonal_value` on storage_tpu_torch:
edit valuation scalars, the monthly forward-curve table and the ratchet grid;
import/export curves as CSV; run asynchronously with live progress; inspect
NPVs, deltas, trigger prices and plots.  Equivalent of the reference's
`samples/python/multi_factor_gui.ipynb`."""),
        device_cell(),
        code("""import os, sys
sys.path.insert(0, os.path.join(os.getcwd(), ".."))
from torch_storage_gui import GuiInputs, StorageGui, run_valuation"""),
        code("""gui = StorageGui(device=DEVICE)
gui.show()""", "needs-ipywidgets"),
        md("""Headless use of the same inputs (e.g. for scripting):"""),
        code("""results = run_valuation(GuiInputs(num_sims=2000), device=DEVICE)
print(f"Full NPV: {results.npv:,.0f}  Intrinsic: {results.intrinsic_npv:,.0f}")"""),
    ], "gui")


def creating_storage_instances():
    return notebook([
        md("""# Creating storage instances

How to describe a storage facility with `CmdtyStorage` of storage_tpu_torch —
the equivalent of the reference's `creating_storage_instances.ipynb`.  Every
physical parameter can be a scalar (constant over the facility's life), a
`pandas.Series` (stepwise in time), or a ratchet table (piecewise in inventory
AND stepwise in time)."""),
        code("""import os, sys
sys.path.insert(0, os.path.join(os.getcwd(), ".."))
import pandas as pd
from storage_tpu_torch import CmdtyStorage, RatchetInterp"""),
        md("""## Simple storage: constant rates and bounds"""),
        code("""simple = CmdtyStorage(
    freq="D",
    storage_start="2021-04-01",
    storage_end="2022-04-01",
    injection_cost=0.01,
    withdrawal_cost=0.025,
    min_inventory=0.0,
    max_inventory=1500.0,
    max_injection_rate=25.5,
    max_withdrawal_rate=30.9,
)
p = simple.start
print("inject/withdraw range at 700:", simple.inject_withdraw_range(p, 700.0))
print("inventory bounds:", simple.min_inventory(p), simple.max_inventory(p))"""),
        md("""## Time-varying parameters via pandas Series

Any scalar parameter accepts a Series indexed by period; values forward-fill
to the storage end."""),
        code("""idx = pd.period_range("2021-04-01", "2022-04-01", freq="D")
seasonal_max_inject = pd.Series(25.5, index=idx)
seasonal_max_inject["2021-11-01":] = 15.0   # winter derate
time_varying = CmdtyStorage(
    freq="D", storage_start="2021-04-01", storage_end="2022-04-01",
    injection_cost=0.01, withdrawal_cost=0.025,
    min_inventory=0.0, max_inventory=1500.0,
    max_injection_rate=seasonal_max_inject, max_withdrawal_rate=30.9,
)
print("summer:", time_varying.inject_withdraw_range(pd.Period("2021-06-01", "D"), 700.0))
print("winter:", time_varying.inject_withdraw_range(pd.Period("2021-12-01", "D"), 700.0))"""),
        md("""## Ratchets: inventory-dependent rates

A ratchet table lists `(inventory, withdraw_rate, inject_rate)` pillars; rates
between pillars interpolate linearly (`RatchetInterp.LINEAR`), stepwise
(`STEP`) or with an exact-fit polynomial (`POLYNOMIAL`).  Tables are dated —
each applies from its date until the next table."""),
        code("""ratcheted = CmdtyStorage(
    freq="D", storage_start="2021-04-01", storage_end="2022-04-01",
    injection_cost=0.01, withdrawal_cost=0.025,
    ratchets=[
        ("2021-04-01", [
            (0.0,    -150.0, 250.0),
            (2000.0, -200.0, 175.0),
            (5000.0, -260.0, 155.0),
            (7000.0, -275.0, 132.0),
        ]),
        ("2021-10-01", [
            (0.0,    -130.0, 260.0),
            (7000.0, -245.0, 148.0),
        ]),
    ],
    ratchet_interp=RatchetInterp.LINEAR,
)
for inv in (0.0, 1000.0, 6000.0, 7000.0):
    print(inv, ratcheted.inject_withdraw_range(pd.Period("2021-05-01", "D"), inv))"""),
        md("""## Other physical parameters

* `cmdty_consumed_inject` / `cmdty_consumed_withdraw` — fuel consumed as a
  fraction of volume moved (e.g. compressor gas).
* `inventory_loss` — fractional inventory lost per period.
* `inventory_cost` — per-unit-held cost per period.
* `terminal_storage_npv` — value of inventory left at the end
  (`lambda spot, inventory: ...`); omit it to require empty-at-end.
* `cost_cash_flow_rule` — when costs settle, if different from the commodity."""),
        code("""full = CmdtyStorage(
    freq="D", storage_start="2021-04-01", storage_end="2022-04-01",
    injection_cost=0.01, withdrawal_cost=0.025,
    min_inventory=0.0, max_inventory=1500.0,
    max_injection_rate=25.5, max_withdrawal_rate=30.9,
    cmdty_consumed_inject=0.015, inventory_loss=0.001, inventory_cost=0.002,
    terminal_storage_npv=lambda spot, inventory: 0.95 * spot * inventory,
)
print("must be empty at end:", full.must_be_empty_at_end)
print("terminal value at spot=20, inv=500:", full.terminal_storage_npv(20.0, 500.0))"""),
        md("""## Intra-day and coarser granularities

The `freq` argument accepts '15min', '30min', 'H', 'D', 'M' and 'Q' —
valuation engines operate per period of the chosen granularity."""),
        code("""hourly = CmdtyStorage(
    freq="H", storage_start="2021-04-01", storage_end="2021-04-08",
    injection_cost=0.01, withdrawal_cost=0.02,
    min_inventory=0.0, max_inventory=100.0,
    max_injection_rate=2.0, max_withdrawal_rate=3.0,
)
print(hourly.start, "...", hourly.end)"""),
    ], "creating")


def main(out_dir=HERE):
    os.makedirs(out_dir, exist_ok=True)
    for name, nb in zip(NOTEBOOKS, (walkthrough(), gui(), creating_storage_instances())):
        with open(os.path.join(out_dir, name), "w") as fh:
            nbf.write(nb, fh)
    print(f"notebooks written to {out_dir}")


if __name__ == "__main__":
    main(*sys.argv[1:])
