"""The reference README worked example on storage_tpu_torch (the PyTorch port).

The inputs of ``examples/readme_example.py`` (1-year daily ratcheted storage,
3-factor seasonal model, 2,000 sims, seed 12); prints Full / Intrinsic /
Extrinsic NPV plus delta and trigger-price summaries, as that script does.

    python examples/torch_readme_example.py                # on the GPU
    python examples/torch_readme_example.py --device cpu   # the kernels' plain versions
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import pandas as pd

from storage_tpu_torch import CmdtyStorage, RatchetInterp, three_factor_seasonal_value

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
args = parser.parse_args()

storage = CmdtyStorage(
    freq="D",
    storage_start="2021-04-01",
    storage_end="2022-04-01",
    injection_cost=0.01,
    withdrawal_cost=0.025,
    ratchets=[
        (
            "2021-04-01",  # applies from 2021-04-01 (inclusive) until the next table
            [
                (0.0, -150.0, 250.0),
                (2000.0, -200.0, 175.0),
                (5000.0, -260.0, 155.0),
                (7000.0, -275.0, 132.0),
            ],
        ),
        (
            "2022-10-01",
            [
                (0.0, -130.0, 260.0),
                (2000.0, -190.0, 190.0),
                (5000.0, -230.0, 165.0),
                (7000.0, -245.0, 148.0),
            ],
        ),
    ],
    ratchet_interp=RatchetInterp.LINEAR,
)

monthly_index = pd.period_range(start="2021-04-25", periods=25, freq="M")
monthly_fwd_prices = [
    16.61, 15.68, 15.42, 15.31, 15.27, 15.13, 15.96, 17.22, 17.32, 17.66,
    17.59, 16.81, 15.36, 14.49, 14.28, 14.25, 14.32, 14.33, 15.30, 16.58,
    16.64, 16.79, 16.64, 15.90, 14.63,
]
fwd_curve = pd.Series(monthly_fwd_prices, index=monthly_index).resample("D").ffill()

rates = pd.Series(
    [0.005, 0.006, 0.0072, 0.0087, 0.0101, 0.0115, 0.0126],
    index=pd.PeriodIndex(
        freq="D",
        data=["2021-04-25", "2021-06-01", "2021-08-01", "2021-12-01",
              "2022-04-01", "2022-12-01", "2023-12-01"],
    ),
)
ir_curve = rates.resample("D").asfreq().interpolate(method="linear")


def settlement_rule(delivery_date):
    return delivery_date.asfreq("M").asfreq("D", "end") + 20


results = three_factor_seasonal_value(
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
    device=args.device,
)

print(f"Full NPV:\t{results.npv:,.0f}")
print(f"Intrinsic NPV:\t{results.intrinsic_npv:,.0f}")
print(f"Extrinsic NPV:\t{results.extrinsic_npv:,.0f}")
print("\nDeltas (head):")
print(results.deltas.head())
print("\nExpected profile (head):")
print(results.expected_profile.head())
print("\nTrigger prices (first rows with both sides):")
print(results.trigger_prices.dropna().head())
