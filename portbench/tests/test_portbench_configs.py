"""Each configuration builds both sides' inputs, and they describe the same
deployment."""
import numpy as np
import pytest

from portbench import cases
from portbench.reference import context

CONFIGS = [c["name"] for c in cases.benchmark()["configs"]]


@pytest.mark.parametrize("name", CONFIGS)
def test_both_sides_build(name):
    from storage_tpu_torch.compile import build_valuation_context

    cfg = cases.load_json("configs", name)
    kw = cases.port_case(cfg)
    ctx = context.build(cfg)
    port = build_valuation_context(kw["cmdty_storage"], kw["val_date"], kw["inventory"],
                                   kw["fwd_curve"], kw["interest_rates"], kw["settlement_rule"],
                                   kw["num_inventory_grid_points"], 1e-12)
    assert port.n_steps == ctx.n
    np.testing.assert_allclose(port.fwd, ctx.fwd, rtol=1e-15)
    np.testing.assert_allclose(port.df_settle, ctx.df_settle, rtol=1e-14)
    np.testing.assert_allclose(port.df_cost, ctx.df_cost, rtol=1e-14)
    np.testing.assert_allclose(port.grids, ctx.grids, rtol=1e-12, atol=1e-9)
    assert len(ctx.basis) == len(cfg["basis"].split("+"))


@pytest.mark.parametrize("name", CONFIGS)
def test_config_file_holds_its_contract_keys(name):
    cfg = cases.load_json("configs", name)
    assert cfg["name"] == name
    for key in ("source", "reduced", "assumed", "guarantees", "dtype"):
        assert key in cfg
    assert cfg["dtype"] == "float32"
