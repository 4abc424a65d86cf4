"""The port's Excel-UDF facade (``storage_tpu_torch.excel``) against the JAX
package's (``storage_tpu.excel``), on the ranges of ``tests/test_excel.py``.

Each of ``tests/test_excel.py``'s 17 cases is a pair test here: the same
worksheet ranges through both facades, the port's on ``device="cpu"``.
Error strings are equal, decision profiles equal, intrinsic and tree values
within 1e-9.  The three-factor NPVs are float32 LSMC at 256 and 128 paths:
at that size both packages' float32 NPVs lie 0.5-0.8% from their common
float64 value (the same inputs in float64 agree to the last bit, held
below), so the two float32 UDFs are held within ``NPV_RTOL`` of each other
(measured 2.9e-3 and 6.5e-4); the port's UDF equals the port's own direct
call on the same route (the chunked driver, which progress reporting
selects) bit for bit.  Beside the pairs: the three-factor UDF with both
engines in float64 (the JAX one under ``jax.enable_x64``), NPVs equal; and
the signatures, the JAX package's plus ``device`` last on each UDF that
runs an engine.
"""
import datetime
import functools
import inspect
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from storage_tpu import excel as jx  # noqa: E402
from storage_tpu_torch import excel as tx  # noqa: E402
from test_excel import RATCHET_RANGE, date_range_2d  # noqa: E402

torch.set_num_threads(2)

CPU = {"device": "cpu"}
NPV_RTOL = 1e-2  # float32 LSMC at 128-256 paths, port against JAX (see above)
VALUE_RTOL = 1e-9
ENGINE_UDFS = ("storage_value_three_factor", "storage_intrinsic_value",
               "storage_intrinsic_decision_profile", "storage_value_trinomial_tree",
               "storage_value_intrinsic")
CACHE_UDFS = ("create_storage", "subscribe_progress", "subscribe_status",
              "subscribe_result_property")
SETTLE_ROWS = [[f"2021-{m:02d}", f"2021-{m + 1:02d}-20"] for m in (4, 5, 6, 7)]


@pytest.fixture(scope="module")
def curves():
    idx = pd.period_range("2021-04-01", "2021-07-01", freq="D")
    fwd = pd.Series(20.0 + 2.0 * np.sin(np.arange(len(idx)) / 7.0), index=idx)
    rates = pd.Series(0.02, index=idx)
    return fwd, rates


def both(udf, *args, **kwargs):
    """(JAX result, port result) of one UDF on the same ranges; the port's
    engines run on the CPU."""
    port_kwargs = dict(kwargs, **CPU) if udf in ENGINE_UDFS else kwargs
    return getattr(jx, udf)(*args, **kwargs), getattr(tx, udf)(*args, **port_kwargs)


def create_both(name, ratchets=RATCHET_RANGE, interp="PiecewiseLinear", *rest, **kw):
    got = both("create_storage", name, "2021-04-01", "2021-07-01", ratchets, interp, *rest, **kw)
    return got, jx.storage_cache.get(name), tx.storage_cache.get(name)


def assert_same_storage(ref, port, inventories=(0.0, 375.0, 750.0, 1200.0, 1500.0)):
    assert port.numerical_tolerance == ref.numerical_tolerance
    for period in pd.period_range("2021-04-01", "2021-06-30", freq="D")[::7]:
        assert port.max_inventory(period) == ref.max_inventory(period)
        assert port.min_inventory(period) == ref.min_inventory(period)
        for inv in inventories:
            assert tuple(port.inject_withdraw_range(period, inv)) == pytest.approx(
                tuple(ref.inject_withdraw_range(period, inv)), rel=1e-12, abs=1e-12)


def three_factor_args(fwd, rates, **overrides):
    kw = dict(spot_vol=0.8, spot_mean_reversion=12.0, long_term_vol=0.2, seasonal_vol=0.3,
              discount_deltas=False, settle_dates=None, num_sims=256,
              basis_functions="1 + s + x_st + x_lt + x_sw", seed=7, fwd_sim_seed=8)
    kw.update(overrides)
    return (date_range_2d(fwd), date_range_2d(rates)), kw


def sync_args(fwd, rates, ratchets=RATCHET_RANGE, inventory=700.0):
    return ("2021-04-01", "2021-04-01", "2021-07-01", ratchets, "PiecewiseLinear", 0.01, 0.0,
            0.025, 0.0, inventory, date_range_2d(fwd), date_range_2d(rates))


class TestCreateStorage:
    def test_creates_and_caches_by_name(self):
        (ref, got), jax_storage, port_storage = create_both(
            "store1", RATCHET_RANGE, "PiecewiseLinear", 0.01, 0.0, 0.025, 0.0)
        assert got == ref == "store1"
        assert_same_storage(jax_storage, port_storage)
        lo, hi = port_storage.inject_withdraw_range(port_storage.start, 750.0)
        assert (lo, hi) == (pytest.approx(-310.0), pytest.approx(255.0))

    def test_two_date_groups(self):
        rng = RATCHET_RANGE + [["2021-06-01", 0.0, 100.0, 150.0],
                               ["2021-06-01", 1500.0, 100.0, 150.0]]
        _, jax_storage, port_storage = create_both(
            "store2", rng, "PiecewiseLinear", 0.01, 0.0, 0.025, 0.0)
        assert_same_storage(jax_storage, port_storage)
        _, hi = port_storage.inject_withdraw_range(pd.Period("2021-06-02", "D"), 750.0)
        assert hi == pytest.approx(100.0)

    def test_blank_row_terminates_range(self):
        rng = RATCHET_RANGE + [["", None, None, None], ["2021-06-01", 0.0, 1.0, 1.0]]
        _, jax_storage, port_storage = create_both("store3", rng, "PiecewiseLinear", 0.01)
        assert_same_storage(jax_storage, port_storage)
        _, hi = port_storage.inject_withdraw_range(pd.Period("2021-06-02", "D"), 750.0)
        assert hi == pytest.approx(255.0)  # second table never parsed

    def test_step_interpolation(self):
        rng = [["2021-04-01", 0.0, 200.0, 100.0], ["2021-04-01", 1000.0, 150.0, 120.0],
               ["2021-04-01", 1500.0, 150.0, 120.0]]
        _, jax_storage, port_storage = create_both("step1", rng, "Step", 0.01)
        assert_same_storage(jax_storage, port_storage)
        p = port_storage.start
        assert port_storage.inject_withdraw_range(p, 500.0).max_inject_withdraw_rate == \
            pytest.approx(200.0)
        assert port_storage.inject_withdraw_range(p, 1200.0).max_inject_withdraw_rate == \
            pytest.approx(150.0)

    def test_polynomial_interpolation(self):
        rng = [["2021-04-01", 0.0, 100.0, 50.0], ["2021-04-01", 750.0, 180.0, 90.0],
               ["2021-04-01", 1500.0, 120.0, 130.0]]
        _, jax_storage, port_storage = create_both("poly1", rng, "Polynomial", 0.01)
        assert_same_storage(jax_storage, port_storage)
        p = port_storage.start
        assert port_storage.inject_withdraw_range(p, 750.0).max_inject_withdraw_rate == \
            pytest.approx(180.0, rel=1e-6)
        mid = port_storage.inject_withdraw_range(p, 375.0).max_inject_withdraw_rate
        assert mid != pytest.approx((100.0 + 180.0) / 2.0, abs=1.0)

    def test_bad_interp_returns_hash_error_string(self):
        ref, got = both("create_storage", "bad", "2021-04-01", "2021-07-01", RATCHET_RANGE,
                        "Cubic", 0.01)
        assert isinstance(got, str) and got.startswith("#ERROR!") and "not recognised" in got
        assert got == ref


class TestThreeFactorAsync:
    def test_async_calc_matches_direct_call(self, curves):
        fwd, rates = curves
        create_both("s3f", RATCHET_RANGE, "PiecewiseLinear", 0.01, 0.0, 0.025, 0.0)
        ranges, kw = three_factor_args(fwd, rates)
        handles = both("storage_value_three_factor", "calc1", "s3f", "2021-04-01", 700.0,
                       *ranges, **kw)
        assert handles == ("calc1", "calc1")
        port_results = tx.calc_cache.get("calc1").result(timeout=600)
        jx.calc_cache.get("calc1").result(timeout=600)
        assert both("subscribe_status", "calc1") == ("success", "success")
        assert both("subscribe_progress", "calc1") == (1.0, 1.0)
        ref, npv = both("subscribe_result_property", "calc1", "npv")
        assert npv == port_results.npv
        assert npv == pytest.approx(ref, rel=NPV_RTOL)

        # The port's direct call on the UDF's route (progress reported: the
        # chunked driver; the blank-cell tolerance 1e-10): the same bits.
        import storage_tpu_torch as tt

        direct = tt.three_factor_seasonal_value(
            tx.storage_cache.get("s3f"), "2021-04-01", 700.0, fwd, rates, None,
            spot_mean_reversion=12.0, spot_vol=0.8, long_term_vol=0.2, seasonal_vol=0.3,
            num_sims=256, basis_funcs="1 + s + x_st + x_lt + x_sw", discount_deltas=False,
            seed=7, fwd_sim_seed=8, numerical_tolerance=1e-10,
            on_progress_update=lambda p: None, device="cpu")
        assert npv == direct.npv

    def test_result_property_for_missing_handle_is_error_string(self):
        ref, got = both("subscribe_result_property", "nope", "npv")
        assert isinstance(got, str) and got.startswith("#ERROR!")
        assert got == ref


class TestSyncUdfs:
    def test_intrinsic_udf_matches_engine(self, curves):
        fwd, rates = curves
        ref, npv = both("storage_intrinsic_value", *sync_args(fwd, rates))
        assert isinstance(npv, float)
        assert npv == pytest.approx(ref, rel=VALUE_RTOL)
        import storage_tpu_torch as tt

        create_both("cmp_intr", RATCHET_RANGE, "PiecewiseLinear", 0.01, 0.0, 0.025, 0.0)
        direct = tt.intrinsic_value(tx.storage_cache.get("cmp_intr"), "2021-04-01", 700.0,
                                    fwd, rates, None, device="cpu")
        assert npv == pytest.approx(direct.npv, rel=VALUE_RTOL)

    def test_trinomial_udf_returns_float(self, curves):
        fwd, rates = curves
        vol = pd.Series(0.6, index=fwd.index)
        args = sync_args(fwd, rates)
        ref, npv = both("storage_value_trinomial_tree", *args[:-1], date_range_2d(vol), 10.0,
                        args[-1])
        assert isinstance(npv, float) and np.isfinite(npv)
        assert npv == pytest.approx(ref, rel=VALUE_RTOL)

    def test_intrinsic_decision_profile_table(self, curves):
        fwd, rates = curves
        ref, table = both("storage_intrinsic_decision_profile", *sync_args(fwd, rates))
        assert isinstance(table, list) and len(table) == len(ref) > 0
        assert all(len(row) == 3 for row in table)
        assert isinstance(table[0][0], datetime.datetime)
        assert [row[0] for row in table] == [row[0] for row in ref]
        np.testing.assert_array_equal([row[1:] for row in table], [row[1:] for row in ref])

    def test_intrinsic_tree_udf_matches_intrinsic_engine(self, curves):
        fwd, rates = curves
        ref, npv = both("storage_value_intrinsic", *sync_args(fwd, rates))
        assert isinstance(npv, float) and np.isfinite(npv)
        assert npv == pytest.approx(ref, rel=VALUE_RTOL)
        intrinsic = tx.storage_intrinsic_value(*sync_args(fwd, rates), **CPU)
        assert npv == pytest.approx(intrinsic, rel=0.02)

    def test_bad_ratchets_return_hash_error(self, curves):
        fwd, rates = curves
        ref, got = both("storage_value_intrinsic", *sync_args(fwd, rates, [["bad"]]))
        assert isinstance(got, str) and got.startswith("#")
        assert got == ref

    def test_settlement_rule_from_range(self):
        rows = [["2021-04", "2021-05-20"], ["2021-05", "2021-06-21"]]
        ref, rule = jx._settlement_rule(rows), tx._settlement_rule(rows)
        for day in pd.period_range("2021-04-01", "2021-05-31", freq="D"):
            assert rule(day) == ref(day)
        assert rule(pd.Period("2021-04-11", "D")) == pd.Period("2021-05-20", "D")
        with pytest.raises(ValueError, match="No settlement date") as port_err:
            rule(pd.Period("2021-07-01", "D"))
        with pytest.raises(ValueError) as jax_err:
            ref(pd.Period("2021-07-01", "D"))
        assert str(port_err.value) == str(jax_err.value)


class TestSettleDatesInCalc:
    def test_three_factor_with_settlement_table(self, curves):
        fwd, _ = curves
        create_both("s3f_settle", RATCHET_RANGE, "PiecewiseLinear", 0.01, 0.0, 0.025, 0.0)
        long_rates = pd.Series(0.02, index=pd.period_range("2021-04-01", "2021-09-01", freq="D"))
        ranges, kw = three_factor_args(fwd, long_rates, discount_deltas=True,
                                       settle_dates=SETTLE_ROWS, num_sims=128,
                                       basis_functions="1 + s + x_st", seed=9, fwd_sim_seed=None)
        assert both("storage_value_three_factor", "calc_settle", "s3f_settle", "2021-04-01",
                    700.0, *ranges, **kw) == ("calc_settle", "calc_settle")
        ref = jx.calc_cache.get("calc_settle").result(timeout=600)
        results = tx.calc_cache.get("calc_settle").result(timeout=600)
        assert np.isfinite(results.npv)
        assert results.npv == pytest.approx(ref.npv, rel=NPV_RTOL)
        import storage_tpu_torch as tt

        direct = tt.three_factor_seasonal_value(
            tx.storage_cache.get("s3f_settle"), "2021-04-01", 700.0, fwd, long_rates, None,
            spot_mean_reversion=12.0, spot_vol=0.8, long_term_vol=0.2, seasonal_vol=0.3,
            num_sims=128, basis_funcs="1 + s + x_st", discount_deltas=True, seed=9,
            device="cpu")
        assert results.npv != pytest.approx(direct.npv, rel=1e-6)


class TestToleranceAndConcurrency:
    def test_create_storage_plumbs_numerical_tolerance(self):
        _, jax_storage, port_storage = create_both(
            "tol1", RATCHET_RANGE, "PiecewiseLinear", 0.01, 0.0, 0.025, 0.0,
            numerical_tolerance=1e-6)
        assert port_storage.numerical_tolerance == jax_storage.numerical_tolerance == 1e-6
        _, jax_storage, port_storage = create_both(
            "tol2", RATCHET_RANGE, "PiecewiseLinear", 0.01, 0.0, 0.025, 0.0,
            numerical_tolerance="")
        assert port_storage.numerical_tolerance == jax_storage.numerical_tolerance == 1e-10

    def test_concurrent_sync_udfs_do_not_cross_wire(self, curves):
        fwd, rates = curves
        small = [["2021-04-01", 0.0, 25.0, 31.0], ["2021-04-01", 150.0, 25.0, 31.0]]

        def value(ratchets, inventory):
            return tx.storage_intrinsic_value(*sync_args(fwd, rates, ratchets, inventory), **CPU)

        big_ref = jx.storage_intrinsic_value(*sync_args(fwd, rates))
        small_ref = jx.storage_intrinsic_value(*sync_args(fwd, rates, small, 70.0))
        big, small_npv = value(RATCHET_RANGE, 700.0), value(small, 70.0)
        assert (big, small_npv) == (pytest.approx(big_ref, rel=VALUE_RTOL),
                                    pytest.approx(small_ref, rel=VALUE_RTOL))
        assert big != pytest.approx(small_npv, rel=1e-3)
        with ThreadPoolExecutor(max_workers=8) as pool:
            futs = [pool.submit(value, *((RATCHET_RANGE, 700.0) if i % 2 == 0
                                         else (small, 70.0))) for i in range(16)]
            outs = [f.result() for f in futs]
        for i, out in enumerate(outs):
            assert out == (big if i % 2 == 0 else small_npv), f"call {i} cross-wired"


def test_three_factor_udf_float64_equals_jax(curves, monkeypatch):
    """The three-factor UDF with each package's engine in float64: the same
    ranges give the same NPV to the last bit, so the float32 gap above is
    float32 policy noise, not the facade."""
    import jax
    import jax.numpy as jnp

    fwd, rates = curves
    create_both("s3f64", RATCHET_RANGE, "PiecewiseLinear", 0.01, 0.0, 0.025, 0.0)
    jax_engine = jx.three_factor_seasonal_value

    def jax_float64(*args, **kwargs):  # x64 is per thread: enabled on the worker's
        with jax.enable_x64(True):
            return jax_engine(*args, dtype=jnp.float64, **kwargs)

    monkeypatch.setattr(jx, "three_factor_seasonal_value", jax_float64)
    monkeypatch.setattr(tx, "three_factor_seasonal_value", functools.partial(
        tx.three_factor_seasonal_value, dtype=torch.float64))
    ranges, kw = three_factor_args(fwd, rates)
    jx.storage_value_three_factor("calc64", "s3f64", "2021-04-01", 700.0, *ranges, **kw)
    ref = jx.calc_cache.get("calc64").result(timeout=600)
    tx.storage_value_three_factor("calc64", "s3f64", "2021-04-01", 700.0, *ranges, **kw, **CPU)
    results = tx.calc_cache.get("calc64").result(timeout=600)
    got = tx.subscribe_result_property("calc64", "npv")
    assert got == results.npv
    assert got == pytest.approx(ref.npv, rel=1e-12)


@pytest.mark.parametrize("udf", ENGINE_UDFS + CACHE_UDFS)
def test_signatures(udf):
    """Each UDF keeps the JAX package's name and argument order; those that
    run an engine take ``device`` last, defaulting to ``"cuda"``."""
    jax_udf = getattr(jx, udf).__closure__[0].cell_contents  # inside _excel_fn's wrapper
    ref = inspect.signature(jax_udf).parameters
    port = inspect.signature(getattr(tx, udf)).parameters
    if udf in ENGINE_UDFS:
        assert list(port) == list(ref) + ["device"]
        assert port["device"].default == "cuda"
    else:
        assert list(port) == list(ref)
    assert [p.default for p in ref.values()] == [port[name].default for name in ref]
    assert tx.NA == jx.NA
