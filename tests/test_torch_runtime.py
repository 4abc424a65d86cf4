"""The port's async valuation runtime: the seven cases of ``test_runtime.py``
(reference ExcelCalcWrapper semantics: progress streaming, status
transitions, cooperative cancellation, the named-object cache) against
``storage_tpu_torch.runtime``, on the CPU.  The valuation runs the port's
chunked driver on a background thread; its NPV is held to the JAX package's
on the same inputs to 1e-4 relative.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import storage_tpu
from storage_tpu_torch import CmdtyStorage, ValuationCancelledError, multi_factor_value
from storage_tpu_torch.runtime import AsyncValuation, CalcStatus, ObjectCache

torch.set_num_threads(2)


def setup_inputs(pkg_storage=CmdtyStorage):
    storage = pkg_storage(
        "D", "2021-01-01", "2021-02-01",
        injection_cost=0.1, withdrawal_cost=0.1,
        min_inventory=0.0, max_inventory=100.0,
        max_injection_rate=10.0, max_withdrawal_rate=10.0,
    )
    idx = pd.period_range("2021-01-01", "2021-02-01", freq="D")
    fwd = pd.Series(10.0 + np.sin(np.arange(len(idx))), index=idx)
    vol = pd.Series(0.5, index=idx)
    return storage, fwd, vol


def make_task(storage, fwd, vol, calc_fn=multi_factor_value, **kw):
    return AsyncValuation(
        calc_fn,
        storage, "2021-01-01", 50.0, fwd, None, None,
        factors=[(1.0, vol)], factor_corrs=None,
        num_sims=200, basis_funcs="1 + x0", discount_deltas=False, seed=1, **kw,
    )


class TestAsyncValuation:
    def test_success_path_with_progress_and_status(self):
        storage, fwd, vol = setup_inputs()
        task = make_task(storage, fwd, vol, device="cpu")
        progresses, statuses = [], []
        task.subscribe_progress(progresses.append)
        task.subscribe_status(statuses.append)
        task.start()
        results = task.result(timeout=300)
        assert task.status == CalcStatus.SUCCESS
        assert np.isfinite(results.npv)
        assert progresses[-1] == 1.0
        assert all(b >= a for a, b in zip(progresses, progresses[1:]))
        assert statuses[0] in (CalcStatus.PENDING, CalcStatus.RUNNING)
        assert statuses[-1] == CalcStatus.SUCCESS
        ref = make_task(*setup_inputs(storage_tpu.CmdtyStorage),
                        calc_fn=storage_tpu.multi_factor_value).start().result(timeout=300)
        assert results.npv == pytest.approx(ref.npv, rel=1e-4)
        assert results.sim_pv.shape == ref.sim_pv.shape

    def test_cancellation(self):
        storage, fwd, vol = setup_inputs()
        task = make_task(storage, fwd, vol, device="cpu")
        task.cancel()  # cancel before start: first cooperative check trips
        task.start()
        with pytest.raises(ValuationCancelledError):
            task.result(timeout=300)
        assert task.status == CalcStatus.CANCELLED

    def test_error_propagates(self):
        def boom(**kwargs):
            raise ValueError("bad inputs")

        task = AsyncValuation(boom).start()
        with pytest.raises(ValueError, match="bad inputs"):
            task.result(timeout=30)
        assert task.status == CalcStatus.ERROR

    def test_double_start_rejected(self):
        storage, fwd, vol = setup_inputs()
        task = make_task(storage, fwd, vol, device="cpu")
        task.start()
        with pytest.raises(RuntimeError):
            task.start()
        task.result(timeout=300)


class TestObjectCache:
    def test_named_storage_roundtrip(self):
        storage, fwd, vol = setup_inputs()
        cache = ObjectCache()
        cache.add("winter_storage", storage)
        assert cache.get("winter_storage") is storage
        assert cache.get_property("winter_storage", "freq") == "D"
        assert "winter_storage" in cache.names()
        cache.remove("winter_storage")
        with pytest.raises(KeyError):
            cache.get("winter_storage")

    def test_result_property_through_async_task(self):
        storage, fwd, vol = setup_inputs()
        cache = ObjectCache()
        cache.add("calc1", make_task(storage, fwd, vol, device="cpu").start())
        npv = cache.get_property("calc1", "npv")
        assert np.isfinite(npv)

    def test_no_replace_raises(self):
        cache = ObjectCache()
        cache.add("a", 1)
        with pytest.raises(KeyError):
            cache.add("a", 2, replace=False)
