"""``examples/torch_storage_gui.py`` against ``examples/storage_gui.py``.

- ``GuiInputs`` JSON files written by either GUI load in the other with equal
  fields; the pillar and daily forward-curve CSV files are byte-equal; the
  ratchet tables and the storages built from the inputs agree.
- ``run_valuation`` on the test-data inputs at 2,048 paths on the CPU against
  the JAX GUI's: NPV within 1e-4 and intrinsic within 1e-6
  (``test_torch_slice.py``'s bounds: two float32 regressions that accumulate
  in another order; measured 3.7e-6 and 3.3e-8), progress ending at 1.0,
  per-sim panels on in both.  The float32 deltas miss ``test_torch_slice``'s
  1e-2 of max|delta| at this path count (measured 3.2e-2 to 6.0e-2 as the JAX
  package's thread setup varies, as that file records for its own case at
  2,048 paths; at 4,096 the current-period decision, a near tie, flips).  So
  the deltas are held where that noise is gone: each GUI's ``run_valuation``
  with its package's valuation switched to float64 (the JAX one under
  ``jax.enable_x64``), NPV within 1e-9, deltas within 1e-6 of max|delta| and
  intrinsic within 1e-12, ``test_torch_float64.py``'s bounds (measured
  2.2e-16, 1.5e-16, equal).  A run cancelled from the start raises each
  package's ``ValuationCancelledError``.
- The Calculate button's background run (``valuation_task``, which
  ``StorageGui._on_run`` starts) ends in success with progress 1.0.  The
  JAX GUI hands its ``run_valuation`` to ``AsyncValuation``, which passes the
  hooks as ``on_progress_update=``: that run ends in an error (a fault of the
  reference GUI, left as it is), which is why the port wires its own.
- ``StorageGui`` built without ``show()`` (ipywidgets imports here):
  ``_distribute`` then ``_collect`` gives the test data back, and its
  Calculate handler runs a valuation to success.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "examples")]

import storage_gui as jax_gui  # noqa: E402
import storage_tpu as jax_pkg  # noqa: E402
import storage_tpu_torch as torch_pkg  # noqa: E402
import torch_storage_gui as gui  # noqa: E402
from storage_tpu.runtime import AsyncValuation as JaxAsyncValuation  # noqa: E402
from storage_tpu_torch.runtime import CalcStatus  # noqa: E402

torch.set_num_threads(2)

SIMS = 2048
NPV_RTOL, INTRINSIC_RTOL = 1e-4, 1e-6
F64_NPV_RTOL, F64_DELTA_TOL, F64_INTRINSIC_RTOL = 1e-9, 1e-6, 1e-12


def _inputs(module, **changes):
    return dataclasses.replace(module.test_data_inputs(), **changes)


def test_tables_are_the_jax_guis():
    assert gui.TEST_FWD_POINTS == jax_gui.TEST_FWD_POINTS
    assert gui.TEST_RATCHET_ROWS == jax_gui.TEST_RATCHET_ROWS
    fields = [(f.name, f.default) for f in dataclasses.fields(gui.GuiInputs)]
    assert fields == [(f.name, f.default) for f in dataclasses.fields(jax_gui.GuiInputs)]


@pytest.mark.parametrize("writer,reader", [(gui, jax_gui), (jax_gui, gui)],
                         ids=["port_to_jax", "jax_to_port"])
def test_json_files_load_in_the_other_gui(writer, reader, tmp_path):
    path = str(tmp_path / "inputs.json")
    written = _inputs(writer, num_sims=777, seed=5, flat_rate=0.02)
    written.save(path)
    loaded = reader.GuiInputs.load(path)
    assert dataclasses.asdict(loaded) == dataclasses.asdict(written)
    assert loaded.ratchet_rows[1] == ("", 2000.0, 175.0, -200.0)


@pytest.mark.parametrize("method", ["save_fwd_csv", "save_daily_fwd_csv"])
def test_curve_csv_files_equal_the_jax_guis(method, tmp_path):
    port_path, jax_path = tmp_path / "port.csv", tmp_path / "jax.csv"
    getattr(_inputs(gui), method)(str(port_path))
    getattr(_inputs(jax_gui), method)(str(jax_path))
    assert port_path.read_bytes() == jax_path.read_bytes()


def test_pillar_csv_loads_back(tmp_path):
    path = str(tmp_path / "pillars.csv")
    _inputs(jax_gui).save_fwd_csv(path)
    back = gui.GuiInputs()
    back.load_fwd_csv(path)
    assert back.fwd_points == list(gui.TEST_FWD_POINTS)


def test_synthetic_curve_equals_the_jax_guis():
    pd.testing.assert_series_equal(gui.GuiInputs().forward_curve(),
                                   jax_gui.GuiInputs().forward_curve())


@pytest.mark.parametrize("use_ratchets", [True, False], ids=["ratchets", "constant"])
def test_ratchets_and_storage_agree(use_ratchets):
    port, ref = _inputs(gui, use_ratchets=use_ratchets), _inputs(jax_gui,
                                                                 use_ratchets=use_ratchets)
    assert port.ratchets() == ref.ratchets()
    got, want = port.build_storage(), ref.build_storage()
    assert (got.start, got.end) == (want.start, want.end)
    for day in ("2022-04-01", "2022-07-15", "2022-10-01", "2023-03-31"):
        p = pd.Period(day, "D")
        assert got.min_inventory(p) == want.min_inventory(p)
        assert got.max_inventory(p) == want.max_inventory(p)
        for inv in (0.0, 700.0, 1500.0, 4000.0, 7000.0):
            if inv <= want.max_inventory(p):
                assert got.inject_withdraw_range(p, inv) == pytest.approx(
                    tuple(want.inject_withdraw_range(p, inv)), rel=1e-12)


def test_first_ratchet_row_needs_a_date():
    with pytest.raises(ValueError, match="must carry a date"):
        gui.GuiInputs(ratchet_rows=[("", 0.0, 1.0, -1.0)]).ratchets()


@pytest.fixture(scope="module")
def valuations():
    progress = []
    got = gui.run_valuation(_inputs(gui, num_sims=SIMS), on_progress=progress.append,
                            device="cpu")
    ref = jax_gui.run_valuation(_inputs(jax_gui, num_sims=SIMS))
    return got, ref, progress


def test_run_valuation_agrees_with_the_jax_gui(valuations):
    got, ref, progress = valuations
    assert got.npv == pytest.approx(ref.npv, rel=NPV_RTOL)
    assert got.intrinsic_npv == pytest.approx(ref.intrinsic_npv, rel=INTRINSIC_RTOL)
    assert progress[-1] == 1.0 and progress == sorted(progress)
    assert got.sim_inventory.shape == ref.sim_inventory.shape  # panels on, as in the JAX GUI


def test_run_valuation_in_float64_equals_the_jax_gui(monkeypatch):
    """Each GUI's ``run_valuation`` as it stands, its package's valuation
    called in float64: what the two GUIs hand their packages agrees, deltas
    too."""
    monkeypatch.setattr(gui, "three_factor_seasonal_value", lambda **kw: (
        torch_pkg.three_factor_seasonal_value(**kw, dtype=torch.float64)))
    monkeypatch.setattr(jax_gui, "three_factor_seasonal_value", lambda **kw: (
        jax_pkg.three_factor_seasonal_value(**kw, dtype=jnp.float64)))
    got = gui.run_valuation(_inputs(gui, num_sims=SIMS), device="cpu")
    with jax.enable_x64(True):
        ref = jax_gui.run_valuation(_inputs(jax_gui, num_sims=SIMS))
    assert got.deltas.dtype == np.float64
    assert got.npv == pytest.approx(ref.npv, rel=F64_NPV_RTOL)
    assert got.intrinsic_npv == pytest.approx(ref.intrinsic_npv, rel=F64_INTRINSIC_RTOL)
    want = ref.deltas.to_numpy()
    np.testing.assert_allclose(got.deltas.to_numpy(), want, rtol=0,
                               atol=F64_DELTA_TOL * np.abs(want).max())


def test_cancelled_run_raises_as_the_jax_gui():
    with pytest.raises(jax_pkg.ValuationCancelledError):
        jax_gui.run_valuation(_inputs(jax_gui, num_sims=256), cancelled=lambda: True)
    with pytest.raises(torch_pkg.ValuationCancelledError):
        gui.run_valuation(_inputs(gui, num_sims=256), cancelled=lambda: True, device="cpu")


def test_calculate_button_task_runs_to_success():
    task = gui.valuation_task(_inputs(gui, num_sims=256), device="cpu")
    progress, statuses = [], []
    task.subscribe_progress(progress.append)
    task.subscribe_status(statuses.append)
    res = task.start().result(timeout=600)
    assert statuses[0] == CalcStatus.PENDING and statuses[-1] == CalcStatus.SUCCESS
    assert progress[-1] == 1.0 and np.isfinite(res.npv)
    # The JAX GUI's own wiring of the same button: its run_valuation takes
    # ``on_progress``, and AsyncValuation passes ``on_progress_update``.
    jax_task = JaxAsyncValuation(jax_gui.run_valuation, _inputs(jax_gui, num_sims=256))
    jax_task.start()
    with pytest.raises(TypeError, match="on_progress_update"):
        jax_task.result(timeout=600)


def test_cancelled_task_ends_cancelled():
    task = gui.valuation_task(_inputs(gui, num_sims=256), device="cpu")
    task.subscribe_progress(lambda p: p > 0.0 and task.cancel())
    task.start()
    with pytest.raises(torch_pkg.ValuationCancelledError):
        task.result(timeout=600)
    assert task.status == CalcStatus.CANCELLED


def test_smoke_records_the_gui_run():
    """``chip_smoke``'s recording of the Calculate task's run keeps the
    launches its ``gui`` phase holds against the plain versions: K1
    mid-horizon, K2's first span (panels on), K3's first path set."""
    import chip_smoke

    task = gui.valuation_task(_inputs(gui, num_sims=256), device="cpu")
    with chip_smoke._recording(
            chip_smoke._first_launches(chip_smoke.GUI_CAPTURE_LAUNCH, ("float32",))) as rec:
        res = task.start().result(timeout=600)
    n_steps = len(res.expected_profile) - 1
    assert rec.calls == {("K1", "float32"): n_steps - 1, ("K2", "float32"): chip_smoke.NUM_SPANS,
                         ("K3", "float32"): chip_smoke.PATH_SETS}
    assert chip_smoke.GUI_CAPTURE_LAUNCH == (n_steps - 1) // 2
    assert sorted(rec.recorded) == [("K1", "float32"), ("K2", "float32"), ("K3", "float32")]
    assert rec.recorded[("K2", "float32")][1]["panels"] is not None
    assert rec.recorded[("K3", "float32")][1] == 256


@pytest.mark.skipif(not gui.HAVE_WIDGETS, reason="ipywidgets does not import")
def test_widget_shell_round_trips_and_calculates():
    shell = gui.StorageGui(device="cpu")
    data = gui.test_data_inputs()
    shell._distribute(data)
    assert shell._collect() == data
    shell._distribute(dataclasses.replace(data, num_sims=256))
    shell._on_run(None)
    res = shell.task.result(timeout=600)
    assert np.isfinite(res.npv)
    assert shell._progress.value == 1.0 and shell._status.value == CalcStatus.SUCCESS.value
