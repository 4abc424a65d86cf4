"""The harness on the CPU at a tiny size: each traffic loop, the result
line, the reference against the program, and the faults the comparison
must catch.

``run.run`` is driven directly (``run.py``'s ``main`` refuses to run without
a card).  The port runs in float64 here, where the reference is its exact
twin (the draws of a float64 valuation, no float32 regression noise at a
few hundred paths), so a clean run agrees to rounding and every fault shows.
"""
import json

import numpy as np
import pytest
import torch

from portbench import cases, compare, driver, run

SIMS = 192
F64 = {"dtype": "float64"}
# Each cell, and the daily valuation once more under a path budget scaled to
# the tiny path count, so that its path sets are streamed in spans.
CASES = {"daily_value_1m": F64, "daily_reprice_1m": F64, "daily_value_2k_panels": F64,
         "daily_value_1m-streamed": dict(F64, max_path_bytes=1e5)}


def _cell(case):
    return case.split("-")[0]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_traffic_loop_makes_two_calls(case):
    row = cases.cell(_cell(case))
    cfg = dict(row["cfg"], **CASES[case])
    program = driver.Program(cfg, row["mix"], seed=3, device="cpu", num_sims=SIMS)
    sample = driver.Sample(3, 2)
    lat, wall, failed = driver.closed_loop(program, 1e9, sample, max_calls=2)
    assert len(lat) == 2 and sample.seen == 2 and wall > 0 and failed == 0
    (i0, a), (i1, b) = sample.items
    assert (i0, i1) == (0, 1)
    assert np.isfinite(a["npv"]) and a["npv"] != b["npv"]  # a fresh seed per call
    assert a["deltas"].shape == (a["profile"].shape[0],)


@pytest.mark.parametrize("case", sorted(CASES))
def test_result_line_and_reference_agree(case):
    line = run.run(_cell(case), 2**31 + 12345, 1e9, False, device="cpu", num_sims=SIMS,
                   max_calls=2, cfg_overrides=CASES[case])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checked"]
    assert line["correct"] is True and line["attempted"] == 2 and line["failed"] == 0
    assert "setup_s" in line["metrics"] and "peak_device_gib" in line["metrics"]
    assert set(line["checked"]) == set(cases.cell(_cell(case))["limits"])
    for name, (number, _) in line["checked"].items():
        assert number <= 1e-9, name
    json.dumps(line)


def test_trigger_rows_count_all_but_the_edge():
    """A trigger that only the program gives counts, unless the reference's
    expected inventory and the program's trigger volume both lie on the
    edge of the next period's space on that side."""
    nan = np.nan
    ref = dict(npv=1.0, deltas=np.ones(4), profile=np.ones((4, 6)),
               triggers=np.array([[5.0, 2.0, -5.0, 1.0], [nan, nan, -5.0, 1.0],
                                  [nan, nan, -5.0, 1.0], [5.0, 2.0, nan, nan]]),
               headroom=np.array([[10.0, 10.0], [0.0, 10.0], [3.0, 10.0], [10.0, 1e-9]]),
               capacity=1000.0)
    got = dict(ref, triggers=np.array([[5.0, 2.0, -5.0, 1.0], [1e-4, 7.0, -5.0, 1.0],
                                       [1e-4, 7.0, -5.0, 1.0], [5.0, 2.0, -2.0, 9.0]]))
    # Row 1 inject: on the edge, a rounding's volume, not counted.  Row 2
    # inject: 3 units of headroom, counted.  Row 3 withdraw: on the edge but
    # a real volume, counted.
    assert compare.numbers(got, ref)["trigger_rows"] == 2.0
    assert compare.numbers(ref, ref)["trigger_rows"] == 0.0


def test_float32_draws_match_the_reference():
    """The float32 draws: the program's spots against the reference's, from
    the same seed and keys (both sets)."""
    from portbench.reference import context, lsmc

    row = cases.cell("daily_value_2k_panels")
    program = driver.Program(row["cfg"], row["mix"], seed=5, device="cpu", num_sims=64)
    got = program.call(0)
    ctx = context.build(row["cfg"])
    ref = lsmc.value(ctx, cases.call_seed(5, 0), 64, False, True, "cpu", torch.float64,
                     panels=True)
    for key in ("spots_reg", "spots_val"):
        np.testing.assert_allclose(got[key], ref[key], rtol=2e-5)


# --------------------------------------------------------------------------- #
# Faults: the timed path broken underneath, and `correct` must read false.   #
# --------------------------------------------------------------------------- #


def _backward_state_unchanged(monkeypatch):
    from storage_tpu_torch.engines import lsmc

    real = lsmc.backward_update

    def stuck(factors, factors_prev, v_next, *a, **k):
        _, graw, praw = real(factors, factors_prev, v_next, *a, **k)
        return v_next.clone(), graw, praw

    monkeypatch.setattr(lsmc, "backward_update", stuck)


def _forward_state_unchanged(monkeypatch):
    from storage_tpu_torch.engines import lsmc

    real = lsmc.forward_sim

    def stuck(factors, inv0, *a, **k):
        sums, xsums, _, pv = real(factors, inv0, *a, **k)
        return sums, xsums, inv0.clone(), torch.zeros_like(pv)

    monkeypatch.setattr(lsmc, "forward_sim", stuck)


def _half_the_sims(monkeypatch):
    from storage_tpu_torch.engines import lsmc

    def half_mean(parts, dim=None):
        p = parts[0]
        if dim is None:
            return p.reshape(-1)[: p.numel() // 2].mean()
        return p.narrow(dim, 0, p.shape[dim] // 2).mean(dim=dim)

    monkeypatch.setattr(lsmc, "sims_mean", half_mean)


def _answer_altered(monkeypatch):
    from storage_tpu_torch.engines import lsmc

    real = lsmc.forward_sim

    def altered(*a, **k):
        sums, xsums, inv, pv = real(*a, **k)
        return sums, xsums, inv, pv * 1.001

    monkeypatch.setattr(lsmc, "forward_sim", altered)


def _triggers_where_none(monkeypatch):
    from storage_tpu_torch.engines import lsmc

    real = lsmc._trigger_calc

    def everywhere(*a, **k):
        # A unit's trigger on each side where there is none; the others kept.
        has_i, vi, pi, has_w, vw, pw = real(*a, **k)
        vi = torch.where(has_i[:, None], vi, vi + 1.0)
        vw = torch.where(has_w[:, None], vw, vw - 1.0)
        return torch.ones_like(has_i), vi, pi, torch.ones_like(has_w), vw, pw

    monkeypatch.setattr(lsmc, "_trigger_calc", everywhere)


def _intrinsic_state_unchanged(monkeypatch):
    from storage_tpu_torch.engines import intrinsic

    real = intrinsic._backward_values

    def stuck(ctx, terminal_values, *a, **k):
        values = real(ctx, terminal_values, *a, **k)
        return values * 0 + values[-1]  # every period keeps the terminal values

    monkeypatch.setattr(intrinsic, "_backward_values", stuck)


def _intrinsic_altered(monkeypatch):
    from storage_tpu_torch import valuation

    real = valuation.intrinsic_value_with_ctx

    def altered(*a, **k):
        res = real(*a, **k)
        return res._replace(npv=res.npv * 1.001)

    monkeypatch.setattr(valuation, "intrinsic_value_with_ctx", altered)


FAULTS = {
    "state_unchanged": {"value": _backward_state_unchanged, "reprice": _forward_state_unchanged},
    "half_the_sims": {"value": _half_the_sims, "reprice": _half_the_sims},
    "answer_altered": {"value": _answer_altered, "reprice": _answer_altered},
    "triggers_where_none": {"value": _triggers_where_none, "reprice": _triggers_where_none},
    "intrinsic_state_unchanged": {"value": _intrinsic_state_unchanged},
    "intrinsic_altered": {"value": _intrinsic_altered},
}


@pytest.mark.parametrize("cell, fault", [
    (cell, fault) for cell in ("daily_value_1m", "daily_reprice_1m")
    for fault in sorted(FAULTS) if cases.cell(cell)["mix"]["entry"] in FAULTS[fault]])
def test_fault_reads_not_correct(cell, fault, monkeypatch):
    FAULTS[fault][cases.cell(cell)["mix"]["entry"]](monkeypatch)
    line = run.run(cell, 77, 1e9, False, device="cpu", num_sims=SIMS, max_calls=1,
                   cfg_overrides=CASES[cell])
    assert line["correct"] is False
