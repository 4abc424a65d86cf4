"""The upstream GUI's test data as the benchmark deploys it, with the per-sim
panels the API returns by default, cut to a CPU's size, against the plain
reference; and the tracing of the panel fetch.

The deployment is the benchmark's ``gui_test_data_3f``: the inputs of the
upstream Jupyter GUI's "test data" button (``examples/torch_storage_gui.py::
test_data_inputs``), valued on the storage's first day, so 365 simulated
periods and 364 decision steps, with the second ratchet table taking over on
2022-10-01, within the horizon.  Its cell ``daily_value_131k_panels`` makes
the GUI's call (panels and a progress callback) at 131,072 paths; here the
same call runs at 512 paths through ``portbench.driver.Program`` on the CPU.

- The configuration builds the GUI's storage, forward curve, rate curve and
  settlement days on every period.
- In float64 the valuation agrees with ``portbench/reference`` in float64
  within ``TOL`` (each with its reason); the reference computed in float32
  fails at least one of those tolerances.
- With a ``profile_sink``: ``Assembly`` is a stopwatch phase, still a span
  under ``All``; each of the eight frames is one ``PanelFetch`` span under
  it, and the counters ``panel_frames``, ``panel_blocks``,
  ``panel_d2h_bytes`` and ``panel_host_bytes`` count the fetch exactly.
  Without panels none of them is recorded, and without a sink nothing is.
- The reference in bfloat16 (``tools/lower_control.py --dtype bfloat16``),
  against which the cell's limits are set, fails each of them but
  ``trigger_rows``.
- ``host_other_s.value`` on traces made by hand, with and without an
  ``Assembly`` phase, and ``tools/trace_spans.py``'s panel readings and its
  ``host_other_s``, which leaves out the reader's four phases.
"""
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
for path in (ROOT, ROOT / "tools", ROOT / "examples"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

import lower_control  # noqa: E402
import torch_storage_gui as gui  # noqa: E402
import trace_spans  # noqa: E402
from portbench import cases, check, compare, driver, trace  # noqa: E402
from storage_tpu_torch import valuation  # noqa: E402
from storage_tpu_torch.compile import build_valuation_context  # noqa: E402
from storage_tpu_torch.utils import profiling  # noqa: E402
from storage_tpu_torch.utils.profiling import Span, Stopwatches  # noqa: E402

CELL = cases.cell("daily_value_131k_panels")
CFG, MIX = CELL["cfg"], CELL["mix"]
F64 = dict(CFG, dtype="float64")  # both sides draw, and compute, in float64
SIMS = 512
SEED = 2**31 + 2323
SPOT_ROWS, DECISION_ROWS = 365, 366  # simulated periods; periods of the horizon
PANEL_BYTES = (2 * SPOT_ROWS + 6 * DECISION_ROWS) * SIMS * 8
# Both sides compute in float64 on the same threefry draws, so the gaps are
# two roundings of one computation: at 512 paths they read 1.8e-16 for the
# NPV, 3.5e-16 to 4.4e-16 for the intrinsic, deltas, profile and panels
# (a few ulp) and 5.6e-13 to 1.6e-12 for the triggers (quotients of
# differences of fitted continuations, which cancel), on two seeds.  Each
# limit leaves 60x or more of room above that and lies far below what the
# reference in float32 reads (npv 3.7e-4 to 2.3e-3, intrinsic 6.3e-7,
# deltas, profile and panels 4.5e-2 or more, triggers 3.1e-2 or more).  No
# trigger that the reference does not give.
TOL = {"npv": 1e-12, "intrinsic": 1e-12, "deltas": 1e-12, "profile": 1e-12, "panels": 1e-12,
       "triggers": 1e-10, "trigger_rows": 0}
PANEL_COUNTERS = ("panel_frames", "panel_blocks", "panel_d2h_bytes", "panel_host_bytes")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def recorded():
    """Call 0 of a run with ``SEED`` in float64 at ``SIMS`` paths, the GUI's
    call (panels, progress), recorded; its answer and its Stopwatches."""
    sws = []
    program = driver.Program(F64, MIX, SEED, "cpu", SIMS)
    program.profile_sink = sws.append
    got = program.call(0)
    (sw,) = sws
    return got, sw


@pytest.fixture(scope="module")
def references():
    return {dtype: check.reference(F64, MIX, SEED, [0], "cpu", dtype, SIMS)[0]
            for dtype in (torch.float64, torch.float32)}


def _period_table(storage, periods):
    """Per period: the inventory bounds and the rate range at inventories
    across the ratchets' pillars."""
    rows = []
    for p in periods:
        lo, hi = storage.min_inventory(p), storage.max_inventory(p)
        row = [lo, hi]
        for x in np.linspace(lo, hi, 9):
            r = storage.inject_withdraw_range(p, float(x))
            row += [r.min_inject_withdraw_rate, r.max_inject_withdraw_rate]
        rows.append(row)
    return np.array(rows)


def test_the_configuration_is_the_gui_test_data():
    kw = cases.port_case(CFG)
    ref = gui.valuation_kwargs(gui.test_data_inputs())
    s, g = kw["cmdty_storage"], ref["cmdty_storage"]
    assert (s.start, s.end, s.freq, s.interp_kind) == (g.start, g.end, g.freq, g.interp_kind)
    assert s.periods.equals(g.periods) and s.must_be_empty_at_end == g.must_be_empty_at_end
    np.testing.assert_array_equal(_period_table(s, s.periods[:-1]),
                                  _period_table(g, g.periods[:-1]))
    for name in ("injection_cost_by_step", "withdrawal_cost_by_step",
                 "cmdty_consumed_inject_by_step", "cmdty_consumed_withdraw_by_step",
                 "inventory_loss_by_step", "inventory_cost_by_step"):
        np.testing.assert_array_equal(getattr(s, name), getattr(g, name))
    assert kw["fwd_curve"].index.equals(ref["fwd_curve"].index)
    np.testing.assert_array_equal(kw["fwd_curve"].to_numpy(), ref["fwd_curve"].to_numpy())
    assert kw["interest_rates"].index.equals(ref["interest_rates"].index)
    np.testing.assert_array_equal(kw["interest_rates"].to_numpy(),
                                  ref["interest_rates"].to_numpy())
    for p in s.periods:
        assert kw["settlement_rule"](p) == ref["settlement_rule"](p)
    for key in ("val_date", "inventory", "spot_mean_reversion", "spot_vol", "long_term_vol",
                "seasonal_vol", "basis_funcs", "discount_deltas"):
        assert kw[key] == ref[key], key
    assert (kw["antithetic"], kw["num_inventory_grid_points"], kw["extra_decisions"]) == \
        (False, 100, None)
    # The valuation's context, every period of it.
    ctx = [build_valuation_context(k["cmdty_storage"], k["val_date"], k["inventory"],
                                   k["fwd_curve"], k["interest_rates"], k["settlement_rule"],
                                   100, 1e-12) for k in (kw, ref)]
    for name in ("grids", "pillars", "fwd", "df_settle", "df_cost", "inject_cost",
                 "withdraw_cost"):
        np.testing.assert_array_equal(getattr(ctx[0], name), getattr(ctx[1], name))
    assert ctx[0].n_steps == DECISION_ROWS - 1 and ctx[0].val_date_is_first_step
    assert CFG["reduced"] == [] and CELL["chips"] == 1 and CELL["traffic"] == "value_131k_panels"
    assert (MIX["num_sims"], MIX["panels"], MIX["progress"]) == (131072, True, True)


def test_the_second_ratchet_table_takes_over_within_the_horizon():
    storage = cases.port_case(CFG)["cmdty_storage"]
    before, after = pd.Period("2022-09-30", "D"), pd.Period("2022-10-01", "D")
    assert storage.end > after
    assert storage.inject_withdraw_range(before, 0.0).max_inject_withdraw_rate == 250.0
    assert storage.inject_withdraw_range(after, 0.0).max_inject_withdraw_rate == 260.0


def test_valuation_with_panels_agrees_with_the_float64_reference(recorded, references):
    got, _ = recorded
    assert got["panels"].shape == (DECISION_ROWS, 6, SIMS)
    assert got["spots_reg"].shape == got["spots_val"].shape == (SPOT_ROWS, SIMS)
    nums = compare.numbers(got, references[torch.float64])
    assert set(nums) == set(TOL)
    for name, limit in TOL.items():
        assert nums[name] <= limit, (name, nums[name], limit)


def test_float32_reference_fails_the_tolerances(references):
    nums = compare.numbers(references[torch.float32], references[torch.float64])
    assert not compare.judge(nums, TOL), nums
    assert nums["npv"] > 100 * TOL["npv"] and nums["panels"] > 100 * TOL["panels"], nums


def test_bfloat16_reference_fails_the_cell_limits():
    """The control the cell's limits are set against, at 512 paths: every
    limit but the exact ``trigger_rows`` fails, by a wide margin (PERF.md
    section 2 has the card's readings at 131,072 paths)."""
    (rec,) = lower_control.readings("daily_value_131k_panels", [SEED], "bfloat16", device="cpu",
                                    num_sims=SIMS)
    limits = CELL["limits"]
    assert not compare.judge(rec, limits), rec
    for name, limit in limits.items():
        if name != "trigger_rows":
            assert rec[name] > 10 * limit, (name, rec[name], limit)


def test_bfloat16_solves_round_a_float32_solution():
    solve = torch.linalg.solve_ex
    a, b = 2 * torch.eye(2, dtype=torch.bfloat16), torch.ones(2, 1, dtype=torch.bfloat16)
    with lower_control.bfloat16_solves():
        x, info = torch.linalg.solve_ex(a, b)
        y, _ = torch.linalg.solve_ex(a.double(), b.double())  # other types as before
    assert x.dtype == torch.bfloat16 and torch.equal(x, torch.full((2, 1), 0.5).bfloat16())
    assert int(info) == 0 and y.dtype == torch.float64
    assert torch.linalg.solve_ex is solve


def _parents(sw):
    return [(s.name, sw.spans[s.parent].name if s.parent >= 0 else None) for s in sw.spans]


def test_assembly_is_a_phase_and_each_frame_a_fetch(recorded):
    _, sw = recorded
    assert "Assembly" in Stopwatches.PHASES
    parents = _parents(sw)
    assert parents.count(("Assembly", "All")) == 1
    assert parents.count(("PanelFetch", "Assembly")) == 8
    assert sum(s.name == "PanelFetch" for s in sw.spans) == 8
    (span,) = [s for s in sw.spans if s.name == "Assembly"]
    assert sw.elapsed("Assembly") == pytest.approx((span.end_ns - span.start_ns) / 1e9, abs=1e-3)
    assert 0 < sw.elapsed("Assembly") < sw.elapsed("All")
    assert sum(sw.elapsed(p) for p in Stopwatches.PHASES) <= sw.elapsed("All")
    # At 512 paths a frame is one block: one wait under each fetch.
    assert {k: sw.counters[k] for k in PANEL_COUNTERS} == {
        "panel_frames": 8, "panel_blocks": 8, "panel_d2h_bytes": PANEL_BYTES,
        "panel_host_bytes": PANEL_BYTES}
    fetches = [i for i, s in enumerate(sw.spans) if s.name == "PanelFetch"]
    assert [sum(s.name == "Wait" and s.parent == i for s in sw.spans) for i in fetches] == [1] * 8


@pytest.mark.parametrize("shard_sims", [(37,), (20, 17)])
def test_panel_blocks_are_counted_exactly(shard_sims):
    """A panel of 11 rows (or its shards) in blocks of 3 rows: 4 blocks a
    shard, each one wait, the float64 bytes of each block to the host."""
    rows, S = 11, sum(shard_sims)
    full = torch.arange(rows * S, dtype=torch.float32).reshape(rows, S)
    shards = list(torch.split(full, list(shard_sims), dim=1))
    panel = shards[0] if len(shards) == 1 else shards
    sw = Stopwatches(record=True)
    with sw.activate():
        out = valuation._fetch_panel(panel, max_chunk_bytes=3 * S * 8)
    np.testing.assert_array_equal(out, full.double().numpy())
    assert sw.counters == {"panel_frames": 1, "panel_blocks": 4 * len(shards),
                           "panel_d2h_bytes": rows * S * 8, "panel_host_bytes": rows * S * 8,
                           "host_syncs": 4 * len(shards)}
    assert [s.name for s in sw.spans] == ["PanelFetch"] + ["Wait"] * 4 * len(shards)


def test_without_panels_no_fetch_is_recorded():
    sws = []
    program = driver.Program(F64, dict(MIX, panels=False), SEED, "cpu", 64)
    program.profile_sink = sws.append
    program.call(0)
    (sw,) = sws
    assert not any(k in sw.counters for k in PANEL_COUNTERS)
    assert not any(s.name == "PanelFetch" for s in sw.spans)
    assert _parents(sw).count(("Assembly", "All")) == 1


def test_nothing_is_recorded_without_a_sink(monkeypatch):
    seen = []
    monkeypatch.setattr(Stopwatches, "_open_span", lambda self, name: seen.append(name))
    got = driver.Program(F64, MIX, SEED, "cpu", 64).call(0)
    assert got["panels"].shape == (DECISION_ROWS, 6, 64)
    idle = profiling.active()
    assert seen == [] and not idle.record and idle.spans == [] and idle.counters == {}


# --------------------------------------------------------------------------- #
# host_other_s and the spans                                                  #
# --------------------------------------------------------------------------- #

PHASES = {"RegressionPriceSimulation": 0.01, "ValuationPriceSimulation": 0.02,
          "BackwardInduction": 0.3, "ForwardSimulation": 0.03, "All": 1.5}


def _trace(phases, events=(), calls=2):
    return trace.Trace(events=list(events), window_s=3.2, calls=calls, steps=364,
                       phases=[dict(p) for p in phases], spans=[],
                       bounds={"k1": 1e-3, "k2": 1e-3, "k3": 1e-3})


def test_host_other_reads_the_same_with_an_assembly_phase():
    read = trace.reader("host_other_s.value")
    plain = read(_trace([PHASES] * 2))
    assert plain == pytest.approx(1.5 - 0.36)
    assert read(_trace([dict(PHASES, Assembly=0.9)] * 2)) == plain


def test_trace_spans_leaves_out_the_readers_phases():
    """``tools/trace_spans.py``'s ``host_other_s`` subtracts
    ``Stopwatches.CORE_PHASES``, the four phases the benchmark's
    ``host_other_s.value`` reader names, so both read one number."""
    ms = 1_000_000  # ns
    t0, spans, phases = 0, [Span(1, "All", -1, 0, 2 * ms)], dict(All=2e-3)
    for name in Stopwatches.CORE_PHASES + ("Assembly",):
        spans.append(Span(1, name, 0, t0, t0 + ms // 4))
        phases[name] = 0.25e-3
        t0 += ms // 4
    got = trace_spans.readings("value", [spans], [{}], [], 0, 2 * ms)
    assert got["host_other_s"] == pytest.approx(trace.reader("host_other_s.value")(
        _trace([phases], calls=1)))
    assert got["host_other_s"] == pytest.approx(2e-3 - 4 * 0.25e-3)


def test_trace_spans_reads_the_panel_fetch():
    spans = [Span(1, "All", -1, 0, 1_000_000), Span(1, "Assembly", 0, 500_000, 1_000_000)]
    spans += [Span(1, "PanelFetch", 1, 500_000 + 50_000 * i, 540_000 + 50_000 * i)
              for i in range(8)]
    counters = [{"host_syncs": 20, "uploads": 78, "decision_steps": 364, "panel_frames": 8,
                 "panel_blocks": 16, "panel_d2h_bytes": 3_068_133_376,
                 "panel_host_bytes": 3_068_133_376}]
    got = trace_spans.readings("value", [spans], counters, [], 0, 1_000_000)
    assert (got["panel_frames"], got["panel_blocks"]) == (8, 16)
    assert got["panel_d2h_bytes"] == got["panel_host_bytes"] == 3_068_133_376
    assert got["panel_fetch_s"] == pytest.approx(8 * 40e-6)
    assert got["assembly_s"] == pytest.approx(500e-6)
    # host_other_s leaves Assembly in: "All" less the four core phases only.
    assert got["host_other_s"] == pytest.approx(1e-3)
    assert "panel_frames" not in trace_spans.readings("value", [spans[:2]], [{}], [], 0, 1)
