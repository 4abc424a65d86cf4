"""The port's float64 valuation with streamed path sets, cut to a CPU's size,
against the plain reference.

The deployment is the benchmark's ``daily_ratchet_3f_f64``: the cmdty/storage
three-factor daily storage of ``daily_ratchet_3f`` at the library's own
precision, float64, with the program's default path budget of 6e9 bytes
written out: at 1M paths its 8.18e9 bytes of factor paths stream, each set
in six spans of 64 steps (the cell ``daily_value_1m_f64``).  At
2,048 paths a budget of 1e7 bytes gives a set (16.8 MB) the same spans.  The
valuation runs as the benchmark makes it (``portbench.driver.Program``), on
the CPU, where each launch of the path kernel is a call of its plain version.

- The streamed valuation agrees with ``portbench/reference`` in float64,
  within the tolerances of ``TOL`` (each with its reason).  The reference
  computed in float32 fails at least one of them.  The cell's own limits
  hold the same way.
- Streaming changes the answer only where the passes are cut: the streamed
  valuation equals, bit for bit, a materialised one cut at the same spans.
  Each span's backward scan solves its latest period directly, as the JAX
  package's does, so the one-scan materialised valuation differs from it by
  rounding alone (``ONE_SCAN_TOL``).
- With a ``profile_sink`` the call counts 2 ``stream_checkpoints`` and 12
  ``streamed_spans`` (six a set), one path-kernel launch each, and its
  ``host_syncs`` hold the two waits of ``StreamingFactorSource.prepare``.
  A read that the one-slot span cache serves is not counted.
- ``tools/trace_spans.py`` reads the stream counters and spans, the
  cell's ``k3_launches.f64`` reader the path kernel's launches, and
  ``tools/lower_control.py`` draws the float32 control's normals finite.
"""
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
for path in (ROOT, ROOT / "tools"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

import lower_control  # noqa: E402
import trace_spans  # noqa: E402
from portbench import cases, check, compare, driver, trace, yardstick  # noqa: E402
from portbench.reference import threefry  # noqa: E402
from storage_tpu_torch.engines import lsmc  # noqa: E402
from storage_tpu_torch.models import simulation  # noqa: E402
from storage_tpu_torch.utils import profiling  # noqa: E402
from storage_tpu_torch.utils.profiling import Span, Stopwatches  # noqa: E402
from storage_tpu_torch.valuation import MAX_PATH_BYTES_ENV  # noqa: E402

CELL = cases.cell("daily_value_1m_f64")
CFG, MIX = CELL["cfg"], CELL["mix"]
SIMS = 2048
BUDGET = 1e7  # bytes: below the 16.8 MB of a set, so that it streams in spans of 64 steps
SEED = 2**31 + 1919
NUM_STEPS, EVERY = 341, 64
SPANS = [(a, min(a + EVERY, NUM_STEPS)) for a in range(0, NUM_STEPS, EVERY)]
VALUE_SYNCS = 4  # a materialised valuation's waits (tests/test_torch_tracing.py)

# Both sides compute in float64 on the same threefry draws, so the gaps are
# the two roundings of one computation: the port assembles each regression
# from the kernel's partials and sums in its own order, the reference solves
# each period directly.  At 2,048 paths they read 1.8e-16 to 5.3e-16 for the
# NPVs, deltas and profile (a few ulp) and 1.6e-13 for the triggers
# (quotients of differences of fitted continuations, which cancel); each
# limit leaves close to three decades of room above that and lies three or
# more below what float32 reads (npv 1.0e-5, intrinsic 1.7e-7, deltas
# 1.6e-2, profile 1.8e-2, triggers 4.3e-3).  No trigger that the reference
# does not give.
TOL = {"npv": 1e-12, "intrinsic": 1e-12, "deltas": 1e-12, "profile": 1e-12,
       "triggers": 1e-10, "trigger_rows": 0}
# The one-scan valuation against the streamed one: five regressions solved
# directly instead of assembled, read 1.6e-12 of the largest trigger price
# and 6e-14 of the largest profile value at 2,048 paths.
ONE_SCAN_TOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _call(max_path_bytes, profile_sink=None):
    """Call 0 of a run with ``SEED`` at ``SIMS`` paths under the budget
    ``max_path_bytes`` (None: the program's default); the program's answer
    as the benchmark reads it.  The budget's variable is restored after."""
    saved = os.environ.get(MAX_PATH_BYTES_ENV)
    try:
        program = driver.Program(dict(CFG, max_path_bytes=max_path_bytes), MIX, SEED, "cpu", SIMS)
        program.profile_sink = profile_sink
        return program.call(0)
    finally:
        if saved is None:
            os.environ.pop(MAX_PATH_BYTES_ENV, None)
        else:
            os.environ[MAX_PATH_BYTES_ENV] = saved


@pytest.fixture(scope="module")
def streamed():
    """The streamed valuation, recorded, with each plain call that stands
    for a path-kernel launch logged as a device event of the kernel's name."""
    launches = []

    def logged(fn, mode):
        def call(*args, **kw):
            launches.append(mode)
            return fn(*args, **kw)
        return call

    sws = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(simulation, "factor_checkpoints_reference",
                   logged(simulation.factor_checkpoints_reference, "checkpoints"))
        mp.setattr(simulation, "simulate_factor_paths_reference",
                   logged(simulation.simulate_factor_paths_reference, "span"))
        got = _call(BUDGET, sws.append)
    (sw,) = sws
    return got, sw, launches


@pytest.fixture(scope="module")
def references():
    """The reference's answer to the same call in float64 and in float32
    (the cell's control: float32 throughout, no TF32)."""
    out = {}
    for dtype in (torch.float64, torch.float32):
        out[dtype] = check.reference(CFG, MIX, SEED, [0], "cpu", dtype, SIMS)[0]
    return out


def test_the_configuration_is_the_float32_one_in_float64():
    """The same deployment: every number of ``daily_ratchet_3f`` but the
    precision and the path budget, which is the program's default."""
    from storage_tpu_torch.valuation import DEFAULT_MAX_PATH_BYTES

    f32 = cases.load_json("configs", "daily_ratchet_3f")
    described = {"name", "source", "assumed", "deployment", "guarantees"}
    assert {k for k in set(f32) | set(CFG) if f32.get(k) != CFG.get(k)} == \
        described | {"dtype", "max_path_bytes"}
    assert (CFG["dtype"], CFG["max_path_bytes"]) == ("float64", DEFAULT_MAX_PATH_BYTES)
    assert CFG["reduced"] == [] and CELL["traffic"] == "value_1m" and CELL["chips"] == 1
    assert CELL["control"] == {"dtype": "float32", "tf32": False}


def test_the_budget_streams_each_set_in_spans_of_64():
    from storage_tpu_torch.valuation import _stream_span_length

    per_step = 3 * SIMS * 8
    assert NUM_STEPS * per_step > BUDGET
    assert _stream_span_length(BUDGET, per_step) == EVERY
    # At 1M paths the default budget gives the cell the same spans.
    assert NUM_STEPS * 3 * 10**6 * 8 > CFG["max_path_bytes"]
    assert _stream_span_length(CFG["max_path_bytes"], 3 * 10**6 * 8) == EVERY


def test_streamed_valuation_agrees_with_the_float64_reference(streamed, references):
    got, _, _ = streamed
    nums = compare.numbers(got, references[torch.float64])
    assert set(nums) == set(TOL)
    for name, limit in TOL.items():
        assert nums[name] <= limit, (name, nums[name], limit)


def test_float32_reference_fails_the_tolerances(references):
    """The reference one precision down, as the cell's control computes it."""
    nums = compare.numbers(references[torch.float32], references[torch.float64])
    assert not compare.judge(nums, TOL), nums
    assert nums["npv"] > 100 * TOL["npv"], nums


def test_the_cell_limits_pass_the_program_and_fail_float32(streamed, references):
    got, _, _ = streamed
    limits = CELL["limits"]
    assert compare.judge(compare.numbers(got, references[torch.float64]), limits)
    nums = compare.numbers(references[torch.float32], references[torch.float64])
    assert not compare.judge(nums, limits), nums
    for name in ("deltas", "profile", "triggers", "intrinsic"):
        assert nums[name] > limits[name], (name, nums)


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a, np.float64))
    return a.shape, a.tobytes()


def test_streamed_equals_materialised_cut_at_the_same_spans(streamed, monkeypatch):
    got, _, _ = streamed
    monkeypatch.setattr(lsmc, "_refine_spans",
                        lambda m, num_chunks, source_spans: [(a, min(b, m)) for a, b in SPANS
                                                             if a < m])
    cut = _call(None)
    assert sorted(cut) == sorted(got)
    for key in got:
        assert _bits(cut[key]) == _bits(got[key]), key


def test_streamed_is_the_one_scan_valuation_but_for_rounding(streamed):
    got, _, _ = streamed
    one_scan = _call(None)
    assert got["intrinsic_npv"] == one_scan["intrinsic_npv"]
    nums = compare.numbers(got, dict(one_scan, capacity=0.0,
                                     headroom=np.zeros((len(one_scan["triggers"]), 2))))
    for name in ("npv", "deltas", "profile", "triggers"):
        assert nums[name] <= ONE_SCAN_TOL, (name, nums[name])
    assert nums["trigger_rows"] == 0


def test_stream_counters_and_spans(streamed):
    _, sw, launches = streamed
    assert sw.counters["stream_checkpoints"] == 2
    assert sw.counters["streamed_spans"] == 2 * len(SPANS) == 12
    assert launches.count("checkpoints") == 2 and launches.count("span") == 12
    assert sw.counters["host_syncs"] == VALUE_SYNCS + 2
    parents = {}
    for s in sw.spans:
        key = (s.name, sw.spans[s.parent].name if s.parent >= 0 else None)
        parents[key] = parents.get(key, 0) + 1
    for phase in ("RegressionPriceSimulation", "ValuationPriceSimulation"):
        assert parents[("StreamCheckpoints", phase)] == 1
        assert parents[("Wait", phase)] == 1  # prepare()'s wait
    assert parents[("StreamSpan", "BackwardScan")] == len(SPANS)
    assert parents[("StreamSpan", "ForwardKernels")] == len(SPANS)
    assert sum(s.name == "Wait" for s in sw.spans) == sw.counters["host_syncs"]


def _small_source():
    rng = np.random.default_rng(0)
    n, F = 103, 3
    coeffs = simulation.sim_coefficients(
        np.array([2.0, 0.1, 5.0]), 0.3 + 0.2 * rng.random((n, F)),
        np.array([[1.0, 0.3, 0.1], [0.3, 1.0, 0.2], [0.1, 0.2, 1.0]]),
        np.linspace(1 / 365, n / 365, n), 18 + 2 * rng.random(n))
    return simulation.StreamingFactorSource(coeffs, 64, simulation.prng_key(42), every=32,
                                            device="cpu", dtype=torch.float64)


def test_span_cache_hits_are_not_regenerations():
    src = _small_source()
    sw = Stopwatches(record=True)
    with sw.activate():
        src.prepare()
        src.factors(32, 64)
        src.factors(40, 50)  # the same span: served by the cache
        src.last()  # span 3
        src.factors(96, 100)  # span 3 again
        src.factors(0, 8)
    counted = {k: sw.counters[k] for k in ("stream_checkpoints", "host_syncs", "streamed_spans")}
    assert counted == {"stream_checkpoints": 1, "host_syncs": 1, "streamed_spans": 3}
    assert [s.name for s in sw.spans] == ["StreamCheckpoints", "Wait", "StreamSpan",
                                          "StreamSpan", "StreamSpan"]


def test_nothing_is_recorded_without_a_sink(monkeypatch):
    seen = []
    monkeypatch.setattr(Stopwatches, "_open_span", lambda self, name: seen.append(name))
    src = _small_source().prepare()
    src.factors(0, 32)
    idle = profiling.active()
    assert seen == [] and not idle.record and idle.spans == [] and idle.counters == {}


def test_yardstick_counts_both_draws_at_8_bytes():
    got = yardstick.call_bounds("value", NUM_STEPS, 10**6, CFG, False)
    one = yardstick.k3_bound(NUM_STEPS, 10**6, 3, 10**6, itemsize=8)[0]
    again = yardstick.k3_bound(NUM_STEPS, 10**6, 3, 10**6, rows=0, itemsize=8)[0]
    assert got["k3"] == pytest.approx(2 * (one + again))
    assert got["k1"] == pytest.approx(
        (NUM_STEPS - 1) * yardstick.k1_bound(10**6, 100, 3, 10, 3, 8)[0])
    assert got["k2"] == pytest.approx(
        yardstick.k2_bound(NUM_STEPS - 1, 10**6, 3, 10, 3, False, 8)[0])


def test_trace_spans_reads_the_stream_counters():
    spans = [Span(1, "All", -1, 0, 1_000_000), Span(1, "RegressionPriceSimulation", 0, 0, 100_000),
             Span(1, "StreamCheckpoints", 1, 0, 50_000), Span(1, "BackwardInduction", 0,
                                                               100_000, 900_000),
             Span(1, "BackwardScan", 3, 100_000, 900_000),
             Span(1, "StreamSpan", 4, 100_000, 120_000),
             Span(1, "StreamSpan", 4, 500_000, 530_000)]
    counters = [{"host_syncs": 6, "uploads": 3, "decision_steps": 4, "stream_checkpoints": 2,
                 "streamed_spans": 12}]
    got = trace_spans.readings("value", [spans], counters, [], 0, 1_000_000)
    assert (got["stream_checkpoints"], got["streamed_spans"]) == (2, 12)
    assert got["stream_span_s"] == pytest.approx(50e-6)
    assert got["stream_checkpoints_s"] == pytest.approx(50e-6)
    assert "streamed_spans" not in trace_spans.readings("value", [spans[:2]], [{}], [], 0, 1)


def _value_trace(k3_per_call, calls=2):
    events, t = [], 0.0
    for _ in range(calls):
        for name in ["path_sim_f64_kernel"] * k3_per_call + ["backward_update_kernel",
                                                              "forward_sim_kernel"]:
            events.append((t, t + 10.0, name))
            t += 15.0
    return trace.Trace(events=events, window_s=1.0, calls=calls, steps=4, phases=[],
                       spans=[], bounds={"k1": 1e-3, "k2": 1e-3, "k3": 1e-3})


def test_k3_launches_reader_counts_the_path_kernel_a_call():
    read = trace.reader("k3_launches.f64")
    assert read(_value_trace(14)) == 14.0
    assert read(_value_trace(2)) == 2.0  # a held path set: one launch a set
    assert read(_value_trace(0)) is None


def test_control_normals_kept_inside(monkeypatch):
    """float64 draws as the reference's own, bit for bit; in float32 a
    uniform that rounds onto +-1 gives a finite normal, where the
    reference's map gives an infinite one."""
    key = threefry.fold_in(threefry.prng_key(SEED), 0)
    for draws in ("float32", "float64"):
        want = threefry.normals(key, (16, 3, 64), "cpu", torch.float64, draws)
        got = lower_control.normals_kept_inside(key, (16, 3, 64), "cpu", torch.float64, draws)
        assert torch.equal(got, want)
    edge = torch.tensor([-1.0 + 2.0**-30, -0.5, 0.0, 0.5, 1.0 - 2.0**-30], dtype=torch.float64)
    monkeypatch.setattr(threefry, "uniform_pm1_64", lambda key, shape, device: edge)
    plain = threefry.normals(key, (5,), "cpu", torch.float32, "float64")
    kept = lower_control.normals_kept_inside(key, (5,), "cpu", torch.float32, "float64")
    assert torch.isinf(plain[[0, 4]]).all() and torch.isfinite(kept).all()
    assert torch.equal(kept[1:4], plain[1:4]) and kept[4] == -kept[0] > 5.0
    with lower_control.kept_inside():
        assert threefry.normals is lower_control.normals_kept_inside
    assert threefry.normals is not lower_control.normals_kept_inside


def test_lower_control_reads_the_cells_own_control():
    """Without a dtype the control is the one the cell's file names (float32
    without TF32), drawn with its uniforms kept inside (-1, 1); at 64 paths
    it fails every limit of the cell but the exact ``trigger_rows``, and the
    reference draws its own normals again afterwards."""
    (rec,) = lower_control.readings("daily_value_1m_f64", [SEED], device="cpu", num_sims=64)
    assert rec["kind"] == "control " + json.dumps(CELL["control"]) and rec["seed"] == SEED
    for name, limit in CELL["limits"].items():
        if name != "trigger_rows":
            assert rec[name] > limit, (name, rec[name], limit)
    assert threefry.normals is not lower_control.normals_kept_inside
