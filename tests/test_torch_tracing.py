"""The port's spans and counters (``storage_tpu_torch.utils.profiling``).

On the CPU, at 256 paths of the benchmark's daily case
(``portbench/configs/daily_ratchet_3f.json``):

- a valuation, a ``fit_policy`` and a ``reprice`` given a ``profile_sink``
  record each of their named spans once, under the right parents, with one
  call identity a call; every ``Wait`` sits under a named span; a span's
  self time is its duration less its children's, so the self times add up
  to the call's ``All``;
- ``host_syncs`` and ``uploads`` are pinned.  ``host_syncs`` counts the
  points where the host waits: 4 a valuation (the intrinsic DP's fetch, the
  two health fetches, the assembly's fetch of the small outputs), none in a
  fit, 1 a reprice (its health fetch); a valuation with panels and progress
  at 2,000 paths adds 8 panel fetches (six fields, two spot panels) and, on
  a card, one event wait a ``Progress`` span (40).  ``uploads`` counts the
  host constants uploaded without a wait: 59 a valuation, 24 a fit, 29 a
  reprice, 78 with panels (154 while each of the 20 progress spans made its
  own decision geometry, uploading its four weight rows; one geometry a
  call since the backward glue became a CUDA graph).  Each sum is the
  number of waits the call would make if every upload waited, as uploads
  did before they were pinned: 63, 24, 30 and 130 (206 with 154 uploads).
  The same sites count on
  the CPU as on a card (the plain versions of the kernels upload what the
  launchers upload), so these are the card's numbers; the ``cuda`` cases
  below check them there;
- the forward pass queues its per-step outputs before the health check's
  fetch, and a failed check (non-finite PVs; PV and inventory paths all
  zero) raises before the user's ``terminal_npv_fn`` is called;
- without a sink nothing is recorded and nothing synchronises (counted with
  monkeypatches), the recorder is released after a call (also one that
  raises), and the profile report is built only when INFO logging is on;
- the arithmetic of ``tools/trace_spans.py`` (innermost spans, the device's
  idle time under each, the longest gaps named, its readings) on a trace
  made by hand.

Marked ``cuda`` (they skip without a card): a span around a synchronised K3
launch encloses the launch in the profiler's trace within 50 us (the spans'
``time.time_ns()`` is the trace's clock), and under
``torch.cuda.set_sync_debug_mode("warn")`` a valuation (plain, and with
panels and progress) and a reprice warn once for each ``host_syncs`` that is
not an event wait (a reprice once); an upload lands with the values its
array had when it was called, though the array is overwritten before the
copy runs; and a reprice whose uploads are made blocking copies followed by
a ``torch.cuda.synchronize()`` gives the same outputs bit for bit.
"""
import logging
import math
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
for path in (ROOT, ROOT / "tools"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

import storage_tpu_torch as st  # noqa: E402
import trace_spans  # noqa: E402
from portbench import cases, driver  # noqa: E402
from storage_tpu_torch.engines import lsmc  # noqa: E402
from storage_tpu_torch.exceptions import StorageError  # noqa: E402
from storage_tpu_torch.utils import profiling  # noqa: E402
from storage_tpu_torch.utils.profiling import Span, Stopwatches  # noqa: E402

SIMS = 256
SEED = 1601
CFG = cases.load_json("configs", "daily_ratchet_3f")
VALUE_SYNCS, FIT_SYNCS, REPRICE_SYNCS = 4, 0, 1
VALUE_UPLOADS, FIT_UPLOADS, REPRICE_UPLOADS = 59, 24, 29
PANELS_SIMS, PANELS_SYNCS, PANELS_UPLOADS, PROGRESS_SPANS = 2000, 12, 78, 40
# The waits of each call if every upload waited: the sums of the two counters.
VALUE_WAITS_BEFORE, FIT_WAITS_BEFORE, REPRICE_WAITS_BEFORE, PANELS_WAITS_BEFORE = 63, 24, 30, 130
DECISION_STEPS = 340

VALUE_TREE = {"All": None, "Compile": "All", "Intrinsic": "All", "DeviceInputs": "All",
              "RegressionPriceSimulation": "All", "BackwardInduction": "All",
              "BackwardScan": "BackwardInduction", "ValuationPriceSimulation": "All",
              "ForwardSimulation": "All", "ForwardKernels": "ForwardSimulation",
              "ForwardHealth": "ForwardSimulation", "StackedOutputs": "ForwardSimulation",
              "AssembleArrays": "ForwardSimulation", "Assembly": "All"}
FIT_TREE = {"All": None, "DeviceInputs": "All", "BackwardInduction": "All",
            "BackwardScan": "BackwardInduction"}
REPRICE_TREE = {"All": None, "DeviceInputs": "All", "ForwardSimulation": "All",
                "ForwardKernels": "ForwardSimulation", "ForwardHealth": "ForwardSimulation",
                "StackedOutputs": "ForwardSimulation", "AssembleArrays": "ForwardSimulation"}
UNTIMED = ("Wait", "Sync", "Progress")  # repeatable spans, under the named ones


def _value(device="cpu", profile_sink=None, num_sims=SIMS, seed=SEED, **kw):
    return st.three_factor_seasonal_value(
        **cases.port_case(CFG), num_sims=num_sims, seed=seed, dtype=torch.float32,
        device=device, return_sim_panels=kw.pop("panels", False), profile_sink=profile_sink,
        **kw)


def _policy_calls(device="cpu", num_sims=SIMS):
    """A recorded fit and reprice as the benchmark's reprice traffic makes
    them (factors on the device, spot-vol loadings and drifts from the
    host); returns their two Stopwatches."""
    mix = cases.load_json("traffic", "reprice_1m")
    p = driver.Program(CFG, mix, SEED, device, num_sims)
    got = []
    reg = p._simulate(p.coeffs, num_sims, key=p._prng_key(SEED + 1), antithetic=CFG["antithetic"],
                      device=device, dtype=torch.float32)
    policy = lsmc.fit_policy(p.ctx, reg, p.coeffs.vols, p.coeffs.log_fwd_drift, p.spec,
                             device=device, profile_sink=got.append)
    val = p._simulate(p.coeffs, num_sims, key=p._prng_key(SEED + 2), antithetic=CFG["antithetic"],
                      device=device, dtype=torch.float32)
    lsmc.reprice(p.ctx, policy, val, p.coeffs.vols, p.coeffs.log_fwd_drift, p.spec,
                 discount_deltas=CFG["discount_deltas"], device=device, profile_sink=got.append)
    return got


@pytest.fixture(scope="module")
def value_sw():
    got = []
    _value(profile_sink=got.append)
    assert len(got) == 1
    return got[0]


@pytest.fixture(scope="module")
def policy_sws():
    return _policy_calls()


@pytest.fixture(scope="module")
def panels_sw():
    got = []
    _value(num_sims=PANELS_SIMS, panels=True, on_progress_update=lambda f: None,
           profile_sink=got.append)
    assert len(got) == 1
    return got[0]


def _check_tree(sw: Stopwatches, tree: dict):
    names = [s.name for s in sw.spans if s.name not in UNTIMED]
    assert sorted(names) == sorted(tree), names
    for s in sw.spans:
        assert s.end_ns >= s.start_ns >= 0
        parent = sw.spans[s.parent].name if s.parent >= 0 else None
        if s.name in UNTIMED:
            assert parent is not None and parent not in ("Wait", "Sync"), s
        else:
            assert parent == tree[s.name], s
        if s.parent >= 0:  # nested inside the parent's interval
            p = sw.spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (s, p)
    assert {s.call for s in sw.spans} == {sw.call}
    assert sum(s.name == "Wait" for s in sw.spans) == sw.counters.get("host_syncs", 0)


def test_valuation_records_each_span_once(value_sw):
    _check_tree(value_sw, VALUE_TREE)
    assert value_sw.counters == {"host_syncs": VALUE_SYNCS, "uploads": VALUE_UPLOADS,
                                 "decision_steps": DECISION_STEPS}
    # The phases' stopwatches read their spans' durations.
    for p in value_sw.PHASES + ("All",):
        (span,) = [s for s in value_sw.spans if s.name == p]
        assert value_sw.elapsed(p) == pytest.approx((span.end_ns - span.start_ns) / 1e9,
                                                    abs=1e-3)


def test_fit_and_reprice_record_each_span_once(policy_sws):
    fit, rep = policy_sws
    _check_tree(fit, FIT_TREE)
    _check_tree(rep, REPRICE_TREE)
    assert FIT_SYNCS == 0 and fit.counters == {"uploads": FIT_UPLOADS,
                                               "decision_steps": DECISION_STEPS}
    assert rep.counters == {"host_syncs": REPRICE_SYNCS, "uploads": REPRICE_UPLOADS}
    assert fit.call != rep.call


def test_panels_and_progress_counts(panels_sw):
    """At 2,000 paths with panels and progress: the panel fetches are waits,
    and on a card each ``Progress`` span waits on one event besides (none
    here: the CPU has no events to wait on).  Each of the eight frames is
    one block at 2,000 paths, and carries its float64 bytes to the host."""
    panel_bytes = (2 * (DECISION_STEPS + 1) + 6 * (DECISION_STEPS + 2)) * PANELS_SIMS * 8
    assert panels_sw.counters == {"host_syncs": PANELS_SYNCS, "uploads": PANELS_UPLOADS,
                                  "decision_steps": DECISION_STEPS, "panel_frames": 8,
                                  "panel_blocks": 8, "panel_d2h_bytes": panel_bytes,
                                  "panel_host_bytes": panel_bytes}
    assert sum(s.name == "Progress" for s in panels_sw.spans) == PROGRESS_SPANS


@pytest.mark.parametrize("which", ["value", "fit", "reprice", "panels"])
def test_every_wait_that_went_is_an_upload(which, value_sw, policy_sws, panels_sw):
    """A call's waits and uploads add up to the waits it would make if every
    upload waited: no fetch or event wait went, and no upload was added."""
    sw, before = {"value": (value_sw, VALUE_WAITS_BEFORE),
                  "fit": (policy_sws[0], FIT_WAITS_BEFORE),
                  "reprice": (policy_sws[1], REPRICE_WAITS_BEFORE),
                  "panels": (panels_sw, PANELS_WAITS_BEFORE)}[which]
    # On a card each Progress span holds one event wait, which the CPU does not make.
    events = sum(s.name == "Progress" for s in sw.spans)
    assert sw.counters.get("host_syncs", 0) + events + sw.counters["uploads"] == before


@pytest.mark.parametrize("which", ["value", "fit", "reprice"])
def test_self_times_add_up_to_the_call(which, value_sw, policy_sws):
    sw = {"value": value_sw, "fit": policy_sws[0], "reprice": policy_sws[1]}[which]
    own = profiling.self_times_ns(sw.spans)
    assert min(own) >= 0
    (root,) = [s for s in sw.spans if s.parent < 0]
    assert sum(own) == root.end_ns - root.start_ns
    for i, s in enumerate(sw.spans):  # a parent is its self time and its children's
        kids = [t for t in sw.spans if sw.spans.index(t) != i and t.parent == i]
        assert own[i] + sum(t.end_ns - t.start_ns for t in kids) == s.end_ns - s.start_ns


def test_no_sink_records_nothing_and_never_syncs(monkeypatch):
    """Unrecorded calls (a valuation, and the harness's fit and reprice)
    open no span and call no synchronise, not even the stopwatches' own."""
    seen = []
    monkeypatch.setattr(Stopwatches, "_open_span", lambda self, name: seen.append(name))
    monkeypatch.setattr(Stopwatches, "synchronize", lambda self: seen.append("synchronize"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: seen.append("cuda"))
    assert math.isfinite(_value(num_sims=64).npv)
    p = driver.Program(CFG, cases.load_json("traffic", "reprice_1m"), SEED, "cpu", 64)
    assert math.isfinite(p.call(0)["npv"])
    assert seen == []
    idle = profiling.active()
    assert not idle.record and idle.spans == [] and idle.counters == {}


def test_the_recorder_is_released_after_a_call(value_sw):
    assert profiling.active() is not value_sw and not profiling.active().record
    got = []
    with pytest.raises(lsmc.ValuationCancelledError):
        _value(num_sims=64, profile_sink=got.append, cancelled=lambda: True)
    assert got == [] and not profiling.active().record
    sw = Stopwatches(record=True)
    with sw.activate():
        assert profiling.active() is sw
        profiling.host_wait(lambda: None)
        got = profiling.upload(np.arange(3.0), "cpu", torch.float32)
    assert sw.counters == {"host_syncs": 1, "uploads": 1}
    assert [s.name for s in sw.spans] == ["Wait"]
    assert got.dtype == torch.float32 and got.tolist() == [0.0, 1.0, 2.0]
    assert not profiling.active().record


def _forward_call(fault, monkeypatch, num_sims=64):
    """The reprice's forward program on the CPU, recorded, with a
    ``terminal_npv_fn`` that logs its calls, and with ``fault``: ``None``, a
    NaN factor in one sim (its PV is not finite) or a forward pass that
    leaves every sim's PV and final inventory at 0.  Returns the recorder,
    the terminal function's calls and the error raised (or None)."""
    p = driver.Program(CFG, cases.load_json("traffic", "reprice_1m"), SEED, "cpu", num_sims)
    val = p._simulate(p.coeffs, num_sims, key=p._prng_key(SEED + 3), antithetic=CFG["antithetic"],
                      device="cpu", dtype=torch.float32)
    if fault == "nan_pv":
        val[5, 0, 3] = float("nan")
    elif fault == "zero_paths":
        forward_sim, step0 = lsmc.forward_sim, lsmc._step0_single_sim

        def zero_forward_sim(*args, **kw):
            sums, xsums, inv, pv = forward_sim(*args, **kw)
            return sums, xsums, torch.zeros_like(inv), torch.zeros_like(pv)

        def zero_step0(*args):
            inv, pv, outputs = step0(*args)
            return torch.zeros_like(inv), torch.zeros_like(pv), outputs

        monkeypatch.setattr(lsmc, "forward_sim", zero_forward_sim)
        monkeypatch.setattr(lsmc, "_step0_single_sim", zero_step0)
    calls = []

    def terminal(spots, inv):
        calls.append(1)
        return torch.zeros_like(inv)

    device = torch.device("cpu")
    statics = dict(lsmc._program_statics(p.ctx, p.spec, 0), terminal_fn=terminal)
    sw = Stopwatches(device, record=True)
    error = None
    with sw.activate():
        try:
            vols, drift = (lsmc._on_device(x, device) for x in (p.coeffs.vols,
                                                                 p.coeffs.log_fwd_drift))
            lsmc._forward_program(
                val, vols, drift, p.policy.cont_mean0, p.policy.coeffs, p.policy.mus,
                p.policy.sds, p.policy.vbars, lsmc.device_inputs(p.ctx, device),
                p.policy.backward_npv, discount_deltas=CFG["discount_deltas"], **statics)
        except StorageError as e:
            error = e
    return sw, calls, error


@pytest.mark.parametrize("fault,match", [(None, None), ("nan_pv", "non-finite"),
                                         ("zero_paths", "identically zero")])
def test_forward_health_raises_after_the_outputs_are_queued(fault, match, monkeypatch):
    """The per-step outputs are queued before the health check; the check
    still raises on non-finite PVs and on PV and inventory paths that are
    all zero, and then the user's terminal function is never called."""
    sw, calls, error = _forward_call(fault, monkeypatch)
    names = [s.name for s in sw.spans if s.name not in UNTIMED]
    assert names[names.index("StackedOutputs"):] == (
        ["StackedOutputs", "ForwardHealth"] + (["AssembleArrays"] if fault is None else []))
    assert sw.counters["host_syncs"] == 1  # the health check's fetch
    if fault is None:
        assert error is None and calls == [1]
    else:
        assert error is not None and match in str(error) and calls == []


def test_profile_report_only_when_info_is_on(monkeypatch):
    built = []
    real = Stopwatches.generate_profile_report
    monkeypatch.setattr(Stopwatches, "generate_profile_report",
                        lambda self: built.append(1) or real(self))
    logger = logging.getLogger("storage_tpu_torch.multi_factor")
    level = logger.level
    try:
        logger.setLevel(logging.WARNING)
        _value(num_sims=64)
        assert built == []
        logger.setLevel(logging.INFO)
        _value(num_sims=64)
        assert built == [1]
    finally:
        logger.setLevel(level)


# --------------------------------------------------------------------------- #
# tools/trace_spans.py on a trace made by hand                                #
# --------------------------------------------------------------------------- #

def _hand_trace(entry: str):
    """Two calls in a 1 ms window (ns from 0): each ``All`` with a front-end
    span (or ``DeviceInputs``) holding a ``Wait``, and a phase holding the
    backward scan or the forward kernels; device events in us."""
    calls = []
    for c, off in enumerate((100_000, 550_000)):
        first = "Compile" if entry == "value" else "DeviceInputs"
        phase, inner = (("BackwardInduction", "BackwardScan") if entry == "value"
                        else ("ForwardSimulation", "StackedOutputs"))
        calls.append([
            Span(c + 1, "All", -1, off, off + 400_000),
            Span(c + 1, first, 0, off + 10_000, off + 110_000),
            Span(c + 1, "Wait", 1, off + 60_000, off + 100_000),
            Span(c + 1, phase, 0, off + 150_000, off + 390_000),
            Span(c + 1, inner, 3, off + 160_000, off + 300_000),
        ])
    events = []
    for off in (100_000, 550_000):
        events += [((off + 70_000) / 1e3, (off + 90_000) / 1e3, "Memcpy HtoD"),
                   ((off + 170_000) / 1e3, (off + 380_000) / 1e3, "backward_update_kernel")]
    counters = [{"host_syncs": 1, "uploads": 3, "decision_steps": 4, "glue_graph_captures": 1,
                 "glue_graph_replays": 3}] * 2
    return calls, events, counters, 0, 1_000_000


@pytest.mark.parametrize("entry", ["value", "reprice"])
def test_idle_by_span_adds_up_to_the_idle_window(entry):
    calls, events, counters, t0, t1 = _hand_trace(entry)
    idle = trace_spans.idle_by_span(calls, events, t0, t1)
    busy = sum(e - s for s, e, _ in events) / 1e6
    assert sum(idle.values()) == pytest.approx((t1 - t0) / 1e9 - busy, rel=1e-12)
    first = "Compile" if entry == "value" else "DeviceInputs"
    assert idle[f"{first}/Wait"] == pytest.approx(2 * 20e-6)  # 40 us less the 20 us copy
    assert idle[first] == pytest.approx(2 * 60e-6)
    assert idle[trace_spans.OUTSIDE] == pytest.approx((100 + 50 + 50) * 1e-6)
    assert all(len(k) < 64 for k in idle)
    gaps = trace_spans.named_gaps(calls, events, t0, t1)
    # 0-170 us: 100 us before the first call, 70 us inside it.
    assert gaps[0] == (trace_spans.OUTSIDE, pytest.approx(170e-6))
    assert len(gaps) == 5 and "All" in {g[0] for g in gaps}
    assert {g[0] for g in gaps} <= {trace_spans.OUTSIDE, "All", first}


@pytest.mark.parametrize("entry", ["value", "reprice"])
def test_readings_are_finite(entry):
    calls, events, counters, t0, t1 = _hand_trace(entry)
    got = trace_spans.readings(entry, calls, counters, events, t0, t1)
    keys = (["compile_s", "intrinsic_s", "assembly_s", "front_end_idle_s", "progress_wait_s",
             "backward_step_host_us", "host_other_s"] if entry == "value"
            else ["triggers_s", "program_idle_s"]) + ["host_syncs", "uploads", "device_inputs_s"]
    for k in keys:
        assert math.isfinite(got[k]) and got[k] >= 0, k
    assert (got["host_syncs"], got["uploads"]) == (1, 3)
    assert (got["glue_graph_captures"], got["glue_graph_replays"]) == (1, 3)
    if entry == "value":
        assert got["backward_step_host_us"] == pytest.approx(140e-6 * 1e6 / 4)
        assert got["k1_step_device_us"] == pytest.approx(2 * 210 / 8)
        assert got["front_end_idle_s"] == pytest.approx(80e-6)
    else:
        assert got["triggers_s"] == pytest.approx(140e-6)
        assert got["program_idle_s"] == pytest.approx(400e-6 - 230e-6)


# --------------------------------------------------------------------------- #
# On the card                                                                 #
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_span_encloses_its_launch_on_the_trace_clock(cuda):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from storage_tpu_torch.models.simulation import simulate_factor_paths

    mix = cases.load_json("traffic", "reprice_1m")
    p = driver.Program(CFG, mix, SEED, "cuda", 65536)
    simulate_factor_paths(p.coeffs, 65536, key=p._prng_key(1), device=cuda)
    torch.cuda.synchronize()
    sw = Stopwatches(cuda, record=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof, sw.activate():
        for i in range(3):
            with sw.span("K3"):
                simulate_factor_paths(p.coeffs, 65536, key=p._prng_key(2 + i), device=cuda)
                torch.cuda.synchronize()
    k3 = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA and "path_sim_kernel" in e.name())
    spans = [s for s in sw.spans if s.name == "K3"]
    assert len(k3) == len(spans) == 3
    for (a, b), s in zip(k3, spans):
        assert s.start_ns - 50_000 <= a <= b <= s.end_ns + 50_000, (a, b, s)


def _sync_warnings(fn) -> int:
    """The sync warnings of ``fn()`` (each an ATen ``warn_or_error_on_sync``);
    the debug mode is set first, so a warning of its own falls outside."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing CUDA operation" in str(w.message) for w in caught)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plain", "panels_progress"])
def test_valuation_syncs_are_host_syncs(cuda, case):
    kw = dict(num_sims=8192, device="cuda")
    if case == "panels_progress":
        kw.update(panels=True, on_progress_update=lambda f: None)
    _value(**kw)  # warm
    got = []
    _value(profile_sink=got.append, **kw)
    (sw,) = got
    waits = sum(s.name == "Wait" and sw.spans[s.parent].name == "Progress" for s in sw.spans)
    if case == "plain":
        assert sw.counters["host_syncs"] == VALUE_SYNCS and waits == 0
        assert sw.counters["uploads"] == VALUE_UPLOADS
    else:
        assert (sw.counters["host_syncs"], waits) == (PANELS_SYNCS + PROGRESS_SPANS,
                                                      PROGRESS_SPANS)
        assert sw.counters["host_syncs"] + sw.counters["uploads"] == PANELS_WAITS_BEFORE
    assert sw.counters["decision_steps"] == DECISION_STEPS
    assert _sync_warnings(lambda: _value(**kw)) == sw.counters["host_syncs"] - waits


@pytest.mark.cuda
def test_reprice_syncs_are_host_syncs(cuda):
    _policy_calls("cuda", 8192)  # warm
    fit, rep = _policy_calls("cuda", 8192)
    assert (fit.counters.get("host_syncs", 0), rep.counters["host_syncs"]) == (FIT_SYNCS,
                                                                                REPRICE_SYNCS)
    assert (fit.counters["uploads"], rep.counters["uploads"]) == (FIT_UPLOADS, REPRICE_UPLOADS)
    mix = cases.load_json("traffic", "reprice_1m")
    p = driver.Program(CFG, mix, SEED, "cuda", 8192)
    val = p._simulate(p.coeffs, 8192, key=p._prng_key(9), antithetic=CFG["antithetic"],
                      device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    n = _sync_warnings(lambda: lsmc.reprice(p.ctx, p.policy, val, p.coeffs.vols,
                                            p.coeffs.log_fwd_drift, p.spec,
                                            discount_deltas=CFG["discount_deltas"],
                                            device="cuda"))
    assert n == REPRICE_SYNCS


@pytest.mark.cuda
def test_upload_lands_the_values_it_was_called_with(cuda):
    """The device is kept busy, so the copy runs well after ``upload``
    returns; the array is overwritten at once, and the upload still lands
    the values it had at the call."""
    a = np.arange(1 << 22, dtype=np.float64)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s of device time ahead of the copy
    got = profiling.upload(a, cuda, torch.float32)
    a[:] = -1.0
    assert torch.equal(got.cpu(), torch.arange(1 << 22, dtype=torch.float32))


@pytest.mark.cuda
def test_reprice_is_bit_equal_with_blocking_uploads(cuda, monkeypatch):
    """A reprice (with its fresh path set) gives the same outputs bit for
    bit when every upload is a blocking copy followed by a synchronise."""
    from storage_tpu_torch import valuation
    from storage_tpu_torch.engines import intrinsic
    from storage_tpu_torch.models import simulation
    from storage_tpu_torch.ops import decisions, forward

    mix = cases.load_json("traffic", "reprice_1m")
    p = driver.Program(CFG, mix, SEED, "cuda", 65536)

    def run():
        val = p._simulate(p.coeffs, 65536, key=p._prng_key(7), antithetic=CFG["antithetic"],
                          device="cuda", dtype=torch.float32)
        a = lsmc.reprice(p.ctx, p.policy, val, p.coeffs.vols, p.coeffs.log_fwd_drift, p.spec,
                         discount_deltas=CFG["discount_deltas"], device="cuda")
        return [x.cpu() for x in (a.npv, a.deltas, a.profile_means, a.pv_by_sim,
                                  a.trigger_has_inject, a.trigger_has_withdraw,
                                  a.trigger_inject_volumes, a.trigger_inject_prices,
                                  a.trigger_withdraw_volumes, a.trigger_withdraw_prices)]

    fast = run()

    def blocking(array, device, dtype=None):
        t = (torch.as_tensor(array, dtype=dtype) if isinstance(array, torch.Tensor)
             else torch.tensor(array, dtype=dtype)).to(device)
        torch.cuda.synchronize()
        return t

    for module in (lsmc, decisions, forward, simulation, valuation, intrinsic):
        monkeypatch.setattr(module, "upload", blocking)
    slow = run()
    for a, b in zip(fast, slow):  # bytes, so that the masked trigger rows' NaNs compare too
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
        assert a.numpy().tobytes() == b.numpy().tobytes()
