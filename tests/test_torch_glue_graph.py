"""The backward scan's glue between two K1 launches, run as it comes and
replayed as one CUDA graph (``engines/lsmc.py``: ``_glue``,
``backward_scan``, ``_GlueGraph``).

On the CPU, at 256 paths of the benchmark's daily case
(``portbench/configs/daily_ratchet_3f.json``):

- ``backward_scan`` equals, bit for bit, a plain composition of
  ``backward_update_reference``, ``assemble_regression`` and
  ``decision_table`` written here, in float32 and float64; the decision
  geometry made for every step at once equals each span's made alone;
- the graph's scan, with its replay run eagerly and K1 by its plain version
  writing one block of partials, equals the eager scan bit for bit: one span,
  20 progress spans, a streamed path set (whose tail span, walked first, is
  the shortest, so the geometry is copied into rows made for the longest)
  and two shards on one device; it replays once a glue step (decision steps
  less the spans);
- the graph is chosen for shards that all lie on one CUDA device, never for
  CPU tensors or shards on two devices; a CPU valuation records neither of
  its counters.

Marked ``cuda`` (they skip without a card; ``python -m pytest
tests/test_torch_glue_graph.py -q -m cuda`` on one): the graph's valuation
equals the eager one (the choice monkeypatched) by bytes, in float32 and
float64, over one span, 20 progress spans and a streamed path set: the
policy (``coeffs``, ``mus``, ``sds``, ``vbars``), NPV, deltas and trigger
prices; K1 launches once a decision step; the graph is captured once a call
and replayed at decision steps less spans; the scan makes no sync under
``torch.cuda.set_sync_debug_mode("error")`` at 65,536 paths, and the
valuation's ``max_memory_allocated`` is the eager one's within 64 KiB.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import storage_tpu_torch as st  # noqa: E402
from portbench import cases, driver  # noqa: E402
from storage_tpu_torch.engines import lsmc  # noqa: E402
from storage_tpu_torch.models.simulation import StreamingFactorSource  # noqa: E402
from storage_tpu_torch.ops.backward import assemble_regression, backward_update_reference  # noqa: E402
from storage_tpu_torch.ops.regression import (  # noqa: E402
    design_matrix, fit_continuation, spot_from_factors, standardize_columns,
)

SIMS = 256
SEED = 2003
CFG = cases.load_json("configs", "daily_ratchet_3f")
DTYPES = {"float32": torch.float32, "float64": torch.float64}


class Case:
    """The daily case's context, regression paths and backward inputs."""

    def __init__(self, dtype, device="cpu", num_sims=SIMS):
        p = driver.Program(CFG, cases.load_json("traffic", "reprice_1m"), SEED, device, num_sims)
        self.p, self.dtype, self.device = p, dtype, torch.device(device)
        self.reg = p._simulate(p.coeffs, num_sims, key=p._prng_key(SEED + 1),
                               antithetic=CFG["antithetic"], device=device, dtype=dtype)
        self.vols, self.drift = (lsmc._on_device(x, self.device, dtype)
                                 for x in (p.coeffs.vols, p.coeffs.log_fwd_drift))
        self.dev = lsmc.device_inputs(p.ctx, self.device, dtype)
        self.statics = lsmc._program_statics(p.ctx, p.spec, 0)
        self.m = self.reg.shape[0] - 1
        self.first = 1 if p.ctx.val_date_is_first_step else 0

    def geometry(self, a=0, b=None):
        b = self.m if b is None else b
        return lsmc._decision_geometry(self.dev, self.first + a, b - a, self.p.ctx.interp_kind,
                                       self.p.ctx.num_grid_points, 0)

    def program(self, factors, num_chunks=1):
        return lsmc._backward_program(factors, self.vols, self.drift, self.dev,
                                      num_chunks=num_chunks, **self.statics)


@pytest.fixture(scope="module", params=list(DTYPES))
def case(request):
    return Case(DTYPES[request.param])


def _equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a, b))


def _plain_scan(v, factors, vols, drift, geometry, spec):
    """The scan written out: the latest step solved directly, then K1's plain
    version and the regression assembled from its partials, step by step."""
    m, S, B = factors.shape[0], v.shape[1], spec.num_basis
    gj, gw, cost, price = geometry
    vbar = v.mean(dim=1)
    X = design_matrix(spec, spot_from_factors(factors[-1], vols[-1], drift[-1]), factors[-1])
    Xs, mu, sd = standardize_columns(X)
    coeffs = fit_continuation(Xs, v.T - vbar[None, :])
    rows = {m - 1: (coeffs, mu, sd, vbar)}
    musd = torch.stack([mu, sd])
    table = lsmc.decision_table(coeffs, vbar, gj[m - 1], gw[m - 1], cost[m - 1], price[m - 1])
    for k in range(m - 1, -1, -1):
        p = max(k - 1, 0)
        scal = torch.stack([torch.cat([drift[k:k + 1], vols[k]]),
                            torch.cat([drift[p:p + 1], vols[p]])])
        v, graw, praw = backward_update_reference(factors[k], factors[p], v, table, vbar, musd,
                                                  gj[k], gw[k], scal, spec)
        if k == 0:
            break
        vbar_new = vbar + praw[B] / S
        coeffs, mu, sd = assemble_regression(graw, praw, musd, vbar_new - vbar, S)
        rows[k - 1] = (coeffs, mu, sd, vbar_new)
        musd, vbar = torch.stack([mu, sd]), vbar_new
        table = lsmc.decision_table(coeffs, vbar, gj[k - 1], gw[k - 1], cost[k - 1],
                                    price[k - 1])
    return (v, *(torch.stack([rows[k][i] for k in range(m)]) for i in range(4)))


def test_scan_equals_plain_composition(case):
    m = 60
    args = (torch.zeros((case.p.ctx.num_grid_points, SIMS), dtype=case.dtype), case.reg[:m],
            case.vols[:m], case.drift[:m], case.geometry(0, m), case.p.spec)
    got, want = lsmc.backward_scan(*args), _plain_scan(*args)
    assert all(_equal(a, b) for a, b in zip(got, want))


def test_the_calls_geometry_equals_each_spans(case):
    """A materialised path set's decision geometry is made for every step at
    once; each span's rows equal the geometry made for the span alone."""
    whole = case.geometry()
    for a, b in lsmc._chunk_bounds(case.m, 20):
        assert all(_equal(w[a:b], g) for w, g in zip(whole, case.geometry(a, b)))


def _graph_on_cpu(monkeypatch):
    """The graph's scan on the CPU: the replay runs its step eagerly, K1 is its
    plain version writing one block of partials.  Returns the replays."""
    replays = []

    def launch(*args, partials):
        v_out, graw, praw = backward_update_reference(*args)
        partials.copy_(torch.cat([praw, graw], dim=1)[None])
        return v_out, partials

    def replay(self):
        replays.append(1)
        self._step()

    monkeypatch.setattr(lsmc, "_glue_graph", lambda devices: True)
    monkeypatch.setattr(lsmc, "launch_backward_update", launch)
    monkeypatch.setattr(lsmc, "backward_partials",
                        lambda v, D, B: v.new_empty((1, B + 1, v.shape[0] + B + 1)))
    monkeypatch.setattr(lsmc._GlueGraph, "_replay", replay)
    return replays


def _streamed(case, every=48):
    p = case.p
    return StreamingFactorSource(p.coeffs, SIMS, p._prng_key(SEED + 1), CFG["antithetic"],
                                 every=every, device="cpu", dtype=case.dtype)


@pytest.mark.parametrize("route", ["one_span", "progress", "streamed", "two_shards"])
def test_graph_scan_equals_eager_on_cpu(case, route, monkeypatch):
    chunks = 20 if route == "progress" else 1
    factors = {"streamed": lambda: _streamed(case),
               "two_shards": lambda: [x.contiguous() for x in case.reg.chunk(2, dim=2)]}.get(
                   route, lambda: case.reg)
    want = case.program(factors(), chunks)
    replays = _graph_on_cpu(monkeypatch)
    got = case.program(factors(), chunks)
    assert all(_equal(a, b) for a, b in zip(got, want))
    spans = lsmc._refine_spans(case.m, chunks, _streamed(case).spans() if route == "streamed"
                               else None)
    assert len(replays) == case.m - len(spans)


def test_the_first_streamed_span_walked_is_the_shortest(case):
    """The streamed case above: the scan walks the source's tail first, so the
    geometry is copied into rows made for the longest span."""
    spans = lsmc._refine_spans(case.m, 1, _streamed(case).spans())
    assert spans[-1][1] - spans[-1][0] < max(b - a for a, b in spans)


@pytest.mark.parametrize("devices,graph", [
    (["cpu"], False), (["cpu", "cpu"], False), (["cuda:0"], True),
    (["cuda:0", "cuda:0"], True), (["cuda:0", "cuda:1"], False), (["cuda:1", "cuda:0"], False),
])
def test_the_graph_is_chosen_by_the_shards_devices(devices, graph):
    assert lsmc._glue_graph([torch.device(d) for d in devices]) is graph


def _value(device="cpu", num_sims=SIMS, dtype=torch.float32, panels=False, **kw):
    return st.three_factor_seasonal_value(
        **cases.port_case(CFG), num_sims=num_sims, seed=SEED, dtype=dtype, device=device,
        return_sim_panels=panels, **kw)


def test_a_cpu_valuation_records_no_graph_counter():
    got = []
    _value(profile_sink=got.append)
    (sw,) = got
    assert sw.counters["decision_steps"] == 340
    assert not {"glue_graph_captures", "glue_graph_replays"} & set(sw.counters)


# --------------------------------------------------------------------------- #
# On the card                                                                 #
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _recorded(monkeypatch, fn):
    """``fn()`` and the outputs of its ``_backward_program``."""
    got = []
    real = lsmc._backward_program

    def program(*a, **k):
        got.append(real(*a, **k))
        return got[-1]

    monkeypatch.setattr(lsmc, "_backward_program", program)
    try:
        res = fn()
    finally:
        monkeypatch.setattr(lsmc, "_backward_program", real)
    (policy,) = got
    return res, policy


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x, dtype=np.float64)).tobytes()


ROUTES = {"one_span": {}, "progress": {"on_progress_update": lambda f: None, "panels": True},
          "streamed": {}}


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_graph_equals_eager_by_bytes(cuda, route, dtype, monkeypatch):
    if route == "streamed":
        monkeypatch.setenv("STORAGE_TPU_MAX_PATH_BYTES", "1000")
    kw = dict(device="cuda", num_sims=8192, dtype=DTYPES[dtype], **ROUTES[route])
    res, policy = _recorded(monkeypatch, lambda: _value(**kw))
    monkeypatch.setattr(lsmc, "_glue_graph", lambda devices: False)
    ref, ref_policy = _recorded(monkeypatch, lambda: _value(**kw))
    for a, b in zip(policy, ref_policy):
        assert _bytes(a) == _bytes(b)
    assert _bytes(res.npv) == _bytes(ref.npv)
    assert _bytes(res.deltas.to_numpy()) == _bytes(ref.deltas.to_numpy())
    assert _bytes(res.trigger_prices.to_numpy()) == _bytes(ref.trigger_prices.to_numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("route,spans", [("one_span", 1), ("progress", 20)])
def test_k1_launches_and_graph_replays(cuda, route, spans):
    kw = dict(device="cuda", num_sims=8192, **ROUTES[route])
    _value(**kw)  # warm
    got = []
    st.reset_launch_counts()
    _value(profile_sink=got.append, **kw)
    torch.cuda.synchronize()
    (sw,) = got
    steps = sw.counters["decision_steps"]
    assert st.launch_counts()["backward_update"] == steps
    assert sw.counters["glue_graph_captures"] == 1
    assert sw.counters["glue_graph_replays"] == steps - spans


@pytest.mark.cuda
def test_the_scan_makes_no_sync(cuda, monkeypatch):
    real = lsmc._GlueGraph.scan
    scans = []

    def scan(self, *a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(self, *a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            scans.append(1)

    _value(device="cuda", num_sims=65536)  # warm
    torch.cuda.synchronize()
    monkeypatch.setattr(lsmc._GlueGraph, "scan", scan)
    _value(device="cuda", num_sims=65536)
    assert scans == [1]


@pytest.mark.cuda
def test_peak_memory_equals_the_eager_scan(cuda, monkeypatch):
    def peak():
        _value(device="cuda", num_sims=65536)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _value(device="cuda", num_sims=65536)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()

    graph = peak()
    monkeypatch.setattr(lsmc, "_glue_graph", lambda devices: False)
    eager = peak()
    assert abs(graph - eager) <= 64 * 1024, (graph, eager)
