"""The backward scan (``engines/lsmc.py``: ``_BackwardScan``, its glue
step between two K1 launches run as it comes or replayed as one CUDA graph,
and ``backward_scan`` over one span) and K1's one entry
(``ops/backward.py::backward_update``).

On the CPU, at 256 paths of the benchmark's daily case
(``portbench/configs/daily_ratchet_3f.json``), in float32 and float64:

- ``backward_scan`` equals, bit for bit, a plain composition of
  ``backward_update_reference``, ``assemble_regression`` and
  ``decision_table`` written here; the decision geometry made for every step
  at once equals each span's made alone;
- ``_backward_program`` equals a plain walk of that composition over the same
  spans in reverse, bit for bit, both as the CPU runs it and with the graph's
  route forced (its replay running the step eagerly): one span, 20 progress
  spans, a streamed path set (whose tail span, walked first, is the
  shortest, so the geometry is copied into rows made for the longest) and
  two shards on one device; the forced route replays once a glue step
  (decision steps less the spans);
- K1's entry on CPU tensors writes its plain version's sums into one block of
  partials, which the reduction gives back bit for bit;
- the graph is chosen for shards that all lie on one CUDA device, never for
  CPU tensors or shards on two devices; a CPU valuation records neither of
  its counters.

Marked ``cuda`` (they skip without a card; ``python -m pytest
tests/test_torch_glue_graph.py -q -m cuda`` on one): the graph's valuation
equals, by bytes, the one whose glue step runs directly (the replay
monkeypatched), in float32 and float64, over one span, 20 progress spans and
a streamed path set: the policy (``coeffs``, ``mus``, ``sds``, ``vbars``),
NPV, deltas and trigger prices; K1 launches once a decision step; the graph
is captured once a call and replayed at decision steps less spans; the scan
makes no sync under ``torch.cuda.set_sync_debug_mode("error")`` at 65,536
paths, and the valuation's ``max_memory_allocated`` is the direct step's
within 64 KiB.
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
from storage_tpu_torch.ops.backward import (  # noqa: E402
    assemble_regression, backward_partials, backward_update, backward_update_reference,
    reduce_partials,
)
from storage_tpu_torch.ops.regression import (  # noqa: E402
    design_matrix, fit_continuation_shards, spot_from_factors, standardize_shards,
)
from storage_tpu_torch.parallel.mesh import sims_mean  # noqa: E402

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
    version on each shard and the regression assembled from its partials,
    summed in shard order, step by step.  ``v`` and ``factors`` are tensors
    or lists of their shards."""
    shards = isinstance(v, list)
    v, factors = (v, factors) if shards else ([v], [factors])
    m, S, B = factors[0].shape[0], sum(x.shape[1] for x in v), spec.num_basis
    gj, gw, cost, price = geometry
    vbar = sims_mean(v, 1)
    Xs, mu, sd = standardize_shards([
        design_matrix(spec, spot_from_factors(f[-1], vols[-1], drift[-1]), f[-1])
        for f in factors])
    coeffs = fit_continuation_shards(Xs, [x.T - vbar[None, :] for x in v])
    rows = {m - 1: (coeffs, mu, sd, vbar)}
    musd = torch.stack([mu, sd])
    table = lsmc.decision_table(coeffs, vbar, gj[m - 1], gw[m - 1], cost[m - 1], price[m - 1])
    for k in range(m - 1, -1, -1):
        p = max(k - 1, 0)
        scal = torch.stack([torch.cat([drift[k:k + 1], vols[k]]),
                            torch.cat([drift[p:p + 1], vols[p]])])
        outs = [backward_update_reference(f[k], f[p], x, table, vbar, musd, gj[k], gw[k], scal,
                                          spec) for f, x in zip(factors, v)]
        v = [o[0] for o in outs]
        if k == 0:
            break
        graw, praw = (sum(parts[1:], parts[0]) for parts in
                      ([o[1] for o in outs], [o[2] for o in outs]))
        vbar_new = vbar + praw[B] / S
        coeffs, mu, sd = assemble_regression(graw, praw, musd, vbar_new - vbar, S)
        rows[k - 1] = (coeffs, mu, sd, vbar_new)
        musd, vbar = torch.stack([mu, sd]), vbar_new
        table = lsmc.decision_table(coeffs, vbar, gj[k - 1], gw[k - 1], cost[k - 1],
                                    price[k - 1])
    return (v if shards else v[0], *(torch.stack([rows[k][i] for k in range(m)])
                                      for i in range(4)))


def _plain_program(case, factors, num_chunks):
    """``_backward_program`` written out: ``_plain_scan`` over its spans in
    reverse, each handed the previous span's value surface, then the
    current period's step."""
    assert case.statics["terminal_fn"] is None and case.first == 1
    reg = lsmc._factor_access(factors)
    G = case.p.ctx.num_grid_points
    v = [torch.zeros((G, w), dtype=case.dtype) for w in reg.widths]
    rows = []
    for a, b in reversed(lsmc._refine_spans(case.m, num_chunks, reg.spans)):
        v, *policy = _plain_scan(v, reg.get(a, b), case.vols[a:b], case.drift[a:b],
                                 case.geometry(a, b), case.p.spec)
        rows.insert(0, policy)
    v0, cont_mean0 = lsmc._current_period_step(v, case.dev, case.p.ctx.interp_kind, G, 0)
    return (sims_mean(v0), cont_mean0, *(torch.cat(x) for x in zip(*rows)))


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


def test_k1s_entry_writes_one_exact_block(case):
    """``backward_update`` on CPU tensors fills one block of partials with
    its plain version's sums; reduced, they are those sums bit for bit."""
    k, G, spec = 170, case.p.ctx.num_grid_points, case.p.spec
    gen = torch.Generator().manual_seed(SEED)
    v = (torch.randn((G, SIMS), generator=gen, dtype=torch.float64) * 50.0).to(case.dtype)
    coeffs = torch.randn((spec.num_basis, G), generator=gen, dtype=torch.float64).to(case.dtype)
    geometry = [g[0] for g in case.geometry(k, k + 1)]
    table = lsmc.decision_table(coeffs, v.mean(dim=1), *geometry)
    Xs, mu, sd = standardize_shards([design_matrix(
        spec, spot_from_factors(case.reg[k], case.vols[k], case.drift[k]), case.reg[k])])
    args = (case.reg[k], case.reg[k - 1], v, table, v.mean(dim=1), torch.stack([mu, sd]),
            *geometry[:2], lsmc._step_scalars(case.vols, case.drift)[k])
    partials = backward_partials(v, table.shape[0], spec.num_basis)
    v_out, got = backward_update(*args, spec=spec, partials=partials)
    assert got is partials and tuple(got.shape) == (1, spec.num_basis + 1,
                                                    G + spec.num_basis + 1)
    want = backward_update_reference(*args, spec)
    assert all(_equal(a, b) for a, b in zip((v_out, *reduce_partials(got, G)), want))


def _graph_on_cpu(monkeypatch):
    """The graph's route on the CPU, its replay running the step eagerly.
    Returns the replays."""
    replays = []

    def replay(self):
        replays.append(1)
        self._step()

    monkeypatch.setattr(lsmc, "_glue_graph", lambda devices: True)
    monkeypatch.setattr(lsmc._BackwardScan, "_replay", replay)
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
    want = _plain_program(case, factors(), chunks)
    assert all(_equal(a, b) for a, b in zip(case.program(factors(), chunks), want))
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


def _step_directly(monkeypatch):
    """The glue step run directly on the card, in place of the graph's replay."""
    monkeypatch.setattr(lsmc._BackwardScan, "_replay", lambda self: self._step())


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
    _step_directly(monkeypatch)
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
    real = lsmc._BackwardScan.scan
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
    monkeypatch.setattr(lsmc._BackwardScan, "scan", scan)
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
    _step_directly(monkeypatch)
    eager = peak()
    assert abs(graph - eager) <= 64 * 1024, (graph, eager)
