"""Every per-layer metric in BENCHMARK.json reads a number from a traced run
of each cell it lists, made here by hand."""
import math

import pytest

from portbench import cases, trace

B = cases.benchmark()
PHASES = {"RegressionPriceSimulation": 0.01, "ValuationPriceSimulation": 0.02,
          "BackwardInduction": 0.5, "ForwardSimulation": 0.03, "All": 0.6}


def _trace(entry: str) -> trace.Trace:
    """Two calls of a valuation (two path sets, three K1 launches with glue
    between them, the forward pass) or of a reprice (a path set, the forward
    pass, the harness's spans)."""
    events, t = [], 0.0
    names = (["path_sim_kernel"] * 2 + ["backward_update_kernel", "glue", "glue",
                                        "backward_update_kernel", "glue",
                                        "backward_update_kernel", "forward_sim_kernel"]
             if entry == "value" else ["path_sim_kernel", "forward_sim_kernel"])
    for _ in range(2):
        for n in names:
            events.append((t, t + 10.0, n))
            t += 15.0
    value = entry == "value"
    return trace.Trace(events=events, window_s=1.2, calls=2, steps=4,
                       phases=[dict(PHASES)] * 2 if value else [],
                       spans=[] if value else [("path_sim", 0.009), ("forward", 0.04)] * 2,
                       bounds={"k1": 1e-3, "k2": 1e-3, "k3": 1e-3})


CASES = [(m["name"], cell) for m in B["per_layer"] for cell in m["workloads"]]


@pytest.mark.parametrize("metric, cell", CASES)
def test_reader_reads_its_cells(metric, cell):
    entry = cases.cell(cell)["mix"]["entry"]
    got = trace.reader(metric)(_trace(entry))
    assert got is not None and math.isfinite(got) and got >= 0, (metric, cell)


@pytest.mark.parametrize("metric", sorted(m["name"] for m in B["per_layer"]
                                          if m["name"].endswith(".panels")
                                          and m["name"] != "valuation_s.panels"))
def test_panels_readers_read_as_the_valuation_ones(metric):
    t = _trace("value")
    assert trace.reader(metric)(t) == trace.reader(metric.replace(".panels", ".value"))(t)


def test_panels_wall_is_the_traced_wall_per_call():
    assert trace.reader("valuation_s.panels")(_trace("value")) == pytest.approx(0.6)
