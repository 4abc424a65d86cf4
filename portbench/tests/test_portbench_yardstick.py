"""The yardstick pinned to PERF.md's kernel table, and the trace arithmetic."""
import pytest

from portbench import cases, yardstick


@pytest.mark.parametrize("name, got, ms, by", [
    ("K1 at 1M, G = 100, D = 3, B = 10", lambda: yardstick.k1_bound(1_000_000, 100, 3, 10, 3),
     0.246, "bytes"),
    ("K2 over 340 steps x 1M", lambda: yardstick.k2_bound(340, 1_000_000, 3, 10, 3, False),
     1.715, "operations"),
    ("K3 [341, 3, 1M]", lambda: yardstick.k3_bound(341, 1_000_000, 3, 1_000_000),
     4.581, "operations"),
])
def test_bounds_match_the_kernel_table(name, got, ms, by):
    t, bound_by = got()
    assert bound_by == by, name
    assert round(t, 3) == ms, name


def test_busy_union_of_overlapping_and_disjoint_intervals():
    ev = [(0.0, 10.0, "a"), (5.0, 12.0, "b"), (20.0, 25.0, "c"), (21.0, 22.0, "d"),
          (30.0, 30.5, "e")]
    assert yardstick.busy_us(ev) == pytest.approx(12.0 + 5.0 + 0.5)
    assert yardstick.busy_us([]) == 0.0
    gaps = yardstick.gaps(ev)
    assert [(round(s, 3), round(g, 3)) for s, g, _, _ in gaps] == [(12.0, 8.0), (25.0, 5.0)]
    assert gaps[0][2:] == ("b", "c") and gaps[1][2:] == ("c", "e")


def test_call_bounds_from_the_work():
    cfg = cases.load_json("configs", "daily_ratchet_3f")
    k1 = yardstick.k1_bound(1_000_000, 100, 3, 10, 3)[0]
    k2 = yardstick.k2_bound(340, 1_000_000, 3, 10, 3, False)[0]
    k3 = yardstick.k3_bound(341, 1_000_000, 3, 1_000_000)[0]
    daily = yardstick.call_bounds("value", 341, 1_000_000, cfg, False)
    assert daily == pytest.approx({"k1": 340 * k1, "k2": k2, "k3": 2 * k3})
    reprice = yardstick.call_bounds("reprice", 341, 1_000_000, cfg, False)
    assert reprice == pytest.approx({"k1": 0.0, "k2": k2, "k3": k3})
    panels = yardstick.call_bounds("value", 341, 2000, cfg, True)
    assert panels["k2"] == pytest.approx(yardstick.k2_bound(340, 2000, 3, 10, 3, True)[0])
    # A set over the path budget is drawn once more, writing no paths.
    streamed = yardstick.call_bounds("value", 341, 1_000_000, dict(cfg, max_path_bytes=1e9),
                                     False)
    again = yardstick.k3_bound(341, 1_000_000, 3, 1_000_000, rows=0)[0]
    assert streamed["k3"] == pytest.approx(2 * (k3 + again))
    # The grid, the basis and the precision are the configuration's.
    wide = yardstick.call_bounds("value", 341, 1_000_000,
                                 dict(cfg, num_inventory_grid_points=200, dtype="float64"), False)
    assert wide["k1"] == pytest.approx(340 * yardstick.k1_bound(1_000_000, 200, 3, 10, 3, 8)[0])
