"""The port's C++ host-op loader (``storage_tpu_torch/native``) against the
JAX package's.

Both packages build ``csrc/storage_host_ops.cpp`` with the same ``g++``
flags, each into its own place, so on the same inputs their libraries give
the same bits.  Here: every case of ``tests/test_native.py`` on the port
(the C++ reduction against the NumPy one on the same 30 random
configurations at rtol 1e-12 / atol 1e-9, infeasible configurations raising
from both); the port's library against the JAX package's on those
configurations, bit for bit; the 2-year hourly case's valuation context,
port against JAX, grids and inventory space bit for bit (the port's NumPy
reduction is 1 ulp off the C++ one on 14 of its 17,521 entries, so this
holds only with the C++ route on both sides); and
``calculate_inventory_space``'s signature, positional arguments included.
"""
import inspect
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import storage_tpu as jax_pkg  # noqa: E402
import storage_tpu_torch as torch_pkg  # noqa: E402
import chip_smoke  # noqa: E402
from chip_smoke import build_hourly_case  # noqa: E402
from storage_tpu.native import inventory_space_native as jax_native  # noqa: E402
from storage_tpu.ops import inventory_space as jax_space  # noqa: E402
from storage_tpu_torch import native  # noqa: E402
from storage_tpu_torch.exceptions import InventoryConstraintsCannotBeFulfilledError  # noqa: E402
from storage_tpu_torch.ops import inventory_space as port_space  # noqa: E402
from storage_tpu_torch.ops.ratchets import INTERP_LINEAR, INTERP_POLY, INTERP_STEP  # noqa: E402
from test_native import random_config  # noqa: E402

pytestmark = pytest.mark.skipif(
    not native.native_available(), reason="native library unavailable (no g++?)"
)


def _configs(interp_kind, seed=123, trials=30):
    rng = np.random.default_rng(seed)
    return [random_config(rng, interp_kind) for _ in range(trials)]


@pytest.mark.parametrize("interp_kind", [INTERP_LINEAR, INTERP_STEP])
@pytest.mark.parametrize("must_be_empty", [False, True])
def test_native_matches_numpy(interp_kind, must_be_empty):
    checked = 0
    for tables, min_inv, max_inv, loss, start in _configs(interp_kind):
        try:
            py = port_space.calculate_inventory_space(
                tables, interp_kind, min_inv, max_inv, loss, start, must_be_empty,
                use_native=False)
        except InventoryConstraintsCannotBeFulfilledError:
            with pytest.raises(InventoryConstraintsCannotBeFulfilledError):
                native.inventory_space_native(
                    tables, interp_kind, min_inv, max_inv, loss, start, must_be_empty)
            continue
        got = native.inventory_space_native(
            tables, interp_kind, min_inv, max_inv, loss, start, must_be_empty)
        assert got is not None
        np.testing.assert_allclose(got[0], py.min_inventory, rtol=1e-12, atol=1e-9)
        np.testing.assert_allclose(got[1], py.max_inventory, rtol=1e-12, atol=1e-9)
        checked += 1
    assert checked >= 10  # most random configs should be feasible


@pytest.mark.parametrize("interp_kind", [INTERP_LINEAR, INTERP_STEP])
@pytest.mark.parametrize("must_be_empty", [False, True])
def test_native_equals_jax_library(interp_kind, must_be_empty):
    """The port's library and the JAX package's: one source, one set of
    flags, the same bits (and the same refusals) on every configuration."""
    for tables, min_inv, max_inv, loss, start in _configs(interp_kind):
        args = (tables, interp_kind, min_inv, max_inv, loss, start, must_be_empty)
        try:
            want = jax_native(*args)
        except jax_pkg.InventoryConstraintsCannotBeFulfilledError:
            with pytest.raises(InventoryConstraintsCannotBeFulfilledError):
                native.inventory_space_native(*args)
            continue
        got = native.inventory_space_native(*args)
        assert want is not None and got is not None
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_dispatch_uses_native_by_default():
    tables, min_inv, max_inv, loss, start = _configs(INTERP_LINEAR, seed=7, trials=1)[0]
    args = (tables, INTERP_LINEAR, min_inv, max_inv, loss, start, False)
    a = port_space.calculate_inventory_space(*args, use_native=True)
    b = port_space.calculate_inventory_space(*args, use_native=False)
    direct = native.inventory_space_native(*args)
    np.testing.assert_array_equal(a.min_inventory, direct[0])
    np.testing.assert_array_equal(a.max_inventory, direct[1])
    np.testing.assert_allclose(a.min_inventory, b.min_inventory, atol=1e-9)
    np.testing.assert_allclose(a.max_inventory, b.max_inventory, atol=1e-9)


def test_signature_matches_jax():
    """``use_native`` stands before ``numerical_tolerance`` in both packages,
    so a positional 8th argument means the same in each."""
    port = list(inspect.signature(port_space.calculate_inventory_space).parameters)
    ref = list(inspect.signature(jax_space.calculate_inventory_space).parameters)
    assert port == ref
    assert port[7:] == ["use_native", "numerical_tolerance"]
    tables, min_inv, max_inv, loss, start = _configs(INTERP_LINEAR, seed=7, trials=1)[0]
    positional = port_space.calculate_inventory_space(
        tables, INTERP_LINEAR, min_inv, max_inv, loss, start, False, False, 1e-9)
    numpy_route = port_space.calculate_inventory_space(
        tables, INTERP_LINEAR, min_inv, max_inv, loss, start, False, use_native=False)
    np.testing.assert_array_equal(positional.max_inventory, numpy_route.max_inventory)


def test_poly_takes_numpy(monkeypatch):
    """POLY ratchets never reach the C++ op (it has no polynomial solver)."""
    monkeypatch.setattr(native, "inventory_space_native",
                        lambda *a: pytest.fail("POLY reached the native op"))
    # Constant rates: Horner coefficients highest power first, zero on top.
    table = np.column_stack([[0.0, 1000.0], [-50.0, -50.0], [40.0, 40.0],
                             [0.0, -50.0], [0.0, 40.0]])
    n = 10
    space = port_space.calculate_inventory_space(
        [table] * n, INTERP_POLY, np.zeros(n + 1), np.full(n + 1, 1000.0), np.zeros(n),
        500.0, False)
    assert space.max_inventory[1] == pytest.approx(540.0)


def test_hourly_context_equals_jax():
    """The hourly case (``benchmarks/hourly_bench.py::build_case(2)``, 17,520
    steps): the port's context against the JAX package's, inventory space and
    grids bit for bit.  The port's NumPy reduction on the same case agrees
    only to 1e-12 (1 ulp on 14 entries)."""
    from storage_tpu.compile import build_valuation_context as jax_context
    from storage_tpu_torch.compile import build_valuation_context as port_context

    contexts = []
    for pkg, build in ((jax_pkg, jax_context), (torch_pkg, port_context)):
        storage, fwd = build_hourly_case(pkg)
        contexts.append(build(storage, "2021-01-01", 1500.0, fwd, 0.01, None, 100, 1e-12))
    ref, got = contexts
    assert got.n_steps == ref.n_steps == 17_520
    np.testing.assert_array_equal(got.inv_space.min_inventory, ref.inv_space.min_inventory)
    np.testing.assert_array_equal(got.inv_space.max_inventory, ref.inv_space.max_inventory)
    np.testing.assert_array_equal(np.asarray(got.grids), np.asarray(ref.grids))
    storage, _ = build_hourly_case(torch_pkg)
    numpy_route = port_space.calculate_inventory_space(
        storage.pillar_tables, storage.interp_kind, storage.min_inventory_by_step,
        storage.max_inventory_by_step, storage.inventory_loss_by_step, 1500.0,
        storage.must_be_empty_at_end, use_native=False)
    np.testing.assert_allclose(numpy_route.max_inventory, got.inv_space.max_inventory,
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(numpy_route.min_inventory, got.inv_space.min_inventory,
                               rtol=1e-12, atol=0)


def test_smoke_recomputes_the_context_inventory_space():
    """``chip_smoke._inventory_space`` rebuilds a context's inventory space
    from the inputs ``build_valuation_context`` gave it: the C++ route bit
    for bit, valued after the storage start (the daily case, 24 periods in),
    and the NumPy route within 1e-12."""
    from storage_tpu_torch.compile import build_valuation_context

    storage, fwd, rates, rule = chip_smoke.build_case(torch_pkg)
    ctx = build_valuation_context(storage, "2021-04-25", 1500.0, fwd, rates, rule, 100, 1e-12)
    assert (ctx.periods[0] - storage.start).n == 24
    fast = chip_smoke._inventory_space(ctx, True)
    slow = chip_smoke._inventory_space(ctx, False)
    for got, ref in ((fast, ctx.inv_space), (slow, ctx.inv_space)):
        assert got.max_inventory.shape == ref.max_inventory.shape == (ctx.n_steps + 1,)
    np.testing.assert_array_equal(fast.min_inventory, ctx.inv_space.min_inventory)
    np.testing.assert_array_equal(fast.max_inventory, ctx.inv_space.max_inventory)
    np.testing.assert_allclose(slow.max_inventory, fast.max_inventory, rtol=1e-12, atol=0)
    np.testing.assert_allclose(slow.min_inventory, fast.min_inventory, rtol=1e-12, atol=0)


def test_missing_compiler_falls_back_to_numpy(monkeypatch, tmp_path, caplog):
    """Without ``g++`` the loader logs a WARNING and the reduction runs in
    NumPy; the JAX package's library directory is never written."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    with caplog.at_level("WARNING", logger="storage_tpu_torch.native"):
        assert not native.native_available()
    assert "NumPy" in caplog.text
    assert not list(tmp_path.iterdir())
    tables, min_inv, max_inv, loss, start = _configs(INTERP_LINEAR, seed=7, trials=1)[0]
    args = (tables, INTERP_LINEAR, min_inv, max_inv, loss, start, False)
    a = port_space.calculate_inventory_space(*args)
    b = port_space.calculate_inventory_space(*args, use_native=False)
    np.testing.assert_array_equal(a.max_inventory, b.max_inventory)
