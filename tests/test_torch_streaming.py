"""The port's streaming factor source and streamed valuation against the JAX package.

- Paths: spans regenerated from checkpointed states equal the port's
  one-pass paths bit for bit (the contract the CUDA path kernel is held to
  on the card), and JAX's ``StreamingFactorSource`` spans within 4 ulp of
  the largest path value (the normals differ by up to 4 ulp between XLA and
  torch, ``test_torch_simulation.py``).  Sizes of ``tests/test_streaming.py``:
  103 steps, 64 sims, ``every=32``, both antithetic modes, a sub-span read,
  ``last`` and the cross-span ``ValueError``.
- Valuation: the headline case cut to 2021-08-15 (G = 40, seed 12, 8,192
  paths, 112 simulated steps), streamed by a path budget below its size
  (spans of 64 and 48 steps): NPV within 1e-4 relative of the port's materialised
  run and of the JAX package's streamed run (float32 regression noise: each
  span solves its latest period directly), progress values equal to JAX's
  value for value, and the same ``ValueError`` for panels under streaming.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import storage_tpu as jax_pkg  # noqa: E402
import storage_tpu_torch as torch_pkg  # noqa: E402
from chip_smoke import BASIS, build_case  # noqa: E402
from storage_tpu.models import simulation as jax_sim  # noqa: E402
from storage_tpu_torch import valuation as torch_valuation  # noqa: E402
from storage_tpu_torch.engines import lsmc as torch_lsmc  # noqa: E402
from storage_tpu_torch.models import simulation as torch_sim  # noqa: E402

torch.set_num_threads(2)

N_STEPS, SIMS, EVERY = 103, 64, 32
VAL_SIMS, GRID = 8192, 40
NPV_RTOL = 1e-4
DEVICE = {jax_pkg: {}, torch_pkg: {"device": "cpu"}}


def _coeffs(mod, n=N_STEPS, F=3):
    rng = np.random.default_rng(0)
    return mod.sim_coefficients(
        np.array([2.0, 0.1, 5.0]), 0.3 + 0.2 * rng.random((n, F)),
        np.array([[1.0, 0.3, 0.1], [0.3, 1.0, 0.2], [0.1, 0.2, 1.0]]),
        np.linspace(1 / 365, n / 365, n), 18 + 2 * rng.random(n))


def _source(antithetic, every=EVERY, sims=SIMS):
    return torch_sim.StreamingFactorSource(
        _coeffs(torch_sim), sims, torch_sim.prng_key(42), antithetic, every=every, device="cpu")


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "antithetic"])
def test_spans_equal_one_pass_paths_bit_for_bit(antithetic):
    mono = torch_sim.simulate_factor_paths(
        _coeffs(torch_sim), SIMS, antithetic=antithetic, key=torch_sim.prng_key(42),
        device="cpu").numpy()
    src = _source(antithetic)
    assert src.spans() == [(0, 32), (32, 64), (64, 96), (96, 103)]
    stream = np.concatenate([src.factors(a, b).numpy() for a, b in src.spans()], axis=0)
    assert np.array_equal(mono.view(np.int32), stream.view(np.int32))
    # Partial sub-span reads and the final state match too.
    assert np.array_equal(src.factors(33, 40).numpy(), mono[33:40])
    assert np.array_equal(src.last().numpy(), mono[-1])


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "antithetic"])
def test_spans_match_jax_source(antithetic):
    ref = jax_sim.StreamingFactorSource(
        _coeffs(jax_sim), SIMS, jax.random.PRNGKey(42), antithetic, every=EVERY)
    src = _source(antithetic)
    assert src.spans() == ref.spans() and src.every == ref.every
    scale = None
    for a, b in ref.spans():
        want, got = np.asarray(ref.factors(a, b)), src.factors(a, b).numpy()
        scale = scale or float(np.abs(want).max())
        # 4 ulp of the largest state: the normals' bound, carried by the OU sum.
        np.testing.assert_allclose(got, want, rtol=0, atol=4 * np.spacing(np.float32(scale)) * 8)
    np.testing.assert_allclose(src.last().numpy(), np.asarray(ref.last()), rtol=1e-5, atol=1e-5)


def test_checkpoints_are_the_entering_states():
    src = _source(True)
    mono = torch_sim.simulate_factor_paths(
        _coeffs(torch_sim), SIMS, antithetic=True, key=torch_sim.prng_key(42), device="cpu")
    ckpts = torch_sim.factor_checkpoints_reference(
        _coeffs(torch_sim), SIMS, torch_sim.prng_key(42), True, EVERY, "cpu")
    assert ckpts.shape == (4, 3, SIMS)
    assert not ckpts[0].any()
    for i in (1, 2, 3):
        assert torch.equal(ckpts[i], mono[i * EVERY - 1])
    assert torch.equal(src._checkpoints(), ckpts)


@pytest.mark.parametrize("every,expected", [(1, 16), (16, 16), (17, 32), (250, 256), (512, 512)])
def test_every_rounds_up_to_draw_blocks(every, expected):
    assert _source(False, every=every).every == expected


def test_span_cache_holds_one_span():
    src = _source(False)
    calls = []
    real = torch_sim.simulate_factor_paths_reference

    def counting(*args, **kw):
        calls.append(kw["step0"])
        return real(*args, **kw)

    torch_sim.simulate_factor_paths_reference = counting
    try:
        src.last()
        src.factors(96, 103)
        src.factors(97, 100)
        src.factors(64, 96)
        src.factors(70, 80)
        src.factors(96, 103)
    finally:
        torch_sim.simulate_factor_paths_reference = real
    assert calls == [96, 64, 96]


def test_cross_span_read_rejected():
    with pytest.raises(ValueError, match="span boundary"):
        _source(False, sims=8).factors(30, 40)


def test_resumed_reference_refuses_unaligned_first_step():
    with pytest.raises(ValueError, match="multiple of 16"):
        torch_sim.simulate_factor_paths_reference(
            _coeffs(torch_sim), 8, torch_sim.prng_key(0), False, "cpu", step0=8, num_steps=8)


def test_kernel_block_keys_are_fold_in_of_block_starts():
    key = torch_sim.prng_key(13)
    tables = torch_sim._path_kernel_tables(_coeffs(torch_sim, n=70), key, "cpu")
    want = np.array([torch_sim.fold_in(key, b0) for b0 in range(0, 70, 16)], dtype=np.uint32)
    assert np.array_equal(tables.keys.numpy().view(np.uint32), want)
    assert tables.coef.shape == (70, 3 + 9)


@pytest.mark.parametrize("m,spans,expected", [
    (102, [(0, 32), (32, 64), (64, 96), (96, 103)], [(0, 32), (32, 64), (64, 96), (96, 102)]),
    (64, [(0, 32), (32, 64), (64, 65)], [(0, 32), (32, 64)]),
    (5, None, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5)]),
], ids=["tail", "end-period-span", "no-source"])
def test_refine_spans(m, spans, expected):
    assert torch_lsmc._refine_spans(m, 20, spans) == expected


def _value(pkg, num_sims=VAL_SIMS, **kw):
    storage, fwd, ir, rule = build_case(pkg, storage_end="2021-08-15")
    return pkg.three_factor_seasonal_value(
        cmdty_storage=storage, val_date="2021-04-25", inventory=1500.0, fwd_curve=fwd,
        interest_rates=ir, settlement_rule=rule, num_sims=num_sims, seed=12,
        spot_mean_reversion=91.0, spot_vol=0.85, long_term_vol=0.30, seasonal_vol=0.19,
        basis_funcs=BASIS, discount_deltas=True, num_inventory_grid_points=GRID,
        **DEVICE[pkg], **kw)


@pytest.fixture(scope="module")
def runs():
    """Materialised (port) and streamed (both packages, with progress) runs."""
    out = {"materialised": _value(torch_pkg, return_sim_panels=False)}
    old = os.environ.get("STORAGE_TPU_MAX_PATH_BYTES")
    os.environ["STORAGE_TPU_MAX_PATH_BYTES"] = "1000"
    try:
        for pkg in (jax_pkg, torch_pkg):
            progress = []
            out[pkg] = (_value(pkg, return_sim_panels=False,
                               on_progress_update=progress.append), progress)
    finally:
        if old is None:
            del os.environ["STORAGE_TPU_MAX_PATH_BYTES"]
        else:
            os.environ["STORAGE_TPU_MAX_PATH_BYTES"] = old
    return out


def test_streamed_matches_materialised(runs):
    base, streamed = runs["materialised"], runs[torch_pkg][0]
    assert streamed.npv == pytest.approx(base.npv, rel=NPV_RTOL)
    assert streamed.intrinsic_npv == base.intrinsic_npv
    np.testing.assert_allclose(
        streamed.expected_profile["inventory"].to_numpy(),
        base.expected_profile["inventory"].to_numpy(), atol=1e-3 * 7000.0)


def test_streamed_matches_jax_streamed(runs):
    ref, got = runs[jax_pkg][0], runs[torch_pkg][0]
    assert got.npv == pytest.approx(ref.npv, rel=NPV_RTOL)
    assert np.isfinite(got.deltas.to_numpy()).all()
    # Deltas as test_torch_slice.py holds them: 1e-2 of the largest delta.
    np.testing.assert_allclose(got.deltas.to_numpy(), ref.deltas.to_numpy(), rtol=0,
                               atol=1e-2 * np.abs(ref.deltas.to_numpy()).max())


def test_streamed_progress_matches_jax_value_for_value(runs):
    ref, got = runs[jax_pkg][1], runs[torch_pkg][1]
    assert got == ref
    # 111 decision steps in spans of 64: 2 backward, 2 forward, then 1.0.
    assert len(got) == 5 and got[-1] == 1.0 and got[1] == pytest.approx(0.66)


def test_streaming_walks_the_source_spans_without_hooks(monkeypatch):
    # The same spans with or without hooks, so the same float32 result.
    monkeypatch.setenv("STORAGE_TPU_MAX_PATH_BYTES", "1000")
    progress = []
    hooked = _value(torch_pkg, num_sims=512, return_sim_panels=False,
                    on_progress_update=progress.append)
    assert len(progress) == 5
    assert _value(torch_pkg, num_sims=512, return_sim_panels=False).npv == hooked.npv


def test_panels_rejected_when_streaming(monkeypatch):
    monkeypatch.setenv("STORAGE_TPU_MAX_PATH_BYTES", "1000")
    messages = {}
    for pkg in (jax_pkg, torch_pkg):
        with pytest.raises(ValueError, match="return_sim_panels") as err:
            _value(pkg, return_sim_panels=True)
        messages[pkg] = str(err.value)
    assert messages[torch_pkg] == messages[jax_pkg]


@pytest.mark.parametrize("budget,per_step,expected", [
    (1.5e9, 3.0e6, 125), (1e9, 1.2e7, 64), (6e9, 3.0e6, 256), (1000, 98304, 64),
], ids=["hourly-250k", "daily-1M-forced", "default-budget", "tiny-budget"])
def test_span_length_rule(budget, per_step, expected):
    """``every`` as the valuation reckons it (the source then rounds it up
    to a multiple of 16: 125 -> 128)."""
    assert torch_valuation._stream_span_length(budget, per_step) == expected
