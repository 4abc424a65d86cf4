"""The CUDA kernels against their plain PyTorch versions, on a CUDA device.

Marked ``cuda``: without a CUDA device every test here skips (a CUDA kernel
has no CPU mode).  Run them on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -q

Random inputs at odd sizes exercise what the main path's shapes do not:
ragged tail blocks, other basis and grid widths (the backward kernel up to
G = 700 at D = 5, in both precisions, sim counts that end a tile inside its
ring of slots, a grid of one block, launches back to back, the widest
decision counts, and bit-identical reruns), STEP ratchets,
single-pillar (constant-rate) tables, and the forward kernel's options —
per-sim panels, D = 7 decisions (``extra_decisions=2``) and POLY ratchets
whose pillar tables are zero-padded to a common height, sim counts below
and across its 256-sim tiles, a span of one step, and bit-identical reruns.  The path
kernel must equal its plain version bit for bit (it fuses multiply-adds
where XLA does, with the card's FMA against the plain version's exact
emulation), also span by span from checkpointed states, in its checkpoint
mode and in its window mode (a shard's columns of the whole set), and a
valuation over a paths mesh of two shards on the card must agree with the
one-device run.  Rounding differs
between a kernel and its plain version (FMA contraction), so near-tie
decisions may flip; flips are counted and bounded like ``chip_smoke.py``
bounds them (<= 1e-4 of the paths per decision; panels and final
inventories within 1e-5 of each field's max outside flipped paths, a path
counting as flipped where its PV or any of its volumes differ).  The
float64 instantiations are held tighter: K3 bit for bit (its draws and OU
update fuse multiply-adds where XLA does, with the card's DFMA against the
plain version's exact emulation), K2 to 1e-12 with no flips (it rounds as
torch does), K1 to 1e-12 outside at most 1e-6 of flipped V entries.
"""
import numpy as np
import pytest
import torch

from storage_tpu_torch import launch_counts, reset_launch_counts
from storage_tpu_torch.models import simulation
from storage_tpu_torch.ops import backward, forward
from storage_tpu_torch.ops.csrc import KernelLaunchError, kernels
from storage_tpu_torch.ops.ratchets import INTERP_POLY, pad_pillars
from storage_tpu_torch.ops.regression import BasisSpec

pytestmark = pytest.mark.cuda

SPEC_3F = BasisSpec((0, 0, 0, 0, 1, 0, 0, 0, 2, 1),
                    ((0, 0, 0), (1, 0, 0), (0, 0, 1), (0, 1, 0), (0, 0, 0), (2, 0, 0),
                     (0, 0, 2), (0, 2, 0), (0, 0, 0), (1, 0, 0)))
SPEC_SMALL = BasisSpec((0, 1, 0), ((0, 0, 0), (0, 0, 0), (1, 0, 0)))
# 16 and 13 terms: the backward kernel reads fitted rows of B + 2 floats as
# five and four float4s (three up to B = 10).
SPEC_16 = BasisSpec(tuple(b % 3 for b in range(16)),
                    tuple(((b // 3) % 2, (b // 6) % 2, b % 2) for b in range(16)))
SPEC_13 = BasisSpec(SPEC_16.spot_powers[:13], SPEC_16.factor_powers[:13])
# Powers of 3 and 4: the forward kernel keeps those in a shared-memory table
# (first and second powers stay in registers).
SPEC_CUBIC = BasisSpec((0, 3, 1, 4, 0), ((0, 0, 0), (1, 0, 0), (3, 0, 2), (0, 4, 0), (2, 3, 1)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _backward_inputs(spec, S, G, D, seed, device, local=False):
    """Random K1 operands; with ``local`` each decision moves inventory by at
    most 4 grid points (j near g, as on the main path), else j is uniform."""
    g = torch.Generator().manual_seed(seed)
    F = len(spec.factor_powers[0])
    B = spec.num_basis

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device)

    v_next = r(G, S, scale=50.0) + torch.linspace(0, 400, G, device=device)[:, None]
    musd = torch.stack([r(B, scale=0.3), torch.rand(B, generator=g).to(device) + 0.5])
    if local:
        step = torch.randint(-4, 5, (D, G), generator=g)
        j = (torch.arange(G) + step).clamp(0, G - 2).to(torch.int32).to(device)
    else:
        j = torch.randint(0, G - 1, (D, G), generator=g, dtype=torch.int32).to(device)
    w = torch.rand(D, G, generator=g).to(device)
    scal = torch.cat([torch.full((2, 1), 2.7), torch.rand(2, F, generator=g) * 0.3], 1).to(device)
    return (r(F, S, scale=0.5), r(F, S, scale=0.5), v_next, r(D, G, B + 2, scale=20.0),
            v_next.mean(dim=1), musd, j, w, scal)


def _k1(args, spec):
    """K1 on ``args``: ``(v_out, graw, praw)``, its partials reduced."""
    v_out, partials = backward.backward_update(*args, spec=spec)
    return (v_out, *backward.reduce_partials(partials, v_out.shape[0]))


@pytest.mark.parametrize("spec,S,G,D", [(SPEC_3F, 1000, 17, 3), (SPEC_SMALL, 4097, 40, 5)],
                         ids=["B10-tail", "B3-D5"])
def test_backward_update_matches_plain(cuda, spec, S, G, D):
    args = _backward_inputs(spec, S, G, D, seed=S, device=cuda)
    reset_launch_counts()
    out = _k1(args, spec)
    assert launch_counts()["backward_update"] == 1
    _assert_backward_agrees(args, spec, out)


def _assert_backward_agrees(args, spec, out):
    """K1's outputs against its plain version's: float32 within 1e-5 of
    max|V| outside near-tie flips (at most 1e-3 of V) and partials within
    1e-4; float64 as ``test_backward_update_f64_matches_plain`` holds it."""
    v_k, graw_k, praw_k = out
    v_r, graw_r, praw_r = backward.backward_update_reference(*args, spec=spec)
    torch.cuda.synchronize()
    v_tol, flips, rtol = (1e-12, 1e-6, 1e-12) if v_k.dtype == torch.float64 else (1e-5, 1e-3, 1e-4)
    flipped = (v_k - v_r).abs() > v_tol * v_r.abs().max()
    assert flipped.double().mean().item() <= flips
    for a, b in ((graw_k, graw_r), (praw_k, praw_r)):
        assert ((a - b).abs().max() / b.abs().max()).item() <= rtol


# Shapes the persistent-grid kernel must take: grids past the PR-1 kernel's
# shared-memory limit (G = 663 at D = 3, 502 at D = 5, 403 at D = 7), fewer
# sims than one 128-sim tile, fewer than one pass of the persistent grid,
# several passes with a ragged tail, G not a multiple of the 16-point chunk,
# an odd S, small and wide bases, decisions that move inventory anywhere on
# the grid (uniform j), and the widest decision counts: the one-phase
# kernel's limits (D = 77 / 55 at B = 10 / 16, D = 2 extra_decisions + 3)
# and past them, where a block of one decision warpgroup holds one ring slot
# and one xr tile (B = 16 at D = 57).
@pytest.mark.parametrize("spec,S,G,D,local", [
    (SPEC_3F, 2048, 700, 5, True), (SPEC_3F, 1500, 450, 7, True),
    (SPEC_3F, 100, 37, 3, True), (SPEC_3F, 20_000, 100, 3, True),
    (SPEC_3F, 300_004, 100, 3, True), (SPEC_SMALL, 4097, 45, 3, True),
    (SPEC_3F, 3000, 70, 3, False), (SPEC_16, 3000, 60, 3, True), (SPEC_13, 2000, 50, 5, True),
    (SPEC_3F, 65_537, 700, 5, True), (SPEC_3F, 1000, 37, 77, True),
    (SPEC_16, 1000, 37, 55, True), (SPEC_16, 1000, 37, 57, True),
], ids=["G700-D5", "G450-D7", "below-tile", "below-grid-pass", "multi-pass", "odd-S",
        "wide-span", "B16", "B13-D5", "G700-D5-ragged", "B10-D77", "B16-D55",
        "B16-D57-one-slot"])
def test_backward_update_shapes_match_plain(cuda, spec, S, G, D, local):
    args = _backward_inputs(spec, S, G, D, seed=S + G, device=cuda, local=local)
    reset_launch_counts()
    out = _k1(args, spec)
    assert launch_counts()["backward_update"] == 1
    _assert_backward_agrees(args, spec, out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("D", [3, 5])
def test_backward_update_is_deterministic(cuda, D, dtype):
    """Two launches on the same inputs give bit-identical outputs, in either
    instantiation."""
    args = [a.to(dtype) if a.is_floating_point() else a
            for a in _backward_inputs(SPEC_3F, 300_004, 100, D, seed=7, device=cuda, local=True)]
    first = _k1(args, SPEC_3F)
    second = _k1(args, SPEC_3F)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# What the warp-specialised kernel's ring of vc slots adds: tile groups that
# end inside the ring (1, 127, 129 and 2,000 sims: decision warpgroups with
# part-filled or no tiles, a block with one item at G <= 16), G no multiple
# of the 16-point chunk, every tile walked by one block (a grid of one block
# forced through backward_update_launch), and the launch plans of wide
# shapes: in float64 at B = 16 and D >= 5 a block holds fewer decision
# warpgroups (two at D = 5, 7 and 13, one at D = 19).
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("spec,S,G,D,blocks", [
    (SPEC_3F, 1, 40, 3, None), (SPEC_3F, 127, 16, 3, None), (SPEC_3F, 127, 9, 5, None),
    (SPEC_SMALL, 129, 33, 5, None), (SPEC_3F, 2000, 100, 3, None), (SPEC_13, 2000, 37, 3, None),
    (SPEC_3F, 2000, 41, 3, 1), (SPEC_3F, 20_000, 100, 5, 1), (SPEC_16, 3001, 23, 3, 1),
    (SPEC_16, 3001, 23, 5, None), (SPEC_16, 20_000, 37, 7, 1), (SPEC_16, 2000, 19, 13, None),
    (SPEC_16, 1000, 17, 19, None),
], ids=["S1", "S127-one-item", "S127-G9-D5", "S129-G33-D5", "S2000", "S2000-G37-B13",
        "one-block", "one-block-many-tiles", "one-block-B16", "B16-D5", "one-block-B16-D7",
        "B16-D13", "B16-D19"])
def test_backward_update_ring_edges_match_plain(cuda, spec, S, G, D, blocks, dtype, monkeypatch):
    args = [a.to(dtype) if a.is_floating_point() else a
            for a in _backward_inputs(spec, S, G, D, seed=S + G, device=cuda, local=True)]
    if blocks is not None:
        key = (torch.cuda.current_device(), dtype, S, D, spec.num_basis)
        monkeypatch.setitem(backward._GRIDS, key, blocks)
    reset_launch_counts()
    out = _k1(args, spec)
    assert launch_counts()["backward_update"] == 1
    if blocks is not None:
        assert backward.backward_partials(args[2], D, spec.num_basis).shape[0] == blocks
    _assert_backward_agrees(args, spec, out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_backward_update_back_to_back(cuda, dtype):
    """Launches queued back to back on one stream, with no wait between them
    (each launch sets up its ring's barriers anew): each agrees with its
    plain version, and a repeat of the first with the first, bit for bit."""
    def inputs(S, G, D, seed):
        return [a.to(dtype) if a.is_floating_point() else a
                for a in _backward_inputs(SPEC_3F, S, G, D, seed=seed, device=cuda, local=True)]

    first, second = inputs(20_000, 100, 3, 1), inputs(3001, 45, 5, 2)
    outs = [_k1(first, SPEC_3F), _k1(second, SPEC_3F), _k1(first, SPEC_3F)]
    torch.cuda.synchronize()
    _assert_backward_agrees(first, SPEC_3F, outs[0])
    _assert_backward_agrees(second, SPEC_3F, outs[1])
    for a, b in zip(outs[0], outs[2]):
        assert torch.equal(a, b)


def _forward_inputs(spec, S, n, G, P, seed, device):
    g = torch.Generator().manual_seed(seed)
    F = len(spec.factor_powers[0])
    B = spec.num_basis
    pil_inv = torch.linspace(0.0, 7000.0, P)
    pillars = torch.stack([pil_inv, -150.0 - 0.02 * pil_inv, 250.0 - 0.015 * pil_inv], 1)
    scal = torch.zeros(n, forward.NUM_FIXED_SCALARS + F)
    scal[:, forward.SC_LO] = 0.0
    scal[:, forward.SC_HI] = torch.linspace(2000.0, 7000.0, n)
    scal[:, forward.SC_IC], scal[:, forward.SC_WC] = 0.01, 0.025
    scal[:, forward.SC_CI], scal[:, forward.SC_CW] = 0.01, 0.005
    scal[:, forward.SC_LOSS] = 1e-4
    scal[:, forward.SC_DFS] = scal[:, forward.SC_DFC] = 0.99
    scal[:, forward.SC_DRIFT] = 2.7
    scal[:, forward.SC_DRIFT + 1:] = torch.rand(n, F, generator=g) * 0.3
    tables = torch.randn(n, B + 1, G, generator=g) * 30.0
    tables[:, B, :] += torch.linspace(0.0, 20_000.0, G)
    t = [torch.randn(n, F, S, generator=g) * 0.5, torch.full((S,), 1500.0), tables,
         torch.randn(n, B, generator=g) * 0.3, torch.rand(n, B, generator=g) + 0.5,
         pillars.expand(n, P, 3).contiguous(), scal]
    return [x.to(device).contiguous() for x in t]


@pytest.mark.parametrize("P,interp_kind", [(4, 0), (4, 1), (1, 0)],
                         ids=["linear", "step", "constant"])
def test_forward_sim_matches_plain(cuda, P, interp_kind):
    S, n, G = 3001, 30, 23
    args = _forward_inputs(SPEC_3F, S, n, G, P, seed=P + interp_kind, device=cuda)
    kw = dict(spec=SPEC_3F, interp_kind=interp_kind, num_grid=G)
    reset_launch_counts()
    s_k, x_k, inv_k, pv_k = forward.forward_sim(*args, **kw)
    assert launch_counts()["forward_sim"] == 1
    s_r, x_r, inv_r, pv_r = forward.forward_sim_reference(*args, **kw)
    torch.cuda.synchronize()
    assert ((x_k - x_r).abs().max() / x_r.abs().max()).item() <= 1e-4
    flipped = (pv_k - pv_r).abs() > 1e-4 * pv_r.abs().clamp_min(1e-6 * pv_r.abs().max().item())
    assert flipped.float().mean().item() / n <= 1e-4
    ok = ~flipped
    assert torch.allclose(inv_k[ok], inv_r[ok], rtol=1e-4, atol=1e-3)
    assert ((s_k - s_r).abs().max() / s_r.abs().max()).item() <= 1e-3


def _poly_pillars(n):
    """POLY pillar tables [n, 4, 5]: odd steps fit 4 pillars (a cubic), even
    steps 3 (a quadratic, zero-padded to the cubic's height)."""
    tables = []
    for k in range(n):
        inv = np.array([0.0, 2000.0, 5000.0, 7000.0][: 4 - (k + 1) % 2])
        mn, mx = -150.0 - 0.02 * inv - 1e-6 * inv**2, 250.0 - 0.015 * inv + 1e-7 * inv**2
        deg = len(inv) - 1
        tables.append(np.column_stack([inv, mn, mx, np.polyfit(inv, mn, deg),
                                       np.polyfit(inv, mx, deg)]))
    return torch.tensor(pad_pillars(tables), dtype=torch.float32)


@pytest.mark.parametrize("S,extra,interp_kind", [(3001, 0, 0), (1000, 2, 0), (2048, 1, INTERP_POLY)],
                         ids=["panels-ragged", "D7", "poly-padded"])
def test_forward_sim_options_match_plain(cuda, S, extra, interp_kind):
    n, G = 30, 23
    args = _forward_inputs(SPEC_3F, S, n, G, 4, seed=S + extra, device=cuda)
    if interp_kind == INTERP_POLY:
        args[5] = _poly_pillars(n).to(cuda)
    kw = dict(spec=SPEC_3F, interp_kind=interp_kind, num_grid=G, extra_decisions=extra)
    panels_k = torch.full((n, 6, S), float("nan"), device=cuda)
    panels_r = torch.empty_like(panels_k)
    reset_launch_counts()
    s_k, x_k, inv_k, pv_k = forward.forward_sim(*args, **kw, panels=panels_k)
    assert launch_counts()["forward_sim"] == 1
    s_r, x_r, inv_r, pv_r = forward.forward_sim_reference(*args, **kw, panels=panels_r)
    torch.cuda.synchronize()
    assert torch.isfinite(panels_k).all()
    flipped = (pv_k - pv_r).abs() > 1e-4 * pv_r.abs().clamp_min(1e-6 * pv_r.abs().max().item())
    vol_k, vol_r = panels_k[:, 1], panels_r[:, 1]
    flipped |= ((vol_k - vol_r).abs() > 1e-5 * vol_r.abs().max()).any(dim=0)
    assert flipped.float().mean().item() / n <= 1e-4
    ok = ~flipped
    for f in range(6):
        a, b = panels_k[:, f, ok], panels_r[:, f, ok]
        assert ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item() <= 1e-5, f
    assert ((inv_k[ok] - inv_r[ok]).abs().max() / inv_r.abs().max()).item() <= 1e-5
    assert ((x_k - x_r).abs().max() / x_r.abs().max()).item() <= 1e-4
    assert ((s_k - s_r).abs().max() / s_r.abs().max()).item() <= 1e-3


@pytest.mark.parametrize("S,n", [(3001, 30), (515, 1), (128, 7), (257, 3), (811_011, 5)],
                         ids=["ragged", "one-step", "half-tile", "tile-plus-one",
                              "tiles-per-block"])
def test_forward_sim_tiles_match_plain(cuda, S, n):
    """Sim counts that are no multiple of the kernel's tile (128 threads x 2
    sims per thread), a span of one step, fewer sims than one tile (every
    thread's second sim is a shadow), one sim past a tile, and more tiles than
    the persistent grid has blocks (a block carries its partials, staged
    records and sims' state from one tile to the next)."""
    G = 23
    args = _forward_inputs(SPEC_3F, S, n, G, 4, seed=S + n, device=cuda)
    kw = dict(spec=SPEC_3F, interp_kind=0, num_grid=G)
    if S > 100_000:
        blocks = forward.grid_blocks(kernels(), cuda, SPEC_3F, S, G,
                                     SPEC_3F.num_basis, 3, 4, 3, 3)
        assert -(-S // forward.TILE_SIMS) // blocks >= 2
    panels_k = torch.full((n, 6, S), float("nan"), device=cuda)
    panels_r = torch.empty_like(panels_k)
    s_k, x_k, inv_k, pv_k = forward.forward_sim(*args, **kw, panels=panels_k)
    s_r, x_r, inv_r, pv_r = forward.forward_sim_reference(*args, **kw, panels=panels_r)
    torch.cuda.synchronize()
    assert torch.isfinite(panels_k).all()
    flipped = ((panels_k[:, 1] - panels_r[:, 1]).abs() > 1e-5 * panels_r[:, 1].abs().max()
               ).any(dim=0)
    assert flipped.float().mean().item() / n <= 1e-4
    ok = ~flipped
    for f in range(6):
        a, b = panels_k[:, f, ok], panels_r[:, f, ok]
        assert ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item() <= 1e-5, f
    assert ((inv_k[ok] - inv_r[ok]).abs().max() / inv_r.abs().max()).item() <= 1e-5
    assert ((pv_k[ok] - pv_r[ok]).abs().max() / pv_r.abs().max()).item() <= 1e-5
    assert ((x_k - x_r).abs().max() / x_r.abs().max()).item() <= 1e-4
    assert ((s_k - s_r).abs().max() / s_r.abs().max()).item() <= 1e-3


@pytest.mark.parametrize("spec", [SPEC_SMALL, SPEC_13, SPEC_16, SPEC_CUBIC],
                         ids=["B3", "B13", "B16", "cubic"])
def test_forward_sim_basis_widths_match_plain(cuda, spec):
    """Table rows of one, four and five float4s (three on the main path), and
    a basis with third and fourth powers."""
    S, n, G = 2049, 12, 31
    args = _forward_inputs(spec, S, n, G, 4, seed=spec.num_basis, device=cuda)
    kw = dict(spec=spec, interp_kind=0, num_grid=G)
    s_k, x_k, inv_k, pv_k = forward.forward_sim(*args, **kw)
    s_r, x_r, inv_r, pv_r = forward.forward_sim_reference(*args, **kw)
    torch.cuda.synchronize()
    flipped = (pv_k - pv_r).abs() > 1e-4 * pv_r.abs().clamp_min(1e-6 * pv_r.abs().max().item())
    assert flipped.float().mean().item() / n <= 1e-4
    assert ((x_k - x_r).abs().max() / x_r.abs().max()).item() <= 1e-4
    assert ((s_k - s_r).abs().max() / s_r.abs().max()).item() <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("panels", [False, True], ids=["sums", "panels"])
def test_forward_sim_is_deterministic(cuda, panels, dtype):
    """Two launches on the same inputs give bit-identical outputs (several
    tiles per block of the persistent grid, so partials accumulate in place),
    in either instantiation."""
    S, n, G = 600_011, 9, 23
    args = [a.to(dtype) for a in _forward_inputs(SPEC_3F, S, n, G, 4, seed=11, device=cuda)]
    kw = dict(spec=SPEC_3F, interp_kind=0, num_grid=G)
    outs = []
    for _ in range(2):
        p = torch.empty((n, 6, S), device=cuda, dtype=dtype) if panels else None
        outs.append(forward.forward_sim(*args, **kw, panels=p) + ((p,) if panels else ()))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    # against the plain version: the sums of a multi-tile, multi-block launch
    s_r, x_r, _, _ = forward.forward_sim_reference(*args, **kw)
    assert ((outs[0][0] - s_r).abs().max() / s_r.abs().max()).item() <= 1e-3
    assert ((outs[0][1] - x_r).abs().max() / x_r.abs().max()).item() <= 1e-4


def _sim_coefficients(num_factors, n):
    rng = np.random.default_rng(100 * num_factors + n)
    corrs = np.array([[1.0, 0.6, 0.3, 0.1], [0.6, 1.0, 0.4, 0.2], [0.3, 0.4, 1.0, 0.3],
                      [0.1, 0.2, 0.3, 1.0]])[:num_factors, :num_factors]
    times = np.cumsum(rng.uniform(0.5, 3.0, n)) / 365.0
    return simulation.sim_coefficients(
        np.array([0.0, 2.5, 16.2, 40.0])[:num_factors], rng.uniform(0.1, 0.9, (n, num_factors)),
        corrs, times, rng.uniform(10.0, 20.0, n))


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "antithetic"])
@pytest.mark.parametrize("n", [5, 16, 37])
@pytest.mark.parametrize("num_factors", [1, 2, 3, 4])
def test_path_sim_equals_plain(cuda, num_factors, n, antithetic):
    """The path kernel against its plain version, bit for bit: horizons
    shorter than, equal to and past whole 16-step draw blocks, an odd sim
    count (a ragged thread block, an unpaired antithetic sim)."""
    num_sims = 10_001
    coeffs = _sim_coefficients(num_factors, n)
    key = simulation.fold_in(simulation.prng_key(12), 1)
    reset_launch_counts()
    got = simulation.simulate_factor_paths(coeffs, num_sims, antithetic=antithetic, key=key,
                                           device=cuda)
    assert launch_counts()["path_sim"] == 1
    ref = simulation.simulate_factor_paths_reference(coeffs, num_sims, key, antithetic, cuda)
    again = simulation.simulate_factor_paths(coeffs, num_sims, antithetic=antithetic, key=key,
                                             device=cuda)
    torch.cuda.synchronize()
    assert got.shape == (n, num_factors, num_sims)
    assert torch.equal(got, ref)
    assert torch.equal(got, again)


def _bits_equal(a, b):
    return a.shape == b.shape and bool((a.view(torch.int32) == b.view(torch.int32)).all())


@pytest.mark.parametrize("num_factors,n,num_sims,antithetic,every", [
    (1, 70, 10_001, False, 16), (2, 70, 10_001, True, 32), (3, 103, 4_097, True, 32),
    (4, 70, 10_001, True, 16), (3, 100, 10_000, False, 64), (3, 520, 1_001, True, 256),
    (2, 33, 257, True, 16), (3, 300, 2_049, False, 512),
], ids=["F1", "F2-antithetic", "F3-antithetic-odd", "F4-antithetic", "F3-short-tail",
        "every256", "tail-of-1", "one-span"])
def test_path_sim_spans_equal_one_launch(cuda, num_factors, n, num_sims, antithetic, every):
    """The path kernel's new modes, bit for bit: spans resumed from
    checkpointed entering states (a first step past 0, a tail span shorter
    than a draw block, odd sim counts with an unpaired antithetic sim)
    equal the one-launch paths; the checkpoint pass equals the plain
    checkpoint function; each is one launch."""
    coeffs = _sim_coefficients(num_factors, n)
    key = simulation.fold_in(simulation.prng_key(12), 1)
    mono = simulation.simulate_factor_paths(coeffs, num_sims, antithetic=antithetic, key=key,
                                            device=cuda)
    src = simulation.StreamingFactorSource(coeffs, num_sims, key, antithetic, every=every,
                                           device=cuda)
    reset_launch_counts()
    src.prepare()
    assert launch_counts()["path_sim"] == 1
    ckpts = simulation.factor_checkpoints_reference(coeffs, num_sims, key, antithetic,
                                                    src.every, cuda)
    assert _bits_equal(src._checkpoints(), ckpts)
    spans = src.spans()
    stream = torch.cat([src.factors(a, b).clone() for a, b in spans])
    assert launch_counts()["path_sim"] == 1 + len(spans)
    assert _bits_equal(stream, mono)
    assert _bits_equal(src.last(), mono[-1])
    assert launch_counts()["path_sim"] == 1 + len(spans)  # the final span is cached
    # The plain version resumed from the same checkpoint gives the same span.
    a, b = spans[-1]
    plain = simulation.simulate_factor_paths_reference(
        coeffs, num_sims, key, antithetic, cuda, y0=ckpts[-1], step0=a, num_steps=b - a)
    torch.cuda.synchronize()
    assert _bits_equal(plain, mono[a:b])


def test_path_sim_refuses_unaligned_first_step(cuda):
    coeffs = _sim_coefficients(2, 40)
    tables = simulation._path_kernel_tables(coeffs, simulation.prng_key(1), cuda)
    out = torch.empty((8, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="multiples of 16"):
        simulation._launch_path_sim(tables, out, 64, False, step0=8, num_steps=8)
    # The launcher itself refuses it too (and an `every` off the draw blocks).
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for step0, every in ((8, 0), (0, 24)):
        assert kernels().path_sim_launch(tables.keys.data_ptr(), tables.coef.data_ptr(), None,
                                         out.data_ptr(), 64, 64, step0, 8, 2, every, stream) != 0


def test_path_sim_refuses_five_factors(cuda):
    n, F = 4, 5
    coeffs = simulation.SimCoefficients(np.ones((n, F)), np.zeros((n, F, F)), np.ones((n, F)),
                                        np.zeros(n))
    with pytest.raises(KernelLaunchError):
        simulation.simulate_factor_paths(coeffs, 64, seed=1, device=cuda)


def test_launch_refused_raises(cuda):
    """A basis wider than the kernel supports is refused by the launcher."""
    B = 17
    spec = BasisSpec((0,) * B, ((0, 0, 0),) * B)
    args = list(_backward_inputs(SPEC_SMALL, 256, 8, 3, seed=1, device=cuda))
    args[3] = torch.zeros(3, 8, B + 2, device=cuda)
    args[5] = torch.ones(2, B, device=cuda)
    with pytest.raises(KernelLaunchError):
        backward.backward_update(*args, spec=spec)


# --------------------------------------------------------------------------- #
# The float64 instantiations of the three kernels (one source each, templated #
# on the element type) against their plain versions in float64.               #
# --------------------------------------------------------------------------- #


def _f64(args):
    return [a.double() if a.is_floating_point() else a for a in args]


@pytest.mark.parametrize("spec,S,G,D,local", [
    (SPEC_3F, 1000, 17, 3, False), (SPEC_SMALL, 4097, 40, 5, False),
    (SPEC_3F, 2048, 700, 5, True), (SPEC_3F, 300_004, 100, 3, True), (SPEC_16, 3000, 60, 3, True),
    (SPEC_3F, 65_537, 700, 5, True), (SPEC_13, 2000, 50, 5, True),
    (SPEC_3F, 1500, 450, 7, True), (SPEC_3F, 100, 37, 3, True), (SPEC_3F, 20_000, 100, 3, True),
    (SPEC_SMALL, 4097, 45, 3, True), (SPEC_3F, 3000, 70, 3, False),
    (SPEC_3F, 1000, 37, 35, True), (SPEC_3F, 1000, 37, 37, True), (SPEC_16, 1000, 37, 25, True),
], ids=["B10-tail", "B3-D5", "G700-D5", "multi-pass", "B16", "G700-D5-ragged", "B13-D5",
        "G450-D7", "below-tile", "below-grid-pass", "odd-S", "wide-span", "B10-D35",
        "B10-D37-one-slot", "B16-D25-one-slot"])
def test_backward_update_f64_matches_plain(cuda, spec, S, G, D, local):
    """K1's float64 instantiation: V entries within 1e-12 of max|V| but for
    near-tie flips of the fitted totals (an FMA chain against torch's matrix
    product), at most 1e-6 of them; partials within 1e-12. Shapes as the
    float32 kernel's: G = 700 at D = 5 (its shared memory does not grow with
    G) at a sim count that is no multiple of the 128-sim tile, fitted rows of
    three, four and five quads, and the widest decision counts: the
    one-phase kernel's limits (D = 35 / 25 at B = 10 / 16) and past them,
    where a block of one decision warpgroup holds one ring slot (D = 37 at
    B = 10, and D = 25 at B = 16)."""
    args = _f64(_backward_inputs(spec, S, G, D, seed=S + G, device=cuda, local=local))
    reset_launch_counts()
    v_k, graw_k, praw_k = _k1(args, spec)
    assert launch_counts()["backward_update"] == 1
    assert v_k.dtype == graw_k.dtype == praw_k.dtype == torch.float64
    v_r, graw_r, praw_r = backward.backward_update_reference(*args, spec=spec)
    torch.cuda.synchronize()
    flipped = (v_k - v_r).abs() > 1e-12 * v_r.abs().max()
    assert flipped.double().mean().item() <= 1e-6
    for a, b in ((graw_k, graw_r), (praw_k, praw_r)):
        assert ((a - b).abs().max() / b.abs().max()).item() <= 1e-12
    again = _k1(args, spec)
    for a, b in zip((v_k, graw_k, praw_k), again):
        assert torch.equal(a, b)


_F64_FORWARD_CASES = [
    (SPEC_3F, 3001, 30, 4, 0, 0, True, 23), (SPEC_3F, 3001, 30, 4, 1, 0, False, 23),
    (SPEC_3F, 3001, 30, 1, 0, 0, False, 23), (SPEC_3F, 1000, 30, 4, 0, 2, True, 23),
    (SPEC_3F, 2048, 30, 4, INTERP_POLY, 1, True, 23), (SPEC_3F, 515, 1, 4, 0, 0, True, 23),
    (SPEC_3F, 811_011, 5, 4, 0, 0, True, 23), (SPEC_16, 2049, 12, 4, 0, 0, False, 23),
    (SPEC_CUBIC, 2049, 12, 4, 0, 0, False, 23), (SPEC_3F, 65_537, 7, 4, 0, 1, True, 700),
    (SPEC_13, 2049, 12, 4, 0, 0, False, 23), (SPEC_SMALL, 300, 9, 4, 0, 0, True, 23),
]


@pytest.mark.parametrize("spec,S,n,P,interp_kind,extra,panels,G", _F64_FORWARD_CASES,
                         ids=["linear-panels", "step", "constant", "D7-panels", "poly-padded",
                              "one-step", "tiles-per-block", "B16", "cubic", "G700-D5-ragged",
                              "B13", "B3-below-tile"])
def test_forward_sim_f64_matches_plain(cuda, spec, S, n, P, interp_kind, extra, panels, G):
    """K2's float64 instantiation rounds every step as the plain version's
    torch ops do: the same decisions, so every per-sim value and panel entry
    equals the plain version's (to 1e-12 of its field's max) and the sums
    agree to 1e-12 (their order differs). Also at G = 700, D = 5 and a sim
    count that is no multiple of the tile, and with table rows of one, four
    and five quads."""
    args = _f64(_forward_inputs(spec, S, n, G, P, seed=S + n + extra, device=cuda))
    if interp_kind == INTERP_POLY:
        args[5] = _poly_pillars(n).double().to(cuda)
    kw = dict(spec=spec, interp_kind=interp_kind, num_grid=G, extra_decisions=extra)
    p_k = torch.full((n, 6, S), float("nan"), dtype=torch.float64, device=cuda) if panels else None
    p_r = torch.empty_like(p_k) if panels else None
    reset_launch_counts()
    s_k, x_k, inv_k, pv_k = forward.forward_sim(*args, **kw, panels=p_k)
    assert launch_counts()["forward_sim"] == 1
    s_r, x_r, inv_r, pv_r = forward.forward_sim_reference(*args, **kw, panels=p_r)
    torch.cuda.synchronize()
    assert pv_k.dtype == s_k.dtype == torch.float64
    pairs = [(inv_k, inv_r), (pv_k, pv_r), (s_k, s_r), (x_k, x_r)]
    if panels:
        assert torch.isfinite(p_k).all()
        pairs += [(p_k[:, f], p_r[:, f]) for f in range(6)]
    for a, b in pairs:
        assert ((a - b).abs().max() / b.abs().max().clamp_min(1e-300)).item() <= 1e-12


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "antithetic"])
@pytest.mark.parametrize("n,num_sims", [(5, 10_001), (37, 10_001), (37, 100_001)],
                         ids=["5", "37", "37-class-C"])
@pytest.mark.parametrize("num_factors", [1, 2, 3, 4])
def test_path_sim_f64_equals_plain(cuda, num_factors, n, num_sims, antithetic):
    """The path kernel's float64 mode against its plain version, bit for bit
    (the same hash, both words of it per draw, XLA's float64 erf_inv and
    log1p with their polynomial steps and the OU update fused as XLA fuses
    them, the card's DFMA against the plain version's emulated FMA). The
    kernel sorts each warp's draws by the normal map's branch: sim counts
    that are no multiple of 32 (a ragged last warp), and 100,001 x 37 x F
    draws, enough to fill the rare outer ranges (w >= 6.25, 0.1% of draws)."""
    coeffs = _sim_coefficients(num_factors, n)
    key = simulation.fold_in(simulation.prng_key(12), 1)
    reset_launch_counts()
    got = simulation.simulate_factor_paths(coeffs, num_sims, antithetic=antithetic, key=key,
                                           device=cuda, dtype=torch.float64)
    assert launch_counts()["path_sim"] == 1
    ref = simulation.simulate_factor_paths_reference(coeffs, num_sims, key, antithetic, cuda,
                                                     dtype=torch.float64)
    torch.cuda.synchronize()
    assert got.dtype == torch.float64 and got.shape == (n, num_factors, num_sims)
    assert torch.equal(got.view(torch.int64), ref.view(torch.int64))


@pytest.mark.parametrize("num_factors,n,num_sims,antithetic,every", [
    (3, 103, 4_097, True, 32), (2, 33, 257, True, 16), (3, 300, 2_049, False, 512),
    (3, 37, 100_001, True, 16), (3, 37, 100_001, False, 16), (1, 70, 100_003, True, 32),
], ids=["F3-antithetic-odd", "tail-of-1", "one-span", "class-C-antithetic", "class-C",
        "F1-class-C"])
def test_path_sim_f64_spans_equal_one_launch(cuda, num_factors, n, num_sims, antithetic, every):
    """Spans from checkpoints equal the one-launch paths, and the checkpoint
    pass its plain version, bit for bit; with 100,001 sims and more the
    outer ranges of erf_inv are drawn in every mode."""
    coeffs = _sim_coefficients(num_factors, n)
    key = simulation.fold_in(simulation.prng_key(12), 1)
    mono = simulation.simulate_factor_paths(coeffs, num_sims, antithetic=antithetic, key=key,
                                            device=cuda, dtype=torch.float64)
    src = simulation.StreamingFactorSource(coeffs, num_sims, key, antithetic, every=every,
                                           device=cuda, dtype=torch.float64).prepare()
    ckpts = simulation.factor_checkpoints_reference(coeffs, num_sims, key, antithetic,
                                                    src.every, cuda, torch.float64)
    assert torch.equal(src._checkpoints().view(torch.int64), ckpts.view(torch.int64))
    stream = torch.cat([src.factors(a, b).clone() for a, b in src.spans()])
    torch.cuda.synchronize()
    assert torch.equal(stream.view(torch.int64), mono.view(torch.int64))


def test_kernels_refuse_float16_on_the_card(cuda):
    args = [a.half() if a.is_floating_point() else a
            for a in _backward_inputs(SPEC_SMALL, 256, 8, 3, seed=1, device=cuda)]
    with pytest.raises(ValueError, match="torch.float16"):
        backward.backward_update(*args, spec=SPEC_SMALL)
    out = torch.empty((5, 2, 64), dtype=torch.float16, device=cuda)
    tables = simulation._path_kernel_tables(_sim_coefficients(2, 5), simulation.prng_key(1), cuda)
    with pytest.raises(ValueError, match="torch.float16"):
        simulation._launch_path_sim(tables, out, 64, False)


# --------------------------------------------------------------------------- #
# The paths mesh: K3's window mode and a valuation in shards on the card      #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("num_factors,n,num_sims,antithetic,window", [
    (3, 70, 10_001, False, (0, 5_000)), (3, 70, 10_001, False, (5_000, 5_001)),
    (3, 70, 10_001, True, (3_333, 4_000)), (1, 37, 10_001, True, (5_001, 5_000)),
    (4, 37, 4_097, True, (2_000, 97)), (2, 33, 257, True, (128, 129)),
], ids=["first-half", "second-half", "across-partners", "partners-only", "F4-small",
        "tail-of-1"])
def test_path_sim_window_equals_whole_columns(cuda, num_factors, n, num_sims, antithetic,
                                              window, dtype):
    """K3's window mode, in its three modes, bit for bit: the window's paths
    equal the same columns of the one-launch whole set and the plain
    version's window; its checkpoint pass equals the plain checkpoints'
    window; its spans resumed from those equal the one-launch columns. An
    antithetic window may hold drawn sims, their partners or both."""
    coeffs = _sim_coefficients(num_factors, n)
    key = simulation.fold_in(simulation.prng_key(12), 1)
    bits = torch.int64 if dtype == torch.float64 else torch.int32
    a, w = window
    tables = simulation._path_kernel_tables(coeffs, key, cuda, dtype)
    whole = simulation._simulate_factor_paths_cuda(coeffs, num_sims, key, antithetic, cuda,
                                                   dtype, tables=tables)
    reset_launch_counts()
    got = simulation._simulate_factor_paths_cuda(coeffs, num_sims, key, antithetic, cuda, dtype,
                                                 window=window, tables=tables)
    assert launch_counts()["path_sim"] == 1 and got.shape == (n, num_factors, w)
    cols = whole[..., a:a + w].contiguous()
    ref = simulation.simulate_factor_paths_reference(coeffs, num_sims, key, antithetic, cuda,
                                                     dtype=dtype, window=window)
    every = 16
    ckpts = torch.empty((-(-n // every), num_factors, w), dtype=dtype, device=cuda)
    simulation._launch_path_sim(tables, ckpts, num_sims, antithetic, every=every, window=window)
    plain_ckpts = simulation.factor_checkpoints_reference(coeffs, num_sims, key, antithetic,
                                                          every, cuda, dtype, window)
    spans = []
    for i in range(ckpts.shape[0]):
        s0, s1 = i * every, min((i + 1) * every, n)
        out = torch.empty((s1 - s0, num_factors, w), dtype=dtype, device=cuda)
        spans.append(simulation._launch_path_sim(tables, out, num_sims, antithetic, y0=ckpts[i],
                                                 step0=s0, num_steps=s1 - s0, window=window))
    torch.cuda.synchronize()
    assert torch.equal(got.view(bits), cols.view(bits))
    assert torch.equal(got.view(bits), ref.view(bits))
    assert torch.equal(ckpts.view(bits), plain_ckpts.view(bits))
    assert torch.equal(torch.cat(spans).view(bits), cols.view(bits))


def test_path_sim_window_refuses_outside_the_set(cuda):
    coeffs = _sim_coefficients(2, 5)
    tables = simulation._path_kernel_tables(coeffs, simulation.prng_key(1), cuda)
    out = torch.empty((5, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="outside"):
        simulation._launch_path_sim(tables, out, 48, False, window=(20, 32))
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert kernels().path_sim_window_launch(tables.keys.data_ptr(), tables.coef.data_ptr(), None,
                                            out.data_ptr(), 48, 48, 20, 32, 0, 5, 2, 0,
                                            stream) != 0


@pytest.mark.parametrize("streamed", [False, True], ids=["materialised", "streamed"])
def test_mesh_valuation_on_the_card(cuda, streamed, monkeypatch):
    """The float64 slice over two shards on one card against one device:
    NPV within 1e-10 relative, deltas within 1e-8 of max|delta|; every kernel
    launched once per shard where the one-device run launched it once, no
    plain version called."""
    import pandas as pd

    import storage_tpu_torch as tt
    from storage_tpu_torch.parallel.mesh import paths_mesh

    plain_calls = []
    for mod, name in ((backward, "backward_update_reference"),
                      (forward, "forward_sim_reference"),
                      (simulation, "simulate_factor_paths_reference"),
                      (simulation, "factor_checkpoints_reference")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _real=real, _name=name, **k: (
            plain_calls.append(_name), _real(*a, **k))[1])
    if streamed:
        monkeypatch.setenv("STORAGE_TPU_MAX_PATH_BYTES", "1e6")
    storage = tt.CmdtyStorage(
        "D", "2021-01-01", "2021-04-01", injection_cost=0.1, withdrawal_cost=0.2,
        ratchets=[("2021-01-01",
                   [(0.0, -50.0, 70.0), (1000.0, -50.0, 70.0), (2500.0, -80.0, 40.0)])],
        ratchet_interp=tt.RatchetInterp.LINEAR)
    idx = pd.period_range("2021-01-01", "2021-04-01", freq="D")
    fwd = pd.Series(18.0 + 4.0 * np.cos(np.arange(len(idx)) / 10.0), index=idx)

    def run(mesh):
        reset_launch_counts()
        res = tt.three_factor_seasonal_value(
            storage, "2021-01-01", 500.0, fwd, 0.03, None, spot_mean_reversion=12.0,
            spot_vol=0.8, long_term_vol=0.2, seasonal_vol=0.4, num_sims=8192,
            basis_funcs="1 + s + x_st + x_lt + x_sw + s**2", discount_deltas=False, seed=7,
            mesh=mesh, return_sim_panels=not streamed, dtype=torch.float64, device=cuda)
        return res, launch_counts()

    one, one_counts = run(None)
    two, two_counts = run(paths_mesh([cuda, cuda]))
    assert two_counts == {k: 2 * v for k, v in one_counts.items()} and not plain_calls
    assert two.npv == pytest.approx(one.npv, rel=1e-10)
    scale = float(one.deltas.abs().max())
    assert float((two.deltas - one.deltas).abs().max()) <= 1e-8 * scale
