"""The CUDA kernels against their plain PyTorch versions, on a CUDA device.

Marked ``cuda``: without a CUDA device every test here skips (a CUDA kernel
has no CPU mode).  Run them on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -q

Random inputs at odd sizes exercise what the main path's shapes do not:
ragged tail blocks, other basis and grid widths, STEP ratchets and
single-pillar (constant-rate) tables.  Rounding differs between a kernel and
its plain version (FMA contraction), so near-tie decisions may flip; flips
are counted and bounded like ``chip_smoke.py`` bounds them.
"""
import numpy as np
import pytest
import torch

from storage_tpu_torch import launch_counts, reset_launch_counts
from storage_tpu_torch.ops import backward, forward
from storage_tpu_torch.ops.csrc import KernelLaunchError
from storage_tpu_torch.ops.regression import BasisSpec

pytestmark = pytest.mark.cuda

SPEC_3F = BasisSpec((0, 0, 0, 0, 1, 0, 0, 0, 2, 1),
                    ((0, 0, 0), (1, 0, 0), (0, 0, 1), (0, 1, 0), (0, 0, 0), (2, 0, 0),
                     (0, 0, 2), (0, 2, 0), (0, 0, 0), (1, 0, 0)))
SPEC_SMALL = BasisSpec((0, 1, 0), ((0, 0, 0), (0, 0, 0), (1, 0, 0)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _backward_inputs(spec, S, G, D, seed, device):
    g = torch.Generator().manual_seed(seed)
    F = len(spec.factor_powers[0])
    B = spec.num_basis

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device)

    v_next = r(G, S, scale=50.0) + torch.linspace(0, 400, G, device=device)[:, None]
    musd = torch.stack([r(B, scale=0.3), torch.rand(B, generator=g).to(device) + 0.5])
    j = torch.randint(0, G - 1, (D, G), generator=g, dtype=torch.int32).to(device)
    w = torch.rand(D, G, generator=g).to(device)
    scal = torch.cat([torch.full((2, 1), 2.7), torch.rand(2, F, generator=g) * 0.3], 1).to(device)
    return (r(F, S, scale=0.5), r(F, S, scale=0.5), v_next, r(D, G, B + 2, scale=20.0),
            v_next.mean(dim=1), musd, j, w, scal)


@pytest.mark.parametrize("spec,S,G,D", [(SPEC_3F, 1000, 17, 3), (SPEC_SMALL, 4097, 40, 5)],
                         ids=["B10-tail", "B3-D5"])
def test_backward_update_matches_plain(cuda, spec, S, G, D):
    args = _backward_inputs(spec, S, G, D, seed=S, device=cuda)
    reset_launch_counts()
    v_k, graw_k, praw_k = backward.backward_update(*args, spec=spec)
    assert launch_counts()["backward_update"] == 1
    v_r, graw_r, praw_r = backward.backward_update_reference(*args, spec=spec)
    torch.cuda.synchronize()
    flipped = (v_k - v_r).abs() > 1e-5 * v_r.abs().max()
    assert flipped.float().mean().item() <= 1e-3
    for a, b in ((graw_k, graw_r), (praw_k, praw_r)):
        assert ((a - b).abs().max() / b.abs().max()).item() <= 1e-4


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


def test_launch_refused_raises(cuda):
    """A basis wider than the kernel supports is refused by the launcher."""
    B = 17
    spec = BasisSpec((0,) * B, ((0, 0, 0),) * B)
    args = list(_backward_inputs(SPEC_SMALL, 256, 8, 3, seed=1, device=cuda))
    args[3] = torch.zeros(3, 8, B + 2, device=cuda)
    args[5] = torch.ones(2, B, device=cuda)
    with pytest.raises(KernelLaunchError):
        backward.backward_update(*args, spec=spec)
