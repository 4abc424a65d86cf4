"""The LSMC forward pass over the whole horizon (CUDA kernel) and its plain
PyTorch version.

Counterpart of the JAX package's ``ops/pallas_forward.py``.  The kernel
(``csrc/forward_sim.cu``) replaces ``_forward_kernel`` there and computes
the XLA math of ``_forward_step_core`` (``engines/lsmc.py``) with the
regression continuation, in float32 with exact two-point interpolation.
Outputs are the per-step sums the engine needs for means, deltas and
trigger prices, plus each sim's final inventory and PV — never a per-sim
panel.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import count_launch
from .decisions import clipped_decision_bounds
from .interp import fractional_index
from .ratchets import interp_rates
from .regression import BasisSpec, design_columns, spot_from_factors

FORWARD_BLOCK_SIMS = 256  # threads (= sims) per block of the CUDA kernel
NUM_SUMS = 7  # inventory, volume, consumed, loss, net volume, immediate PV, net x spot

# Packed per-step scalar layout (column indices into scalars[n, :]); the CUDA
# kernel's ``Scalar`` enum is the same.
SC_LO, SC_HI, SC_LOSS, SC_IC, SC_WC, SC_CI, SC_CW, SC_ICR, SC_DFS, SC_DFC, SC_DRIFT = range(11)
NUM_FIXED_SCALARS = 11


def pack_scalars(space_lo, space_hi, loss, inject_cost, withdraw_cost, cons_inject,
                 cons_withdraw, inv_cost_rate, df_settle, df_cost, sim_drift,
                 sim_vols) -> torch.Tensor:
    """Pack per-step scalars into the kernel's ``[n, 11 + F]`` layout."""
    cols = [space_lo, space_hi, loss, inject_cost, withdraw_cost, cons_inject,
            cons_withdraw, inv_cost_rate, df_settle, df_cost, sim_drift]
    return torch.cat([torch.stack(cols, dim=1), sim_vols], dim=1).float().contiguous()


def forward_sim_reference(
    factors: torch.Tensor,  # [n, F, S]
    inv0: torch.Tensor,  # [S] starting inventory
    tables: torch.Tensor,  # [n, B+1, G] coefficient tables incl. the vbar row
    mus: torch.Tensor,  # [n, B]
    sds: torch.Tensor,  # [n, B]
    pillars: torch.Tensor,  # [n, P, 3]
    scalars: torch.Tensor,  # [n, 11 + F]
    spec: BasisSpec,
    interp_kind: int,
    num_grid: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: a loop over steps, vectorised over
    sims.  Returns ``(sums [n, 7], xsums [n, B+1], inv_final [S], pv_final [S])``."""
    n, num_factors, S = factors.shape
    B = spec.num_basis
    inv = inv0.clone()
    pv = torch.zeros_like(inv)
    sums, xsums = [], []
    for k in range(n):
        sc = scalars[k]
        f = factors[k]
        spot = spot_from_factors(f, sc[SC_DRIFT + 1:], sc[SC_DRIFT])
        cols = design_columns(spec, spot, f)
        xn1 = torch.stack([(cols[b] - mus[k, b]) / sds[k, b] for b in range(B)]
                          + [torch.ones_like(spot)])  # [B+1, S]
        min_rate, max_rate = interp_rates(pillars[k], inv, interp_kind)
        lo, hi = sc[SC_LO], sc[SC_HI]
        loss_amt = sc[SC_LOSS] * inv
        yw, yi = clipped_decision_bounds(min_rate, max_rate, inv, loss_amt, lo, hi)
        has_zero = (yw < 0.0) & (yi > 0.0)
        decisions = (yw, torch.where(has_zero, torch.zeros_like(yi), yi), yi)
        tbl = tables[k].T  # [G, B+1]
        best = None
        for d in decisions:
            j, w = fractional_index((inv + d) - loss_amt, lo, hi, num_grid)
            eff = tbl[j] * (1.0 - w)[:, None] + tbl[j + 1] * w[:, None]  # [S, B+1]
            cont = (xn1.T * eff).sum(dim=1)
            inject = d > 0.0
            abs_d = d.abs()
            consumed = torch.where(inject, sc[SC_CI] * abs_d, sc[SC_CW] * abs_d)
            iw_cost = torch.where(inject, sc[SC_IC] * abs_d, sc[SC_WC] * abs_d)
            cost = (iw_cost + sc[SC_ICR] * inv) * sc[SC_DFC]
            imm = -(d + consumed) * sc[SC_DFS] * spot + (-cost)
            total = imm + cont
            if best is None:
                best = [total, d, consumed, imm]
            else:  # first-occurrence argmax
                better = total > best[0]
                best = [torch.where(better, a, b) for a, b in zip((total, d, consumed, imm), best)]
        _, vol, consumed, imm = best
        net = -vol - consumed
        sums.append(torch.stack([x.sum() for x in (inv, vol, consumed, loss_amt, net, imm,
                                                   net * spot)]))
        xsums.append(xn1.sum(dim=1))
        inv = inv + vol - loss_amt
        pv = pv + imm
    return torch.stack(sums), torch.stack(xsums), inv, pv


def _forward_sim_cuda(factors, inv0, tables, mus, sds, pillars, scalars, spec: BasisSpec,
                      interp_kind: int, num_grid: int):
    """Launch ``forward_sim_kernel`` (CUDA tensors only)."""
    from .csrc import basis_arrays, check_launch, check_operand, kernels

    n, F, S = factors.shape
    B = spec.num_basis
    G = num_grid
    P = pillars.shape[1]
    for name, t, shape in (
        ("factors", factors, (n, F, S)), ("inv0", inv0, (S,)), ("tables", tables, (n, B + 1, G)),
        ("mus", mus, (n, B)), ("sds", sds, (n, B)), ("pillars", pillars, (n, P, 3)),
        ("scalars", scalars, (n, NUM_FIXED_SCALARS + F)),
    ):
        check_operand(name, t, shape)
    lib = kernels()
    dev = factors.device
    tables_gb = tables.transpose(1, 2).contiguous()  # [n, G, B+1]: row j contiguous
    nblk = -(-S // FORWARD_BLOCK_SIMS)
    sums_part = torch.empty((nblk, n, NUM_SUMS), dtype=torch.float32, device=dev)
    xsums_part = torch.empty((nblk, n, B + 1), dtype=torch.float32, device=dev)
    inv_out = torch.empty((S,), dtype=torch.float32, device=dev)
    pv_out = torch.empty((S,), dtype=torch.float32, device=dev)
    spot_pow, fac_pow = basis_arrays(spec)
    err = lib.forward_sim_launch(
        factors.data_ptr(), inv0.data_ptr(), tables_gb.data_ptr(), mus.data_ptr(),
        sds.data_ptr(), pillars.data_ptr(), scalars.data_ptr(), sums_part.data_ptr(),
        xsums_part.data_ptr(), inv_out.data_ptr(), pv_out.data_ptr(),
        S, n, G, P, int(interp_kind), B, F, spot_pow, fac_pow, FORWARD_BLOCK_SIMS,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch("forward_sim", err)
    count_launch("forward_sim")
    return sums_part.sum(dim=0), xsums_part.sum(dim=0), inv_out, pv_out


def forward_sim(factors, inv0, tables, mus, sds, pillars, scalars, spec: BasisSpec,
                interp_kind: int, num_grid: int):
    """The forward pass: ``(sums [n, 7], xsums [n, B+1], inv_final [S], pv_final [S])``.

    CUDA tensors go to the kernel; CPU tensors to :func:`forward_sim_reference`.
    """
    if factors.device.type == "cpu":
        return forward_sim_reference(factors, inv0, tables, mus, sds, pillars, scalars, spec,
                                     interp_kind, num_grid)
    return _forward_sim_cuda(factors, inv0, tables, mus, sds, pillars, scalars, spec,
                             interp_kind, num_grid)
