"""The LSMC forward pass over a span of steps (CUDA kernel) and its plain
PyTorch version.

Counterpart of the JAX package's ``ops/pallas_forward.py``.  The kernel
(``csrc/forward_sim.cu``, one source templated on the element type: a
float32 and a float64 instantiation) replaces ``_forward_kernel`` there and
computes the XLA math of ``_forward_step_core`` (``engines/lsmc.py``) with
the regression continuation, in the operands' dtype with exact two-point
interpolation, for any ``extra_decisions`` and ratchet interpolation
(LINEAR, STEP, POLY).
Outputs are the per-step sums the engine needs for means, deltas and
trigger prices, plus each sim's final inventory and PV; given a ``panels``
tensor ``[n, 6, S]`` it also writes the per-sim panel fields into it (the
engine passes a view into its ``[n+1, 6, S]`` result, so no copy is made).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.profiling import upload
from . import count_launch
from .decisions import bang_bang_decisions_fixed, decision_weights
from .interp import fractional_index
from .ratchets import interp_rates
from .regression import BasisSpec, design_columns, spot_from_factors

NUM_SUMS = 7  # inventory, volume, consumed, loss, net volume, immediate PV, net x spot

# Packed per-step scalar layout (column indices into scalars[n, :]); the CUDA
# kernel's ``Scalar`` enum is the same.
SC_LO, SC_HI, SC_LOSS, SC_IC, SC_WC, SC_CI, SC_CW, SC_ICR, SC_DFS, SC_DFC, SC_DRIFT = range(11)
NUM_FIXED_SCALARS = 11


def pack_scalars(space_lo, space_hi, loss, inject_cost, withdraw_cost, cons_inject,
                 cons_withdraw, inv_cost_rate, df_settle, df_cost, sim_drift,
                 sim_vols) -> torch.Tensor:
    """Pack per-step scalars into the kernel's ``[n, 11 + F]`` layout, in the
    dtype of ``space_lo`` (the run's)."""
    cols = [space_lo, space_hi, loss, inject_cost, withdraw_cost, cons_inject,
            cons_withdraw, inv_cost_rate, df_settle, df_cost, sim_drift]
    return torch.cat([torch.stack(cols, dim=1), sim_vols], dim=1).to(space_lo.dtype).contiguous()


def forward_sim_reference(
    factors: torch.Tensor,  # [n, F, S]
    inv0: torch.Tensor,  # [S] starting inventory
    tables: torch.Tensor,  # [n, B+1, G] coefficient tables incl. the vbar row
    mus: torch.Tensor,  # [n, B]
    sds: torch.Tensor,  # [n, B]
    pillars: torch.Tensor,  # [n, P, 3], or [n, P, 5] for POLY
    scalars: torch.Tensor,  # [n, 11 + F]
    spec: BasisSpec,
    interp_kind: int,
    num_grid: int,
    extra_decisions: int = 0,
    panels: Optional[torch.Tensor] = None,  # [n, 6, S], written when given
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: a loop over steps, vectorised over
    sims.  Returns ``(sums [n, 7], xsums [n, B+1], inv_final [S], pv_final [S])``."""
    n, num_factors, S = factors.shape
    B = spec.num_basis
    # The slot weights, uploaded once, as the kernel's launcher does.
    weights = upload(decision_weights(extra_decisions), inv0.device, inv0.dtype)
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
        decisions = bang_bang_decisions_fixed(min_rate, max_rate, inv, loss_amt, lo, hi,
                                              extra_decisions, weights)  # [S, D]
        tbl = tables[k].T  # [G, B+1]
        best = None
        for d in decisions.unbind(dim=1):
            j, w = fractional_index((inv + d) - loss_amt, lo, hi, num_grid)
            eff = tbl[j] * (1.0 - w)[:, None] + tbl[j + 1] * w[:, None]  # [S, B+1]
            cont = torch.zeros_like(d)
            for b in range(B + 1):  # sequential, in the kernel's order
                cont = cont + xn1[b] * eff[:, b]
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
        if panels is not None:
            panels[k] = torch.stack([inv, vol, consumed, loss_amt, net, imm])
        sums.append(torch.stack([x.sum() for x in (inv, vol, consumed, loss_amt, net, imm,
                                                   net * spot)]))
        xsums.append(xn1.sum(dim=1))
        inv = inv + vol - loss_amt
        pv = pv + imm
    return torch.stack(sums), torch.stack(xsums), inv, pv


TILE_SIMS = 256  # sims of one tile of the kernel's persistent grid (``tile_sims``, both dtypes)


def grid_blocks(lib, device, spec: BasisSpec, *shape, dtype=torch.float32) -> int:
    """Blocks (= partials) of the kernel's persistent grid for ``shape`` (the
    integer arguments of ``forward_sim_blocks``), the basis ``spec`` and the
    instantiation of ``dtype``: an occupancy query, asked on every launch."""
    from .csrc import basis_arrays, check_launch, on_device

    blocks = lib.forward_sim_blocks if dtype == torch.float32 else lib.forward_sim_f64_blocks
    with on_device(device):
        n = blocks(*shape, *basis_arrays(spec))
    if n <= 0:
        check_launch("forward_sim", -n)
    return n


def pack_records(tables, mus, sds, pillars, scalars, pitch: int) -> torch.Tensor:
    """The kernel's per-step records ``[n, RL]`` in the tables' dtype: the
    table ``[G, B+1]`` with rows zero-padded to ``pitch`` elements (whole
    quads of four, read as one float4 or two double2; the kernel's
    ``forward_sim_row_pitch`` or ``forward_sim_f64_row_pitch`` says how many
    for a basis, the same in both dtypes), then the
    ``(mu_b, sd_b)`` pairs, the pillars and the scalars, zero-padded to a
    multiple of 4 elements (the launcher checks RL against its own count)."""
    n, B1, G = tables.shape
    table_rows = torch.nn.functional.pad(tables.transpose(1, 2), (0, pitch - B1))  # [n, G, pitch]
    musd = torch.stack([mus, sds], dim=2)  # [n, B, 2]
    parts = [table_rows.reshape(n, -1), musd.reshape(n, -1), pillars.reshape(n, -1), scalars]
    pad = -sum(p.shape[1] for p in parts) % 4
    return torch.cat(parts + [tables.new_zeros((n, pad))], dim=1).contiguous()


def _forward_sim_cuda(factors, inv0, tables, mus, sds, pillars, scalars, spec: BasisSpec,
                      interp_kind: int, num_grid: int, extra_decisions: int = 0,
                      panels: Optional[torch.Tensor] = None):
    """Launch ``forward_sim_kernel`` (CUDA tensors only), its float32 or its
    float64 instantiation by the dtype of ``factors``."""
    from .csrc import basis_arrays, check_dtype, check_launch, check_operand, kernels, on_device

    n, F, S = factors.shape
    B = spec.num_basis
    G = num_grid
    P, C = pillars.shape[1:]
    dtype = factors.dtype
    check_dtype("the forward_sim kernel", dtype)
    f64 = dtype == torch.float64
    operands = [
        ("factors", factors, (n, F, S)), ("inv0", inv0, (S,)), ("tables", tables, (n, B + 1, G)),
        ("mus", mus, (n, B)), ("sds", sds, (n, B)), ("pillars", pillars, (n, P, C)),
        ("scalars", scalars, (n, NUM_FIXED_SCALARS + F)),
    ]
    if panels is not None:
        operands.append(("panels", panels, (n, 6, S)))
    for name, t, shape in operands:
        check_operand(name, t, shape, dtype)
    lib = kernels()
    dev = factors.device
    weights = upload(decision_weights(extra_decisions), dev, dtype)
    D = weights.shape[1]
    pitch = lib.forward_sim_f64_row_pitch(B) if f64 else lib.forward_sim_row_pitch(B)
    records = pack_records(tables, mus, sds, pillars, scalars, pitch)
    nblk = grid_blocks(lib, dev, spec, S, G, B, F, P, C, D, dtype=dtype)
    # One [n, 7 + B+1] partial per block: the 7 sums' columns, then the design row's.
    partials = torch.empty((nblk, n, NUM_SUMS + B + 1), dtype=dtype, device=dev)
    inv_out = torch.empty((S,), dtype=dtype, device=dev)
    pv_out = torch.empty((S,), dtype=dtype, device=dev)
    spot_pow, fac_pow = basis_arrays(spec)
    launch = lib.forward_sim_f64_launch if f64 else lib.forward_sim_launch
    with on_device(dev):
        err = launch(
            factors.data_ptr(), inv0.data_ptr(), records.data_ptr(), weights.data_ptr(),
            partials.data_ptr(), inv_out.data_ptr(), pv_out.data_ptr(),
            None if panels is None else panels.data_ptr(),
            S, n, G, P, C, int(interp_kind), D, B, F, spot_pow, fac_pow, records.shape[1],
            nblk, torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch("forward_sim", err)
    count_launch("forward_sim")
    sums = partials.sum(dim=0)  # a fixed-order reduction over the blocks
    return sums[:, :NUM_SUMS], sums[:, NUM_SUMS:], inv_out, pv_out


def forward_sim(factors, inv0, tables, mus, sds, pillars, scalars, spec: BasisSpec,
                interp_kind: int, num_grid: int, extra_decisions: int = 0,
                panels: Optional[torch.Tensor] = None):
    """The forward pass: ``(sums [n, 7], xsums [n, B+1], inv_final [S], pv_final [S])``,
    writing the per-sim panel fields into ``panels [n, 6, S]`` when given.

    CUDA tensors go to the kernel; CPU tensors to :func:`forward_sim_reference`.
    """
    impl = forward_sim_reference if factors.device.type == "cpu" else _forward_sim_cuda
    return impl(factors, inv0, tables, mus, sds, pillars, scalars, spec, interp_kind, num_grid,
                extra_decisions, panels)
