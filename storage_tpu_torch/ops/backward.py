"""One backward LSMC period: the value-surface update (CUDA kernel) and the
exact regression solve assembled from its partials.

Counterpart of the JAX package's ``ops/pallas_backward.py``.  The kernel
(``csrc/backward_update.cu``, one source templated on the element type: a
float32 and a float64 instantiation) replaces ``_backward_kernel`` there;
it computes the XLA math of ``_backward_step_core`` (``engines/lsmc.py``)
in the operands' dtype with exact linear interpolation, from a per-step
table

    table[d, g, :B]   = M_d @ coeffs'        (interpolation folded through the fit)
    table[d, g, B]    = M_d @ vbar - cost_npv[g, d]
    table[d, g, B+1]  = price_coeff[g, d]

where ``M_d`` interpolates the next grid at decision d's post-decision
inventories ``(j, w) = geometry[d, g]``.  It also emits the Gram and cross
partials of the previous period's regression, from which
:func:`assemble_regression` solves that period's coefficients without
re-reading the value surface.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import count_launch
from .regression import BasisSpec, cholesky_solve_or_zero, design_columns, spot_from_factors

_GRIDS = {}  # (device, dtype, S, D, B) -> the kernel's persistent grid (blocks)


def _standardized_rows(spec: BasisSpec, factors, coef, musd) -> torch.Tensor:
    """``[B, S]`` design rows standardized with ``musd = [mu; sd]``, and the spot."""
    spot = spot_from_factors(factors, coef[1:], coef[0])
    cols = design_columns(spec, spot, factors)
    rows = torch.stack([(cols[b] - musd[0, b]) / musd[1, b] for b in range(spec.num_basis)])
    return rows, spot


def backward_update_reference(
    factors: torch.Tensor,  # [F, S] this period's factors
    factors_prev: torch.Tensor,  # [F, S] previous period's factors
    v_next: torch.Tensor,  # [G, S] next-period values
    table: torch.Tensor,  # [D, G, B+2]
    vbar: torch.Tensor,  # [G] sim-mean of v_next
    musd: torch.Tensor,  # [2, B]
    geom_j: torch.Tensor,  # [D, G] int32
    geom_w: torch.Tensor,  # [D, G]
    scal: torch.Tensor,  # [2, 1+F]
    spec: BasisSpec,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: a vectorised ``[D, G, S]``
    evaluation.  Returns ``(v_out [G, S], graw [B+1, B+1], praw [B+1, G])``."""
    B = spec.num_basis
    xn, spot = _standardized_rows(spec, factors, scal[0], musd)
    affine = table[..., B, None]
    price = table[..., B + 1, None]
    fit = torch.einsum("dgb,bs->dgs", table[..., :B], xn) + affine + price * spot
    vc = v_next - vbar[:, None]
    j = geom_j.long()
    w = geom_w[..., None]
    act = vc[j] * (1.0 - w) + vc[j + 1] * w + affine + price * spot
    best_fit, v_out = fit[0], act[0]
    for d in range(1, table.shape[0]):  # first-occurrence argmax, decision 0 seeds
        better = fit[d] > best_fit
        best_fit = torch.where(better, fit[d], best_fit)
        v_out = torch.where(better, act[d], v_out)
    xr, _ = _standardized_rows(spec, factors_prev, scal[1], musd)
    xr = torch.cat([xr, torch.ones_like(xr[:1])], dim=0)  # [B+1, S]
    graw = xr @ xr.T
    praw = xr @ (v_out - vbar[:, None]).T
    return v_out, graw, praw


def _persistent_grid(lib, device, S: int, D: int, B: int, dtype=torch.float32) -> int:
    """Blocks (= partials) of the kernel's persistent grid for these shapes
    (of its float32 or its float64 instantiation)."""
    from .csrc import check_launch, on_device

    with on_device(device):
        key = (torch.cuda.current_device(), dtype, S, D, B)
        if key not in _GRIDS:
            blocks = lib.backward_update_blocks if dtype == torch.float32 else \
                lib.backward_update_f64_blocks
            n = blocks(S, D, B)
            if n <= 0:
                check_launch("backward_update", -n)
            _GRIDS[key] = n
    return _GRIDS[key]


def backward_partials(v_next: torch.Tensor, D: int, B: int) -> torch.Tensor:
    """A buffer for K1's partials at ``v_next``'s shapes: one ``[B+1, G +
    B+1]`` partial (praw's columns, then graw's) per block of the kernel's
    persistent grid on CUDA, one on the CPU."""
    G, S = v_next.shape
    if v_next.device.type == "cpu":
        nblk = 1
    else:
        from .csrc import kernels

        nblk = _persistent_grid(kernels(), v_next.device, S, D, B, v_next.dtype)
    return torch.empty((nblk, B + 1, G + B + 1), dtype=v_next.dtype, device=v_next.device)


def reduce_partials(partials: torch.Tensor, G: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(graw [B+1, B+1], praw [B+1, G])`` from the kernel's partials: a
    fixed-order reduction over the blocks."""
    sums = partials.sum(dim=0)
    return sums[:, G:], sums[:, :G]


def _backward_update_cuda(factors, factors_prev, v_next, table, vbar, musd, geom_j, geom_w,
                          scal, spec: BasisSpec, partials=None):
    """Launch ``backward_update_kernel`` (CUDA tensors only), its float32 or
    its float64 instantiation by the dtype of ``v_next``, writing its
    partials into ``partials`` (:func:`backward_partials`; a new buffer
    when None).  Returns ``(v_out [G, S], partials)``."""
    from .csrc import basis_arrays, check_dtype, check_launch, check_operand, kernels, on_device

    F, S = factors.shape
    G = v_next.shape[0]
    D = table.shape[0]
    B = spec.num_basis
    dtype = v_next.dtype
    check_dtype("the backward_update kernel", dtype)
    for name, t, shape in (
        ("factors", factors, (F, S)), ("factors_prev", factors_prev, (F, S)),
        ("v_next", v_next, (G, S)), ("table", table, (D, G, B + 2)), ("vbar", vbar, (G,)),
        ("musd", musd, (2, B)), ("geom_w", geom_w, (D, G)), ("scal", scal, (2, 1 + F)),
    ):
        check_operand(name, t, shape, dtype)
    check_operand("geom_j", geom_j, (D, G), torch.int32)
    lib = kernels()
    nblk = _persistent_grid(lib, v_next.device, S, D, B, dtype)
    if partials is None:
        partials = backward_partials(v_next, D, B)
    check_operand("partials", partials, (nblk, B + 1, G + B + 1), dtype)
    v_out = torch.empty_like(v_next)
    spot_pow, fac_pow = basis_arrays(spec)
    launch = lib.backward_update_launch if dtype == torch.float32 else \
        lib.backward_update_f64_launch
    with on_device(v_next.device):
        err = launch(
            factors.data_ptr(), factors_prev.data_ptr(), v_next.data_ptr(), v_out.data_ptr(),
            table.data_ptr(), vbar.data_ptr(), musd.data_ptr(), geom_j.data_ptr(),
            geom_w.data_ptr(), scal.data_ptr(), partials.data_ptr(),
            S, G, D, B, F, spot_pow, fac_pow, nblk,
            torch.cuda.current_stream(v_next.device).cuda_stream,
        )
    check_launch("backward_update", err)
    count_launch("backward_update")
    return v_out, partials


def backward_update(factors, factors_prev, v_next, table, vbar, musd, geom_j, geom_w, scal,
                    spec: BasisSpec, partials=None):
    """One backward period: ``(v_out [G, S], partials)``, the Gram and cross
    partials written unreduced (:func:`reduce_partials`) into ``partials``
    (:func:`backward_partials`; a new buffer when None).

    CUDA tensors go to the kernel; CPU tensors to
    :func:`backward_update_reference`, whose sums fill one block (so the
    reduction gives them back exactly).
    """
    if v_next.device.type != "cpu":
        return _backward_update_cuda(factors, factors_prev, v_next, table, vbar, musd, geom_j,
                                     geom_w, scal, spec, partials)
    v_out, graw, praw = backward_update_reference(factors, factors_prev, v_next, table, vbar,
                                                  musd, geom_j, geom_w, scal, spec)
    if partials is None:
        partials = backward_partials(v_next, table.shape[0], spec.num_basis)
    partials[0].copy_(torch.cat([praw, graw], dim=1))
    return v_out, partials


def assemble_regression(graw, praw, musd_approx, delta, num_sims: int,
                        ridge: float = 1e-6, eps: float = 1e-12):
    """Exact regression solve from the kernel's approximate-standardized
    partials (``pallas_backward.py::assemble_regression``).

    The kernel emitted, for the previous period's design matrix X (columns b)
    approx-standardized as ``z_b = (x_b - m_b) / s_b`` with a trailing ones
    row (index B):

      ``graw = [Z; 1] [Z; 1]'``  and  ``praw = [Z; 1] (V - c)'``

    where ``c`` is the next-period sim-mean used for centring and
    ``delta = vbar_new - c`` re-centres the target onto the new surface's own
    mean.  Every properly standardized column ``Xs_b = (x_b - mu_b)/sd_b`` is
    affine in ``z_b``, so the exact standardized Gram/RHS assemble in closed
    form from these sums.  Returns ``(coeffs [B, G], mu [B], sd [B])``.
    """
    B = graw.shape[0] - 1
    S = num_sims
    m_a, s_a = musd_approx[0], musd_approx[1]

    zbar = graw[B, :B] / S
    ez2 = torch.diagonal(graw)[:B] / S
    var_z = torch.clamp(ez2 - zbar * zbar, min=0.0)
    mu = m_a + s_a * zbar
    sd = s_a * torch.sqrt(var_z)
    # Constant-column detection must tolerate the f32 cancellation floor of
    # E[z^2] - zbar^2 (a column constant in the previous period, standardized
    # with this period's stats, is a non-zero constant z).  1e-3 covers every
    # practical path count; a missed detection is far worse than a false
    # positive (see the JAX package's note on this threshold).
    is_const = var_z <= torch.clamp(1e-3 * ez2, min=eps)
    mu = torch.where(is_const, torch.zeros_like(mu), mu)
    sd = torch.where(is_const, torch.ones_like(sd), sd)

    # Xs_b = alpha_b z_b + beta_b with the final (mu, sd).
    alpha = s_a / sd
    beta = (m_a - mu) / sd
    g = graw[:B, :B]
    gz1 = graw[:B, B]  # sum of z_b
    gram = (
        alpha[:, None] * alpha[None, :] * g
        + alpha[:, None] * beta[None, :] * gz1[:, None]
        + beta[:, None] * alpha[None, :] * gz1[None, :]
        + S * beta[:, None] * beta[None, :]
    )
    # Xs' (V - vbar_new): re-centre the target by delta via the column sums.
    xs_colsum = alpha * gz1 + S * beta  # [B]
    rhs = (
        alpha[:, None] * praw[:B, :]
        + beta[:, None] * praw[B, :][None, :]
        - xs_colsum[:, None] * delta[None, :]
    )
    gram = gram + (ridge * S) * torch.eye(B, dtype=gram.dtype, device=gram.device)
    return cholesky_solve_or_zero(gram, rhs), mu, sd
