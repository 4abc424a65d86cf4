"""Least-squares continuation-value regression.

The reference computes a thin-QR pseudo-inverse of the design matrix per
period and applies it to each next-inventory value vector
(``LsmcStorageValuation.cs:185-205``, MKL-backed).  Here, as in the JAX
package, the regression uses **normal equations with standardised basis
columns**:

    coeffs = (Xs'Xs + lam I)^-1  Xs' V       for all grid columns at once,

a pair of skinny products ``[B,S]x[S,B]`` and ``[B,S]x[S,G]`` followed by a
tiny ``[B,B]`` Cholesky solve.  Standardising columns keeps the Gram matrix
well-conditioned so float32 suffices where the reference needed float64 QR.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from ..utils.basis import Monomial


class BasisSpec(NamedTuple):
    """Static dense encoding of a monomial basis.

    ``spot_powers[b]`` and ``factor_powers[b, f]`` are integer exponents; the
    design matrix column b is ``s**spot_powers[b] * prod_f x_f**factor_powers[b, f]``.
    """

    spot_powers: Tuple[int, ...]
    factor_powers: Tuple[Tuple[int, ...], ...]  # [B][F]

    @property
    def num_basis(self) -> int:
        return len(self.spot_powers)


def basis_spec(monomials: Sequence[Monomial], num_factors: int) -> BasisSpec:
    """Build a :class:`BasisSpec` from parsed monomials.

    Raises if a monomial references a factor index outside the model
    (mirrors the reference's runtime failure when basis functions index
    missing Markov factors).
    """
    spot_powers = []
    factor_powers = []
    for m in monomials:
        if m.max_factor_index >= num_factors:
            raise ValueError(
                f"Basis function {m} references factor x{m.max_factor_index} but the "
                f"model only has {num_factors} factors."
            )
        spot_powers.append(m.spot_power)
        row = [0] * num_factors
        for idx, power in m.factor_powers:
            row[idx] = power
        factor_powers.append(tuple(row))
    return BasisSpec(tuple(spot_powers), tuple(factor_powers))


def spot_from_factors(factors, vols, drift) -> torch.Tensor:
    """Spot prices from factor states: ``exp(drift + vols . Y)``, summed in
    the CUDA kernels' order (``csrc/storage_kernels.cuh::spot_of``).

    The spot is a deterministic per-period transform of the Markov states, so
    the engines recompute it instead of carrying an extra ``[n, S]`` array.
    """
    log_spot = drift
    for f in range(factors.shape[0]):
        log_spot = log_spot + vols[f] * factors[f]
    return torch.exp(log_spot)


def _ipow(x: torch.Tensor, p: int) -> torch.Tensor:
    """``x**p`` for a static positive integer as a multiply chain (the
    CUDA kernels evaluate the same chain)."""
    out = x
    for _ in range(p - 1):
        out = out * x
    return out


def design_columns(spec: BasisSpec, spot: torch.Tensor, factors) -> list:
    """Design-matrix columns: one tensor shaped like ``spot`` per basis
    function (``LsmcStorageValuation.PopulateDesignMatrix``, :753-770)."""
    columns = []
    for b in range(spec.num_basis):
        col = torch.ones_like(spot)
        sp = spec.spot_powers[b]
        if sp:
            col = col * _ipow(spot, sp)
        for f, fp in enumerate(spec.factor_powers[b]):
            if fp:
                col = col * _ipow(factors[f], fp)
        columns.append(col)
    return columns


def design_matrix(spec: BasisSpec, spot: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """Design matrix ``[S, B]`` from spot prices ``[S]`` and factors ``[F, S]``."""
    return torch.stack(design_columns(spec, spot, factors), dim=-1)


def standardize_columns(design: torch.Tensor, eps: float = 1e-12):
    """Z-score non-constant columns of ``design [S, B]``.

    Returns ``(standardized, mean, scale)``; constant columns (e.g. the ones
    basis) pass through with mean 0 / scale 1 so the intercept survives.
    The same (mean, scale) must be re-applied to the valuation-path design
    matrix in the forward pass so saved coefficients stay meaningful.
    """
    mean = design.mean(dim=0)
    var = ((design - mean) ** 2).mean(dim=0)
    sd = torch.sqrt(var)
    is_const = sd <= eps * (1.0 + mean.abs())
    mean = torch.where(is_const, torch.zeros_like(mean), mean)
    scale = torch.where(is_const, torch.ones_like(sd), sd)
    return (design - mean) / scale, mean, scale


def cholesky_solve_or_zero(gram: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``gram^-1 rhs`` by Cholesky, with the reference build's guard: where the
    float32 factorisation fails or yields non-finite values the fit falls
    back to zero (the column mean, for a pre-centred target).  Never raises
    and never synchronises with the device."""
    chol, info = torch.linalg.cholesky_ex(gram)
    coeffs = torch.cholesky_solve(rhs, chol)
    ok = torch.isfinite(coeffs) & (info == 0)
    return torch.where(ok, coeffs, torch.zeros_like(coeffs))


def fit_continuation(design_std: torch.Tensor, values: torch.Tensor,
                     ridge: float = 1e-6) -> torch.Tensor:
    """Regression coefficients ``[B, G]`` for every next-grid value column.

    ``ridge`` is a relative Tikhonov term scaled by ``S`` (standardized Gram
    diagonals are ~``S``); it guards the float32 Cholesky against basis
    collinearity.  Near-expiry design matrices can be almost perfectly
    collinear; a failed solve falls back to the zero fit (see
    :func:`cholesky_solve_or_zero`).
    """
    num_sims = design_std.shape[0]
    gram = design_std.T @ design_std
    rhs = design_std.T @ values
    gram = gram + (ridge * num_sims) * torch.eye(
        gram.shape[0], dtype=gram.dtype, device=gram.device)
    return cholesky_solve_or_zero(gram, rhs)
