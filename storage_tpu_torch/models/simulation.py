"""Multi-factor spot-price path simulation (torch).

Model (see SURVEY.md §2.2): risk-neutral forward dynamics

    dF(t,T)/F(t,T) = sum_i sigma_i(T) e^{-alpha_i (T-t)} dW_i,   corr(dW_i,dW_j)=rho_ij

so the spot S(t) = F(t,t) is log-normal around the initial forward curve:

    ln S(t_k) = ln F(0,t_k) - V_k/2 + sum_i sigma_i(t_k) * Y_i(t_k)

with dimensionless OU factor states Y_i and V_k the closed-form integrated
variance.  Discretisation is exact: ``Y_k = e^{-alpha dt} Y_{k-1} + L_k Z_k``
with ``L_k`` the Cholesky factor of the exact increment covariance.  All
per-step coefficients are precomputed on the host in float64.

Random numbers: the JAX package draws with ``jax.random`` (threefry2x32 in
its "partitionable" bit layout, normals as ``sqrt(2) * erf_inv(u)``).  This
module reproduces that generator, so that the port draws the same paths from
the same seed: the same ``fold_in`` block keying, the same bits-to-uniform
map and XLA's float32 ``erf_inv`` polynomial (``torch.erfinv`` differs by
~2e-5).

:func:`simulate_factor_paths` sends a CUDA device to one fused kernel
(``ops/csrc/path_sim.cu``: hash, normal map and OU update per sim in
registers, native uint32 arithmetic, nothing but the paths written to device
memory) and the CPU to :func:`simulate_factor_paths_reference`, the plain
PyTorch version: threefry2x32 in int64 tensor arithmetic masked to 32 bits,
normals one 16-step draw block at a time (integer temporaries of
``[16, F, S]``).  The kernel rounds every step as the plain version's torch
ops do, so the two give the same paths bit for bit on one card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# XLA's float32 inverse error function (Giles, "Approximating the erfinv
# function"), the expansion ``jax.lax.erf_inv`` lowers to.
_ERFINV_LT5 = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
_ERFINV_GE5 = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)


def _cont_ext(x: np.ndarray, dt) -> np.ndarray:
    """(1 - e^{-x dt}) / x with the x -> 0 limit dt (reference
    ``MultiFactorModel._cont_ext``, ``multi_factor.py:225-229``)."""
    x = np.asarray(x, dtype=np.float64)
    safe = np.where(x == 0.0, 1.0, x)
    return np.where(x == 0.0, dt, (1.0 - np.exp(-safe * dt)) / safe)


@dataclass(frozen=True)
class SimCoefficients:
    """Host-precomputed per-step simulation coefficients (all float64).

    Shapes: n sim steps, F factors.
    """

    decay: np.ndarray  # [n, F] e^{-alpha_i dt_k}
    chol: np.ndarray  # [n, F, F] Cholesky of exact increment covariance
    vols: np.ndarray  # [n, F] sigma_i(t_k) of the spot for each sim period
    log_fwd_drift: np.ndarray  # [n] ln F(0,t_k) - V_k / 2


def sim_coefficients(
    mean_reversions: np.ndarray,  # [F]
    vols: np.ndarray,  # [n, F] factor vol for each simulated period
    factor_corrs: np.ndarray,  # [F, F]
    times: np.ndarray,  # [n] year fractions from the valuation date
    forwards: np.ndarray,  # [n] F(0, t_k)
) -> SimCoefficients:
    """Precompute exact-discretisation coefficients."""
    alphas = np.asarray(mean_reversions, dtype=np.float64)
    vols = np.asarray(vols, dtype=np.float64)
    corrs = np.asarray(factor_corrs, dtype=np.float64)
    times = np.asarray(times, dtype=np.float64)
    forwards = np.asarray(forwards, dtype=np.float64)
    n, num_factors = vols.shape
    alpha_sum = alphas[:, None] + alphas[None, :]  # [F, F]

    prev_times = np.concatenate([[0.0], times[:-1]])
    dts = times - prev_times
    if np.any(dts < 0.0):
        raise ValueError("Simulation times must be non-decreasing.")

    decay = np.exp(-alphas[None, :] * dts[:, None])  # [n, F]

    cov_all = corrs[None, :, :] * _cont_ext(
        alpha_sum[None, :, :], dts[:, None, None]
    )  # [n, F, F]
    try:
        chol = np.linalg.cholesky(cov_all)
    except np.linalg.LinAlgError:
        # Some step is semidefinite (dt == 0 or perfectly correlated
        # factors): redo per step so only the bad ones pay the eigh repair
        # jitter (which must not perturb healthy covariances).
        chol = np.empty((n, num_factors, num_factors), dtype=np.float64)
        for k in range(n):
            cov = cov_all[k]
            try:
                chol[k] = np.linalg.cholesky(cov)
            except np.linalg.LinAlgError:
                eye = np.eye(num_factors) * 1e-14
                w, v = np.linalg.eigh(cov + eye)
                w = np.clip(w, 0.0, None)
                chol[k] = np.linalg.cholesky(v @ np.diag(w) @ v.T + eye)

    # V_k = Var[sum_i sigma_i(t_k) Y_i(t_k)]
    variance = np.einsum(
        "kf,kg,fg,kfg->k",
        vols,
        vols,
        corrs,
        _cont_ext(alpha_sum[None, :, :], times[:, None, None]),
    )
    log_fwd_drift = np.log(forwards) - 0.5 * variance
    return SimCoefficients(decay=decay, chol=chol, vols=vols, log_fwd_drift=log_fwd_drift)


# --------------------------------------------------------------------------- #
# threefry2x32, as jax.random computes it                                     #
# --------------------------------------------------------------------------- #


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _MASK32


def threefry2x32(k1: int, k2: int, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pair ``(x1, x2)``.

    ``k1``/``k2`` are Python ints; ``x1``/``x2`` are Python ints or int64
    tensors holding unsigned 32-bit values.  Returns the output pair in the
    same representation.
    """
    ks = (k1 & _MASK32, k2 & _MASK32, (k1 ^ k2 ^ 0x1BD11BDA) & _MASK32)
    x = [(x1 + ks[0]) & _MASK32, (x2 + ks[1]) & _MASK32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x[0], x[1]


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for the threefry implementation."""
    seed = int(seed)
    return (seed >> 32) & _MASK32, seed & _MASK32


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """``jax.random.fold_in``: hash the counter pair ``(0, data)`` under ``key``."""
    return threefry2x32(key[0], key[1], 0, int(data) & _MASK32)


def random_bits(key: Tuple[int, int], shape, device) -> torch.Tensor:
    """32-bit random words (as int64) in jax's partitionable layout.

    Element ``i`` of the flattened shape hashes the counter pair
    ``(i >> 32, i & 0xffffffff)`` and XORs the two output words, so values
    depend on the requested shape.
    """
    size = int(np.prod(shape))
    if size >= 2**32:
        raise ValueError("random_bits supports fewer than 2**32 elements.")
    counts = torch.arange(size, dtype=torch.int64, device=device)
    o1, o2 = threefry2x32(key[0], key[1], 0, counts)
    return (o1 ^ o2).reshape(shape)


def _erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (the Giles polynomial pair)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, x.new_tensor(_ERFINV_LT5[0]), x.new_tensor(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, x.new_tensor(c_lt), x.new_tensor(c_ge)) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def uniform_from_bits(bits: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits, then scale."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def normal(key: Tuple[int, int], shape, device) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform_from_bits(random_bits(key, shape, device), lo, 1.0)
    return _erf_inv_f32(u) * float(np.float32(np.sqrt(2)))


# --------------------------------------------------------------------------- #
# Factor paths                                                                #
# --------------------------------------------------------------------------- #

# Normal draws happen in fixed blocks of this many steps, each keyed by
# fold_in(key, block_start_step): the stream for steps [b, b+16) depends only
# on the key and b, never on how much of the horizon is simulated around it.
_DRAW_BLOCK = 16


def _block_normals(key, b0: int, num_factors: int, num_sims: int, antithetic: bool,
                   device) -> torch.Tensor:
    """Normals for the draw block starting at step ``b0`` — always the full
    ``[_DRAW_BLOCK, F, S]`` shape (callers slice partial tail blocks), since
    threefry values depend on the requested shape."""
    k = fold_in(key, b0)
    if antithetic:
        half = (num_sims + 1) // 2
        z = normal(k, (_DRAW_BLOCK, num_factors, half), device)
        return torch.cat([z, -z], dim=-1)[:, :, :num_sims]
    return normal(k, (_DRAW_BLOCK, num_factors, num_sims), device)


def simulate_factor_paths_reference(
    coeffs: SimCoefficients,
    num_sims: int,
    key: Tuple[int, int],
    antithetic: bool = False,
    device=None,
) -> torch.Tensor:
    """Plain PyTorch version of the path kernel: factor paths ``[n, F, S]``
    (float32) on ``device`` for the threefry ``key``."""
    n, num_factors = coeffs.decay.shape
    decay = torch.as_tensor(coeffs.decay, dtype=torch.float32).to(device)
    chol = torch.as_tensor(coeffs.chol, dtype=torch.float32).to(device)
    out = torch.empty((n, num_factors, num_sims), dtype=torch.float32, device=device)
    y = torch.zeros((num_factors, num_sims), dtype=torch.float32, device=device)
    for b0 in range(0, n, _DRAW_BLOCK):
        z_b = _block_normals(key, b0, num_factors, num_sims, antithetic, device)
        for c in range(min(_DRAW_BLOCK, n - b0)):
            k = b0 + c
            # Exact OU update: decay + correlated increment, the rank-F
            # contraction written out (F is tiny).
            inc = chol[k, :, 0, None] * z_b[c, 0]
            for f in range(1, num_factors):
                inc = inc + chol[k, :, f, None] * z_b[c, f]
            y = decay[k, :, None] * y + inc
            out[k] = y
        del z_b
    return out


def _simulate_factor_paths_cuda(coeffs: SimCoefficients, num_sims: int, key: Tuple[int, int],
                                antithetic: bool, device) -> torch.Tensor:
    """Launch ``path_sim_kernel`` (CUDA devices only): one thread per drawn
    sim, one launch per path set."""
    from ..ops import count_launch
    from ..ops.csrc import check_launch, kernels

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the path kernel needs a CUDA device (got {device}); it never runs "
                         "on the CPU")
    n, num_factors = coeffs.decay.shape
    out = torch.empty((n, num_factors, num_sims), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    draw_sims = (num_sims + 1) // 2 if antithetic else num_sims
    if _DRAW_BLOCK * num_factors * draw_sims >= 2**32:
        raise ValueError("random_bits supports fewer than 2**32 elements.")
    # One key per 16-step draw block, hashed here (n / 16 of them); the
    # per-step coefficients as rows [decay (F) | chol (F x F, row-major)].
    keys = np.array([fold_in(key, b0) for b0 in range(0, n, _DRAW_BLOCK)], dtype=np.uint32)
    coef = np.concatenate([coeffs.decay, coeffs.chol.reshape(n, -1)], axis=1).astype(np.float32)
    keys_dev = torch.from_numpy(keys.view(np.int32)).to(device)
    coef_dev = torch.from_numpy(coef).to(device)
    with torch.cuda.device(device):
        err = kernels().path_sim_launch(
            keys_dev.data_ptr(), coef_dev.data_ptr(), out.data_ptr(), num_sims, draw_sims, n,
            num_factors, torch.cuda.current_stream(device).cuda_stream)
    check_launch("path_sim", err)
    count_launch("path_sim")
    return out


def simulate_factor_paths(
    coeffs: SimCoefficients,
    num_sims: int,
    seed: Optional[int] = None,
    antithetic: bool = False,
    key: Optional[Tuple[int, int]] = None,
    device=None,
) -> torch.Tensor:
    """Simulate Markov factor state paths ``[n, F, S]`` (float32) on ``device``.

    Draws are those of the JAX package for the same threefry key: the
    default key is ``prng_key(seed)``.  A CUDA device goes to the kernel; the
    CPU (``device`` None or ``"cpu"``) to
    :func:`simulate_factor_paths_reference`.
    """
    if key is None:
        if seed is None:
            seed = np.random.SeedSequence().entropy % (2**63)
        key = prng_key(int(seed))
    if device is None or torch.device(device).type == "cpu":
        return simulate_factor_paths_reference(coeffs, num_sims, key, antithetic, device)
    return _simulate_factor_paths_cuda(coeffs, num_sims, key, antithetic, device)


def spots_from_factor_paths(factors: torch.Tensor, vols: torch.Tensor,
                            log_fwd_drift: torch.Tensor) -> torch.Tensor:
    """Spot-price panel ``[n, S]`` from factor paths (deterministic transform)."""
    log_spots = torch.einsum("nf,nfs->ns", vols, factors) + log_fwd_drift[:, None]
    return torch.exp(log_spots)
