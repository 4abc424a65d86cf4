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

:class:`StreamingFactorSource` serves horizons whose paths do not fit the
device: one checkpoint pass (the kernel's checkpoint mode, or
:func:`factor_checkpoints_reference`) keeps the state entering every span,
and each span is regenerated from its checkpoint on demand (the kernel, or
the plain version, resumed at the span's first step), bit for bit the paths
of one pass over the whole horizon.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

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


def _ou_steps(coeffs: SimCoefficients, num_sims: int, key: Tuple[int, int], antithetic: bool,
              device, y0: Optional[torch.Tensor], step0: int, num_steps: int):
    """Yield ``(i, y)``: the factor state ``[F, S]`` after local step ``i`` of
    the ``num_steps`` steps from absolute step ``step0`` (a multiple of the
    draw block), entered with state ``y0`` (None: zeros).  Each ``y`` is a new
    tensor."""
    if step0 % _DRAW_BLOCK:
        raise ValueError(f"step0 ({step0}) must be a multiple of {_DRAW_BLOCK}.")
    num_factors = coeffs.decay.shape[1]
    decay = torch.as_tensor(coeffs.decay, dtype=torch.float32).to(device)
    chol = torch.as_tensor(coeffs.chol, dtype=torch.float32).to(device)
    if y0 is None:
        y = torch.zeros((num_factors, num_sims), dtype=torch.float32, device=device)
    else:
        y = y0
    for b0 in range(step0, step0 + num_steps, _DRAW_BLOCK):
        z_b = _block_normals(key, b0, num_factors, num_sims, antithetic, device)
        for c in range(min(_DRAW_BLOCK, step0 + num_steps - b0)):
            k = b0 + c
            # Exact OU update: decay + correlated increment, the rank-F
            # contraction written out (F is tiny).
            inc = chol[k, :, 0, None] * z_b[c, 0]
            for f in range(1, num_factors):
                inc = inc + chol[k, :, f, None] * z_b[c, f]
            y = decay[k, :, None] * y + inc
            yield k - step0, y
        del z_b


def simulate_factor_paths_reference(
    coeffs: SimCoefficients,
    num_sims: int,
    key: Tuple[int, int],
    antithetic: bool = False,
    device=None,
    y0: Optional[torch.Tensor] = None,
    step0: int = 0,
    num_steps: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the path kernel: factor paths ``[n, F, S]``
    (float32) on ``device`` for the threefry ``key``.  With ``y0``/``step0``/
    ``num_steps``: the steps ``[step0, step0 + num_steps)`` of the horizon
    entered with state ``y0 [F, S]`` (``step0`` a multiple of 16)."""
    num_factors = coeffs.decay.shape[1]
    if num_steps is None:
        num_steps = coeffs.decay.shape[0] - step0
    out = torch.empty((num_steps, num_factors, num_sims), dtype=torch.float32, device=device)
    for i, y in _ou_steps(coeffs, num_sims, key, antithetic, device, y0, step0, num_steps):
        out[i] = y
    return out


def _num_checkpoints(num_steps: int, every: int) -> int:
    return -(-num_steps // every)


def factor_checkpoints_reference(coeffs: SimCoefficients, num_sims: int, key: Tuple[int, int],
                                 antithetic: bool, every: int, device=None) -> torch.Tensor:
    """Plain PyTorch version of the path kernel's checkpoint mode: the factor
    states ENTERING steps ``0, every, 2 every, ...`` as ``[num_ckpt, F, S]``
    (``every`` a multiple of 16)."""
    n, num_factors = coeffs.decay.shape
    num_ckpt = _num_checkpoints(n, every)
    out = torch.zeros((num_ckpt, num_factors, num_sims), dtype=torch.float32, device=device)
    last = (num_ckpt - 1) * every  # no state entered after it is kept
    for i, y in _ou_steps(coeffs, num_sims, key, antithetic, device, None, 0, last):
        if (i + 1) % every == 0:
            out[(i + 1) // every] = y
    return out


class _PathKernelTables(NamedTuple):
    """What every launch of the path kernel over one horizon and key reads."""

    keys: torch.Tensor  # [ceil(n / 16), 2] int32 view of the uint32 block keys
    coef: torch.Tensor  # [n, F + F F] rows [decay | chol row-major]
    num_steps: int
    num_factors: int


def _path_kernel_tables(coeffs: SimCoefficients, key: Tuple[int, int], device) -> _PathKernelTables:
    """One key per 16-step draw block, hashed on the host (n / 16 of them), and
    the per-step coefficient rows, on ``device``."""
    n, num_factors = coeffs.decay.shape
    # fold_in vectorised over the block starts: one hash of the counters (0, b0).
    starts = torch.arange(0, n, _DRAW_BLOCK, dtype=torch.int64)
    k0, k1 = threefry2x32(key[0], key[1], 0, starts)
    keys = torch.stack([k0, k1], dim=1).numpy().astype(np.uint32)
    coef = np.concatenate([coeffs.decay, coeffs.chol.reshape(n, -1)], axis=1).astype(np.float32)
    return _PathKernelTables(torch.from_numpy(keys.view(np.int32)).to(device),
                             torch.from_numpy(coef).to(device), n, num_factors)


def _launch_path_sim(tables: _PathKernelTables, out: torch.Tensor, num_sims: int,
                     antithetic: bool, y0: Optional[torch.Tensor] = None, step0: int = 0,
                     num_steps: Optional[int] = None, every: int = 0) -> torch.Tensor:
    """One launch of ``path_sim_kernel`` into ``out`` (CUDA only): the steps
    ``[step0, step0 + num_steps)`` entered with ``y0`` (None: zeros); paths
    when ``every`` is 0, else the checkpoints every ``every`` steps."""
    from ..ops import count_launch
    from ..ops.csrc import check_launch, check_operand, kernels

    device = out.device
    if device.type != "cuda":
        raise ValueError(f"the path kernel needs a CUDA device (got {device}); it never runs "
                         "on the CPU")
    F = tables.num_factors
    if num_steps is None:
        num_steps = tables.num_steps - step0
    if step0 % _DRAW_BLOCK or every % _DRAW_BLOCK:
        raise ValueError(f"step0 ({step0}) and every ({every}) must be multiples of "
                         f"{_DRAW_BLOCK}.")
    if not 0 <= step0 <= step0 + num_steps <= tables.num_steps:
        raise ValueError(f"steps [{step0}, {step0 + num_steps}) lie outside the horizon "
                         f"of {tables.num_steps} steps.")
    rows = _num_checkpoints(num_steps, every) if every else num_steps
    check_operand("out", out, (rows, F, num_sims))
    if y0 is not None:
        check_operand("y0", y0, (F, num_sims))
    if out.numel() == 0:
        return out
    draw_sims = (num_sims + 1) // 2 if antithetic else num_sims
    if _DRAW_BLOCK * F * draw_sims >= 2**32:
        raise ValueError("random_bits supports fewer than 2**32 elements.")
    with torch.cuda.device(device):
        err = kernels().path_sim_launch(
            tables.keys.data_ptr(), tables.coef.data_ptr(),
            None if y0 is None else y0.data_ptr(), out.data_ptr(), num_sims, draw_sims, step0,
            num_steps, F, every, torch.cuda.current_stream(device).cuda_stream)
    check_launch("path_sim", err)
    count_launch("path_sim")
    return out


def _simulate_factor_paths_cuda(coeffs: SimCoefficients, num_sims: int, key: Tuple[int, int],
                                antithetic: bool, device) -> torch.Tensor:
    """Launch ``path_sim_kernel`` (CUDA devices only): one thread per drawn
    sim, one launch per path set."""
    device = torch.device(device)
    n, num_factors = coeffs.decay.shape
    out = torch.empty((n, num_factors, num_sims), dtype=torch.float32, device=device)
    return _launch_path_sim(_path_kernel_tables(coeffs, key, device), out, num_sims, antithetic)


def simulate_factor_paths(
    coeffs: SimCoefficients,
    num_sims: int,
    seed: Optional[int] = None,
    antithetic: bool = False,
    key: Optional[Tuple[int, int]] = None,
    device="cuda",
) -> torch.Tensor:
    """Simulate Markov factor state paths ``[n, F, S]`` (float32) on ``device``.

    Draws are those of the JAX package for the same threefry key: the
    default key is ``prng_key(seed)``.  A CUDA device goes to the kernel;
    ``device="cpu"`` to :func:`simulate_factor_paths_reference`.
    """
    if key is None:
        if seed is None:
            seed = np.random.SeedSequence().entropy % (2**63)
        key = prng_key(int(seed))
    if torch.device(device).type == "cpu":
        return simulate_factor_paths_reference(coeffs, num_sims, key, antithetic, device)
    return _simulate_factor_paths_cuda(coeffs, num_sims, key, antithetic, device)


class StreamingFactorSource:
    """Factor paths regenerated per time-span from checkpointed OU states.

    At hourly granularity x production path counts the full ``[n, F, S]``
    factor array does not fit the device (2 years hourly x 250k paths =
    52.6 GB), so the engine consumes paths span by span: one checkpoint pass
    stores the OU state entering each span, and each span is re-simulated on
    demand — checkpointed rematerialisation, trading one extra pass of the
    simulation arithmetic for O(n / every) memory.  Because normal draws are
    keyed per fixed 16-step block (see ``_block_normals``), the regenerated
    paths equal the one-launch paths bit for bit for the same key.

    Peak factor memory: one ``[every, F, S]`` span + ``[n / every, F, S]``
    checkpoints.  ``every`` is rounded up to a multiple of 16.  On a CUDA
    device the checkpoint pass and each span are one launch of the path
    kernel; ``device="cpu"`` runs the plain versions.
    """

    def __init__(self, coeffs: SimCoefficients, num_sims: int, key: Tuple[int, int],
                 antithetic: bool = False, every: int = 512, device="cuda"):
        self.num_steps = int(coeffs.decay.shape[0])
        self.num_factors = int(coeffs.decay.shape[1])
        self.num_sims = int(num_sims)
        self.antithetic = bool(antithetic)
        self.every = max(_DRAW_BLOCK, -(-int(every) // _DRAW_BLOCK) * _DRAW_BLOCK)
        self.device = torch.device(device)
        self._key = key
        self._coeffs = coeffs
        self._tables = None  # the kernel's keys and coefficient rows, uploaded once
        self._ckpts = None  # computed on first use
        self._span_cache = None  # (span_index, [span_len, F, S]) one-slot

    def prepare(self) -> "StreamingFactorSource":
        """Eagerly run the checkpoint pass (otherwise lazy on first read), so
        that callers can attribute the upfront simulation cost to their own
        timing phase.  Returns ``self`` for chaining."""
        self._checkpoints()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def spans(self):
        """The aligned spans [(a, b), ...] covering [0, num_steps)."""
        return [(a, min(a + self.every, self.num_steps))
                for a in range(0, self.num_steps, self.every)]

    def _on_card(self) -> bool:
        if self.device.type == "cpu":
            return False
        if self._tables is None:
            self._tables = _path_kernel_tables(self._coeffs, self._key, self.device)
        return True

    def _checkpoints(self) -> torch.Tensor:
        if self._ckpts is None:
            if self._on_card():
                out = torch.empty(
                    (_num_checkpoints(self.num_steps, self.every), self.num_factors,
                     self.num_sims), dtype=torch.float32, device=self.device)
                self._ckpts = _launch_path_sim(self._tables, out, self.num_sims,
                                               self.antithetic, every=self.every)
            else:
                self._ckpts = factor_checkpoints_reference(
                    self._coeffs, self.num_sims, self._key, self.antithetic, self.every,
                    self.device)
        return self._ckpts

    def factors(self, a: int, b: int) -> torch.Tensor:
        """``[b - a, F, S]`` factor states for steps [a, b).

        ``[a, b)`` must lie within one aligned span (the engine iterates
        :meth:`spans`), so each call re-simulates at most one span.
        """
        i = a // self.every
        s0, s1 = i * self.every, min((i + 1) * self.every, self.num_steps)
        if not (s0 <= a < b <= s1):
            raise ValueError(f"factors({a}, {b}) crosses a span boundary (every={self.every}).")
        # One-slot span cache: the engine reads a span, sub-spans of it and
        # last() (one step of the final span) consecutively, so memoizing the
        # last regenerated span removes all redundant re-simulation at the
        # cost of one resident span.
        if self._span_cache is not None and self._span_cache[0] == i:
            out = self._span_cache[1]
        else:
            # Drop the stale span BEFORE materialising the next one: holding
            # both would transiently double the streamed-path footprint that
            # the path budget sized to ONE [span, F, S] block.
            self._span_cache = None
            y0 = self._checkpoints()[i]
            if self._on_card():
                out = torch.empty((s1 - s0, self.num_factors, self.num_sims),
                                  dtype=torch.float32, device=self.device)
                _launch_path_sim(self._tables, out, self.num_sims, self.antithetic, y0=y0,
                                 step0=s0, num_steps=s1 - s0)
            else:
                out = simulate_factor_paths_reference(
                    self._coeffs, self.num_sims, self._key, self.antithetic, self.device,
                    y0=y0, step0=s0, num_steps=s1 - s0)
            self._span_cache = (i, out)
        return out[a - s0:b - s0]

    def last(self) -> torch.Tensor:
        """``[F, S]`` — the factor state of the final simulated period."""
        return self.factors(self.num_steps - 1, self.num_steps)[0]


def spots_from_factor_paths(factors: torch.Tensor, vols: torch.Tensor,
                            log_fwd_drift: torch.Tensor) -> torch.Tensor:
    """Spot-price panel ``[n, S]`` from factor paths (deterministic transform)."""
    log_spots = torch.einsum("nf,nfs->ns", vols, factors) + log_fwd_drift[:, None]
    return torch.exp(log_spots)


def simulate_spot_paths(
    coeffs: SimCoefficients,
    num_sims: int,
    seed: Optional[int],
    antithetic: bool = False,
    key: Optional[Tuple[int, int]] = None,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Simulate spot paths and Markov factor states.

    Equivalent of ``MultiFactorSpotPriceSimulator.Simulate(numSims)``; the
    threefry ``seed`` replaces the reference's ``MersenneTwisterGenerator``
    seed (``multi_factor.py:76-80``).

    Returns:
      spots ``[n, S]``, factors ``[n, F, S]`` on ``device``.
    """
    factors = simulate_factor_paths(coeffs, num_sims, seed, antithetic, key, device)
    dev = factors.device
    spots = spots_from_factor_paths(
        factors, torch.as_tensor(coeffs.vols, dtype=torch.float32).to(dev),
        torch.as_tensor(coeffs.log_fwd_drift, dtype=torch.float32).to(dev))
    return spots, factors
