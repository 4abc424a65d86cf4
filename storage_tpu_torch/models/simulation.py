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
map, XLA's ``erf_inv`` polynomials (``torch.erfinv`` differs by ~2e-5) and
XLA's ``log1p`` (a rational approximation below ``sqrt(2) - 1``, ``log(1 +
x)`` above it), rounded as XLA's CPU code rounds them: each polynomial step,
and the OU update after its first product, one fused multiply-add (exact, in
separately rounded float64 torch ops: :func:`_fma`, :func:`_fma32`), every
other step on its own.  In float32 the ``log`` of ``log1p``'s upper branch
is XLA's own (Cephes' ``logf``, :func:`_xla_logf`) and the square root the
correctly rounded one; in float64 (``dtype=torch.float64``) a draw takes
both 32-bit words of the hash as one 64-bit word, keeps 52 mantissa bits,
and goes through Giles' three-range expansion.  So the float32 draws are
the JAX package's bit for bit, and the float64 ones wherever the platform's
``log`` and ``sqrt`` agree with XLA's.

:func:`simulate_factor_paths` sends a CUDA device to one fused kernel
(``ops/csrc/path_sim.cu``: hash, normal map and OU update per sim in
registers, native uint32 arithmetic, nothing but the paths written to device
memory; in float64 each warp sorts a few steps' draws by ``log1p`` branch in
shared memory first) and the CPU to :func:`simulate_factor_paths_reference`, the plain
PyTorch version: threefry2x32 in int64 tensor arithmetic masked to 32 bits,
normals one 16-step draw block at a time (integer temporaries of
``[16, F, S]``).  The kernel rounds every step as the plain version does
(a float64 fused step with the card's DFMA), so the two give the same paths
bit for bit on one card.

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

from ..utils.profiling import active, host_wait, upload

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
# XLA's float64 erf_inv: Giles' double-precision expansion in three ranges
# of w = -log1p(-x^2): below 6.25 (23 terms), below 16 (19), beyond (17).
# The coefficients are the ones XLA compiles (read from its HLO).
_ERFINV64_LT6_25 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18,
    1.115787767802518096e-17, -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14, -8.1519341976054721522e-14,
    2.6335093153082322977e-12, -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09, -2.9070369957882005086e-08,
    4.2347877827932403518e-07, -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512, -0.0060336708714301490533,
    0.24015818242558961693, 1.6536545626831027356,
)
_ERFINV64_LT16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08, -2.7517406297064545428e-07,
    1.8239629214389227755e-08, 1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05, -4.7318229009055733981e-05,
    6.8284851459573175448e-05, 2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313, 0.0024914420961078508066,
    -0.0037512085075692412107, 0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635,
)
_ERFINV64_GE16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
    -3.7894654401267369937e-09, 7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08, 2.2900482228026654717e-07,
    -9.9298272942317002539e-07, 4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347, -0.00013871931833623122026,
    1.0103004648645343977, 4.8499064014085844221,
)
# XLA's log1p: below this |x|, the Cephes rational approximation
# x - x^2 / 2 + x^3 P(x) / Q(x) (coefficients highest power first); above
# it log(1 + x).
_LOG1P_SMALL = 0.41421356237309504880
_LOG1P_P = (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
    2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1,
)
_LOG1P_Q = (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
    3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1,
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


def _hash_words(key: Tuple[int, int], shape, device):
    """The two 32-bit output words (int64 tensors of ``shape``) of element
    ``i``'s counter pair ``(i >> 32, i & 0xffffffff)``: jax's partitionable
    layout, so values depend on the requested shape."""
    size = int(np.prod(shape))
    if size >= 2**32:
        raise ValueError("random_bits supports fewer than 2**32 elements.")
    counts = torch.arange(size, dtype=torch.int64, device=device)
    o1, o2 = threefry2x32(key[0], key[1], 0, counts)
    return o1.reshape(shape), o2.reshape(shape)


def random_bits(key: Tuple[int, int], shape, device) -> torch.Tensor:
    """32-bit random words (as int64), ``jax.random.bits``: the two hash
    words XORed.  A float64 draw takes the words apart instead (see
    :func:`uniform_from_words64`)."""
    o1, o2 = _hash_words(key, shape, device)
    return o1 ^ o2


_SPLIT = 2.0**27 + 1.0  # Veltkamp's splitter for float64


def _split(a: torch.Tensor):
    """Veltkamp's split of ``a`` into two halves of 26 bits each, ``a = hi + lo``."""
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """Knuth's TwoSum: ``s = a + b`` rounded and its error, ``a + b = s + e`` exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _round_to_odd(v: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """``v`` rounded to odd given the error ``e`` of the sum it rounds: an
    inexact sum whose last bit is even steps one ulp toward the exact value."""
    even = (v.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.full_like(v, float("inf")), torch.full_like(v, -float("inf")))
    return torch.where((e != 0) & even, torch.nextafter(v, toward), v)


def _fma(a, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once, as the card's DFMA computes it, from float64
    torch ops that each round on their own (Boldo and Melquiond, "Emulation
    of FMA and correctly rounded sums: proved algorithms using rounding to
    odd", IEEE Trans. Computers 57(4), 2008): Dekker's exact product
    ``uh + ul``, the TwoSum ``c + uh = th + tl``, the low parts added with
    rounding to odd, and one rounded sum of ``th`` and that odd part.  Only
    plain ``*``, ``+`` and ``-``, so no backend can contract them.  ``a`` or
    ``b`` may be a Python float.  Exact for operands whose products neither
    overflow nor underflow, as the normal map's and the OU update's are."""
    a, b = torch.as_tensor(a, dtype=c.dtype, device=c.device), \
        torch.as_tensor(b, dtype=c.dtype, device=c.device)
    uh = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    ul = ((ah * bh - uh) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, uh)
    v = _round_to_odd(*_two_sum(tl, ul))
    # v == 0: the sum is th exactly, with th's sign of zero (th + 0 would
    # turn -0 into +0).
    return torch.where(v == 0, th, th + v)


def _fma32(a, b, c: torch.Tensor) -> torch.Tensor:
    """The float32 ``a * b + c`` rounded once, as the card's FFMA computes it:
    the product of two float32 values is exact in float64, their sum with
    ``c`` is rounded to odd there (TwoSum), and one rounding to float32
    follows, which is then correct (Boldo and Melquiond, as :func:`_fma`:
    53 >= 2 x 24 + 2 bits).  ``a`` or ``b`` may be a Python float, rounded
    to float32 first as torch rounds a scalar."""
    a, b = (torch.as_tensor(t, dtype=torch.float32, device=c.device) for t in (a, b))
    return _round_to_odd(*_two_sum(a.double() * b.double(), c.double())).float()


def _fused(dtype):
    """The exact fused multiply-add of ``dtype``."""
    return _fma if dtype == torch.float64 else _fma32


# XLA's float32 log on the CPU: Cephes' logf (the mantissa m in [sqrt(1/2),
# sqrt(2)) as a polynomial in m - 1 in three interleaved Horner chains, the
# exponent's ln 2 split in two).
_LOGF_SQRTHF = 0.707106781186547524
_LOGF_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
           1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
           3.3333331174e-1)
_LOGF_Q1, _LOGF_Q2 = -2.12194440e-4, 0.693359375


def _xla_logf(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log`` of positive normal ``x`` as its CPU code computes
    it (not correctly rounded: it differs from a rounded ``log`` on ~7% of
    the arguments ``log1p`` meets), each multiply-add of the polynomial one
    float32 FMA (:func:`_fma32`), every other step on its own.
    ``ops/csrc/path_sim.cu`` (``xla_logf``) evaluates the same steps."""
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)  # in [1/2, 1)
    below = m < _LOGF_SQRTHF
    e = e - below.float()
    m = (m - 1.0) + torch.where(below, m, torch.zeros_like(m))
    x2 = m * m
    x3 = x2 * m
    p = _LOGF_P
    y, y1, y2 = _fma32(m, p[0], torch.full_like(m, p[1])), \
        _fma32(m, p[3], torch.full_like(m, p[4])), _fma32(m, p[6], torch.full_like(m, p[7]))
    y, y1, y2 = _fma32(y, m, torch.full_like(m, p[2])), _fma32(y1, m, torch.full_like(m, p[5])), \
        _fma32(y2, m, torch.full_like(m, p[8]))
    y = _fma32(_fma32(y, x3, y1), x3, y2)
    y = _fma32(y, x3, _LOGF_Q1 * e)
    return ((m - 0.5 * x2) + y) + _LOGF_Q2 * e


def _xla_log1p(x: torch.Tensor, log=None) -> torch.Tensor:
    """XLA's ``log1p`` (float32 or float64): the Cephes rational
    approximation below ``sqrt(2) - 1`` in magnitude, ``log(1 + x)`` above
    it, rounded as XLA's CPU code rounds it: each Horner step of P and Q one
    fused multiply-add, every other product, sum and the division on its
    own.  The inner sum ``-0.5 x^2 + x^3 P / Q`` is the same whether it is
    fused or not, since ``-0.5 x^2`` is exact; fusing the other product,
    ``fma(x^3, P / Q, -0.5 x^2)``, is not what XLA computes (a search over
    millions of arguments tells the forms apart).  ``log`` defaults to
    XLA's own float32 ``log`` (:func:`_xla_logf`) in float32 and to
    ``torch.log`` in float64; it is a seam for tests (XLA's own ``log`` on
    the same argument).  ``ops/csrc/path_sim.cu`` evaluates the same steps."""
    fma = _fused(x.dtype)
    if log is None:
        log = _xla_logf if x.dtype == torch.float32 else torch.log

    def horner(coefs):
        p = torch.zeros_like(x)
        for c in coefs:
            p = fma(p, x, torch.full_like(x, c))
        return p

    x2 = x * x
    small = x + (-0.5 * x2 + (x * x2) * (horner(_LOG1P_P) / horner(_LOG1P_Q)))
    return torch.where(x.abs() < _LOG1P_SMALL, small, log(x + 1.0))


def _erf_inv_f64(x: torch.Tensor, log=None, sqrt=torch.sqrt) -> torch.Tensor:
    """XLA's float64 ``erf_inv`` (Giles' three-range expansion), each Horner
    step one fused multiply-add as XLA's CPU code computes it.  ``log`` goes
    to :func:`_xla_log1p`; ``sqrt``, of the two outer ranges, is a seam for
    tests as well (torch's float64 ``sqrt`` on the CPU is not correctly
    rounded on every argument; on a CUDA device it is)."""
    w = -_xla_log1p(-x * x, log)
    lt6 = w < 6.25
    lt16 = w < 16.0

    def coef(i):
        c = x.new_tensor(_ERFINV64_LT6_25[i])
        if i < len(_ERFINV64_LT16):
            c = torch.where(lt6, c, x.new_tensor(_ERFINV64_LT16[i]))
        if i < len(_ERFINV64_GE16):
            c = torch.where(lt16, c, x.new_tensor(_ERFINV64_GE16[i]))
        return c

    w = torch.where(lt6, w - 3.125,
                    sqrt(w) - torch.where(lt16, x.new_tensor(3.25), x.new_tensor(5.0)))
    p = coef(0).expand_as(x)
    for i in range(1, len(_ERFINV64_LT6_25)):
        step = _fma(p, w, coef(i).expand_as(x))
        if i < len(_ERFINV64_GE16):
            p = step
        elif i < len(_ERFINV64_LT16):  # the two outer ranges' polynomials have ended
            p = torch.where(lt16, step, p)
        else:
            p = torch.where(lt6, step, p)
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def _erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (the Giles polynomial pair) as XLA's CPU code
    computes it: ``w = -log1p(-x^2)`` through XLA's ``log1p``
    (:func:`_xla_log1p`), each Horner step one float32 FMA (:func:`_fma32`),
    and the correctly rounded square root (torch's float32 ``sqrt`` on the
    CPU is not, on ~0.6% of arguments; the float64 root rounded once more
    is: 53 >= 2 x 24 + 2 bits).  ``ops/csrc/path_sim.cu`` (``erf_inv_rn``)
    evaluates the same steps with ``__fmaf_rn`` and ``__fsqrt_rn``."""
    w = -_xla_log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, x.new_tensor(_ERFINV_LT5[0]), x.new_tensor(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma32(p, w, torch.where(lt, x.new_tensor(c_lt), x.new_tensor(c_ge)))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def uniform_from_bits(bits: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits, then scale."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def uniform_from_words64(o1: torch.Tensor, o2: torch.Tensor, minval: float,
                         maxval: float) -> torch.Tensor:
    """``jax.random.uniform`` in float64 from the hash words of 64-bit random
    words ``o1 << 32 | o2``: their top 52 bits as the mantissa, then scale.
    torch has no logical right shift of int64, so the mantissa is taken as
    ``(o1 << 20) | (o2 >> 12)`` (both words lie in [0, 2^32))."""
    mant = (o1 << 20) | (o2 >> 12) | 0x3FF0000000000000
    floats = mant.view(torch.float64) - 1.0
    lo = torch.tensor(minval, dtype=torch.float64, device=o1.device)
    hi = torch.tensor(maxval, dtype=torch.float64, device=o1.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def normal(key: Tuple[int, int], shape, device, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` for float32 or float64."""
    if dtype == torch.float64:
        lo = float(np.nextafter(-1.0, 0.0))
        u = uniform_from_words64(*_hash_words(key, shape, device), lo, 1.0)
        return _erf_inv_f64(u) * float(np.sqrt(2))
    if dtype != torch.float32:
        raise ValueError(f"normal draws float32 or float64 (got {dtype}).")
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
                   device, dtype=torch.float32, window=None) -> torch.Tensor:
    """Normals for the draw block starting at step ``b0`` — always the full
    ``[_DRAW_BLOCK, F, S]`` shape (callers slice partial tail blocks), since
    threefry values depend on the requested shape.  With ``window = (sim0,
    local)`` only those columns are returned (drawn as part of the whole
    block: slow, and right)."""
    k = fold_in(key, b0)
    if antithetic:
        half = (num_sims + 1) // 2
        z = normal(k, (_DRAW_BLOCK, num_factors, half), device, dtype)
        z = torch.cat([z, -z], dim=-1)[:, :, :num_sims]
    else:
        z = normal(k, (_DRAW_BLOCK, num_factors, num_sims), device, dtype)
    return z if window is None else z[:, :, window[0]:window[0] + window[1]]


def _ou_steps(coeffs: SimCoefficients, num_sims: int, key: Tuple[int, int], antithetic: bool,
              device, y0: Optional[torch.Tensor], step0: int, num_steps: int,
              dtype=torch.float32, window=None):
    """Yield ``(i, y)``: the factor state ``[F, S]`` after local step ``i`` of
    the ``num_steps`` steps from absolute step ``step0`` (a multiple of the
    draw block), entered with state ``y0`` (None: zeros).  Each ``y`` is a new
    tensor of ``dtype``.  With ``window = (sim0, local)``: the states of those
    sims of the ``num_sims``, ``[F, local]``."""
    if step0 % _DRAW_BLOCK:
        raise ValueError(f"step0 ({step0}) must be a multiple of {_DRAW_BLOCK}.")
    num_factors = coeffs.decay.shape[1]
    fused = _fused(dtype)
    decay = upload(coeffs.decay, device, dtype)
    chol = upload(coeffs.chol, device, dtype)
    if y0 is None:
        width = num_sims if window is None else window[1]
        y = torch.zeros((num_factors, width), dtype=dtype, device=device)
    else:
        y = y0
    for b0 in range(step0, step0 + num_steps, _DRAW_BLOCK):
        z_b = _block_normals(key, b0, num_factors, num_sims, antithetic, device, dtype, window)
        for c in range(min(_DRAW_BLOCK, step0 + num_steps - b0)):
            k = b0 + c
            # Exact OU update: decay + correlated increment, the rank-F
            # contraction written out (F is tiny).  Its later products are
            # fused into the sums, as XLA's CPU code fuses them.
            inc = chol[k, :, 0, None] * z_b[c, 0]
            for f in range(1, num_factors):
                inc = fused(chol[k, :, f, None], z_b[c, f], inc)
            y = fused(decay[k, :, None], y, inc)
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
    dtype=torch.float32,
    window: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the path kernel: factor paths ``[n, F, S]``
    of ``dtype`` (float32 or float64) on ``device`` for the threefry
    ``key``.  With ``y0``/``step0``/``num_steps``: the steps
    ``[step0, step0 + num_steps)`` of the horizon entered with state
    ``y0 [F, S]`` (``step0`` a multiple of 16).  With ``window = (sim0,
    local)``: only those columns of the ``num_sims`` (``y0 [F, local]``)."""
    num_factors = coeffs.decay.shape[1]
    if num_steps is None:
        num_steps = coeffs.decay.shape[0] - step0
    width = num_sims if window is None else window[1]
    out = torch.empty((num_steps, num_factors, width), dtype=dtype, device=device)
    for i, y in _ou_steps(coeffs, num_sims, key, antithetic, device, y0, step0, num_steps,
                          dtype, window):
        out[i] = y
    return out


def _num_checkpoints(num_steps: int, every: int) -> int:
    return -(-num_steps // every)


def factor_checkpoints_reference(coeffs: SimCoefficients, num_sims: int, key: Tuple[int, int],
                                 antithetic: bool, every: int, device=None,
                                 dtype=torch.float32, window=None) -> torch.Tensor:
    """Plain PyTorch version of the path kernel's checkpoint mode: the factor
    states ENTERING steps ``0, every, 2 every, ...`` as ``[num_ckpt, F, S]``
    (``every`` a multiple of 16); with ``window = (sim0, local)`` only those
    columns, ``[num_ckpt, F, local]``."""
    n, num_factors = coeffs.decay.shape
    num_ckpt = _num_checkpoints(n, every)
    width = num_sims if window is None else window[1]
    out = torch.zeros((num_ckpt, num_factors, width), dtype=dtype, device=device)
    last = (num_ckpt - 1) * every  # no state entered after it is kept
    for i, y in _ou_steps(coeffs, num_sims, key, antithetic, device, None, 0, last, dtype,
                          window):
        if (i + 1) % every == 0:
            out[(i + 1) // every] = y
    return out


class _PathKernelTables(NamedTuple):
    """What every launch of the path kernel over one horizon and key reads."""

    keys: torch.Tensor  # [ceil(n / 16), 2] int32 view of the uint32 block keys
    coef: torch.Tensor  # [n, F + F F] rows [decay | chol row-major], of the paths' dtype
    num_steps: int
    num_factors: int


def _path_kernel_tables(coeffs: SimCoefficients, key: Tuple[int, int], device,
                        dtype=torch.float32) -> _PathKernelTables:
    """One key per 16-step draw block, hashed on the host (n / 16 of them), and
    the per-step coefficient rows in ``dtype``, on ``device``."""
    n, num_factors = coeffs.decay.shape
    # fold_in vectorised over the block starts: one hash of the counters (0, b0).
    starts = torch.arange(0, n, _DRAW_BLOCK, dtype=torch.int64)
    k0, k1 = threefry2x32(key[0], key[1], 0, starts)
    keys = torch.stack([k0, k1], dim=1).numpy().astype(np.uint32)
    coef = torch.as_tensor(np.concatenate([coeffs.decay, coeffs.chol.reshape(n, -1)], axis=1),
                           dtype=dtype)
    return _PathKernelTables(upload(keys.view(np.int32), device, torch.int32),
                             upload(coef, device, dtype), n, num_factors)


def _launch_path_sim(tables: _PathKernelTables, out: torch.Tensor, num_sims: int,
                     antithetic: bool, y0: Optional[torch.Tensor] = None, step0: int = 0,
                     num_steps: Optional[int] = None, every: int = 0,
                     window: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One launch of ``path_sim_kernel`` into ``out`` (CUDA only; the float32
    or the float64 mode, by ``out``'s dtype): the steps
    ``[step0, step0 + num_steps)`` entered with ``y0`` (None: zeros); paths
    when ``every`` is 0, else the checkpoints every ``every`` steps.  With
    ``window = (sim0, local)`` the kernel's window mode: only those columns of
    the ``num_sims`` (``out [., F, local]``, ``y0 [F, local]``)."""
    from ..ops import count_launch
    from ..ops.csrc import check_dtype, check_launch, check_operand, kernels, on_device

    device = out.device
    if device.type != "cuda":
        raise ValueError(f"the path kernel needs a CUDA device (got {device}); it never runs "
                         "on the CPU")
    check_dtype("the path_sim kernel", out.dtype)
    F = tables.num_factors
    if num_steps is None:
        num_steps = tables.num_steps - step0
    if step0 % _DRAW_BLOCK or every % _DRAW_BLOCK:
        raise ValueError(f"step0 ({step0}) and every ({every}) must be multiples of "
                         f"{_DRAW_BLOCK}.")
    if not 0 <= step0 <= step0 + num_steps <= tables.num_steps:
        raise ValueError(f"steps [{step0}, {step0 + num_steps}) lie outside the horizon "
                         f"of {tables.num_steps} steps.")
    if window is not None and not (0 <= window[0] and window[1] >= 1
                                   and window[0] + window[1] <= num_sims):
        raise ValueError(f"window {window} lies outside the {num_sims} sims")
    width = num_sims if window is None else window[1]
    rows = _num_checkpoints(num_steps, every) if every else num_steps
    check_operand("out", out, (rows, F, width), out.dtype)
    check_operand("coef", tables.coef, (tables.num_steps, F + F * F), out.dtype)
    if y0 is not None:
        check_operand("y0", y0, (F, width), out.dtype)
    if out.numel() == 0:
        return out
    draw_sims = (num_sims + 1) // 2 if antithetic else num_sims
    if _DRAW_BLOCK * F * draw_sims >= 2**32:
        raise ValueError("random_bits supports fewer than 2**32 elements.")
    f64 = out.dtype == torch.float64
    lib = kernels()
    args = [tables.keys.data_ptr(), tables.coef.data_ptr(),
            None if y0 is None else y0.data_ptr(), out.data_ptr(), num_sims, draw_sims]
    if window is None:
        launch = lib.path_sim_f64_launch if f64 else lib.path_sim_launch
    else:
        launch = lib.path_sim_f64_window_launch if f64 else lib.path_sim_window_launch
        args += list(window)
    with on_device(device):
        err = launch(*args, step0, num_steps, F, every,
                     torch.cuda.current_stream(device).cuda_stream)
    check_launch("path_sim", err)
    count_launch("path_sim")
    return out


def _simulate_factor_paths_cuda(coeffs: SimCoefficients, num_sims: int, key: Tuple[int, int],
                                antithetic: bool, device, dtype=torch.float32,
                                window: Optional[Tuple[int, int]] = None,
                                tables: Optional[_PathKernelTables] = None) -> torch.Tensor:
    """Launch ``path_sim_kernel`` (CUDA devices only): one launch per path set,
    or per window of it."""
    device = torch.device(device)
    n, num_factors = coeffs.decay.shape
    width = num_sims if window is None else window[1]
    out = torch.empty((n, num_factors, width), dtype=dtype, device=device)
    if tables is None:
        tables = _path_kernel_tables(coeffs, key, device, dtype)
    return _launch_path_sim(tables, out, num_sims, antithetic, window=window)


def _mesh_windows(mesh, num_sims: int):
    """``[(device, window), ...]`` of a paths mesh's shards: each entry's
    device and ``(sim0, local)``."""
    return list(zip(mesh.devices, mesh.windows(num_sims)))


def simulate_factor_paths(
    coeffs: SimCoefficients,
    num_sims: int,
    seed: Optional[int] = None,
    antithetic: bool = False,
    key: Optional[Tuple[int, int]] = None,
    device="cuda",
    dtype=torch.float32,
    mesh=None,
) -> torch.Tensor:
    """Simulate Markov factor state paths ``[n, F, S]`` of ``dtype`` (float32
    or float64) on ``device``.

    Draws are those of the JAX package for the same threefry key and dtype:
    the default key is ``prng_key(seed)``.  A CUDA device goes to the
    kernel; ``device="cpu"`` to :func:`simulate_factor_paths_reference`.
    With ``mesh`` (a :class:`~storage_tpu_torch.parallel.mesh.PathsMesh`) the
    result is one tensor ``[n, F, S / shards]`` per shard, on its entry's
    device: each shard draws only its window of the path set (the kernel's
    window mode), the same columns bit for bit; ``device`` is not used.
    """
    if key is None:
        if seed is None:
            seed = np.random.SeedSequence().entropy % (2**63)
        key = prng_key(int(seed))
    if mesh is not None:
        tables = {}
        out = []
        for dev, window in _mesh_windows(mesh, num_sims):
            if dev.type == "cpu":
                out.append(simulate_factor_paths_reference(coeffs, num_sims, key, antithetic,
                                                           dev, dtype=dtype, window=window))
            else:
                if dev not in tables:
                    tables[dev] = _path_kernel_tables(coeffs, key, dev, dtype)
                out.append(_simulate_factor_paths_cuda(coeffs, num_sims, key, antithetic, dev,
                                                       dtype, window, tables[dev]))
        return out
    if torch.device(device).type == "cpu":
        return simulate_factor_paths_reference(coeffs, num_sims, key, antithetic, device,
                                               dtype=dtype)
    return _simulate_factor_paths_cuda(coeffs, num_sims, key, antithetic, device, dtype)


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
    kernel; ``device="cpu"`` runs the plain versions.  With ``mesh`` (a
    :class:`~storage_tpu_torch.parallel.mesh.PathsMesh`; ``device`` is not
    used) each shard keeps its own checkpoints and regenerates only its own
    window of each span on its own device, so no device holds the whole set:
    :meth:`factors` and :meth:`last` return one tensor per shard.

    In a recorded call (one given a ``profile_sink``) each shard's checkpoint
    pass is a ``StreamCheckpoints`` span and each shard's regeneration of a
    span a ``StreamSpan`` span, counted in ``stream_checkpoints`` and
    ``streamed_spans``: one each per path-kernel launch on a card.  A read
    served by the span cache is neither.
    """

    def __init__(self, coeffs: SimCoefficients, num_sims: int, key: Tuple[int, int],
                 antithetic: bool = False, every: int = 512, device="cuda",
                 dtype=torch.float32, mesh=None):
        self.num_steps = int(coeffs.decay.shape[0])
        self.num_factors = int(coeffs.decay.shape[1])
        self.num_sims = int(num_sims)
        self.antithetic = bool(antithetic)
        self.every = max(_DRAW_BLOCK, -(-int(every) // _DRAW_BLOCK) * _DRAW_BLOCK)
        self.mesh = mesh
        self.device = torch.device(device) if mesh is None else mesh.devices[0]
        self.dtype = dtype
        self._key = key
        self._coeffs = coeffs
        # (device, window) of each shard; one shard of the whole set without a mesh.
        self._shards = [(self.device, None)] if mesh is None else \
            _mesh_windows(mesh, self.num_sims)
        self._tables = {}  # the kernel's keys and coefficient rows, uploaded once per device
        self._ckpts = None  # computed on first use, one tensor per shard
        self._span_cache = None  # (span_index, [[span_len, F, S_shard], ...]) one-slot

    def prepare(self) -> "StreamingFactorSource":
        """Eagerly run the checkpoint pass (otherwise lazy on first read), so
        that callers can attribute the upfront simulation cost to their own
        timing phase.  The wait for the pass is one :func:`host_wait`.
        Returns ``self`` for chaining."""
        self._shard_checkpoints()
        host_wait(self._synchronize)
        return self

    def _synchronize(self) -> None:
        for device in {d for d, _ in self._shards if d.type == "cuda"}:
            torch.cuda.synchronize(device)

    def spans(self):
        """The aligned spans [(a, b), ...] covering [0, num_steps)."""
        return [(a, min(a + self.every, self.num_steps))
                for a in range(0, self.num_steps, self.every)]

    def _tables_on(self, device) -> Optional[_PathKernelTables]:
        """The kernel's tables on a CUDA ``device``; None on the CPU."""
        if device.type == "cpu":
            return None
        if device not in self._tables:
            self._tables[device] = _path_kernel_tables(self._coeffs, self._key, device,
                                                       self.dtype)
        return self._tables[device]

    def _width(self, window) -> int:
        return self.num_sims if window is None else window[1]

    def _shard_checkpoints(self):
        if self._ckpts is None:
            self._ckpts = []
            sw = active()
            for device, window in self._shards:
                sw.count("stream_checkpoints")
                with sw.span("StreamCheckpoints"):
                    tables = self._tables_on(device)
                    if tables is not None:
                        out = torch.empty(
                            (_num_checkpoints(self.num_steps, self.every), self.num_factors,
                             self._width(window)), dtype=self.dtype, device=device)
                        self._ckpts.append(_launch_path_sim(tables, out, self.num_sims,
                                                            self.antithetic, every=self.every,
                                                            window=window))
                    else:
                        self._ckpts.append(factor_checkpoints_reference(
                            self._coeffs, self.num_sims, self._key, self.antithetic, self.every,
                            device, self.dtype, window))
        return self._ckpts

    def _checkpoints(self):
        """The checkpoints ``[num_ckpt, F, S]``, or one tensor per shard."""
        ckpts = self._shard_checkpoints()
        return ckpts if self.mesh is not None else ckpts[0]

    def factors(self, a: int, b: int):
        """``[b - a, F, S]`` factor states for steps [a, b) (one tensor per
        shard with a mesh).

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
            outs = self._span_cache[1]
        else:
            # Drop the stale span BEFORE materialising the next one: holding
            # both would transiently double the streamed-path footprint that
            # the path budget sized to ONE [span, F, S] block.
            self._span_cache = None
            outs = []
            sw = active()
            for (device, window), ckpts in zip(self._shards, self._shard_checkpoints()):
                sw.count("streamed_spans")
                with sw.span("StreamSpan"):
                    tables = self._tables_on(device)
                    if tables is not None:
                        out = torch.empty((s1 - s0, self.num_factors, self._width(window)),
                                          dtype=self.dtype, device=device)
                        _launch_path_sim(tables, out, self.num_sims, self.antithetic,
                                         y0=ckpts[i], step0=s0, num_steps=s1 - s0,
                                         window=window)
                    else:
                        out = simulate_factor_paths_reference(
                            self._coeffs, self.num_sims, self._key, self.antithetic, device,
                            y0=ckpts[i], step0=s0, num_steps=s1 - s0, dtype=self.dtype,
                            window=window)
                outs.append(out)
            self._span_cache = (i, outs)
        outs = [out[a - s0:b - s0] for out in outs]
        return outs if self.mesh is not None else outs[0]

    def last(self):
        """``[F, S]`` — the factor state of the final simulated period (one
        tensor per shard with a mesh)."""
        outs = self.factors(self.num_steps - 1, self.num_steps)
        return [o[0] for o in outs] if self.mesh is not None else outs[0]


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
    dtype=torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Simulate spot paths and Markov factor states.

    Equivalent of ``MultiFactorSpotPriceSimulator.Simulate(numSims)``; the
    threefry ``seed`` replaces the reference's ``MersenneTwisterGenerator``
    seed (``multi_factor.py:76-80``).

    Returns:
      spots ``[n, S]``, factors ``[n, F, S]`` on ``device``.
    """
    factors = simulate_factor_paths(coeffs, num_sims, seed, antithetic, key, device, dtype)
    dev = factors.device
    spots = spots_from_factor_paths(
        factors, torch.as_tensor(coeffs.vols, dtype=dtype).to(dev),
        torch.as_tensor(coeffs.log_fwd_drift, dtype=dtype).to(dev))
    return spots, factors
