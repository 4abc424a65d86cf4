// The multi-factor path simulator: threefry2x32 draws, the bits-to-normal
// map and the exact OU update, fused into one kernel.
//
// Replaces storage_tpu/models/simulation.py::simulate_factor_paths (:264, its
// jitted body _simulate_factor_kernel) and, for horizons whose paths do not
// fit the device, _factor_checkpoints_kernel (:293) and _factor_span_kernel
// (:325): XLA code in the JAX package, not a Pallas kernel. Plain PyTorch
// versions: storage_tpu_torch/models/simulation.py::
// simulate_factor_paths_reference and factor_checkpoints_reference.
//
// Three uses, one kernel: the whole horizon from y = 0 (one launch per path
// set); a checkpoint pass that walks the whole horizon but writes only the
// state entering every `every`-th step; and one span [step0, step0 + n) from
// a checkpointed entering state. A span regenerated from its checkpoint
// equals the same steps of the one-launch paths bit for bit: the draws
// depend only on the key and the absolute step, the state is carried in
// its type either way.
//
// Two layouts of the sims, in every use: the whole set (path_sim_launch),
// and a window [sim0, sim0 + local) of it (path_sim_window_launch), which is
// what one shard of a paths mesh simulates: out and y0 then hold only the
// window's columns, and each of them equals the same column of the whole
// set bit for bit, since a sim's draws are found by its counter in the
// whole set's draw block.
//
// What it computes. Steps are drawn in blocks of 16; block b0's key is
// fold_in(key, b0), hashed on the host (n / 16 pairs). Element
// i = (c F + f) S' + s of block b0's [16, F, S'] draw (c the step within the
// block, S' the drawn sims: S, or ceil(S / 2) in antithetic mode) is
//   bits = o1 ^ o2,  (o1, o2) = threefry2x32(key_b0, (0, i))
//   u    = max(lo, (as_float(bits >> 9 | 0x3F800000) - 1) (1 - lo) + lo),
//          lo = nextafter(-1, 0)
//   z    = sqrt(2) erf_inv(u)       (Giles' float32 polynomial pair, as XLA
//                                    lowers erf_inv)
// and the factor state moves as y_f <- decay[k, f] y_f + sum_g chol[k, f, g] z_g,
// written to out[k, f, s]. In antithetic mode sim s + S' takes -z, so its
// state is exactly -y (round-to-nearest is symmetric in sign): over the
// whole set the thread of sim s writes both; in a window each thread draws
// its own sim, a partner s >= S' the draw s - S' negated.
//
// Rounding, float32: as XLA's CPU code rounds it, which fuses multiply-adds
// (models/simulation.py::_erf_inv_f32). Each Horner step of erf_inv and of
// log1p's P and Q is one FMA (__fmaf_rn), and so is the OU update after its
// first product: inc = c0 z0, inc = fma(c_g, z_g, inc), y = fma(decay, y,
// inc). log1p's upper branch takes XLA's own float32 log (Cephes' logf,
// its multiply-adds fused as well), the square root is IEEE's. Every other
// product and sum is rounded on its own (__fmul_rn / __fadd_rn: nvcc may
// not contract them). Polynomial coefficients are double literals cast to
// float, which is how the plain version's Python floats become float32.
// The plain version computes the same steps with an exact FMA written in
// float64 torch ops (_fma32), so the paths equal it on the same card bit for
// bit, and the draws equal jax.random.normal's.
//
// Float64 mode (path_sim_f64_launch): the same hash and keys, but a draw
// takes both words of the hash as one 64-bit word o1 << 32 | o2 (not
// o1 ^ o2), keeps its top 52 bits as the mantissa of u, and maps u through
// XLA's float64 erf_inv (Giles' three-range expansion in w = -log1p(-u^2))
// and XLA's log1p (the Cephes rational approximation below sqrt(2) - 1,
// log(1 + x) above it), as jax.random.normal(key, shape, float64) draws.
// The state is carried and written in float64.
//
// Float64 rounding: as XLA's CPU code rounds it, which fuses multiply-adds.
// Each Horner step of erf_inv and of log1p's P and Q is one DFMA
// (__fma_rn), and so is the OU update after its first product:
// inc = c0 z0, inc = fma(c_g, z_g, inc), y = fma(decay, y, inc). Every
// other product, sum and the division is rounded on its own (__dmul_rn,
// __dadd_rn, __ddiv_rn: nvcc contracts nothing), log and the IEEE square
// root are the functions torch's CUDA ops call. The plain version computes
// the same steps with an exact FMA written in float64 torch ops
// (models/simulation.py::_fma), so the paths equal it bit for bit, and
// equal JAX's wherever the platform's log agrees.
//
// What bounds it on the H100. The function's only necessary traffic is its
// output, written once: 4 B x n x F x S (4.09 GB at 341 x 3 x 1M: 1.22 ms
// at 3.35 TB/s; 2.44 ms in float64). Per drawn element the hash is 72
// integer operations (20 rounds of add, rotate, xor; 11 key additions; the
// final xor) plus 3 for the counter and the mantissa, at the card's int32
// rate (64 lanes per SM, half the float32 lane rate: 16.75e12
// operations/s); 1.02e9 elements take 4.6 ms. The float32 work (the map
// with XLA's log1p on either branch, ~55 operations; 2F + 1 for the OU
// update) is ~60 operations per element, 0.9 ms at 67 TFLOP/s, on another
// pipe. So
// integer operations bound it, not bytes. The float64 map is ~85 operations
// a draw (2.6 ms at 34 TFLOP/s): the hash bounds it as well. The checkpoint
// pass does the same operations and writes 1 / every of the bytes.
//
// Design, float32. One thread per drawn sim, looping over all n steps with
// y[F] in registers: no temporaries in device memory, no shared memory, no
// __syncthreads. F is a template parameter, so a step's F hashes are
// independent chains the scheduler interleaves. Arithmetic is native uint32
// (rotations are funnel shifts). The per-step coefficients (decay, chol:
// F + F F floats) and the block keys are read through the read-only cache
// at addresses uniform over the warp. Stores are coalesced along s.
//
// Design, float64 (path_sim_f64_kernel). The float32 design evaluated both
// branches of log1p in every warp (a lane's draw takes the rational branch
// with 64% probability, the log with 36%), the square root under a select,
// and two or three selects per Horner step to pick a range's coefficient:
// ~150 FP64 and ~165 other instructions a draw. A draw's uniform depends
// only on the key and its counter, never on the state, so a warp first
// draws all uniforms of a round of K3F64::kSteps steps (each lane its own
// sim's kSteps x F), sorts them into two lists in shared memory by a ballot
// a draw (class A, |u^2| < sqrt(2) - 1: the rational log1p and erf_inv's
// first range; class B, the log branch), and maps each list in full-warp
// passes of one draw a lane: straight-line code with constant-bank
// coefficients, no selects. Class C (w >= 6.25, 0.1% of
// draws: the square root and the two outer ranges) is a branch inside B's
// passes. Each normal goes back to its list slot; after
// __syncwarp each lane reads its own draws through a per-lane position
// table and runs the OU updates and stores as the float32 design does. The
// last warp is ragged: lanes past the sims take part in every ballot and
// __syncwarp and draw nothing. Compaction changes where a draw is computed,
// never how: the paths are the same in one launch, in the checkpoint pass
// and in spans. What bounds it now is instruction issue: ~237 instructions
// a draw (the hash ~80, the map ~65 in class A and ~95 in B, sorting,
// OU update and stores the rest), and the map's FP64 work does not hide
// behind the hash's integer work (ablations and the sizes tried: PERF.md,
// section 6).
#include <type_traits>

#include "storage_kernels.cuh"

namespace storage_kernels {

constexpr int kDrawBlock = 16;   // steps per draw block (one key each)
constexpr int kSimThreads = 256;

__device__ __forceinline__ uint32_t rotl32(uint32_t v, int r) { return __funnelshift_l(v, v, r); }

// The output words (o1, o2) of threefry2x32 (20 rounds) of the counter pair
// (0, counter) under the key schedule ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA).
__device__ __forceinline__ void threefry_words(const uint32_t (&ks)[3], uint32_t counter,
                                               uint32_t& o1, uint32_t& o2) {
  uint32_t x0 = ks[0];
  uint32_t x1 = counter + ks[1];
#define STORAGE_TF_ROUND(r) \
  x0 += x1;                 \
  x1 = rotl32(x1, r) ^ x0;
#define STORAGE_TF_GROUP(a, b, c, d, i)   \
  STORAGE_TF_ROUND(a)                     \
  STORAGE_TF_ROUND(b)                     \
  STORAGE_TF_ROUND(c)                     \
  STORAGE_TF_ROUND(d)                     \
  x0 += ks[(i + 1) % 3];                  \
  x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  STORAGE_TF_GROUP(13, 15, 26, 6, 0)
  STORAGE_TF_GROUP(17, 29, 16, 24, 1)
  STORAGE_TF_GROUP(13, 15, 26, 6, 2)
  STORAGE_TF_GROUP(17, 29, 16, 24, 3)
  STORAGE_TF_GROUP(13, 15, 26, 6, 4)
#undef STORAGE_TF_GROUP
#undef STORAGE_TF_ROUND
  o1 = x0;
  o2 = x1;
}

// o1 ^ o2: the 32-bit random word of a float32 draw.
__device__ __forceinline__ uint32_t threefry_bits(const uint32_t (&ks)[3], uint32_t counter) {
  uint32_t o1, o2;
  threefry_words(ks, counter, o1, o2);
  return o1 ^ o2;
}

// XLA's float32 log on the CPU (Cephes' logf) of a positive normal x, as
// models/simulation.py::_xla_logf computes it.
__device__ __forceinline__ float xla_logf(float x) {
  const int bits = __float_as_int(x);
  float e = __fadd_rn((float)((bits >> 23) - 0x7F), 1.0f);
  float m = __int_as_float((bits & 0x007FFFFF) | 0x3F000000);  // in [1/2, 1)
  const bool below = m < (float)0.707106781186547524;
  e = __fsub_rn(e, below ? 1.0f : 0.0f);
  m = __fadd_rn(__fsub_rn(m, 1.0f), below ? m : 0.0f);
  const float x2 = __fmul_rn(m, m), x3 = __fmul_rn(x2, m);
  float y = __fmaf_rn(m, (float)7.0376836292e-2, (float)-1.1514610310e-1);
  float y1 = __fmaf_rn(m, (float)-1.2420140846e-1, (float)1.4249322787e-1);
  float y2 = __fmaf_rn(m, (float)2.0000714765e-1, (float)-2.4999993993e-1);
  y = __fmaf_rn(y, m, (float)1.1676998740e-1);
  y1 = __fmaf_rn(y1, m, (float)-1.6668057665e-1);
  y2 = __fmaf_rn(y2, m, (float)3.3333331174e-1);
  y = __fmaf_rn(__fmaf_rn(y, x3, y1), x3, y2);
  y = __fmaf_rn(y, x3, __fmul_rn((float)-2.12194440e-4, e));
  return __fadd_rn(__fadd_rn(__fsub_rn(m, __fmul_rn(0.5f, x2)), y),
                   __fmul_rn((float)0.693359375, e));
}

// XLA's float32 log1p (models/simulation.py::_xla_log1p): the rational
// approximation below sqrt(2) - 1, log(1 + x) above it.
__device__ __forceinline__ float xla_log1pf(float x) {
  if (!(fabsf(x) < (float)0.41421356237309504880)) return xla_logf(__fadd_rn(x, 1.0f));
  float p = (float)4.5270000862445199635215e-5, q = 1.0f;
#define STORAGE_LOG1P_STEP(c_p, c_q)   \
  p = __fmaf_rn(p, x, (float)(c_p)); \
  q = __fmaf_rn(q, x, (float)(c_q));
  STORAGE_LOG1P_STEP(4.9854102823193375972212e-1, 1.5062909083469192043167e1)
  STORAGE_LOG1P_STEP(6.5787325942061044846969e0, 8.3047565967967209469434e1)
  STORAGE_LOG1P_STEP(2.9911919328553073277375e1, 2.2176239823732856465394e2)
  STORAGE_LOG1P_STEP(6.0949667980987787057556e1, 3.0909872225312059774938e2)
  STORAGE_LOG1P_STEP(5.7112963590585538103336e1, 2.1642788614495947685003e2)
  STORAGE_LOG1P_STEP(2.0039553499201281259648e1, 6.0118660497603843919306e1)
#undef STORAGE_LOG1P_STEP
  const float x2 = __fmul_rn(x, x);
  return __fadd_rn(x, __fadd_rn(__fmul_rn(-0.5f, x2),
                                __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(p, q))));
}

// XLA's float32 erf_inv (Giles), each Horner step one FMA.
__device__ __forceinline__ float erf_inv_rn(float x) {
  float w = -xla_log1pf(__fmul_rn(-x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = lt ? (float)2.81022636e-08 : (float)-0.000200214257;
#define STORAGE_ERFINV_STEP(c_lt, c_ge) \
  p = __fmaf_rn(p, w, lt ? (float)(c_lt) : (float)(c_ge));
  STORAGE_ERFINV_STEP(3.43273939e-07, 0.000100950558)
  STORAGE_ERFINV_STEP(-3.5233877e-06, 0.00134934322)
  STORAGE_ERFINV_STEP(-4.39150654e-06, -0.00367342844)
  STORAGE_ERFINV_STEP(0.00021858087, 0.00573950773)
  STORAGE_ERFINV_STEP(-0.00125372503, -0.0076224613)
  STORAGE_ERFINV_STEP(-0.00417768164, 0.00943887047)
  STORAGE_ERFINV_STEP(0.246640727, 1.00167406)
  STORAGE_ERFINV_STEP(1.50140941, 2.83297682)
#undef STORAGE_ERFINV_STEP
  return fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7f800000)) : __fmul_rn(p, x);
}

// jax.random.normal's float32 value for one 32-bit random word.
__device__ __forceinline__ float normal_from_bits(uint32_t bits) {
  const float lo = -0x1.fffffep-1f;  // nextafter(-1, 0)
  const float unit = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float u = fmaxf(lo, __fadd_rn(__fmul_rn(unit, __fsub_rn(1.0f, lo)), lo));
  return __fmul_rn(erf_inv_rn(u), 0x1.6a09e6p+0f);  // float32(sqrt(2))
}

// XLA's float64 log1p and erf_inv, rounded as XLA's CPU code rounds them
// (models/simulation.py::_xla_log1p, _erf_inv_f64): each Horner step one
// fused multiply-add (__fma_rn), every other product, sum and the division
// on its own. Coefficients highest power first, read from the constant bank.
__constant__ double kLog1pP[7] = {
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
    2.9911919328553073277375e1,  6.0949667980987787057556e1,  5.7112963590585538103336e1,
    2.0039553499201281259648e1};
__constant__ double kLog1pQ[7] = {
    1.0,                         1.5062909083469192043167e1,  8.3047565967967209469434e1,
    2.2176239823732856465394e2,  3.0909872225312059774938e2,  2.1642788614495947685003e2,
    6.0118660497603843919306e1};
__constant__ double kErfInvLt6[23] = {
    -3.6444120640178196996e-21, -1.685059138182016589e-19,  1.2858480715256400167e-18,
    1.115787767802518096e-17,   -1.333171662854620906e-16,  2.0972767875968561637e-17,
    6.6376381343583238325e-15,  -4.0545662729752068639e-14, -8.1519341976054721522e-14,
    2.6335093153082322977e-12,  -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09,   -4.1126339803469836976e-09, -2.9070369957882005086e-08,
    4.2347877827932403518e-07,  -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352,   -0.00074070253416626697512, -0.0060336708714301490533,
    0.24015818242558961693,     1.6536545626831027356};
__constant__ double kErfInvLt16[19] = {
    2.2137376921775787049e-09,  9.0756561938885390979e-08,  -2.7517406297064545428e-07,
    1.8239629214389227755e-08,  1.5027403968909827627e-06,  -4.013867526981545969e-06,
    2.9234449089955446044e-06,  1.2475304481671778723e-05,  -4.7318229009055733981e-05,
    6.8284851459573175448e-05,  2.4031110387097893999e-05,  -0.0003550375203628474796,
    0.00095328937973738049703,  -0.0016882755560235047313,  0.0024914420961078508066,
    -0.0037512085075692412107,  0.005370914553590063617,    1.0052589676941592334,
    3.0838856104922207635};
__constant__ double kErfInvGe16[17] = {
    -2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
    -3.7894654401267369937e-09, 7.6157012080783393804e-09,  -1.4960026627149240478e-08,
    2.9147953450901080826e-08,  -6.7711997758452339498e-08, 2.2900482228026654717e-07,
    -9.9298272942317002539e-07, 4.5260625972231537039e-06,  -1.9681778105531670567e-05,
    7.5995277030017761139e-05,  -0.00021503011930044477347, -0.00013871931833623122026,
    1.0103004648645343977,      4.8499064014085844221};

// Class A, |x| < sqrt(2) - 1 for x = -u u rounded, is |u| <= kRationalMaxU:
// the largest double whose rounded square lies below sqrt(2) - 1 (the
// rounded square is monotone in |u|), one compare in place of a product
// and a compare.
constexpr double kRationalMaxU = 0x1.49852f983efddp-1;
constexpr double kSqrt2 = 0x1.6a09e667f3bcdp+0;

// u in [nextafter(-1, 0), 1) for the 64-bit random word o1 << 32 | o2: its top
// 52 bits as the mantissa of a number in [1, 2), then scaled as
// jax.random.uniform scales it, max(lo, unit (1 - lo) + lo). Here 1 - lo
// rounds to 2, so the product is exact and the two roundings are one FMA;
// and unit >= 0, so the max is the sum.
__device__ __forceinline__ double uniform_from_words(uint32_t o1, uint32_t o2) {
  const double lo = -0x1.fffffffffffffp-1;  // nextafter(-1, 0)
  const uint64_t mant = ((uint64_t)o1 << 20) | (o2 >> 12);
  const double unit = __dsub_rn(__longlong_as_double(mant | 0x3FF0000000000000ull), 1.0);
  return __fma_rn(unit, 2.0, lo);
}

// The argument of log1p in erf_inv: -u u.
__device__ __forceinline__ double log1p_arg(double u) { return __dmul_rn(-u, u); }

// The first range of erf_inv, w < 6.25: 22 DFMA.
__device__ __forceinline__ double erf_inv_first_range(double w) {
  const double v = __dsub_rn(w, 3.125);
  double e = kErfInvLt6[0];
#pragma unroll
  for (int i = 1; i < 23; ++i) e = __fma_rn(e, v, kErfInvLt6[i]);
  return e;
}

// The two outer ranges, w >= 6.25 (0.1% of draws): the square root and the
// coefficients of w < 16 (19 terms) or beyond (17 terms), selected per lane.
__device__ __noinline__ double erf_inv_outer_ranges(double w) {
  const bool lt16 = w < 16.0;
  const double v = __dsub_rn(__dsqrt_rn(w), lt16 ? 3.25 : 5.0);
  double e = lt16 ? kErfInvLt16[0] : kErfInvGe16[0];
#pragma unroll
  for (int i = 1; i < 19; ++i) {
    const double step =
        __fma_rn(e, v, i < 17 ? (lt16 ? kErfInvLt16[i] : kErfInvGe16[i]) : kErfInvLt16[i]);
    e = (i < 17 || lt16) ? step : e;  // the third range's polynomial ends after 17 terms
  }
  return e;
}

// The normal for the uniform u from erf_inv's polynomial value e: e u
// sqrt(2). (erf_inv(+-1) = +-inf, the plain version's special case, never
// arises: the uniforms lie strictly inside (-1, 1).)
__device__ __forceinline__ double normal_of(double e, double u) {
  return __dmul_rn(__dmul_rn(e, u), kSqrt2);
}

// Class A, |x| < sqrt(2) - 1 (x = -u^2): the rational log1p, whose w =
// -log1p(x) < 0.54 lies in erf_inv's first range. Straight-line: 12 + 22
// DFMA and one division.
__device__ __forceinline__ double normal_rational(double u) {
  const double x = log1p_arg(u);
  double p = kLog1pP[0], q = kLog1pQ[0];
#pragma unroll
  for (int i = 1; i < 7; ++i) {
    p = __fma_rn(p, x, kLog1pP[i]);
    q = __fma_rn(q, x, kLog1pQ[i]);
  }
  const double x2 = __dmul_rn(x, x);
  // XLA's inner sum -0.5 x^2 + x^3 P / Q is the same fused or not, since
  // -0.5 x^2 is exact: written unfused, as in the plain version.
  const double small =
      __dadd_rn(x, __dadd_rn(__dmul_rn(-0.5, x2), __dmul_rn(__dmul_rn(x, x2), __ddiv_rn(p, q))));
  return normal_of(erf_inv_first_range(-small), u);
}

// Class B, |x| >= sqrt(2) - 1: w = -log(1 + x) and erf_inv's first range,
// straight-line; class C, w >= 6.25, is taken by a branch.
__device__ __forceinline__ double normal_log(double u) {
  const double w = -log(__dadd_rn(log1p_arg(u), 1.0));
  double e = erf_inv_first_range(w);
  if (!(w < 6.25)) e = erf_inv_outer_ranges(w);
  return normal_of(e, u);
}

// One normal of the working type T for the counter of a draw.
template <typename T>
__device__ __forceinline__ T normal_draw(const uint32_t (&ks)[3], uint32_t counter);

template <>
__device__ __forceinline__ float normal_draw<float>(const uint32_t (&ks)[3], uint32_t counter) {
  return normal_from_bits(threefry_bits(ks, counter));
}

// 0 - y: the antithetic partner's state. The plain version computes the
// partner from -z on its own, so an exactly zero state (every sim's at step
// 0) is +0 there for both sims of a pair; -y would write -0.
__device__ __forceinline__ float mirrored(float y) { return __fsub_rn(0.0f, y); }
__device__ __forceinline__ double mirrored(double y) { return __dsub_rn(0.0, y); }

// Which sim a thread draws, and where it writes. Over the whole set
// (`window` false) thread t is sim t of the draw_sims drawn, and writes
// column t and, where it has one, its antithetic partner t + draw_sims of
// out [., F, num_sims]. In a window thread t is sim sim0 + t of the whole
// set and writes column t of out [., F, local]; a partner (sim >= draw_sims,
// antithetic mode only) takes the draw sim - draw_sims, negated.
struct SimSlot {
  uint32_t t;       // the thread's column in out and y0
  uint32_t draw;    // its draw's index in the draw block's sims
  bool negate;      // the draw is negated (a partner, in a window)
  bool mirror;      // the thread also writes column t + draw_sims (whole set)
  long long width;  // columns of out and y0
};

__device__ __forceinline__ SimSlot sim_slot(uint32_t t, bool window, long long num_sims,
                                            uint32_t draw_sims, long long sim0, long long local) {
  SimSlot slot;
  slot.t = t;
  if (window) {
    const long long s = sim0 + t;
    slot.negate = s >= draw_sims;
    slot.draw = (uint32_t)(slot.negate ? s - draw_sims : s);
    slot.mirror = false;
    slot.width = local;
  } else {
    slot.draw = t;
    slot.negate = false;
    slot.mirror = (long long)t + draw_sims < num_sims;
    slot.width = num_sims;
  }
  return slot;
}

// One state [F, width] written at dst: the thread's column and, where it
// has one, its partner's.
template <typename T, int kF>
__device__ __forceinline__ void store_state(T* __restrict__ dst, const T (&y)[kF],
                                            const SimSlot& slot, uint32_t draw_sims) {
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    dst[(size_t)f * slot.width + slot.t] = y[f];
    if (slot.mirror) dst[(size_t)f * slot.width + slot.t + draw_sims] = mirrored(y[f]);
  }
}

// kCheckpoints false: writes every step's state, out [num_steps, F, width].
// kCheckpoints true: writes only the state ENTERING local steps 0, every,
// 2 every, ... into out [ceil(num_steps / every), F, width] and stops at the
// last of them. Steps are absolute: local step i is step step0 + i of the
// horizon (step0 a multiple of kDrawBlock), which picks the block key and
// the coefficient row; y0 (null: zeros) is the state entering step0. Only
// y0[f, t] of the thread's own column is read: a partner's state is its
// negative. `threads` is draw_sims over the whole set, local in a window.
template <typename T, int kF, bool kCheckpoints>
__global__ void __launch_bounds__(kSimThreads)
    path_sim_kernel(const uint32_t* __restrict__ keys,  // [ceil(N / 16), 2] block keys, whole horizon
                    const T* __restrict__ coef,         // [N, F + F F] decay, then chol row-major
                    const T* __restrict__ y0,           // [F, width] or null
                    T* __restrict__ out, long long num_sims, uint32_t draw_sims, bool window,
                    long long sim0, uint32_t threads, int step0, int num_steps, int every) {
  const uint32_t t = blockIdx.x * (uint32_t)kSimThreads + threadIdx.x;
  if (t >= threads) return;
  const SimSlot slot = sim_slot(t, window, num_sims, draw_sims, sim0, threads);
  constexpr int kRow = kF + kF * kF;
  T y[kF];
#pragma unroll
  for (int f = 0; f < kF; ++f) y[f] = y0 != nullptr ? y0[(size_t)f * slot.width + t] : T(0);
  uint32_t ks[3] = {0u, 0u, 0u};
  // Checkpoint mode stops at the last checkpoint (a multiple of `every`,
  // written after the loop): the steps after it enter no state that is kept.
  const int last = kCheckpoints ? ((num_steps - 1) / every) * every : num_steps;
  int until_ckpt = 0;  // steps until the next checkpoint
  for (int i = 0; i < last; ++i) {
    if (kCheckpoints) {
      if (until_ckpt == 0) {
        store_state<T, kF>(out + (size_t)(i / every) * kF * slot.width, y, slot, draw_sims);
        until_ckpt = every;
      }
      --until_ckpt;
    }
    const int k = step0 + i;
    const int c = k % kDrawBlock;
    if (c == 0) {
      ks[0] = __ldg(keys + 2 * (k / kDrawBlock));
      ks[1] = __ldg(keys + 2 * (k / kDrawBlock) + 1);
      ks[2] = ks[0] ^ ks[1] ^ 0x1BD11BDAu;
    }
    T z[kF];
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      z[f] = normal_draw<T>(ks, (uint32_t)(c * kF + f) * draw_sims + slot.draw);
      if (slot.negate) z[f] = -z[f];
    }
    const T* row = coef + (size_t)k * kRow;
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      // XLA's fusion: inc = c0 z0, inc = fma(c_g, z_g, inc), y = fma(decay, y, inc).
      T inc = mul_rn(__ldg(row + kF + f * kF), z[0]);
#pragma unroll
      for (int g = 1; g < kF; ++g) inc = fma_rn(__ldg(row + kF + f * kF + g), z[g], inc);
      y[f] = fma_rn(__ldg(row + f), y[f], inc);
      if (!kCheckpoints) {
        T* dst = out + ((size_t)i * kF + f) * slot.width;
        dst[t] = y[f];
        if (slot.mirror) dst[(size_t)t + draw_sims] = mirrored(y[f]);
      }
    }
  }
  if (kCheckpoints) {
    store_state<T, kF>(out + (size_t)(last / every) * kF * slot.width, y, slot, draw_sims);
  }
}

// The float64 mode (see the head of this file): a warp draws the uniforms
// of kSteps steps before any OU update, sorts them by the normal map's
// branch, and maps each class in full-warp passes.
struct K3F64 {
  static constexpr int kThreads = 128;  // threads per block
  static constexpr int kSteps = 8;      // steps drawn per round (divides kDrawBlock)
};

// Shared memory per warp: the round's uniforms in class order (class A from
// the front, B and C from the back), mapped in place to normals, and each
// lane's position of its draw j in that order.
template <int kF>
struct F64Round {
  static constexpr int kCap = K3F64::kSteps * kF * kWarp;  // draws of a warp per round
  double val[kCap];
  uint16_t pos[kCap];  // [j][lane]
};

// Maps the n entries at val[first + dir * r], r = 0..n-1, of one class to
// normals in place, in full-warp passes of one entry a lane.
template <bool kRational>
__device__ __forceinline__ void map_class(double* val, int first, int dir, int n, int lane) {
  for (int r = lane; r - lane < n; r += kWarp) {
    if (r < n) {
      double* v = val + first + dir * r;
      *v = kRational ? normal_rational(*v) : normal_log(*v);
    }
  }
}

// The float64 path kernel: the modes, layouts, arguments and values of
// path_sim_kernel, one thread per column. Lanes past `threads` (the last
// warp) take part in every ballot and __syncwarp but draw nothing.
template <int kF, bool kCheckpoints>
__global__ void __launch_bounds__(K3F64::kThreads)
    path_sim_f64_kernel(const uint32_t* __restrict__ keys, const double* __restrict__ coef,
                        const double* __restrict__ y0, double* __restrict__ out,
                        long long num_sims, uint32_t draw_sims, bool window, long long sim0,
                        uint32_t threads, int step0, int num_steps, int every) {
  using Round = F64Round<kF>;
  __shared__ Round rounds[K3F64::kThreads / kWarp];  // static: no shared window base to rebuild
  const int lane = threadIdx.x % kWarp;
  Round& sh = rounds[threadIdx.x / kWarp];
  const uint32_t t = blockIdx.x * (uint32_t)K3F64::kThreads + threadIdx.x;
  if (t - lane >= threads) return;  // the whole warp lies past the sims
  const bool active = t < threads;
  const SimSlot slot = sim_slot(t, window, num_sims, draw_sims, sim0, threads);
  const bool mirror = active && slot.mirror;
  const unsigned lanes_below = (1u << lane) - 1u;
  const unsigned active_lanes = __ballot_sync(0xffffffffu, active);
  const int active_below = __popc(active_lanes & lanes_below), num_active = __popc(active_lanes);
  constexpr int kRow = kF + kF * kF;
  double y[kF];
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    y[f] = y0 != nullptr && active ? y0[(size_t)f * slot.width + t] : 0.0;
  }
  const int last = kCheckpoints ? ((num_steps - 1) / every) * every : num_steps;
  int until_ckpt = 0;
  for (int i0 = 0; i0 < last; i0 += K3F64::kSteps) {
    const int steps = min(K3F64::kSteps, last - i0);
    const int k0 = step0 + i0;  // a round lies in one draw block: kSteps divides 16
    uint32_t ks[3];
    ks[0] = __ldg(keys + 2 * (k0 / kDrawBlock));
    ks[1] = __ldg(keys + 2 * (k0 / kDrawBlock) + 1);
    ks[2] = ks[0] ^ ks[1] ^ 0x1BD11BDAu;
    // Draw: each lane hashes its own uniforms; one ballot a draw sorts the
    // warp's uniforms into the two lists.
    int num_rational = 0, num_log = 0;
    for (int c = 0; c < steps; ++c) {
#pragma unroll
      for (int f = 0; f < kF; ++f) {
        uint32_t o1, o2;
        threefry_words(ks, (uint32_t)((k0 % kDrawBlock + c) * kF + f) * draw_sims + slot.draw,
                       o1, o2);
        const double u = uniform_from_words(o1, o2);
        const bool rational = fabs(u) <= kRationalMaxU;
        const unsigned in_rational = __ballot_sync(0xffffffffu, active && rational);
        const int rank = __popc(in_rational & lanes_below), count = __popc(in_rational);
        const int e = rational ? num_rational + rank
                               : Round::kCap - 1 - num_log - (active_below - rank);
        if (active) {
          sh.val[e] = u;
          sh.pos[(c * kF + f) * kWarp + lane] = (uint16_t)e;
        }
        num_rational += count;
        num_log += num_active - count;
      }
    }
    __syncwarp();
    map_class<true>(sh.val, 0, 1, num_rational, lane);
    map_class<false>(sh.val, Round::kCap - 1, -1, num_log, lane);
    __syncwarp();
    if (active) {
      // Running pointers: the step's coefficient row, and the thread's
      // element of the step's state [F, width] in path mode.
      const double* row = coef + (size_t)(step0 + i0) * kRow;
      double* dst = out + (size_t)i0 * kF * slot.width + t;
      for (int c = 0; c < steps; ++c, row += kRow, dst += (size_t)kF * slot.width) {
        const int i = i0 + c;
        if (kCheckpoints) {
          if (until_ckpt == 0) {
            store_state<double, kF>(out + (size_t)(i / every) * kF * slot.width, y, slot,
                                    draw_sims);
            until_ckpt = every;
          }
          --until_ckpt;
        }
        double z[kF];
#pragma unroll
        for (int f = 0; f < kF; ++f) {
          z[f] = sh.val[sh.pos[(c * kF + f) * kWarp + lane]];
          if (slot.negate) z[f] = -z[f];
        }
#pragma unroll
        for (int f = 0; f < kF; ++f) {
          // XLA's fusion: inc = c0 z0, inc = fma(c_g, z_g, inc), y = fma(decay, y, inc).
          double inc = __dmul_rn(__ldg(row + kF + f * kF), z[0]);
#pragma unroll
          for (int g = 1; g < kF; ++g) inc = __fma_rn(__ldg(row + kF + f * kF + g), z[g], inc);
          y[f] = __fma_rn(__ldg(row + f), y[f], inc);
          if (!kCheckpoints) {
            dst[(size_t)f * slot.width] = y[f];
            if (mirror) dst[(size_t)f * slot.width + draw_sims] = mirrored(y[f]);
          }
        }
      }
    }
    __syncwarp();  // the next round overwrites the lists
  }
  if (kCheckpoints && active) {
    store_state<double, kF>(out + (size_t)(last / every) * kF * slot.width, y, slot, draw_sims);
  }
}

// The launch arguments every instantiation takes.
struct PathSimArgs {
  const uint32_t* keys;
  long long num_sims;
  uint32_t draw_sims;
  bool window;
  long long sim0;
  uint32_t threads;  // draw_sims over the whole set, the window's width in a window
  int step0, num_steps, every;
};

template <int kF, bool kCheckpoints>
static void launch_path_sim_f64(cudaStream_t st, const PathSimArgs& a, const double* coef,
                                const double* y0, double* out) {
  const unsigned blocks =
      (unsigned)(((long long)a.threads + K3F64::kThreads - 1) / K3F64::kThreads);
  path_sim_f64_kernel<kF, kCheckpoints><<<blocks, K3F64::kThreads, 0, st>>>(
      a.keys, coef, y0, out, a.num_sims, a.draw_sims, a.window, a.sim0, a.threads, a.step0,
      a.num_steps, a.every);
}

template <typename T, int kF>
static void launch_path_sim(cudaStream_t st, const PathSimArgs& a, const T* coef, const T* y0,
                            T* out) {
  const bool checkpoints = a.every > 0;
  if constexpr (std::is_same<T, double>::value) {
    if (checkpoints) {
      launch_path_sim_f64<kF, true>(st, a, coef, y0, out);
    } else {
      launch_path_sim_f64<kF, false>(st, a, coef, y0, out);
    }
  } else {
    const unsigned blocks = (unsigned)(((long long)a.threads + kSimThreads - 1) / kSimThreads);
    if (checkpoints) {
      path_sim_kernel<T, kF, true><<<blocks, kSimThreads, 0, st>>>(
          a.keys, coef, y0, out, a.num_sims, a.draw_sims, a.window, a.sim0, a.threads, a.step0,
          a.num_steps, a.every);
    } else {
      path_sim_kernel<T, kF, false><<<blocks, kSimThreads, 0, st>>>(
          a.keys, coef, y0, out, a.num_sims, a.draw_sims, a.window, a.sim0, a.threads, a.step0,
          a.num_steps, a.every);
    }
  }
}

template <typename T>
static int path_sim_launch_typed(const uint32_t* keys, const T* coef, const T* y0, T* out,
                                 long long num_sims, long long draw_sims, bool window,
                                 long long sim0, long long local_sims, int step0, int num_steps,
                                 int num_factors, int every, void* stream) {
  if (num_factors < 1 || num_factors > kMaxFactors || num_steps < 1 || draw_sims < 1 ||
      draw_sims > num_sims || num_sims > 2 * draw_sims || step0 < 0 ||
      step0 % kDrawBlock != 0 || every < 0 || every % kDrawBlock != 0 ||
      (long long)kDrawBlock * num_factors * draw_sims >= (1LL << 32) ||
      (window && (sim0 < 0 || local_sims < 1 || sim0 + local_sims > num_sims))) {
    return (int)cudaErrorInvalidValue;
  }
  const PathSimArgs a{keys, num_sims, (uint32_t)draw_sims, window, window ? sim0 : 0,
                      (uint32_t)(window ? local_sims : draw_sims), step0, num_steps, every};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (num_factors) {
    case 1: launch_path_sim<T, 1>(st, a, coef, y0, out); break;
    case 2: launch_path_sim<T, 2>(st, a, coef, y0, out); break;
    case 3: launch_path_sim<T, 3>(st, a, coef, y0, out); break;
    default: launch_path_sim<T, 4>(st, a, coef, y0, out); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace storage_kernels

using namespace storage_kernels;

// Launches path_sim_kernel on `stream` over the whole set: `draw_sims`
// threads, each writing sim s and, where s + draw_sims < num_sims, its
// antithetic partner. `keys` and `coef` cover the whole horizon; the launch
// runs steps [step0, step0 + num_steps) from the entering state `y0` (null:
// zeros). `every` == 0 writes the paths, out [num_steps, F, S]; `every` > 0
// (a multiple of 16) writes only the checkpoints, out [ceil(num_steps /
// every), F, S]. Returns the cudaError_t of the launch (0 on success).
extern "C" int path_sim_launch(const uint32_t* keys, const float* coef, const float* y0,
                               float* out, long long num_sims, long long draw_sims, int step0,
                               int num_steps, int num_factors, int every, void* stream) {
  return path_sim_launch_typed<float>(keys, coef, y0, out, num_sims, draw_sims, false, 0,
                                      num_sims, step0, num_steps, num_factors, every, stream);
}

// The same in float64: coef, y0 and out are double.
extern "C" int path_sim_f64_launch(const uint32_t* keys, const double* coef, const double* y0,
                                   double* out, long long num_sims, long long draw_sims,
                                   int step0, int num_steps, int num_factors, int every,
                                   void* stream) {
  return path_sim_launch_typed<double>(keys, coef, y0, out, num_sims, draw_sims, false, 0,
                                       num_sims, step0, num_steps, num_factors, every, stream);
}

// The window [sim0, sim0 + local_sims) of the set of num_sims: one thread a
// sim, y0 [F, local_sims] (or null) and out [., F, local_sims] holding only
// the window's columns; otherwise as path_sim_launch.
extern "C" int path_sim_window_launch(const uint32_t* keys, const float* coef, const float* y0,
                                      float* out, long long num_sims, long long draw_sims,
                                      long long sim0, long long local_sims, int step0,
                                      int num_steps, int num_factors, int every, void* stream) {
  return path_sim_launch_typed<float>(keys, coef, y0, out, num_sims, draw_sims, true, sim0,
                                      local_sims, step0, num_steps, num_factors, every, stream);
}

// The same in float64.
extern "C" int path_sim_f64_window_launch(const uint32_t* keys, const double* coef,
                                          const double* y0, double* out, long long num_sims,
                                          long long draw_sims, long long sim0,
                                          long long local_sims, int step0, int num_steps,
                                          int num_factors, int every, void* stream) {
  return path_sim_launch_typed<double>(keys, coef, y0, out, num_sims, draw_sims, true, sim0,
                                       local_sims, step0, num_steps, num_factors, every, stream);
}
