// The multi-factor path simulator: threefry2x32 draws, the bits-to-normal
// map and the exact OU update, fused into one kernel.
//
// Replaces storage_tpu/models/simulation.py::simulate_factor_paths (:264, its
// jitted body _simulate_factor_kernel): XLA code in the JAX package, not a
// Pallas kernel. Plain PyTorch version:
// storage_tpu_torch/models/simulation.py::simulate_factor_paths_reference.
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
// state is exactly -y (round-to-nearest is symmetric in sign): the thread
// of sim s writes both.
//
// Rounding. Every product and sum of the uniform map, the Horner steps and
// the OU update is rounded on its own (__fmul_rn / __fadd_rn: nvcc may not
// contract them into FMAs), in the order of the plain version's torch ops;
// log1pf and the IEEE square root are the functions torch's CUDA ops call.
// Polynomial coefficients are double literals cast to float, which is how
// the plain version's Python floats become float32. So the paths equal the
// plain version's on the same card bit for bit.
//
// What bounds it on the H100. The function's only necessary traffic is its
// output, written once: 4 B x n x F x S (4.09 GB at 341 x 3 x 1M: 1.22 ms
// at 3.35 TB/s). Per drawn element the hash is 72 integer operations (20
// rounds of add, rotate, xor; 11 key additions; the final xor) plus 3 for
// the counter and the mantissa, at the card's int32 rate (64 lanes per SM,
// half the float32 lane rate: 16.75e12 operations/s); 1.02e9 elements take
// 4.6 ms. The float work (the map, log1pf, the square root, 16 Horner
// operations, 2F + 1 for the OU update) is ~35 operations per element,
// 0.5 ms at 67 TFLOP/s, on another pipe. So integer operations bound it,
// not bytes.
//
// Design. One thread per drawn sim, looping over all n steps with y[F] in
// registers: no temporaries in device memory, no shared memory, no
// __syncthreads. F is a template parameter, so a step's F hashes are
// independent chains the scheduler interleaves. Arithmetic is native uint32
// (rotations are funnel shifts). The per-step coefficients (decay, chol:
// F + F F floats) and the block keys are read through the read-only cache
// at addresses uniform over the warp. Stores are coalesced along s.
#include "storage_kernels.cuh"

namespace storage_kernels {

constexpr int kDrawBlock = 16;   // steps per draw block (one key each)
constexpr int kSimThreads = 256;

__device__ __forceinline__ uint32_t rotl32(uint32_t v, int r) { return __funnelshift_l(v, v, r); }

// o1 ^ o2 of threefry2x32 (20 rounds) of the counter pair (0, counter)
// under the key schedule ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA).
__device__ __forceinline__ uint32_t threefry_bits(const uint32_t (&ks)[3], uint32_t counter) {
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
  return x0 ^ x1;
}

// XLA's float32 erf_inv (Giles), each step rounded like the torch version.
__device__ __forceinline__ float erf_inv_rn(float x) {
  float w = -log1pf(__fmul_rn(-x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = lt ? (float)2.81022636e-08 : (float)-0.000200214257;
#define STORAGE_ERFINV_STEP(c_lt, c_ge) \
  p = __fadd_rn(lt ? (float)(c_lt) : (float)(c_ge), __fmul_rn(p, w));
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

template <int kF>
__global__ void __launch_bounds__(kSimThreads)
    path_sim_kernel(const uint32_t* __restrict__ keys,  // [ceil(n / 16), 2] block keys
                    const float* __restrict__ coef,     // [n, F + F F] decay, then chol row-major
                    float* __restrict__ out,            // [n, F, S]
                    long long num_sims, uint32_t draw_sims, int num_steps) {
  const uint32_t s = blockIdx.x * (uint32_t)kSimThreads + threadIdx.x;
  if (s >= draw_sims) return;
  // The antithetic partner s + S' (draw_sims < num_sims only in that mode).
  const bool mirror = (long long)s + draw_sims < num_sims;
  constexpr int kRow = kF + kF * kF;
  float y[kF];
#pragma unroll
  for (int f = 0; f < kF; ++f) y[f] = 0.0f;
  uint32_t ks[3] = {0u, 0u, 0u};
  for (int k = 0; k < num_steps; ++k) {
    const int c = k % kDrawBlock;
    if (c == 0) {
      ks[0] = __ldg(keys + 2 * (k / kDrawBlock));
      ks[1] = __ldg(keys + 2 * (k / kDrawBlock) + 1);
      ks[2] = ks[0] ^ ks[1] ^ 0x1BD11BDAu;
    }
    float z[kF];
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      z[f] = normal_from_bits(threefry_bits(ks, (uint32_t)(c * kF + f) * draw_sims + s));
    }
    const float* row = coef + (size_t)k * kRow;
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      float inc = __fmul_rn(__ldg(row + kF + f * kF), z[0]);
#pragma unroll
      for (int g = 1; g < kF; ++g) {
        inc = __fadd_rn(inc, __fmul_rn(__ldg(row + kF + f * kF + g), z[g]));
      }
      y[f] = __fadd_rn(__fmul_rn(__ldg(row + f), y[f]), inc);
      float* dst = out + ((size_t)k * kF + f) * num_sims;
      dst[s] = y[f];
      if (mirror) dst[(size_t)s + draw_sims] = -y[f];
    }
  }
}

}  // namespace storage_kernels

using namespace storage_kernels;

// Launches path_sim_kernel on `stream`: `draw_sims` threads, each writing
// sim s and, where s + draw_sims < num_sims, its antithetic partner.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int path_sim_launch(const uint32_t* keys, const float* coef, float* out,
                               long long num_sims, long long draw_sims, int num_steps,
                               int num_factors, void* stream) {
  if (num_factors < 1 || num_factors > kMaxFactors || num_steps < 1 || draw_sims < 1 ||
      draw_sims > num_sims || num_sims > 2 * draw_sims ||
      (long long)kDrawBlock * num_factors * draw_sims >= (1LL << 32)) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned blocks = (unsigned)((draw_sims + kSimThreads - 1) / kSimThreads);
  const cudaStream_t st = (cudaStream_t)stream;
  const uint32_t ds = (uint32_t)draw_sims;
  switch (num_factors) {
    case 1: path_sim_kernel<1><<<blocks, kSimThreads, 0, st>>>(keys, coef, out, num_sims, ds, num_steps); break;
    case 2: path_sim_kernel<2><<<blocks, kSimThreads, 0, st>>>(keys, coef, out, num_sims, ds, num_steps); break;
    case 3: path_sim_kernel<3><<<blocks, kSimThreads, 0, st>>>(keys, coef, out, num_sims, ds, num_steps); break;
    default: path_sim_kernel<4><<<blocks, kSimThreads, 0, st>>>(keys, coef, out, num_sims, ds, num_steps); break;
  }
  return (int)cudaGetLastError();
}
