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
// float32 either way.
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
// not bytes. The checkpoint pass does the same operations and writes 1 / every
// of the bytes.
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

// 0 - y: the antithetic partner's state. The plain version computes the
// partner from -z on its own, so an exactly zero state (every sim's at step
// 0) is +0 there for both sims of a pair; -y would write -0.
__device__ __forceinline__ float mirrored(float y) { return __fsub_rn(0.0f, y); }

// One state [F, S] written at dst: sim s and, where it has one, its partner.
template <int kF>
__device__ __forceinline__ void store_state(float* __restrict__ dst, const float (&y)[kF],
                                            long long num_sims, uint32_t s, uint32_t draw_sims,
                                            bool mirror) {
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    dst[(size_t)f * num_sims + s] = y[f];
    if (mirror) dst[(size_t)f * num_sims + s + draw_sims] = mirrored(y[f]);
  }
}

// kCheckpoints false: writes every step's state, out [num_steps, F, S].
// kCheckpoints true: writes only the state ENTERING local steps 0, every,
// 2 every, ... into out [ceil(num_steps / every), F, S] and stops at the last
// of them. Steps are absolute: local step i is step step0 + i of the horizon
// (step0 a multiple of kDrawBlock), which picks the block key and the
// coefficient row; y0 (null: zeros) is the state entering step0. Only
// y0[f, s] of the drawn sims is read: the partner's state is its negative.
template <int kF, bool kCheckpoints>
__global__ void __launch_bounds__(kSimThreads)
    path_sim_kernel(const uint32_t* __restrict__ keys,  // [ceil(N / 16), 2] block keys, whole horizon
                    const float* __restrict__ coef,     // [N, F + F F] decay, then chol row-major
                    const float* __restrict__ y0,       // [F, S] or null
                    float* __restrict__ out, long long num_sims, uint32_t draw_sims, int step0,
                    int num_steps, int every) {
  const uint32_t s = blockIdx.x * (uint32_t)kSimThreads + threadIdx.x;
  if (s >= draw_sims) return;
  // The antithetic partner s + S' (draw_sims < num_sims only in that mode).
  const bool mirror = (long long)s + draw_sims < num_sims;
  constexpr int kRow = kF + kF * kF;
  float y[kF];
#pragma unroll
  for (int f = 0; f < kF; ++f) y[f] = y0 != nullptr ? y0[(size_t)f * num_sims + s] : 0.0f;
  uint32_t ks[3] = {0u, 0u, 0u};
  // Checkpoint mode stops at the last checkpoint (a multiple of `every`,
  // written after the loop): the steps after it enter no state that is kept.
  const int last = kCheckpoints ? ((num_steps - 1) / every) * every : num_steps;
  int until_ckpt = 0;  // steps until the next checkpoint
  for (int i = 0; i < last; ++i) {
    if (kCheckpoints) {
      if (until_ckpt == 0) {
        store_state<kF>(out + (size_t)(i / every) * kF * num_sims, y, num_sims, s, draw_sims,
                        mirror);
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
      if (!kCheckpoints) {
        float* dst = out + ((size_t)i * kF + f) * num_sims;
        dst[s] = y[f];
        if (mirror) dst[(size_t)s + draw_sims] = mirrored(y[f]);
      }
    }
  }
  if (kCheckpoints) {
    store_state<kF>(out + (size_t)(last / every) * kF * num_sims, y, num_sims, s, draw_sims,
                    mirror);
  }
}

template <int kF>
static void launch_path_sim(bool checkpoints, unsigned blocks, cudaStream_t st,
                            const uint32_t* keys, const float* coef, const float* y0, float* out,
                            long long num_sims, uint32_t draw_sims, int step0, int num_steps,
                            int every) {
  if (checkpoints) {
    path_sim_kernel<kF, true><<<blocks, kSimThreads, 0, st>>>(keys, coef, y0, out, num_sims,
                                                              draw_sims, step0, num_steps, every);
  } else {
    path_sim_kernel<kF, false><<<blocks, kSimThreads, 0, st>>>(keys, coef, y0, out, num_sims,
                                                               draw_sims, step0, num_steps, every);
  }
}

}  // namespace storage_kernels

using namespace storage_kernels;

// Launches path_sim_kernel on `stream`: `draw_sims` threads, each writing
// sim s and, where s + draw_sims < num_sims, its antithetic partner.
// `keys` and `coef` cover the whole horizon; the launch runs steps
// [step0, step0 + num_steps) from the entering state `y0` (null: zeros).
// `every` == 0 writes the paths, out [num_steps, F, S]; `every` > 0 (a
// multiple of 16) writes only the checkpoints, out [ceil(num_steps / every),
// F, S]. Returns the cudaError_t of the launch (0 on success).
extern "C" int path_sim_launch(const uint32_t* keys, const float* coef, const float* y0,
                               float* out, long long num_sims, long long draw_sims, int step0,
                               int num_steps, int num_factors, int every, void* stream) {
  if (num_factors < 1 || num_factors > kMaxFactors || num_steps < 1 || draw_sims < 1 ||
      draw_sims > num_sims || num_sims > 2 * draw_sims || step0 < 0 ||
      step0 % kDrawBlock != 0 || every < 0 || every % kDrawBlock != 0 ||
      (long long)kDrawBlock * num_factors * draw_sims >= (1LL << 32)) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned blocks = (unsigned)((draw_sims + kSimThreads - 1) / kSimThreads);
  const cudaStream_t st = (cudaStream_t)stream;
  const uint32_t ds = (uint32_t)draw_sims;
  const bool ck = every > 0;
  switch (num_factors) {
    case 1: launch_path_sim<1>(ck, blocks, st, keys, coef, y0, out, num_sims, ds, step0, num_steps, every); break;
    case 2: launch_path_sim<2>(ck, blocks, st, keys, coef, y0, out, num_sims, ds, step0, num_steps, every); break;
    case 3: launch_path_sim<3>(ck, blocks, st, keys, coef, y0, out, num_sims, ds, step0, num_steps, every); break;
    default: launch_path_sim<4>(ck, blocks, st, keys, coef, y0, out, num_sims, ds, step0, num_steps, every); break;
  }
  return (int)cudaGetLastError();
}
