// One backward LSMC period: the value-surface update and the regression
// partials of the period before it.
//
// Replaces the TPU kernel storage_tpu/ops/pallas_backward.py::_backward_kernel
// (body _backward_tile). Plain PyTorch version:
// storage_tpu_torch/ops/backward.py::backward_update_reference.
//
// What it computes. V is held [G, S] with sims contiguous. For each sim, grid
// point g and decision d:
//   fitted_dg = table[d,g,:B] . xn + table[d,g,B] + table[d,g,B+1] * spot
//   actual_dg = (1-w) (V[j] - vbar[j]) + w (V[j+1] - vbar[j+1])
//               + table[d,g,B] + table[d,g,B+1] * spot
// with (j, w) = geometry[d, g]; the first-occurrence argmax over d of the
// fitted totals picks the actual total written to V_out[g]. The table folds
// the interpolation through the regression coefficients, so the fitted
// continuation costs B multiply-adds per (g, d). Second output: the previous
// period's design row xr [B+1] (standardized with this period's (mu, sd), a
// trailing ones row) contracted with itself (graw [B+1, B+1]) and with the
// centred new surface vc = V_out - vbar (praw [B+1, G]).
//
// What bounds it on the H100. Per launch it must read V_next and write V_out
// (2 x 4 B x G x S = 800 MB at 1M sims, G = 100) and read the two factor
// rows (24 MB): 0.246 ms at 3.35 TB/s. Its arithmetic per sim is D G (2B + 3)
// flops for the fitted totals, 10 G for the winning decision's actual total
// and its centred value, and 2 (B+1)(G + B+1) for the partials: 10.3 GFLOP
// at D = 3 and 14.9 GFLOP at D = 5 (B = 10), 0.154 and 0.223 ms at 67 TFLOP/s
// float32. So the bytes bound it at both. The tensor cores are not used:
// the only product (praw) is a fifth of the flops at D = 3, and TF32's
// 10-bit mantissa is too coarse for partials whose Gram has a condition
// number up to 3e6 and for fitted totals that decide an argmax.
//
// Design:
// - One sim per thread, 128 threads per block. A persistent grid
//   (blocks per SM from the occupancy calculator, times the SM count, at
//   most one block per 128-sim tile) walks the tiles; each block keeps its
//   partials across its tiles and writes one [B+1, G + B+1] partial (praw
//   columns, then graw columns), which the wrapper sums over blocks in a
//   fixed order. __launch_bounds__(128, 7) holds a thread to 73 registers so
//   that seven blocks (28 warps) share an SM: the kernel is bound by latency
//   (the fitted totals' FMA chains and the V_next reads), and the measured
//   time falls from 2.2 ms at two resident blocks to 1.2 ms at seven.
// - G is walked in chunks of kChunk = 16 grid points. A chunk's table rows
//   (B weights, affine, price), w and j are copied into shared memory with
//   cp.async, double-buffered: the next work item's (tile, chunk) copies are
//   in flight while this one decides. Its per-entry constants (vbar[j],
//   vbar[j+1], w, 1 - w, affine, price, j, j + 1) are derived once per entry
//   while the last item's product runs. Shared memory is sized by D, B and
//   kChunk, never by G, so any grid the JAX package values launches.
// - Fitted totals: one FMA chain per (sim, d) over the extended row
//   (xn, 1, spot) against (weights, affine, price), read as float4
//   broadcasts (rows zero-padded to a multiple of four floats in shared
//   memory). The decision loop is unrolled by three (kDUnroll) so the
//   chains of consecutive decisions interleave.
// - Actual totals: only the winning decision's, so V_next is read twice per
//   sim and grid point whatever D, through L1 (__ldg); the two reads are
//   issued at grid point g and used at g + kLookahead (2), after the fitted
//   totals in between. Staging the rows in shared memory instead (a chunk's
//   row span by cp.async, or a per-thread ring of rows) was measured slower:
//   it costs resident blocks.
// - Cross partials: a block-level product from shared memory, with no warp
//   shuffles. The decision pass writes vc into a [kChunk, 128] tile; each
//   thread owns (grid point, basis row) entries of praw and sums
//   xr[a, s] vc[g, s] over the tile's sims with float32 FMAs in four chains
//   (s mod 4), float4 reads, rows padded by 4 floats against bank conflicts.
//   graw is summed the same way from the xr tile once per tile. Each entry
//   has one owner thread and a fixed order, so the result is bit-identical
//   from run to run; there are no float atomics.
// - Rounding: both totals are written out with __fmaf_rn / __fadd_rn, so
//   that unrolling or register pressure cannot change how they round:
//   fitted = fma(price, spot, dot + affine), the dot an FMA chain in b order;
//   actual = fma(price, spot, fma(v1, w, v0 (1 - w)) + affine).
//   torch rounds every product and sum separately, so near-tie decisions
//   may flip against the plain version; chip_smoke counts them.
//
// Shared memory per block, in bytes, with NQ = max(3, ceil((B + 2) / 4)):
//   4 [2 D kChunk (4 NQ + 10) + (B + 1 + kChunk)(128 + 4)]
// (D = 3, B = 10: 22,704 B; D = 5: 28,336 B.) V_out is a separate buffer: a
// chunk reads rows of V_next outside itself.
#include "storage_kernels.cuh"

namespace storage_kernels {

constexpr int kThreads = 128;                // threads per block = sims per tile
constexpr int kChunk = 16;                   // grid points per chunk
constexpr int kDUnroll = 3;                  // decisions evaluated together
constexpr int kLookahead = 2;                // grid points a V_next read is issued ahead
constexpr int kMinBlocks = 7;                // resident blocks per SM the registers allow
constexpr int kPitch = kThreads + 4;         // row pitch of the xr and vc tiles (floats)
constexpr int kAGroups = kThreads / kChunk;  // basis-row groups of the praw product
constexpr int kAPerThread = (kMaxBasis + 1 + kAGroups - 1) / kAGroups;
static_assert(kThreads % kChunk == 0, "a chunk must divide the block");
static_assert(kMaxBasis + 2 <= 20, "a fitted row is at most five float4s");

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

struct Operands {
  const float* f_cur;   // [F, S] factors of this period
  const float* f_prev;  // [F, S] factors of the previous period
  const float* v_next;  // [G, S] next-period values
  float* v_out;         // [G, S] this-period values
  const float* table;   // [D, G, B+2] fitted tables + affine columns
  const float* vbar;    // [G] sim-mean of v_next
  const float* musd;    // [2, B] standardization mean / scale
  const int* geom_j;    // [D, G] lower interpolation index
  const float* geom_w;  // [D, G] upper interpolation weight
  const float* scal;    // [2, 1+F] (drift, vols) this / previous period
  float* part;          // [nblk, B+1, G + B+1] per-block (praw | graw)
  long long num_sims;   // S < 2^30
  unsigned row_bytes;   // 4 S: bytes from one V row to the next
  int num_grid;
  int num_decisions;
};

// Shared buffers of one stage: one work item's (tile, chunk) copies, and
// the per-(decision, grid point) constants derived from them.
struct Stage {
  float* tab;   // [D kChunk, 4 NQ] table rows (B weights, affine, price), zero-padded
  float* raw;   // [D kChunk, 2] (w, j) as copied
  float4* dec;  // [D kChunk, 2] (vbar[j], vbar[j+1], w, 1 - w), (affine, price, j, j + 1)
};

__host__ __device__ constexpr int stage_floats(int dc, int nq) { return dc * (4 * nq + 10); }

// Stage k (0 or 1); the two stages lead the shared memory.
__device__ __forceinline__ Stage stage_at(float* smem, int k, int DC, int NQ) {
  Stage st;
  st.tab = smem + k * stage_floats(DC, NQ);
  st.raw = st.tab + DC * 4 * NQ;
  st.dec = reinterpret_cast<float4*>(st.raw + 2 * DC);
  return st;
}

// Start the asynchronous copies of chunk c's table rows, w and j into stage
// st (one commit group).
template <int kNQ>
__device__ __forceinline__ void issue_copies(const Operands& op, const Stage& st, int B, int c) {
  const int G = op.num_grid;
  const int g0 = c * kChunk;
  const int gcount = min(kChunk, G - g0);
  for (int e = threadIdx.x; e < op.num_decisions * kChunk; e += kThreads) {
    const int d = e / kChunk;
    const int gl = e % kChunk;
    if (gl < gcount) {
      const size_t dg = (size_t)d * G + g0 + gl;
      const float* row = op.table + dg * (B + 2);
      float* dst = st.tab + e * 4 * kNQ;
      for (int b = 0; b < B + 2; ++b) cp_async4(dst + b, row + b);
      for (int b = B + 2; b < 4 * kNQ; ++b) dst[b] = 0.0f;
      cp_async4(st.raw + 2 * e, op.geom_w + dg);
      cp_async4(st.raw + 2 * e + 1, op.geom_j + dg);
    }
  }
  cp_async_commit();
}

// The per-(decision, grid point) constants of chunk c from its landed copies.
template <int kNQ>
__device__ __forceinline__ void prepare_stage(const Operands& op, const Stage& st, int B, int c) {
  const int gcount = min(kChunk, op.num_grid - c * kChunk);
  for (int e = threadIdx.x; e < op.num_decisions * kChunk; e += kThreads) {
    if (e % kChunk < gcount) {
      const float w = st.raw[2 * e];
      const int j = __float_as_int(st.raw[2 * e + 1]);
      const float* row = st.tab + e * 4 * kNQ;
      st.dec[2 * e] = make_float4(__ldg(op.vbar + j), __ldg(op.vbar + j + 1), w,
                                  __fsub_rn(1.0f, w));
      st.dec[2 * e + 1] = make_float4(row[B], row[B + 1], __int_as_float(j),
                                      __int_as_float(j + 1));
    }
  }
}

// The decisions of one chunk for this thread's sim: best_act for each grid
// point into V_out and, centred, into the vc tile. The fitted total of every
// decision is one FMA chain over the extended row (xn, 1, spot) against
// (weights, affine, price). Only the winning decision's actual total is
// computed, so V_next is read twice per sim and grid point, whatever D; the
// winner's two reads are issued at grid point g and used at g + kLookahead,
// after the fitted totals in between, which hides their latency. A sim past
// the last one reads sim 0's column (vcol) and writes nothing but a zero vc.
template <int kNQ>
__device__ __forceinline__ void decide_chunk(const Operands& op, const Stage& st,
                                             const float (&xn)[4 * kNQ], float spot, bool valid,
                                             long long s, const char* vcol, int g0, int gcount,
                                             float* s_vc) {
  const int tid = threadIdx.x;
  // The reads in flight: stage a holds grid point gl - kLookahead + a's
  // winning entry and its two V_next values.
  int pe[kLookahead];
  float pr0[kLookahead], pr1[kLookahead];
  for (int gl = 0; gl < gcount + kLookahead; ++gl) {
    int ne;
    float nr0, nr1;
    if (gl < gcount) {
      float best_fit = 0.0f;
      ne = gl;
#pragma unroll kDUnroll
      for (int d = 0; d < op.num_decisions; ++d) {
        const int e = d * kChunk + gl;
        const float4* T = reinterpret_cast<const float4*>(st.tab + e * 4 * kNQ);
        float fit = 0.0f;
#pragma unroll
        for (int q = 0; q < kNQ; ++q) {
          const float4 t = T[q];
          fit = __fmaf_rn(t.x, xn[4 * q], fit);
          fit = __fmaf_rn(t.y, xn[4 * q + 1], fit);
          fit = __fmaf_rn(t.z, xn[4 * q + 2], fit);
          fit = __fmaf_rn(t.w, xn[4 * q + 3], fit);
        }
        // Decision 0 seeds unconditionally; later ones replace it only when
        // strictly better (first-occurrence argmax).
        if (d == 0 || fit > best_fit) {
          best_fit = fit;
          ne = e;
        }
      }
      const float4 k1 = st.dec[2 * ne + 1];  // affine, price, j, j + 1
      nr0 = __ldg(reinterpret_cast<const float*>(vcol + (size_t)__float_as_uint(k1.z) *
                                                            op.row_bytes));
      nr1 = __ldg(reinterpret_cast<const float*>(vcol + (size_t)__float_as_uint(k1.w) *
                                                            op.row_bytes));
    }
    if (gl >= kLookahead) {  // the actual total of grid point gl - kLookahead
      const int g = g0 + gl - kLookahead;
      const float vb = __ldg(op.vbar + g);
      const float4 k0 = st.dec[2 * pe[0]];      // vbar[j], vbar[j+1], w, 1 - w
      const float4 k1 = st.dec[2 * pe[0] + 1];  // affine, price, j, j + 1
      const float v0 = __fsub_rn(pr0[0], k0.x);
      const float v1 = __fsub_rn(pr1[0], k0.y);
      const float lin = __fmaf_rn(v1, k0.z, __fmul_rn(v0, k0.w));
      const float act = __fmaf_rn(k1.y, spot, __fadd_rn(lin, k1.x));
      if (valid) op.v_out[(size_t)g * op.num_sims + s] = act;
      s_vc[(g - g0) * kPitch + tid] = valid ? __fsub_rn(act, vb) : 0.0f;
    }
#pragma unroll
    for (int a = 0; a < kLookahead; ++a) {
      pe[a] = a + 1 < kLookahead ? pe[a + 1] : ne;
      pr0[a] = a + 1 < kLookahead ? pr0[a + 1] : nr0;
      pr1[a] = a + 1 < kLookahead ? pr1[a + 1] : nr1;
    }
  }
}

template <int kNQ>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    backward_update_kernel(Operands op, BasisDesc bd) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int B = bd.num_basis;
  const int F = bd.num_factors;
  const int B1 = B + 1;
  const int G = op.num_grid;
  const int DC = op.num_decisions * kChunk;
  const long long S = op.num_sims;

  float* s_xr = smem + 2 * stage_floats(DC, kNQ);  // [B1, kPitch] previous period's design rows
  float* s_vc = s_xr + B1 * kPitch;                 // [kChunk, kPitch] centred new values

  const int nchunks = (G + kChunk - 1) / kChunk;
  const long long ntiles = (S + kThreads - 1) / kThreads;
  const long long my_tiles = (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const long long nitems = my_tiles * nchunks;
  const int part_row = G + B1;
  float* my_part = op.part + (size_t)blockIdx.x * B1 * part_row;

  // Pipeline: item it + 1's copies are in flight during item it's decisions,
  // and its constants are prepared during item it's product.
  issue_copies<kNQ>(op, stage_at(smem, 0, DC, kNQ), B, 0);
  cp_async_wait_all();
  __syncthreads();
  prepare_stage<kNQ>(op, stage_at(smem, 0, DC, kNQ), B, 0);

  float xn[4 * kNQ];  // (standardized design row, 1, spot, 0...) of this thread's sim
  float spot = 0.0f;
  bool valid = false;
  long long s = 0;
  const char* vcol = nullptr;  // the sim's V_next column (sim 0's past the last sim)
  const int pg = tid % kChunk;  // praw product: this thread's grid point in the chunk
  const int ag = tid / kChunk;  // and its basis rows ag, ag + kAGroups, ...

  for (long long it = 0; it < nitems; ++it) {
    const int buf = (int)(it & 1);
    const long long tile = blockIdx.x + (it / nchunks) * gridDim.x;
    const int c = (int)(it % nchunks);
    const int c1 = (int)((it + 1) % nchunks);
    const bool more = it + 1 < nitems;
    if (more) issue_copies<kNQ>(op, stage_at(smem, buf ^ 1, DC, kNQ), B, c1);
    __syncthreads();  // this item's constants are ready; the last product's reads are done

    if (c == 0) {  // a new tile: its sim's design rows
      s = tile * kThreads + tid;
      valid = s < S;
      vcol = reinterpret_cast<const char*>(op.v_next + (valid ? s : 0));
      float xr[kMaxBasis + 1];
      float xfull[kMaxBasis];
      spot = 0.0f;
#pragma unroll
      for (int b = 0; b < kMaxBasis; ++b) xfull[b] = 0.0f;
#pragma unroll
      for (int b = 0; b <= kMaxBasis; ++b) xr[b] = 0.0f;
      if (valid) {
        float fc[kMaxFactors], fp[kMaxFactors];
#pragma unroll
        for (int f = 0; f < kMaxFactors; ++f) {
          if (f < F) {
            fc[f] = op.f_cur[(size_t)f * S + s];
            fp[f] = op.f_prev[(size_t)f * S + s];
          }
        }
        spot = spot_of(op.scal, fc, F);
        design_row(bd, spot, fc, xfull);
        const float spot_prev = spot_of(op.scal + 1 + F, fp, F);
        design_row(bd, spot_prev, fp, xr);
#pragma unroll
        for (int b = 0; b < kMaxBasis; ++b) {
          if (b < B) {
            xfull[b] = (xfull[b] - op.musd[b]) / op.musd[B + b];
            xr[b] = (xr[b] - op.musd[b]) / op.musd[B + b];
          }
        }
#pragma unroll
        for (int b = 0; b <= kMaxBasis; ++b) {
          if (b == B) xr[b] = 1.0f;
        }
      }
#pragma unroll
      for (int b = 0; b < 4 * kNQ; ++b) {
        xn[b] = b < kMaxBasis && b < B ? xfull[b < kMaxBasis ? b : 0]
                : b == B               ? 1.0f
                : b == B + 1           ? spot
                                       : 0.0f;
      }
#pragma unroll
      for (int b = 0; b <= kMaxBasis; ++b) {
        if (b < B1) s_xr[b * kPitch + tid] = xr[b];
      }
    }

    const int g0 = c * kChunk;
    const int gcount = min(kChunk, G - g0);
    decide_chunk<kNQ>(op, stage_at(smem, buf, DC, kNQ), xn, spot, valid, s, vcol, g0, gcount,
                      s_vc);
    cp_async_wait_all();
    __syncthreads();  // the vc tile is complete; the next item's copies have landed
    if (more) prepare_stage<kNQ>(op, stage_at(smem, buf ^ 1, DC, kNQ), B, c1);

    // praw[a, chunk] += xr[a, tile] . vc[chunk, tile], in a fixed order.
    const bool first_tile = it < nchunks;
    float acc[kAPerThread][4];  // four chains (sims s = 0, 1, 2, 3 mod 4) per entry
#pragma unroll
    for (int k = 0; k < kAPerThread; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.0f;
#pragma unroll 4
    for (int s4 = 0; s4 < kThreads; s4 += 4) {
      const float4 v = *reinterpret_cast<const float4*>(s_vc + pg * kPitch + s4);
#pragma unroll
      for (int k = 0; k < kAPerThread; ++k) {
        const int a = ag + k * kAGroups;
        if (a < B1) {
          const float4 x = *reinterpret_cast<const float4*>(s_xr + a * kPitch + s4);
          acc[k][0] = acc[k][0] + x.x * v.x;
          acc[k][1] = acc[k][1] + x.y * v.y;
          acc[k][2] = acc[k][2] + x.z * v.z;
          acc[k][3] = acc[k][3] + x.w * v.w;
        }
      }
    }
    if (pg < gcount) {
#pragma unroll
      for (int k = 0; k < kAPerThread; ++k) {
        const int a = ag + k * kAGroups;
        if (a < B1) {
          float* out = my_part + a * part_row + g0 + pg;
          const float tile_sum = (acc[k][0] + acc[k][1]) + (acc[k][2] + acc[k][3]);
          *out = first_tile ? tile_sum : *out + tile_sum;
        }
      }
    }
    if (c == 0) {  // graw += xr[:, tile] xr[:, tile]', once per tile
      for (int e = tid; e < B1 * B1; e += kThreads) {
        const int a = e / B1;
        const int b = e - a * B1;
        float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int s4 = 0; s4 < kThreads; s4 += 4) {
          const float4 x = *reinterpret_cast<const float4*>(s_xr + a * kPitch + s4);
          const float4 y = *reinterpret_cast<const float4*>(s_xr + b * kPitch + s4);
          sum[0] = sum[0] + x.x * y.x;
          sum[1] = sum[1] + x.y * y.y;
          sum[2] = sum[2] + x.z * y.z;
          sum[3] = sum[3] + x.w * y.w;
        }
        float* out = my_part + a * part_row + G + b;
        const float tile_sum = (sum[0] + sum[1]) + (sum[2] + sum[3]);
        *out = first_tile ? tile_sum : *out + tile_sum;
      }
    }
  }
}

using KernelFn = void (*)(Operands, BasisDesc);

// A fitted row (B weights, affine, price) is read as ceil((B + 2) / 4)
// float4s, zero-padded: three for B <= 10, four for B <= 14, five beyond.
int quads_of(int num_basis) { return (num_basis + 2 + 3) / 4 < 3 ? 3 : (num_basis + 2 + 3) / 4; }

KernelFn kernel_for(int num_basis) {
  switch (quads_of(num_basis)) {
    case 3: return backward_update_kernel<3>;
    case 4: return backward_update_kernel<4>;
    default: return backward_update_kernel<5>;
  }
}

size_t smem_bytes(int num_decisions, int num_basis) {
  return sizeof(float) *
         (2 * (size_t)stage_floats(num_decisions * kChunk, quads_of(num_basis)) +
          (size_t)(num_basis + 1 + kChunk) * kPitch);
}

bool valid_shape(long long num_sims, int num_decisions, int num_basis, int num_factors) {
  return num_sims >= 1 && num_sims < (1LL << 30) && num_basis >= 1 && num_basis <= kMaxBasis &&
         num_factors >= 1 && num_factors <= kMaxFactors && num_decisions >= 1;
}

// Sets the kernel's dynamic shared memory and returns its persistent grid
// (blocks per SM from the occupancy calculator x SMs, at most one per tile).
cudaError_t persistent_grid(long long num_sims, int num_decisions, int num_basis,
                            int* num_blocks) {
  const KernelFn fn = kernel_for(num_basis);
  const size_t smem = smem_bytes(num_decisions, num_basis);
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return err;
  }
  const long long ntiles = (num_sims + kThreads - 1) / kThreads;
  const long long grid = (long long)per_sm * sms;
  *num_blocks = (int)(ntiles < grid ? ntiles : grid);
  return cudaSuccess;
}

}  // namespace storage_kernels

using namespace storage_kernels;

// The number of blocks (= partials) backward_update_launch takes for these
// shapes on the current device, or minus a cudaError_t.
extern "C" int backward_update_blocks(long long num_sims, int num_decisions, int num_basis) {
  if (!valid_shape(num_sims, num_decisions, num_basis, 1)) return -(int)cudaErrorInvalidValue;
  int nblk = 0;
  const cudaError_t err = persistent_grid(num_sims, num_decisions, num_basis, &nblk);
  return err == cudaSuccess ? nblk : -(int)err;
}

// Launches backward_update_kernel on `stream` with `num_blocks` blocks (from
// backward_update_blocks) writing partials [num_blocks, B+1, G + B+1];
// returns the cudaError_t of the launch (0 on success). Pointers are device
// pointers except spot_pow / fac_pow ([B] and [B, F] ints on the host).
extern "C" int backward_update_launch(
    const float* f_cur, const float* f_prev, const float* v_next, float* v_out,
    const float* table, const float* vbar, const float* musd, const int* geom_j,
    const float* geom_w, const float* scal, float* partials, long long num_sims, int num_grid,
    int num_decisions, int num_basis, int num_factors, const int* spot_pow, const int* fac_pow,
    int num_blocks, void* stream) {
  if (!valid_shape(num_sims, num_decisions, num_basis, num_factors) || num_grid < 2 ||
      num_blocks < 1 || num_blocks > (num_sims + kThreads - 1) / kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const BasisDesc bd = make_basis_desc(num_basis, num_factors, spot_pow, fac_pow);
  const Operands op = {f_cur, f_prev, v_next, v_out, table, vbar, musd, geom_j, geom_w, scal,
                       partials, num_sims, (unsigned)(4 * num_sims), num_grid, num_decisions};
  const KernelFn fn = kernel_for(num_basis);
  const size_t smem = smem_bytes(num_decisions, num_basis);
  const cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {const_cast<Operands*>(&op), const_cast<BasisDesc*>(&bd)};
  return (int)cudaLaunchKernel(reinterpret_cast<const void*>(fn), dim3(num_blocks),
                               dim3(kThreads), args, smem, (cudaStream_t)stream);
}
