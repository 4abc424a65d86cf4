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
// float32. So the bytes bound it at both. The tensor cores are not used in
// float32: the only product (praw) is a fifth of the flops at D = 3, and
// TF32's 10-bit mantissa is too coarse for partials whose Gram has a
// condition number up to 3e6 and for fitted totals that decide an argmax.
// In float64 the bytes double (1.6 GB: 0.492 ms with the factor rows) and
// the same 10.3 GFLOP take 0.30 ms at the 34 TFLOP/s of float64 outside the
// tensor cores: the bytes bound it too.
//
// One source, two instantiations: K1Traits<T> holds what differs between
// float and double (chunk, lookahead, resident blocks, the actual total's
// rounding, the partials' product); Elem<T> (storage_kernels.cuh) the
// vectors. A quad of four elements is one float4 or two double2 reads, so
// the float32 design below reads the same in double. The float32 machine
// code is its pre-template parent's, instruction for instruction
// (tools/kernel_turns.py --sass).
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
// Float64 (K1Traits<double>), the same design with these differences:
// - Four resident blocks (128 registers): measured against five and six
//   (96 and 80 registers, which spill 268 B and 804 B) and against 8-point
//   chunks (PERF.md): the kernel is held up by its fitted totals (table
//   reads and FMA chains) more than by occupancy.
// - The partials' product runs on the FP64 tensor cores (mma.m8n8k4.f64,
//   IEEE double products and sums): one 8 x 8 tile of praw (graw once a
//   tile) per warp, over the tile's 128 sims in four chains, each entry
//   written by one lane in a fixed order. TF32's objection does not apply.
// - The winner's actual total is rounded as torch rounds it,
//   ((v0 (1 - w) + v1 w) + affine) + price spot, and so are the design rows
//   and the spot, so a V entry whose decision does not flip is the plain
//   version's bit for bit.
// - Tile rows are padded by two doubles (16 bytes) instead of four floats;
//   table rows, w and j are copied by 8- and 4-byte cp.async; j rides in
//   the low word of a double of the per-entry constants.
//
// Shared memory per block, in bytes, with NQ = max(3, ceil((B + 2) / 4)):
//   sizeof(T) [2 D kChunk (4 NQ + 10) + (B + 1 + kChunk)(128 + 16 / sizeof(T))]
// (float32, D = 3, B = 10: 22,704 B; D = 5: 28,336 B; float64, D = 3:
// 44,976 B.) V_out is a separate buffer: a chunk reads rows of V_next
// outside itself.
#include "storage_kernels.cuh"

namespace storage_kernels {

constexpr int kThreads = 128;  // threads per block = sims per tile

// The constants of each instantiation, and how it rounds the winner's actual
// total (see the head of this file).
template <class T> struct K1Traits;

template <>
struct K1Traits<float> {
  using Round = Contract;           // the design rows and the spot
  static constexpr bool kTensorCores = false;  // the partials' product
  static constexpr int kChunk = 16;      // grid points per chunk
  static constexpr int kDUnroll = 3;     // decisions evaluated together
  static constexpr int kLookahead = 2;   // grid points a V_next read is issued ahead
  static constexpr int kMinBlocks = 7;   // resident blocks per SM the registers allow
  // fma(price, spot, fma(v1, w, v0 (1 - w)) + affine)
  static __device__ __forceinline__ float actual_total(float v0, float v1, float w, float w1,
                                                       float affine, float price, float spot) {
    const float lin = __fmaf_rn(v1, w, __fmul_rn(v0, w1));
    return __fmaf_rn(price, spot, __fadd_rn(lin, affine));
  }
};

template <>
struct K1Traits<double> {
  using Round = TorchRounding;
  static constexpr bool kTensorCores = true;
  static constexpr int kChunk = 16;
  static constexpr int kDUnroll = 3;
  static constexpr int kLookahead = 2;
  static constexpr int kMinBlocks = 4;
  // ((v0 (1 - w) + v1 w) + affine) + price spot, each rounded as torch does.
  static __device__ __forceinline__ double actual_total(double v0, double v1, double w, double w1,
                                                        double affine, double price,
                                                        double spot) {
    const double lin = __dadd_rn(__dmul_rn(v0, w1), __dmul_rn(v1, w));
    return __dadd_rn(__dadd_rn(lin, affine), __dmul_rn(price, spot));
  }
};

// Row pitch of the xr and vc tiles (elements): a 16-byte pad against bank
// conflicts of the product's vector reads.
template <class T>
__host__ __device__ constexpr int tile_pitch() {
  return kThreads + 16 / (int)sizeof(T);
}
static_assert(kMaxBasis + 2 <= 20, "a fitted row is at most five quads");

template <class T>
struct Operands {
  const T* f_cur;       // [F, S] factors of this period
  const T* f_prev;      // [F, S] factors of the previous period
  const T* v_next;      // [G, S] next-period values
  T* v_out;             // [G, S] this-period values
  const T* table;       // [D, G, B+2] fitted tables + affine columns
  const T* vbar;        // [G] sim-mean of v_next
  const T* musd;        // [2, B] standardization mean / scale
  const int* geom_j;    // [D, G] lower interpolation index
  const T* geom_w;      // [D, G] upper interpolation weight
  const T* scal;        // [2, 1+F] (drift, vols) this / previous period
  T* part;              // [nblk, B+1, G + B+1] per-block (praw | graw)
  long long num_sims;   // S < 2^32 / sizeof(T)
  unsigned row_bytes;   // sizeof(T) S: bytes from one V row to the next
  int num_grid;
  int num_decisions;
};

// Shared buffers of one stage: one work item's (tile, chunk) copies, and
// the per-(decision, grid point) constants derived from them.
template <class T>
struct Stage {
  T* tab;  // [D kChunk, 4 NQ] table rows (B weights, affine, price), zero-padded
  T* raw;  // [D kChunk, 2] (w, j) as copied
  // [D kChunk, 2] (vbar[j], vbar[j+1], w, 1 - w), (affine, price, j, j + 1)
  typename Elem<T>::Quad* dec;
};

__host__ __device__ constexpr int stage_elems(int dc, int nq) { return dc * (4 * nq + 10); }

// Stage k (0 or 1); the two stages lead the shared memory.
template <class T>
__device__ __forceinline__ Stage<T> stage_at(T* smem, int k, int DC, int NQ) {
  Stage<T> st;
  st.tab = smem + k * stage_elems(DC, NQ);
  st.raw = st.tab + DC * 4 * NQ;
  st.dec = reinterpret_cast<typename Elem<T>::Quad*>(st.raw + 2 * DC);
  return st;
}

// Start the asynchronous copies of chunk c's table rows, w and j into stage
// st (one commit group).
template <class T, int kNQ>
__device__ __forceinline__ void issue_copies(const Operands<T>& op, const Stage<T>& st, int B,
                                             int c) {
  constexpr int kChunk = K1Traits<T>::kChunk;
  const int G = op.num_grid;
  const int g0 = c * kChunk;
  const int gcount = min(kChunk, G - g0);
  for (int e = threadIdx.x; e < op.num_decisions * kChunk; e += kThreads) {
    const int d = e / kChunk;
    const int gl = e % kChunk;
    if (gl < gcount) {
      const size_t dg = (size_t)d * G + g0 + gl;
      const T* row = op.table + dg * (B + 2);
      T* dst = st.tab + e * 4 * kNQ;
      for (int b = 0; b < B + 2; ++b) cp_async_elem(dst + b, row + b);
      for (int b = B + 2; b < 4 * kNQ; ++b) dst[b] = T(0);
      cp_async_elem(st.raw + 2 * e, op.geom_w + dg);
      cp_async4(st.raw + 2 * e + 1, op.geom_j + dg);
    }
  }
  cp_async_commit();
}

// The per-(decision, grid point) constants of chunk c from its landed copies.
template <class T, int kNQ>
__device__ __forceinline__ void prepare_stage(const Operands<T>& op, const Stage<T>& st, int B,
                                              int c) {
  using E = Elem<T>;
  constexpr int kChunk = K1Traits<T>::kChunk;
  const int gcount = min(kChunk, op.num_grid - c * kChunk);
  for (int e = threadIdx.x; e < op.num_decisions * kChunk; e += kThreads) {
    if (e % kChunk < gcount) {
      const T w = st.raw[2 * e];
      const int j = E::int_at(st.raw + 2 * e + 1);
      const T* row = st.tab + e * 4 * kNQ;
      st.dec[2 * e] = E::quad(__ldg(op.vbar + j), __ldg(op.vbar + j + 1), w, sub_rn(T(1), w));
      st.dec[2 * e + 1] = E::quad(row[B], row[B + 1], E::from_index(j), E::from_index(j + 1));
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
template <class T, int kNQ>
__device__ __forceinline__ void decide_chunk(const Operands<T>& op, const Stage<T>& st,
                                             const T (&xn)[4 * kNQ], T spot, bool valid,
                                             long long s, const char* vcol, int g0, int gcount,
                                             T* s_vc) {
  using Tr = K1Traits<T>;
  using E = Elem<T>;
  using Quad = typename E::Quad;
  constexpr int kChunk = Tr::kChunk;
  constexpr int kLookahead = Tr::kLookahead;
  constexpr int kPitch = tile_pitch<T>();
  const int tid = threadIdx.x;
  // The reads in flight: stage a holds grid point gl - kLookahead + a's
  // winning entry and its two V_next values.
  int pe[kLookahead];
  T pr0[kLookahead], pr1[kLookahead];
  for (int gl = 0; gl < gcount + kLookahead; ++gl) {
    int ne;
    T nr0, nr1;
    if (gl < gcount) {
      T best_fit = T(0);
      ne = gl;
#pragma unroll (Tr::kDUnroll)
      for (int d = 0; d < op.num_decisions; ++d) {
        const int e = d * kChunk + gl;
        const Quad* Tq = reinterpret_cast<const Quad*>(st.tab + e * 4 * kNQ);
        T fit = T(0);
#pragma unroll
        for (int q = 0; q < kNQ; ++q) {
          const Quad t = Tq[q];
          fit = fma_rn(t.x, xn[4 * q], fit);
          fit = fma_rn(t.y, xn[4 * q + 1], fit);
          fit = fma_rn(t.z, xn[4 * q + 2], fit);
          fit = fma_rn(t.w, xn[4 * q + 3], fit);
        }
        // Decision 0 seeds unconditionally; later ones replace it only when
        // strictly better (first-occurrence argmax).
        if (d == 0 || fit > best_fit) {
          best_fit = fit;
          ne = e;
        }
      }
      const Quad k1 = st.dec[2 * ne + 1];  // affine, price, j, j + 1
      nr0 = __ldg(reinterpret_cast<const T*>(vcol + (size_t)E::to_index(k1.z) * op.row_bytes));
      nr1 = __ldg(reinterpret_cast<const T*>(vcol + (size_t)E::to_index(k1.w) * op.row_bytes));
    }
    if (gl >= kLookahead) {  // the actual total of grid point gl - kLookahead
      const int g = g0 + gl - kLookahead;
      const T vb = __ldg(op.vbar + g);
      const Quad k0 = st.dec[2 * pe[0]];      // vbar[j], vbar[j+1], w, 1 - w
      const Quad k1 = st.dec[2 * pe[0] + 1];  // affine, price, j, j + 1
      const T v0 = sub_rn(pr0[0], k0.x);
      const T v1 = sub_rn(pr1[0], k0.y);
      const T act = Tr::actual_total(v0, v1, k0.z, k0.w, k1.x, k1.y, spot);
      if (valid) op.v_out[(size_t)g * op.num_sims + s] = act;
      s_vc[(g - g0) * kPitch + tid] = valid ? sub_rn(act, vb) : T(0);
    }
#pragma unroll
    for (int a = 0; a < kLookahead; ++a) {
      pe[a] = a + 1 < kLookahead ? pe[a + 1] : ne;
      pr0[a] = a + 1 < kLookahead ? pr0[a + 1] : nr0;
      pr1[a] = a + 1 < kLookahead ? pr1[a + 1] : nr1;
    }
  }
}

// d += a b on the FP64 tensor cores: one m8n8k4 step of an 8 x 8 tile
// (IEEE double products and sums).
__device__ __forceinline__ void dmma_m8n8k4(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a), "d"(b));
}

// The 8 x 8 tile sum_s X[r, s] Y[c, s] over a tile's kThreads sims, X and Y
// rows of kPitch doubles: this lane's entries (r = lane / 4, c = 2 (lane % 4)
// + i), in four chains over the sims (s / 4 mod 4), added in a fixed order.
template <int kPitch>
__device__ __forceinline__ void tile_product(const double* X, const double* Y, int lane,
                                             double (&d)[2]) {
  const double* x = X + (lane / 4) * kPitch + lane % 4;
  const double* y = Y + (lane / 4) * kPitch + lane % 4;
  double acc[4][2] = {};
#pragma unroll
  for (int s = 0; s < kThreads; s += 16) {
#pragma unroll
    for (int h = 0; h < 4; ++h) dmma_m8n8k4(acc[h], x[s + 4 * h], y[s + 4 * h]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) d[i] = (acc[0][i] + acc[1][i]) + (acc[2][i] + acc[3][i]);
}

template <class T, int kNQ>
__global__ void __launch_bounds__(kThreads, K1Traits<T>::kMinBlocks)
    backward_update_kernel(Operands<T> op, BasisDesc bd) {
  using Tr = K1Traits<T>;
  using R = typename Tr::Round;
  using Quad = typename Elem<T>::Quad;
  constexpr int kChunk = Tr::kChunk;
  constexpr int kPitch = tile_pitch<T>();
  constexpr int kAGroups = kThreads / kChunk;  // basis-row groups of the praw product
  constexpr int kAPerThread = (kMaxBasis + 1 + kAGroups - 1) / kAGroups;
  static_assert(kThreads % kChunk == 0, "a chunk must divide the block");
  extern __shared__ __align__(16) float smem_words[];
  T* smem = reinterpret_cast<T*>(smem_words);  // the dynamic shared memory as T elements
  const int tid = threadIdx.x;
  const int B = bd.num_basis;
  const int F = bd.num_factors;
  const int B1 = B + 1;
  const int G = op.num_grid;
  const int DC = op.num_decisions * kChunk;
  const long long S = op.num_sims;

  T* s_xr = smem + 2 * stage_elems(DC, kNQ);  // [B1, kPitch] previous period's design rows
  T* s_vc = s_xr + B1 * kPitch;                 // [kChunk, kPitch] centred new values

  const int nchunks = (G + kChunk - 1) / kChunk;
  const long long ntiles = (S + kThreads - 1) / kThreads;
  const long long my_tiles = (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const long long nitems = my_tiles * nchunks;
  const int part_row = G + B1;
  T* my_part = op.part + (size_t)blockIdx.x * B1 * part_row;

  // Pipeline: item it + 1's copies are in flight during item it's decisions,
  // and its constants are prepared during item it's product.
  issue_copies<T, kNQ>(op, stage_at(smem, 0, DC, kNQ), B, 0);
  cp_async_wait_all();
  __syncthreads();
  prepare_stage<T, kNQ>(op, stage_at(smem, 0, DC, kNQ), B, 0);

  T xn[4 * kNQ];  // (standardized design row, 1, spot, 0...) of this thread's sim
  T spot = T(0);
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
    if (more) issue_copies<T, kNQ>(op, stage_at(smem, buf ^ 1, DC, kNQ), B, c1);
    __syncthreads();  // this item's constants are ready; the last product's reads are done

    if (c == 0) {  // a new tile: its sim's design rows
      s = tile * kThreads + tid;
      valid = s < S;
      vcol = reinterpret_cast<const char*>(op.v_next + (valid ? s : 0));
      T xr[kMaxBasis + 1];
      T xfull[kMaxBasis];
      spot = T(0);
#pragma unroll
      for (int b = 0; b < kMaxBasis; ++b) xfull[b] = T(0);
#pragma unroll
      for (int b = 0; b <= kMaxBasis; ++b) xr[b] = T(0);
      if (valid) {
        T fc[kMaxFactors], fp[kMaxFactors];
#pragma unroll
        for (int f = 0; f < kMaxFactors; ++f) {
          if (f < F) {
            fc[f] = op.f_cur[(size_t)f * S + s];
            fp[f] = op.f_prev[(size_t)f * S + s];
          }
        }
        spot = spot_of<R>(op.scal, fc, F);
        design_row<R>(bd, spot, fc, xfull);
        const T spot_prev = spot_of<R>(op.scal + 1 + F, fp, F);
        design_row<R>(bd, spot_prev, fp, xr);
#pragma unroll
        for (int b = 0; b < kMaxBasis; ++b) {
          if (b < B) {
            xfull[b] = R::sub(xfull[b], op.musd[b]) / op.musd[B + b];
            xr[b] = R::sub(xr[b], op.musd[b]) / op.musd[B + b];
          }
        }
#pragma unroll
        for (int b = 0; b <= kMaxBasis; ++b) {
          if (b == B) xr[b] = T(1);
        }
      }
#pragma unroll
      for (int b = 0; b < 4 * kNQ; ++b) {
        xn[b] = b < kMaxBasis && b < B ? xfull[b < kMaxBasis ? b : 0]
                : b == B               ? T(1)
                : b == B + 1           ? spot
                                       : T(0);
      }
#pragma unroll
      for (int b = 0; b <= kMaxBasis; ++b) {
        if (b < B1) s_xr[b * kPitch + tid] = xr[b];
      }
    }

    const int g0 = c * kChunk;
    const int gcount = min(kChunk, G - g0);
    decide_chunk<T, kNQ>(op, stage_at(smem, buf, DC, kNQ), xn, spot, valid, s, vcol, g0, gcount,
                         s_vc);
    cp_async_wait_all();
    __syncthreads();  // the vc tile is complete; the next item's copies have landed
    if (more) prepare_stage<T, kNQ>(op, stage_at(smem, buf ^ 1, DC, kNQ), B, c1);

    // praw[a, chunk] += xr[a, tile] . vc[chunk, tile], in a fixed order.
    const bool first_tile = it < nchunks;
    if constexpr (!Tr::kTensorCores) {
      T acc[kAPerThread][4];  // four chains (sims s = 0, 1, 2, 3 mod 4) per entry
#pragma unroll
      for (int k = 0; k < kAPerThread; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = T(0);
#pragma unroll 4
      for (int s4 = 0; s4 < kThreads; s4 += 4) {
        const Quad v = *reinterpret_cast<const Quad*>(s_vc + pg * kPitch + s4);
#pragma unroll
        for (int k = 0; k < kAPerThread; ++k) {
          const int a = ag + k * kAGroups;
          if (a < B1) {
            const Quad x = *reinterpret_cast<const Quad*>(s_xr + a * kPitch + s4);
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
            T* out = my_part + a * part_row + g0 + pg;
            const T tile_sum = (acc[k][0] + acc[k][1]) + (acc[k][2] + acc[k][3]);
            *out = first_tile ? tile_sum : *out + tile_sum;
          }
        }
      }
      if (c == 0) {  // graw += xr[:, tile] xr[:, tile]', once per tile
        for (int e = tid; e < B1 * B1; e += kThreads) {
          const int a = e / B1;
          const int b = e - a * B1;
          T sum[4] = {T(0), T(0), T(0), T(0)};
          for (int s4 = 0; s4 < kThreads; s4 += 4) {
            const Quad x = *reinterpret_cast<const Quad*>(s_xr + a * kPitch + s4);
            const Quad y = *reinterpret_cast<const Quad*>(s_xr + b * kPitch + s4);
            sum[0] = sum[0] + x.x * y.x;
            sum[1] = sum[1] + x.y * y.y;
            sum[2] = sum[2] + x.z * y.z;
            sum[3] = sum[3] + x.w * y.w;
          }
          T* out = my_part + a * part_row + G + b;
          const T tile_sum = (sum[0] + sum[1]) + (sum[2] + sum[3]);
          *out = first_tile ? tile_sum : *out + tile_sum;
        }
      }
    } else {
      // The same sums on the FP64 tensor cores: 8 x 8 tiles of praw (and
      // once per tile of graw), one warp a tile, each over the tile's sims.
      const int warp = tid / kWarp, lane = tid % kWarp;
      const int mt = (B1 + 7) / 8;
      for (int t = warp; t < mt * (kChunk / 8); t += kThreads / kWarp) {
        const int m0 = t / (kChunk / 8) * 8, n0 = t % (kChunk / 8) * 8;
        T d[2];
        tile_product<kPitch>(s_xr + m0 * kPitch, s_vc + n0 * kPitch, lane, d);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int a = m0 + lane / 4, gl = n0 + 2 * (lane % 4) + i;
          if (a < B1 && gl < gcount) {
            T* out = my_part + a * part_row + g0 + gl;
            *out = first_tile ? d[i] : *out + d[i];
          }
        }
      }
      if (c == 0) {
        for (int t = warp; t < mt * mt; t += kThreads / kWarp) {
          const int m0 = t / mt * 8, n0 = t % mt * 8;
          T d[2];
          tile_product<kPitch>(s_xr + m0 * kPitch, s_xr + n0 * kPitch, lane, d);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int a = m0 + lane / 4, b = n0 + 2 * (lane % 4) + i;
            if (a < B1 && b < B1) {
              T* out = my_part + a * part_row + G + b;
              *out = first_tile ? d[i] : *out + d[i];
            }
          }
        }
      }
    }
  }
}

template <class T>
using KernelFn = void (*)(Operands<T>, BasisDesc);

// A fitted row (B weights, affine, price) is read as ceil((B + 2) / 4)
// quads, zero-padded: three for B <= 10, four for B <= 14, five beyond.
int quads_of(int num_basis) { return (num_basis + 2 + 3) / 4 < 3 ? 3 : (num_basis + 2 + 3) / 4; }

template <class T>
KernelFn<T> kernel_for(int num_basis) {
  switch (quads_of(num_basis)) {
    case 3: return backward_update_kernel<T, 3>;
    case 4: return backward_update_kernel<T, 4>;
    default: return backward_update_kernel<T, 5>;
  }
}

template <class T>
size_t smem_bytes(int num_decisions, int num_basis) {
  constexpr int kChunk = K1Traits<T>::kChunk;
  return sizeof(T) *
         (2 * (size_t)stage_elems(num_decisions * kChunk, quads_of(num_basis)) +
          (size_t)(num_basis + 1 + kChunk) * tile_pitch<T>());
}

template <class T>
bool valid_shape(long long num_sims, int num_decisions, int num_basis, int num_factors) {
  return num_sims >= 1 && num_sims < (1LL << 32) / (long long)sizeof(T) && num_basis >= 1 &&
         num_basis <= kMaxBasis && num_factors >= 1 && num_factors <= kMaxFactors &&
         num_decisions >= 1;
}

template <class T>
int blocks_for(long long num_sims, int num_decisions, int num_basis) {
  if (!valid_shape<T>(num_sims, num_decisions, num_basis, 1)) return -(int)cudaErrorInvalidValue;
  int nblk = 0;
  const cudaError_t err = persistent_grid(
      reinterpret_cast<const void*>(kernel_for<T>(num_basis)), kThreads,
      smem_bytes<T>(num_decisions, num_basis), (num_sims + kThreads - 1) / kThreads, &nblk);
  return err == cudaSuccess ? nblk : -(int)err;
}

template <class T>
int launch(const T* f_cur, const T* f_prev, const T* v_next, T* v_out, const T* table,
           const T* vbar, const T* musd, const int* geom_j, const T* geom_w, const T* scal,
           T* partials, long long num_sims, int num_grid, int num_decisions, int num_basis,
           int num_factors, const int* spot_pow, const int* fac_pow, int num_blocks,
           void* stream) {
  if (!valid_shape<T>(num_sims, num_decisions, num_basis, num_factors) || num_grid < 2 ||
      num_blocks < 1 || num_blocks > (num_sims + kThreads - 1) / kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const BasisDesc bd = make_basis_desc(num_basis, num_factors, spot_pow, fac_pow);
  const Operands<T> op = {f_cur,  f_prev, v_next, v_out,    table,
                          vbar,   musd,   geom_j, geom_w,   scal,
                          partials, num_sims, (unsigned)(sizeof(T) * num_sims), num_grid,
                          num_decisions};
  const void* fn = reinterpret_cast<const void*>(kernel_for<T>(num_basis));
  const size_t smem = smem_bytes<T>(num_decisions, num_basis);
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {const_cast<Operands<T>*>(&op), const_cast<BasisDesc*>(&bd)};
  return (int)cudaLaunchKernel(fn, dim3(num_blocks), dim3(kThreads), args, smem,
                               (cudaStream_t)stream);
}

}  // namespace storage_kernels

using namespace storage_kernels;

// The number of blocks (= partials) backward_update_launch takes for these
// shapes on the current device, or minus a cudaError_t.
extern "C" int backward_update_blocks(long long num_sims, int num_decisions, int num_basis) {
  return blocks_for<float>(num_sims, num_decisions, num_basis);
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
  return launch<float>(f_cur, f_prev, v_next, v_out, table, vbar, musd, geom_j, geom_w, scal,
                       partials, num_sims, num_grid, num_decisions, num_basis, num_factors,
                       spot_pow, fac_pow, num_blocks, stream);
}

// The same two entry points in float64: every floating-point operand is double.
extern "C" int backward_update_f64_blocks(long long num_sims, int num_decisions, int num_basis) {
  return blocks_for<double>(num_sims, num_decisions, num_basis);
}

extern "C" int backward_update_f64_launch(
    const double* f_cur, const double* f_prev, const double* v_next, double* v_out,
    const double* table, const double* vbar, const double* musd, const int* geom_j,
    const double* geom_w, const double* scal, double* partials, long long num_sims,
    int num_grid, int num_decisions, int num_basis, int num_factors, const int* spot_pow,
    const int* fac_pow, int num_blocks, void* stream) {
  return launch<double>(f_cur, f_prev, v_next, v_out, table, vbar, musd, geom_j, geom_w, scal,
                        partials, num_sims, num_grid, num_decisions, num_basis, num_factors,
                        spot_pow, fac_pow, num_blocks, stream);
}
