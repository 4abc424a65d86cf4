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
// float and double (the roles' sizes and registers, ring depth, lookahead,
// the actual total's rounding, the partials' product); Elem<T>
// (storage_kernels.cuh) the vectors. A quad of four elements is one float4
// or two double2 reads.
//
// Design: a warp-specialised persistent kernel. Each (tile, chunk of kChunk =
// 16 grid points) item needs two phases: the decisions (FMA chains over table
// rows read from shared memory, an argmax, the winner's two V_next reads,
// V_out) and the regression partials' product over the chunk's centred
// values. Here they run in separate warpgroups (128 threads) of a block that
// meet in shared memory under mbarriers: after the barriers are set up there
// is no block-wide barrier, so no warp waits for the slowest one.
// - Decision warpgroups (kDecGroups of them, setmaxnreg.inc to kDecRegs).
//   Each owns a tile of 128 sims, one a thread, and walks G chunk by chunk:
//   per sim and grid point the fitted totals, the first-occurrence argmax,
//   the winner's actual total, V_out and the centred vc, which goes into a
//   slot of the warpgroup's own ring (kRing slots). It marks the slot full on
//   its mbarrier and goes on to the next chunk. Bound by latency: the FMA
//   chains, the shared-memory reads of the table and constants and the
//   V_next reads (through L1, issued kLookahead grid points before their
//   use; the grid-point loop is unrolled by kLookahead so that each read
//   keeps its registers until then).
// - The partials warpgroup (setmaxnreg.dec to kPartRegs). For each item it
//   waits until every decision warpgroup has filled its slot, adds praw[a,
//   chunk] += xr . vc (graw once a tile) into the block's partial for each
//   decision tile in turn, and frees the slots; so the product of one chunk
//   overlaps the decisions of the next inside the block. Bound by
//   shared-memory reads (a vc quad and up to three xr quads per 4 sims and
//   entry). It is also the producer: once every decision warpgroup is past
//   item i, stage i mod kStages is free, and one thread brings chunk
//   i + kStages's table rows in with one bulk asynchronous copy per decision
//   (cp.async.bulk, completing on the stage's mbarrier) while all derive the
//   per-entry constants (vbar[j], vbar[j+1], w, 1 - w, affine, price, j,
//   j + 1) and the chunk's vbar from w and j read from global memory. A
//   fitted row whose B + 2 elements are not whole quads (B other than 10 or
//   14), or a table not 16-byte aligned, is copied by the same threads
//   element by element into zero-padded rows.
// - The previous period's design rows xr of a decision tile go into one of
//   the warpgroup's kRing xr tiles, freed by the partials warpgroup after the
//   tile's last chunk.
// A persistent grid (blocks per SM from the occupancy calculator, times the
// SM count, at most one block per group of tiles) walks the tile groups;
// each block keeps its partials across its tiles and writes one [B+1, G +
// B+1] partial (praw columns, then graw columns), which the wrapper sums
// over blocks in a fixed order. The launch plan is shape-driven (make_plan,
// worked out once per device and shape): the most decision warpgroups, at
// most kDecGroups, whose block fits the shared memory (fewer past D = 57 /
// 35 in float32 and 12 / 3 in float64, at B = 10 / 16) and whose tile
// groups fill every block the card holds at once twice; else one
// decision warpgroup, the finest tiles (the 2,000-sim calls, 65,536-sim
// checks); and at the widest D, where even that block's ring does not fit,
// one warpgroup with a ring of one slot and one xr tile (no overlap of its
// decisions with its product). Shared memory is sized by D, B and kChunk,
// never by G, so any grid the JAX package values launches; D up to 85 / 59
// in float32 at B = 10 / 16 and 39 / 27 in float64, past the one-phase
// kernel's 77 / 55 and 36 / 25.
// - Fitted totals: one FMA chain per (sim, d) over the extended row
//   (xn, 1, spot) against (weights, affine, price), read as quad broadcasts
//   (rows zero-padded to a multiple of four elements). The decision loop is
//   unrolled by kDUnroll so the chains of consecutive decisions interleave.
// - Actual totals: only the winning decision's, so V_next is read twice per
//   sim and grid point whatever D.
// - Cross partials: each entry of praw (a grid point, a basis row) has one
//   owner thread that sums xr[a, s] vc[g, s] over each 128-sim tile with
//   FMAs in four chains (s mod 4), reads of quads, rows padded by 16 bytes
//   against bank conflicts, and adds the tile's sum to the block's partial
//   in the order the block walks its tiles; graw is summed the same way
//   once per tile. The result is bit-identical from run to run; there are
//   no float atomics. Only the number of blocks moves its rounding.
// - Design rows: built once a tile with rolled loops (design_row), which
//   keeps that code small: unrolled, it overflowed the instruction cache and
//   took half of the decision warps' cycles.
// - Rounding: both totals are written out with __fmaf_rn / __fadd_rn, so
//   that unrolling or register pressure cannot change how they round:
//   fitted = fma(price, spot, dot + affine), the dot an FMA chain in b order;
//   actual = fma(price, spot, fma(v1, w, v0 (1 - w)) + affine). V_out is the
//   earlier one-phase kernel's byte for byte. torch rounds every product and
//   sum separately, so near-tie decisions may flip against the plain
//   version; chip_smoke counts them.
//
// Measured on an H100 80GB HBM3 at 700 W, the main path's launch 170 (1M
// sims, G = 100, D = 3, B = 10; tools/kernel_turns.py, PERF.md section 6),
// against the one-phase kernel (128 threads, both phases, seven blocks an
// SM: 1.23 ms float32, 2.31 ms float64): time follows the resident decision
// warps. Float32: three decision warpgroups at two blocks an SM (24
// decision warps), 1.06 ms. Slower: two sims a thread (each table quad
// feeding two chains) in one warpgroup at three blocks (12 warps of 24
// chains) 1.18 ms, in three at one block 1.41 ms and in two at one block
// 1.54 ms; two warpgroups of one sim (16 warps) 1.33 ms, one at four
// blocks (16 warps) 1.40 ms; a lookahead of 3 or 4 no faster; a product of
// one grid point by three basis rows a thread 1.23 ms. Float64: three
// decision warpgroups at one block an SM (12 warps of 152 registers) 1.75
// ms; one at three blocks 2.15 ms; one at two blocks 2.75 ms. Float64 at
// medium sim counts is slower than the one-phase kernel (65,536 sims at G
// = 700, 262,144 at G = 500): its 16 warps of 128 registers each ran both
// phases; here at most 12 decision warps fit an SM (PERF.md section 7).
//
// Float64 (K1Traits<double>), the same design with these differences:
// - The partials' product runs on the FP64 tensor cores (mma.m8n8k4.f64,
//   IEEE double products and sums): one 8 x 8 tile of praw (graw once a
//   tile) per warp, over the tile's 128 sims in four chains, each entry
//   written by one lane in a fixed order. TF32's objection does not apply.
// - The winner's actual total is rounded as torch rounds it,
//   ((v0 (1 - w) + v1 w) + affine) + price spot, and so are the design rows
//   and the spot, so a V entry whose decision does not flip is the plain
//   version's bit for bit.
// - Tile rows are padded by two doubles (16 bytes) instead of four floats;
//   j rides in the low word of a double of the per-entry constants.
//
// Shared memory per block: the mbarriers, then, in elements of T, with
// NQ = max(3, ceil((B + 2) / 4)), P = 128 + 16 / sizeof(T) and r the ring's
// depth (kRing, or 1):
//   kStages (D kChunk (4 NQ + 8) + kChunk) + n r P (B + 1 + kChunk)
// for n decision warpgroups (float32, D = 3, B = 10, n = 3: 93,504 B, two
// blocks an SM). V_out is a separate buffer: a chunk reads rows of V_next
// outside itself.
#include <map>
#include <mutex>
#include <tuple>

#include "storage_kernels.cuh"

namespace storage_kernels {

constexpr int kGroup = 128;  // threads of a warpgroup = sims of a tile

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
  static constexpr int kDecGroups = 3;   // decision warpgroups per block
  static constexpr int kRing = 2;        // vc slots and xr tiles per decision warpgroup
  static constexpr int kStages = 2;      // table stages in flight
  static constexpr int kMinBlocks = 2;   // resident blocks per SM the registers allow
  static constexpr int kDecRegs = 72;    // registers of a decision thread
  static constexpr int kPartRegs = 40;   // registers of a partials thread
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
  static constexpr int kDecGroups = 3;
  static constexpr int kRing = 2;
  static constexpr int kStages = 2;
  static constexpr int kMinBlocks = 1;
  static constexpr int kDecRegs = 152;
  static constexpr int kPartRegs = 56;
  // ((v0 (1 - w) + v1 w) + affine) + price spot, each rounded as torch does.
  static __device__ __forceinline__ double actual_total(double v0, double v1, double w, double w1,
                                                        double affine, double price,
                                                        double spot) {
    const double lin = __dadd_rn(__dmul_rn(v0, w1), __dmul_rn(v1, w));
    return __dadd_rn(__dadd_rn(lin, affine), __dmul_rn(price, spot));
  }
};

// Threads of a block: the decision warpgroups, then the partials warpgroup.
template <class T>
__host__ __device__ constexpr int block_threads() {
  return kGroup * (K1Traits<T>::kDecGroups + 1);
}

// Registers a thread starts with: what __launch_bounds__ leaves each thread
// at kMinBlocks resident blocks (at most 255), in the allocation unit of 8.
template <class T>
__host__ __device__ constexpr int launch_regs() {
  const int regs = 65536 / (block_threads<T>() * K1Traits<T>::kMinBlocks);
  return (regs < 255 ? regs : 255) / 8 * 8;
}

// The register split moves registers between the roles of a block and never
// asks for more than the block holds (setmaxnreg.inc would wait forever).
template <class T>
__host__ __device__ constexpr bool register_split_fits(int regs) {
  using Tr = K1Traits<T>;
  return Tr::kPartRegs <= regs && regs <= Tr::kDecRegs &&
         Tr::kDecGroups * Tr::kDecRegs + Tr::kPartRegs <= (Tr::kDecGroups + 1) * regs;
}

// Row pitch of the xr and vc tiles (elements): a 16-byte pad against bank
// conflicts of the product's vector reads.
template <class T>
__host__ __device__ constexpr int tile_pitch() {
  return kGroup + 16 / (int)sizeof(T);
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
  int depth_log2;       // log2 of the ring's depth (slots and xr tiles a decision warpgroup)
  bool bulk;            // table rows are whole quads: one bulk copy per decision
};

// The mbarriers of a block, at the head of its shared memory.
template <class T>
struct Barriers {
  using Tr = K1Traits<T>;
  uint64_t stage_full[Tr::kStages];                // a stage's copies and constants landed
  uint64_t ring_full[Tr::kDecGroups][Tr::kRing];   // a slot's vc written
  uint64_t ring_empty[Tr::kDecGroups][Tr::kRing];  // a slot's product done
  uint64_t xr_empty[Tr::kDecGroups][Tr::kRing];    // a tile's last product done
};

template <class T>
__host__ __device__ constexpr int barrier_elems() {  // Barriers<T> in elements of T, 16-byte aligned
  return (int)((sizeof(Barriers<T>) + 15) / 16 * 16 / sizeof(T));
}

// Elements of one stage: [D kChunk, 4 NQ] table rows (B weights, affine,
// price, zero-padded), then [kChunk D, 2] quads (vbar[j], vbar[j+1], w,
// 1 - w), (affine, price, j, j + 1), grid point major so that the lanes of a
// warp that pick different decisions read different banks, then the chunk's
// vbar [kChunk].
template <class T>
__host__ __device__ constexpr int stage_elems(int dc, int nq) {
  return dc * (4 * nq + 8) + K1Traits<T>::kChunk;
}

// A decision tile's xr rows: [B+1][pitch]; a ring slot: [kChunk][pitch].
template <class T>
__host__ __device__ constexpr int xr_elems(int b1) {
  return b1 * tile_pitch<T>();
}
template <class T>
__host__ __device__ constexpr int slot_elems() {
  return K1Traits<T>::kChunk * tile_pitch<T>();
}

// Shared buffers of one stage.
template <class T>
struct Stage {
  T* tab;
  typename Elem<T>::Quad* dec;
  T* vb;
};

// The block's shared memory, carved in this order: barriers, stages, each
// decision warpgroup's `depth` xr tiles, each decision warpgroup's ring of
// `depth` slots.
template <class T>
struct Shared {
  Barriers<T>* bar;
  T* stages;
  T* xr;
  T* ring;
  int stage_size, xr_size, depth;

  __device__ __forceinline__ Stage<T> stage(int k, int DC, int NQ) const {
    Stage<T> st;
    st.tab = stages + k * stage_size;
    st.dec = reinterpret_cast<typename Elem<T>::Quad*>(st.tab + DC * 4 * NQ);
    st.vb = st.tab + DC * (4 * NQ + 8);
    return st;
  }
  __device__ __forceinline__ T* xr_tile(int w, int b) const { return xr + (depth * w + b) * xr_size; }
  __device__ __forceinline__ T* slot(int w, int r) const {
    return ring + (depth * w + r) * slot_elems<T>();
  }
};

template <class T>
__host__ __device__ constexpr size_t smem_elems(int num_decisions, int nq, int num_basis,
                                                int dec_groups, int depth) {
  using Tr = K1Traits<T>;
  return (size_t)barrier_elems<T>() +
         (size_t)Tr::kStages * stage_elems<T>(num_decisions * Tr::kChunk, nq) +
         (size_t)dec_groups * depth * (xr_elems<T>(num_basis + 1) + slot_elems<T>());
}

// --- mbarriers, bulk copies and register moves (sm_90) ---

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(shared_addr(bar)) : "memory");
}

// An arrival that also announces `bytes` of asynchronous copies to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(shared_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(shared_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global into
// shared memory, counted on `bar` when they land.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(shared_addr(dst)),
      "l"(src), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// Arrival of a whole warp once all its lanes are done with their accesses.
__device__ __forceinline__ void warp_arrive(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// --- the producer's part of the partials warpgroup ---

// Item i's stage: chunk c's table rows (bulk, or element by element), its
// per-entry constants and its vbar; thread t of the partials warpgroup.
template <class T, int kNQ>
__device__ __forceinline__ void produce_stage(const Operands<T>& op, const Stage<T>& st,
                                              uint64_t* full, int B, int c, int t) {
  using E = Elem<T>;
  constexpr int kChunk = K1Traits<T>::kChunk;
  const int G = op.num_grid;
  const int D = op.num_decisions;
  const int g0 = c * kChunk;
  const int gcount = min(kChunk, G - g0);
  const int row = B + 2;
  if (op.bulk && t == 0) {
    const unsigned bytes = (unsigned)(gcount * row * sizeof(T));
    mbar_arrive_expect_tx(full, bytes * D);
    for (int d = 0; d < D; ++d) {
      bulk_copy(st.tab + d * kChunk * 4 * kNQ, op.table + ((size_t)d * G + g0) * row, bytes, full);
    }
  }
  for (int e = t; e < D * kChunk; e += kGroup) {
    const int d = e / kChunk;
    const int gl = e % kChunk;
    if (gl < gcount) {
      const size_t dg = (size_t)d * G + g0 + gl;
      const T* src = op.table + dg * row;
      if (!op.bulk) {
        T* dst = st.tab + e * 4 * kNQ;
        for (int b = 0; b < row; ++b) dst[b] = __ldg(src + b);
      }
      const T w = __ldg(op.geom_w + dg);
      const int j = __ldg(op.geom_j + dg);
      const int de = gl * D + d;
      st.dec[2 * de] = E::quad(__ldg(op.vbar + j), __ldg(op.vbar + j + 1), w, sub_rn(T(1), w));
      st.dec[2 * de + 1] =
          E::quad(__ldg(src + B), __ldg(src + B + 1), E::from_index(j), E::from_index(j + 1));
    }
  }
  if (t < gcount) st.vb[t] = __ldg(op.vbar + g0 + t);
  warp_arrive(full, t % kWarp);
}

// --- the decision warpgroups ---

// This thread's sim s of one decision tile: its design row xr into the
// tile's xr buffer (column xr_col), and (xn, 1, spot, 0...) in registers. The
// loop over basis columns is rolled (the row goes through local memory):
// unrolled, this once-a-tile code filled the instruction cache and took as
// long as the decisions.
template <class T, int kNQ>
__device__ __forceinline__ void tile_rows(const Operands<T>& op, const BasisDesc& bd, long long s,
                                          T* xr_col, T (&xn)[4 * kNQ], T& spot) {
  using R = typename K1Traits<T>::Round;
  constexpr int kPitch = tile_pitch<T>();
  const int B = bd.num_basis;
  const int F = bd.num_factors;
  const long long S = op.num_sims;
  T xfull[kMaxBasis];
  T sp = T(0);
  if (s < S) {
    T fc[kMaxFactors], fp[kMaxFactors], xr[kMaxBasis];
#pragma unroll
    for (int f = 0; f < kMaxFactors; ++f) {
      if (f < F) {
        fc[f] = op.f_cur[(size_t)f * S + s];
        fp[f] = op.f_prev[(size_t)f * S + s];
      }
    }
    sp = spot_of<R>(op.scal, fc, F);
    design_row<R>(bd, sp, fc, xfull);
    design_row<R>(bd, spot_of<R>(op.scal + 1 + F, fp, F), fp, xr);
#pragma unroll 1
    for (int b = 0; b < B; ++b) {
      xfull[b] = R::sub(xfull[b], op.musd[b]) / op.musd[B + b];
      xr_col[b * kPitch] = R::sub(xr[b], op.musd[b]) / op.musd[B + b];
    }
    xr_col[B * kPitch] = T(1);
  } else {  // past the last sim: a zero row, a zero ones row
#pragma unroll 1
    for (int b = 0; b <= B; ++b) {
      if (b < B) xfull[b] = T(0);
      xr_col[b * kPitch] = T(0);
    }
  }
  spot = sp;
#pragma unroll
  for (int b = 0; b < 4 * kNQ; ++b) {
    xn[b] = b < kMaxBasis && b < B ? xfull[b < kMaxBasis ? b : 0]
            : b == B               ? T(1)
            : b == B + 1           ? sp
                                   : T(0);
  }
}

// The decisions of one chunk for this thread's sim s: best_act for each grid
// point into V_out and, centred, into the ring slot (column vc_col). The
// fitted total of every decision is one FMA chain over the extended row
// (xn, 1, spot) against (weights, affine, price). Only the winning decision's
// actual total is computed, so V_next is read twice per sim and grid point,
// whatever D; the winner's two reads are issued at grid point g and used at
// g + kLookahead, after the fitted totals in between, which hides their
// latency. A sim past the last one reads sim 0's column and writes nothing
// but a zero vc.
template <class T, int kNQ>
__device__ __forceinline__ void decide_chunk(const Operands<T>& op, const Stage<T>& st,
                                             const T (&xn)[4 * kNQ], T spot, long long s, int g0,
                                             int gcount, T* vc_col) {
  using Tr = K1Traits<T>;
  using E = Elem<T>;
  using Quad = typename E::Quad;
  constexpr int kChunk = Tr::kChunk;
  constexpr int kLookahead = Tr::kLookahead;
  constexpr int kPitch = tile_pitch<T>();
  const long long S = op.num_sims;
  const bool valid = s < S;
  const char* vcol = reinterpret_cast<const char*>(op.v_next + (valid ? s : 0));
  const int D = op.num_decisions;
  // The reads in flight: stage a holds the winning entry of grid point
  // gl - kLookahead (gl = a mod kLookahead), its affine and price terms and
  // its two V_next values. The grid-point loop is unrolled by kLookahead, so
  // each stage keeps its registers from the read to its use: no register
  // move waits on a read in flight.
  int pe[kLookahead];
  T pa[kLookahead], pp[kLookahead], pr0[kLookahead], pr1[kLookahead];
  for (int base = 0; base < gcount + kLookahead; base += kLookahead) {
#pragma unroll
    for (int a = 0; a < kLookahead; ++a) {
      const int gl = base + a;
      int nd = 0;  // the winning decision
      if (gl < gcount) {
        T best_fit = T(0);
#pragma unroll (Tr::kDUnroll)
        for (int d = 0; d < D; ++d) {
          const Quad* Tq = reinterpret_cast<const Quad*>(st.tab + (d * kChunk + gl) * 4 * kNQ);
          T fit = T(0);
#pragma unroll
          for (int q = 0; q < kNQ; ++q) {
            const Quad tq = Tq[q];
            fit = fma_rn(tq.x, xn[4 * q], fit);
            fit = fma_rn(tq.y, xn[4 * q + 1], fit);
            fit = fma_rn(tq.z, xn[4 * q + 2], fit);
            fit = fma_rn(tq.w, xn[4 * q + 3], fit);
          }
          // Decision 0 seeds unconditionally; later ones replace it only
          // when strictly better (first-occurrence argmax).
          if (d == 0 || fit > best_fit) {
            best_fit = fit;
            nd = d;
          }
        }
      }
      if (gl >= kLookahead && gl - kLookahead < gcount) {  // grid point gl - kLookahead
        const int g = g0 + gl - kLookahead;
        const Quad k0 = st.dec[2 * pe[a]];  // vbar[j], vbar[j+1], w, 1 - w
        const T v0 = sub_rn(pr0[a], k0.x);
        const T v1 = sub_rn(pr1[a], k0.y);
        const T act = Tr::actual_total(v0, v1, k0.z, k0.w, pa[a], pp[a], spot);
        if (valid) op.v_out[(size_t)g * S + s] = act;
        vc_col[(g - g0) * kPitch] = valid ? sub_rn(act, st.vb[gl - kLookahead]) : T(0);
      }
      if (gl < gcount) {  // the winner's reads of grid point gl, into stage a
        pe[a] = gl * D + nd;
        const Quad k1 = st.dec[2 * pe[a] + 1];  // affine, price, j, j + 1
        pa[a] = k1.x;
        pp[a] = k1.y;
        pr0[a] = __ldg(reinterpret_cast<const T*>(vcol + (size_t)E::to_index(k1.z) * op.row_bytes));
        pr1[a] = __ldg(reinterpret_cast<const T*>(vcol + (size_t)E::to_index(k1.w) * op.row_bytes));
      }
    }
  }
}

// --- the partials' product ---

// d += a b on the FP64 tensor cores: one m8n8k4 step of an 8 x 8 tile
// (IEEE double products and sums).
__device__ __forceinline__ void dmma_m8n8k4(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a), "d"(b));
}

// The 8 x 8 tile sum_s X[r, s] Y[c, s] over a tile's 128 sims, X and Y
// rows of kPitch doubles: this lane's entries (r = lane / 4, c = 2 (lane % 4)
// + i), in four chains over the sims (s / 4 mod 4), added in a fixed order.
template <int kPitch>
__device__ __forceinline__ void tile_product(const double* X, const double* Y, int lane,
                                             double (&d)[2]) {
  const double* x = X + (lane / 4) * kPitch + lane % 4;
  const double* y = Y + (lane / 4) * kPitch + lane % 4;
  double acc[4][2] = {};
#pragma unroll
  for (int s = 0; s < kGroup; s += 16) {
#pragma unroll
    for (int h = 0; h < 4; ++h) dmma_m8n8k4(acc[h], x[s + 4 * h], y[s + 4 * h]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) d[i] = (acc[0][i] + acc[1][i]) + (acc[2][i] + acc[3][i]);
}

// One decision tile's share of the block's partial: praw[:, chunk] from xr
// [B1, kPitch] and vc [kChunk, kPitch], and graw when `with_graw` (the
// tile's first chunk). `first` writes the sums, else adds them. Thread t
// of the partials warpgroup.
template <class T>
__device__ __forceinline__ void tile_partials(const T* s_xr, const T* s_vc, T* my_part, int B1,
                                              int part_row, int G, int g0, int gcount,
                                              bool first, bool with_graw, int t) {
  using Tr = K1Traits<T>;
  using Quad = typename Elem<T>::Quad;
  constexpr int kChunk = Tr::kChunk;
  constexpr int kPitch = tile_pitch<T>();
  if constexpr (!Tr::kTensorCores) {
    constexpr int kAGroups = kGroup / kChunk;  // basis-row groups of the praw product
    constexpr int kAPerThread = (kMaxBasis + 1 + kAGroups - 1) / kAGroups;
    static_assert(kGroup % kChunk == 0, "a chunk must divide the warpgroup");
    const int pg = t % kChunk;  // this thread's grid point in the chunk
    const int ag = t / kChunk;  // and its basis rows ag, ag + kAGroups, ...
    T acc[kAPerThread][4];      // four chains (sims s = 0, 1, 2, 3 mod 4) per entry
#pragma unroll
    for (int k = 0; k < kAPerThread; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = T(0);
#pragma unroll 4
    for (int s4 = 0; s4 < kGroup; s4 += 4) {
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
          *out = first ? tile_sum : *out + tile_sum;
        }
      }
    }
    if (with_graw) {  // graw += xr xr', once per tile
      for (int e = t; e < B1 * B1; e += kGroup) {
        const int a = e / B1;
        const int b = e - a * B1;
        T sum[4] = {T(0), T(0), T(0), T(0)};
        for (int s4 = 0; s4 < kGroup; s4 += 4) {
          const Quad x = *reinterpret_cast<const Quad*>(s_xr + a * kPitch + s4);
          const Quad y = *reinterpret_cast<const Quad*>(s_xr + b * kPitch + s4);
          sum[0] = sum[0] + x.x * y.x;
          sum[1] = sum[1] + x.y * y.y;
          sum[2] = sum[2] + x.z * y.z;
          sum[3] = sum[3] + x.w * y.w;
        }
        T* out = my_part + a * part_row + G + b;
        const T tile_sum = (sum[0] + sum[1]) + (sum[2] + sum[3]);
        *out = first ? tile_sum : *out + tile_sum;
      }
    }
  } else {
    // The same sums on the FP64 tensor cores: 8 x 8 tiles of praw (and once
    // per tile of graw), one warp an 8 x 8 tile, each over the tile's sims.
    const int warp = t / kWarp, lane = t % kWarp;
    const int mt = (B1 + 7) / 8;
    for (int k = warp; k < mt * (kChunk / 8); k += kGroup / kWarp) {
      const int m0 = k / (kChunk / 8) * 8, n0 = k % (kChunk / 8) * 8;
      T d[2];
      tile_product<kPitch>(s_xr + m0 * kPitch, s_vc + n0 * kPitch, lane, d);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int a = m0 + lane / 4, gl = n0 + 2 * (lane % 4) + i;
        if (a < B1 && gl < gcount) {
          T* out = my_part + a * part_row + g0 + gl;
          *out = first ? d[i] : *out + d[i];
        }
      }
    }
    if (with_graw) {
      for (int k = warp; k < mt * mt; k += kGroup / kWarp) {
        const int m0 = k / mt * 8, n0 = k % mt * 8;
        T d[2];
        tile_product<kPitch>(s_xr + m0 * kPitch, s_xr + n0 * kPitch, lane, d);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int a = m0 + lane / 4, b = n0 + 2 * (lane % 4) + i;
          if (a < B1 && b < B1) {
            T* out = my_part + a * part_row + G + b;
            *out = first ? d[i] : *out + d[i];
          }
        }
      }
    }
  }
}

template <class T, int kNQ>
__global__ void __launch_bounds__(block_threads<T>(), K1Traits<T>::kMinBlocks)
    backward_update_kernel(Operands<T> op, BasisDesc bd) {
  using Tr = K1Traits<T>;
  constexpr int kChunk = Tr::kChunk;
  constexpr int kStages = Tr::kStages;
  static_assert(register_split_fits<T>(launch_regs<T>()), "the register split overdraws the block");
  static_assert((Tr::kRing & (Tr::kRing - 1)) == 0, "slots are picked by masks: a power of two");
  extern __shared__ __align__(16) float smem_words[];
  T* smem = reinterpret_cast<T*>(smem_words);  // the dynamic shared memory as T elements
  const int tid = threadIdx.x;
  const int B = bd.num_basis;
  const int B1 = B + 1;
  const int G = op.num_grid;
  const int DC = op.num_decisions * kChunk;
  const long long S = op.num_sims;
  const int ndec = blockDim.x / kGroup - 1;  // decision warpgroups launched (the launch plan)
  const int depth = 1 << op.depth_log2;      // ring slots and xr tiles (the launch plan)

  Shared<T> sh;
  sh.bar = reinterpret_cast<Barriers<T>*>(smem);
  sh.stages = smem + barrier_elems<T>();
  sh.stage_size = stage_elems<T>(DC, kNQ);
  sh.xr = sh.stages + kStages * sh.stage_size;
  sh.xr_size = xr_elems<T>(B1);
  sh.depth = depth;
  sh.ring = sh.xr + ndec * depth * sh.xr_size;

  const int nchunks = (G + kChunk - 1) / kChunk;
  const long long ngroups = (S + (long long)kGroup * ndec - 1) / ((long long)kGroup * ndec);
  const long long rounds = (ngroups - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const long long nitems = rounds * nchunks;

  if (tid == 0) {
    for (int k = 0; k < kStages; ++k) mbar_init(&sh.bar->stage_full[k], kGroup / kWarp + op.bulk);
    for (int w = 0; w < ndec; ++w) {
      for (int r = 0; r < depth; ++r) {
        mbar_init(&sh.bar->ring_full[w][r], kGroup / kWarp);
        mbar_init(&sh.bar->ring_empty[w][r], kGroup / kWarp);
        mbar_init(&sh.bar->xr_empty[w][r], kGroup / kWarp);
      }
    }
  }
  if (!op.bulk) {  // the rows' zero pads, never written again
    for (int e = tid; e < kStages * DC; e += blockDim.x) {
      T* row = sh.stages + (e / DC) * sh.stage_size + (e % DC) * 4 * kNQ;
      for (int b = B + 2; b < 4 * kNQ; ++b) row[b] = T(0);
    }
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();  // the only block barrier: the barriers are set up

  // Item i (round k, chunk c) uses ring slot and xr tile i and k mod depth,
  // in phase i and k / depth of their barriers.
  const int wg = tid / kGroup;
  const int t = tid % kGroup;
  const int lane = t % kWarp;
  if (wg < ndec) {
    // ---- a decision warpgroup: w = wg, sim s of each of its tiles ----
    regs_inc<Tr::kDecRegs>();
    const int w = wg;
    T xn[4 * kNQ];  // (standardized design row, 1, spot, 0...)
    T spot;
    for (long long k = 0; k < rounds; ++k) {
      const long long first = ((blockIdx.x + k * gridDim.x) * ndec + w) * kGroup;
      if (first >= S) break;  // no tile for this warpgroup in the block's last round
      const int xb = (int)(k & (depth - 1));
      mbar_wait(&sh.bar->xr_empty[w][xb], (unsigned)((k >> op.depth_log2) & 1) ^ 1u);
      tile_rows<T, kNQ>(op, bd, first + t, sh.xr_tile(w, xb) + t, xn, spot);
      for (int c = 0; c < nchunks; ++c) {
        const long long i = k * nchunks + c;
        const int st = (int)(i % kStages);
        const int r = (int)(i & (depth - 1));
        mbar_wait(&sh.bar->stage_full[st], (unsigned)((i / kStages) & 1));
        mbar_wait(&sh.bar->ring_empty[w][r], (unsigned)((i >> op.depth_log2) & 1) ^ 1u);
        const int g0 = c * kChunk;
        decide_chunk<T, kNQ>(op, sh.stage(st, DC, kNQ), xn, spot, first + t, g0,
                             min(kChunk, G - g0), sh.slot(w, r) + t);
        warp_arrive(&sh.bar->ring_full[w][r], lane);
      }
    }
  } else {
    // ---- the partials warpgroup, and the stages' producer ----
    regs_dec<Tr::kPartRegs>();
    const int part_row = G + B1;
    T* my_part = op.part + (size_t)blockIdx.x * B1 * part_row;
    for (long long i = 0; i < nitems && i < kStages; ++i) {
      produce_stage<T, kNQ>(op, sh.stage((int)i, DC, kNQ), &sh.bar->stage_full[i], B,
                            (int)(i % nchunks), t);
    }
    for (long long k = 0; k < rounds; ++k) {
      const long long group_first = (blockIdx.x + k * gridDim.x) * ndec * kGroup;
      const int active = (int)min((long long)ndec, (S - group_first + kGroup - 1) / kGroup);
      const int xb = (int)(k & (depth - 1));
      for (int c = 0; c < nchunks; ++c) {
        const long long i = k * nchunks + c;
        const int r = (int)(i & (depth - 1));
        for (int w = 0; w < active; ++w) {
          mbar_wait(&sh.bar->ring_full[w][r], (unsigned)((i >> op.depth_log2) & 1));
        }
        // Every decision warpgroup is past item i: its stage takes item i + kStages.
        if (i + kStages < nitems) {
          const int st = (int)(i % kStages);
          produce_stage<T, kNQ>(op, sh.stage(st, DC, kNQ), &sh.bar->stage_full[st], B,
                                (int)((i + kStages) % nchunks), t);
        }
        const int g0 = c * kChunk;
        const int gcount = min(kChunk, G - g0);
        for (int w = 0; w < active; ++w) {
          tile_partials<T>(sh.xr_tile(w, xb), sh.slot(w, r), my_part, B1, part_row, G, g0, gcount,
                           k == 0 && w == 0, c == 0, t);
          warp_arrive(&sh.bar->ring_empty[w][r], lane);
          if (c == nchunks - 1) warp_arrive(&sh.bar->xr_empty[w][xb], lane);
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
bool valid_shape(long long num_sims, int num_decisions, int num_basis, int num_factors) {
  return num_sims >= 1 && num_sims < (1LL << 32) / (long long)sizeof(T) && num_basis >= 1 &&
         num_basis <= kMaxBasis && num_factors >= 1 && num_factors <= kMaxFactors &&
         num_decisions >= 1;
}

// How a shape is launched: with the most decision warpgroups (at most
// kDecGroups) whose block fits the shared memory with a ring of kRing slots
// and whose tile groups fill every block the card holds at once twice over
// (so that the blocks' last rounds, which some blocks lack, cost a third or
// less); where no count does (small S: the 2,000-sim calls, 65,536-sim
// checks), with one, the finest tiles; and where even one warpgroup's ring of
// kRing slots does not fit (the widest D), with one slot and one xr tile. A
// block of fewer warpgroups holds fewer registers, but its split still fits
// them. Shared by blocks_for and launch.
struct Plan {
  const void* fn;
  int depth, threads;  // ring slots; threads of a block (its decision warpgroups and one)
  size_t smem;
  long long groups;  // tile groups of as many tiles as decision warpgroups: the most blocks
};

template <class T>
cudaError_t make_plan(int dev, long long num_sims, int num_decisions, int num_basis, Plan* plan) {
  using Tr = K1Traits<T>;
  const void* fn = reinterpret_cast<const void*>(kernel_for<T>(num_basis));
  cudaFuncAttributes attr;
  int limit = 0, sms = 0;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // The compiled kernel must hold the registers its split assumes, or
  // setmaxnreg.inc would wait forever.
  if (!register_split_fits<T>((attr.numRegs + 7) / 8 * 8)) return cudaErrorInvalidConfiguration;
  const auto bytes = [&](int n, int depth) {
    return sizeof(T) * smem_elems<T>(num_decisions, quads_of(num_basis), num_basis, n, depth);
  };
  bool found = false;
  for (int n = Tr::kDecGroups; n >= 1; --n) {
    int depth = Tr::kRing;
    if (n == 1 && bytes(n, depth) > (size_t)limit) depth = 1;
    const size_t smem = bytes(n, depth);
    if (smem > (size_t)limit) continue;
    const int threads = kGroup * (n + 1);
    int per_sm = 0;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
    }
    if (err != cudaSuccess) return err;
    const long long group = (long long)n * kGroup;
    *plan = {fn, depth, threads, smem, (num_sims + group - 1) / group};
    found = true;
    if (plan->groups >= 2LL * per_sm * sms) return cudaSuccess;
  }
  return found ? cudaSuccess : cudaErrorInvalidValue;  // else not even one warpgroup fits
}

// The plan of a shape on the current device, worked out once: a launch
// after the first makes no query of the device or the kernel.
template <class T>
cudaError_t plan_for(long long num_sims, int num_decisions, int num_basis, Plan* plan) {
  static std::mutex mutex;
  static std::map<std::tuple<int, long long, int, int>, Plan> plans;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(dev, num_sims, num_decisions, num_basis);
  const std::lock_guard<std::mutex> lock(mutex);
  const auto found = plans.find(key);
  if (found != plans.end()) {
    *plan = found->second;
    return cudaSuccess;
  }
  err = make_plan<T>(dev, num_sims, num_decisions, num_basis, plan);
  if (err == cudaSuccess) plans.emplace(key, *plan);
  return err;
}

template <class T>
int blocks_for(long long num_sims, int num_decisions, int num_basis) {
  if (!valid_shape<T>(num_sims, num_decisions, num_basis, 1)) return -(int)cudaErrorInvalidValue;
  Plan plan;
  cudaError_t err = plan_for<T>(num_sims, num_decisions, num_basis, &plan);
  int nblk = 0;
  if (err == cudaSuccess) {
    err = persistent_grid(plan.fn, plan.threads, plan.smem, plan.groups, &nblk);
  }
  return err == cudaSuccess ? nblk : -(int)err;
}

template <class T>
int launch(const T* f_cur, const T* f_prev, const T* v_next, T* v_out, const T* table,
           const T* vbar, const T* musd, const int* geom_j, const T* geom_w, const T* scal,
           T* partials, long long num_sims, int num_grid, int num_decisions, int num_basis,
           int num_factors, const int* spot_pow, const int* fac_pow, int num_blocks,
           void* stream) {
  if (!valid_shape<T>(num_sims, num_decisions, num_basis, num_factors) || num_grid < 2 ||
      num_blocks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Plan plan;
  cudaError_t err = plan_for<T>(num_sims, num_decisions, num_basis, &plan);
  if (err != cudaSuccess) return (int)err;
  if (num_blocks > plan.groups) return (int)cudaErrorInvalidValue;
  const BasisDesc bd = make_basis_desc(num_basis, num_factors, spot_pow, fac_pow);
  const bool bulk = num_basis + 2 == 4 * quads_of(num_basis) &&
                    reinterpret_cast<uintptr_t>(table) % 16 == 0;
  int depth_log2 = 0;
  while ((1 << depth_log2) < plan.depth) ++depth_log2;
  const Operands<T> op = {f_cur,  f_prev, v_next, v_out,    table,
                          vbar,   musd,   geom_j, geom_w,   scal,
                          partials, num_sims, (unsigned)(sizeof(T) * num_sims), num_grid,
                          num_decisions, depth_log2, bulk};
  err = cudaFuncSetAttribute(plan.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {const_cast<Operands<T>*>(&op), const_cast<BasisDesc*>(&bd)};
  return (int)cudaLaunchKernel(plan.fn, dim3(num_blocks), dim3(plan.threads), args, plan.smem,
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
// backward_update_blocks, or fewer) writing partials [num_blocks, B+1, G +
// B+1]; returns the cudaError_t of the launch (0 on success). Pointers are
// device pointers except spot_pow / fac_pow ([B] and [B, F] ints on the host).
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
