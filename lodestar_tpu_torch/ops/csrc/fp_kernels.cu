// Relaxed BLS12-381 Fp products for Hopper (sm_90a): the five entry points of
// lodestar_tpu/ops/fp_pallas.py.
//
// Replaces (each C entry point below names its Pallas function), and runs as:
//   lodestar_fp_mul_acc  <- fp_pallas.mul_acc  (_mul_acc_kernel)      mul_acc_kernel
//   lodestar_fp_sq_acc   <- fp_pallas.sq_acc   (_sq_acc_kernel)       sq_acc_kernel<PATH, W>
//   lodestar_fp_redc     <- fp_pallas.redc     (_redc_kernel / _redc_rows)  redc_kernel<PATH, K>
//   lodestar_fp_mont_mul <- fp_pallas.mont_mul (_mont_mul_kernel)     mont_mul_kernel<PATH, W>
//   lodestar_fp_mont_sq  <- fp_pallas.mont_sq  (_mont_sq_kernel)      mont_sq_kernel<PATH, W>
//
// Representation (lodestar_tpu_torch/ops/fp.py): an element is 33 signed
// 12-bit limbs in int32, an accumulator 66. The limbs out are bit-identical
// to the plain PyTorch versions in ops/fp.py.
//
// Arithmetic stays inside the int32 ledger of ops/fp.py: a convolution
// coefficient is at most 33 * 4161^2 < 2^30, the m*p product plus the
// carried accumulator and 2Rp stays below 2^30, so nothing is widened; a
// partial sum of any subset of a column's products stays below that too,
// so the order of the shares' atomic adds does not matter.
//
// What bounds these kernels on an H100 SXM (132 SMs, 64 int32 lanes each,
// so ~16.7e12 int32 multiply-adds/s at 1.98 GHz; 3.35 TB/s of HBM):
//   conv (mul_acc)  1089 multiply-adds per row (561 for a square) against
//                   528 bytes read and written (396 for sq_acc): bytes bound.
//   reduction       561 (m = t_lo * P' mod R) + 1089 (m * p) ~ 1.6k
//                   multiply-adds per row against 396 bytes (redc): about
//                   balanced; mont_mul (~2.7k multiply-adds, 396 bytes)
//                   and mont_sq (~2.2k, 264 bytes) are bound by the int32
//                   multiply-adds.
// But a verify launches mul_acc and redc mostly at 4-6k rows, mont_mul and
// mont_sq at one row (760 launches each: the Fermat chains, one launch
// after the other) and at 2,048 rows, sq_acc at one row; input prep
// launches them at 2-123k rows (its Fp2 square-root chain at 20-31k), and
// sq_acc at 2,048 and 4,096. Up to ~6k rows every bound is under a
// microsecond. There the time is the ~2 us floor of a launch plus one
// block's serial chain, and that chain is set by how many instructions each
// warp issues and fetches: one thread per row leaves most SMs idle and
// each thread walks a whole row alone; four warps on four code paths
// (mul_acc) fetch four times the code, and straight-line code past a few
// tens of KB is fetch bound, more so the more SMs fetch it at once
// (PERF.md).
//
// mul_acc_kernel: each row over four threads, one per warp of a 128-thread
//   block: warp q computes columns [kColStart[q], kColStart[q+1]) of its
//   tile's 32 rows, lane r row r: 276, 285, 275 and 253 of the 1089
//   products, each over compile-time limb indices with the operands in
//   registers. The two carry passes need only the carries into a range's
//   first column, which the range below computes from its own top two
//   columns; they cross warps through shared memory at one barrier.
// redc_kernel (up to 5 tiles per SM), mont_mul_kernel, mont_sq_kernel,
// sq_acc_kernel:
//   each row over W threads (shares), all threads of a 128-thread block on
//   ONE code path: a share's part of each step is chosen by offsets
//   computed from its index q at run time, and every register index stays
//   a compile-time constant.
//   A product takes the other operand's limbs kBase q .. kBase q + kBase - 1
//   (and 32) against all 33 (kBase = 33 / W, rounded down); the square and
//   the m-step take the rows i = q, q + W, ... of their triangles; the
//   shares meet by shared-memory atomic adds into zeroed, padded rows (no
//   share tests which columns it may touch: those tests compiled to
//   branches cost more than the arithmetic); each carry pass runs over a
//   window of columns per share that reads the columns below it. W = 8
//   (16-row tiles) while a launch's tiles are one per SM or fewer (up to
//   2,112 rows: the 2,048-row launches), else W = 4 (32-row tiles), which
//   issues fewer instructions per row. mont_mul and mont_sq keep the row's
//   66-limb accumulator in shared memory and reduce it there: it never
//   reaches device memory (the point of the fused TPU kernel), and one
//   launch does what mul_acc + redc do in two. sq_acc runs mont_sq's square
//   and its two carry passes and stores the accumulator.
// redc_kernel of more than 5 32-row tiles per SM (RedcRanges; past 21,120
//   rows on an H100 SXM, the verify's 24,588-row launches): mul_acc's four
//   column ranges, one code path per warp, PR 2's body, which issues fewer
//   instructions per row than the shares once every SM walks several tiles.
// The share kernels and mul_acc walk their tiles in persistent blocks
//   (kTileLoop; grid = resident blocks, capped by the tile count). A tile's
//   rows are one contiguous span: it is loaded by cp.async.bulk onto an
//   mbarrier, double-buffered so the next tile's load overlaps this tile's
//   products, and stored by cp.async.bulk from shared memory. Bytes past
//   the last 16-byte multiple (the ragged last tile), or every byte when a
//   pointer is not 16-byte aligned, go through plain loads and stores.
// A launch of one tile or less (kOneTilePath; all but mul_acc) is
//   one block whose rows come in by plain coalesced loads and go out by
//   plain coalesced stores, without the mbarrier, its fence, the bulk
//   copies and the tile loop.
// A mont_mul, mont_sq or sq_acc launch of ONE row (kOneRowPath, mont_row
//   and sq_row): the tile paths leave most lanes on rows that do not exist;
//   here all 128 threads of the block work on the one row, a few products
//   and one column of each step each. The squares run as the product a * a
//   (1,089 products, not the square's 561): the same integers, and at one
//   row the time is the barriers and the atomics' latency, not the
//   multiply-adds.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kL = 33;       // limbs of an element
constexpr int kA = 2 * kL;   // limbs of an accumulator

// The carries floor-divide signed limbs by 2^12. C++17 leaves >> of a
// negative int to the implementation; nvcc and its host compilers shift
// arithmetically, and this makes the build fail if one ever does not.
static_assert((-1 >> 1) == -1 && (-4097 >> 12) == -2,
              "signed >> must be an arithmetic shift (floor division)");

__device__ __forceinline__ int floor_div_4096(int v) { return v >> 12; }
// v - floor(v / 4096) * 4096 on the two's-complement pattern
__device__ __forceinline__ int mod_4096(int v) { return v & 0xFFF; }

__constant__ int c_p[kL] = {
    2731, 4090, 4095, 4095, 2558, 4091, 1023, 2837, 4094, 2751, 1054,
    3938, 1712, 2575, 210,  1651, 703,  2129, 1267, 1208, 1143, 3446,
    2988, 1076, 1974, 442,  2635, 3689, 2431, 3747, 273,  416,  0};
// P' = -p^-1 mod 2^396
__constant__ int c_pprime[kL] = {
    4093, 4047, 3327, 4095, 2547, 3720, 275,  3485, 2962, 1709, 2088,
    180,  2275, 3852, 3886, 366,  2892, 2861, 3726, 3232, 2540, 1409,
    2255, 3622, 1790, 2865, 1128, 4041, 3754, 111,  97,   3307, 1952};
// 2p (the high half of the 2Rp offset, and the quotient subtracted after)
__constant__ int c_two_p[kL] = {
    1366, 4085, 4095, 4095, 1021, 4087, 2047, 1578, 4093, 1407, 2109,
    3780, 3425, 1054, 421,  3302, 1406, 162,  2535, 2416, 2286, 2796,
    1881, 2153, 3948, 884,  1174, 3283, 767,  3399, 547,  832,  0};

// ---------------------------------------------------------------------------
// Hopper building blocks: bulk asynchronous copies completing on an mbarrier,
// and bulk stores.

constexpr int kTileRows = 32;  // rows per tile of mul_acc_kernel

// The three ways a kernel walks its rows.
enum Path : int { kTileLoop, kOneTilePath, kOneRowPath };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to bulk copies.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Bytes of a span of `words` int32 words that go by bulk copy: the largest
// multiple of 16, or none when the span does not start 16-byte aligned.
__device__ __forceinline__ uint32_t bulk_bytes(int words, bool aligned) {
  return aligned ? (static_cast<uint32_t>(words) * 4u) & ~15u : 0u;
}

// One thread: arm `bar` and start the bulk copies of a tile's operands
// (op k of the tile goes to dst + k * op_words).
template <int kOps>
__device__ __forceinline__ void tile_load_async(int* dst, int op_words, const int* a,
                                                const int* b, int words, bool aligned,
                                                uint64_t* bar) {
  const uint32_t bytes = bulk_bytes(words, aligned);
  mbar_arrive_expect_tx(bar, kOps * bytes);
  if (bytes) {
    bulk_load(dst, a, bytes, bar);
    if (kOps == 2) bulk_load(dst + op_words, b, bytes, bar);
  }
}

// All threads: the words the bulk copy did not take, with plain loads.
template <int kOps>
__device__ __forceinline__ void tile_load_tail(int* dst, int op_words, const int* a,
                                               const int* b, int words, bool aligned) {
  for (int w = bulk_bytes(words, aligned) / 4 + threadIdx.x; w < words; w += blockDim.x) {
    dst[w] = a[w];
    if (kOps == 2) dst[op_words + w] = b[w];
  }
}

// All threads, after a fence and a barrier: write a tile's results out. On
// return the shared buffer may be rewritten after the next barrier.
__device__ __forceinline__ void tile_store(int* dst, const int* src, int words, bool aligned) {
  const uint32_t bytes = bulk_bytes(words, aligned);
  if (threadIdx.x == 0 && bytes) bulk_store(dst, src, bytes);
  for (int w = bytes / 4 + threadIdx.x; w < words; w += blockDim.x) dst[w] = src[w];
  if (threadIdx.x == 0 && bytes) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// All threads: thread x of the block takes share q = x / K::kRows of the
// tile's row r = x % K::kRows (K::columns), writing the tile's results to
// sh.out.
template <class K>
__device__ __forceinline__ void run_columns(typename K::Shared& sh, int stage) {
  const int x = static_cast<int>(threadIdx.x);
  K::columns(sh, stage, x / K::kRows, x % K::kRows);
}

// The tile loop (kTileLoop) of mul_acc, redc, mont_mul and mont_sq: a
// persistent block of 128 threads walks tiles blockIdx.x, +gridDim.x, ...;
// tile i+1's bulk load is in flight while tile i is computed (two stages,
// one mbarrier each). K gives the operand count and widths, the rows of a
// tile (kRows), its shared memory (in[stage] and out at least), init(sh)
// (run once before the first barrier) and columns(sh, stage, q, r): share
// q of the tile's row r, written to sh.out. Rows past the tile's last are
// computed on stale data and not stored, so every thread reaches every
// barrier in columns.
template <class K>
__device__ __forceinline__ void stream_tiles(const int* __restrict__ a, const int* __restrict__ b,
                                             int* __restrict__ out, int64_t n,
                                             typename K::Shared& sh) {
  constexpr int kRows = K::kRows;
  constexpr int kInWords = kRows * K::kIn;  // per operand
  constexpr int kOutWords = kRows * K::kOut;
  static_assert((kInWords * 4) % 16 == 0 && (kOutWords * 4) % 16 == 0,
                "whole tiles start 16-byte aligned");
  static_assert(K::kThreads % 32 == 0, "whole warps, one share of each row each");
  const int64_t tiles = (n + kRows - 1) / kRows;
  const bool in_aligned =
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
  const bool out_aligned = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  auto rows_of = [&](int64_t tile) {
    const int64_t left = n - tile * kRows;
    return left < kRows ? static_cast<int>(left) : kRows;
  };
  auto issue = [&](int64_t tile, int stage) {
    const int64_t off = tile * kInWords;
    tile_load_async<K::kOps>(sh.in[stage], kInWords, a + off, b + off,
                             rows_of(tile) * K::kIn, in_aligned, &sh.bar[stage]);
  };

  K::init(sh);
  if (threadIdx.x == 0) {
    mbar_init(&sh.bar[0]);
    mbar_init(&sh.bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && blockIdx.x < tiles) issue(blockIdx.x, 0);

  int it = 0;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    const int stage = it & 1;
    // the other stage was last read before the barrier that ended the
    // previous iteration, so its next load can start now
    if (threadIdx.x == 0 && tile + gridDim.x < tiles) issue(tile + gridDim.x, stage ^ 1);
    mbar_wait(&sh.bar[stage], (it >> 1) & 1);
    const int rows = rows_of(tile);
    const int64_t off = tile * kInWords;
    tile_load_tail<K::kOps>(sh.in[stage], kInWords, a + off, b + off, rows * K::kIn,
                            in_aligned);
    fence_proxy_async();
    __syncthreads();
    run_columns<K>(sh, stage);
    fence_proxy_async();
    __syncthreads();
    tile_store(out + tile * kOutWords, sh.out, rows * K::kOut, out_aligned);
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A launch of one tile or less (n <= K::kRows; one block of K::kThreads):
// the rows come in by plain coalesced loads into sh.in[0], all issued
// before the first is stored so their latencies overlap, and go out by
// plain coalesced stores from sh.out. Two barriers besides those of
// columns, and no mbarrier, proxy fence or bulk copy.
template <class K>
__device__ __forceinline__ void one_tile(const int* __restrict__ a, const int* __restrict__ b,
                                         int* __restrict__ out, int n, typename K::Shared& sh) {
  constexpr int kInWords = K::kRows * K::kIn;  // per operand
  constexpr int kPer = (kInWords + K::kThreads - 1) / K::kThreads;
  const int words = n * K::kIn;
  int va[kPer], vb[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int w = threadIdx.x + k * K::kThreads;
    if (w < words) {
      va[k] = a[w];
      if (K::kOps == 2) vb[k] = b[w];
    }
  }
  K::init(sh);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int w = threadIdx.x + k * K::kThreads;
    if (w < words) {
      sh.in[0][w] = va[k];
      if (K::kOps == 2) sh.in[0][kInWords + w] = vb[k];
    }
  }
  __syncthreads();
  run_columns<K>(sh, 0);
  __syncthreads();
  for (int w = threadIdx.x; w < n * K::kOut; w += blockDim.x) out[w] = sh.out[w];
}

// ---------------------------------------------------------------------------
// mul_acc: four threads per row, one column range each, one code path per
// warp.

// Columns [kColStart[q], kColStart[q + 1]) of a product belong to warp q of
// a block: 276, 285, 275 and 253 of its 1089 products.
constexpr int kColStart[5] = {0, 23, 33, 43, kA};

// Columns S..E-1 of the 33x33 convolution of one row, over compile-time limb
// indices: only the limbs these columns use are loaded, all into registers.
template <int S, int E>
__device__ __forceinline__ void conv_columns(const int* ra, const int* rb, int (&v)[E - S]) {
  constexpr int kLo = S > kL - 1 ? S - (kL - 1) : 0;
  constexpr int kHi = E - 1 < kL - 1 ? E - 1 : kL - 1;
  int a[kL], b[kL];
#pragma unroll
  for (int i = kLo; i <= kHi; ++i) {
    a[i] = ra[i];
    b[i] = rb[i];
  }
#pragma unroll
  for (int c = S; c < E; ++c) {
    int sum = 0;
#pragma unroll
    for (int i = c > kL - 1 ? c - (kL - 1) : 0; i <= (c < kL - 1 ? c : kL - 1); ++i)
      sum += a[i] * b[c - i];
    v[c - S] = sum;
  }
}

// Two carry passes over columns [S, S + W) of row r, whose column ranges
// are spread over the block's warps Q = 0..3. A pass's carry into a range's
// first column comes from the range below, which computes both passes'
// carries out of its top column from its own top two columns: each range
// publishes those in `carry`, one barrier, and takes its own. KEEP_TOP:
// column TOP keeps its whole value (the value is preserved); otherwise the
// carry out of it is dropped (the mod-R truncation of the m-step). W >= 2.
template <int Q, int S, int W, int TOP, bool KEEP_TOP>
__device__ __forceinline__ void carry2_range(int2 (&carry)[3][kTileRows], int r, int (&v)[W]) {
  auto low = [](int x, int col) { return KEEP_TOP && col == TOP ? x : mod_4096(x); };
  if (Q < 3) {
    const int x1_top = low(v[W - 1], S + W - 1) + floor_div_4096(v[W - 2]);
    carry[Q][r] = make_int2(floor_div_4096(v[W - 1]), floor_div_4096(x1_top));
  }
  __syncthreads();
  const int2 cin = Q ? carry[Q ? Q - 1 : 0][r] : make_int2(0, 0);
  int x1[W];
#pragma unroll
  for (int c = 0; c < W; ++c) x1[c] = low(v[c], S + c) + (c ? floor_div_4096(v[c - 1]) : cin.x);
#pragma unroll
  for (int c = 0; c < W; ++c) v[c] = low(x1[c], S + c) + (c ? floor_div_4096(x1[c - 1]) : cin.y);
}

struct MulAcc {
  static constexpr int kOps = 2, kIn = kL, kOut = kA, kRows = kTileRows;
  static constexpr int kThreads = 128;  // warp q: column range q of the tile's 32 rows
  struct Shared {
    uint64_t bar[2];
    alignas(16) int in[2][2 * kTileRows * kL];
    alignas(16) int out[kTileRows * kA];
    int2 carry[3][kTileRows];  // carries out of a range's top column: pass 1, pass 2
  };

  __device__ static void init(Shared&) {}

  // Thread (warp q, lane r): columns of range q of row r, both carry passes.
  __device__ static void columns(Shared& sh, int stage, int q, int r) {
    switch (q) {
      case 0: range<0>(sh, stage, r); break;
      case 1: range<1>(sh, stage, r); break;
      case 2: range<2>(sh, stage, r); break;
      default: range<3>(sh, stage, r); break;
    }
  }

  template <int Q>
  __device__ static void range(Shared& sh, int stage, int r) {
    constexpr int S = kColStart[Q], E = kColStart[Q + 1], W = E - S;
    int v[W];
    conv_columns<S, E>(sh.in[stage] + r * kL, sh.in[stage] + kTileRows * kL + r * kL, v);
    carry2_range<Q, S, W, kA - 1, true>(sh.carry, r, v);
#pragma unroll
    for (int c = 0; c < W; ++c) sh.out[r * kA + S + c] = v[c];
  }
};

// ---------------------------------------------------------------------------
// redc of a launch of many tiles per SM (RedcRanges, tile loop only):
// mul_acc's split, four threads per row, one column range and code path per
// warp. It issues fewer instructions per row than the one-code-path shares
// below, where every share runs the largest share's work; that wins once
// each SM walks several tiles (PERF.md).

// Columns of m = t_lo * P' per warp: 136, 140, 130 and 155 of 561 products.
constexpr int kMColStart[5] = {0, 16, 23, 28, kL};

struct RedcRanges {
  static constexpr int kOps = 1, kIn = kA, kOut = kL, kRows = kTileRows;
  static constexpr int kThreads = 128;  // warp q: column range q of the tile's 32 rows
  struct Shared {
    uint64_t bar[2];
    alignas(16) int in[2][kTileRows * kA];
    alignas(16) int out[kTileRows * kL];
    int2 carry[3][kTileRows];
    int m[kTileRows][kL];
  };

  __device__ static void init(Shared&) {}

  __device__ static void columns(Shared& sh, int stage, int q, int r) {
    switch (q) {
      case 0: range<0>(sh, stage, r); break;
      case 1: range<1>(sh, stage, r); break;
      case 2: range<2>(sh, stage, r); break;
      default: range<3>(sh, stage, r); break;
    }
  }

  // Limb c of t after one carry pass (top limb kept), from the raw row.
  __device__ static int t_carried(const int* t, int c) {
    return (c == kA - 1 ? t[c] : mod_4096(t[c])) + (c ? floor_div_4096(t[c - 1]) : 0);
  }

  template <int Q>
  __device__ static void range(Shared& sh, int stage, int r) {
    int* t = sh.in[stage] + r * kA;
    // m = t_lo * P' mod R over this warp's m columns
    constexpr int MS = kMColStart[Q], ME = kMColStart[Q + 1], MW = ME - MS;
    int tl[kL];
#pragma unroll
    for (int i = 0; i < ME; ++i) tl[i] = t_carried(t, i);
    int m[MW];
#pragma unroll
    for (int k = MS; k < ME; ++k) {
      int sum = 0;
#pragma unroll
      for (int i = 0; i <= k; ++i) sum += tl[i] * c_pprime[k - i];
      m[k - MS] = sum;
    }
    carry2_range<Q, MS, MW, kL - 1, false>(sh.carry, r, m);  // mod R: top carries dropped
#pragma unroll
    for (int k = 0; k < MW; ++k) sh.m[r][MS + k] = m[k];
    __syncthreads();

    // t + m * p + 2Rp over this warp's product columns
    constexpr int S = kColStart[Q], E = kColStart[Q + 1], W = E - S;
    constexpr int kLo = S > kL - 1 ? S - (kL - 1) : 0;
    constexpr int kHi = E - 1 < kL - 1 ? E - 1 : kL - 1;
    int mm[kL];
#pragma unroll
    for (int i = kLo; i <= kHi; ++i) mm[i] = sh.m[r][i];
    int v[W];
#pragma unroll
    for (int c = S; c < E; ++c) {
      int sum = t_carried(t, c) + (c >= kL ? c_two_p[c - kL] : 0);
#pragma unroll
      for (int i = c > kL - 1 ? c - (kL - 1) : 0; i <= (c < kL - 1 ? c : kL - 1); ++i)
        if (c - i != kL - 1) sum += mm[i] * c_p[c - i];  // p's top limb is 0
      v[c - S] = sum;
    }
    __syncthreads();  // every thread has read its row of t: it can take the sums
    carry2_range<Q, S, W, kA - 1, true>(sh.carry, r, v);
    if (E > 32) {  // columns 32..65 into the row's place in the input stage
#pragma unroll
      for (int c = S < 32 ? 32 : S; c < E; ++c) t[c - 32] = v[c - S];
    }
    __syncthreads();

    // out = x[33..65] - 2p (+1 when the low half is R), one carry pass
    const int carry = t[0] >= 2048 ? 1 : 0;
    for (int k = Q; k < kL; k += 4) {
      const int vk = t[1 + k] - c_two_p[k] + (k == 0 ? carry : 0);
      const int cin = k ? floor_div_4096(t[k] - c_two_p[k - 1] + (k == 1 ? carry : 0)) : 0;
      sh.out[r * kL + k] = (k == kL - 1 ? vk : mod_4096(vk)) + cin;
    }
  }
};


// ---------------------------------------------------------------------------
// redc, mont_mul, mont_sq and sq_acc: W threads (shares) per row, all
// threads of a block on ONE code path. Thread x of a 128-thread block takes
// share q = x / R of row x % R of its R-row tile (R = 128 / W), through
// offsets computed from q at run time, while every register index stays a
// compile-time constant: the threads run the same instructions, and q may
// differ between the lanes of a warp. Warps on separate code paths fetch
// that many times the code, and a short kernel of straight-line code is
// set by its instruction fetch, more so the more SMs fetch at once
// (PERF.md, PR 3). The shares of a step cross threads
// through shared memory: partial products by shared-memory atomic adds
// into zeroed rows, carry passes by reading the columns below a share's
// range (a pass needs one column of look-back). The rows are padded, with
// zero columns below column 0 and spare columns above the top, so that no
// share needs a test of which columns it may touch: the compiler makes
// each such test a branch with a reconvergence barrier, and a few dozen of
// them cost more than the arithmetic they guard (PERF.md). Reads past a
// row's top column land in the next row (or the next array of the block's
// shared memory) and reach only columns that are not written.
//
// W = 8 (16-row tiles) gives a launch of up to 16 rows per SM one tile per
// SM and half the chain of W = 4 (32-row tiles), which issues fewer
// instructions per row and so takes more rows per SM better: the entry
// points take W = 8 while n <= 16 x the SM count (a 2,048-row launch: 128
// tiles), else W = 4.

constexpr int kShareThreads = 128;  // threads a block of these kernels

template <int W>
struct Split {
  static_assert(kShareThreads % W == 0 && (kL / W) * W + 1 == kL, "33 = W * kBase + 1");
  static constexpr int kRows = kShareThreads / W;  // rows per tile
  static constexpr int kBase = kL / W;    // operand limbs a share takes in a product step
  static constexpr int kSlots = kBase + 1;  // ... and one more, limb 32, for the last share
  static constexpr int kCW = (kA + W - 1) / W;  // columns a share carries of a 66-limb row
  static constexpr int kMW = (kL + W - 1) / W;  // limbs a share carries of a 33-limb row
};

constexpr int odd(int n) { return n | 1; }  // an odd row stride: 32 rows, 32 banks

// PASSES carry passes over a window x of consecutive columns, in place and
// from the top down, so each pass reads the last pass's x[k - 1]: afterwards
// x[k] is exact for k >= PASSES (the window's first PASSES columns lack
// the carries from below it). The column at index TOP_K, when has_top (the
// accumulator's top column, in one share's window), keeps its whole value;
// every other column keeps its low 12 bits, and what passes out of the
// window's last column is dropped.
template <int PASSES, int TOP_K, int N>
__device__ __forceinline__ void carry_window(int (&x)[N], bool has_top) {
#pragma unroll
  for (int pass = 0; pass < PASSES; ++pass) {
#pragma unroll
    for (int k = N - 1; k > 0; --k)
      x[k] = (k == TOP_K && has_top ? x[k] : mod_4096(x[k])) + floor_div_4096(x[k - 1]);
  }
}

// t += a * b over share q: b limbs j = kBase q + s for s < kBase (and limb
// 32 for the last share; the extra slot multiplies by zero for the others)
// times all 33 limbs of a, into the columns from kBase q.
template <int W>
__device__ __forceinline__ void product_step(const int* ra, const int* rb, int* t, int q) {
  using S = Split<W>;
  constexpr int kP = S::kSlots + kL - 1;
  int a[kL];
#pragma unroll
  for (int i = 0; i < kL; ++i) a[i] = ra[i];
  int p[kP];
#pragma unroll
  for (int k = 0; k < kP; ++k) p[k] = 0;
#pragma unroll
  for (int s = 0; s < S::kSlots; ++s) {
    const int v = rb[S::kBase * q + s];  // limb kBase q + kBase <= 32 of the row
    const int bj = s < S::kBase || q == W - 1 ? v : 0;
#pragma unroll
    for (int i = 0; i < kL; ++i) p[s + i] += a[i] * bj;
  }
#pragma unroll
  for (int k = 0; k < kP; ++k) atomicAdd(&t[S::kBase * q + k], p[k]);
}

// t += a * a over share q: the rows i = q, q + W, ... of the square's
// triangle, each a_i * a_j for j >= i, doubled off the diagonal (561
// products over the shares; each thread runs the share of q = 0, on zero
// limbs past limb 32). a is read rotated by q, A[k] = a[q + k], so a_i * a_j
// is A[W s] * A[W s + k] and lands in column 2q + 2Ws + k: the register
// indices are compile-time constants. ra is read up to ra[W + 31], past
// the row, which the rotation sets to zero.
template <int W>
__device__ __forceinline__ void square_step(const int* ra, int* t, int q) {
  using S = Split<W>;
  constexpr int kP = 2 * kL - 1;
  int A[kL];
#pragma unroll
  for (int k = 0; k < kL; ++k) {
    const int v = ra[q + k];
    A[k] = k <= kL - W || q + k < kL ? v : 0;
  }
  int p[kP];
#pragma unroll
  for (int k = 0; k < kP; ++k) p[k] = 0;
#pragma unroll
  for (int s = 0; s < S::kSlots; ++s) {
    const int ai = A[W * s], ai2 = 2 * A[W * s];
    p[2 * W * s] += ai * ai;
#pragma unroll
    for (int k = 1; W * s + k < kL; ++k) p[2 * W * s + k] += ai2 * A[W * s + k];
  }
#pragma unroll
  for (int k = 0; k < kP; ++k) atomicAdd(&t[2 * q + k], p[k]);  // t[66..]: spare columns
}

// PASSES carry passes (the top column keeps its value) of a 66-limb row
// src, over share q's columns [kCW q, kCW q + kCW), written to u with the
// 2Rp offset of the reduction added (2p in columns 33..65); columns from 66
// up to kCW * W are spare. src is read from src[-PASSES] (zero below
// column 0) up.
template <int W, int PASSES>
__device__ __forceinline__ void carry_into_u(const int* src, int* u, int q) {
  using S = Split<W>;
  constexpr int kN = S::kCW + PASSES;
  constexpr int kTopShare = (kA - 1) / S::kCW;
  const int c0 = S::kCW * q - PASSES;  // the first column read: PASSES of look-back
  int x[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const bool below = k < PASSES && c0 + k < 0;
    const int v = src[below ? 0 : c0 + k];
    x[k] = below ? 0 : v;
  }
  carry_window<PASSES, kA - 1 - (S::kCW * kTopShare - PASSES)>(x, q == kTopShare);
#pragma unroll
  for (int k = PASSES; k < kN; ++k) {
    const int c = c0 + k;
    u[c] = x[k] + (c >= kL && c < kA ? c_two_p[c - kL] : 0);
  }
}

// m += t_lo * P' mod R over share q: the rows i = q, q + W, ... of the
// 561-product triangle (each thread runs the share of q = 0), each
// t_i * P'_k into column i + k - q of its partial sums; columns >= 33 are
// dropped later (mod R).
template <int W>
__device__ __forceinline__ void m_step(const int* u, int* m, int q) {
  using S = Split<W>;
  int p[kL];
#pragma unroll
  for (int k = 0; k < kL; ++k) p[k] = 0;
#pragma unroll
  for (int s = 0; s < S::kSlots; ++s) {
    const int v = u[q + W * s];
    const int ti = s < S::kBase || q == 0 ? v : 0;  // t_i for i <= 32 only
#pragma unroll
    for (int k = 0; W * s + k < kL; ++k) p[W * s + k] += ti * c_pprime[k];
  }
#pragma unroll
  for (int k = 0; k < kL; ++k) atomicAdd(&m[q + k], p[k]);  // m[33..]: spare columns
}

// Two carry passes of m mod R (every limb masked, the top carry dropped)
// over share q's limbs [kMW q, kMW q + kMW), into m2 (limbs from 33 up to
// kMW * W are spare). m is read from m[-2] (zero) up.
template <int W>
__device__ __forceinline__ void carry_m(const int* m, int* m2, int q) {
  using S = Split<W>;
  constexpr int kN = S::kMW + 2;
  const int c0 = S::kMW * q - 2;
  int x[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) x[k] = m[c0 + k];
  carry_window<2, -1>(x, false);
#pragma unroll
  for (int k = 2; k < kN; ++k) m2[c0 + k] = x[k];
}

// u += m * p over share q: m limbs j = kBase q + s (and 32 for the last
// share) times p's 32 nonzero limbs (its top limb is 0), into the columns
// from kBase q.
template <int W>
__device__ __forceinline__ void mp_step(const int* m2, int* u, int q) {
  using S = Split<W>;
  constexpr int kP = S::kSlots + kL - 2;
  int p[kP];
#pragma unroll
  for (int k = 0; k < kP; ++k) p[k] = 0;
#pragma unroll
  for (int s = 0; s < S::kSlots; ++s) {
    const int v = m2[S::kBase * q + s];
    const int mj = s < S::kBase || q == W - 1 ? v : 0;
#pragma unroll
    for (int k = 0; k < kL - 1; ++k) p[s + k] += mj * c_p[k];
  }
#pragma unroll
  for (int k = 0; k < kP; ++k) atomicAdd(&u[S::kBase * q + k], p[k]);
}

// out = x[33..65] - 2p (+1 when the low half x[0..32] is R, not 0), one
// carry pass keeping the top limb, where x = u after two carry passes:
// share q's output limbs kBase q + s for s < kBase (and limb 32 for the
// last share), from u[30 + kBase q ..] (two columns of look-back for x, one
// more for the carry into its first limb) and u[30..32] for x[32], the low
// half's test.
template <int W>
__device__ __forceinline__ void redc_out(const int* u, int* out, int q) {
  using S = Split<W>;
  constexpr int kN = S::kSlots + 3;
  constexpr int kTop = kA - 1 - (30 + S::kBase * (W - 1));  // column 65, last share
  const int k0 = S::kBase * q;
  const int c0 = 30 + k0;
  int x[kN];  // after the passes, x[k] = carried column c0 + k for k >= 2
#pragma unroll
  for (int k = 0; k < kN; ++k) x[k] = u[c0 + k];
  carry_window<2, kTop>(x, q == W - 1);
  const int w31 = mod_4096(u[31]) + floor_div_4096(u[30]);
  const int w32 = mod_4096(u[32]) + floor_div_4096(u[31]);
  const int low_is_r = mod_4096(w32) + floor_div_4096(w31) >= 2048 ? 1 : 0;
#pragma unroll
  for (int s = 0; s < S::kSlots; ++s) {
    const int limb = k0 + s;
    const int v = x[s + 3] - c_two_p[limb] + (limb == 0 ? low_is_r : 0);
    const int below = x[s + 2] - c_two_p[limb ? limb - 1 : 0] + (limb == 1 ? low_is_r : 0);
    const int o = (s == S::kBase ? v : mod_4096(v)) + (limb ? floor_div_4096(below) : 0);
    if (s < S::kBase) {
      out[limb] = o;
    } else if (q == W - 1) {
      out[limb] = o;  // limb 32, which keeps its carry
    }
  }
}

// Shared memory of the reduction, per row: u (the carried accumulator plus
// 2Rp, then plus m * p), m (the m-step's partial sums, zero between tiles;
// two zero columns below column 0) and m2 (m mod R, carried), each with the
// spare columns above the top that its shares reach.
template <int W>
struct RedcRows {
  using S = Split<W>;
  static constexpr int kMLead = 2;
  static constexpr int kMCols = kL + W - 1 > S::kMW * W ? kL + W - 1 : S::kMW * W;
  int u[S::kRows][odd(S::kCW * W)];
  int m[S::kRows][odd(kMLead + kMCols)];
  int m2[S::kRows][odd(S::kMW * W)];
  __device__ int* m_row(int r) { return m[r] + kMLead; }
};

__device__ __forceinline__ void zero_words(int* p, int words) {
  for (int w = threadIdx.x; w < words; w += blockDim.x) p[w] = 0;
}

// The Montgomery reduction of row r (fp_pallas _redc_rows) once
// sh.u[r] holds (t carried once) + 2Rp and every thread has passed a
// barrier: (t + m*p + 2Rp) / R - 2p with m = t_lo * P' mod R, into out (the
// row's 33 limbs); exact zero stays exact zero. Three barriers, which every
// thread of the block reaches; leaves sh.m zero for the next tile.
template <int W>
__device__ __forceinline__ void redc_rows(RedcRows<W>& sh, int q, int r, int* out) {
  constexpr int kMW = Split<W>::kMW;
  m_step<W>(sh.u[r], sh.m_row(r), q);
  __syncthreads();
  carry_m<W>(sh.m_row(r), sh.m2[r], q);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kMW; ++k) sh.m_row(r)[kMW * q + k] = 0;  // every read of m is done
  mp_step<W>(sh.m2[r], sh.u[r], q);
  __syncthreads();
  redc_out<W>(sh.u[r], out, q);
}

template <int W>
struct Redc {
  static constexpr int kOps = 1, kIn = kA, kOut = kL, kRows = Split<W>::kRows;
  static constexpr int kThreads = kShareThreads;
  struct Shared {
    uint64_t bar[2];
    alignas(16) int in[2][kRows * kA];
    alignas(16) int out[kRows * kL];
    RedcRows<W> red;
  };

  __device__ static void init(Shared& sh) { zero_words(&sh.red.m[0][0], sizeof(sh.red.m) / 4); }

  __device__ static void columns(Shared& sh, int stage, int q, int r) {
    carry_into_u<W, 1>(sh.in[stage] + r * kA, sh.red.u[r], q);
    __syncthreads();
    redc_rows<W>(sh.red, q, r, sh.out + r * kL);
  }
};

// mont_mul (SQUARE = false) and mont_sq (SQUARE = true): the product's
// partial sums into the row's accumulator t in shared memory, three carry
// passes (mul_acc's two and the reduction's one) into u, then the
// reduction: the accumulator never reaches device memory.
template <bool SQUARE, int W>
struct MontMul {
  using S = Split<W>;
  static constexpr int kOps = SQUARE ? 1 : 2, kIn = kL, kOut = kL, kRows = S::kRows;
  static constexpr int kThreads = kShareThreads;
  static constexpr int kTLead = 3;  // zero columns below column 0: the carries' look-back
  // the square's atomics reach column 2 (W - 1) + 64, the clearing kCW * W - 1
  static constexpr int kTCols = SQUARE && 2 * (W - 1) + 2 * kL - 1 > S::kCW * W
                                    ? 2 * (W - 1) + 2 * kL - 1
                                    : S::kCW * W;
  struct Shared {
    uint64_t bar[2];
    alignas(16) int in[2][kOps * kRows * kL];
    alignas(16) int out[kRows * kL];
    int t[kRows][odd(kTLead + kTCols)];  // the product's columns, zero between tiles
    RedcRows<W> red;
  };

  __device__ static void init(Shared& sh) {
    zero_words(&sh.t[0][0], sizeof(sh.t) / 4);
    zero_words(&sh.red.m[0][0], sizeof(sh.red.m) / 4);
  }

  __device__ static void columns(Shared& sh, int stage, int q, int r) {
    const int* ra = sh.in[stage] + r * kL;
    int* t = sh.t[r] + kTLead;
    if constexpr (SQUARE) {
      square_step<W>(ra, t, q);
    } else {
      product_step<W>(ra, ra + kRows * kL, t, q);
    }
    __syncthreads();
    carry_into_u<W, 3>(t, sh.red.u[r], q);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < S::kCW; ++k) t[S::kCW * q + k] = 0;  // every read of t is done
    redc_rows<W>(sh.red, q, r, sh.out + r * kL);
  }
};

// Two carry passes (the top column keeps its value) of a 66-limb row t over
// share q's columns [kCW q, kCW q + kCW), stored to the output row out;
// the columns from 66 up to kCW * W go to `spare`, a word nothing reads (a
// store address chosen by a select, where a test would be a branch). t is
// read from t[-2] (zero below column 0) up.
template <int W>
__device__ __forceinline__ void carry_out(const int* t, int* out, int* spare, int q) {
  using S = Split<W>;
  constexpr int kN = S::kCW + 2;
  constexpr int kTopShare = (kA - 1) / S::kCW;
  const int c0 = S::kCW * q - 2;  // the first column read: two of look-back
  int x[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) x[k] = t[c0 + k];
  carry_window<2, kA - 1 - (S::kCW * kTopShare - 2)>(x, q == kTopShare);
#pragma unroll
  for (int k = 2; k < kN; ++k) {
    const int c = c0 + k;
    *(c < kA ? out + c : spare) = x[k];
  }
}

// sq_acc: the square's partial sums into the row's columns t in shared
// memory (square_step, as mont_sq), then the two carry passes that keep
// the top limb, stored as the 66-limb accumulator: no reduction.
template <int W>
struct SqAcc {
  using S = Split<W>;
  static constexpr int kOps = 1, kIn = kL, kOut = kA, kRows = S::kRows;
  static constexpr int kThreads = kShareThreads;
  static constexpr int kTLead = 2;  // zero columns below column 0: the carries' look-back
  // the square's atomics reach column 2 (W - 1) + 64, the carries kCW * W - 1
  static constexpr int kTCols =
      2 * (W - 1) + 2 * kL - 1 > S::kCW * W ? 2 * (W - 1) + 2 * kL - 1 : S::kCW * W;
  struct Shared {
    uint64_t bar[2];
    alignas(16) int in[2][kRows * kL];
    alignas(16) int out[kRows * kA];
    int t[kRows][odd(kTLead + kTCols)];  // the square's columns, zero between tiles
    int spare;
  };

  __device__ static void init(Shared& sh) { zero_words(&sh.t[0][0], sizeof(sh.t) / 4); }

  __device__ static void columns(Shared& sh, int stage, int q, int r) {
    int* t = sh.t[r] + kTLead;
    square_step<W>(sh.in[stage] + r * kL, t, q);
    __syncthreads();
    carry_out<W>(t, sh.out + r * kA, &sh.spare, q);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < S::kCW; ++k) t[S::kCW * q + k] = 0;  // every read of t is done
  }
};

// ---------------------------------------------------------------------------
// mont_mul and mont_sq of ONE row, the Fermat chains' launches (760 of each
// per 2048-set verify, one after the other): there the tile paths leave 30
// of each warp's 32 lanes on rows that do not exist, and the time is one
// thread's chain. Here one block of kRowThreads threads works on the one row:
// thread (warp q, lane l) takes operand limbs i = l (and i = 32 on lane 0)
// against the slots j = 8q + s of the other operand (the ninth, limb 32,
// for warp 3) in each product step, 18 products into as many columns by
// shared-memory atomic adds, and one column in each carry pass. The row's
// limbs come straight from device memory; six barriers. A square runs as
// the product of a with itself: the integers are those of the square.

constexpr int kRowThreads = 128;  // four warps: 4 x 8 slots + limb 32
static_assert(kRowThreads == kShareThreads, "the kernels' launch bounds");

// Thread (warp q, lane l) of a one-row launch's kRowThreads threads: its
// part of the product a * b, operand limb a_l (and a_32 on lane 0) against
// the slots b_j, j = 8q + s (s < 8, and s = 8, limb 32, on warp 3). The
// operands load on construction, so the loads are in flight while the
// caller zeroes its rows; add_to adds the 18 products into the columns of
// t (up to column 95) by shared-memory atomic adds.
struct RowProduct {
  int q, lane, a_lo, a_hi, bj[9];

  __device__ __forceinline__ RowProduct(const int* __restrict__ a, const int* __restrict__ b)
      : q(static_cast<int>(threadIdx.x) >> 5), lane(static_cast<int>(threadIdx.x) & 31) {
    a_lo = a[lane];
    a_hi = lane == 0 ? a[lane == 0 ? 32 : 0] : 0;  // limb 32 on lane 0
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      const int v = b[8 * q + s];
      bj[s] = s < 8 || q == 3 ? v : 0;
    }
  }

  __device__ __forceinline__ void add_to(int* t) const {
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      atomicAdd(&t[lane + 8 * q + s], a_lo * bj[s]);
      atomicAdd(&t[lane + 32 + 8 * q + s], a_hi * bj[s]);
    }
  }
};

__device__ __forceinline__ void mont_row(const int* __restrict__ a, const int* __restrict__ b,
                                         int* __restrict__ out) {
  // Every array is as wide as any thread reads or adds to (up to column
  // 127, past the row), so no thread tests a column; t and m have zero
  // columns below column 0 for the carries' look-back.
  constexpr int kW = kRowThreads;
  __shared__ int t_[3 + kW], u[kW + 4], m_[3 + kW], m2[kW];
  int* t = t_ + 3;
  int* m = m_ + 2;
  const int tid = threadIdx.x, q = tid >> 5, lane = tid & 31;
  const RowProduct prod(a, b);
  t_[tid] = 0;
  m_[tid] = 0;
  if (tid < 3) {
    t_[kW + tid] = 0;
    m_[kW + tid] = 0;
  }
  __syncthreads();
  prod.add_to(t);  // t = a * b
  __syncthreads();

  // u = t after three carry passes (the top column keeps its value) + 2Rp
  {
    const int c = tid;
    int x[4] = {t[c - 3], t[c - 2], t[c - 1], t[c]};
    carry_window<3, 3>(x, c == kA - 1);
    u[c] = x[3] + (c >= kL && c < kA ? c_two_p[c - kL] : 0);
  }
  __syncthreads();

  // m = t_lo * P' (columns past 32 are dropped below: mod R)
  {
    const int t_lo = u[lane];
    const int t_hi = lane == 0 ? u[32] : 0;
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      const int pk = s < 8 || q == 3 ? c_pprime[8 * q + s] : 0;
      atomicAdd(&m[lane + 8 * q + s], t_lo * pk);
      atomicAdd(&m[lane + 32 + 8 * q + s], t_hi * pk);
    }
  }
  __syncthreads();

  // m2 = m mod R after two carry passes
  {
    const int c = tid;
    int x[3] = {m[c - 2], m[c - 1], m[c]};
    carry_window<2, -1>(x, false);
    m2[c] = x[2];
  }
  __syncthreads();

  // u += m * p (p's top limb is 0)
  {
    const int m_lo = m2[lane];
    const int m_hi = lane == 0 ? m2[32] : 0;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int pk = c_p[8 * q + s];
      atomicAdd(&u[lane + 8 * q + s], m_lo * pk);
      atomicAdd(&u[lane + 32 + 8 * q + s], m_hi * pk);
    }
  }
  __syncthreads();

  // out = x[33..65] - 2p (+1 when the low half is R), one carry pass
  // keeping the top limb, x = u after two carry passes (limb = tid < 33)
  {
    const int limb = tid & 63;
    int x[4] = {u[30 + limb], u[31 + limb], u[32 + limb], u[33 + limb]};
    carry_window<2, 3>(x, limb == kL - 1);  // column 65 keeps its value
    const int w31 = mod_4096(u[31]) + floor_div_4096(u[30]);
    const int w32 = mod_4096(u[32]) + floor_div_4096(u[31]);
    const int low_is_r = mod_4096(w32) + floor_div_4096(w31) >= 2048 ? 1 : 0;
    const int idx = limb < kL ? limb : 0;
    const int v = x[3] - c_two_p[idx] + (limb == 0 ? low_is_r : 0);
    const int below = x[2] - c_two_p[idx ? idx - 1 : 0] + (limb == 1 ? low_is_r : 0);
    const int o = (limb == kL - 1 ? v : mod_4096(v)) + (limb ? floor_div_4096(below) : 0);
    if (tid < kL) out[tid] = o;
  }
}

// sq_acc of ONE row: all kRowThreads threads on the row, the square as the
// product a * a (RowProduct, as mont_row; 1,089 products, the same
// integers), then the two carry passes, one column a thread. Two barriers.
__device__ __forceinline__ void sq_row(const int* __restrict__ a, int* __restrict__ out) {
  constexpr int kW = kRowThreads;
  __shared__ int t_[2 + kW];  // two zero columns below column 0, up to column 127
  int* t = t_ + 2;
  const int tid = threadIdx.x;
  const RowProduct prod(a, a);
  t_[tid] = 0;
  if (tid < 2) t_[kW + tid] = 0;
  __syncthreads();
  prod.add_to(t);  // t = a * a
  __syncthreads();
  const int c = tid;
  int x[3] = {t[c - 2], t[c - 1], t[c]};
  carry_window<2, 2>(x, c == kA - 1);  // column 65 keeps its value
  if (c < kA) out[c] = x[2];
}

__global__ void __launch_bounds__(MulAcc::kThreads)
    mul_acc_kernel(const int* __restrict__ a, const int* __restrict__ b,
                   int* __restrict__ out, int64_t n) {
  __shared__ MulAcc::Shared sh;
  stream_tiles<MulAcc>(a, b, out, n, sh);
}

// K: Redc<W> (W shares a row) or RedcRanges (tile loop only).
template <int PATH, class K>
__global__ void __launch_bounds__(kShareThreads)
    redc_kernel(const int* __restrict__ t, int* __restrict__ out, int64_t n) {
  __shared__ typename K::Shared sh;
  if constexpr (PATH == kOneTilePath) {
    one_tile<K>(t, t, out, static_cast<int>(n), sh);
  } else {
    stream_tiles<K>(t, t, out, n, sh);
  }
}

template <int PATH, int W>
__global__ void __launch_bounds__(kShareThreads)
    mont_mul_kernel(const int* __restrict__ a, const int* __restrict__ b,
                    int* __restrict__ out, int64_t n) {
  using K = MontMul<false, W>;
  if constexpr (PATH == kOneRowPath) {
    mont_row(a, b, out);
  } else {
    __shared__ typename K::Shared sh;
    if constexpr (PATH == kOneTilePath) {
      one_tile<K>(a, b, out, static_cast<int>(n), sh);
    } else {
      stream_tiles<K>(a, b, out, n, sh);
    }
  }
}

template <int PATH, int W>
__global__ void __launch_bounds__(kShareThreads)
    mont_sq_kernel(const int* __restrict__ a, int* __restrict__ out, int64_t n) {
  using K = MontMul<true, W>;
  if constexpr (PATH == kOneRowPath) {
    mont_row(a, a, out);  // one row: the square as a product (the same integers)
  } else {
    __shared__ typename K::Shared sh;
    if constexpr (PATH == kOneTilePath) {
      one_tile<K>(a, a, out, static_cast<int>(n), sh);
    } else {
      stream_tiles<K>(a, a, out, n, sh);
    }
  }
}

template <int PATH, int W>
__global__ void __launch_bounds__(kShareThreads)
    sq_acc_kernel(const int* __restrict__ a, int* __restrict__ out, int64_t n) {
  using K = SqAcc<W>;
  if constexpr (PATH == kOneRowPath) {
    sq_row(a, out);
  } else {
    __shared__ typename K::Shared sh;
    if constexpr (PATH == kOneTilePath) {
      one_tile<K>(a, a, out, static_cast<int>(n), sh);
    } else {
      stream_tiles<K>(a, a, out, n, sh);
    }
  }
}

// SMs of the current device (cached per device).
int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int& count = sms[dev & 63];
  if (count == 0) cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  return count;
}

// Persistent grid of `kernel`: as many blocks as fit on the card at once,
// at most one per tile. Each kernel's per-device count is cached after its
// first launch.
template <auto kernel>
unsigned persistent_grid(int threads, int64_t n, int rows) {
  static int resident[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int& cap = resident[dev & 63];
  if (cap == 0) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    cap = sm_count() * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t tiles = (n + rows - 1) / rows;
  return static_cast<unsigned>(tiles < cap ? tiles : cap);
}

// Shares per row for a launch of n rows (Split): 8 while the 16-row tiles
// are one per SM or fewer, else 4.
inline int shares_for(int64_t n) {
  return n <= 16 * static_cast<int64_t>(sm_count()) ? 8 : 4;
}

// redc takes RedcRanges once a launch has more than this many 32-row tiles
// per SM (PERF.md).
constexpr int kRangesTilesPerSm = 5;

// One launch of redc, mont_mul or mont_sq at W shares a row: the one-tile
// kernel for a launch of one tile or less, else the tile loop.
template <class K, auto one_tile_kernel, auto tile_kernel, class... Ptrs>
void launch_tiles(int64_t n, cudaStream_t s, Ptrs... ptrs) {
  if (n <= K::kRows) {
    one_tile_kernel<<<1, K::kThreads, 0, s>>>(ptrs..., n);
  } else {
    tile_kernel<<<persistent_grid<tile_kernel>(K::kThreads, n, K::kRows), K::kThreads, 0, s>>>(
        ptrs..., n);
  }
}

}  // namespace

// Plain C interface (bound with ctypes): row-major contiguous int32 rows,
// n > 0 rows, launched on `stream` without synchronising. Returns the
// cudaError_t of the launch (0 when it was accepted).
extern "C" {

int lodestar_fp_mul_acc(const int* a, const int* b, int* out, int64_t n, void* stream) {
  mul_acc_kernel<<<persistent_grid<mul_acc_kernel>(MulAcc::kThreads, n, MulAcc::kRows),
                   MulAcc::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, b, out, n);
  return static_cast<int>(cudaGetLastError());
}

int lodestar_fp_sq_acc(const int* a, int* out, int64_t n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 1) {
    sq_acc_kernel<kOneRowPath, 8><<<1, kRowThreads, 0, s>>>(a, out, n);
    return static_cast<int>(cudaGetLastError());
  }
  if (shares_for(n) == 8) {
    launch_tiles<SqAcc<8>, sq_acc_kernel<kOneTilePath, 8>, sq_acc_kernel<kTileLoop, 8>>(
        n, s, a, out);
  } else {
    launch_tiles<SqAcc<4>, sq_acc_kernel<kOneTilePath, 4>, sq_acc_kernel<kTileLoop, 4>>(
        n, s, a, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int lodestar_fp_redc(const int* t, int* out, int64_t n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > static_cast<int64_t>(kRangesTilesPerSm) * kTileRows * sm_count()) {
    const unsigned grid = persistent_grid<redc_kernel<kTileLoop, RedcRanges>>(
        RedcRanges::kThreads, n, RedcRanges::kRows);
    redc_kernel<kTileLoop, RedcRanges><<<grid, RedcRanges::kThreads, 0, s>>>(t, out, n);
  } else if (shares_for(n) == 8) {
    launch_tiles<Redc<8>, redc_kernel<kOneTilePath, Redc<8>>, redc_kernel<kTileLoop, Redc<8>>>(
        n, s, t, out);
  } else {
    launch_tiles<Redc<4>, redc_kernel<kOneTilePath, Redc<4>>, redc_kernel<kTileLoop, Redc<4>>>(
        n, s, t, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int lodestar_fp_mont_mul(const int* a, const int* b, int* out, int64_t n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 1) {
    mont_mul_kernel<kOneRowPath, 8><<<1, kRowThreads, 0, s>>>(a, b, out, n);
    return static_cast<int>(cudaGetLastError());
  }
  if (shares_for(n) == 8) {
    launch_tiles<MontMul<false, 8>, mont_mul_kernel<kOneTilePath, 8>,
                 mont_mul_kernel<kTileLoop, 8>>(n, s, a, b, out);
  } else {
    launch_tiles<MontMul<false, 4>, mont_mul_kernel<kOneTilePath, 4>,
                 mont_mul_kernel<kTileLoop, 4>>(n, s, a, b, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int lodestar_fp_mont_sq(const int* a, int* out, int64_t n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 1) {
    mont_sq_kernel<kOneRowPath, 8><<<1, kRowThreads, 0, s>>>(a, out, n);
    return static_cast<int>(cudaGetLastError());
  }
  if (shares_for(n) == 8) {
    launch_tiles<MontMul<true, 8>, mont_sq_kernel<kOneTilePath, 8>,
                 mont_sq_kernel<kTileLoop, 8>>(n, s, a, out);
  } else {
    launch_tiles<MontMul<true, 4>, mont_sq_kernel<kOneTilePath, 4>,
                 mont_sq_kernel<kTileLoop, 4>>(n, s, a, out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* lodestar_fp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
