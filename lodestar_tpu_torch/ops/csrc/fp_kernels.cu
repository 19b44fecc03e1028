// Relaxed BLS12-381 Fp products for Hopper (sm_90a): the five entry points of
// lodestar_tpu/ops/fp_pallas.py.
//
// Replaces (each C entry point below names its Pallas function), and runs as:
//   lodestar_fp_mul_acc  <- fp_pallas.mul_acc  (_mul_acc_kernel)      mul_acc_kernel
//   lodestar_fp_sq_acc   <- fp_pallas.sq_acc   (_sq_acc_kernel)       mul_kernel<true, false>
//   lodestar_fp_redc     <- fp_pallas.redc     (_redc_kernel / _redc_rows)  redc_kernel
//   lodestar_fp_mont_mul <- fp_pallas.mont_mul (_mont_mul_kernel)     mul_kernel<false, true>
//   lodestar_fp_mont_sq  <- fp_pallas.mont_sq  (_mont_sq_kernel)      mul_kernel<true, true>
//
// Representation (lodestar_tpu_torch/ops/fp.py): an element is 33 signed
// 12-bit limbs in int32, an accumulator 66. The limbs out are bit-identical
// to the plain PyTorch versions in ops/fp.py.
//
// Arithmetic stays inside the int32 ledger of ops/fp.py: a convolution
// coefficient is at most 33 * 4161^2 < 2^30, the m*p product plus the
// carried accumulator and 2Rp stays below 2^30, so nothing is widened.
//
// What bounds these kernels on an H100 SXM (132 SMs, 64 int32 lanes each,
// so ~16.7e12 int32 multiply-adds/s at 1.98 GHz; 3.35 TB/s of HBM):
//   conv (mul_acc)  1089 multiply-adds per row (561 for a square) against
//                   528 bytes read and written (396 for sq_acc): bytes bound.
//   reduction       561 (m = t_lo * P' mod R) + 1089 (m * p) ~ 1.6k
//                   multiply-adds per row against 396 bytes (redc): about
//                   balanced; mont_mul (~2.7k multiply-adds, 396 bytes)
//                   and mont_sq are bound by the int32 multiply-adds.
// But a verify launches most mul_acc and redc calls at 4-6k rows, where
// the bound is under a microsecond and the card's width is what counts:
// one thread per row in 128-row blocks gives 32 blocks at 4096 rows (100 of
// 132 SMs idle), each thread walking 1.1-1.6k multiply-adds and 66-limb
// carry chains alone. So mul_acc_kernel and redc_kernel give each row four
// threads, one per warp of a 128-thread block:
//
// mul_acc_kernel: warp q of a block computes columns [kColStart[q],
//   kColStart[q+1]) of its tile's 32 rows, lane r row r: 276, 285, 275 and
//   253 of the 1089 products, each over compile-time limb indices with the
//   operands in registers. The two carry passes need only the carries into
//   a range's first column, which the range below computes from its own top
//   two columns; they cross warps through shared memory at one barrier.
// redc_kernel: the same split for the reduction's three steps: m = t_lo*P'
//   (columns per warp by the triangle's 561 products), its two carry passes
//   mod R, m to shared memory, then t + m*p + 2Rp over the mul_acc ranges
//   with P' and p read from constant memory at compile-time offsets, its
//   two carry passes, and the final shift by 33 limbs through the tile's
//   input buffer.
//   An int8 tensor-core version (mma.sync.m16n8k32 on 16-row tiles, each
//   limb split as 128*hi + lo, the Toeplitz B fragments built at compile
//   time) was exact but slower: its 16 rows per warp run a long serial
//   chain of shuffles, splits and recombinations (PERF.md has both times).
// Both walk 32-row tiles in persistent blocks (grid = resident blocks,
//   capped by the tile count). A tile's rows are one contiguous span: it is
//   loaded by cp.async.bulk onto an mbarrier, double-buffered so the next
//   tile's load overlaps this tile's products, and stored by cp.async.bulk
//   from shared memory. Bytes past the last 16-byte multiple (the ragged
//   last tile), or every byte when a pointer is not 16-byte aligned, go
//   through plain loads and stores.
//
// sq_acc, mont_mul, mont_sq (mul_kernel): one thread per row, fully
// unrolled schoolbook over compile-time limb indices so every limb lives in
// a register; a block's rows are staged through shared memory with
// coalesced loads and stores; the row stride in shared memory is odd (33,
// or 66 padded to 67), so a warp reading one row per thread hits 32
// distinct banks; the 66-limb accumulator of mont_mul/mont_sq never leaves
// registers (the point of the fused TPU kernel); the ragged last block is
// masked, nothing is padded.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kL = 33;       // limbs of an element
constexpr int kA = 2 * kL;   // limbs of an accumulator
constexpr int kRows = 128;   // rows (one per thread) per block
constexpr int kS33 = kL;     // shared-memory row stride of 33-limb rows (odd)
constexpr int kS66 = kA + 1; // shared-memory row stride of 66-limb rows (odd)
constexpr int kSmemWords = kRows * kS66;
static_assert(kSmemWords >= 2 * kRows * kS33, "staging buffer holds two operands");

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

// One parallel signed carry pass: every limb keeps its low 12 bits and
// passes floor(limb / 4096) up one place. KEEP_TOP: the top limb keeps its
// carry (the value is preserved); otherwise the top carry is dropped (the
// mod-R truncation of the m-step). carry_in is the carry of the ORIGINAL
// lower limb, so the pass is the data-parallel one of ops/fp.py.
template <int N, bool KEEP_TOP>
__device__ __forceinline__ void carry_once(int (&x)[N]) {
  int carry_in = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int v = x[i];
    const bool top_kept = KEEP_TOP && i == N - 1;
    x[i] = (top_kept ? v : mod_4096(v)) + carry_in;
    carry_in = floor_div_4096(v);
  }
}

template <int N, bool KEEP_TOP>
__device__ __forceinline__ void carry2(int (&x)[N]) {
  carry_once<N, KEEP_TOP>(x);
  carry_once<N, KEEP_TOP>(x);
}

// Device function 1: schoolbook 33x33 convolution, then two carry passes
// keeping the top limb (fp_pallas _conv_var + _carry2_rows).
__device__ __forceinline__ void conv_carry(const int (&a)[kL], const int (&b)[kL],
                                           int (&acc)[kA]) {
#pragma unroll
  for (int k = 0; k < kA; ++k) acc[k] = 0;
#pragma unroll
  for (int i = 0; i < kL; ++i) {
#pragma unroll
    for (int j = 0; j < kL; ++j) acc[i + j] += a[i] * b[j];
  }
  carry2<kA, true>(acc);
}

// The same with a = b: 561 products (each cross term once, doubled). The
// integer coefficients equal those of conv_carry(a, a) exactly.
__device__ __forceinline__ void sq_conv_carry(const int (&a)[kL], int (&acc)[kA]) {
#pragma unroll
  for (int k = 0; k < kA; ++k) acc[k] = 0;
#pragma unroll
  for (int i = 0; i < kL; ++i) {
    acc[2 * i] += a[i] * a[i];
    const int a2 = 2 * a[i];
#pragma unroll
    for (int j = i + 1; j < kL; ++j) acc[i + j] += a2 * a[j];
  }
  carry2<kA, true>(acc);
}

// Device function 2: Montgomery reduction of an accumulator held in
// registers (fp_pallas _redc_rows): (t + m*p + 2Rp) / R - 2p with
// m = t_lo * P' mod R; exact zero stays exact zero. t is consumed.
__device__ __forceinline__ void redc_regs(int (&t)[kA], int (&out)[kL]) {
  carry_once<kA, true>(t);  // absorb accumulator sums
  int m[kL];
#pragma unroll
  for (int k = 0; k < kL; ++k) m[k] = 0;
#pragma unroll
  for (int i = 0; i < kL; ++i) {
#pragma unroll
    for (int j = 0; i + j < kL; ++j) m[i + j] += t[i] * c_pprime[j];
  }
  carry2<kL, false>(m);  // mod R: top carries dropped
#pragma unroll
  for (int i = 0; i < kL; ++i) {
#pragma unroll
    for (int j = 0; j < kL; ++j) t[i + j] += m[i] * c_p[j];
  }
#pragma unroll
  for (int k = 0; k < kL; ++k) t[kL + k] += c_two_p[k];
  carry2<kA, true>(t);
  // the low half is exactly 0 or R: its limb 32 is <= 1 or >= 4095
  const int carry = t[kL - 1] >= 2048 ? 1 : 0;
#pragma unroll
  for (int k = 0; k < kL; ++k) out[k] = t[kL + k] - c_two_p[k];
  out[0] += carry;
  carry_once<kL, true>(out);
}

// Coalesced copy of `rows` contiguous rows of `width` limbs between device
// memory and shared memory rows of stride `stride`.
template <int width, int stride>
__device__ __forceinline__ void stage_in(int* smem, const int* __restrict__ g, int rows) {
  for (int w = threadIdx.x; w < rows * width; w += kRows) {
    const int r = w / width;
    smem[r * stride + (w - r * width)] = g[w];
  }
}

template <int width, int stride>
__device__ __forceinline__ void stage_out(int* __restrict__ g, const int* smem, int rows) {
  for (int w = threadIdx.x; w < rows * width; w += kRows) {
    const int r = w / width;
    g[w] = smem[r * stride + (w - r * width)];
  }
}

template <int N, int stride>
__device__ __forceinline__ void load_row(int (&x)[N], const int* smem) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = smem[threadIdx.x * stride + i];
}

template <int N, int stride>
__device__ __forceinline__ void store_row(int* smem, const int (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) smem[threadIdx.x * stride + i] = x[i];
}

// mul_acc / sq_acc (REDUCE = false) and mont_mul / mont_sq (REDUCE = true).
template <bool SQUARE, bool REDUCE>
__global__ void __launch_bounds__(kRows)
    mul_kernel(const int* __restrict__ a, const int* __restrict__ b,
               int* __restrict__ out, int64_t n) {
  __shared__ int smem[kSmemWords];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rows = n - row0 < kRows ? static_cast<int>(n - row0) : kRows;
  const bool active = static_cast<int>(threadIdx.x) < rows;  // ragged last block

  int* sa = smem;
  int* sb = smem + kRows * kS33;
  stage_in<kL, kS33>(sa, a + row0 * kL, rows);
  if (!SQUARE) stage_in<kL, kS33>(sb, b + row0 * kL, rows);
  __syncthreads();

  int acc[kA];
  if (active) {
    int x[kL];
    load_row<kL, kS33>(x, sa);
    if (SQUARE) {
      sq_conv_carry(x, acc);
    } else {
      int y[kL];
      load_row<kL, kS33>(y, sb);
      conv_carry(x, y, acc);
    }
  }
  __syncthreads();  // every row is read before the buffer is reused

  if (REDUCE) {
    if (active) {
      int r[kL];
      redc_regs(acc, r);
      store_row<kL, kS33>(smem, r);
    }
    __syncthreads();
    stage_out<kL, kS33>(out + row0 * kL, smem, rows);
  } else {
    if (active) store_row<kA, kS66>(smem, acc);
    __syncthreads();
    stage_out<kA, kS66>(out + row0 * kA, smem, rows);
  }
}

// ---------------------------------------------------------------------------
// Hopper building blocks: bulk asynchronous copies completing on an mbarrier,
// and bulk stores.

constexpr int kTileRows = 32;  // rows per tile of mul_acc_kernel and redc_kernel

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

// The tile loop shared by mul_acc_kernel and redc_kernel: a persistent
// block of 128 threads walks tiles blockIdx.x, +gridDim.x, ...; tile i+1's
// bulk load is in flight while tile i is computed (two stages, one mbarrier
// each). K gives the operand count and widths, its shared memory (in[stage]
// and out at least) and columns<Q>(sh, stage, r): warp Q's column range of
// the tile's row r, written to sh.out. Rows past the tile's last are
// computed on stale data and not stored, so every thread reaches every
// barrier in columns<Q>.
template <class K>
__device__ __forceinline__ void stream_tiles(const int* __restrict__ a, const int* __restrict__ b,
                                             int* __restrict__ out, int64_t n,
                                             typename K::Shared& sh) {
  constexpr int kInWords = kTileRows * K::kIn;  // per operand
  constexpr int kOutWords = kTileRows * K::kOut;
  static_assert((kInWords * 4) % 16 == 0 && (kOutWords * 4) % 16 == 0,
                "whole tiles start 16-byte aligned");
  static_assert(K::kThreads == 128, "four warps, one column range each");
  const int64_t tiles = (n + kTileRows - 1) / kTileRows;
  const bool in_aligned =
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
  const bool out_aligned = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  auto rows_of = [&](int64_t tile) {
    const int64_t left = n - tile * kTileRows;
    return left < kTileRows ? static_cast<int>(left) : kTileRows;
  };
  auto issue = [&](int64_t tile, int stage) {
    const int64_t off = tile * kInWords;
    tile_load_async<K::kOps>(sh.in[stage], kInWords, a + off, b + off,
                             rows_of(tile) * K::kIn, in_aligned, &sh.bar[stage]);
  };

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
    const int r = threadIdx.x & 31;
    switch (threadIdx.x >> 5) {
      case 0: K::template columns<0>(sh, stage, r); break;
      case 1: K::template columns<1>(sh, stage, r); break;
      case 2: K::template columns<2>(sh, stage, r); break;
      default: K::template columns<3>(sh, stage, r); break;
    }
    fence_proxy_async();
    __syncthreads();
    tile_store(out + tile * kOutWords, sh.out, rows * K::kOut, out_aligned);
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// mul_acc: four threads per row, one column range each.

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
// publishes those in `carry`, one barrier, and takes its own. KEEP_TOP as
// in carry_once, for column TOP. W >= 2.
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
  static constexpr int kOps = 2, kIn = kL, kOut = kA;
  static constexpr int kThreads = 128;  // warp q: column range q of the tile's 32 rows
  struct Shared {
    uint64_t bar[2];
    alignas(16) int in[2][2 * kTileRows * kL];
    alignas(16) int out[kTileRows * kA];
    int2 carry[3][kTileRows];  // carries out of a range's top column: pass 1, pass 2
  };

  // Thread (warp Q, lane r): columns of range Q of row r, both carry passes.
  template <int Q>
  __device__ static void columns(Shared& sh, int stage, int r) {
    constexpr int S = kColStart[Q], E = kColStart[Q + 1], W = E - S;
    int v[W];
    conv_columns<S, E>(sh.in[stage] + r * kL, sh.in[stage] + kTileRows * kL + r * kL, v);
    carry2_range<Q, S, W, kA - 1, true>(sh.carry, r, v);
#pragma unroll
    for (int c = 0; c < W; ++c) sh.out[r * kA + S + c] = v[c];
  }

};

// ---------------------------------------------------------------------------
// redc: four threads per row, one column range each.

// Columns of m = t_lo * P' per warp: 136, 140, 130 and 155 of 561 products.
constexpr int kMColStart[5] = {0, 16, 23, 28, kL};

struct Redc {
  static constexpr int kOps = 1, kIn = kA, kOut = kL;
  static constexpr int kThreads = 128;
  struct Shared {
    uint64_t bar[2];
    alignas(16) int in[2][kTileRows * kA];
    alignas(16) int out[kTileRows * kL];
    int2 carry[3][kTileRows];
    int m[kTileRows][kL];
  };

  // Limb c of t after one carry pass (top limb kept), from the raw row.
  __device__ static int t_carried(const int* t, int c) {
    return (c == kA - 1 ? t[c] : mod_4096(t[c])) + (c ? floor_div_4096(t[c - 1]) : 0);
  }

  template <int Q>
  __device__ static void columns(Shared& sh, int stage, int r) {
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

__global__ void __launch_bounds__(MulAcc::kThreads)
    mul_acc_kernel(const int* __restrict__ a, const int* __restrict__ b,
                   int* __restrict__ out, int64_t n) {
  __shared__ MulAcc::Shared sh;
  stream_tiles<MulAcc>(a, b, out, n, sh);
}

__global__ void __launch_bounds__(Redc::kThreads)
    redc_kernel(const int* __restrict__ t, int* __restrict__ out, int64_t n) {
  __shared__ Redc::Shared sh;
  stream_tiles<Redc>(t, t, out, n, sh);
}

// Persistent grid: as many blocks as fit on the card at once, at most one
// per tile. The per-device count is cached after the first launch.
template <class Kernel>
unsigned persistent_grid(Kernel kernel, int threads, int64_t n) {
  static int resident[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int& cap = resident[dev & 63];
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t tiles = (n + kTileRows - 1) / kTileRows;
  return static_cast<unsigned>(tiles < cap ? tiles : cap);
}

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kRows - 1) / kRows);
}

}  // namespace

// Plain C interface (bound with ctypes): row-major contiguous int32 rows,
// n > 0 rows, launched on `stream` without synchronising. Returns the
// cudaError_t of the launch (0 when it was accepted).
extern "C" {

int lodestar_fp_mul_acc(const int* a, const int* b, int* out, int64_t n, void* stream) {
  mul_acc_kernel<<<persistent_grid(mul_acc_kernel, MulAcc::kThreads, n), MulAcc::kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a, b, out, n);
  return static_cast<int>(cudaGetLastError());
}

int lodestar_fp_sq_acc(const int* a, int* out, int64_t n, void* stream) {
  mul_kernel<true, false><<<blocks_for(n), kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      a, a, out, n);
  return static_cast<int>(cudaGetLastError());
}

int lodestar_fp_redc(const int* t, int* out, int64_t n, void* stream) {
  redc_kernel<<<persistent_grid(redc_kernel, Redc::kThreads, n), Redc::kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(t, out, n);
  return static_cast<int>(cudaGetLastError());
}

int lodestar_fp_mont_mul(const int* a, const int* b, int* out, int64_t n, void* stream) {
  mul_kernel<false, true><<<blocks_for(n), kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, n);
  return static_cast<int>(cudaGetLastError());
}

int lodestar_fp_mont_sq(const int* a, int* out, int64_t n, void* stream) {
  mul_kernel<true, true><<<blocks_for(n), kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      a, a, out, n);
  return static_cast<int>(cudaGetLastError());
}

const char* lodestar_fp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
