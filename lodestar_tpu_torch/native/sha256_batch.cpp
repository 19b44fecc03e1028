// Native batched SHA-256 pair hasher for host-side merkleization.
//
// Replaces the reference's @chainsafe/as-sha256 WASM hot loop (SURVEY
// §2b: the hasher inside persistent-merkle-tree) for sub-device-threshold
// merkle levels, where the Python hashlib loop's per-call overhead
// dominates (round-2 advisor finding on ssz/hash.py).
//
// Layout contract: `in` is n concatenated 64-byte messages (two 32-byte
// child nodes), `out` receives n 32-byte digests. Each digest is
// SHA-256(msg64): one compression of the message block plus one of the
// constant padding block (0x80 || zeros || bitlen=512).
//
// Two compression backends, selected once at load time:
//  * portable scalar (any arch)
//  * x86-64 SHA-NI intrinsics (runtime __builtin_cpu_supports("sha"))
// Large batches split across std::thread workers.
//
// Build: g++ -O3 -std=c++17 -fPIC -shared -pthread (see native/__init__.py).
//
// A copy of the JAX package's lodestar_tpu/native/sha256_batch.cpp.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace {

constexpr uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

constexpr uint32_t IV[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                            0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};

inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }
inline uint32_t load_be(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) |
         uint32_t(p[3]);
}
inline void store_be(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v >> 24);
  p[1] = uint8_t(v >> 16);
  p[2] = uint8_t(v >> 8);
  p[3] = uint8_t(v);
}

// ---- portable scalar backend ------------------------------------------------

void compress_scalar(uint32_t state[8], const uint32_t w_in[16]) {
  uint32_t w[64];
  std::memcpy(w, w_in, 64);
  for (int i = 16; i < 64; i++) {
    uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
    uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint32_t a = state[0], b = state[1], c = state[2], d = state[3];
  uint32_t e = state[4], f = state[5], g = state[6], h = state[7];
  for (int i = 0; i < 64; i++) {
    uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + S1 + ch + K[i] + w[i];
    uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  state[0] += a; state[1] += b; state[2] += c; state[3] += d;
  state[4] += e; state[5] += f; state[6] += g; state[7] += h;
}

// padding block for a 64-byte message: 0x80, zeros, bitlen 512
constexpr uint32_t PAD512[16] = {0x80000000, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 0, 0, 0, 512};

void digest64_scalar(const uint8_t* msg, uint8_t* out) {
  uint32_t state[8];
  std::memcpy(state, IV, 32);
  uint32_t w[16];
  for (int i = 0; i < 16; i++) w[i] = load_be(msg + 4 * i);
  compress_scalar(state, w);
  compress_scalar(state, PAD512);
  for (int i = 0; i < 8; i++) store_be(out + 4 * i, state[i]);
}

// ---- x86-64 SHA-NI backend --------------------------------------------------

#if defined(__x86_64__)

__attribute__((target("sha,sse4.1"))) void compress_shani(__m128i& s01,
                                                          __m128i& s23,
                                                          const uint8_t* block,
                                                          bool pad_block) {
  const __m128i shuf =
      _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);
  __m128i msg0, msg1, msg2, msg3;
  if (pad_block) {
    // constant pad schedule (already big-endian word order)
    msg0 = _mm_set_epi32(0, 0, 0, int(0x80000000));
    msg1 = _mm_setzero_si128();
    msg2 = _mm_setzero_si128();
    msg3 = _mm_set_epi32(512, 0, 0, 0);
  } else {
    msg0 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(block + 0)), shuf);
    msg1 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(block + 16)), shuf);
    msg2 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(block + 32)), shuf);
    msg3 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(block + 48)), shuf);
  }

  const __m128i abef_save = s01;
  const __m128i cdgh_save = s23;
  __m128i state0 = s01, state1 = s23, msg, tmp;

#define ROUNDS4(m, ki)                                              \
  msg = _mm_add_epi32(m, _mm_loadu_si128((const __m128i*)&K[ki]));  \
  state1 = _mm_sha256rnds2_epu32(state1, state0, msg);              \
  msg = _mm_shuffle_epi32(msg, 0x0E);                               \
  state0 = _mm_sha256rnds2_epu32(state0, state1, msg);

#define SCHED(m0, m1, m2, m3)                        \
  tmp = _mm_sha256msg1_epu32(m0, m1);                \
  tmp = _mm_add_epi32(tmp, _mm_alignr_epi8(m3, m2, 4)); \
  m0 = _mm_sha256msg2_epu32(tmp, m3);

  ROUNDS4(msg0, 0)
  ROUNDS4(msg1, 4)
  ROUNDS4(msg2, 8)
  ROUNDS4(msg3, 12)
  SCHED(msg0, msg1, msg2, msg3)
  ROUNDS4(msg0, 16)
  SCHED(msg1, msg2, msg3, msg0)
  ROUNDS4(msg1, 20)
  SCHED(msg2, msg3, msg0, msg1)
  ROUNDS4(msg2, 24)
  SCHED(msg3, msg0, msg1, msg2)
  ROUNDS4(msg3, 28)
  SCHED(msg0, msg1, msg2, msg3)
  ROUNDS4(msg0, 32)
  SCHED(msg1, msg2, msg3, msg0)
  ROUNDS4(msg1, 36)
  SCHED(msg2, msg3, msg0, msg1)
  ROUNDS4(msg2, 40)
  SCHED(msg3, msg0, msg1, msg2)
  ROUNDS4(msg3, 44)
  SCHED(msg0, msg1, msg2, msg3)
  ROUNDS4(msg0, 48)
  SCHED(msg1, msg2, msg3, msg0)
  ROUNDS4(msg1, 52)
  SCHED(msg2, msg3, msg0, msg1)
  ROUNDS4(msg2, 56)
  SCHED(msg3, msg0, msg1, msg2)
  ROUNDS4(msg3, 60)

#undef ROUNDS4
#undef SCHED

  s01 = _mm_add_epi32(state0, abef_save);
  s23 = _mm_add_epi32(state1, cdgh_save);
}

__attribute__((target("sha,sse4.1"))) void digest64_shani(const uint8_t* msg,
                                                          uint8_t* out) {
  // state in the SHA-NI register layout: s01 = ABEF, s23 = CDGH
  __m128i s01 = _mm_set_epi32(int(IV[0]), int(IV[1]), int(IV[4]), int(IV[5]));
  __m128i s23 = _mm_set_epi32(int(IV[2]), int(IV[3]), int(IV[6]), int(IV[7]));
  compress_shani(s01, s23, msg, false);
  compress_shani(s01, s23, nullptr, true);
  uint32_t a = uint32_t(_mm_extract_epi32(s01, 3));
  uint32_t b = uint32_t(_mm_extract_epi32(s01, 2));
  uint32_t e = uint32_t(_mm_extract_epi32(s01, 1));
  uint32_t f = uint32_t(_mm_extract_epi32(s01, 0));
  uint32_t c = uint32_t(_mm_extract_epi32(s23, 3));
  uint32_t d = uint32_t(_mm_extract_epi32(s23, 2));
  uint32_t g = uint32_t(_mm_extract_epi32(s23, 1));
  uint32_t h = uint32_t(_mm_extract_epi32(s23, 0));
  store_be(out + 0, a); store_be(out + 4, b); store_be(out + 8, c);
  store_be(out + 12, d); store_be(out + 16, e); store_be(out + 20, f);
  store_be(out + 24, g); store_be(out + 28, h);
}

#endif  // __x86_64__

using Digest64Fn = void (*)(const uint8_t*, uint8_t*);

Digest64Fn select_backend() {
#if defined(__x86_64__)
  if (__builtin_cpu_supports("sha") && __builtin_cpu_supports("sse4.1"))
    return digest64_shani;
#endif
  return digest64_scalar;
}

Digest64Fn g_digest64 = select_backend();

void hash_range(const uint8_t* in, uint8_t* out, size_t begin, size_t end) {
  for (size_t i = begin; i < end; i++) g_digest64(in + 64 * i, out + 32 * i);
}

constexpr size_t PAIRS_PER_THREAD_MIN = 8192;

}  // namespace

extern "C" {

// n pairs: in = n*64 bytes, out = n*32 bytes
void sha256_pairs(const uint8_t* in, uint64_t n, uint8_t* out) {
  size_t workers = std::thread::hardware_concurrency();
  if (workers < 2 || n < 2 * PAIRS_PER_THREAD_MIN) {
    hash_range(in, out, 0, n);
    return;
  }
  size_t max_workers = (n + PAIRS_PER_THREAD_MIN - 1) / PAIRS_PER_THREAD_MIN;
  if (workers > max_workers) workers = max_workers;
  std::vector<std::thread> pool;
  pool.reserve(workers);
  size_t chunk = (n + workers - 1) / workers;
  for (size_t t = 0; t < workers; t++) {
    size_t begin = t * chunk;
    size_t end = begin + chunk < n ? begin + chunk : n;
    if (begin >= end) break;
    pool.emplace_back(hash_range, in, out, begin, end);
  }
  for (auto& th : pool) th.join();
}

// 1 = SHA-NI, 0 = portable scalar (introspection for tests/bench)
int sha256_backend() {
#if defined(__x86_64__)
  if (__builtin_cpu_supports("sha") && __builtin_cpu_supports("sse4.1")) return 1;
#endif
  return 0;
}

}  // extern "C"
