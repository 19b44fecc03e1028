// Native host BLS12-381: decompression, subgroup checks, hash-to-G2.
//
// The host half of batch signature verification (the device half is the
// PyTorch pairing). The reference does this work inside blst
// (packages/beacon-node/src/chain/bls/maybeBatch.ts); this is the
// framework's own C++ equivalent, differential-tested against the
// pure-Python oracle (lodestar_tpu_torch/crypto/bls) which remains the
// correctness anchor.
//
// A copy of the JAX package's lodestar_tpu/native/bls_host.cpp.
//
// Arithmetic: 6x64-bit Montgomery (CIOS with unsigned __int128), curve
// math in Jacobian coordinates, psi-endomorphism fast paths mirroring
// the oracle's (curve.py g2_clear_cofactor_fast / g2_in_subgroup_fast).
// All inputs are public data (pubkeys, signatures, messages): variable-
// time code is fine by design.
//
// Outputs are written directly in the device kernel's Montgomery
// 12-bit x 32-limb int32 layout (ops/fp.py), so Python does zero bignum
// work after this returns.
//
// Build: g++ -O3 -std=c++17 -fPIC -shared -pthread bls_host.cpp

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <thread>
#include <vector>
#include <atomic>

#include "bls_host_constants.h"

typedef unsigned __int128 u128;

// ---------------------------------------------------------------- fp core

static inline void fp_copy(fp r, const fp a) { memcpy(r, a, sizeof(fp)); }
static inline void fp_zero(fp r) { memset(r, 0, sizeof(fp)); }

static inline bool fp_is_zero(const fp a) {
  uint64_t x = 0;
  for (int i = 0; i < 6; i++) x |= a[i];
  return x == 0;
}

static inline bool fp_eq(const fp a, const fp b) {
  uint64_t x = 0;
  for (int i = 0; i < 6; i++) x |= a[i] ^ b[i];
  return x == 0;
}

// r = a + b mod p
static inline void fp_add(fp r, const fp a, const fp b) {
  u128 c = 0;
  uint64_t t[6];
  for (int i = 0; i < 6; i++) {
    c += (u128)a[i] + b[i];
    t[i] = (uint64_t)c;
    c >>= 64;
  }
  // conditional subtract p
  uint64_t borrow = 0, s[6];
  u128 d;
  for (int i = 0; i < 6; i++) {
    d = (u128)t[i] - FP_P[i] - borrow;
    s[i] = (uint64_t)d;
    borrow = (uint64_t)(d >> 64) & 1;
  }
  bool ge = (c != 0) || !borrow;
  for (int i = 0; i < 6; i++) r[i] = ge ? s[i] : t[i];
}

static inline void fp_sub(fp r, const fp a, const fp b) {
  uint64_t borrow = 0;
  u128 d;
  uint64_t t[6];
  for (int i = 0; i < 6; i++) {
    d = (u128)a[i] - b[i] - borrow;
    t[i] = (uint64_t)d;
    borrow = (uint64_t)(d >> 64) & 1;
  }
  if (borrow) {
    u128 c = 0;
    for (int i = 0; i < 6; i++) {
      c += (u128)t[i] + FP_P[i];
      t[i] = (uint64_t)c;
      c >>= 64;
    }
  }
  fp_copy(r, t);
}

static inline void fp_neg(fp r, const fp a) {
  if (fp_is_zero(a)) { fp_zero(r); return; }
  fp_sub(r, FP_P, a);
}

// Montgomery product (CIOS)
static void fp_mul(fp r, const fp a, const fp b) {
  uint64_t t[8] = {0};
  for (int i = 0; i < 6; i++) {
    u128 c = 0;
    for (int j = 0; j < 6; j++) {
      c += (u128)t[j] + (u128)a[i] * b[j];
      t[j] = (uint64_t)c;
      c >>= 64;
    }
    c += t[6];
    t[6] = (uint64_t)c;
    t[7] = (uint64_t)(c >> 64);

    uint64_t m = t[0] * FP_INV64;
    c = (u128)t[0] + (u128)m * FP_P[0];
    c >>= 64;
    for (int j = 1; j < 6; j++) {
      c += (u128)t[j] + (u128)m * FP_P[j];
      t[j - 1] = (uint64_t)c;
      c >>= 64;
    }
    c += t[6];
    t[5] = (uint64_t)c;
    t[6] = t[7] + (uint64_t)(c >> 64);
    t[7] = 0;
  }
  // t[0..5] may still be >= p (t[6] holds a possible overflow bit)
  uint64_t borrow = 0, s[6];
  u128 d;
  for (int i = 0; i < 6; i++) {
    d = (u128)t[i] - FP_P[i] - borrow;
    s[i] = (uint64_t)d;
    borrow = (uint64_t)(d >> 64) & 1;
  }
  bool ge = t[6] || !borrow;
  for (int i = 0; i < 6; i++) r[i] = ge ? s[i] : t[i];
}

static inline void fp_sqr(fp r, const fp a) { fp_mul(r, a, a); }

// a^e for a big-endian byte exponent, in mont domain
static void fp_pow(fp r, const fp a, const uint8_t* e, size_t elen) {
  fp acc;
  fp_copy(acc, FP_ONE_M);
  for (size_t i = 0; i < elen; i++) {
    for (int bit = 7; bit >= 0; bit--) {
      fp_sqr(acc, acc);
      if ((e[i] >> bit) & 1) fp_mul(acc, acc, a);
    }
  }
  fp_copy(r, acc);
}

static void fp_inv(fp r, const fp a) { fp_pow(r, a, EXP_FP_INV, EXP_FP_INV_LEN); }

// sqrt in Fp (p = 3 mod 4): a^((p+1)/4), verified. Returns false if non-residue.
static bool fp_sqrt(fp r, const fp a) {
  fp c, c2;
  fp_pow(c, a, EXP_FP_SQRT, EXP_FP_SQRT_LEN);
  fp_sqr(c2, c);
  if (!fp_eq(c2, a)) return false;
  fp_copy(r, c);
  return true;
}

// mont -> canonical integer limbs
static void fp_from_mont(fp r, const fp a) {
  static const fp one_raw = {1, 0, 0, 0, 0, 0};
  fp_mul(r, a, one_raw);
}

static void fp_to_mont(fp r, const fp a) { fp_mul(r, a, FP_R2); }

// canonical value comparison: a > (p-1)/2 ?  (a is mont; convert first)
static bool fp_is_larger(const fp a_mont) {
  fp v;
  fp_from_mont(v, a_mont);
  for (int i = 5; i >= 0; i--) {
    if (v[i] != FP_HALF_P[i]) return v[i] > FP_HALF_P[i];
  }
  return false;  // equal -> not larger
}

static bool fp_is_odd(const fp a_mont) {
  fp v;
  fp_from_mont(v, a_mont);
  return v[0] & 1;
}

// 48 big-endian bytes -> mont fp; returns false if >= p
static bool fp_from_be48(fp r, const uint8_t* in) {
  fp v;
  for (int i = 0; i < 6; i++) {
    uint64_t limb = 0;
    for (int j = 0; j < 8; j++) limb = (limb << 8) | in[(5 - i) * 8 + j];
    v[i] = limb;
  }
  // reject >= p
  for (int i = 5; i >= 0; i--) {
    if (v[i] != FP_P[i]) {
      if (v[i] > FP_P[i]) return false;
      break;
    }
    if (i == 0) return false;  // equal to p
  }
  fp_to_mont(r, v);
  return true;
}

static void fp_to_be48(uint8_t* out, const fp a_mont) {
  fp v;
  fp_from_mont(v, a_mont);
  for (int i = 0; i < 6; i++)
    for (int j = 0; j < 8; j++)
      out[(5 - i) * 8 + j] = (uint8_t)(v[i] >> (56 - 8 * j));
}

// mont fp -> 33 x int32 12-bit limbs (device layout R = 2^396; matches
// ops/fp.py mont_limbs_from_int). The internal CIOS base is R64 = 2^384,
// so one extra Montgomery multiply by the raw constant 2^396 mod p turns
// x*2^384 into the plain words of x*2^396 mod p, which are then split.
static void fp_to_device_limbs(int32_t* out, const fp a_mont) {
  fp v;
  fp_mul(v, a_mont, FP_C396);  // = x * 2^396 mod p, canonical 6x64 words
  int bitpos = 0;
  for (int i = 0; i < 33; i++) {
    int word = bitpos >> 6, off = bitpos & 63;
    uint64_t limb = word < 6 ? (v[word] >> off) : 0;
    if (off > 52 && word < 5) limb |= v[word + 1] << (64 - off);
    out[i] = (int32_t)(limb & 0xFFF);
    bitpos += 12;
  }
}

// ---------------------------------------------------------------- fp2

static inline void fp2_copy(fp2& r, const fp2& a) { fp_copy(r.c0, a.c0); fp_copy(r.c1, a.c1); }
static inline void fp2_zero(fp2& r) { fp_zero(r.c0); fp_zero(r.c1); }
static inline bool fp2_is_zero(const fp2& a) { return fp_is_zero(a.c0) && fp_is_zero(a.c1); }
static inline bool fp2_eq(const fp2& a, const fp2& b) { return fp_eq(a.c0, b.c0) && fp_eq(a.c1, b.c1); }

static inline void fp2_add(fp2& r, const fp2& a, const fp2& b) {
  fp_add(r.c0, a.c0, b.c0);
  fp_add(r.c1, a.c1, b.c1);
}

static inline void fp2_sub(fp2& r, const fp2& a, const fp2& b) {
  fp_sub(r.c0, a.c0, b.c0);
  fp_sub(r.c1, a.c1, b.c1);
}

static inline void fp2_neg(fp2& r, const fp2& a) {
  fp_neg(r.c0, a.c0);
  fp_neg(r.c1, a.c1);
}

static inline void fp2_conj(fp2& r, const fp2& a) {
  fp_copy(r.c0, a.c0);
  fp_neg(r.c1, a.c1);
}

static void fp2_mul(fp2& r, const fp2& a, const fp2& b) {
  fp t0, t1, s0, s1, cross;
  fp_mul(t0, a.c0, b.c0);
  fp_mul(t1, a.c1, b.c1);
  fp_add(s0, a.c0, a.c1);
  fp_add(s1, b.c0, b.c1);
  fp_mul(cross, s0, s1);
  fp_sub(r.c0, t0, t1);
  fp_sub(cross, cross, t0);
  fp_sub(r.c1, cross, t1);
}

static void fp2_sqr(fp2& r, const fp2& a) {
  fp sum, diff, prod;
  fp_add(sum, a.c0, a.c1);
  fp_sub(diff, a.c0, a.c1);
  fp_mul(prod, a.c0, a.c1);
  fp_mul(r.c0, sum, diff);
  fp_add(r.c1, prod, prod);
}

static void fp2_mul_fp(fp2& r, const fp2& a, const fp s) {
  fp_mul(r.c0, a.c0, s);
  fp_mul(r.c1, a.c1, s);
}

static void fp2_inv(fp2& r, const fp2& a) {
  fp n, t0, t1, ninv;
  fp_sqr(t0, a.c0);
  fp_sqr(t1, a.c1);
  fp_add(n, t0, t1);
  fp_inv(ninv, n);
  fp_mul(r.c0, a.c0, ninv);
  fp_mul(t0, a.c1, ninv);
  fp_neg(r.c1, t0);
}

// sqrt in Fp2 via the complex method (p = 3 mod 4), verified by squaring.
static bool fp2_sqrt(fp2& r, const fp2& a) {
  if (fp2_is_zero(a)) { fp2_zero(r); return true; }
  fp2 cand;
  if (fp_is_zero(a.c1)) {
    fp s;
    if (fp_sqrt(s, a.c0)) {
      fp_copy(cand.c0, s);
      fp_zero(cand.c1);
    } else {
      fp na;
      fp_neg(na, a.c0);
      if (!fp_sqrt(s, na)) return false;
      fp_zero(cand.c0);
      fp_copy(cand.c1, s);
    }
  } else {
    // n = c0^2 + c1^2; s = sqrt(n); t = sqrt((c0 + s)/2) or sqrt((c0-s)/2)
    fp n, s, t, half, tmp;
    fp_sqr(n, a.c0);
    fp_sqr(tmp, a.c1);
    fp_add(n, n, tmp);
    if (!fp_sqrt(s, n)) return false;
    // half = 1/2 in mont: (p+1)/2 as raw -> to_mont once (precompute lazily)
    static fp HALF_M;
    static bool half_init = false;
    if (!half_init) {
      fp two = {2, 0, 0, 0, 0, 0};
      fp two_m, two_inv;
      fp_to_mont(two_m, two);
      fp_inv(two_inv, two_m);
      fp_copy(HALF_M, two_inv);
      half_init = true;
    }
    fp_copy(half, HALF_M);
    fp_add(tmp, a.c0, s);
    fp_mul(tmp, tmp, half);
    if (!fp_sqrt(t, tmp)) {
      fp_sub(tmp, a.c0, s);
      fp_mul(tmp, tmp, half);
      if (!fp_sqrt(t, tmp)) return false;
    }
    fp t2inv, tt;
    fp_add(tt, t, t);
    fp_inv(t2inv, tt);
    fp_copy(cand.c0, t);
    fp_mul(cand.c1, a.c1, t2inv);
  }
  fp2 check;
  fp2_sqr(check, cand);
  if (!fp2_eq(check, a)) return false;
  fp2_copy(r, cand);
  return true;
}

static void fp2_pow(fp2& r, const fp2& a, const uint8_t* e, size_t elen) {
  fp2 acc;
  fp_copy(acc.c0, FP_ONE_M);
  fp_zero(acc.c1);
  for (size_t i = 0; i < elen; i++) {
    for (int bit = 7; bit >= 0; bit--) {
      fp2_sqr(acc, acc);
      if ((e[i] >> bit) & 1) fp2_mul(acc, acc, a);
    }
  }
  fp2_copy(r, acc);
}

// lexicographic "larger" on (c1, c0) per the ZCash convention
static bool fp2_is_larger(const fp2& y) {
  if (!fp_is_zero(y.c1)) return fp_is_larger(y.c1);
  return fp_is_larger(y.c0);
}

// RFC 9380 sgn0 for Fp2
static int fp2_sgn0(const fp2& a) {
  int sign0 = fp_is_odd(a.c0) ? 1 : 0;
  int zero0 = fp_is_zero(a.c0) ? 1 : 0;
  int sign1 = fp_is_odd(a.c1) ? 1 : 0;
  return sign0 | (zero0 & sign1);
}

// ---------------------------------------------------------------- curves

// Jacobian points; Z == 0 encodes infinity.
struct g1p { fp X, Y, Z; };
struct g2p { fp2 X, Y, Z; };

template <typename P>
static inline bool pt_is_inf(const P& p);

template <>
inline bool pt_is_inf(const g1p& p) { return fp_is_zero(p.Z); }
template <>
inline bool pt_is_inf(const g2p& p) { return fp2_is_zero(p.Z); }

static void g1_set_inf(g1p& p) { fp_zero(p.X); fp_zero(p.Y); fp_zero(p.Z); }
static void g2_set_inf(g2p& p) { fp2_zero(p.X); fp2_zero(p.Y); fp2_zero(p.Z); }

// a = 0 doubling (same formulas as the oracle's _jac_double)
#define DEFINE_JAC(PT, FE, FE_COPY, FE_SQR, FE_MUL, FE_ADD, FE_SUB, FE_NEG, FE_ZEROQ, SETINF) \
  static void PT##_dbl(PT& r, const PT& p) {                                           \
    if (pt_is_inf(p)) { r = p; return; }                                               \
    FE A, B, C, D, E, Fq, t, t2;                                                       \
    FE_SQR(A, p.X);                                                                    \
    FE_SQR(B, p.Y);                                                                    \
    FE_SQR(C, B);                                                                      \
    FE_ADD(t, p.X, B);                                                                 \
    FE_SQR(t, t);                                                                      \
    FE_SUB(t, t, A);                                                                   \
    FE_SUB(t, t, C);                                                                   \
    FE_ADD(D, t, t);                                                                   \
    FE_ADD(E, A, A);                                                                   \
    FE_ADD(E, E, A);                                                                   \
    FE_SQR(Fq, E);                                                                     \
    FE_ADD(t2, D, D);                                                                  \
    FE_SUB(Fq, Fq, t2);                                                                \
    PT out;                                                                            \
    FE_COPY(out.X, Fq);                                                                        \
    FE_SUB(t, D, Fq);                                                                  \
    FE_MUL(t, E, t);                                                                   \
    FE ec;                                                                             \
    FE_ADD(ec, C, C);                                                                  \
    FE_ADD(ec, ec, ec);                                                                \
    FE_ADD(ec, ec, ec);                                                                \
    FE_SUB(out.Y, t, ec);                                                              \
    FE_MUL(t, p.Y, p.Z);                                                               \
    FE_ADD(out.Z, t, t);                                                               \
    r = out;                                                                           \
  }                                                                                    \
  static void PT##_add(PT& r, const PT& p, const PT& q) {                              \
    if (pt_is_inf(p)) { r = q; return; }                                               \
    if (pt_is_inf(q)) { r = p; return; }                                               \
    FE Z1Z1, Z2Z2, U1, U2, S1, S2, H, Rr, t;                                           \
    FE_SQR(Z1Z1, p.Z);                                                                 \
    FE_SQR(Z2Z2, q.Z);                                                                 \
    FE_MUL(U1, p.X, Z2Z2);                                                             \
    FE_MUL(U2, q.X, Z1Z1);                                                             \
    FE_MUL(t, q.Z, Z2Z2);                                                              \
    FE_MUL(S1, p.Y, t);                                                                \
    FE_MUL(t, p.Z, Z1Z1);                                                              \
    FE_MUL(S2, q.Y, t);                                                                \
    FE_SUB(H, U2, U1);                                                                 \
    FE_SUB(Rr, S2, S1);                                                                \
    if (FE_ZEROQ(H)) {                                                                 \
      if (FE_ZEROQ(Rr)) { PT##_dbl(r, p); return; }                                    \
      SETINF(r);                                                                       \
      return;                                                                          \
    }                                                                                  \
    FE H2, H3, U1H2;                                                                   \
    FE_SQR(H2, H);                                                                     \
    FE_MUL(H3, H, H2);                                                                 \
    FE_MUL(U1H2, U1, H2);                                                              \
    PT out;                                                                            \
    FE_SQR(t, Rr);                                                                     \
    FE_SUB(t, t, H3);                                                                  \
    FE two;                                                                            \
    FE_ADD(two, U1H2, U1H2);                                                           \
    FE_SUB(out.X, t, two);                                                             \
    FE_SUB(t, U1H2, out.X);                                                            \
    FE_MUL(t, Rr, t);                                                                  \
    FE s1h3;                                                                           \
    FE_MUL(s1h3, S1, H3);                                                              \
    FE_SUB(out.Y, t, s1h3);                                                            \
    FE_MUL(t, p.Z, q.Z);                                                               \
    FE_MUL(out.Z, t, H);                                                               \
    r = out;                                                                           \
  }

static inline void fp_sqr_w(fp r, const fp a) { fp_sqr(r, a); }
#define FP_COPY_M(r, a) fp_copy(r, a)
#define FP_SQR_M(r, a) fp_sqr(r, a)
#define FP_MUL_M(r, a, b) fp_mul(r, a, b)
#define FP_ADD_M(r, a, b) fp_add(r, a, b)
#define FP_SUB_M(r, a, b) fp_sub(r, a, b)
#define FP_NEG_M(r, a) fp_neg(r, a)
#define FP2_COPY_M(r, a) fp2_copy(r, a)
#define FP2_SQR_M(r, a) fp2_sqr(r, a)
#define FP2_MUL_M(r, a, b) fp2_mul(r, a, b)
#define FP2_ADD_M(r, a, b) fp2_add(r, a, b)
#define FP2_SUB_M(r, a, b) fp2_sub(r, a, b)
#define FP2_NEG_M(r, a) fp2_neg(r, a)

DEFINE_JAC(g1p, fp, FP_COPY_M, FP_SQR_M, FP_MUL_M, FP_ADD_M, FP_SUB_M, FP_NEG_M, fp_is_zero, g1_set_inf)
DEFINE_JAC(g2p, fp2, FP2_COPY_M, FP2_SQR_M, FP2_MUL_M, FP2_ADD_M, FP2_SUB_M, FP2_NEG_M, fp2_is_zero, g2_set_inf)

static void g1_neg(g1p& r, const g1p& p) { r = p; fp_neg(r.Y, p.Y); }
static void g2_neg(g2p& r, const g2p& p) { r = p; fp2_neg(r.Y, p.Y); }

template <typename PT, void DBL(PT&, const PT&), void ADD(PT&, const PT&, const PT&),
          void SETINF(PT&)>
static void pt_mul_bytes(PT& r, const PT& p, const uint8_t* e, size_t elen) {
  PT acc;
  SETINF(acc);
  for (size_t i = 0; i < elen; i++) {
    for (int bit = 7; bit >= 0; bit--) {
      DBL(acc, acc);
      if ((e[i] >> bit) & 1) ADD(acc, acc, p);
    }
  }
  r = acc;
}

static void g1_mul_bytes(g1p& r, const g1p& p, const uint8_t* e, size_t n) {
  pt_mul_bytes<g1p, g1p_dbl, g1p_add, g1_set_inf>(r, p, e, n);
}
static void g2_mul_bytes(g2p& r, const g2p& p, const uint8_t* e, size_t n) {
  pt_mul_bytes<g2p, g2p_dbl, g2p_add, g2_set_inf>(r, p, e, n);
}

static void g2_mul_u64(g2p& r, const g2p& p, uint64_t k) {
  uint8_t be[8];
  for (int i = 0; i < 8; i++) be[i] = (uint8_t)(k >> (56 - 8 * i));
  g2_mul_bytes(r, p, be, 8);
}

// to affine; p must not be infinity
static void g1_to_affine(fp x, fp y, const g1p& p) {
  fp zi, zi2, zi3;
  fp_inv(zi, p.Z);
  fp_sqr(zi2, zi);
  fp_mul(zi3, zi2, zi);
  fp_mul(x, p.X, zi2);
  fp_mul(y, p.Y, zi3);
}

static void g2_to_affine(fp2& x, fp2& y, const g2p& p) {
  fp2 zi, zi2, zi3;
  fp2_inv(zi, p.Z);
  fp2_sqr(zi2, zi);
  fp2_mul(zi3, zi2, zi);
  fp2_mul(x, p.X, zi2);
  fp2_mul(y, p.Y, zi3);
}

// on-curve checks (affine)
static bool g1_on_curve(const fp x, const fp y) {
  fp lhs, rhs;
  fp_sqr(lhs, y);
  fp_sqr(rhs, x);
  fp_mul(rhs, rhs, x);
  fp_add(rhs, rhs, FP_B3_G1);
  return fp_eq(lhs, rhs);
}

static bool g2_on_curve(const fp2& x, const fp2& y) {
  fp2 lhs, rhs;
  fp2_sqr(lhs, y);
  fp2_sqr(rhs, x);
  fp2_mul(rhs, rhs, x);
  fp2_add(rhs, rhs, FP2_B_G2);
  return fp2_eq(lhs, rhs);
}

// psi endomorphism on the twist (oracle curve.py g2_psi)
static void g2_psi(g2p& r, const g2p& p) {
  // psi((x, y)) = (conj(x) * CX, conj(y) * CY) on affine coordinates.
  // In Jacobian form conj distributes over X/Z^2 and Y/Z^3, so
  // conjugating X, Y, Z componentwise and scaling X, Y by the constants
  // realizes psi exactly (the constants multiply the affine coords).
  fp2 zconj, xc, yc;
  fp2_conj(zconj, p.Z);
  fp2_conj(xc, p.X);
  fp2_conj(yc, p.Y);
  fp2_mul(r.X, xc, PSI_CX);
  fp2_mul(r.Y, yc, PSI_CY);
  fp2_copy(r.Z, zconj);
}

// equality of Jacobian points
static bool g2_pt_eq(const g2p& a, const g2p& b) {
  if (pt_is_inf(a) || pt_is_inf(b)) return pt_is_inf(a) && pt_is_inf(b);
  fp2 az2, bz2, az3, bz3, l, r;
  fp2_sqr(az2, a.Z);
  fp2_sqr(bz2, b.Z);
  fp2_mul(l, a.X, bz2);
  fp2_mul(r, b.X, az2);
  if (!fp2_eq(l, r)) return false;
  fp2_mul(az3, az2, a.Z);
  fp2_mul(bz3, bz2, b.Z);
  fp2_mul(l, a.Y, bz3);
  fp2_mul(r, b.Y, az3);
  return fp2_eq(l, r);
}

// subgroup checks: G1 by order-R ladder; G2 by psi eigenvalue
// (psi(P) == [x]P, with x = -BLS_X_ABS: [x]P = -[|x|]P)
static bool g1_in_subgroup(const g1p& p) {
  g1p t;
  g1_mul_bytes(t, p, EXP_ORDER_R, EXP_ORDER_R_LEN);
  return pt_is_inf(t);
}

static bool g2_in_subgroup(const g2p& p) {
  if (pt_is_inf(p)) return true;
  g2p lhs, rhs;
  g2_psi(lhs, p);
  g2_mul_u64(rhs, p, BLS_X_ABS);
  g2_neg(rhs, rhs);  // [x]P with x negative
  return g2_pt_eq(lhs, rhs);
}

// Budroni-Pintore cofactor clearing (oracle g2_clear_cofactor_fast):
// [x^2-x-1]P + [x-1]psi(P) + psi^2([2]P)
static void g2_clear_cofactor(g2p& r, const g2p& p) {
  if (pt_is_inf(p)) { r = p; return; }
  g2p t1, t2, t3, tmp;
  g2_mul_u64(tmp, p, BLS_X_ABS);
  g2_neg(t1, tmp);            // t1 = [x]P (x < 0)
  g2_psi(t2, p);              // t2 = psi(P)
  g2p two_p;
  g2p_dbl(two_p, p);
  g2_psi(t3, two_p);
  g2_psi(t3, t3);             // t3 = psi^2([2]P)
  g2p nt2;
  g2_neg(nt2, t2);
  g2p_add(t3, t3, nt2);       // t3 = psi^2(2P) - psi(P)
  g2p_add(t2, t1, t2);        // t2 = [x]P + psi(P)
  g2_mul_u64(tmp, t2, BLS_X_ABS);
  g2_neg(t2, tmp);            // t2 = [x]([x]P + psi(P))
  g2p_add(t3, t3, t2);
  g2p nt1;
  g2_neg(nt1, t1);
  g2p_add(t3, t3, nt1);       // - [x]P
  g2p np;
  g2_neg(np, p);
  g2p_add(r, t3, np);         // - P
}

// ---------------------------------------------------------------- sha256

struct Sha256 {
  uint32_t h[8];
  uint64_t len;
  uint8_t buf[64];
  size_t buflen;
};

static const uint32_t SHA_K[64] = {
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

static inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

static void sha_compress(uint32_t h[8], const uint8_t* block) {
  uint32_t w[64];
  for (int i = 0; i < 16; i++)
    w[i] = (uint32_t)block[4 * i] << 24 | (uint32_t)block[4 * i + 1] << 16 |
           (uint32_t)block[4 * i + 2] << 8 | block[4 * i + 3];
  for (int i = 16; i < 64; i++) {
    uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
    uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6], hh = h[7];
  for (int i = 0; i < 64; i++) {
    uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = hh + S1 + ch + SHA_K[i] + w[i];
    uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    uint32_t mj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = S0 + mj;
    hh = g; g = f; f = e; e = d + t1; d = c; c = b; b = a; a = t1 + t2;
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d;
  h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

static void sha_init(Sha256& s) {
  static const uint32_t iv[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                                 0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  memcpy(s.h, iv, sizeof(iv));
  s.len = 0;
  s.buflen = 0;
}

static void sha_update(Sha256& s, const uint8_t* data, size_t n) {
  s.len += n;
  while (n) {
    size_t take = 64 - s.buflen;
    if (take > n) take = n;
    memcpy(s.buf + s.buflen, data, take);
    s.buflen += take;
    data += take;
    n -= take;
    if (s.buflen == 64) {
      sha_compress(s.h, s.buf);
      s.buflen = 0;
    }
  }
}

static void sha_final(Sha256& s, uint8_t out[32]) {
  uint64_t bits = s.len * 8;
  uint8_t pad = 0x80;
  sha_update(s, &pad, 1);
  uint8_t z = 0;
  while (s.buflen != 56) sha_update(s, &z, 1);
  uint8_t lb[8];
  for (int i = 0; i < 8; i++) lb[i] = (uint8_t)(bits >> (56 - 8 * i));
  sha_update(s, lb, 8);
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 4; j++) out[4 * i + j] = (uint8_t)(s.h[i] >> (24 - 8 * j));
}

// ---------------------------------------------------------------- hash to G2

// field element from 64 uniform big-endian bytes: v mod p, into mont form
static void fp_from_be64_mod(fp r, const uint8_t* in) {
  // v = hi*2^384 + lo; mont(v) = mont_mul(lo, R2) + mont_mul(mont_mul(hi, R2), R2)
  fp lo, hi;
  for (int i = 0; i < 6; i++) {
    uint64_t limb = 0;
    for (int j = 0; j < 8; j++) limb = (limb << 8) | in[16 + (5 - i) * 8 + j];
    lo[i] = limb;
  }
  fp_zero(hi);
  for (int i = 0; i < 2; i++) {
    uint64_t limb = 0;
    for (int j = 0; j < 8; j++) limb = (limb << 8) | in[(1 - i) * 8 + j];
    hi[i] = limb;
  }
  fp lo_m, hi_m, hi_shift;
  fp_mul(lo_m, lo, FP_R2);
  fp_mul(hi_m, hi, FP_R2);
  fp_mul(hi_shift, hi_m, FP_R2);
  fp_add(r, lo_m, hi_shift);
}

static void expand_message_xmd(uint8_t* out, size_t len_in_bytes, const uint8_t* msg,
                               size_t msg_len, const uint8_t* dst, size_t dst_len) {
  size_t ell = (len_in_bytes + 31) / 32;
  uint8_t dst_prime[256];
  memcpy(dst_prime, dst, dst_len);
  dst_prime[dst_len] = (uint8_t)dst_len;
  size_t dpl = dst_len + 1;

  uint8_t b0[32];
  {
    Sha256 s;
    sha_init(s);
    uint8_t zpad[64] = {0};
    sha_update(s, zpad, 64);
    sha_update(s, msg, msg_len);
    uint8_t lib[2] = {(uint8_t)(len_in_bytes >> 8), (uint8_t)len_in_bytes};
    sha_update(s, lib, 2);
    uint8_t zero = 0;
    sha_update(s, &zero, 1);
    sha_update(s, dst_prime, dpl);
    sha_final(s, b0);
  }
  uint8_t bi[32];
  {
    Sha256 s;
    sha_init(s);
    sha_update(s, b0, 32);
    uint8_t one = 1;
    sha_update(s, &one, 1);
    sha_update(s, dst_prime, dpl);
    sha_final(s, bi);
  }
  size_t off = 0;
  for (size_t i = 1;; i++) {
    size_t take = len_in_bytes - off < 32 ? len_in_bytes - off : 32;
    memcpy(out + off, bi, take);
    off += take;
    if (off >= len_in_bytes || i >= ell) break;
    uint8_t x[32];
    for (int j = 0; j < 32; j++) x[j] = b0[j] ^ bi[j];
    Sha256 s;
    sha_init(s);
    sha_update(s, x, 32);
    uint8_t idx = (uint8_t)(i + 1);
    sha_update(s, &idx, 1);
    sha_update(s, dst_prime, dpl);
    sha_final(s, bi);
  }
}

static void poly_eval(fp2& r, const fp2* k, size_t n, const fp2& x) {
  fp2 acc;
  fp2_zero(acc);
  for (size_t i = n; i-- > 0;) {
    fp2 t;
    fp2_mul(t, acc, x);
    fp2_add(acc, t, k[i]);
  }
  fp2_copy(r, acc);
}

// SSWU map onto E', then 3-isogeny onto the twist (affine out; the SSWU
// image is never a pole for these parameters in practice — poles map to
// infinity and the caller treats that as a (harmless) infinity addend)
static bool map_to_curve_g2(g2p& out, const fp2& u) {
  fp2 tv1, tv2, x1, gx1, y, usq;
  fp2_sqr(usq, u);
  fp2_mul(tv1, SSWU_Z, usq);          // Z u^2
  fp2_sqr(tv2, tv1);
  fp2_add(tv2, tv2, tv1);             // Z^2 u^4 + Z u^2
  if (fp2_is_zero(tv2)) {
    fp2_copy(x1, SSWU_B_OVER_ZA);
  } else {
    fp2 inv, one;
    fp2_inv(inv, tv2);
    fp_copy(one.c0, FP_ONE_M);
    fp_zero(one.c1);
    fp2_add(inv, inv, one);
    fp2_mul(x1, SSWU_NEG_B_OVER_A, inv);
  }
  // g(x) = x^3 + A x + B on E'
  auto gp = [](fp2& r, const fp2& x) {
    fp2 x3, ax;
    fp2_sqr(x3, x);
    fp2_mul(x3, x3, x);
    fp2_mul(ax, SSWU_A, x);
    fp2_add(r, x3, ax);
    fp2_add(r, r, SSWU_B);
  };
  gp(gx1, x1);
  fp2 xx, yy;
  if (fp2_sqrt(y, gx1)) {
    fp2_copy(xx, x1);
    fp2_copy(yy, y);
  } else {
    fp2 x2, gx2;
    fp2_mul(x2, tv1, x1);
    gp(gx2, x2);
    if (!fp2_sqrt(y, gx2)) return false;  // cannot happen for valid params
    fp2_copy(xx, x2);
    fp2_copy(yy, y);
  }
  if (fp2_sgn0(u) != fp2_sgn0(yy)) fp2_neg(yy, yy);

  // isogeny E' -> E
  fp2 xden, yden;
  poly_eval(xden, ISO_K2, ISO_K2_N, xx);
  poly_eval(yden, ISO_K4, ISO_K4_N, xx);
  if (fp2_is_zero(xden) || fp2_is_zero(yden)) {
    g2_set_inf(out);
    return true;
  }
  fp2 xnum, ynum, xdi, ydi, ax, ay;
  poly_eval(xnum, ISO_K1, ISO_K1_N, xx);
  poly_eval(ynum, ISO_K3, ISO_K3_N, xx);
  fp2_inv(xdi, xden);
  fp2_inv(ydi, yden);
  fp2_mul(ax, xnum, xdi);
  fp2_mul(ay, ynum, ydi);
  fp2_mul(ay, ay, yy);
  fp2_copy(out.X, ax);
  fp2_copy(out.Y, ay);
  fp_copy(out.Z.c0, FP_ONE_M);
  fp_zero(out.Z.c1);
  return true;
}

static void hash_to_g2(g2p& out, const uint8_t* msg, size_t msg_len, const uint8_t* dst,
                       size_t dst_len) {
  uint8_t uniform[256];
  expand_message_xmd(uniform, 256, msg, msg_len, dst, dst_len);
  fp2 u0, u1;
  fp_from_be64_mod(u0.c0, uniform);
  fp_from_be64_mod(u0.c1, uniform + 64);
  fp_from_be64_mod(u1.c0, uniform + 128);
  fp_from_be64_mod(u1.c1, uniform + 192);
  g2p q0, q1, q;
  map_to_curve_g2(q0, u0);
  map_to_curve_g2(q1, u1);
  g2p_add(q, q0, q1);
  g2_clear_cofactor(out, q);
}

// ---------------------------------------------------------------- decompress

// ZCash compressed flags
static const uint8_t F_COMPRESSED = 0x80, F_INFINITY = 0x40, F_SIGN = 0x20;

// returns 0 ok (finite point), 1 infinity, negative on error
static int g1_decompress(g1p& out, const uint8_t in[48]) {
  uint8_t flags = in[0];
  if (!(flags & F_COMPRESSED)) return -1;
  if (flags & F_INFINITY) {
    if (flags & ~(F_COMPRESSED | F_INFINITY)) return -2;
    for (int i = 1; i < 48; i++)
      if (in[i]) return -2;
    return 1;
  }
  uint8_t xb[48];
  memcpy(xb, in, 48);
  xb[0] &= 0x1F;
  fp x;
  if (!fp_from_be48(x, xb)) return -3;
  fp rhs, y;
  fp_sqr(rhs, x);
  fp_mul(rhs, rhs, x);
  fp_add(rhs, rhs, FP_B3_G1);
  if (!fp_sqrt(y, rhs)) return -4;
  bool want_larger = (flags & F_SIGN) != 0;
  if (want_larger != fp_is_larger(y)) fp_neg(y, y);
  fp_copy(out.X, x);
  fp_copy(out.Y, y);
  fp_copy(out.Z, FP_ONE_M);
  return 0;
}

static int g2_decompress(g2p& out, const uint8_t in[96]) {
  uint8_t flags = in[0];
  if (!(flags & F_COMPRESSED)) return -1;
  if (flags & F_INFINITY) {
    if (flags & ~(F_COMPRESSED | F_INFINITY)) return -2;
    for (int i = 1; i < 96; i++)
      if (in[i]) return -2;
    return 1;
  }
  uint8_t x1b[48];
  memcpy(x1b, in, 48);
  x1b[0] &= 0x1F;
  fp2 x;
  if (!fp_from_be48(x.c1, x1b)) return -3;
  if (!fp_from_be48(x.c0, in + 48)) return -3;
  fp2 rhs, y;
  fp2_sqr(rhs, x);
  fp2_mul(rhs, rhs, x);
  fp2_add(rhs, rhs, FP2_B_G2);
  if (!fp2_sqrt(y, rhs)) return -4;
  bool want_larger = (flags & F_SIGN) != 0;
  if (want_larger != fp2_is_larger(y)) fp2_neg(y, y);
  fp2_copy(out.X, x);
  fp2_copy(out.Y, y);
  fp_copy(out.Z.c0, FP_ONE_M);
  fp_zero(out.Z.c1);
  return 0;
}

// ---------------------------------------------------------------- exports

static void fp2_to_device_limbs(int32_t* out, const fp2& a) {
  fp_to_device_limbs(out, a.c0);
  fp_to_device_limbs(out + 33, a.c1);
}

extern "C" {

// Prepare one signature set: decompress+subgroup-check pubkey (48B) and
// signature (96B), hash the 32-byte message to G2. Writes device-layout
// mont limbs: pk_xy (2*33 int32), h_xy (2*2*33), sig_xy (2*2*33).
// Returns 0 on success, nonzero error code otherwise (infinity pubkey or
// signature is an error here, matching prepare_sets' fail-fast).
int bls_prepare_one(const uint8_t* pk48, const uint8_t* sig96, const uint8_t* msg,
                    uint64_t msg_len, int32_t* pk_out, int32_t* h_out, int32_t* sig_out) {
  g1p pk;
  int rc = g1_decompress(pk, pk48);
  if (rc != 0) return rc == 1 ? -10 : rc;  // infinity pubkey rejected
  if (!g1_on_curve(pk.X, pk.Y)) return -5;
  if (!g1_in_subgroup(pk)) return -6;

  g2p sig;
  rc = g2_decompress(sig, sig96);
  if (rc != 0) return rc == 1 ? -11 : rc - 20;  // infinity signature rejected
  if (!g2_on_curve(sig.X, sig.Y)) return -25;
  if (!g2_in_subgroup(sig)) return -26;

  g2p h;
  hash_to_g2(h, msg, (size_t)msg_len, DST_G2, DST_G2_LEN);
  if (pt_is_inf(h)) return -30;  // astronomically unlikely
  fp2 hx, hy;
  g2_to_affine(hx, hy, h);

  fp_to_device_limbs(pk_out, pk.X);
  fp_to_device_limbs(pk_out + 33, pk.Y);
  fp2_to_device_limbs(h_out, hx);
  fp2_to_device_limbs(h_out + 66, hy);
  fp2_to_device_limbs(sig_out, sig.X);
  fp2_to_device_limbs(sig_out + 66, sig.Y);
  return 0;
}

// Batched + threaded prepare. msgs: n x 32 bytes. Returns 0 if every set
// is valid, else (index+1) of the first invalid set.
int bls_prepare_sets(uint64_t n, const uint8_t* pks, const uint8_t* sigs,
                     const uint8_t* msgs, int32_t* pk_out, int32_t* h_out,
                     int32_t* sig_out, int n_threads) {
  if (n == 0) return 0;
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 4;
  }
  if ((uint64_t)n_threads > n) n_threads = (int)n;
  std::atomic<uint64_t> next(0);
  std::atomic<int64_t> bad(-1);
  auto worker = [&]() {
    for (;;) {
      uint64_t i = next.fetch_add(1);
      if (i >= n || bad.load() >= 0) return;
      int rc = bls_prepare_one(pks + 48 * i, sigs + 96 * i, msgs + 32 * i, 32,
                               pk_out + 66 * i, h_out + 132 * i, sig_out + 132 * i);
      if (rc != 0) {
        int64_t expect = -1;
        int64_t mine = (int64_t)i;
        // keep the SMALLEST failing index: retry only while the stored
        // index is larger than ours
        while (!bad.compare_exchange_weak(expect, mine)) {
          if (expect >= 0 && expect <= mine) break;
        }
        return;
      }
    }
  };
  std::vector<std::thread> ts;
  for (int t = 1; t < n_threads; t++) ts.emplace_back(worker);
  worker();
  for (auto& t : ts) t.join();
  int64_t b = bad.load();
  return b >= 0 ? (int)(b + 1) : 0;
}

// Hash one message to an affine G2 point, output as 4x48-byte big-endian
// (x.c0, x.c1, y.c0, y.c1) — the differential-test surface vs the oracle.
int bls_hash_to_g2_bytes(const uint8_t* msg, uint64_t msg_len, uint8_t* out192) {
  g2p h;
  hash_to_g2(h, msg, (size_t)msg_len, DST_G2, DST_G2_LEN);
  if (pt_is_inf(h)) return -1;
  fp2 x, y;
  g2_to_affine(x, y, h);
  fp_to_be48(out192, x.c0);
  fp_to_be48(out192 + 48, x.c1);
  fp_to_be48(out192 + 96, y.c0);
  fp_to_be48(out192 + 144, y.c1);
  return 0;
}

// Decompress+check a G1 point to affine big-endian (x, y) 96 bytes.
// Returns 0 ok, 1 infinity, <0 error.
int bls_g1_decompress_check(const uint8_t* in48, uint8_t* out96) {
  g1p p;
  int rc = g1_decompress(p, in48);
  if (rc != 0) return rc;
  if (!g1_on_curve(p.X, p.Y)) return -5;
  if (!g1_in_subgroup(p)) return -6;
  fp x, y;
  g1_to_affine(x, y, p);
  fp_to_be48(out96, x);
  fp_to_be48(out96 + 48, y);
  return 0;
}

// Decompress+check a G2 point to affine big-endian (x0, x1, y0, y1).
int bls_g2_decompress_check(const uint8_t* in96, uint8_t* out192) {
  g2p p;
  int rc = g2_decompress(p, in96);
  if (rc != 0) return rc;
  if (!g2_on_curve(p.X, p.Y)) return -5;
  if (!g2_in_subgroup(p)) return -6;
  fp2 x, y;
  g2_to_affine(x, y, p);
  fp_to_be48(out192, x.c0);
  fp_to_be48(out192 + 48, x.c1);
  fp_to_be48(out192 + 96, y.c0);
  fp_to_be48(out192 + 144, y.c1);
  return 0;
}

int bls_host_selftest(void) {
  // G1 generator decompression roundtrip sanity: 0xc00.. infinity decodes
  uint8_t inf[48] = {0};
  inf[0] = 0xC0;
  g1p p;
  if (g1_decompress(p, inf) != 1) return 1;
  return 0;
}

}  // extern "C"
