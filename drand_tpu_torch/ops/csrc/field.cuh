// BLS12-381 Fp and Fp2 arithmetic and the G1 and G2 group laws for the
// port's Hopper kernels.
//
// In the point kernels K7 and K8 one thread owns one lane, and in K1's
// chain and inversion (pow.cu); K2, K3, K4, K5 and K6 run a thread group a
// lane over this header's Fp product and sum (group.cuh).  An
// Fp element is 12 x 32-bit little-endian words in Montgomery form with
// R = 2^384 -- the same Montgomery values as the plain engine's 24 x 16-bit
// limbs (drand_tpu_torch/ops/limbs.py), so the wrappers only regroup words.
// Every function returns canonical values (< p), as the plain engine does.
//
// Replaces the lane-layout field layer of the TPU kernels
// (drand_tpu/ops/pallas_field.py: pf_mul, _norm, _cond_sub_p and the pf2
// tower copy; the pf6/pf12 formulas live in ops/fp12prog.py).  On the TPU
// the limbs lay on sublanes and a product was 24 vector multiply-accumulates
// over 16-bit limbs; here a product is a CIOS Montgomery multiplication on
// 32-bit words in registers, 2 x 144 word products (lo and hi halves) per
// multiply, which is what bounds every kernel of this file on the card
// (integer multiply-adds).
//
// Formulas that fix a projective representative (the G1 and G2 Jacobian
// double and complete add, the mixed add) follow the JAX package step for
// step; field products, inverses and powers have unique values, so those
// may use any correct formula.
//
// The header also compiles as plain C++ (no __CUDACC__): the same lane code
// then runs on the host, which is how its arithmetic can be checked on a
// machine without a GPU.

#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define DI static __device__ __forceinline__
#define DNI static __device__ __noinline__
#define CMEM static __constant__
#define UNROLL _Pragma("unroll")
#else
#define DI static inline
#define DNI static __attribute__((noinline))
#define CMEM static const
#define UNROLL
#endif

namespace drand {

struct Fp { uint32_t v[12]; };
struct Fp2 { Fp c0, c1; };

CMEM uint32_t kP[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u,
    0x6730d2a0u, 0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u,
    0x397fe69au, 0x1a0111eau};
// R mod p: 1 in Montgomery form
CMEM uint32_t kOne[12] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau,
    0x5f489857u, 0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u,
    0xfa80e493u, 0x15f65ec3u};
// -p^-1 mod 2^32
static constexpr uint32_t kN0 = 0xfffcfffdu;

// Rows of the constant bundle (kernels.py CONST_NAMES, the order of
// pallas_field._const_entries); 12 words per row.
enum {
  C_P = 0, C_ONE = 1, C_HALF = 2, C_BETA = 3, C_B2_0 = 4, C_B2_1 = 5,
  C_FROB1 = 6,   // frob1_i_0 at 6 + 2i, frob1_i_1 at 7 + 2i
  C_FROB2 = 18,  // frob2_i_0 at 18 + 2i, frob2_i_1 at 19 + 2i
  N_CONST = 30
};

// ---------------------------------------------------------------------------
// Fp
// ---------------------------------------------------------------------------

DI void fp_load_const(Fp& r, const uint32_t* c) {
  UNROLL for (int i = 0; i < 12; i++) r.v[i] = c[i];
}

DI void fp_zero(Fp& r) {
  UNROLL for (int i = 0; i < 12; i++) r.v[i] = 0u;
}

DI void fp_one(Fp& r) {
  UNROLL for (int i = 0; i < 12; i++) r.v[i] = kOne[i];
}

DI bool fp_is_zero(const Fp& a) {
  uint32_t acc = 0;
  UNROLL for (int i = 0; i < 12; i++) acc |= a.v[i];
  return acc == 0;
}

DI bool fp_eq(const Fp& a, const Fp& b) {
  uint32_t acc = 0;
  UNROLL for (int i = 0; i < 12; i++) acc |= a.v[i] ^ b.v[i];
  return acc == 0;
}

// s (< 2p, 12 words) -> s mod p
DI void fp_reduce_once(Fp& r, const uint32_t* s) {
  uint32_t d[12];
  uint64_t bw = 0;
  UNROLL for (int i = 0; i < 12; i++) {
    uint64_t t = (uint64_t)s[i] - kP[i] - bw;
    d[i] = (uint32_t)t;
    bw = t >> 63;
  }
  const bool ge = (bw == 0);
  UNROLL for (int i = 0; i < 12; i++) r.v[i] = ge ? d[i] : s[i];
}

DI void fp_add(Fp& r, const Fp& a, const Fp& b) {
  uint32_t s[12];
  uint64_t c = 0;
  UNROLL for (int i = 0; i < 12; i++) {
    c += (uint64_t)a.v[i] + b.v[i];
    s[i] = (uint32_t)c;
    c >>= 32;
  }
  fp_reduce_once(r, s);  // a + b < 2p < 2^384: no carry out
}

DI void fp_sub(Fp& r, const Fp& a, const Fp& b) {
  uint32_t d[12];
  uint64_t bw = 0;
  UNROLL for (int i = 0; i < 12; i++) {
    uint64_t t = (uint64_t)a.v[i] - b.v[i] - bw;
    d[i] = (uint32_t)t;
    bw = t >> 63;
  }
  const uint32_t mask = 0u - (uint32_t)bw;  // add p back on borrow
  uint64_t c = 0;
  UNROLL for (int i = 0; i < 12; i++) {
    c += (uint64_t)d[i] + (kP[i] & mask);
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
}

DI void fp_neg(Fp& r, const Fp& a) {
  const uint32_t mask = fp_is_zero(a) ? 0u : 0xffffffffu;  // 0 -> 0
  uint64_t bw = 0;
  UNROLL for (int i = 0; i < 12; i++) {
    uint64_t t = (uint64_t)(kP[i] & mask) - a.v[i] - bw;
    r.v[i] = (uint32_t)t;
    bw = t >> 63;
  }
}

// CIOS Montgomery product a*b*2^-384 mod p.  Every 64-bit accumulation is
// < 2^64: (2^32-1)^2 + 2 (2^32-1) = 2^64 - 1.  nvcc turns each step into a
// wide multiply-add with carry; hand-written PTX carry chains
// (mad.lo.cc / madc.hi.cc in asm volatile) measured slower on the H100 and
// built 9x slower (PERF.md, the Fp-product A/B).
DI void fp_mul(Fp& r, const Fp& a, const Fp& b) {
  uint32_t t[14];
  UNROLL for (int i = 0; i < 14; i++) t[i] = 0u;
  UNROLL for (int i = 0; i < 12; i++) {
    const uint32_t bi = b.v[i];
    uint64_t c = 0;
    UNROLL for (int j = 0; j < 12; j++) {
      uint64_t s = (uint64_t)a.v[j] * bi + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[12] + c;
    t[12] = (uint32_t)s;
    t[13] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * kN0;
    s = (uint64_t)m * kP[0] + t[0];
    c = s >> 32;
    UNROLL for (int j = 1; j < 12; j++) {
      s = (uint64_t)m * kP[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[12] + c;
    t[11] = (uint32_t)s;
    t[12] = t[13] + (uint32_t)(s >> 32);
  }
  // t < 2p < 2^384, so t[12] == 0 here
  fp_reduce_once(r, t);
}

#ifdef DRAND_SQR_AS_MUL
// The squaring as a general product: tools/torch_group_variants.py builds
// K1 so to time the squaring below against it.
DI void fp_sqr(Fp& r, const Fp& a) { fp_mul(r, a, a); }
#else
// Montgomery squaring a*a*2^-384 mod p: the 66 cross products a_i a_j (i <
// j) once, doubled by a one-bit shift, the 12 diagonal squares added, then
// the 12 reduction rounds of fp_mul on the 24-word square: 2 x 78 + 12 x
// 25 word products where fp_mul takes 2 x 144 + 12 x 25.  Every 64-bit
// step is < 2^64, as in fp_mul; the square is < p^2 < p 2^384, so the
// reduced value is < 2p and its word 24 is zero.
DI void fp_sqr(Fp& r, const Fp& a) {
  uint32_t t[24];
  UNROLL for (int i = 0; i < 24; i++) t[i] = 0u;
  UNROLL for (int i = 0; i < 11; i++) {
    uint64_t c = 0;
    UNROLL for (int j = i + 1; j < 12; j++) {
      const uint64_t s = (uint64_t)a.v[i] * a.v[j] + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    t[i + 12] = (uint32_t)c;
  }
  UNROLL for (int i = 23; i > 0; i--) t[i] = (t[i] << 1) | (t[i - 1] >> 31);
  t[0] <<= 1;
  uint64_t c = 0;
  UNROLL for (int i = 0; i < 12; i++) {
    const uint64_t sq = (uint64_t)a.v[i] * a.v[i];
    const uint64_t lo = (uint64_t)t[2 * i] + (uint32_t)sq + c;
    t[2 * i] = (uint32_t)lo;
    const uint64_t hi = (uint64_t)t[2 * i + 1] + (sq >> 32) + (lo >> 32);
    t[2 * i + 1] = (uint32_t)hi;
    c = hi >> 32;
  }
  uint32_t top = 0;  // the carry out of word i + 12, added at i + 13
  UNROLL for (int i = 0; i < 12; i++) {
    const uint32_t m = t[i] * kN0;
    uint64_t cc = 0;
    UNROLL for (int j = 0; j < 12; j++) {
      const uint64_t s = (uint64_t)m * kP[j] + t[i + j] + cc;
      t[i + j] = (uint32_t)s;
      cc = s >> 32;
    }
    const uint64_t s = (uint64_t)t[i + 12] + cc + top;
    t[i + 12] = (uint32_t)s;
    top = (uint32_t)(s >> 32);
  }
  fp_reduce_once(r, t + 12);
}
#endif

// ---------------------------------------------------------------------------
// Constant-time Fp inversion: Bernstein-Yang safegcd ("Fast constant-time
// gcd computation and modular inversion", TCHES 2019), in the batched form
// of libsecp256k1's modinv32: 30 divsteps at a time on the low words of f
// and g give a 2x2 transition matrix of 31-bit entries, which then updates
// f, g (exact division by 2^30) and d, e (division by 2^30 mod p) as
// 13-limb signed 30-bit numbers.  f = p, g = x, d = 0, e = 1 keep f = d x,
// g = e x (mod p); when g reaches 0, f = +-1 and x^-1 = +-d.
//
// The iteration count is a constant.  Theorem 11.2 of the paper: for f
// odd and f^2 + 4 g^2 <= 5 2^(2d), divstep^m(1, f, g) has g_m = 0 for
// every m >= floor((49 d + 57) / 17) (d >= 46).  With f = p < 2^381 and
// g < p, d = 381 gives m = 1101; the code runs 37 batches of 30 = 1110
// divsteps (steps after g = 0 leave f, g and d unchanged).  Every step
// and update is the same word operations for every input: the divstep's
// choices are masks, the loop counts are constants, no index depends on
// x.  0 -> 0.
//
// Montgomery in and out: the integer inverse of x = a 2^384 mod p is
// a^-1 2^-384; one product by 2^(3*384) mod p makes it a^-1 2^384.
// ---------------------------------------------------------------------------

struct S30 { int32_t v[13]; };   // sum v[i] 2^(30 i), v[0..11] in [0, 2^30)

constexpr int INV_BATCHES = 37;  // 37 x 30 = 1110 >= 1101 divsteps
constexpr int32_t M30 = 0x3fffffff;
// p in 30-bit limbs, and p^-1 mod 2^30
CMEM int32_t kP30[13] = {
    0x3fffaaab, 0x27fbffff, 0x153ffffb, 0x2affffac, 0x30f6241e, 0x034a83da,
    0x112bf673, 0x12e13ce1, 0x2cd76477, 0x1ed90d2e, 0x29a4b1ba, 0x3a8e5ff9,
    0x001a0111};
static constexpr uint32_t kPinv30 = 0x30003u;
// 2^(3*384) mod p: R^3 for the Montgomery fix-up
CMEM uint32_t kR3[12] = {
    0xd94ca1e0u, 0xed48ac6bu, 0x03a7adf8u, 0x315f831eu, 0x615e29ddu,
    0x9a53352au, 0x921e1761u, 0x34c04e5eu, 0x65724728u, 0x2512d435u,
    0x91755d4du, 0x0aa63460u};

// 30 divsteps on the low words of f (odd) and g.  zeta = -delta (delta
// starts at 1).  A divstep: if delta > 0 and g odd, (delta, f, g) <- (1 -
// delta, g, (g - f) / 2), else (1 + delta, f, (g + (g mod 2) f) / 2).  The
// matrix (u v; q r) maps the inputs, times 2^30, to the outputs, each row's
// |entries| summing to at most 2^30.
DI int32_t divsteps_30(int32_t zeta, uint32_t f, uint32_t g, int32_t* t) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
  UNROLL for (int i = 0; i < 30; i++) {
    const uint32_t c1 = (uint32_t)(zeta >> 31);     // delta > 0
    const uint32_t c2 = 0u - (g & 1u);              // g odd
    const uint32_t x = (f ^ c1) - c1, y = (u ^ c1) - c1, z = (v ^ c1) - c1;
    g += x & c2;                                    // g -+ f where g odd
    q += y & c2;
    r += z & c2;
    const uint32_t sw = c1 & c2;                    // the swap
    zeta = (int32_t)(((uint32_t)zeta ^ sw) - 1u - sw);
    f += g & sw;                                    // f <- old g
    u += q & sw;
    v += r & sw;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t[0] = (int32_t)u;
  t[1] = (int32_t)v;
  t[2] = (int32_t)q;
  t[3] = (int32_t)r;
  return zeta;
}

// (f, g) <- (u f + v g, q f + r g) / 2^30: exact
DI void s30_update_fg(S30& f, S30& g, const int32_t* t) {
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  int64_t cf = (int64_t)u * f.v[0] + (int64_t)v * g.v[0];
  int64_t cg = (int64_t)q * f.v[0] + (int64_t)r * g.v[0];
  cf >>= 30;
  cg >>= 30;
  UNROLL for (int i = 1; i < 13; i++) {
    const int32_t fi = f.v[i], gi = g.v[i];
    cf += (int64_t)u * fi + (int64_t)v * gi;
    cg += (int64_t)q * fi + (int64_t)r * gi;
    f.v[i - 1] = (int32_t)cf & M30;
    g.v[i - 1] = (int32_t)cg & M30;
    cf >>= 30;
    cg >>= 30;
  }
  f.v[12] = (int32_t)cf;
  g.v[12] = (int32_t)cg;
}

// (d, e) <- (u d + v e, q d + r e) / 2^30 mod p: multiples md, me of p
// clear the low 30 bits; in and out d, e in (-2p, p) (libsecp256k1's
// modinv32_update_de_30)
DI void s30_update_de(S30& d, S30& e, const int32_t* t) {
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  const int32_t sd = d.v[12] >> 31, se = e.v[12] >> 31;
  int32_t md = (u & sd) + (v & se), me = (q & sd) + (r & se);
  int64_t cd = (int64_t)u * d.v[0] + (int64_t)v * e.v[0];
  int64_t ce = (int64_t)q * d.v[0] + (int64_t)r * e.v[0];
  md -= (int32_t)((kPinv30 * (uint32_t)cd + (uint32_t)md) & (uint32_t)M30);
  me -= (int32_t)((kPinv30 * (uint32_t)ce + (uint32_t)me) & (uint32_t)M30);
  cd += (int64_t)kP30[0] * md;
  ce += (int64_t)kP30[0] * me;
  cd >>= 30;
  ce >>= 30;
  UNROLL for (int i = 1; i < 13; i++) {
    const int32_t di = d.v[i], ei = e.v[i];
    cd += (int64_t)u * di + (int64_t)v * ei + (int64_t)kP30[i] * md;
    ce += (int64_t)q * di + (int64_t)r * ei + (int64_t)kP30[i] * me;
    d.v[i - 1] = (int32_t)cd & M30;
    e.v[i - 1] = (int32_t)ce & M30;
    cd >>= 30;
    ce >>= 30;
  }
  d.v[12] = (int32_t)cd;
  e.v[12] = (int32_t)ce;
}

DI void s30_carry(S30& a) {
  UNROLL for (int i = 0; i < 12; i++) {
    a.v[i + 1] += a.v[i] >> 30;
    a.v[i] &= M30;
  }
}

// d in (-2p, p) -> d (negated where f < 0) in [0, p), by masks
DI void s30_normalize(S30& d, int32_t fsign) {
  int32_t m = d.v[12] >> 31;
  UNROLL for (int i = 0; i < 13; i++) d.v[i] += kP30[i] & m;
  m = fsign >> 31;
  UNROLL for (int i = 0; i < 13; i++) d.v[i] = (d.v[i] ^ m) - m;
  s30_carry(d);
  m = d.v[12] >> 31;
  UNROLL for (int i = 0; i < 13; i++) d.v[i] += kP30[i] & m;
  s30_carry(d);
}

DNI void fp_inv(Fp& r, const Fp& a) {
  S30 f, g, d, e;
  UNROLL for (int i = 0; i < 13; i++) {   // bits [30 i, 30 i + 30) of a
    const int w = 30 * i / 32, s = 30 * i % 32;
    uint32_t x = a.v[w] >> s;
    if (s > 2 && w < 11) x |= a.v[w + 1] << (32 - s);
    g.v[i] = (int32_t)(x & (uint32_t)M30);
    f.v[i] = kP30[i];
    d.v[i] = 0;
    e.v[i] = 0;
  }
  e.v[0] = 1;
  int32_t zeta = -1, t[4];
  for (int b = 0; b < INV_BATCHES; b++) {
    zeta = divsteps_30(zeta, (uint32_t)f.v[0], (uint32_t)g.v[0], t);
    s30_update_de(d, e, t);
    s30_update_fg(f, g, t);
  }
  s30_normalize(d, f.v[12]);
  Fp x, k;
  UNROLL for (int j = 0; j < 12; j++) {   // bits [32 j, 32 j + 32) of d
    const int l = 32 * j / 30, s = 32 * j % 30;
    x.v[j] = ((uint32_t)d.v[l] >> s) | ((uint32_t)d.v[l + 1] << (30 - s));
  }
  fp_load_const(k, kR3);
  fp_mul(r, x, k);
}

// ---------------------------------------------------------------------------
// Fp2 = Fp[u]/(u^2 + 1)
// ---------------------------------------------------------------------------

DI void fp2_zero(Fp2& r) { fp_zero(r.c0); fp_zero(r.c1); }
DI void fp2_one(Fp2& r) { fp_one(r.c0); fp_zero(r.c1); }

DI void fp2_add(Fp2& r, const Fp2& a, const Fp2& b) {
  fp_add(r.c0, a.c0, b.c0);
  fp_add(r.c1, a.c1, b.c1);
}

DI void fp2_sub(Fp2& r, const Fp2& a, const Fp2& b) {
  fp_sub(r.c0, a.c0, b.c0);
  fp_sub(r.c1, a.c1, b.c1);
}

DI void fp2_neg(Fp2& r, const Fp2& a) {
  fp_neg(r.c0, a.c0);
  fp_neg(r.c1, a.c1);
}

DNI void fp2_mul(Fp2& r, const Fp2& a, const Fp2& b) {
  Fp t0, t1, t2, s0, s1;
  fp_mul(t0, a.c0, b.c0);
  fp_mul(t1, a.c1, b.c1);
  fp_add(s0, a.c0, a.c1);
  fp_add(s1, b.c0, b.c1);
  fp_mul(t2, s0, s1);
  fp_sub(r.c0, t0, t1);
  fp_sub(t2, t2, t0);
  fp_sub(r.c1, t2, t1);
}

DNI void fp2_sqr(Fp2& r, const Fp2& a) {
  Fp s, d, m;
  fp_add(s, a.c0, a.c1);
  fp_sub(d, a.c0, a.c1);
  fp_mul(m, a.c0, a.c1);
  fp_mul(r.c0, s, d);
  fp_add(r.c1, m, m);
}

// ---------------------------------------------------------------------------
// G1 Jacobian group law (drand_tpu/ops/curve.py DevCurve.double / add)
// ---------------------------------------------------------------------------

struct G1J { Fp X, Y, Z; };

DI void g1_infinity(G1J& r) {
  fp_one(r.X);
  fp_one(r.Y);
  fp_zero(r.Z);
}

DNI void g1_double(G1J& r, const G1J& p) {
  Fp A, B, t, XB, C, U, D, E, Fv, X3, Y3a, C2, C4, Y3, Z3, tmp;
  fp_sqr(A, p.X);
  fp_sqr(B, p.Y);
  fp_mul(t, p.Y, p.Z);
  fp_add(XB, p.X, B);
  fp_sqr(C, B);
  fp_sqr(U, XB);
  fp_sub(D, U, A);
  fp_sub(D, D, C);
  fp_add(D, D, D);
  fp_add(E, A, A);
  fp_add(E, E, A);
  fp_sqr(Fv, E);
  fp_add(tmp, D, D);
  fp_sub(X3, Fv, tmp);
  fp_sub(tmp, D, X3);
  fp_mul(Y3a, E, tmp);
  fp_add(C2, C, C);
  fp_add(C4, C2, C2);
  fp_add(tmp, C4, C4);
  fp_sub(Y3, Y3a, tmp);
  fp_add(Z3, t, t);
  r.X = X3;
  r.Y = Y3;
  r.Z = Z3;
}

// Complete addition: infinity operands, P == Q and P == -Q by selection,
// in the JAX package's order of precedence.
DNI void g1_add(G1J& r, const G1J& p, const G1J& q) {
  Fp Z12, Z1Z1, Z2Z2, ZS, dA, dB, dt, XB, U1, U2, t1, t2, dC, dU, dD, dE;
  Fp S1, S2, dFv, H, HH, rr, dX3, I, dY3a, dC2, dC4, dY3, dZ3, J, V, RR, Z3;
  Fp X3, Y3a, S1J, Y3, tmp;
  fp_add(Z12, p.Z, q.Z);
  fp_sqr(Z1Z1, p.Z);
  fp_sqr(Z2Z2, q.Z);
  fp_sqr(ZS, Z12);
  fp_sqr(dA, p.X);
  fp_sqr(dB, p.Y);
  fp_mul(dt, p.Y, p.Z);
  fp_add(XB, p.X, dB);
  fp_mul(U1, p.X, Z2Z2);
  fp_mul(U2, q.X, Z1Z1);
  fp_mul(t1, q.Z, Z2Z2);
  fp_mul(t2, p.Z, Z1Z1);
  fp_sqr(dC, dB);
  fp_sqr(dU, XB);
  fp_sub(dD, dU, dA);
  fp_sub(dD, dD, dC);
  fp_add(dD, dD, dD);
  fp_add(dE, dA, dA);
  fp_add(dE, dE, dA);
  fp_mul(S1, p.Y, t1);
  fp_mul(S2, q.Y, t2);
  fp_sqr(dFv, dE);
  fp_sub(H, U2, U1);
  fp_add(HH, H, H);
  fp_sub(rr, S2, S1);
  fp_add(rr, rr, rr);
  fp_add(tmp, dD, dD);
  fp_sub(dX3, dFv, tmp);
  fp_sqr(I, HH);
  fp_sub(tmp, dD, dX3);
  fp_mul(dY3a, dE, tmp);
  fp_add(dC2, dC, dC);
  fp_add(dC4, dC2, dC2);
  fp_add(tmp, dC4, dC4);
  fp_sub(dY3, dY3a, tmp);
  fp_add(dZ3, dt, dt);
  fp_mul(J, H, I);
  fp_mul(V, U1, I);
  fp_sqr(RR, rr);
  fp_sub(tmp, ZS, Z1Z1);
  fp_sub(tmp, tmp, Z2Z2);
  fp_mul(Z3, tmp, H);
  fp_sub(X3, RR, J);
  fp_add(tmp, V, V);
  fp_sub(X3, X3, tmp);
  fp_sub(tmp, V, X3);
  fp_mul(Y3a, rr, tmp);
  fp_mul(S1J, S1, J);
  fp_add(tmp, S1J, S1J);
  fp_sub(Y3, Y3a, tmp);

  const bool inf1 = fp_is_zero(p.Z);
  const bool inf2 = fp_is_zero(q.Z);
  const bool same_x = fp_eq(U1, U2) && !inf1 && !inf2;
  const bool same_y = fp_eq(S1, S2);
  if (inf2) {
    r = p;
  } else if (inf1) {
    r = q;
  } else if (same_x && !same_y) {
    g1_infinity(r);
  } else if (same_x && same_y) {
    r.X = dX3;
    r.Y = dY3;
    r.Z = dZ3;
  } else {
    r.X = X3;
    r.Y = Y3;
    r.Z = Z3;
  }
}

struct G1A { Fp x, y; };  // affine, never infinity

// Complete mixed addition p + q, q affine (DevCurve.add_mixed): Z2 = 1
// drops 5 of the complete add's 23 products.  Precedence of the JAX
// selections: an infinite accumulator gives (x2, y2, 1), then P == -Q
// gives infinity, then P == Q the double.
DNI void g1_add_mixed(G1J& r, const G1J& p, const G1A& q) {
  Fp Z1Z1, dA, dB, dt, XB, U2, t2, dC, dU, dD, dE, S2, dFv, H, HH, rr, dX3;
  Fp I, dY3a, dC2, dC4, dY3, dZ3, J, V, RR, Z3, X3, Y3a, S1J, Y3, tmp;
  fp_sqr(Z1Z1, p.Z);
  fp_sqr(dA, p.X);
  fp_sqr(dB, p.Y);
  fp_mul(dt, p.Y, p.Z);
  fp_add(XB, p.X, dB);
  fp_mul(U2, q.x, Z1Z1);
  fp_mul(t2, p.Z, Z1Z1);
  fp_sqr(dC, dB);
  fp_sqr(dU, XB);
  fp_sub(dD, dU, dA);
  fp_sub(dD, dD, dC);
  fp_add(dD, dD, dD);
  fp_add(dE, dA, dA);
  fp_add(dE, dE, dA);
  fp_mul(S2, q.y, t2);
  fp_sqr(dFv, dE);
  fp_sub(H, U2, p.X);
  fp_add(HH, H, H);
  fp_sub(rr, S2, p.Y);
  fp_add(rr, rr, rr);
  fp_add(tmp, dD, dD);
  fp_sub(dX3, dFv, tmp);
  fp_sqr(I, HH);
  fp_sub(tmp, dD, dX3);
  fp_mul(dY3a, dE, tmp);
  fp_add(dC2, dC, dC);
  fp_add(dC4, dC2, dC2);
  fp_add(tmp, dC4, dC4);
  fp_sub(dY3, dY3a, tmp);
  fp_add(dZ3, dt, dt);
  fp_mul(J, H, I);
  fp_mul(V, p.X, I);
  fp_sqr(RR, rr);
  fp_mul(Z3, p.Z, HH);
  fp_sub(X3, RR, J);
  fp_add(tmp, V, V);
  fp_sub(X3, X3, tmp);
  fp_sub(tmp, V, X3);
  fp_mul(Y3a, rr, tmp);
  fp_mul(S1J, p.Y, J);
  fp_add(tmp, S1J, S1J);
  fp_sub(Y3, Y3a, tmp);

  const bool inf1 = fp_is_zero(p.Z);
  const bool same_x = fp_eq(U2, p.X) && !inf1;
  const bool same_y = fp_eq(S2, p.Y);
  if (inf1) {
    r.X = q.x;
    r.Y = q.y;
    fp_one(r.Z);
  } else if (same_x && !same_y) {
    g1_infinity(r);
  } else if (same_x && same_y) {
    r.X = dX3;
    r.Y = dY3;
    r.Z = dZ3;
  } else {
    r.X = X3;
    r.Y = Y3;
    r.Z = Z3;
  }
}

// ---------------------------------------------------------------------------
// G2 Jacobian group law over Fp2: the same formulas as G1 (the JAX
// DevCurve is generic over its field), product group by product group.  A
// G2 point is 72 words, so its temporaries live in local memory; the
// functions are __noinline__ to keep the kernels that call them within the
// register file and the build short.
// ---------------------------------------------------------------------------

struct G2J { Fp2 X, Y, Z; };
struct G2A { Fp2 x, y; };  // affine, never infinity

DI void g2_infinity(G2J& r) {
  fp2_one(r.X);
  fp2_one(r.Y);
  fp2_zero(r.Z);
}

DI bool fp2_is_zero(const Fp2& a) { return fp_is_zero(a.c0) && fp_is_zero(a.c1); }

DI bool fp2_eq(const Fp2& a, const Fp2& b) {
  return fp_eq(a.c0, b.c0) && fp_eq(a.c1, b.c1);
}

// r = c ? a : b, word by word: a select, not a branch.  The G2 adds pick
// their result this way and write r once: with per-lane branches that
// copied whole points (r = p where r and p are the same accumulator), a
// warp whose lanes diverged between the infinite-operand cases and the
// generic sum faulted with an illegal address on the H100.
DI void g2_select(G2J& r, bool c, const G2J& a, const G2J& b) {
  const Fp* pa = &a.X.c0;
  const Fp* pb = &b.X.c0;
  Fp* pr = &r.X.c0;
  UNROLL for (int k = 0; k < 6; k++)
    UNROLL for (int w = 0; w < 12; w++)
      pr[k].v[w] = c ? pa[k].v[w] : pb[k].v[w];
}

DNI void g2_double(G2J& r, const G2J& p) {
  Fp2 A, B, t, XB, C, U, D, E, Fv, X3, Y3a, C2, C4, tmp;
  fp2_sqr(A, p.X);
  fp2_sqr(B, p.Y);
  fp2_mul(t, p.Y, p.Z);
  fp2_add(XB, p.X, B);
  fp2_sqr(C, B);
  fp2_sqr(U, XB);
  fp2_sub(D, U, A);
  fp2_sub(D, D, C);
  fp2_add(D, D, D);
  fp2_add(E, A, A);
  fp2_add(E, E, A);
  fp2_sqr(Fv, E);
  fp2_add(tmp, D, D);
  fp2_sub(X3, Fv, tmp);
  fp2_sub(tmp, D, X3);
  fp2_mul(Y3a, E, tmp);
  fp2_add(C2, C, C);
  fp2_add(C4, C2, C2);
  fp2_add(tmp, C4, C4);
  r.X = X3;
  fp2_sub(r.Y, Y3a, tmp);
  fp2_add(r.Z, t, t);
}

// Complete addition: infinity operands, P == Q and P == -Q by selection,
// in the JAX package's order of precedence.
DNI void g2_add(G2J& r, const G2J& p, const G2J& q) {
  Fp2 Z12, Z1Z1, Z2Z2, ZS, dA, dB, dt, XB, U1, U2, t1, t2, dC, dU, dD, dE;
  Fp2 S1, S2, dFv, H, HH, rr, dX3, I, dY3a, dC2, dC4, dY3, dZ3, J, V, RR, Z3;
  Fp2 X3, Y3a, S1J, Y3, tmp;
  fp2_add(Z12, p.Z, q.Z);
  fp2_sqr(Z1Z1, p.Z);
  fp2_sqr(Z2Z2, q.Z);
  fp2_sqr(ZS, Z12);
  fp2_sqr(dA, p.X);
  fp2_sqr(dB, p.Y);
  fp2_mul(dt, p.Y, p.Z);
  fp2_add(XB, p.X, dB);
  fp2_mul(U1, p.X, Z2Z2);
  fp2_mul(U2, q.X, Z1Z1);
  fp2_mul(t1, q.Z, Z2Z2);
  fp2_mul(t2, p.Z, Z1Z1);
  fp2_sqr(dC, dB);
  fp2_sqr(dU, XB);
  fp2_sub(dD, dU, dA);
  fp2_sub(dD, dD, dC);
  fp2_add(dD, dD, dD);
  fp2_add(dE, dA, dA);
  fp2_add(dE, dE, dA);
  fp2_mul(S1, p.Y, t1);
  fp2_mul(S2, q.Y, t2);
  fp2_sqr(dFv, dE);
  fp2_sub(H, U2, U1);
  fp2_add(HH, H, H);
  fp2_sub(rr, S2, S1);
  fp2_add(rr, rr, rr);
  fp2_add(tmp, dD, dD);
  fp2_sub(dX3, dFv, tmp);
  fp2_sqr(I, HH);
  fp2_sub(tmp, dD, dX3);
  fp2_mul(dY3a, dE, tmp);
  fp2_add(dC2, dC, dC);
  fp2_add(dC4, dC2, dC2);
  fp2_add(tmp, dC4, dC4);
  fp2_sub(dY3, dY3a, tmp);
  fp2_add(dZ3, dt, dt);
  fp2_mul(J, H, I);
  fp2_mul(V, U1, I);
  fp2_sqr(RR, rr);
  fp2_sub(tmp, ZS, Z1Z1);
  fp2_sub(tmp, tmp, Z2Z2);
  fp2_mul(Z3, tmp, H);
  fp2_sub(X3, RR, J);
  fp2_add(tmp, V, V);
  fp2_sub(X3, X3, tmp);
  fp2_sub(tmp, V, X3);
  fp2_mul(Y3a, rr, tmp);
  fp2_mul(S1J, S1, J);
  fp2_add(tmp, S1J, S1J);
  fp2_sub(Y3, Y3a, tmp);

  const bool inf1 = fp2_is_zero(p.Z);
  const bool inf2 = fp2_is_zero(q.Z);
  const bool same_x = fp2_eq(U1, U2) && !inf1 && !inf2;
  const bool same_y = fp2_eq(S1, S2);
  G2J out = {X3, Y3, Z3}, alt = {dX3, dY3, dZ3};
  g2_select(out, same_x && same_y, alt, out);
  g2_infinity(alt);
  g2_select(out, same_x && !same_y, alt, out);
  g2_select(out, inf1, q, out);
  g2_select(out, inf2, p, out);
  r = out;
}

// Complete mixed addition p + q, q affine (DevCurve.add_mixed), with the
// JAX selections' precedence: an infinite accumulator gives (x2, y2, 1),
// then P == -Q gives infinity, then P == Q the double.
DNI void g2_add_mixed(G2J& r, const G2J& p, const G2A& q) {
  Fp2 Z1Z1, dA, dB, dt, XB, U2, t2, dC, dU, dD, dE, S2, dFv, H, HH, rr, dX3;
  Fp2 I, dY3a, dC2, dC4, dY3, dZ3, J, V, RR, Z3, X3, Y3a, S1J, Y3, tmp;
  fp2_sqr(Z1Z1, p.Z);
  fp2_sqr(dA, p.X);
  fp2_sqr(dB, p.Y);
  fp2_mul(dt, p.Y, p.Z);
  fp2_add(XB, p.X, dB);
  fp2_mul(U2, q.x, Z1Z1);
  fp2_mul(t2, p.Z, Z1Z1);
  fp2_sqr(dC, dB);
  fp2_sqr(dU, XB);
  fp2_sub(dD, dU, dA);
  fp2_sub(dD, dD, dC);
  fp2_add(dD, dD, dD);
  fp2_add(dE, dA, dA);
  fp2_add(dE, dE, dA);
  fp2_mul(S2, q.y, t2);
  fp2_sqr(dFv, dE);
  fp2_sub(H, U2, p.X);
  fp2_add(HH, H, H);
  fp2_sub(rr, S2, p.Y);
  fp2_add(rr, rr, rr);
  fp2_add(tmp, dD, dD);
  fp2_sub(dX3, dFv, tmp);
  fp2_sqr(I, HH);
  fp2_sub(tmp, dD, dX3);
  fp2_mul(dY3a, dE, tmp);
  fp2_add(dC2, dC, dC);
  fp2_add(dC4, dC2, dC2);
  fp2_add(tmp, dC4, dC4);
  fp2_sub(dY3, dY3a, tmp);
  fp2_add(dZ3, dt, dt);
  fp2_mul(J, H, I);
  fp2_mul(V, p.X, I);
  fp2_sqr(RR, rr);
  fp2_mul(Z3, p.Z, HH);
  fp2_sub(X3, RR, J);
  fp2_add(tmp, V, V);
  fp2_sub(X3, X3, tmp);
  fp2_sub(tmp, V, X3);
  fp2_mul(Y3a, rr, tmp);
  fp2_mul(S1J, p.Y, J);
  fp2_add(tmp, S1J, S1J);
  fp2_sub(Y3, Y3a, tmp);

  const bool inf1 = fp2_is_zero(p.Z);
  const bool same_x = fp2_eq(U2, p.X) && !inf1;
  const bool same_y = fp2_eq(S2, p.Y);
  G2J out = {X3, Y3, Z3}, alt = {dX3, dY3, dZ3};
  g2_select(out, same_x && same_y, alt, out);
  g2_infinity(alt);
  g2_select(out, same_x && !same_y, alt, out);
  alt.X = q.x;
  alt.Y = q.y;
  fp2_one(alt.Z);
  g2_select(out, inf1, alt, out);
  r = out;
}

// ---------------------------------------------------------------------------
// Lane I/O: structure-of-arrays, word w of coordinate c of lane b at
// (c * 12 + w) * B + b, so neighbouring threads read neighbouring words.
// ---------------------------------------------------------------------------

DI void load_fp(Fp& r, const uint32_t* base, int coord, int64_t B, int64_t lane) {
  const uint32_t* p = base + (int64_t)coord * 12 * B + lane;
  UNROLL for (int w = 0; w < 12; w++) r.v[w] = p[(int64_t)w * B];
}

DI void store_fp(uint32_t* base, int coord, const Fp& a, int64_t B, int64_t lane) {
  uint32_t* p = base + (int64_t)coord * 12 * B + lane;
  UNROLL for (int w = 0; w < 12; w++) p[(int64_t)w * B] = a.v[w];
}

// Points: G1 as 3 coordinates (X, Y, Z), G2 as 6 (X.c0, X.c1, Y.c0, ...),
// from coordinate c0 on.  The overloads let one lane template serve both.
DI void load_point(G1J& p, const uint32_t* base, int c0, int64_t B, int64_t lane) {
  load_fp(p.X, base, c0, B, lane);
  load_fp(p.Y, base, c0 + 1, B, lane);
  load_fp(p.Z, base, c0 + 2, B, lane);
}

DI void store_point(uint32_t* base, int c0, const G1J& p, int64_t B, int64_t lane) {
  store_fp(base, c0, p.X, B, lane);
  store_fp(base, c0 + 1, p.Y, B, lane);
  store_fp(base, c0 + 2, p.Z, B, lane);
}

DI void load_fp2(Fp2& a, const uint32_t* base, int c0, int64_t B, int64_t lane) {
  load_fp(a.c0, base, c0, B, lane);
  load_fp(a.c1, base, c0 + 1, B, lane);
}

DI void store_fp2(uint32_t* base, int c0, const Fp2& a, int64_t B, int64_t lane) {
  store_fp(base, c0, a.c0, B, lane);
  store_fp(base, c0 + 1, a.c1, B, lane);
}

DI void load_point(G2J& p, const uint32_t* base, int c0, int64_t B, int64_t lane) {
  load_fp2(p.X, base, c0, B, lane);
  load_fp2(p.Y, base, c0 + 2, B, lane);
  load_fp2(p.Z, base, c0 + 4, B, lane);
}

DI void store_point(uint32_t* base, int c0, const G2J& p, int64_t B, int64_t lane) {
  store_fp2(base, c0, p.X, B, lane);
  store_fp2(base, c0 + 2, p.Y, B, lane);
  store_fp2(base, c0 + 4, p.Z, B, lane);
}

DI void point_add(G1J& r, const G1J& p, const G1J& q) { g1_add(r, p, q); }
DI void point_add(G2J& r, const G2J& p, const G2J& q) { g2_add(r, p, q); }

}  // namespace drand

// Launch helpers shared by the kernel files: one thread per lane, the
// ragged edge masked; on the host the same lane function runs in a loop.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DRAND_LANE_INDEX() ((int64_t)blockIdx.x * blockDim.x + threadIdx.x)
#define DRAND_LAUNCH(kernel, B, threads, stream, ...)                        \
  do {                                                                       \
    if ((B) > 0) {                                                           \
      const int64_t blocks_ = ((B) + (threads) - 1) / (threads);             \
      kernel<<<(unsigned)blocks_, (threads), 0, (cudaStream_t)(stream)>>>(   \
          __VA_ARGS__);                                                      \
    }                                                                        \
    return (int)cudaGetLastError();                                          \
  } while (0)
#endif
