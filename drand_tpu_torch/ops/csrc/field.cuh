// BLS12-381 field tower and the G1 and G2 group laws for the port's Hopper
// kernels.
//
// One thread owns one lane.  An Fp element is 12 x 32-bit little-endian
// words in Montgomery form with R = 2^384 -- the same Montgomery values as
// the plain engine's 24 x 16-bit limbs (drand_tpu_torch/ops/limbs.py), so
// the wrappers only regroup words.  Every function returns canonical values
// (< p), as the plain engine does.
//
// Replaces the lane-layout field layer of the TPU kernels
// (drand_tpu/ops/pallas_field.py: pf_mul, _norm, _cond_sub_p and the
// pf2/pf6/pf12 tower copies).  On the TPU the limbs lay on sublanes and a
// product was 24 vector multiply-accumulates over 16-bit limbs; here a
// product is a CIOS Montgomery multiplication on 32-bit words in registers,
// 2 x 144 word products (lo and hi halves) per multiply, which is what bounds
// every kernel of this file on the card (integer multiply-adds).
//
// Formulas that fix a projective representative (the G1 and G2 Jacobian
// double and complete add, the mixed add, the Miller-loop steps) follow the
// JAX package step for step; field products, inverses and powers have unique values, so those
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
struct Fp6 { Fp2 c0, c1, c2; };
struct Fp12 { Fp6 c0, c1; };

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

DI void fp_sqr(Fp& r, const Fp& a) { fp_mul(r, a, a); }

// x^e for e given MSB-first as nbits bits (acc starts at 1).
DI void fp_pow_bits(Fp& r, const Fp& x, const int32_t* bits, int nbits) {
  Fp acc, base = x;
  fp_one(acc);
  for (int i = 0; i < nbits; i++) {
    fp_sqr(acc, acc);
    if (bits[i]) fp_mul(acc, acc, base);
  }
  r = acc;
}

// ---------------------------------------------------------------------------
// Fp2 = Fp[u]/(u^2 + 1)
// ---------------------------------------------------------------------------

DI void fp2_load_const(Fp2& r, const uint32_t* consts, int row0, int row1) {
  fp_load_const(r.c0, consts + 12 * row0);
  fp_load_const(r.c1, consts + 12 * row1);
}

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

DI void fp2_conj(Fp2& r, const Fp2& a) {
  r.c0 = a.c0;
  fp_neg(r.c1, a.c1);
}

DI void fp2_triple(Fp2& r, const Fp2& a) {
  Fp2 t;
  fp2_add(t, a, a);
  fp2_add(r, t, a);
}

// (c0 + c1 u)(1 + u) = (c0 - c1) + (c0 + c1) u
DI void fp2_mul_xi(Fp2& r, const Fp2& a) {
  Fp t0, t1;
  fp_sub(t0, a.c0, a.c1);
  fp_add(t1, a.c0, a.c1);
  r.c0 = t0;
  r.c1 = t1;
}

DI void fp2_mul_fp(Fp2& r, const Fp2& a, const Fp& k) {
  fp_mul(r.c0, a.c0, k);
  fp_mul(r.c1, a.c1, k);
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

DI bool fp2_is_zero(const Fp2& a) { return fp_is_zero(a.c0) && fp_is_zero(a.c1); }

// 1/a: one Fermat chain (bits of p - 2) on the norm
DNI void fp2_inv(Fp2& r, const Fp2& a, const int32_t* invbits, int ninv) {
  Fp t0, t1, n, ni;
  fp_sqr(t0, a.c0);
  fp_sqr(t1, a.c1);
  fp_add(n, t0, t1);
  fp_pow_bits(ni, n, invbits, ninv);
  fp_mul(r.c0, a.c0, ni);
  fp_mul(t1, a.c1, ni);
  fp_neg(r.c1, t1);
}

// ---------------------------------------------------------------------------
// Fp6 = Fp2[v]/(v^3 - xi)
// ---------------------------------------------------------------------------

DI void fp6_zero(Fp6& r) { fp2_zero(r.c0); fp2_zero(r.c1); fp2_zero(r.c2); }
DI void fp6_one(Fp6& r) { fp2_one(r.c0); fp2_zero(r.c1); fp2_zero(r.c2); }

DI void fp6_add(Fp6& r, const Fp6& a, const Fp6& b) {
  fp2_add(r.c0, a.c0, b.c0);
  fp2_add(r.c1, a.c1, b.c1);
  fp2_add(r.c2, a.c2, b.c2);
}

DI void fp6_sub(Fp6& r, const Fp6& a, const Fp6& b) {
  fp2_sub(r.c0, a.c0, b.c0);
  fp2_sub(r.c1, a.c1, b.c1);
  fp2_sub(r.c2, a.c2, b.c2);
}

DI void fp6_neg(Fp6& r, const Fp6& a) {
  fp2_neg(r.c0, a.c0);
  fp2_neg(r.c1, a.c1);
  fp2_neg(r.c2, a.c2);
}

// (a0 + a1 v + a2 v^2) v = xi a2 + a0 v + a1 v^2
DI void fp6_mul_by_v(Fp6& r, const Fp6& a) {
  Fp2 t;
  fp2_mul_xi(t, a.c2);
  r.c2 = a.c1;
  r.c1 = a.c0;
  r.c0 = t;
}

DNI void fp6_mul(Fp6& r, const Fp6& a, const Fp6& b) {
  Fp2 t0, t1, t2, x, y, c0, c1, c2;
  fp2_mul(t0, a.c0, b.c0);
  fp2_mul(t1, a.c1, b.c1);
  fp2_mul(t2, a.c2, b.c2);
  // c0 = t0 + xi ((a1 + a2)(b1 + b2) - t1 - t2)
  fp2_add(x, a.c1, a.c2);
  fp2_add(y, b.c1, b.c2);
  fp2_mul(c0, x, y);
  fp2_sub(c0, c0, t1);
  fp2_sub(c0, c0, t2);
  fp2_mul_xi(c0, c0);
  fp2_add(c0, c0, t0);
  // c1 = (a0 + a1)(b0 + b1) - t0 - t1 + xi t2
  fp2_add(x, a.c0, a.c1);
  fp2_add(y, b.c0, b.c1);
  fp2_mul(c1, x, y);
  fp2_sub(c1, c1, t0);
  fp2_sub(c1, c1, t1);
  fp2_mul_xi(x, t2);
  fp2_add(c1, c1, x);
  // c2 = (a0 + a2)(b0 + b2) - t0 - t2 + t1
  fp2_add(x, a.c0, a.c2);
  fp2_add(y, b.c0, b.c2);
  fp2_mul(c2, x, y);
  fp2_sub(c2, c2, t0);
  fp2_sub(c2, c2, t2);
  fp2_add(c2, c2, t1);
  r.c0 = c0;
  r.c1 = c1;
  r.c2 = c2;
}

DNI void fp6_inv(Fp6& r, const Fp6& a, const int32_t* invbits, int ninv) {
  Fp2 c0, c1, c2, t, u;
  fp2_sqr(c0, a.c0);          // c0 = a0^2 - xi a1 a2
  fp2_mul(t, a.c1, a.c2);
  fp2_mul_xi(t, t);
  fp2_sub(c0, c0, t);
  fp2_sqr(c1, a.c2);          // c1 = xi a2^2 - a0 a1
  fp2_mul_xi(c1, c1);
  fp2_mul(t, a.c0, a.c1);
  fp2_sub(c1, c1, t);
  fp2_sqr(c2, a.c1);          // c2 = a1^2 - a0 a2
  fp2_mul(t, a.c0, a.c2);
  fp2_sub(c2, c2, t);
  fp2_mul(t, a.c1, c2);       // tt = xi (a1 c2 + a2 c1) + a0 c0
  fp2_mul(u, a.c2, c1);
  fp2_add(t, t, u);
  fp2_mul_xi(t, t);
  fp2_mul(u, a.c0, c0);
  fp2_add(t, t, u);
  fp2_inv(t, t, invbits, ninv);
  fp2_mul(r.c0, c0, t);
  fp2_mul(r.c1, c1, t);
  fp2_mul(r.c2, c2, t);
}

// ---------------------------------------------------------------------------
// Fp12 = Fp6[w]/(w^2 - v)
// ---------------------------------------------------------------------------

DI void fp12_one(Fp12& r) { fp6_one(r.c0); fp6_zero(r.c1); }

DI void fp12_conj(Fp12& r, const Fp12& a) {
  r.c0 = a.c0;
  fp6_neg(r.c1, a.c1);
}

DNI void fp12_mul(Fp12& r, const Fp12& a, const Fp12& b) {
  Fp6 t0, t1, t2, x, y;
  fp6_mul(t0, a.c0, b.c0);
  fp6_mul(t1, a.c1, b.c1);
  fp6_add(x, a.c0, a.c1);
  fp6_add(y, b.c0, b.c1);
  fp6_mul(t2, x, y);
  fp6_mul_by_v(x, t1);
  fp6_add(r.c0, t0, x);
  fp6_sub(t2, t2, t0);
  fp6_sub(r.c1, t2, t1);
}

DNI void fp12_sqr(Fp12& r, const Fp12& a) {
  Fp6 tt, x, y, c0;
  fp6_mul(tt, a.c0, a.c1);
  fp6_add(x, a.c0, a.c1);
  fp6_mul_by_v(y, a.c1);
  fp6_add(y, a.c0, y);
  fp6_mul(c0, x, y);
  fp6_sub(c0, c0, tt);
  fp6_mul_by_v(x, tt);
  fp6_sub(r.c0, c0, x);
  fp6_add(r.c1, tt, tt);
}

DNI void fp12_inv(Fp12& r, const Fp12& a, const int32_t* invbits, int ninv) {
  Fp6 t0, t1, c0, c1;
  fp6_mul(t0, a.c0, a.c0);
  fp6_mul(t1, a.c1, a.c1);
  fp6_mul_by_v(t1, t1);
  fp6_sub(t0, t0, t1);
  fp6_inv(t0, t0, invbits, ninv);
  fp6_mul(c0, a.c0, t0);
  fp6_mul(c1, a.c1, t0);
  r.c0 = c0;
  fp6_neg(r.c1, c1);
}

// a^(p^j), j in {1, 2}: coefficient i of a = sum c_i w^i is conjugated for
// odd j and scaled by the bundle's frob{j}_i constant.
DNI void fp12_frobenius(Fp12& r, const Fp12& a, int j, const uint32_t* consts) {
  const Fp2* cs[6] = {&a.c0.c0, &a.c1.c0, &a.c0.c1, &a.c1.c1, &a.c0.c2, &a.c1.c2};
  Fp2 out[6];
  const int base = (j == 1) ? C_FROB1 : C_FROB2;
  for (int i = 0; i < 6; i++) {
    Fp2 c, g;
    if (j & 1) fp2_conj(c, *cs[i]);
    else c = *cs[i];
    fp2_load_const(g, consts, base + 2 * i, base + 2 * i + 1);
    fp2_mul(out[i], c, g);
  }
  r.c0.c0 = out[0]; r.c1.c0 = out[1];
  r.c0.c1 = out[2]; r.c1.c1 = out[3];
  r.c0.c2 = out[4]; r.c1.c2 = out[5];
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

// r = c ? a : b, word by word (the G1 twin of g2_select below).
DI void g1_select(G1J& r, bool c, const G1J& a, const G1J& b) {
  const Fp* pa = &a.X;
  const Fp* pb = &b.X;
  Fp* pr = &r.X;
  UNROLL for (int k = 0; k < 3; k++)
    UNROLL for (int w = 0; w < 12; w++)
      pr[k].v[w] = c ? pa[k].v[w] : pb[k].v[w];
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
// functions are __noinline__, as the Fp12 tower is, to keep the three
// kernels that call them within the register file and the build short.
// ---------------------------------------------------------------------------

struct G2J { Fp2 X, Y, Z; };
struct G2A { Fp2 x, y; };  // affine, never infinity

DI void g2_infinity(G2J& r) {
  fp2_one(r.X);
  fp2_one(r.Y);
  fp2_zero(r.Z);
}

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

DI void point_infinity(G1J& r) { g1_infinity(r); }
DI void point_infinity(G2J& r) { g2_infinity(r); }
DI void point_double(G1J& r, const G1J& p) { g1_double(r, p); }
DI void point_double(G2J& r, const G2J& p) { g2_double(r, p); }
DI void point_add(G1J& r, const G1J& p, const G1J& q) { g1_add(r, p, q); }
DI void point_add(G2J& r, const G2J& p, const G2J& q) { g2_add(r, p, q); }
DI void point_select(G1J& r, bool c, const G1J& a, const G1J& b) {
  g1_select(r, c, a, b);
}
DI void point_select(G2J& r, bool c, const G2J& a, const G2J& b) {
  g2_select(r, c, a, b);
}

// Fp12 leaves in (c6, c2, c) nesting order: 12 coordinates
DI void load_fp12(Fp12& f, const uint32_t* base, int64_t B, int64_t lane) {
  Fp* leaves[12] = {&f.c0.c0.c0, &f.c0.c0.c1, &f.c0.c1.c0, &f.c0.c1.c1,
                    &f.c0.c2.c0, &f.c0.c2.c1, &f.c1.c0.c0, &f.c1.c0.c1,
                    &f.c1.c1.c0, &f.c1.c1.c1, &f.c1.c2.c0, &f.c1.c2.c1};
  for (int i = 0; i < 12; i++) load_fp(*leaves[i], base, i, B, lane);
}

DI void store_fp12(uint32_t* base, const Fp12& f, int64_t B, int64_t lane) {
  const Fp* leaves[12] = {&f.c0.c0.c0, &f.c0.c0.c1, &f.c0.c1.c0, &f.c0.c1.c1,
                          &f.c0.c2.c0, &f.c0.c2.c1, &f.c1.c0.c0, &f.c1.c0.c1,
                          &f.c1.c1.c0, &f.c1.c1.c1, &f.c1.c2.c0, &f.c1.c2.c1};
  for (int i = 0; i < 12; i++) store_fp(base, i, *leaves[i], B, lane);
}

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
