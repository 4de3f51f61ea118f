// BLS12-381 Fp arithmetic for the port's Hopper kernels: the Montgomery
// product and squaring, the constant-time inversion, and the lanes' I/O.
//
// K1's chain and inversion (pow.cu) run one thread a lane on these; K2-K8
// run a thread group a lane over this header's Fp product and group.cuh's
// linear ops, with the point and tower formulas in ops/fp12prog.py.  An
// Fp element is 12 x 32-bit little-endian words in Montgomery form with
// R = 2^384 -- the same Montgomery values as the plain engine's 24 x 16-bit
// limbs (drand_tpu_torch/ops/limbs.py), so the wrappers only regroup words.
// Every function returns canonical values (< p), as the plain engine does.
//
// Replaces the lane-layout field layer of the TPU kernels
// (drand_tpu/ops/pallas_field.py: pf_mul, _norm, _cond_sub_p; the pf2,
// pf6 and pf12 formulas and the point formulas live in ops/fp12prog.py).
// On the TPU the limbs lay on sublanes and a product was 24 vector
// multiply-accumulates over 16-bit limbs; here a product is a CIOS
// Montgomery multiplication on 32-bit words in registers, 2 x 144 word
// products (lo and hi halves) per multiply, which is what bounds every
// kernel on the card (integer multiply-adds).
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

CMEM uint32_t kP[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u,
    0x6730d2a0u, 0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u,
    0x397fe69au, 0x1a0111eau};
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

// The plain engine's layout: lane b's Fp as 24 int64 16-bit limbs at x +
// 24 b (drand_tpu_torch/ops/limbs.py), read and written by the kernels
// that take the limb tensors themselves (K1, K7, K8).
DI void load_fp_limbs(Fp& r, const int64_t* x, int64_t lane) {
  const int64_t* p = x + lane * 24;
  UNROLL for (int w = 0; w < 12; w++)
    r.v[w] = (uint32_t)p[2 * w] | ((uint32_t)p[2 * w + 1] << 16);
}

DI void store_fp_limbs(int64_t* out, const Fp& a, int64_t lane) {
  int64_t* p = out + lane * 24;
  UNROLL for (int w = 0; w < 12; w++) {
    p[2 * w] = a.v[w] & 0xffffu;
    p[2 * w + 1] = a.v[w] >> 16;
  }
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
