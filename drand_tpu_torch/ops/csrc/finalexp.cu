// K4: the final exponentiation f^((p^12 - 1)/r), times 3 in the hard part.
//
// Replaces drand_tpu/ops/pallas_field.py _finalexp_call (_finalexp_math)
// and follows its chain exactly: the easy part through fp12_inv (whose Fp
// inverse is the p-2 Fermat chain), then the five pow_x chains, Frobenius
// maps and conjugations in the same order.
//
// Bound on this card: integer multiply-adds (five 63-bit pow_x chains of
// Fp12 squarings, ~320 squarings and ~45 multiplications of Fp12 a lane).
// Design: one thread per lane, the Fp12 values in local memory, tower
// functions out of line; exponent bits are uniform across the warp.

#include "field.cuh"

using namespace drand;

// g^x for x < 0 on the cyclotomic subgroup: conj(g^|x|), bits of |x|
// after the leading one
DNI void pow_x(Fp12& r, const Fp12& g, const int32_t* xbits, int nxbits) {
  Fp12 acc = g;
  for (int i = 0; i < nxbits; i++) {
    fp12_sqr(acc, acc);
    if (xbits[i]) fp12_mul(acc, acc, g);
  }
  fp12_conj(r, acc);
}

DNI void finalexp(Fp12& out, const Fp12& fin, const uint32_t* consts,
                  const int32_t* xbits, int nxbits, const int32_t* invbits,
                  int ninv) {
  Fp12 f, t, u, e1, e2, e3;
  // easy part: f^((p^6 - 1)(p^2 + 1))
  fp12_conj(t, fin);
  fp12_inv(u, fin, invbits, ninv);
  fp12_mul(f, t, u);
  fp12_frobenius(t, f, 2, consts);
  fp12_mul(f, t, f);
  // hard part
  pow_x(t, f, xbits, nxbits);               // e1 = f^x * conj(f)
  fp12_conj(u, f);
  fp12_mul(e1, t, u);
  pow_x(t, e1, xbits, nxbits);              // e1 = e1^x * conj(e1)
  fp12_conj(u, e1);
  fp12_mul(e1, t, u);
  pow_x(t, e1, xbits, nxbits);              // e2 = e1^x * frob1(e1)
  fp12_frobenius(u, e1, 1, consts);
  fp12_mul(e2, t, u);
  pow_x(t, e2, xbits, nxbits);              // e3 = (e2^x)^x * frob2(e2) * conj(e2)
  pow_x(t, t, xbits, nxbits);
  fp12_frobenius(u, e2, 2, consts);
  fp12_mul(e3, t, u);
  fp12_conj(u, e2);
  fp12_mul(e3, e3, u);
  fp12_sqr(t, f);                           // f3 = f^2 * f
  fp12_mul(t, t, f);
  fp12_mul(out, e3, t);
}

DI void finalexp_lane(const uint32_t* in, uint32_t* out, const uint32_t* consts,
                      const int32_t* xbits, int nxbits, const int32_t* invbits,
                      int ninv, int64_t B, int64_t lane) {
  Fp12 f, r;
  load_fp12(f, in, B, lane);
  finalexp(r, f, consts, xbits, nxbits, invbits, ninv);
  store_fp12(out, r, B, lane);
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(64) k_finalexp(const uint32_t* in,
                                                 uint32_t* out,
                                                 const uint32_t* consts,
                                                 const int32_t* xbits,
                                                 int nxbits,
                                                 const int32_t* invbits,
                                                 int ninv, int64_t B) {
  const int64_t lane = DRAND_LANE_INDEX();
  if (lane < B)
    finalexp_lane(in, out, consts, xbits, nxbits, invbits, ninv, B, lane);
}

extern "C" int drand_finalexp(const void* in, void* out, const void* consts,
                              const void* xbits, int nxbits,
                              const void* invbits, int ninv, int64_t B,
                              void* stream) {
  DRAND_LAUNCH(k_finalexp, B, 64, stream, (const uint32_t*)in, (uint32_t*)out,
               (const uint32_t*)consts, (const int32_t*)xbits, nxbits,
               (const int32_t*)invbits, ninv, B);
}
#else
extern "C" int drand_finalexp(const void* in, void* out, const void* consts,
                              const void* xbits, int nxbits,
                              const void* invbits, int ninv, int64_t B,
                              void* stream) {
  (void)stream;
  for (int64_t lane = 0; lane < B; lane++)
    finalexp_lane((const uint32_t*)in, (uint32_t*)out, (const uint32_t*)consts,
                  (const int32_t*)xbits, nxbits, (const int32_t*)invbits, ninv,
                  B, lane);
  return 0;
}
#endif
