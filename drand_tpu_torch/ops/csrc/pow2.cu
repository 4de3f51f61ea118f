// K5: Fp2 x^e for a fixed exponent, square-and-multiply MSB-first.
//
// Replaces drand_tpu/ops/pallas_field.py _pow2_call (_pow2_math): the
// E2 = (p^2 - 9)/16 scan (758 bits) that G2 signature decompression and
// both SSWU maps of hash-to-G2 share, at width 3N.
//
// Bound on this card: integer multiply-adds (an Fp2 squaring is 2 Fp
// products, an Fp2 product 3: about 1,500 + 3 x popcount(e) Fp products a
// lane, 192 bytes in and out).  Design: one thread per lane, the base and
// the accumulator in registers (the tower's __noinline__ Fp2 products take
// them by reference); the exponent bits are one small device array read by
// every thread, so the zero-bit skip is a uniform branch, as in pow.cu.

#include "field.cuh"

using namespace drand;

DI void pow2_lane(const uint32_t* x, uint32_t* out, const int32_t* bits,
                  int nbits, int64_t B, int64_t lane) {
  Fp2 a, acc;
  load_fp2(a, x, 0, B, lane);
  fp2_one(acc);
  for (int i = 0; i < nbits; i++) {
    fp2_sqr(acc, acc);
    if (bits[i]) fp2_mul(acc, acc, a);
  }
  store_fp2(out, 0, acc, B, lane);
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(128) k_pow2(const uint32_t* x,
                                              uint32_t* out,
                                              const int32_t* bits, int nbits,
                                              int64_t B) {
  const int64_t lane = DRAND_LANE_INDEX();
  if (lane < B) pow2_lane(x, out, bits, nbits, B, lane);
}

extern "C" int drand_pow2(const void* x, void* out, const void* bits,
                          int nbits, int64_t B, void* stream) {
  DRAND_LAUNCH(k_pow2, B, 128, stream, (const uint32_t*)x, (uint32_t*)out,
               (const int32_t*)bits, nbits, B);
}
#else
extern "C" int drand_pow2(const void* x, void* out, const void* bits,
                          int nbits, int64_t B, void* stream) {
  (void)stream;
  for (int64_t lane = 0; lane < B; lane++)
    pow2_lane((const uint32_t*)x, (uint32_t*)out, (const int32_t*)bits, nbits,
              B, lane);
  return 0;
}
#endif
