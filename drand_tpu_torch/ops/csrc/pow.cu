// K1: Fp x^e for a fixed exponent, square-and-multiply MSB-first.
//
// Replaces drand_tpu/ops/pallas_field.py _pow_call (_pow_math): the sqrt
// scan of G1 decompression + SSWU (e = (p-3)/4) and the Fermat inversions
// under to_affine (e = p-2).
//
// Bound on this card: integer multiply-adds (about 570 Montgomery products
// per lane for a 379-bit exponent, no memory traffic beyond 96 bytes in and
// out).  Design: one thread per lane, the element and the accumulator live
// in registers for the whole chain; the exponent bits are one small device
// array read by every thread, so the zero-bit skip is a uniform branch with
// no divergence.  No padding: the ragged edge is masked.

#include "field.cuh"

using namespace drand;

DI void pow_lane(const uint32_t* x, uint32_t* out, const int32_t* bits,
                 int nbits, int64_t B, int64_t lane) {
  Fp a, acc;
  load_fp(a, x, 0, B, lane);
  fp_pow_bits(acc, a, bits, nbits);
  store_fp(out, 0, acc, B, lane);
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(128) k_pow(const uint32_t* x, uint32_t* out,
                                             const int32_t* bits, int nbits,
                                             int64_t B) {
  const int64_t lane = DRAND_LANE_INDEX();
  if (lane < B) pow_lane(x, out, bits, nbits, B, lane);
}

extern "C" int drand_pow(const void* x, void* out, const void* bits, int nbits,
                         int64_t B, void* stream) {
  DRAND_LAUNCH(k_pow, B, 128, stream, (const uint32_t*)x, (uint32_t*)out,
               (const int32_t*)bits, nbits, B);
}
#else
extern "C" int drand_pow(const void* x, void* out, const void* bits, int nbits,
                         int64_t B, void* stream) {
  (void)stream;
  for (int64_t lane = 0; lane < B; lane++)
    pow_lane((const uint32_t*)x, (uint32_t*)out, (const int32_t*)bits, nbits,
             B, lane);
  return 0;
}
#endif
