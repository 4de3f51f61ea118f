// K2: k*P on G1 for a fixed scalar k, Jacobian double-and-add MSB-first.
//
// Replaces drand_tpu/ops/pallas_field.py _ladder_fixed_call
// (_ladder_fixed_math), G1 instance: the two |x| ladders of the subgroup
// check and the (1 - x) cofactor clearing.
//
// Bound on this card: integer multiply-adds (64 doubles of 9 products and a
// few complete adds of 23 products per |x| ladder).  Design: one thread per
// lane, the accumulator and the base point in registers; the scalar bits are
// a small device array read by every thread, so a zero bit skips its add as
// a uniform branch.  The accumulator starts at infinity, as the TPU ladder
// does, which yields the same Jacobian representative as the JAX package.

#include "field.cuh"

using namespace drand;

DI void ladder_lane(const uint32_t* in, uint32_t* out, const int32_t* bits,
                    int nbits, int64_t B, int64_t lane) {
  G1J pt, acc;
  load_fp(pt.X, in, 0, B, lane);
  load_fp(pt.Y, in, 1, B, lane);
  load_fp(pt.Z, in, 2, B, lane);
  g1_infinity(acc);
  for (int i = 0; i < nbits; i++) {
    g1_double(acc, acc);
    if (bits[i]) g1_add(acc, acc, pt);
  }
  store_fp(out, 0, acc.X, B, lane);
  store_fp(out, 1, acc.Y, B, lane);
  store_fp(out, 2, acc.Z, B, lane);
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(128) k_ladder_g1(const uint32_t* in,
                                                   uint32_t* out,
                                                   const int32_t* bits,
                                                   int nbits, int64_t B) {
  const int64_t lane = DRAND_LANE_INDEX();
  if (lane < B) ladder_lane(in, out, bits, nbits, B, lane);
}

extern "C" int drand_ladder_g1(const void* in, void* out, const void* bits,
                               int nbits, int64_t B, void* stream) {
  DRAND_LAUNCH(k_ladder_g1, B, 128, stream, (const uint32_t*)in,
               (uint32_t*)out, (const int32_t*)bits, nbits, B);
}
#else
extern "C" int drand_ladder_g1(const void* in, void* out, const void* bits,
                               int nbits, int64_t B, void* stream) {
  (void)stream;
  for (int64_t lane = 0; lane < B; lane++)
    ladder_lane((const uint32_t*)in, (uint32_t*)out, (const int32_t*)bits,
                nbits, B, lane);
  return 0;
}
#endif
