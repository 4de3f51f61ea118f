// K2: k*P for a fixed scalar k, Jacobian double-and-add MSB-first, on G1
// and on G2.
//
// Replaces drand_tpu/ops/pallas_field.py _ladder_fixed_call
// (_ladder_fixed_math), both instances: on G1 the two |x| ladders of the
// subgroup check and the (1 - x) cofactor clearing; on G2 the |x| ladder of
// the subgroup check and the two of Budroni-Pintore cofactor clearing.
//
// Bound on this card: integer multiply-adds (an |x| ladder: 64 doubles and
// 5 complete adds; a G2 product is 3 Fp products, a G2 squaring 2).
// Design: one thread per lane; the scalar bits are a small device array
// read by every thread, so a zero bit skips its add as a uniform branch.
// The accumulator starts at infinity, as the TPU ladder does, which yields
// the same Jacobian representative as the JAX package.  One lane template
// serves both curves through field.cuh's point overloads: the G1 point
// stays in registers, the G2 point (72 words) and its group-law
// temporaries go to local memory.

#include "field.cuh"

using namespace drand;

template <class J>
DI void ladder_lane(const uint32_t* in, uint32_t* out, const int32_t* bits,
                    int nbits, int64_t B, int64_t lane) {
  J pt, acc;
  load_point(pt, in, 0, B, lane);
  point_infinity(acc);
  for (int i = 0; i < nbits; i++) {
    point_double(acc, acc);
    if (bits[i]) point_add(acc, acc, pt);
  }
  store_point(out, 0, acc, B, lane);
}

#ifdef __CUDACC__
template <class J>
__global__ void __launch_bounds__(128) k_ladder(const uint32_t* in,
                                                uint32_t* out,
                                                const int32_t* bits,
                                                int nbits, int64_t B) {
  const int64_t lane = DRAND_LANE_INDEX();
  if (lane < B) ladder_lane<J>(in, out, bits, nbits, B, lane);
}

extern "C" int drand_ladder_g1(const void* in, void* out, const void* bits,
                               int nbits, int64_t B, void* stream) {
  DRAND_LAUNCH(k_ladder<G1J>, B, 128, stream, (const uint32_t*)in,
               (uint32_t*)out, (const int32_t*)bits, nbits, B);
}

extern "C" int drand_ladder_g2(const void* in, void* out, const void* bits,
                               int nbits, int64_t B, void* stream) {
  DRAND_LAUNCH(k_ladder<G2J>, B, 128, stream, (const uint32_t*)in,
               (uint32_t*)out, (const int32_t*)bits, nbits, B);
}
#else
template <class J>
static int ladder_host(const void* in, void* out, const void* bits, int nbits,
                       int64_t B) {
  for (int64_t lane = 0; lane < B; lane++)
    ladder_lane<J>((const uint32_t*)in, (uint32_t*)out, (const int32_t*)bits,
                   nbits, B, lane);
  return 0;
}

extern "C" int drand_ladder_g1(const void* in, void* out, const void* bits,
                               int nbits, int64_t B, void* stream) {
  (void)stream;
  return ladder_host<G1J>(in, out, bits, nbits, B);
}

extern "C" int drand_ladder_g2(const void* in, void* out, const void* bits,
                               int nbits, int64_t B, void* stream) {
  (void)stream;
  return ladder_host<G2J>(in, out, bits, nbits, B);
}
#endif
