// K6: k_i*P_i with one scalar per lane, Jacobian double-and-add MSB-first,
// on G1 and on G2.
//
// Replaces drand_tpu/ops/pallas_field.py _ladder_var_call
// (_ladder_var_math), both instances: batched signing (256 bits), the
// signed-digit GLV Lagrange ladders of batched tBLS recovery (130 bits on
// G1, 66 on G2) and the DKG Horner steps.
//
// Bound on this card: integer multiply-adds.
// Design: one thread per lane.  The bit rows are (nbits, B) int32, read
// coalesced as bits[i * B + lane].  Every step computes the double and the
// complete add and picks the sum or the doubled accumulator with a
// word-by-word select, written once: the bits differ lane by lane, so a
// warp diverges on every step, and a G2 point copied under per-lane
// branches faulted on the card (field.cuh, g2_select).  Computing the add
// on a zero bit and discarding it is what the TPU kernel does too; the
// accumulator starts at infinity as there, so the Jacobian representative
// equals the JAX package's limb for limb.

#include "field.cuh"

using namespace drand;

template <class J>
DI void ladder_var_lane(const uint32_t* in, uint32_t* out,
                        const int32_t* bits, int nbits, int64_t B,
                        int64_t lane) {
  J pt, acc, sum;
  load_point(pt, in, 0, B, lane);
  point_infinity(acc);
  for (int i = 0; i < nbits; i++) {
    point_double(acc, acc);
    point_add(sum, acc, pt);
    point_select(acc, bits[(int64_t)i * B + lane] != 0, sum, acc);
  }
  store_point(out, 0, acc, B, lane);
}

#ifdef __CUDACC__
template <class J>
__global__ void __launch_bounds__(128) k_ladder_var(const uint32_t* in,
                                                    uint32_t* out,
                                                    const int32_t* bits,
                                                    int nbits, int64_t B) {
  const int64_t lane = DRAND_LANE_INDEX();
  if (lane < B) ladder_var_lane<J>(in, out, bits, nbits, B, lane);
}

extern "C" int drand_ladder_var_g1(const void* in, void* out,
                                   const void* bits, int nbits, int64_t B,
                                   void* stream) {
  DRAND_LAUNCH(k_ladder_var<G1J>, B, 128, stream, (const uint32_t*)in,
               (uint32_t*)out, (const int32_t*)bits, nbits, B);
}

extern "C" int drand_ladder_var_g2(const void* in, void* out,
                                   const void* bits, int nbits, int64_t B,
                                   void* stream) {
  DRAND_LAUNCH(k_ladder_var<G2J>, B, 128, stream, (const uint32_t*)in,
               (uint32_t*)out, (const int32_t*)bits, nbits, B);
}
#else
template <class J>
static int ladder_var_host(const void* in, void* out, const void* bits,
                           int nbits, int64_t B) {
  for (int64_t lane = 0; lane < B; lane++)
    ladder_var_lane<J>((const uint32_t*)in, (uint32_t*)out,
                       (const int32_t*)bits, nbits, B, lane);
  return 0;
}

extern "C" int drand_ladder_var_g1(const void* in, void* out,
                                   const void* bits, int nbits, int64_t B,
                                   void* stream) {
  (void)stream;
  return ladder_var_host<G1J>(in, out, bits, nbits, B);
}

extern "C" int drand_ladder_var_g2(const void* in, void* out,
                                   const void* bits, int nbits, int64_t B,
                                   void* stream) {
  (void)stream;
  return ladder_var_host<G2J>(in, out, bits, nbits, B);
}
#endif
