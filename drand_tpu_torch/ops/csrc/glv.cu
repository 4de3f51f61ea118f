// K8: the GLV joint ladder of the RLC: [k0]P + [k1]phi(P) on G1 and
// [k0]Q + [k1]psi^2(Q) on G2.
//
// Replaces drand_tpu/ops/pallas_field.py _ladder_glv_mixed_call
// (_ladder_glv_mixed_math), both instances: the tables {P, endo(P),
// P + endo(P)} arrive affine, the accumulator starts at infinity, every
// step doubles and then mixed-adds the entry the bit pair (b0, b1) selects
// where b0 | b1 -- the JAX selections in the JAX order, so the Jacobian
// output equals the JAX package's limb for limb.
//
// Bound on this card: integer multiply-adds (G1: 64 doublings of 7 products
// and about 48 mixed adds of 18 a lane for random 64-bit halves; G2: 32
// steps, each product 3 Fp products).  Design: one thread per lane; the
// bits are per lane, read from the (2, nbits, B) planes (neighbouring
// threads on neighbouring words), so the skip of a zero pair is a per-lane
// branch.  G1 keeps its three affine tables in registers and selects the
// entry word by word.  G2's tables are 144 words and its accumulator 72,
// more than the register file holds for a thread: the selected entry is
// read from device memory at each step (read-only, it stays in L1/L2).

#include "field.cuh"

using namespace drand;

// tables: (6, 12, B) words, coordinates P.x, P.y, phi.x, phi.y, P3.x, P3.y;
// bits: (2, nbits, B) int32, plane 0 = b0, plane 1 = b1, MSB first
DI void glv_lane_g1(const uint32_t* tab, const int32_t* bits, uint32_t* out,
                    int nbits, int64_t B, int64_t lane) {
  G1A pt, phi, p3, t;
  load_fp(pt.x, tab, 0, B, lane);
  load_fp(pt.y, tab, 1, B, lane);
  load_fp(phi.x, tab, 2, B, lane);
  load_fp(phi.y, tab, 3, B, lane);
  load_fp(p3.x, tab, 4, B, lane);
  load_fp(p3.y, tab, 5, B, lane);
  const int32_t* b0 = bits + lane;
  const int32_t* b1 = bits + (int64_t)nbits * B + lane;
  G1J acc;
  g1_infinity(acc);
  for (int i = 0; i < nbits; i++) {
    g1_double(acc, acc);
    const bool c0 = b0[(int64_t)i * B] == 1;
    const bool c1 = b1[(int64_t)i * B] == 1;
    if (c0 || c1) {
      // sel(b0, sel(b1, P3, P), sel(b1, phi, P)), word by word so the
      // tables stay in registers
      UNROLL for (int w = 0; w < 12; w++) {
        t.x.v[w] = c0 ? (c1 ? p3.x.v[w] : pt.x.v[w])
                      : (c1 ? phi.x.v[w] : pt.x.v[w]);
        t.y.v[w] = c0 ? (c1 ? p3.y.v[w] : pt.y.v[w])
                      : (c1 ? phi.y.v[w] : pt.y.v[w]);
      }
      g1_add_mixed(acc, acc, t);
    }
  }
  store_point(out, 0, acc, B, lane);
}

// tables: (12, 12, B) words, coordinates Q.x.c0, Q.x.c1, Q.y.c0, Q.y.c1,
// then psi^2(Q) and Q + psi^2(Q) likewise; bits as for G1
DI void glv_lane_g2(const uint32_t* tab, const int32_t* bits, uint32_t* out,
                    int nbits, int64_t B, int64_t lane) {
  const int32_t* b0 = bits + lane;
  const int32_t* b1 = bits + (int64_t)nbits * B + lane;
  G2J acc;
  G2A t;
  g2_infinity(acc);
  for (int i = 0; i < nbits; i++) {
    g2_double(acc, acc);
    const bool c0 = b0[(int64_t)i * B] == 1;
    const bool c1 = b1[(int64_t)i * B] == 1;
    if (c0 || c1) {
      // sel(b0, sel(b1, P3, Q), sel(b1, psi^2, Q)): table 2, 0 or 1
      const int entry = c0 ? (c1 ? 2 : 0) : 1;
      load_fp2(t.x, tab, 4 * entry, B, lane);
      load_fp2(t.y, tab, 4 * entry + 2, B, lane);
      g2_add_mixed(acc, acc, t);
    }
  }
  store_point(out, 0, acc, B, lane);
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(128) k_glv_g1(const uint32_t* tab,
                                                const int32_t* bits,
                                                uint32_t* out, int nbits,
                                                int64_t B) {
  const int64_t lane = DRAND_LANE_INDEX();
  if (lane < B) glv_lane_g1(tab, bits, out, nbits, B, lane);
}

__global__ void __launch_bounds__(128) k_glv_g2(const uint32_t* tab,
                                                const int32_t* bits,
                                                uint32_t* out, int nbits,
                                                int64_t B) {
  const int64_t lane = DRAND_LANE_INDEX();
  if (lane < B) glv_lane_g2(tab, bits, out, nbits, B, lane);
}

extern "C" int drand_glv_g1(const void* tab, const void* bits, void* out,
                            int nbits, int64_t B, void* stream) {
  DRAND_LAUNCH(k_glv_g1, B, 128, stream, (const uint32_t*)tab,
               (const int32_t*)bits, (uint32_t*)out, nbits, B);
}

extern "C" int drand_glv_g2(const void* tab, const void* bits, void* out,
                            int nbits, int64_t B, void* stream) {
  DRAND_LAUNCH(k_glv_g2, B, 128, stream, (const uint32_t*)tab,
               (const int32_t*)bits, (uint32_t*)out, nbits, B);
}
#else
extern "C" int drand_glv_g1(const void* tab, const void* bits, void* out,
                            int nbits, int64_t B, void* stream) {
  (void)stream;
  for (int64_t lane = 0; lane < B; lane++)
    glv_lane_g1((const uint32_t*)tab, (const int32_t*)bits, (uint32_t*)out,
                nbits, B, lane);
  return 0;
}

extern "C" int drand_glv_g2(const void* tab, const void* bits, void* out,
                            int nbits, int64_t B, void* stream) {
  (void)stream;
  for (int64_t lane = 0; lane < B; lane++)
    glv_lane_g2((const uint32_t*)tab, (const int32_t*)bits, (uint32_t*)out,
                nbits, B, lane);
  return 0;
}
#endif
