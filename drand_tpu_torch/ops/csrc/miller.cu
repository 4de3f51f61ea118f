// K3: the optimal-ate Miller loop over the 63 bits of |x| after the leading
// one, projective G2 steps with sparse line products into Fp12, conjugated
// at the end (x < 0).
//
// Replaces drand_tpu/ops/pallas_field.py _miller_call (_miller_math,
// _pf_dbl_step, _pf_add_step, _pf_apply_line).  The steps give the JAX
// package's field values: R and the line coefficients fix f up to a factor
// the final exponentiation kills, so the port must match f exactly, and it
// updates f in the same order (square, double line, add line on a set bit).
//
// Bound on this card: the latency of each lane's chain of dependent
// Montgomery products at the 2- and 8-pair launches of the RLC passes,
// integer multiply-adds at the exact passes' 16,384-28,672 pairs.  Design:
// a warp per pair (group.cuh): f, R, P, Q and the temporaries live in
// shared memory, and each step is a program of fp12prog.py ("miller"): per
// doubling step 100 products in 3 product phases (f^2 and the step's
// squarings together, then the step's products and the line scaling, then
// the sparse line product: 39 products in place of a dense 54).  A lane
// walks fp12prog's schedule (a doubling step a bit of |x|, an add step on
// a set bit), the same for every lane: no branch diverges.

#include "group.cuh"

using namespace drand;

// slots 0-5: px, py, qx (2), qy (2) in; slots 0-11: the Fp12 leaves out
constexpr int NIN = 6;

// group.cuh's layout of a launch of K2, K3, K4 or K6, for the records.
extern "C" int drand_group_layout(int nslots, int width, int32_t* out) {
  out[0] = group_lanes_per_block(nslots, width);
  out[1] = group_smem_bytes(out[0], nslots);
  return 0;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(GROUP_THREADS)
    k_miller(const uint32_t* in, uint32_t* out, const uint32_t* consts,
             const int32_t* prog, const int32_t* sched, int nsched,
             int64_t B) {
  extern __shared__ __align__(16) Fp smem[];
  const GroupProg g = group_prog(prog);
  int64_t idx;
  Fp* lane = group_enter<GROUP>(smem, consts, g.nslots, B, &idx);
  if (lane) group_lane(g, lane, smem, in, NIN, out, sched, nsched, B, idx);
}

extern "C" int drand_miller(const void* in, void* out, const void* consts,
                            const void* prog, int nslots, const void* sched,
                            int nsched, int64_t B, void* stream) {
  DRAND_GROUP_LAUNCH(k_miller, GROUP, B, nslots, stream, (const uint32_t*)in,
                     (uint32_t*)out, (const uint32_t*)consts,
                     (const int32_t*)prog, (const int32_t*)sched, nsched, B);
}
#else
extern "C" int drand_miller(const void* in, void* out, const void* consts,
                            const void* prog, int nslots, const void* sched,
                            int nsched, int64_t B, void* stream) {
  (void)nslots;
  (void)stream;
  return group_host_run(
      (const int32_t*)prog, (const uint32_t*)consts, B,
      [&](const GroupProg& g, Fp* lane, const Fp* cs, int64_t idx) {
        group_lane(g, lane, cs, (const uint32_t*)in, NIN, (uint32_t*)out,
                   (const int32_t*)sched, nsched, B, idx);
      });
}
#endif
