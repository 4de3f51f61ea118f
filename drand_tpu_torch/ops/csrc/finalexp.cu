// K4: the final exponentiation f^((p^12 - 1)/r), times 3 in the hard part.
//
// Replaces drand_tpu/ops/pallas_field.py _finalexp_call (_finalexp_math)
// and follows its chain: the easy part f = conj(f) / f, f = frob2(f) f;
// then the five pow_x chains, Frobenius maps and conjugations in the same
// order.  Field values are unique, so the formulas are free: the Fp12
// inverse goes down the tower to one Fp inverse (binary extended gcd on
// one thread, group.cuh fp_inv, in place of the p-2 chain), and pow_x
// squares by Granger-Scott (18 products in place of 36), valid because the
// easy part has mapped every nonzero input into the cyclotomic subgroup
// (and zero stays zero).
//
// Bound on this card: the latency of one lane's chain of dependent
// products at the one-lane launch of every RLC pass, integer multiply-adds
// at the exact passes' 8192-14,336 lanes.  Design: a warp per lane
// (group.cuh), the Fp12 values (f, the chain's base and accumulator, e1,
// e2, the inverse's pieces) and temporaries in shared memory; each step is
// a program of fp12prog.py ("finalexp"): a cyclotomic squaring is one
// product phase of 18, a dense product one of 54.  A lane walks
// fp12prog's schedule (the five pow_x loops over the bits of |x|), the same
// for every lane.

#include "group.cuh"

using namespace drand;

// slots 0-11: the Fp12 leaves in; slots 0-11: the Fp12 leaves out
constexpr int NIN = 12;

#ifdef __CUDACC__
__global__ void __launch_bounds__(GROUP_THREADS)
    k_finalexp(const uint32_t* in, uint32_t* out, const uint32_t* consts,
             const int32_t* prog, const int32_t* sched, int nsched,
             int64_t B) {
  extern __shared__ __align__(16) Fp smem[];
  const GroupProg g = group_prog(prog);
  int64_t idx;
  Fp* lane = group_enter<GROUP>(smem, consts, g.nslots, B, &idx);
  if (lane) group_lane(g, lane, smem, in, NIN, out, sched, nsched, B, idx);
}

extern "C" int drand_finalexp(const void* in, void* out, const void* consts,
                            const void* prog, int nslots, const void* sched,
                            int nsched, int64_t B, void* stream) {
  DRAND_GROUP_LAUNCH(k_finalexp, GROUP, B, nslots, stream, (const uint32_t*)in,
                     (uint32_t*)out, (const uint32_t*)consts,
                     (const int32_t*)prog, (const int32_t*)sched, nsched, B);
}
#else
extern "C" int drand_finalexp(const void* in, void* out, const void* consts,
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
