// K2: k*P for a fixed public scalar k, Jacobian double-and-add MSB-first
// from infinity, on G1 and on G2.
//
// Replaces drand_tpu/ops/pallas_field.py _ladder_fixed_call
// (_ladder_fixed_math), both instances: on G1 the two |x| ladders of the
// subgroup check and the (1 - x) cofactor clearing; on G2 the |x| ladder of
// the subgroup check and the two of Budroni-Pintore cofactor clearing.
//
// Bound on this card: the latency of each lane's chain of dependent
// Montgomery products and linear steps at the 2048-lane launches (signing
// and partials), the instruction rate at the 8192- and 14,336-lane
// launches of the verify passes, where the lanes fill the card.  Design: a
// thread group per lane (group.cuh), as K6: the lane's P, accumulator and
// temporaries in shared-memory slots, each thread at most one Fp product
// in registers.  The lane walks a schedule that fp12prog.py writes from
// the bits of k ("fixed_g1" / "fixed_g2"): the init fragment (acc =
// infinity, P's Z^2, Z^3 and the flag Z != 0), then per bit a double, and
// on a one bit the complete add of acc and P with its embedded doubling,
// flags and selects -- curve.DevCurve's field values and picks, so the
// Jacobian representative equals the JAX package's limb for limb.  A zero
// bit runs no add, as the TPU kernel's ladder does.  8 threads a lane
// (a double's product phases hold 3 products on G1, 7 on G2); G1 also
// compiles 2 threads a lane, which idles fewer threads where the lanes
// fill the card.  The wrapper picks the width by the lane count
// (kernels.fixed_width) and passes it, checked here.
//
// Public scalars only: the schedule follows k's bits, so the run time
// tells them.  Every library path passes a public constant (|x|, 1 - x);
// a secret scalar (a key share) belongs to K6, which runs one operation
// sequence for every scalar.
//
// No branch reads a lane's data: every branch is on the program or the
// schedule, the same for every lane of the launch.  group.cuh's sched_lane
// (not group_lane) keeps K4's inverse out of this kernel.

#include "group.cuh"

using namespace drand;

// threads a lane (fp12prog.WIDTH, and FILL_WIDTH on G1)
constexpr int K2_G1_FILL = 2, K2_G1_WIDTH = 8, K2_G2_WIDTH = 8;

// fp12prog.K2 slots for NC coordinates: the accumulator at 0 (the output),
// P at NC (the input): group.cuh's sched_lane<W, NC>.

#ifdef __CUDACC__
template <int W, int NC>
DI void ladder_block(const uint32_t* in, uint32_t* out,
                     const uint32_t* consts, const int32_t* prog,
                     const int32_t* sched, int nsched, int64_t B) {
  extern __shared__ __align__(16) Fp smem[];
  const GroupProg g = group_prog(prog);
  int64_t idx;
  Fp* lane = group_enter<W>(smem, consts, g.nslots, B, &idx);
  if (lane) sched_lane<W, NC>(g, lane, smem, in, out, sched, nsched, B, idx);
}

#define K2_KERNEL(name, W, NC)                                               \
  __global__ void __launch_bounds__(GROUP_THREADS)                          \
      name(const uint32_t* in, uint32_t* out, const uint32_t* consts,       \
           const int32_t* prog, const int32_t* sched, int nsched,            \
           int64_t B) {                                                      \
    ladder_block<W, NC>(in, out, consts, prog, sched, nsched, B);            \
  }
K2_KERNEL(k_ladder_g1_fill, K2_G1_FILL, 3)
K2_KERNEL(k_ladder_g1, K2_G1_WIDTH, 3)
K2_KERNEL(k_ladder_g2, K2_G2_WIDTH, 6)

#define K2_ARGS                                                              \
  (const uint32_t*)in, (uint32_t*)out, (const uint32_t*)consts,             \
      (const int32_t*)prog, (const int32_t*)sched, nsched, B

extern "C" int drand_ladder_g1(const void* in, void* out, const void* consts,
                               const void* prog, int nslots, int width,
                               const void* sched, int nsched, int64_t B,
                               void* stream) {
  if (width == K2_G1_FILL)
    DRAND_GROUP_LAUNCH(k_ladder_g1_fill, K2_G1_FILL, B, nslots, stream,
                       K2_ARGS);
  if (width == K2_G1_WIDTH)
    DRAND_GROUP_LAUNCH(k_ladder_g1, K2_G1_WIDTH, B, nslots, stream, K2_ARGS);
  return 1;
}

extern "C" int drand_ladder_g2(const void* in, void* out, const void* consts,
                               const void* prog, int nslots, int width,
                               const void* sched, int nsched, int64_t B,
                               void* stream) {
  if (width == K2_G2_WIDTH)
    DRAND_GROUP_LAUNCH(k_ladder_g2, K2_G2_WIDTH, B, nslots, stream, K2_ARGS);
  return 1;
}
#else
template <int W, int NC>
static int ladder_host(const void* in, void* out, const void* consts,
                       const void* prog, const void* sched, int nsched,
                       int64_t B) {
  return group_host_run(
      (const int32_t*)prog, (const uint32_t*)consts, B,
      [&](const GroupProg& g, Fp* lane, const Fp* cs, int64_t idx) {
        sched_lane<W, NC>(g, lane, cs, (const uint32_t*)in, (uint32_t*)out,
                           (const int32_t*)sched, nsched, B, idx);
      });
}

extern "C" int drand_ladder_g1(const void* in, void* out, const void* consts,
                               const void* prog, int nslots, int width,
                               const void* sched, int nsched, int64_t B,
                               void* stream) {
  (void)nslots;
  (void)stream;
  if (width == K2_G1_FILL)
    return ladder_host<K2_G1_FILL, 3>(in, out, consts, prog, sched, nsched,
                                      B);
  if (width == K2_G1_WIDTH)
    return ladder_host<K2_G1_WIDTH, 3>(in, out, consts, prog, sched, nsched,
                                       B);
  return 1;
}

extern "C" int drand_ladder_g2(const void* in, void* out, const void* consts,
                               const void* prog, int nslots, int width,
                               const void* sched, int nsched, int64_t B,
                               void* stream) {
  (void)nslots;
  (void)stream;
  if (width == K2_G2_WIDTH)
    return ladder_host<K2_G2_WIDTH, 6>(in, out, consts, prog, sched, nsched,
                                       B);
  return 1;
}
#endif
