// K5: Fp2 x^e for a fixed public exponent: a Frobenius-split windowed chain
// on a thread group a lane.
//
// Replaces drand_tpu/ops/pallas_field.py _pow2_call (_pow2_math): the
// E2 = (p^2 - 9)/16 scan that G2 signature decompression and both SSWU
// maps of hash-to-G2 share, at width 3N, 2N and the threshold paths'.
//
// Bound on this card: the latency of each lane's chain of dependent
// products where a launch leaves the card idle, the instruction rate where
// the lanes fill it.  Design: the chain is shortened, then spread over a
// group (group.cuh, as K2).  x^p = conj(x) in Fp2, so with e = a p + b,
// x^e = conj(x)^a x^b: fp12prog.pow2_schedule walks the window digits of
// a and b at once over one table of odd powers x, x^3, ..., x^15, a digit
// of a multiplying by a table entry's conjugate (its sign folded into the
// product fragment).  For E2 that is 380 Fp2 squarings and 157 products
// where square-and-multiply ran 758 and 366.  The fragments ("pow2":
// INIT, the table and acc = 1; SQR, 2 Fp products; MUL[k] and MULC[k], 4)
// are each one phase of independent products and one linear phase, and
// the lane walks the schedule that e's digits give, passed with the
// launch: every branch is on the program or the schedule, the same for
// every lane, none on a lane's data.  2 threads a lane: an SQR's two
// products take one round, a MUL's four two; 1 and 4 threads were slower
// at every main-path shape (PERF.md).  The wrapper passes the width,
// checked here.

#include "group.cuh"

using namespace drand;

// threads a lane (fp12prog.WIDTH["pow2"])
constexpr int K5_WIDTH = 2;

// fp12prog's "pow2" slots: the accumulator at 0-1 (the output), x at 2-3
// (the input): group.cuh's sched_lane<W, 2>.

#ifdef __CUDACC__
template <int W>
DI void pow2_block(const uint32_t* in, uint32_t* out, const uint32_t* consts,
                   const int32_t* prog, const int32_t* sched, int nsched,
                   int64_t B) {
  extern __shared__ __align__(16) Fp smem[];
  const GroupProg g = group_prog(prog);
  int64_t idx;
  Fp* lane = group_enter<W>(smem, consts, g.nslots, B, &idx);
  if (lane) sched_lane<W, 2>(g, lane, smem, in, out, sched, nsched, B, idx);
}

#define K5_KERNEL(name, W)                                                   \
  __global__ void __launch_bounds__(GROUP_THREADS)                          \
      name(const uint32_t* in, uint32_t* out, const uint32_t* consts,       \
           const int32_t* prog, const int32_t* sched, int nsched,            \
           int64_t B) {                                                      \
    pow2_block<W>(in, out, consts, prog, sched, nsched, B);                  \
  }
K5_KERNEL(k_pow2, K5_WIDTH)

#define K5_ARGS                                                              \
  (const uint32_t*)in, (uint32_t*)out, (const uint32_t*)consts,             \
      (const int32_t*)prog, (const int32_t*)sched, nsched, B

extern "C" int drand_pow2(const void* in, void* out, const void* consts,
                          const void* prog, int nslots, int width,
                          const void* sched, int nsched, int64_t B,
                          void* stream) {
  if (width == K5_WIDTH)
    DRAND_GROUP_LAUNCH(k_pow2, K5_WIDTH, B, nslots, stream, K5_ARGS);
  return 1;
}
#else
template <int W>
static int pow2_host(const void* in, void* out, const void* consts,
                     const void* prog, const void* sched, int nsched,
                     int64_t B) {
  return group_host_run(
      (const int32_t*)prog, (const uint32_t*)consts, B,
      [&](const GroupProg& g, Fp* lane, const Fp* cs, int64_t idx) {
        sched_lane<W, 2>(g, lane, cs, (const uint32_t*)in, (uint32_t*)out,
                         (const int32_t*)sched, nsched, B, idx);
      });
}

extern "C" int drand_pow2(const void* in, void* out, const void* consts,
                          const void* prog, int nslots, int width,
                          const void* sched, int nsched, int64_t B,
                          void* stream) {
  (void)nslots;
  (void)stream;
  if (width == K5_WIDTH)
    return pow2_host<K5_WIDTH>(in, out, consts, prog, sched, nsched, B);
  return 1;
}
#endif
