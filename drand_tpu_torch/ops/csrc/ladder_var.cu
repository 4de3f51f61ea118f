// K6: k_i*P_i with one scalar per lane, Jacobian double-and-add MSB-first
// from infinity, on G1 and on G2.
//
// Replaces drand_tpu/ops/pallas_field.py _ladder_var_call
// (_ladder_var_math), both instances: batched signing (256 bits, the
// secret's bits on every lane), the signed-digit GLV Lagrange ladders of
// batched tBLS recovery (130 bits on G1, 66 on G2) and the DKG Horner
// steps (16 bits).
//
// Bound on this card: the latency of each lane's chain of dependent
// Montgomery products at signing's 2048 lanes (16 blocks of one thread a
// lane filled 16 of 132 SMs), the instruction rate at recovery's 28,672
// (G1) and 57,344 (G2) lanes, where a group runs about twice the warp
// instructions a lane-step that one thread a lane did (idle threads in
// narrow phases, each phase's loads and sync), so those two launches run
// slower than that design's (PERF.md).  Design: a thread group per lane
// (group.cuh), 8 threads on G1 (no step phase holds more than 8 Fp
// products), 16 on G2 (up to 18: one phase takes two rounds; a warp a
// lane idled more threads and ran slower at both of G2's widths, PERF.md).
// The lane's P, accumulator and
// temporaries sit in shared-memory slots; each thread holds at most one Fp
// product in registers.  A step is one fragment of the program that
// drand_tpu_torch/ops/fp12prog.py writes ("ladder_g1" / "ladder_g2"): the
// double, the complete add of the doubled accumulator and P with its
// embedded doubling, the equality and infinity flags, and the selects that
// pick the step's result -- the plain version's field values and picks,
// so the Jacobian representative equals the JAX package's limb for limb.
//
// One operation sequence for every scalar: signing's scalar is a secret
// share, so nothing a lane does may depend on its bits.  Before each step
// the group writes the step's bit as a flag (every word all ones or all
// zeros) into a slot, and the step selects with it word by word; every
// lane runs the same phases, adds included, whatever its bits or its
// points (the TPU kernel, too, computes the add on every bit and selects).
// No branch here or in group.cuh reads a bit or a flag.

#include "group.cuh"

using namespace drand;

// threads a lane (fp12prog.WIDTH; the wrapper passes its width, checked)
constexpr int K6_G1_WIDTH = 8, K6_G2_WIDTH = 16;
// fp12prog.K6 slots for NC coordinates: the accumulator at 0 (the output),
// P at NC (the input), the step's bit flag at 2 NC; fragments init, step
constexpr int K6_INIT = 0, K6_STEP = 1;

template <int W, int NC>
DI void ladder_var_lane(const GroupProg& g, Fp* lane, const Fp* cs,
                        const uint32_t* in, uint32_t* out,
                        const int32_t* bits, int nbits, int64_t B,
                        int64_t idx) {
  const int64_t src = idx < B ? idx : B - 1;
  load_lane<W>(lane + NC, in, NC, B, idx);
  // i = -1: the init fragment; then per bit its flag and a step (one call
  // site, so the interpreter is inlined once)
  for (int i = -1; i < nbits; i++) {
    if (i >= 0) {
      const uint32_t m = 0u - (uint32_t)(bits[(int64_t)i * B + src] == 1);
      group_phase<W>([&](int t) {
        for (int w = t; w < 12; w += W) lane[2 * NC].v[w] = m;
      });
    }
    run_frag<W>(g, lane, cs, i < 0 ? K6_INIT : K6_STEP);
  }
  store_lane<W>(out, lane, NC, B, idx);
}

#ifdef __CUDACC__
template <int W, int NC>
DI void ladder_var_block(const uint32_t* in, uint32_t* out,
                         const uint32_t* consts, const int32_t* prog,
                         const int32_t* bits, int nbits, int64_t B) {
  extern __shared__ __align__(16) Fp smem[];
  const GroupProg g = group_prog(prog);
  int64_t idx;
  Fp* lane = group_enter<W>(smem, consts, g.nslots, B, &idx);
  if (lane)
    ladder_var_lane<W, NC>(g, lane, smem, in, out, bits, nbits, B, idx);
}

__global__ void __launch_bounds__(GROUP_THREADS)
    k_ladder_var_g1(const uint32_t* in, uint32_t* out, const uint32_t* consts,
                    const int32_t* prog, const int32_t* bits, int nbits,
                    int64_t B) {
  ladder_var_block<K6_G1_WIDTH, 3>(in, out, consts, prog, bits, nbits, B);
}

__global__ void __launch_bounds__(GROUP_THREADS)
    k_ladder_var_g2(const uint32_t* in, uint32_t* out, const uint32_t* consts,
                    const int32_t* prog, const int32_t* bits, int nbits,
                    int64_t B) {
  ladder_var_block<K6_G2_WIDTH, 6>(in, out, consts, prog, bits, nbits, B);
}

extern "C" int drand_ladder_var_g1(const void* in, void* out,
                                   const void* consts, const void* prog,
                                   int nslots, int width, const void* bits,
                                   int nbits, int64_t B, void* stream) {
  if (width != K6_G1_WIDTH) return 1;
  DRAND_GROUP_LAUNCH(k_ladder_var_g1, K6_G1_WIDTH, B, nslots, stream,
                     (const uint32_t*)in, (uint32_t*)out,
                     (const uint32_t*)consts, (const int32_t*)prog,
                     (const int32_t*)bits, nbits, B);
}

extern "C" int drand_ladder_var_g2(const void* in, void* out,
                                   const void* consts, const void* prog,
                                   int nslots, int width, const void* bits,
                                   int nbits, int64_t B, void* stream) {
  if (width != K6_G2_WIDTH) return 1;
  DRAND_GROUP_LAUNCH(k_ladder_var_g2, K6_G2_WIDTH, B, nslots, stream,
                     (const uint32_t*)in, (uint32_t*)out,
                     (const uint32_t*)consts, (const int32_t*)prog,
                     (const int32_t*)bits, nbits, B);
}
#else
template <int W, int NC>
static int ladder_var_host(const void* in, void* out, const void* consts,
                           const void* prog, int width, const void* bits,
                           int nbits, int64_t B) {
  if (width != W) return 1;
  return group_host_run(
      (const int32_t*)prog, (const uint32_t*)consts, B,
      [&](const GroupProg& g, Fp* lane, const Fp* cs, int64_t idx) {
        ladder_var_lane<W, NC>(g, lane, cs, (const uint32_t*)in,
                               (uint32_t*)out, (const int32_t*)bits, nbits,
                               B, idx);
      });
}

extern "C" int drand_ladder_var_g1(const void* in, void* out,
                                   const void* consts, const void* prog,
                                   int nslots, int width, const void* bits,
                                   int nbits, int64_t B, void* stream) {
  (void)nslots;
  (void)stream;
  return ladder_var_host<K6_G1_WIDTH, 3>(in, out, consts, prog, width, bits,
                                         nbits, B);
}

extern "C" int drand_ladder_var_g2(const void* in, void* out,
                                   const void* consts, const void* prog,
                                   int nslots, int width, const void* bits,
                                   int nbits, int64_t B, void* stream) {
  (void)nslots;
  (void)stream;
  return ladder_var_host<K6_G2_WIDTH, 6>(in, out, consts, prog, width, bits,
                                         nbits, B);
}
#endif
