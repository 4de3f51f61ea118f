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
// Bound on this card: integer multiply-adds (G1: 64 steps, G2: 32, over
// 16,384-57,344 lanes), where one thread a lane held the tables and the
// accumulator in 255 registers and spilled (G1) or kept them in local
// memory (G2), and so ran at a few resident warps an SM.  Design: a thread
// group per lane (group.cuh), as K6: the lane's table, accumulator, bit
// flags and temporaries in shared-memory slots, each thread at most one
// Fp product in registers.  A step is one fragment of fp12prog's "glv_g1"
// / "glv_g2" program: DevCurve.double, the entry picked by word-wise
// selects on the bit flags, and curve.add_mixed with its embedded
// doubling, flags and selects, the ladder's select by b0 | b1 folded into
// its chain.  Before each step the group writes the step's two bits as
// flags (every word all ones or all zeros) into slots; every lane runs the
// same phases, the add included, whatever its bits: no branch here or in
// group.cuh reads a bit, a flag or a point.
//
// Lanes in and out as the plain engine's limb tensors: the table's 6 (G1)
// or 12 (G2) coordinates P.x, P.y, endo.x, endo.y, P3.x, P3.y (Fp2 pairs
// on G2), the accumulator's 3 or 6; bits (2, nbits, B) int32, plane 0 =
// b0, plane 1 = b1, MSB first.

#include "group.cuh"

using namespace drand;

// threads a lane (fp12prog.WIDTH["glv_g1"] / ["glv_g2"]; the wrapper
// passes its width, checked here)
constexpr int K8_G1_WIDTH = 4, K8_G2_WIDTH = 8;
// fp12prog.GLV slots for N field components: the accumulator at 0 (3 N,
// the output), the table at 3 N (6 N, the input), the bit flags at 9 N and
// 9 N + 1; fragments init, step
constexpr int K8_INIT = 0, K8_STEP = 1;

template <int W, int N>
DI void glv_lane(const GroupProg& g, Fp* lane, const Fp* cs, const Limbs& tab,
                 const Limbs& out, const int32_t* bits, int nbits, int64_t B,
                 int64_t idx) {
  const int64_t src = idx < B ? idx : B - 1;
  load_lane_limbs<W>(lane + 3 * N, tab, 6 * N, B, idx);
  // i = -1: the init fragment; then per step its flags and the step (one
  // call site, so the interpreter is inlined once)
  for (int i = -1; i < nbits; i++) {
    if (i >= 0) {
      const uint32_t m0 = 0u - (uint32_t)(bits[(int64_t)i * B + src] == 1);
      const uint32_t m1 =
          0u - (uint32_t)(bits[((int64_t)nbits + i) * B + src] == 1);
      group_phase<W>([&](int t) {
        for (int w = t; w < 24; w += W)
          lane[9 * N + w / 12].v[w % 12] = w < 12 ? m0 : m1;
      });
    }
    run_frag<W>(g, lane, cs, i < 0 ? K8_INIT : K8_STEP);
  }
  store_lane_limbs<W>(out, lane, 3 * N, B, idx);
}

#ifdef __CUDACC__
template <int W, int N>
DI void glv_block(const Limbs& tab, const Limbs& out, const uint32_t* consts,
                  const int32_t* prog, const int32_t* bits, int nbits,
                  int64_t B) {
  extern __shared__ __align__(16) Fp smem[];
  const GroupProg g = group_prog(prog);
  int64_t idx;
  Fp* lane = group_enter<W>(smem, consts, g.nslots, B, &idx);
  if (lane) glv_lane<W, N>(g, lane, smem, tab, out, bits, nbits, B, idx);
}

#define K8_KERNEL(name, W, N)                                                \
  __global__ void __launch_bounds__(GROUP_THREADS)                          \
      name(Limbs tab, Limbs out, const uint32_t* consts,                     \
           const int32_t* prog, const int32_t* bits, int nbits, int64_t B) { \
    glv_block<W, N>(tab, out, consts, prog, bits, nbits, B);                 \
  }
K8_KERNEL(k_glv_g1, K8_G1_WIDTH, 1)
K8_KERNEL(k_glv_g2, K8_G2_WIDTH, 2)

#define K8_LAUNCH(kernel, W, N)                                              \
  DRAND_GROUP_LAUNCH(kernel, W, B, nslots, stream, limbs_of(tab, 6 * N),     \
                     limbs_of(out, 3 * N), (const uint32_t*)consts,          \
                     (const int32_t*)prog, (const int32_t*)bits, nbits, B)
#else
template <int W, int N>
static int glv_host(const void* const* tab, const void* const* out,
                    const void* consts, const void* prog, const void* bits,
                    int nbits, int64_t B) {
  const Limbs t = limbs_of(tab, 6 * N), o = limbs_of(out, 3 * N);
  return group_host_run(
      (const int32_t*)prog, (const uint32_t*)consts, B,
      [&](const GroupProg& g, Fp* lane, const Fp* cs, int64_t idx) {
        glv_lane<W, N>(g, lane, cs, t, o, (const int32_t*)bits, nbits, B,
                       idx);
      });
}
#define K8_LAUNCH(kernel, W, N)                                              \
  (void)nslots;                                                              \
  (void)stream;                                                              \
  return glv_host<W, N>(tab, out, consts, prog, bits, nbits, B)
#endif

#define K8_ENTRY(fn, kernel, W, N)                                           \
  extern "C" int fn(const void* const* tab, const void* const* out,         \
                    const void* consts, const void* prog, int nslots,        \
                    int width, const void* bits, int nbits, int64_t B,       \
                    void* stream) {                                          \
    if (width != W) return 1;                                                \
    K8_LAUNCH(kernel, W, N);                                                 \
  }
K8_ENTRY(drand_glv_g1, k_glv_g1, K8_G1_WIDTH, 1)
K8_ENTRY(drand_glv_g2, k_glv_g2, K8_G2_WIDTH, 2)
