// K1: Fp x^e for a fixed public exponent: a windowed chain, and for e = p - 2
// (the inverse) a constant-time inversion.
//
// Replaces drand_tpu/ops/pallas_field.py _pow_call (_pow_math): the sqrt
// scan of G1 decompression + SSWU (e = (p-3)/4) and the Fermat inversions
// under to_affine and batch_inverse (e = p-2).
//
// Bound on this card: one lane is one chain of dependent Montgomery
// products, and the launches (1 to 3N lanes) leave the card's issue slots
// mostly idle, so a launch takes about one lane's chain.  Design: one
// thread a lane (a chain has no independent products to spread over a
// group), the element and the accumulator in registers.
//
//   k_pow: a left-to-right sliding-window chain.  kernels.pow_schedule
//     derives it from e: a table of the odd powers x, x^3, ... that the
//     digits use (at most K1_TABLE, in local memory), then the digit
//     schedule: sched[0] the first digit's entry, then -1 for a squaring
//     and k >= 0 for a product by entry k.  Window 5: (p-3)/4 takes 457
//     products in place of square-and-multiply's 607, 376 of them
//     squarings, which field.cuh's fp_sqr does in 456 word products to a
//     product's 588.
//   k_inv: field.cuh's fp_inv, Bernstein-Yang safegcd with a fixed count
//     of 1110 divsteps: a run of word shifts, adds and masks, and one
//     Montgomery product, in place of the 610 products of the p-2 chain.
//     kernels.pow_fixed sends e = p - 2 here.
//
// Fixed work for every input: the schedule and the table size follow the
// public e alone, and every lane of a launch runs the same schedule, so
// its branches are uniform; the inversion has no branch on data.  The
// ragged edge is masked.
//
// Lanes in and out in the plain engine's layout, (B, 24) int64 16-bit
// limbs (drand_tpu_torch/ops/limbs.py), so the wrapper launches on the
// limb tensor itself: the word layout's conversions around a launch cost
// more than the inversion (PERF.md).  A lane's 192 bytes are read and
// written once.

#include "field.cuh"

using namespace drand;

constexpr int K1_TABLE = 16;       // odd powers up to x^31: window 5
constexpr int K1_THREADS = 128;    // threads a block
constexpr int K1_SQR = -1;         // a squaring in the digit schedule

template <int NTAB>
DI void pow_lane(const int64_t* x, int64_t* out, const int32_t* sched,
                 int nsched, int ntab, int64_t lane) {
  Fp tab[NTAB], acc;
  load_fp_limbs(tab[0], x, lane);
  if (ntab > 1) {
    Fp x2;
    fp_sqr(x2, tab[0]);
    for (int k = 1; k < ntab; k++) fp_mul(tab[k], tab[k - 1], x2);
  }
  acc = tab[sched[0]];
  for (int s = 1; s < nsched; s++) {
    const int op = sched[s];
    if (op == K1_SQR) fp_sqr(acc, acc);
    else fp_mul(acc, acc, tab[op]);
  }
  store_fp_limbs(out, acc, lane);
}

DI void inv_lane(const int64_t* x, int64_t* out, int64_t lane) {
  Fp a, r;
  load_fp_limbs(a, x, lane);
  fp_inv(r, a);
  store_fp_limbs(out, r, lane);
}

#ifdef __CUDACC__
#define K1_KERNEL(name, NTAB, THREADS)                                       \
  __global__ void __launch_bounds__(THREADS)                                \
      name(const int64_t* x, int64_t* out, const int32_t* sched,             \
           int nsched, int ntab, int64_t B) {                                \
    const int64_t lane = DRAND_LANE_INDEX();                                 \
    if (lane < B) pow_lane<NTAB>(x, out, sched, nsched, ntab, lane);         \
  }
K1_KERNEL(k_pow, K1_TABLE, K1_THREADS)

__global__ void __launch_bounds__(K1_THREADS) k_inv(const int64_t* x,
                                                    int64_t* out, int64_t B) {
  const int64_t lane = DRAND_LANE_INDEX();
  if (lane < B) inv_lane(x, out, lane);
}

extern "C" int drand_pow(const void* x, void* out, const void* sched,
                         int nsched, int ntab, int64_t B, void* stream) {
  if (ntab < 1 || ntab > K1_TABLE || nsched < 1) return 1;
  DRAND_LAUNCH(k_pow, B, K1_THREADS, stream, (const int64_t*)x,
               (int64_t*)out, (const int32_t*)sched, nsched, ntab, B);
}

extern "C" int drand_inv(const void* x, void* out, int64_t B, void* stream) {
  DRAND_LAUNCH(k_inv, B, K1_THREADS, stream, (const int64_t*)x,
               (int64_t*)out, B);
}
#else
extern "C" int drand_pow(const void* x, void* out, const void* sched,
                         int nsched, int ntab, int64_t B, void* stream) {
  (void)stream;
  if (ntab < 1 || ntab > K1_TABLE || nsched < 1) return 1;
  for (int64_t lane = 0; lane < B; lane++)
    pow_lane<K1_TABLE>((const int64_t*)x, (int64_t*)out,
                       (const int32_t*)sched, nsched, ntab, lane);
  return 0;
}

extern "C" int drand_inv(const void* x, void* out, int64_t B, void* stream) {
  (void)stream;
  for (int64_t lane = 0; lane < B; lane++)
    inv_lane((const int64_t*)x, (int64_t*)out, lane);
  return 0;
}
#endif
