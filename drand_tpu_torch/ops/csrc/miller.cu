// K3: the optimal-ate Miller loop over the 63 bits of |x| after the leading
// one, projective G2 steps with line evaluation into Fp12, conjugated at the
// end (x < 0).
//
// Replaces drand_tpu/ops/pallas_field.py _miller_call (_miller_math,
// _pf_dbl_step, _pf_add_step, _pf_apply_line).  The steps follow the JAX
// package product for product: the line coefficients fix f up to a factor
// the final exponentiation kills, and the port must match f exactly.
//
// Bound on this card: integer multiply-adds (about 63 Fp12 squarings, 69
// line multiplications and the G2 steps: ~10^4 Montgomery products a lane).
// Design: one thread per lane; f (144 words) and R do not fit the 255
// registers a thread may hold, so they live in local memory (L1-cached) and
// the Fp2/Fp6/Fp12 functions are out of line to keep the build short.  The
// loop bits are uniform across the warp, so the add step is a uniform
// branch.  Field constants (b2, 1/2) come from the constant bundle.

#include "field.cuh"

using namespace drand;

struct G2P { Fp2 X, Y, Z; };

// doubling step: R <- 2R, ell = line coefficients (ell0, ell_px, ell_py)
DNI void dbl_step(G2P& R, Fp2 ell[3], const uint32_t* consts) {
  Fp2 b2, t0, t1, u, v, m, s, t2, t3, t4, hh, g, q0, q1, q2, q3;
  Fp half;
  fp2_load_const(b2, consts, C_B2_0, C_B2_1);
  fp_load_const(half, consts + 12 * C_HALF);
  fp2_sqr(t0, R.Y);
  fp2_sqr(t1, R.Z);
  fp2_add(s, R.Y, R.Z);
  fp2_sqr(u, s);
  fp2_sqr(v, R.X);
  fp2_mul(m, R.X, R.Y);
  fp2_mul(t2, t1, b2);
  fp2_triple(t2, t2);
  fp2_triple(t3, t2);
  fp2_sub(t4, u, t1);
  fp2_sub(t4, t4, t0);
  fp2_sub(ell[0], t2, t0);
  fp2_triple(ell[1], v);
  fp2_neg(ell[2], t4);
  fp2_add(s, t0, t3);
  fp2_mul_fp(hh, s, half);
  fp2_sub(s, t0, t3);
  fp2_mul_fp(g, s, half);
  fp2_sqr(q0, hh);
  fp2_sqr(q1, t2);
  fp2_mul(q2, g, m);
  fp2_mul(q3, t0, t4);
  fp2_triple(q1, q1);
  R.X = q2;
  fp2_sub(R.Y, q0, q1);
  R.Z = q3;
}

// mixed addition step with affine Q: R <- R + Q, ell = line coefficients
DNI void add_step(G2P& R, Fp2 ell[3], const Fp2& Qx, const Fp2& Qy) {
  Fp2 a, b, t0, t1, s0, s1, t2, t3, t4, t0sqRz, t5, u0, u1, u2, u3, tmp;
  fp2_mul(a, Qy, R.Z);
  fp2_mul(b, Qx, R.Z);
  fp2_sub(t0, R.Y, a);
  fp2_sub(t1, R.X, b);
  fp2_mul(s0, t0, Qx);
  fp2_mul(s1, t1, Qy);
  fp2_sqr(t2, t1);
  fp2_sqr(tmp, t0);
  fp2_sub(ell[0], s0, s1);
  fp2_neg(ell[1], t0);
  ell[2] = t1;
  fp2_mul(t3, t2, t1);
  fp2_mul(t4, t2, R.X);
  fp2_mul(t0sqRz, tmp, R.Z);
  fp2_add(t5, t4, t4);
  fp2_sub(t5, t3, t5);
  fp2_add(t5, t5, t0sqRz);
  fp2_mul(u0, t1, t5);
  fp2_sub(tmp, t4, t5);
  fp2_mul(u1, tmp, t0);
  fp2_mul(u2, t3, R.Y);
  fp2_mul(u3, R.Z, t3);
  R.X = u0;
  fp2_sub(R.Y, u1, u2);
  R.Z = u3;
}

// f <- f * (ell0 + ell1 px v + ell2 py v w): the line as a sparse Fp12
DNI void apply_line(Fp12& f, const Fp2 ell[3], const Fp& px, const Fp& py) {
  Fp12 sp;
  fp12_one(sp);
  sp.c0.c0 = ell[0];
  fp2_mul_fp(sp.c0.c1, ell[1], px);
  fp2_zero(sp.c0.c2);
  fp2_zero(sp.c1.c0);
  fp2_mul_fp(sp.c1.c1, ell[2], py);
  fp2_zero(sp.c1.c2);
  fp12_mul(f, f, sp);
}

DI void miller_lane(const uint32_t* in, uint32_t* out, const uint32_t* consts,
                    const int32_t* xbits, int nxbits, int64_t B, int64_t lane) {
  Fp px, py;
  Fp2 qx, qy, ell[3];
  load_fp(px, in, 0, B, lane);
  load_fp(py, in, 1, B, lane);
  load_fp(qx.c0, in, 2, B, lane);
  load_fp(qx.c1, in, 3, B, lane);
  load_fp(qy.c0, in, 4, B, lane);
  load_fp(qy.c1, in, 5, B, lane);
  Fp12 f;
  fp12_one(f);
  G2P R;
  R.X = qx;
  R.Y = qy;
  fp2_one(R.Z);
  for (int i = 0; i < nxbits; i++) {
    fp12_sqr(f, f);
    dbl_step(R, ell, consts);
    apply_line(f, ell, px, py);
    if (xbits[i]) {
      add_step(R, ell, qx, qy);
      apply_line(f, ell, px, py);
    }
  }
  fp12_conj(f, f);
  store_fp12(out, f, B, lane);
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(64) k_miller(const uint32_t* in, uint32_t* out,
                                               const uint32_t* consts,
                                               const int32_t* xbits, int nxbits,
                                               int64_t B) {
  const int64_t lane = DRAND_LANE_INDEX();
  if (lane < B) miller_lane(in, out, consts, xbits, nxbits, B, lane);
}

extern "C" int drand_miller(const void* in, void* out, const void* consts,
                            const void* xbits, int nxbits, int64_t B,
                            void* stream) {
  DRAND_LAUNCH(k_miller, B, 64, stream, (const uint32_t*)in, (uint32_t*)out,
               (const uint32_t*)consts, (const int32_t*)xbits, nxbits, B);
}
#else
extern "C" int drand_miller(const void* in, void* out, const void* consts,
                            const void* xbits, int nxbits, int64_t B,
                            void* stream) {
  (void)stream;
  for (int64_t lane = 0; lane < B; lane++)
    miller_lane((const uint32_t*)in, (uint32_t*)out, (const uint32_t*)consts,
                (const int32_t*)xbits, nxbits, B, lane);
  return 0;
}
#endif
