"""RFC 9380 hash-to-G1/G2 and signature decompression on tensors.

Counterpart of drand_tpu/ops/h2c.py.  The host hashes (expand_message_xmd,
hash_to_field: crypto/host/h2c.py); everything algebraic runs batched on
tensors:

* simplified SWU, straight-line and projective (x = xn/xd), so the maps
  contain no inversion: over Fp ONE (p-3)/4 power (q = 3 mod 4) yields
  both the square test and the root; over Fp2 ONE E2 = (p^2-9)/16 power
  (q = 9 mod 16) yields the candidate roots of U/V;
* the 11-isogeny (G1) and 3-isogeny (G2) on homogenized polynomials,
  Jacobian output;
* signature decompression rides the same exponent, so
  ``g1_decompress_and_hash`` runs ONE K1 launch and
  ``g2_decompress_and_hash`` ONE K5 launch, at width 3N for the N
  signatures and the 2N hash inputs.
"""

import torch

from . import limbs as L
from . import tower as T
from .curve import (G1, G2, g1_clear_cofactor, g2_clear_cofactor,
                    _cat_lanes, _tmap)
from ..crypto.host import field as HF
from ..crypto.host import _iso_g2 as ISO2
from ..crypto.host.params import (P, ISO_A1, ISO_B1, ISO_A2, ISO_B2, Z1, Z2,
                                  B1, B2)
from ..crypto.host._iso_g1 import XNUM, XDEN, YNUM, YDEN

_C1_EXP = (P - 3) // 4
_C2 = pow((-(Z1 ** 3)) % P, (P + 1) // 4, P)
assert _C2 * _C2 % P == (-(Z1 ** 3)) % P, "c2 = sqrt(-Z^3) must exist"


def _mc(x, like):
    """Montgomery constant broadcast to `like`'s shape."""
    return L.mont_const(x, like.device).expand(like.shape)


def fp_sgn0(a):
    """Parity of the canonical representative (Montgomery in)."""
    return L.from_mont(a)[..., 0] & 1


def _fp_ge_half1(y_mont):
    """canonical(y) > (p-1)/2  ==  canonical(y) >= (p+1)/2."""
    y_can = L.from_mont(y_mont)
    return L.ge(y_can, L.const((P + 1) // 2, str(y_can.device)))


def _sswu_g1_pre(u):
    """Front half: everything up to the sqrt_ratio pow input tv4 = gx1*gxd^3."""
    tv1 = L.mont_sqr(u)                                # u^2
    tv3 = L.mont_mul(_mc(Z1, u), tv1)                  # Z*u^2
    xd = L.add_mod(L.mont_sqr(tv3), tv3)               # Z^2u^4 + Zu^2
    x1n = L.mont_mul(L.add_mod(xd, _mc(1, u)), _mc(ISO_B1, u))
    xd = L.mont_mul(_mc(P - ISO_A1, u), xd)            # -A*(Z^2u^4+Zu^2)
    xd = L.select(L.is_zero(xd), _mc(Z1 * ISO_A1 % P, u), xd)
    xd2 = L.mont_sqr(xd)
    gxd, axd2, gx1a = L.mul_many(
        [(xd2, xd), (_mc(ISO_A1, u), xd2), (x1n, x1n)])  # xd^3, A*xd^2, x1n^2
    gx1 = L.mont_mul(L.add_mod(gx1a, axd2), x1n)       # x1n^3 + A*x1n*xd^2
    gx1 = L.add_mod(gx1, L.mont_mul(_mc(ISO_B1, u), gxd))  # ... + B*xd^3
    tv4a, tv2e = L.mul_many([(gxd, gxd), (gx1, gxd)])  # gxd^2, gx1*gxd
    tv4 = L.mont_mul(tv4a, tv2e)                       # gx1*gxd^3
    return tv4, (u, tv1, tv3, x1n, xd, gxd, gx1, tv2e)


def _sswu_g1_post(e, ctx):
    """Back half: e = tv4^((p-3)/4) -> projective (xn, xd, y_affine)."""
    u, tv1, tv3, x1n, xd, gxd, gx1, tv2e = ctx
    y1, x2n, tv1u = L.mul_many([(e, tv2e), (tv3, x1n), (tv1, u)])
    y2, ysq = L.mul_many([(L.mont_mul(y1, _mc(_C2, u)), tv1u), (y1, y1)])
    e2 = L.eq(L.mont_mul(ysq, gxd), gx1)               # gx1/gxd was square?
    xn = L.select(e2, x1n, x2n)
    y = L.select(e2, y1, y2)
    flip = fp_sgn0(u) != fp_sgn0(y)
    y = L.select(flip, L.neg_mod(y), y)
    return xn, xd, y


def _iso_g1_proj(xn, xd, y):
    """11-isogeny on projective x = xn/xd, affine y: homogenized Horner,
    Jacobian output, zero inversions."""
    polys = [list(XNUM), list(XDEN), list(YNUM), list(YDEN)]
    maxd = max(len(p) for p in polys) - 1
    xdp = [None, xd]
    for i in range(2, maxd + 1):
        xdp.append(L.mont_mul(xdp[i // 2], xdp[i - i // 2]) if i > 2
                   else L.mont_sqr(xd))
    degs = [len(p) - 1 for p in polys]
    accs = [_mc(p[-1], xn) for p in polys]
    for r in range(max(degs)):
        pairs, meta = [], []
        for j, p in enumerate(polys):
            i = degs[j] - 1 - r                        # next coeff index
            if i < 0:
                continue
            pairs.append((accs[j], xn))
            pairs.append((_mc(p[i], xn), xdp[degs[j] - i]))
            meta.append(j)
        prods = L.mul_many(pairs)
        for k, j in enumerate(meta):
            accs[j] = L.add_mod(prods[2 * k], prods[2 * k + 1])
    xn_h, xd_h, yn_h, yd_h = accs
    d1, yd2 = L.mul_many([(xd, xd_h), (yd_h, yd_h)])   # full x-denominator
    z, d12, yyn = L.mul_many([(d1, yd_h), (d1, d1), (y, yn_h)])
    X, d13 = L.mul_many([(xn_h, L.mont_mul(d1, yd2)), (d12, d1)])
    Y = L.mont_mul(yyn, L.mont_mul(d13, yd2))
    return (X, Y, z)


def _g1_y2(x_can):
    """Decompression front half: wire x -> (x_mont, y^2 = x^3 + 4)."""
    xm = L.to_mont(x_can)
    return xm, L.add_mod(L.mont_mul(L.mont_sqr(xm), xm), _mc(B1, xm))


def _g1_recover_post(xm, y2, e, sign_bit):
    """Back half: e = y2^((p-3)/4) -> (Jacobian point, ok).

    y = e*y2 = y2^((p+1)/4), the root when y2 is a residue; y's parity
    follows the ZCash larger-half convention."""
    y = L.mont_mul(e, y2)
    ok = L.eq(L.mont_sqr(y), y2)
    flip = _fp_ge_half1(y) ^ (sign_bit == 1)
    y = L.select(flip, L.neg_mod(y), y)
    return (xm, y, L.ones_like(xm)), ok


def g1_recover_y(x_can, sign_bit):
    """x (canonical limbs), sign flag -> (Jacobian point, ok); ok is False
    where x^3 + 4 is not a square (not on the curve).  One K1 launch."""
    xm, y2 = _g1_y2(x_can)
    return _g1_recover_post(xm, y2, L.pow_fixed(y2, _C1_EXP), sign_bit)


def map_to_g1_jac(u):
    """SSWU + 11-isogeny: field element batch -> Jacobian points on E1."""
    tv4, ctx = _sswu_g1_pre(u)
    return _iso_g1_proj(*_sswu_g1_post(L.pow_fixed(tv4, _C1_EXP), ctx))


def hash_to_g1_jac(u0, u1):
    """Two field-element batches -> G1 Jacobian points (in the subgroup)."""
    q = map_to_g1_jac(torch.cat([u0, u1], 0))
    n = u0.shape[0]
    r = G1.add(tuple(t[:n] for t in q), tuple(t[n:] for t in q))
    return g1_clear_cofactor(r)


def g1_decompress_and_hash(sig_x_can, sign_bit, u0, u1):
    """Fused G1 front end: signature decompression + hash_to_curve(u0, u1)
    with ONE (p-3)/4 power across all three chains (width 3N).

    Returns (sig_jac, parse_ok, hm_jac) for the verification equation
    e(S, -g2) * e(H(m), pk) == 1."""
    u = torch.cat([u0, u1], 0)
    tv4, ctx = _sswu_g1_pre(u)
    xm, y2 = _g1_y2(sig_x_can)
    e = L.pow_fixed(torch.cat([tv4, y2], 0), _C1_EXP)
    n2 = u.shape[0]
    q = _iso_g1_proj(*_sswu_g1_post(e[:n2], ctx))
    sig_jac, ok = _g1_recover_post(xm, y2, e[n2:], sign_bit)
    n = u0.shape[0]
    hm = g1_clear_cofactor(G1.add(tuple(t[:n] for t in q),
                                  tuple(t[n:] for t in q)))
    return sig_jac, ok, hm


# ---------------------------------------------------------------------------
# G2: simplified SWU over Fp2 for q = 9 mod 16 (RFC 9380 F.2.1.3), the
# 3-isogeny and decompression, all on the one E2 = (p^2-9)/16 exponent
# ---------------------------------------------------------------------------

_E2_EXP = (P * P - 9) // 16
assert (P * P) % 16 == 9

# sqrt candidates of U/V are gamma*{1, s1, s2, s3}; for a non-square the
# root of Z^3*U/V is gamma*eta_j (host golden field code)
_S1 = (0, 1)                                   # sqrt(-1) = u
_S2 = HF.fp2_sqrt(_S1)
_S3 = HF.fp2_sqrt(HF.fp2_neg(_S1))
assert _S2 is not None and _S3 is not None
_Z2_CUBE = HF.fp2_mul(HF.fp2_sqr(Z2), Z2)
_ROOTS8 = [_S2, HF.fp2_mul(_S1, _S2), HF.fp2_neg(_S2),
           HF.fp2_neg(HF.fp2_mul(_S1, _S2))]   # primitive 8th roots of 1
_ETAS = [HF.fp2_sqrt(HF.fp2_mul(_Z2_CUBE, HF.fp2_inv(z))) for z in _ROOTS8]
assert all(e is not None for e in _ETAS)
_SQR_MULTS = [(1, 0), _S1, _S2, _S3]


def _mc2(c, like):
    """Fp2 Montgomery constant broadcast to `like`'s (an Fp2) shape."""
    return (_mc(c[0], like[0]), _mc(c[1], like[0]))


def fp2_sgn0(a):
    """RFC 9380 sgn0 for m = 2 (Montgomery in)."""
    c0, c1 = L.from_mont(a[0]), L.from_mont(a[1])
    z0 = torch.all(c0 == 0, dim=-1).to(c0.dtype)
    return (c0[..., 0] & 1) | (z0 & (c1[..., 0] & 1))


def _sswu_g2_pre(u):
    """Front half: everything up to the sqrt_ratio power input w = U*V^7,
    U/V = g(x1) with x1 = x1n/xd projective."""
    A, B, Z = _mc2(ISO_A2, u), _mc2(ISO_B2, u), _mc2(Z2, u)
    tv1 = T.fp2_sqr(u)                                # u^2
    tv3 = T.fp2_mul(Z, tv1)                           # Z*u^2
    xd = T.fp2_add(T.fp2_sqr(tv3), tv3)               # Z^2u^4 + Zu^2
    x1n = T.fp2_mul(T.fp2_add(xd, T.fp2_ones_like(u[0])), B)
    xd = T.fp2_mul(_mc2(HF.fp2_neg(ISO_A2), u), xd)   # -A*(Z^2u^4+Zu^2)
    xd = T.fp2_select(T.fp2_is_zero(xd), _mc2(HF.fp2_mul(Z2, ISO_A2), u), xd)
    xd2 = T.fp2_sqr(xd)
    xd3 = T.fp2_mul(xd2, xd)
    gx1 = T.fp2_mul(T.fp2_add(T.fp2_sqr(x1n), T.fp2_mul(A, xd2)), x1n)
    U = T.fp2_add(gx1, T.fp2_mul(B, xd3))             # x1n^3+A x1n xd^2+B xd^3
    V = xd3
    V2 = T.fp2_sqr(V)
    UV3 = T.fp2_mul(U, T.fp2_mul(V2, V))              # U*V^3 (gamma factor)
    w = T.fp2_mul(UV3, T.fp2_sqr(V2))                 # U*V^7
    return w, (u, tv1, tv3, x1n, xd, U, V, UV3)


def _sswu_g2_post(e, ctx):
    """Back half: e = w^E2 -> projective (xn, xd, y_affine)."""
    u, tv1, tv3, x1n, xd, U, V, UV3 = ctx
    gamma = T.fp2_mul(e, UV3)                         # candidate sqrt(U/V)
    y_qr, is_qr = None, None
    for m in _SQR_MULTS:
        c = gamma if m == (1, 0) else T.fp2_mul(gamma, _mc2(m, u))
        hit = T.fp2_eq(T.fp2_mul(T.fp2_sqr(c), V), U)
        y_qr = c if y_qr is None else T.fp2_select(hit, c, y_qr)
        is_qr = hit if is_qr is None else (is_qr | hit)
    # non-square: sqrt(Z^3*U/V) = gamma*eta_j; then y = u^3 * that
    z3u = T.fp2_mul(_mc2(_Z2_CUBE, u), U)
    y_im = None
    for eta in _ETAS:
        c = T.fp2_mul(gamma, _mc2(eta, u))
        hit = T.fp2_eq(T.fp2_mul(T.fp2_sqr(c), V), z3u)
        y_im = c if y_im is None else T.fp2_select(hit, c, y_im)
    u3 = T.fp2_mul(T.fp2_mul(tv1, u), y_im)
    xn = T.fp2_select(is_qr, x1n, T.fp2_mul(tv3, x1n))
    y = T.fp2_select(is_qr, y_qr, u3)
    flip = fp2_sgn0(u) != fp2_sgn0(y)
    return xn, xd, T.fp2_select(flip, T.fp2_neg(y), y)


def _iso_g2_proj(xn, xd, y):
    """3-isogeny E2' -> E2 on projective x = xn/xd, affine y: homogenized
    Horner, Jacobian output, zero inversions (degrees: x numerator 3,
    denominator 2, y numerator 3, denominator 3)."""
    xd2 = T.fp2_sqr(xd)
    xdp = [None, xd, xd2, T.fp2_mul(xd2, xd)]

    def homog(coeffs):                  # sum k_i * xn^i * xd^(deg-i)
        deg = len(coeffs) - 1
        acc = _mc2(coeffs[deg], xn)
        for i in range(deg - 1, -1, -1):
            acc = T.fp2_add(T.fp2_mul(acc, xn),
                            T.fp2_mul(_mc2(coeffs[i], xn), xdp[deg - i]))
        return acc

    xn_h = homog(ISO2.XNUM)
    xd_h = T.fp2_mul(homog(ISO2.XDEN), xd)            # lifted to degree 3
    yn_h = homog(ISO2.YNUM)
    yd_h = homog(ISO2.YDEN)
    z = T.fp2_mul(xd_h, yd_h)
    yd2 = T.fp2_sqr(yd_h)
    X = T.fp2_mul(T.fp2_mul(xn_h, xd_h), yd2)          # xn*xd*yd^2
    Y = T.fp2_mul(T.fp2_mul(y, yn_h),
                  T.fp2_mul(T.fp2_mul(T.fp2_sqr(xd_h), xd_h), yd2))
    return (X, Y, z)


def map_to_g2_jac(u):
    """SSWU + 3-isogeny: Fp2 element batch -> Jacobian points on E2."""
    w, ctx = _sswu_g2_pre(u)
    return _iso_g2_proj(*_sswu_g2_post(T.fp2_pow_fixed(w, _E2_EXP), ctx))


def _halves(q, n):
    return _tmap(lambda t: t[:n], q), _tmap(lambda t: t[n:], q)


def hash_to_g2_jac(u0, u1):
    """Two Fp2 field-element batches -> G2 Jacobian points (in G2); the two
    SSWU maps run as one stacked pass."""
    q0, q1 = _halves(map_to_g2_jac(_cat_lanes(u0, u1)), u0[0].shape[0])
    return g2_clear_cofactor(G2.add(q0, q1))


def _g2_y2(x0_can, x1_can):
    """Decompression front half: wire x -> (x_mont, y^2 = x^3 + b)."""
    xm = (L.to_mont(x0_can), L.to_mont(x1_can))
    return xm, T.fp2_add(T.fp2_mul(T.fp2_sqr(xm), xm), _mc2(B2, xm))


def _g2_recover_post(xm, y2, e, sign_bit):
    """Back half: e = y2^E2 -> (Jacobian point, ok).  gamma = e*y2 =
    y2^((q+7)/16); the root is gamma*{1, s1, s2, s3} when y2 is a square.
    y's sign follows the ZCash larger-half rule on c1, or on c0 when c1
    is zero."""
    gamma = T.fp2_mul(e, y2)
    y, ok = None, None
    for m in _SQR_MULTS:
        c = gamma if m == (1, 0) else T.fp2_mul(gamma, _mc2(m, xm))
        hit = T.fp2_eq(T.fp2_sqr(c), y2)
        y = c if y is None else T.fp2_select(hit, c, y)
        ok = hit if ok is None else (ok | hit)
    c1_zero = L.is_zero(L.from_mont(y[1]))
    larger = torch.where(c1_zero, _fp_ge_half1(y[0]), _fp_ge_half1(y[1]))
    flip = larger ^ (sign_bit == 1)
    y = T.fp2_select(flip, T.fp2_neg(y), y)
    return (xm, y, T.fp2_ones_like(xm[0])), ok


def g2_recover_y(x0_can, x1_can, sign_bit):
    """x (canonical limbs, c0 and c1), sign flag -> (Jacobian point, ok);
    ok is False where x^3 + b is not a square (not on the curve)."""
    xm, y2 = _g2_y2(x0_can, x1_can)
    return _g2_recover_post(xm, y2, T.fp2_pow_fixed(y2, _E2_EXP), sign_bit)


def g2_decompress_and_hash(sig_x0, sig_x1, sign_bit, u0, u1):
    """Fused G2 front end: signature decompression + hash_to_curve(u0, u1)
    with ONE Fp2 E2 power (kernel K5) across all three chains (width 3N).

    Returns (sig_jac, parse_ok, hm_jac) for the verification equation
    e(-g1, S) * e(pk, H(m)) == 1."""
    u = _cat_lanes(u0, u1)
    w, ctx = _sswu_g2_pre(u)
    xm, y2 = _g2_y2(sig_x0, sig_x1)
    e = T.fp2_pow_fixed(_cat_lanes(w, y2), _E2_EXP)
    n2 = u[0].shape[0]
    e_s, e_d = _halves(e, n2)
    q = _iso_g2_proj(*_sswu_g2_post(e_s, ctx))
    sig_jac, ok = _g2_recover_post(xm, y2, e_d, sign_bit)
    q0, q1 = _halves(q, u0[0].shape[0])
    return sig_jac, ok, g2_clear_cofactor(G2.add(q0, q1))
