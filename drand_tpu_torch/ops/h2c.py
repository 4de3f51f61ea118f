"""RFC 9380 hash-to-G1 and G1 signature decompression on tensors.

Counterpart of the G1 half of drand_tpu/ops/h2c.py.  The host hashes
(expand_message_xmd, hash_to_field: crypto/host/h2c.py); everything
algebraic runs batched on tensors:

* simplified SWU, F.2.1.2 straight-line version for q = 3 mod 4: ONE
  (p-3)/4 power yields both the square test and the root, x stays
  projective (xn/xd), so the map contains no inversion;
* the 11-isogeny on homogenized polynomials, Jacobian output;
* signature decompression rides the same (p-3)/4 exponent, so
  ``g1_decompress_and_hash`` runs ONE K1 launch at width 3N for the N
  signatures and the 2N hash inputs.
"""

import torch

from . import limbs as L
from .curve import G1, g1_clear_cofactor
from ..crypto.host.params import P, ISO_A1, ISO_B1, Z1, B1
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
