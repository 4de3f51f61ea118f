"""G1 group law on tensors: branchless Jacobian arithmetic, batched.

Counterpart of the G1 half of drand_tpu/ops/curve.py.  Points are Jacobian
(X, Y, Z) tuples of ``(..., 24)`` Montgomery limb tensors; infinity has
Z = 0.  Everything is select-based, so one formula runs over a whole batch.
The formulas are the JAX package's, product group by product group: a
Jacobian point has many representatives, and the port must produce the
same one (the tests compare coordinates exactly).

  P in G1  <=>  phi(P) == [-x^2]P,   phi(x, y) = (beta*x, y)
  h_eff = 1 - x clears the G1 cofactor (RFC 9380 section 8.8.1)

Scalar multiplication by a fixed scalar dispatches to kernel K2
(``kernels.scalar_mul_fixed``), the GLV-split RLC multiplication to K8
(``kernels.scalar_mul_glv_mixed``).
"""

import torch

from . import limbs as L
from ..crypto.host.params import P as FP_P, X as BLS_X

_BETA = pow(2, (FP_P - 1) // 3, FP_P)


class DevCurve:
    """y^2 = x^3 + 4 over Fp, Jacobian coordinates (the G1 instance of the
    JAX DevCurve)."""

    name = "G1"

    # -- constructors --------------------------------------------------------

    @staticmethod
    def infinity_like(x):
        one = L.ones_like(x)
        return (one, one, x.new_zeros(x.shape))

    @staticmethod
    def is_infinity(p):
        return L.is_zero(p[2])

    # -- group law -----------------------------------------------------------

    @staticmethod
    def double(p):
        """Branchless Jacobian doubling; maps infinity to infinity."""
        X1, Y1, Z1 = p
        A, B, t = L.mul_many([(X1, X1), (Y1, Y1), (Y1, Z1)])
        XB = L.add_mod(X1, B)
        C, U = L.mul_many([(B, B), (XB, XB)])
        D = L.sub_mod(L.sub_mod(U, A), C)
        D = L.add_mod(D, D)
        E = L.add_mod(L.add_mod(A, A), A)
        (Fv,) = L.mul_many([(E, E)])
        X3 = L.sub_mod(Fv, L.add_mod(D, D))
        (Y3a,) = L.mul_many([(E, L.sub_mod(D, X3))])
        C2 = L.add_mod(C, C)
        C4 = L.add_mod(C2, C2)
        Y3 = L.sub_mod(Y3a, L.add_mod(C4, C4))
        Z3 = L.add_mod(t, t)
        return (X3, Y3, Z3)

    @classmethod
    def add(cls, p, q):
        """Complete Jacobian addition: handles inf operands, P==Q, P==-Q."""
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        Z12 = L.add_mod(Z1, Z2)
        Z1Z1, Z2Z2, ZS, dA, dB, dt = L.mul_many(
            [(Z1, Z1), (Z2, Z2), (Z12, Z12), (X1, X1), (Y1, Y1), (Y1, Z1)])
        XB = L.add_mod(X1, dB)
        U1, U2, t1, t2, dC, dU = L.mul_many(
            [(X1, Z2Z2), (X2, Z1Z1), (Z2, Z2Z2), (Z1, Z1Z1), (dB, dB),
             (XB, XB)])
        dD = L.sub_mod(L.sub_mod(dU, dA), dC)
        dD = L.add_mod(dD, dD)
        dE = L.add_mod(L.add_mod(dA, dA), dA)
        S1, S2, dFv = L.mul_many([(Y1, t1), (Y2, t2), (dE, dE)])
        H = L.sub_mod(U2, U1)
        HH = L.add_mod(H, H)
        rr = L.sub_mod(S2, S1)
        rr = L.add_mod(rr, rr)
        dX3 = L.sub_mod(dFv, L.add_mod(dD, dD))
        I, dY3a = L.mul_many([(HH, HH), (dE, L.sub_mod(dD, dX3))])
        dC2 = L.add_mod(dC, dC)
        dC4 = L.add_mod(dC2, dC2)
        dY3 = L.sub_mod(dY3a, L.add_mod(dC4, dC4))
        dZ3 = L.add_mod(dt, dt)
        J, V, RR, Z3 = L.mul_many(
            [(H, I), (U1, I), (rr, rr),
             (L.sub_mod(L.sub_mod(ZS, Z1Z1), Z2Z2), H)])
        X3 = L.sub_mod(L.sub_mod(RR, J), L.add_mod(V, V))
        Y3a, S1J = L.mul_many([(rr, L.sub_mod(V, X3)), (S1, J)])
        Y3 = L.sub_mod(Y3a, L.add_mod(S1J, S1J))
        out = (X3, Y3, Z3)

        inf1 = cls.is_infinity(p)
        inf2 = cls.is_infinity(q)
        same_x = L.eq(U1, U2) & ~inf1 & ~inf2
        same_y = L.eq(S1, S2)
        dbl = (dX3, dY3, dZ3)
        infp = cls.infinity_like(X3)
        out = cls.select(same_x & same_y, dbl, out)
        out = cls.select(same_x & ~same_y, infp, out)
        out = cls.select(inf1, q, out)
        out = cls.select(inf2, p, out)
        return out

    @classmethod
    def add_mixed(cls, p, q_aff):
        """Complete mixed addition: q = (X2, Y2) affine, never infinity.
        Z2 = 1 drops 5 of the complete add's 23 staged products; the P == Q
        doubling and the infinite accumulator stay select-based, in the
        JAX package's order of precedence."""
        X1, Y1, Z1 = p
        X2, Y2 = q_aff
        Z1Z1, dA, dB, dt = L.mul_many(
            [(Z1, Z1), (X1, X1), (Y1, Y1), (Y1, Z1)])
        XB = L.add_mod(X1, dB)
        U2, t2, dC, dU = L.mul_many(
            [(X2, Z1Z1), (Z1, Z1Z1), (dB, dB), (XB, XB)])
        dD = L.sub_mod(L.sub_mod(dU, dA), dC)
        dD = L.add_mod(dD, dD)
        dE = L.add_mod(L.add_mod(dA, dA), dA)
        S2, dFv = L.mul_many([(Y2, t2), (dE, dE)])
        H = L.sub_mod(U2, X1)
        HH = L.add_mod(H, H)
        rr = L.sub_mod(S2, Y1)
        rr = L.add_mod(rr, rr)
        dX3 = L.sub_mod(dFv, L.add_mod(dD, dD))
        I, dY3a = L.mul_many([(HH, HH), (dE, L.sub_mod(dD, dX3))])
        dC2 = L.add_mod(dC, dC)
        dC4 = L.add_mod(dC2, dC2)
        dY3 = L.sub_mod(dY3a, L.add_mod(dC4, dC4))
        dZ3 = L.add_mod(dt, dt)
        J, V, RR, Z3 = L.mul_many([(H, I), (X1, I), (rr, rr), (Z1, HH)])
        X3 = L.sub_mod(L.sub_mod(RR, J), L.add_mod(V, V))
        Y3a, S1J = L.mul_many([(rr, L.sub_mod(V, X3)), (Y1, J)])
        Y3 = L.sub_mod(Y3a, L.add_mod(S1J, S1J))
        out = (X3, Y3, Z3)

        inf1 = cls.is_infinity(p)
        same_x = L.eq(U2, X1) & ~inf1
        same_y = L.eq(S2, Y1)
        dbl = (dX3, dY3, dZ3)
        out = cls.select(same_x & same_y, dbl, out)
        out = cls.select(same_x & ~same_y, cls.infinity_like(X3), out)
        out = cls.select(inf1, (X2, Y2, L.ones_like(X3)), out)
        return out

    @staticmethod
    def batch_inverse(z):
        """Simultaneous inversion over the leading axis: one Fermat chain
        (K1 at one lane) and about 3 products per element through a
        tree-shaped Montgomery trick, every level one wide product.
        0 -> 0."""
        zero = L.is_zero(z)
        z = L.select(zero, L.ones_like(z), z)
        levels = []
        cur = z
        while cur.shape[0] > 1:
            n = cur.shape[0]
            half = n // 2
            levels.append((cur, half, n))
            (prod,) = L.mul_many([(cur[:half], cur[half:2 * half])])
            if n % 2:
                prod = torch.cat([prod, cur[2 * half:]], 0)
            cur = prod
        inv = L.inv_mod(cur)
        for cur_lvl, half, n in reversed(levels):
            a, b = cur_lvl[:half], cur_lvl[half:2 * half]
            pinv = inv[:half]
            ia, ib = L.mul_many([(pinv, b), (pinv, a)])
            out = torch.cat([ia, ib], 0)
            if n % 2:
                out = torch.cat([out, inv[half:]], 0)
            inv = out
        return L.select(zero, torch.zeros_like(inv), inv)

    @classmethod
    def to_affine_batch(cls, p):
        """to_affine over the leading axis with one shared inversion
        (batch_inverse).  Returns (x, y, is_inf); infinity maps to
        (0, 0, True)."""
        X1, Y1, Z1 = p
        zi = cls.batch_inverse(Z1)
        zi2 = L.mont_sqr(zi)
        x, zi3 = L.mul_many([(X1, zi2), (zi2, zi)])
        (y,) = L.mul_many([(Y1, zi3)])
        return (x, y, cls.is_infinity(p))

    @staticmethod
    def neg(p):
        return (p[0], L.neg_mod(p[1]), p[2])

    @staticmethod
    def select(cond, a, b):
        return tuple(L.select(cond, x, y) for x, y in zip(a, b))

    @classmethod
    def to_affine(cls, p):
        """Returns (x, y, is_inf).  Infinity maps to (0, 0, True)."""
        X1, Y1, Z1 = p
        zi = L.inv_mod(Z1)              # 0 for infinity -> coords come out 0
        zi2 = L.mont_sqr(zi)
        return (L.mont_mul(X1, zi2), L.mont_mul(Y1, L.mont_mul(zi2, zi)),
                cls.is_infinity(p))

    @classmethod
    def eq_points(cls, p, q):
        """Projective equality (both may be infinity)."""
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        Z1Z1, Z2Z2 = L.mul_many([(Z1, Z1), (Z2, Z2)])
        a, b, t1, t2 = L.mul_many(
            [(X1, Z2Z2), (X2, Z1Z1), (Z2, Z2Z2), (Z1, Z1Z1)])
        c, d = L.mul_many([(Y1, t1), (Y2, t2)])
        same = L.eq(a, b) & L.eq(c, d)
        both_inf = cls.is_infinity(p) & cls.is_infinity(q)
        one_inf = cls.is_infinity(p) ^ cls.is_infinity(q)
        return (same | both_inf) & ~one_inf

    @classmethod
    def scalar_mul_fixed(cls, p, k: int):
        """k*P for a static python-int scalar: kernel K2 (|k| ladder, then a
        negation for k < 0)."""
        from . import kernels
        if k == 0:
            return cls.infinity_like(p[0])
        res = kernels.scalar_mul_fixed(p, abs(k))
        return cls.neg(res) if k < 0 else res


G1 = DevCurve()


def g1_phi(p):
    X1, Y1, Z1 = p
    return (L.mont_mul(L.mont_const(_BETA, X1.device), X1), Y1, Z1)


def _cat_lanes(*pts):
    return tuple(torch.cat(cs, 0) for cs in zip(*pts))


def g1_phi_lanes(p):
    """[P, phi(P)] concatenated along the leading batch axis."""
    return _cat_lanes(p, g1_phi(p))


def g1_glv_msm_terms(p, bits0, bits1):
    """(k0 + lambda*k1)-weighted points for the RLC, lambda = -x^2 mod r
    (the phi eigenvalue); bits MSB-first, (nbits,) + batch.

    The route of the JAX package's Pallas engine
    (pallas_field.scalar_mul_glv_g1): the tables {P, phi(P), P + phi(P)}
    go affine through ONE to_affine_batch over P and P + phi(P), phi's
    affine x is beta*x, the joint ladder is kernel K8, and infinite inputs
    (whose affine tables read (0, 0)) get infinity back afterwards."""
    from . import kernels
    p3_jac = G1.add(p, g1_phi(p))
    ax, ay, _ = G1.to_affine_batch(_cat_lanes(p, p3_jac))
    n = p[0].shape[0]
    pt, p3 = (ax[:n], ay[:n]), (ax[n:], ay[n:])
    phi = (L.mont_mul(L.mont_const(_BETA, pt[0].device), pt[0]), pt[1])
    out = kernels.scalar_mul_glv_mixed(pt, phi, p3, bits0, bits1)
    return G1.select(G1.is_infinity(p), G1.infinity_like(p[0]), out)


def g1_in_subgroup(p):
    """P in G1 <=> phi(P) == [-x^2]P, with [-x^2]P = -[|x|][|x|]P."""
    lhs = g1_phi(p)
    xP = G1.scalar_mul_fixed(p, -BLS_X)
    x2P = G1.scalar_mul_fixed(xP, -BLS_X)
    return G1.eq_points(lhs, G1.neg(x2P))


def g1_clear_cofactor(p):
    """h_eff = 1 - x (RFC 9380 section 8.8.1 fast method)."""
    return G1.scalar_mul_fixed(p, 1 - BLS_X)


def encode_g1_points(pts, device="cpu"):
    """Host affine G1 points (or None) -> batched Jacobian point."""
    xs, ys, zs = [], [], []
    for pt in pts:
        if pt is None:
            xs.append(1); ys.append(1); zs.append(0)
        else:
            xs.append(pt[0]); ys.append(pt[1]); zs.append(1)
    return (L.encode_mont(xs, device), L.encode_mont(ys, device),
            L.encode_mont(zs, device))


def decode_g1_points(p):
    """Batched Jacobian point -> host affine list (None = infinity)."""
    out = []
    for x, y, z in zip(L.decode_mont(p[0]), L.decode_mont(p[1]),
                       L.decode_mont(p[2])):
        if z == 0:
            out.append(None)
            continue
        zi = pow(z, FP_P - 2, FP_P)
        zi2 = zi * zi % FP_P
        out.append((x * zi2 % FP_P, y * zi2 * zi % FP_P))
    return out
