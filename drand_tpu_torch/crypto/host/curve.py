"""Host-side G1/G2 group law (pure Python): public-key decoding, the signing
used to cross-check the device path, and the generators.

The port's own copy of the pure-Python path of drand_tpu/crypto/host/curve.py
(the JAX package's copy prefers its native C library; this one never does).

Points: affine (x, y) or None for infinity; Jacobian (X, Y, Z) with Z = 0 for
infinity.
"""

from . import field as F
from .params import P, R, X, B1, B2, G1_GEN, G2_GEN, H_EFF_G1


class FieldOps:
    __slots__ = ("add", "sub", "mul", "sqr", "neg", "inv", "zero", "one",
                 "is_zero", "eq", "scalar")

    def __init__(self, add, sub, mul, sqr, neg, inv, zero, one, is_zero, eq,
                 scalar):
        self.add, self.sub, self.mul, self.sqr = add, sub, mul, sqr
        self.neg, self.inv, self.zero, self.one = neg, inv, zero, one
        self.is_zero, self.eq, self.scalar = is_zero, eq, scalar


FP_OPS = FieldOps(
    F.fp_add, F.fp_sub, F.fp_mul, lambda a: a * a % P, F.fp_neg, F.fp_inv,
    0, 1, lambda a: a == 0, lambda a, b: a == b, lambda a, k: a * k % P,
)

FP2_OPS = FieldOps(
    F.fp2_add, F.fp2_sub, F.fp2_mul, F.fp2_sqr, F.fp2_neg, F.fp2_inv,
    F.FP2_ZERO, F.FP2_ONE, F.fp2_is_zero, F.fp2_eq, F.fp2_scalar,
)


class Curve:
    """y^2 = x^3 + b over the field described by ``ops``."""

    def __init__(self, ops: FieldOps, b, generator, name):
        self.f = ops
        self.b = b
        self.gen = generator
        self.name = name

    def is_on_curve(self, pt):
        if pt is None:
            return True
        x, y = pt
        f = self.f
        return f.eq(f.sqr(y), f.add(f.mul(f.sqr(x), x), self.b))

    def to_jacobian(self, pt):
        f = self.f
        if pt is None:
            return (f.one, f.one, f.zero)
        return (pt[0], pt[1], f.one)

    def to_affine(self, jp):
        f = self.f
        X, Y, Z = jp
        if f.is_zero(Z):
            return None
        zi = f.inv(Z)
        zi2 = f.sqr(zi)
        return (f.mul(X, zi2), f.mul(Y, f.mul(zi2, zi)))

    def jac_double(self, jp):
        f = self.f
        X, Y, Z = jp
        if f.is_zero(Z) or f.is_zero(Y):
            return (f.one, f.one, f.zero)
        A = f.sqr(X)
        B = f.sqr(Y)
        C = f.sqr(B)
        D = f.sub(f.sqr(f.add(X, B)), f.add(A, C))
        D = f.add(D, D)
        E = f.add(f.add(A, A), A)
        Fv = f.sqr(E)
        X3 = f.sub(Fv, f.add(D, D))
        Y3 = f.sub(f.mul(E, f.sub(D, X3)), f.scalar(C, 8))
        Z3 = f.mul(f.add(Y, Y), Z)
        return (X3, Y3, Z3)

    def jac_add(self, jp, jq):
        f = self.f
        X1, Y1, Z1 = jp
        X2, Y2, Z2 = jq
        if f.is_zero(Z1):
            return jq
        if f.is_zero(Z2):
            return jp
        Z1Z1 = f.sqr(Z1)
        Z2Z2 = f.sqr(Z2)
        U1 = f.mul(X1, Z2Z2)
        U2 = f.mul(X2, Z1Z1)
        S1 = f.mul(Y1, f.mul(Z2, Z2Z2))
        S2 = f.mul(Y2, f.mul(Z1, Z1Z1))
        if f.eq(U1, U2):
            if f.eq(S1, S2):
                return self.jac_double(jp)
            return (f.one, f.one, f.zero)
        H = f.sub(U2, U1)
        I = f.sqr(f.add(H, H))
        J = f.mul(H, I)
        rr = f.sub(S2, S1)
        rr = f.add(rr, rr)
        V = f.mul(U1, I)
        X3 = f.sub(f.sub(f.sqr(rr), J), f.add(V, V))
        Y3 = f.sub(f.mul(rr, f.sub(V, X3)), f.scalar(f.mul(S1, J), 2))
        Z3 = f.mul(f.sub(f.sqr(f.add(Z1, Z2)), f.add(Z1Z1, Z2Z2)), H)
        return (X3, Y3, Z3)

    def add(self, p, q):
        return self.to_affine(
            self.jac_add(self.to_jacobian(p), self.to_jacobian(q)))

    def neg(self, p):
        if p is None:
            return None
        return (p[0], self.f.neg(p[1]))

    def mul(self, p, k):
        """Scalar multiplication k*p (any int k), double-and-add."""
        if p is None or k == 0:
            return None
        if k < 0:
            return self.mul(self.neg(p), -k)
        f = self.f
        acc = (f.one, f.one, f.zero)
        base = self.to_jacobian(p)
        while k:
            if k & 1:
                acc = self.jac_add(acc, base)
            base = self.jac_double(base)
            k >>= 1
        return self.to_affine(acc)

    def in_subgroup(self, p):
        return self.mul(p, R) is None


G1 = Curve(FP_OPS, B1, G1_GEN, "G1")
G2 = Curve(FP2_OPS, B2, G2_GEN, "G2")


def g1_clear_cofactor(p):
    """h_eff = 1 - x (RFC 9380 §8.8.1 fast method for BLS12-381 G1)."""
    return G1.mul(p, H_EFF_G1)


# psi = untwist . frobenius . twist on the D-twist E2 with this tower:
# psi(x, y) = (c_x * conj(x), c_y * conj(y)), c_x = 1/xi^((p-1)/3),
# c_y = 1/xi^((p-1)/2).
PSI_CX = F.fp2_inv(F.fp2_pow(F.XI, (P - 1) // 3))
PSI_CY = F.fp2_inv(F.fp2_pow(F.XI, (P - 1) // 2))


def g2_psi(p):
    if p is None:
        return None
    x, y = p
    return (F.fp2_mul(PSI_CX, F.fp2_conj(x)), F.fp2_mul(PSI_CY, F.fp2_conj(y)))


def g2_clear_cofactor(p):
    """Budroni-Pintore: [x^2-x-1]P + [x-1]psi(P) + psi(psi(2P)), exactly
    h_eff * P for the RFC 9380 BLS12381G2 suite."""
    xP = G2.mul(p, X)                  # x < 0: mul negates
    x2P = G2.mul(xP, X)
    t = G2.add(x2P, G2.neg(xP))        # (x^2 - x) P
    t = G2.add(t, G2.neg(p))           # (x^2 - x - 1) P
    u = g2_psi(G2.add(xP, G2.neg(p)))  # psi((x - 1) P)
    t = G2.add(t, u)
    v = g2_psi(g2_psi(G2.add(p, p)))   # psi^2(2P)
    return G2.add(t, v)
