"""G1/G2 group law on tensors: branchless Jacobian arithmetic, batched.

Counterpart of drand_tpu/ops/curve.py.  ``DevCurve`` is generic over its
field (``FieldFns``): G1 runs the formulas over Fp, G2 the same formulas
over Fp2.  A point is a Jacobian (X, Y, Z) tuple of field elements (an Fp
element is a ``(..., 24)`` Montgomery limb tensor, an Fp2 element a pair of
them); infinity has Z = 0.  Everything is select-based, so one formula runs
over a whole batch.  The formulas are the JAX package's, product group by
product group: a Jacobian point has many representatives, and the port must
produce the same one (the tests compare coordinates exactly).

  P in G1  <=>  phi(P) == [-x^2]P,   phi(x, y) = (beta*x, y)
  Q in G2  <=>  psi(Q) == [x]Q       (Bowe's check)
  h_eff = 1 - x clears the G1 cofactor (RFC 9380 section 8.8.1); G2 uses
  Budroni-Pintore with psi.

Scalar multiplication by a fixed scalar dispatches to kernel K2
(``kernels.scalar_mul_fixed``), by one scalar per lane to K6
(``kernels.scalar_mul_bits``), the GLV-split RLC multiplication to K8
(``kernels.scalar_mul_glv_mixed``), and a 1-D point sum to K7
(``kernels.sum_points``), either curve.
"""

import numpy as np
import torch

from . import limbs as L
from . import tower as T
from ..crypto.host import field as HF
from ..crypto.host.params import P as FP_P, R as ORDER_R, X as BLS_X

_BETA = pow(2, (FP_P - 1) // 3, FP_P)


class FieldFns:
    """The field operations DevCurve is generic over.  ``mul_many`` runs k
    independent products as one staged wide op; the group-law formulas
    below are written as stages of independent products for it.
    ``ones_like`` / ``zeros_like`` build an element from a leaf tensor."""

    def __init__(self, add, sub, mul, mul_many, sqr, neg, inv, is_zero, eq,
                 select, zeros_like, ones_like):
        self.add, self.sub, self.mul, self.mul_many = add, sub, mul, mul_many
        self.sqr, self.neg, self.inv = sqr, neg, inv
        self.is_zero, self.eq, self.select = is_zero, eq, select
        self.zeros_like, self.ones_like = zeros_like, ones_like


FP_FNS = FieldFns(
    add=L.add_mod, sub=L.sub_mod, mul=L.mont_mul, mul_many=L.mul_many,
    sqr=L.mont_sqr, neg=L.neg_mod, inv=L.inv_mod, is_zero=L.is_zero,
    eq=L.eq, select=L.select, zeros_like=lambda x: x.new_zeros(x.shape),
    ones_like=L.ones_like)

FP2_FNS = FieldFns(
    add=T.fp2_add, sub=T.fp2_sub, mul=T.fp2_mul, mul_many=T.fp2_mul_many,
    sqr=T.fp2_sqr, neg=T.fp2_neg, inv=T.fp2_inv, is_zero=T.fp2_is_zero,
    eq=T.fp2_eq, select=T.fp2_select, zeros_like=T.fp2_zeros_like,
    ones_like=T.fp2_ones_like)


def _leaf(x):
    while isinstance(x, tuple):
        x = x[0]
    return x


def _tmap(fn, *trees):
    """fn over the leaf tensors of equally nested tuples."""
    if isinstance(trees[0], tuple):
        return tuple(_tmap(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


class DevCurve:
    """y^2 = x^3 + b over the field `f`, Jacobian coordinates (the JAX
    DevCurve)."""

    def __init__(self, f: FieldFns, name: str):
        self.f = f
        self.name = name

    # -- constructors --------------------------------------------------------

    def infinity_like(self, x):
        """Infinity (1, 1, 0) with the batch shape of leaf tensor x."""
        one = self.f.ones_like(x)
        return (one, one, self.f.zeros_like(x))

    def is_infinity(self, p):
        return self.f.is_zero(p[2])

    # -- group law -----------------------------------------------------------

    def double(self, p):
        """Branchless Jacobian doubling; maps infinity to infinity."""
        f = self.f
        X1, Y1, Z1 = p
        A, B, t = f.mul_many([(X1, X1), (Y1, Y1), (Y1, Z1)])
        XB = f.add(X1, B)
        C, U = f.mul_many([(B, B), (XB, XB)])
        D = f.sub(f.sub(U, A), C)
        D = f.add(D, D)
        E = f.add(f.add(A, A), A)
        (Fv,) = f.mul_many([(E, E)])
        X3 = f.sub(Fv, f.add(D, D))
        (Y3a,) = f.mul_many([(E, f.sub(D, X3))])
        C2 = f.add(C, C)
        C4 = f.add(C2, C2)
        Y3 = f.sub(Y3a, f.add(C4, C4))
        Z3 = f.add(t, t)
        return (X3, Y3, Z3)

    def add(self, p, q):
        """Complete Jacobian addition: handles inf operands, P==Q, P==-Q."""
        f = self.f
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        Z12 = f.add(Z1, Z2)
        Z1Z1, Z2Z2, ZS, dA, dB, dt = f.mul_many(
            [(Z1, Z1), (Z2, Z2), (Z12, Z12), (X1, X1), (Y1, Y1), (Y1, Z1)])
        XB = f.add(X1, dB)
        U1, U2, t1, t2, dC, dU = f.mul_many(
            [(X1, Z2Z2), (X2, Z1Z1), (Z2, Z2Z2), (Z1, Z1Z1), (dB, dB),
             (XB, XB)])
        dD = f.sub(f.sub(dU, dA), dC)
        dD = f.add(dD, dD)
        dE = f.add(f.add(dA, dA), dA)
        S1, S2, dFv = f.mul_many([(Y1, t1), (Y2, t2), (dE, dE)])
        H = f.sub(U2, U1)
        HH = f.add(H, H)
        rr = f.sub(S2, S1)
        rr = f.add(rr, rr)
        dX3 = f.sub(dFv, f.add(dD, dD))
        I, dY3a = f.mul_many([(HH, HH), (dE, f.sub(dD, dX3))])
        dC2 = f.add(dC, dC)
        dC4 = f.add(dC2, dC2)
        dY3 = f.sub(dY3a, f.add(dC4, dC4))
        dZ3 = f.add(dt, dt)
        J, V, RR, Z3 = f.mul_many(
            [(H, I), (U1, I), (rr, rr), (f.sub(f.sub(ZS, Z1Z1), Z2Z2), H)])
        X3 = f.sub(f.sub(RR, J), f.add(V, V))
        Y3a, S1J = f.mul_many([(rr, f.sub(V, X3)), (S1, J)])
        Y3 = f.sub(Y3a, f.add(S1J, S1J))
        out = (X3, Y3, Z3)

        inf1 = self.is_infinity(p)
        inf2 = self.is_infinity(q)
        same_x = f.eq(U1, U2) & ~inf1 & ~inf2
        same_y = f.eq(S1, S2)
        dbl = (dX3, dY3, dZ3)
        infp = self.infinity_like(_leaf(X3))
        out = self.select(same_x & same_y, dbl, out)
        out = self.select(same_x & ~same_y, infp, out)
        out = self.select(inf1, q, out)
        out = self.select(inf2, p, out)
        return out

    def add_mixed(self, p, q_aff):
        """Complete mixed addition: q = (X2, Y2) affine, never infinity.
        Z2 = 1 drops 5 of the complete add's 23 staged products; the P == Q
        doubling and the infinite accumulator stay select-based, in the
        JAX package's order of precedence."""
        f = self.f
        X1, Y1, Z1 = p
        X2, Y2 = q_aff
        Z1Z1, dA, dB, dt = f.mul_many(
            [(Z1, Z1), (X1, X1), (Y1, Y1), (Y1, Z1)])
        XB = f.add(X1, dB)
        U2, t2, dC, dU = f.mul_many(
            [(X2, Z1Z1), (Z1, Z1Z1), (dB, dB), (XB, XB)])
        dD = f.sub(f.sub(dU, dA), dC)
        dD = f.add(dD, dD)
        dE = f.add(f.add(dA, dA), dA)
        S2, dFv = f.mul_many([(Y2, t2), (dE, dE)])
        H = f.sub(U2, X1)
        HH = f.add(H, H)
        rr = f.sub(S2, Y1)
        rr = f.add(rr, rr)
        dX3 = f.sub(dFv, f.add(dD, dD))
        I, dY3a = f.mul_many([(HH, HH), (dE, f.sub(dD, dX3))])
        dC2 = f.add(dC, dC)
        dC4 = f.add(dC2, dC2)
        dY3 = f.sub(dY3a, f.add(dC4, dC4))
        dZ3 = f.add(dt, dt)
        J, V, RR, Z3 = f.mul_many([(H, I), (X1, I), (rr, rr), (Z1, HH)])
        X3 = f.sub(f.sub(RR, J), f.add(V, V))
        Y3a, S1J = f.mul_many([(rr, f.sub(V, X3)), (Y1, J)])
        Y3 = f.sub(Y3a, f.add(S1J, S1J))
        out = (X3, Y3, Z3)

        inf1 = self.is_infinity(p)
        same_x = f.eq(U2, X1) & ~inf1
        same_y = f.eq(S2, Y1)
        dbl = (dX3, dY3, dZ3)
        leaf = _leaf(X3)
        out = self.select(same_x & same_y, dbl, out)
        out = self.select(same_x & ~same_y, self.infinity_like(leaf), out)
        out = self.select(inf1, (X2, Y2, f.ones_like(leaf)), out)
        return out

    def batch_inverse(self, z):
        """Simultaneous inversion over the leading axis: one Fermat chain
        (K1 at one lane) and about 3 products per element through a
        tree-shaped Montgomery trick, every level one wide product.
        0 -> 0."""
        f = self.f
        cat = lambda *ts: _tmap(lambda *xs: torch.cat(xs, 0), *ts)
        cut = lambda t, lo, hi=None: _tmap(lambda x: x[lo:hi], t)
        zero = f.is_zero(z)
        z = f.select(zero, f.ones_like(_leaf(z)), z)
        levels = []
        cur = z
        while _leaf(cur).shape[0] > 1:
            n = _leaf(cur).shape[0]
            half = n // 2
            levels.append((cur, half, n))
            (prod,) = f.mul_many([(cut(cur, 0, half), cut(cur, half,
                                                          2 * half))])
            if n % 2:
                prod = cat(prod, cut(cur, 2 * half))
            cur = prod
        inv = f.inv(cur)
        for cur_lvl, half, n in reversed(levels):
            a, b = cut(cur_lvl, 0, half), cut(cur_lvl, half, 2 * half)
            pinv = cut(inv, 0, half)
            ia, ib = f.mul_many([(pinv, b), (pinv, a)])
            out = cat(ia, ib)
            if n % 2:
                out = cat(out, cut(inv, half))
            inv = out
        return f.select(zero, f.zeros_like(_leaf(inv)), inv)

    def to_affine_batch(self, p):
        """to_affine over the leading axis with one shared inversion
        (batch_inverse).  Returns (x, y, is_inf); infinity maps to
        (0, 0, True)."""
        f = self.f
        X1, Y1, Z1 = p
        zi = self.batch_inverse(Z1)
        zi2 = f.sqr(zi)
        x, zi3 = f.mul_many([(X1, zi2), (zi2, zi)])
        (y,) = f.mul_many([(Y1, zi3)])
        return (x, y, self.is_infinity(p))

    def neg(self, p):
        return (p[0], self.f.neg(p[1]), p[2])

    def select(self, cond, a, b):
        return tuple(self.f.select(cond, x, y) for x, y in zip(a, b))

    def to_affine(self, p):
        """Returns (x, y, is_inf).  Infinity maps to (0, 0, True)."""
        f = self.f
        X1, Y1, Z1 = p
        zi = f.inv(Z1)                  # 0 for infinity -> coords come out 0
        zi2 = f.sqr(zi)
        return (f.mul(X1, zi2), f.mul(Y1, f.mul(zi2, zi)),
                self.is_infinity(p))

    def eq_points(self, p, q):
        """Projective equality (both may be infinity)."""
        f = self.f
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        Z1Z1, Z2Z2 = f.mul_many([(Z1, Z1), (Z2, Z2)])
        a, b, t1, t2 = f.mul_many(
            [(X1, Z2Z2), (X2, Z1Z1), (Z2, Z2Z2), (Z1, Z1Z1)])
        c, d = f.mul_many([(Y1, t1), (Y2, t2)])
        same = f.eq(a, b) & f.eq(c, d)
        both_inf = self.is_infinity(p) & self.is_infinity(q)
        one_inf = self.is_infinity(p) ^ self.is_infinity(q)
        return (same | both_inf) & ~one_inf

    def scalar_mul_fixed(self, p, k: int):
        """k*P for a static python-int scalar: kernel K2 (|k| ladder, then a
        negation for k < 0)."""
        from . import kernels
        if k == 0:
            return self.infinity_like(_leaf(p[0]))
        res = kernels.scalar_mul_fixed(p, abs(k))
        return self.neg(res) if k < 0 else res

    def scalar_mul_bits(self, p, bits):
        """k*P for per-element scalars given as an MSB-first bit tensor:
        p has batch shape S, bits (nbits,) + S.  Kernel K6."""
        from . import kernels
        return kernels.scalar_mul_bits(p, bits)

    def sum_points(self, p):
        """Sum a point batch over its leading axis.  A 1-D batch goes to
        kernel K7 (the JAX Pallas route); a batch of more dimensions runs
        the JAX package's halving tree over the leading axis, the odd
        leftover carried, as pallas_field.sum_points leaves it to XLA."""
        from . import kernels
        if _leaf(p[0]).dim() == 2:
            return kernels.sum_points(p)
        n = _leaf(p[0]).shape[0]
        while n > 1:
            half = n // 2
            s = self.add(_tmap(lambda t: t[:half], p),
                         _tmap(lambda t: t[half:2 * half], p))
            p = _cat_lanes(s, _tmap(lambda t: t[2 * half:], p)) \
                if n % 2 else s
            n = half + n % 2
        return _tmap(lambda t: t[0], p)


G1 = DevCurve(FP_FNS, "G1")
G2 = DevCurve(FP2_FNS, "G2")


def _cat_lanes(*pts):
    return _tmap(lambda *xs: torch.cat(xs, 0), *pts)


# ---------------------------------------------------------------------------
# Scalars to bit planes (host numpy)
# ---------------------------------------------------------------------------

def msb_bits(ks, nbits: int) -> np.ndarray:
    """Non-negative ints below 2^nbits -> (nbits, len(ks)) MSB-first int32
    bit planes."""
    nbytes = (nbits + 7) // 8
    buf = np.frombuffer(b"".join(int(k).to_bytes(nbytes, "big") for k in ks),
                        np.uint8).reshape(len(ks), nbytes)
    bits = np.unpackbits(buf, axis=1)[:, -nbits:]
    return np.ascontiguousarray(bits.T, dtype=np.int32)


def scalars_to_bits(ks, nbits: int = 256) -> np.ndarray:
    """Scalars (reduced mod r, low nbits kept) -> (nbits, len(ks))
    MSB-first int32 bit planes."""
    lomask = (1 << nbits) - 1
    return msb_bits([k % ORDER_R & lomask for k in ks], nbits)


# Signed-digit GLV decompositions of full 255-bit scalars (the Lagrange
# coefficients of batched recovery): the device negates a base lane where
# its digit is negative and runs one short ladder (K6) over all lanes.
# G2: psi acts as [x], so k = sum_j d_j x^j gives [k]Q = sum_j [d_j]
# psi^j(Q); centered base-x digits fit 66 bits.  G1: phi has eigenvalue
# lambda = -x^2; Babai rounding on the basis (x^2, 1), (x^2 - 1, x^2) gives
# k = k0 + lambda k1 with |k_i| < 2^130.
GLV_G2_LANES = 4
GLV_G2_NBITS = 66
GLV_G1_LANES = 2
GLV_G1_NBITS = 130


def _signed_digit_bits(digs: np.ndarray, nbits: int):
    """(lanes, n) object array of signed ints -> (bits (nbits, lanes, n)
    MSB-first int32, neg mask (lanes, n) int32)."""
    shape = digs.shape
    flat = [int(d) for d in digs.reshape(-1)]
    mags = [abs(d) for d in flat]
    assert max(mags, default=0) < (1 << nbits), \
        f"GLV digit overflows {nbits} bits"
    neg = np.array([d < 0 for d in flat], dtype=np.int32)
    return (msb_bits(mags, nbits).reshape((nbits,) + shape),
            neg.reshape(shape))


def glv_decompose_g2(ks):
    """Scalars -> (bits (66, 4, n), neg (4, n)) with k = d0 + x d1 + x^2 d2
    + x^3 d3 mod r, so [k]Q = sum_j [d_j] psi^j(Q) on G2."""
    m = -BLS_X
    n = len(ks)
    digs = np.zeros((GLV_G2_LANES, n), dtype=object)
    for i, k in enumerate(ks):
        t = int(k) % ORDER_R
        for j in range(GLV_G2_LANES):
            q = -((2 * t + m) // (2 * m))     # nearest integer to t/x
            digs[j][i] = t - BLS_X * q
            t = q
        digs[GLV_G2_LANES - 1][i] += BLS_X * t  # fold the residual
    return _signed_digit_bits(digs, GLV_G2_NBITS)


def glv_decompose_g1(ks):
    """Scalars -> (bits (130, 2, n), neg (2, n)) with k = k0 + lambda k1
    mod r, lambda = -x^2 the phi eigenvalue, so [k]P = [k0]P + [k1]phi(P)."""
    x2 = BLS_X * BLS_X
    n = len(ks)
    digs = np.zeros((GLV_G1_LANES, n), dtype=object)
    for i, k in enumerate(ks):
        k = int(k) % ORDER_R
        c1 = (2 * k * x2 + ORDER_R) // (2 * ORDER_R)
        c2 = -((2 * k + ORDER_R) // (2 * ORDER_R))
        digs[0][i] = k - c1 * x2 - c2 * (x2 - 1)
        digs[1][i] = -c1 - c2 * x2
    return _signed_digit_bits(digs, GLV_G1_NBITS)


# ---------------------------------------------------------------------------
# G1 endomorphism phi, subgroup check, cofactor clearing, GLV terms
# ---------------------------------------------------------------------------

def g1_phi(p):
    X1, Y1, Z1 = p
    return (L.mont_mul(L.mont_const(_BETA, X1.device), X1), Y1, Z1)


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


# ---------------------------------------------------------------------------
# G2 endomorphisms psi and psi^2, subgroup check, cofactor clearing, GLV
# ---------------------------------------------------------------------------

# psi on the D-twist: psi(x, y) = (c_x * conj(x), c_y * conj(y)); on Jacobian
# coordinates psi(X, Y, Z) = (c_x*conj(X), c_y*conj(Y), conj(Z)).
_PSI_CX = HF.fp2_inv(HF.fp2_pow(HF.XI, (FP_P - 1) // 3))
_PSI_CY = HF.fp2_inv(HF.fp2_pow(HF.XI, (FP_P - 1) // 2))
# psi^2 scales affine coordinates by Fp constants n = c * conj(c) (the
# norms land in Fp); its eigenvalue on G2 is x^2.
_PSI2_NX = HF.fp2_mul(_PSI_CX, HF.fp2_conj(_PSI_CX))
_PSI2_NY = HF.fp2_mul(_PSI_CY, HF.fp2_conj(_PSI_CY))
assert _PSI2_NX[1] == 0 and _PSI2_NY[1] == 0
_PSI2_NX, _PSI2_NY = _PSI2_NX[0], _PSI2_NY[0]


def _fp2_const(c, device):
    return (L.mont_const(c[0], device), L.mont_const(c[1], device))


def g2_psi(p):
    X2, Y2, Z2 = p
    dev = _leaf(X2).device
    x, y = T.fp2_mul_many([(_fp2_const(_PSI_CX, dev), T.fp2_conj(X2)),
                           (_fp2_const(_PSI_CY, dev), T.fp2_conj(Y2))])
    return (x, y, T.fp2_conj(Z2))


def _psi2_affine_scale(x, y):
    """(n_x*x, n_y*y): psi^2 on Fp2 coordinates, four Fp products."""
    dev = x[0].device
    nx, ny = L.mont_const(_PSI2_NX, dev), L.mont_const(_PSI2_NY, dev)
    r = L.mul_many([(x[0], nx), (x[1], nx), (y[0], ny), (y[1], ny)])
    return (r[0], r[1]), (r[2], r[3])


def g2_psi2(p):
    """psi o psi on Jacobian coordinates: Fp scalings of X and Y, Z kept."""
    x, y = _psi2_affine_scale(p[0], p[1])
    return (x, y, p[2])


def g2_psi_lanes(p):
    """[P, psi P, psi^2 P, psi^3 P] concatenated along the leading axis."""
    p2 = g2_psi2(p)
    return _cat_lanes(p, g2_psi(p), p2, g2_psi(p2))


def g2_glv_msm_terms(p, bits0, bits1):
    """(k0 + x^2*k1)-weighted G2 points for the RLC (x^2 the psi^2
    eigenvalue); bits MSB-first, (nbits,) + batch, 32 bits when the caller
    splits the 128-bit coefficient four ways across psi by lane
    duplication (crypto/batch.py).

    The route of the JAX package's Pallas engine
    (pallas_field.scalar_mul_glv_g2): psi^2(Q) as Jacobian, Q + psi^2(Q) by
    a complete add, ONE to_affine_batch over Q and Q + psi^2(Q), psi^2's
    affine table (n_x x, n_y y), the joint ladder (kernel K8, G2 instance)
    and infinity restored for infinite inputs."""
    from . import kernels
    p3_jac = G2.add(p, g2_psi2(p))
    ax, ay, _ = G2.to_affine_batch(_cat_lanes(p, p3_jac))
    n = _leaf(p[0]).shape[0]
    lo = lambda c: _tmap(lambda t: t[:n], c)
    hi = lambda c: _tmap(lambda t: t[n:], c)
    pt, p3 = (lo(ax), lo(ay)), (hi(ax), hi(ay))
    psi2 = _psi2_affine_scale(*pt)
    out = kernels.scalar_mul_glv_mixed(pt, psi2, p3, bits0, bits1)
    return G2.select(G2.is_infinity(p), G2.infinity_like(_leaf(p[0])), out)


def g2_in_subgroup(p):
    """Q in G2 <=> psi(Q) == [x]Q (batch).  Infinity counts as member."""
    return G2.eq_points(g2_psi(p), G2.scalar_mul_fixed(p, BLS_X))


def g2_clear_cofactor(p):
    """Budroni-Pintore: [x^2-x-1]P + [x-1]psi(P) + psi^2(2P), exactly
    h_eff*P for the RFC 9380 G2 suite (three K2 |x| ladders)."""
    xP = G2.scalar_mul_fixed(p, BLS_X)
    x2P = G2.scalar_mul_fixed(xP, BLS_X)
    t = G2.add(x2P, G2.neg(xP))               # (x^2 - x) P
    t = G2.add(t, G2.neg(p))                  # (x^2 - x - 1) P
    u = g2_psi(G2.add(xP, G2.neg(p)))         # psi((x - 1) P)
    t = G2.add(t, u)
    v = g2_psi(g2_psi(G2.double(p)))          # psi^2(2P)
    return G2.add(t, v)


# ---------------------------------------------------------------------------
# Host <-> tensor points
# ---------------------------------------------------------------------------

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


def encode_g2_points(pts, device="cpu"):
    """Host affine G2 points (or None) -> batched Jacobian point."""
    cols = [[] for _ in range(6)]
    for pt in pts:
        if pt is None:
            vals = (1, 0, 1, 0, 0, 0)
        else:
            (x0, x1), (y0, y1) = pt
            vals = (x0, x1, y0, y1, 1, 0)
        for c, v in zip(cols, vals):
            c.append(v)
    e = [L.encode_mont(c, device) for c in cols]
    return ((e[0], e[1]), (e[2], e[3]), (e[4], e[5]))


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


def decode_g2_points(p):
    """Batched Jacobian G2 point -> host affine list (None = infinity)."""
    cols = [L.decode_mont(c) for coord in p for c in coord]
    out = []
    for x0, x1, y0, y1, z0, z1 in zip(*cols):
        if (z0, z1) == (0, 0):
            out.append(None)
            continue
        zi = HF.fp2_inv((z0, z1))
        zi2 = HF.fp2_mul(zi, zi)
        out.append((HF.fp2_mul((x0, x1), zi2),
                    HF.fp2_mul((y0, y1), HF.fp2_mul(zi2, zi))))
    return out
