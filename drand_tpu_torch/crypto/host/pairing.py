"""Host-side optimal ate pairing for BLS12-381.

e : G1 x G2 -> GT (subgroup of Fp12*).  Implemented as the optimal ate Miller
loop over |x| followed by conjugation (x < 0) and final exponentiation whose
hard part uses the standard BLS12 decomposition

    3 * (p^4 - p^2 + 1)/r  =  (x-1)^2 * (x + p) * (x^2 + p^2 - 1) + 3

(the cube factor is harmless: we only ever test products against 1 and
gcd(3, r) = 1).  The identity itself is asserted in tests.

The port's copy of drand_tpu/crypto/host/pairing.py: the host path of
Scheme.verify, which the verify service's host fallback
(crypto/hostverify.py) runs when a device backend fails over.
"""

from . import tower as F
from .params import P, X

# Embed E2 (the D-twist) into E(Fp12):  (x', y') -> (x'/w^2, y'/w^3).
# w^-2 and w^-3 as Fp12 constants, computed once.

def _fp2_to_fp12(a):
    return ((a, F.FP2_ZERO, F.FP2_ZERO), F.FP6_ZERO)

_W = (F.FP6_ZERO, F.FP6_ONE)  # w
_WINV = F.fp12_inv(_W)
_WINV2 = F.fp12_sqr(_WINV)
_WINV3 = F.fp12_mul(_WINV2, _WINV)


def _untwist(q):
    """E2(Fp2) affine -> E(Fp12) affine."""
    x, y = q
    return (
        F.fp12_mul(_fp2_to_fp12(x), _WINV2),
        F.fp12_mul(_fp2_to_fp12(y), _WINV3),
    )


def _fp_to_fp12(a):
    return (((a % P, 0), F.FP2_ZERO, F.FP2_ZERO), F.FP6_ZERO)


def miller_loop(p1, q2):
    """f_{|x|, Q}(P) for P in G1 affine, Q in G2 affine (None = infinity -> 1)."""
    if p1 is None or q2 is None:
        return F.FP12_ONE
    xp = _fp_to_fp12(p1[0])
    yp = _fp_to_fp12(p1[1])
    Q = _untwist(q2)
    T = Q
    f = F.FP12_ONE
    n = -X  # positive loop count
    bits = bin(n)[3:]  # skip leading 1
    for b in bits:
        f = F.fp12_sqr(f)
        f = F.fp12_mul(f, _line(T, T, xp, yp))
        T = _ec12_add(T, T)
        if b == "1":
            f = F.fp12_mul(f, _line(T, Q, xp, yp))
            T = _ec12_add(T, Q)
    # x < 0: f_{x,Q} = conj(f_{|x|,Q}) up to final exponentiation
    return F.fp12_conj(f)


def _ec12_add(a, b):
    """Affine addition on E(Fp12): y^2 = x^3 + 4.  Inputs distinct-or-equal,
    never inverses of each other during a Miller loop on prime-order inputs."""
    xa, ya = a
    xb, yb = b
    if xa == xb and ya == yb:
        # doubling
        num = F.fp12_mul(_fp_to_fp12(3), F.fp12_sqr(xa))
        den = F.fp12_mul(_fp_to_fp12(2), ya)
    else:
        num = F.fp12_add(yb, _fp12_neg(ya))
        den = F.fp12_add(xb, _fp12_neg(xa))
    lam = F.fp12_mul(num, F.fp12_inv(den))
    x3 = F.fp12_add(F.fp12_sqr(lam), _fp12_neg(F.fp12_add(xa, xb)))
    y3 = F.fp12_add(F.fp12_mul(lam, F.fp12_add(xa, _fp12_neg(x3))), _fp12_neg(ya))
    return (x3, y3)


def _fp12_neg(a):
    return (F.fp6_neg(a[0]), F.fp6_neg(a[1]))


def _line(a, b, xp, yp):
    """Evaluate the line through points a,b of E(Fp12) at (xp, yp)."""
    xa, ya = a
    xb, yb = b
    if xa == xb and ya == yb:
        num = F.fp12_mul(_fp_to_fp12(3), F.fp12_sqr(xa))
        den = F.fp12_mul(_fp_to_fp12(2), ya)
    else:
        num = F.fp12_add(yb, _fp12_neg(ya))
        den = F.fp12_add(xb, _fp12_neg(xa))
    lam = F.fp12_mul(num, F.fp12_inv(den))
    # l = y_p - y_a - lam*(x_p - x_a)
    return F.fp12_add(
        F.fp12_add(yp, _fp12_neg(ya)),
        _fp12_neg(F.fp12_mul(lam, F.fp12_add(xp, _fp12_neg(xa)))),
    )


def _pow_abs_x(g):
    """g^|x| by square-and-multiply (|x| = 0xd201000000010000, HW 6)."""
    return F.fp12_pow(g, -X)


def _pow_x(g):
    """g^x for cyclotomic g (x < 0: inverse == conjugate)."""
    return F.fp12_conj(_pow_abs_x(g))


def final_exponentiation(f):
    # easy part: f^((p^6-1)(p^2+1))
    f = F.fp12_mul(F.fp12_conj(f), F.fp12_inv(f))
    f = F.fp12_mul(F.fp12_frobenius(f, 2), f)
    # hard part (times 3): f^((x-1)^2 (x+p) (x^2+p^2-1)) * f^3
    e1 = F.fp12_mul(_pow_x(f), F.fp12_conj(f))          # f^(x-1)
    e1 = F.fp12_mul(_pow_x(e1), F.fp12_conj(e1))        # f^((x-1)^2)
    e2 = F.fp12_mul(_pow_x(e1), F.fp12_frobenius(e1, 1))  # e1^(x+p)
    e3 = F.fp12_mul(
        F.fp12_mul(_pow_x(_pow_x(e2)), F.fp12_frobenius(e2, 2)),
        F.fp12_conj(e2),
    )  # e2^(x^2+p^2-1)
    return F.fp12_mul(e3, F.fp12_mul(F.fp12_sqr(f), f))


def pairing(p1, q2):
    """Full pairing e(P, Q) with final exponentiation."""
    return final_exponentiation(miller_loop(p1, q2))


def multi_pairing(pairs):
    """prod_i e(P_i, Q_i) with a single shared final exponentiation."""
    f = F.FP12_ONE
    for p1, q2 in pairs:
        f = F.fp12_mul(f, miller_loop(p1, q2))
    return final_exponentiation(f)


def pairing_check(pairs):
    """True iff prod_i e(P_i, Q_i) == 1."""
    return F.fp12_is_one(multi_pairing(pairs))
