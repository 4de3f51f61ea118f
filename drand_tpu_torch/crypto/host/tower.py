"""Host-side Fp6 and Fp12 for the pure-Python pairing.

The port's copy of the tower half of drand_tpu/crypto/host/field.py: Fp6 =
Fp2[v]/(v^3 - xi), xi = 1 + u, and Fp12 = Fp6[w]/(w^2 - v), with the
Frobenius maps over field.FROB.  Pure-Python big ints; it serves
host/pairing.py, the service's host fallback.
"""

from .field import (FP2_ONE, FP2_ZERO, FROB, fp_add, fp_sub, fp2_add,
                    fp2_conj, fp2_inv, fp2_is_zero, fp2_mul, fp2_neg,
                    fp2_sqr, fp2_sub)

FP6_ZERO = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE = (FP2_ONE, FP2_ZERO, FP2_ZERO)


def fp2_mul_xi(a):
    """(c0 + c1 u)(1 + u) = (c0 - c1) + (c0 + c1) u."""
    return (fp_sub(a[0], a[1]), fp_add(a[0], a[1]))


def fp6_add(a, b):
    return (fp2_add(a[0], b[0]), fp2_add(a[1], b[1]), fp2_add(a[2], b[2]))


def fp6_sub(a, b):
    return (fp2_sub(a[0], b[0]), fp2_sub(a[1], b[1]), fp2_sub(a[2], b[2]))


def fp6_neg(a):
    return (fp2_neg(a[0]), fp2_neg(a[1]), fp2_neg(a[2]))


def fp6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fp2_mul(a0, b0)
    t1 = fp2_mul(a1, b1)
    t2 = fp2_mul(a2, b2)
    # c0 = t0 + xi*((a1+a2)(b1+b2) - t1 - t2)
    c0 = fp2_add(t0, fp2_mul_xi(fp2_sub(fp2_sub(fp2_mul(fp2_add(a1, a2), fp2_add(b1, b2)), t1), t2)))
    # c1 = (a0+a1)(b0+b1) - t0 - t1 + xi*t2
    c1 = fp2_add(fp2_sub(fp2_sub(fp2_mul(fp2_add(a0, a1), fp2_add(b0, b1)), t0), t1), fp2_mul_xi(t2))
    # c2 = (a0+a2)(b0+b2) - t0 - t2 + t1
    c2 = fp2_add(fp2_sub(fp2_sub(fp2_mul(fp2_add(a0, a2), fp2_add(b0, b2)), t0), t2), t1)
    return (c0, c1, c2)


def fp6_sqr(a):
    return fp6_mul(a, a)


def fp6_mul_by_v(a):
    """a * v: (a0 + a1 v + a2 v^2) v = xi*a2 + a0 v + a1 v^2."""
    return (fp2_mul_xi(a[2]), a[0], a[1])


def fp6_inv(a):
    a0, a1, a2 = a
    c0 = fp2_sub(fp2_sqr(a0), fp2_mul_xi(fp2_mul(a1, a2)))
    c1 = fp2_sub(fp2_mul_xi(fp2_sqr(a2)), fp2_mul(a0, a1))
    c2 = fp2_sub(fp2_sqr(a1), fp2_mul(a0, a2))
    t = fp2_add(fp2_mul_xi(fp2_add(fp2_mul(a1, c2), fp2_mul(a2, c1))), fp2_mul(a0, c0))
    tinv = fp2_inv(t)
    return (fp2_mul(c0, tinv), fp2_mul(c1, tinv), fp2_mul(c2, tinv))


def fp6_is_zero(a):
    return all(fp2_is_zero(c) for c in a)


# ---------------------------------------------------------------------------
# Fp12 = Fp6[w]/(w^2 - v)
# ---------------------------------------------------------------------------

FP12_ONE = (FP6_ONE, FP6_ZERO)


def fp12_add(a, b):
    return (fp6_add(a[0], b[0]), fp6_add(a[1], b[1]))


def fp12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fp6_mul(a0, b0)
    t1 = fp6_mul(a1, b1)
    c0 = fp6_add(t0, fp6_mul_by_v(t1))
    c1 = fp6_sub(fp6_sub(fp6_mul(fp6_add(a0, a1), fp6_add(b0, b1)), t0), t1)
    return (c0, c1)


def fp12_sqr(a):
    a0, a1 = a
    t = fp6_mul(a0, a1)
    c0 = fp6_mul(fp6_add(a0, a1), fp6_add(a0, fp6_mul_by_v(a1)))
    c0 = fp6_sub(fp6_sub(c0, t), fp6_mul_by_v(t))
    return (c0, fp6_add(t, t))


def fp12_conj(a):
    """Conjugation = raising to p^6: (a0, a1) -> (a0, -a1)."""
    return (a[0], fp6_neg(a[1]))


def fp12_inv(a):
    a0, a1 = a
    t = fp6_sub(fp6_sqr(a0), fp6_mul_by_v(fp6_sqr(a1)))
    tinv = fp6_inv(t)
    return (fp6_mul(a0, tinv), fp6_neg(fp6_mul(a1, tinv)))


def fp12_pow(a, e):
    if e < 0:
        return fp12_pow(fp12_inv(a), -e)
    out = FP12_ONE
    base = a
    while e:
        if e & 1:
            out = fp12_mul(out, base)
        base = fp12_sqr(base)
        e >>= 1
    return out


def fp12_eq(a, b):
    return a == b


def fp12_is_one(a):
    return a == FP12_ONE


def _fp2_frob(a, j):
    """a^(p^j) in Fp2: conjugate iff j odd."""
    return fp2_conj(a) if j & 1 else a


def fp12_frobenius(a, j=1):
    """a^(p^j) for j in {1,2,3} using precomputed gamma coefficients.

    Write a = sum_{i=0..5} c_i * w^i with c_i in Fp2 (w^2=v, v^3=xi).
    Then a^(p^j) = sum c_i^(p^j) * gamma_{j,i} * w^i.
    """
    g = FROB[j]
    (c0, c2, c4), (c1, c3, c5) = a  # a0 = c0 + c2 v + c4 v^2 ; a1 = c1 + c3 v + c5 v^2
    cs = [c0, c1, c2, c3, c4, c5]
    out = [fp2_mul(_fp2_frob(c, j), g[i]) for i, c in enumerate(cs)]
    return ((out[0], out[2], out[4]), (out[1], out[3], out[5]))
