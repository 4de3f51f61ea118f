"""Host-side BLS12-381 field math the port needs: Fp, Fp2 and the Frobenius
constants of the Fp12 tower.

The port's own copy of the Fp/Fp2 part of drand_tpu/crypto/host/field.py
(pure-Python big ints).  It serves public-key decoding (G2 decompression and
its subgroup check), the host signing used to cross-check the device path,
and the Frobenius coefficients the device tower encodes once.

Representation:
  Fp   : int in [0, p)
  Fp2  : (c0, c1)   c0 + c1*u,  u^2 = -1
Tower above Fp2 (device side only): v^3 = xi = 1 + u, w^2 = v.
"""

from .params import P

# ---------------------------------------------------------------------------
# Fp
# ---------------------------------------------------------------------------


def fp_add(a, b):
    c = a + b
    return c - P if c >= P else c


def fp_sub(a, b):
    c = a - b
    return c + P if c < 0 else c


def fp_mul(a, b):
    return a * b % P


def fp_neg(a):
    return P - a if a else 0


def fp_inv(a):
    return pow(a, P - 2, P)


def fp_sqrt(a):
    """Square root for p = 3 mod 4; returns None if a is not a QR."""
    s = pow(a, (P + 1) // 4, P)
    return s if s * s % P == a else None


def fp_is_square(a):
    return a == 0 or pow(a, (P - 1) // 2, P) == 1


def fp_sgn0(a):
    return a & 1


# ---------------------------------------------------------------------------
# Fp2 = Fp[u]/(u^2+1)
# ---------------------------------------------------------------------------

FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)


def fp2_add(a, b):
    return (fp_add(a[0], b[0]), fp_add(a[1], b[1]))


def fp2_sub(a, b):
    return (fp_sub(a[0], b[0]), fp_sub(a[1], b[1]))


def fp2_neg(a):
    return (fp_neg(a[0]), fp_neg(a[1]))


def fp2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0
    t1 = a1 * b1
    t2 = (a0 + a1) * (b0 + b1) - t0 - t1
    return ((t0 - t1) % P, t2 % P)


def fp2_sqr(a):
    a0, a1 = a
    return ((a0 + a1) * (a0 - a1) % P, 2 * a0 * a1 % P)


def fp2_scalar(a, k):
    return (a[0] * k % P, a[1] * k % P)


def fp2_conj(a):
    return (a[0], fp_neg(a[1]))


def fp2_inv(a):
    a0, a1 = a
    norm = (a0 * a0 + a1 * a1) % P
    ninv = fp_inv(norm)
    return (a0 * ninv % P, (P - a1) * ninv % P if a1 else 0)


def fp2_is_zero(a):
    return a[0] == 0 and a[1] == 0


def fp2_eq(a, b):
    return a[0] == b[0] and a[1] == b[1]


def fp2_pow(a, e):
    out = FP2_ONE
    base = a
    while e:
        if e & 1:
            out = fp2_mul(out, base)
        base = fp2_sqr(base)
        e >>= 1
    return out


def fp2_is_square(a):
    """a is a square in Fp2 iff its norm is a square in Fp."""
    return fp_is_square((a[0] * a[0] + a[1] * a[1]) % P)


def fp2_sgn0(a):
    """RFC 9380 sgn0 for m = 2 (little-endian lexicographic parity)."""
    return (a[0] & 1) | (int(a[0] == 0) & (a[1] & 1))


def fp2_sqrt(a):
    """Square root in Fp2 for p = 3 mod 4 via the norm trick; None if
    a is not a square."""
    a0, a1 = a
    if a1 == 0:
        s = fp_sqrt(a0)
        if s is not None:
            return (s, 0)
        s = fp_sqrt(fp_neg(a0))
        if s is None:
            return None
        return (0, s)
    norm = (a0 * a0 + a1 * a1) % P
    d = fp_sqrt(norm)
    if d is None:
        return None
    inv2 = (P + 1) // 2
    x2 = (a0 + d) * inv2 % P
    x = fp_sqrt(x2)
    if x is None:
        x2 = (a0 - d) * inv2 % P
        x = fp_sqrt(x2)
        if x is None:
            return None
    y = a1 * fp_inv(2 * x % P) % P
    return (x, y)


# ---------------------------------------------------------------------------
# Frobenius coefficients of the Fp12 tower
# ---------------------------------------------------------------------------

XI = (1, 1)


def _compute_frob_coeffs():
    """gamma_{j,i} = xi^(i*(p^j-1)/6) for the w-coefficient twists."""
    coeffs = {}
    for j in (1, 2, 3):
        pj = P**j
        coeffs[j] = [fp2_pow(XI, i * (pj - 1) // 6) for i in range(6)]
    return coeffs


FROB = _compute_frob_coeffs()
