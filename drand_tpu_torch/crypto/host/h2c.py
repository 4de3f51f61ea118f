"""RFC 9380 hash-to-field and hash-to-curve on the host (hashlib + big ints).

The port's own copy of drand_tpu/crypto/host/h2c.py: expand_message_xmd
and hash_to_field_fp / hash_to_field_fp2 feed the device pipeline (the
FIELDS front of batched verification), and hash_to_curve_g1 /
hash_to_curve_g2 are the pure-Python references the device hash-to-curve
is cross-checked against.
Suites: BLS12381G1_XMD:SHA-256_SSWU_RO_ and BLS12381G2_XMD:SHA-256_SSWU_RO_.
"""

import hashlib

from . import field as F
from .params import P, HTF_L, ISO_A1, ISO_B1, ISO_A2, ISO_B2, Z1, Z2
from .curve import G1, G2, g1_clear_cofactor, g2_clear_cofactor
from ._iso_g1 import XNUM, XDEN, YNUM, YDEN
from . import _iso_g2 as ISO2


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    ell = (len_in_bytes + 31) // 32
    assert ell <= 255 and len(dst) <= 255
    dst_prime = dst + bytes([len(dst)])
    z_pad = b"\x00" * 64
    l_i_b = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b + b"\x00" + dst_prime).digest()
    bi = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    out = [bi]
    for i in range(2, ell + 1):
        tmp = bytes(a ^ b for a, b in zip(b0, bi))
        bi = hashlib.sha256(tmp + bytes([i]) + dst_prime).digest()
        out.append(bi)
    return b"".join(out)[:len_in_bytes]


def hash_to_field_fp(msg: bytes, dst: bytes, count: int):
    ub = expand_message_xmd(msg, dst, count * HTF_L)
    return [int.from_bytes(ub[i * HTF_L:(i + 1) * HTF_L], "big") % P
            for i in range(count)]


def hash_to_field_fp2(msg: bytes, dst: bytes, count: int):
    ub = expand_message_xmd(msg, dst, count * 2 * HTF_L)
    out = []
    for i in range(count):
        base = i * 2 * HTF_L
        c0 = int.from_bytes(ub[base:base + HTF_L], "big") % P
        c1 = int.from_bytes(ub[base + HTF_L:base + 2 * HTF_L], "big") % P
        out.append((c0, c1))
    return out


def _sswu_fp(u):
    """map_to_curve_simple_swu onto E1': y^2 = x^3 + A*x + B, Z = Z1."""
    A, B, Z = ISO_A1, ISO_B1, Z1
    u2 = u * u % P
    tv1 = Z * u2 % P
    tv2 = (tv1 * tv1 + tv1) % P
    if tv2 == 0:
        x1 = B * F.fp_inv(Z * A % P) % P
    else:
        x1 = (P - B) * F.fp_inv(A) % P * ((1 + F.fp_inv(tv2)) % P) % P
    gx1 = (pow(x1, 3, P) + A * x1 + B) % P
    x2 = tv1 * x1 % P
    gx2 = (pow(x2, 3, P) + A * x2 + B) % P
    if F.fp_is_square(gx1):
        x, y = x1, F.fp_sqrt(gx1)
    else:
        x, y = x2, F.fp_sqrt(gx2)
    if F.fp_sgn0(u) != F.fp_sgn0(y):
        y = P - y
    return (x, y)


def _affine_add_fp(p, q, A):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1 + A) * F.fp_inv(2 * y1 % P) % P
    else:
        lam = (y2 - y1) * F.fp_inv((x2 - x1) % P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def _horner_fp(coeffs, x):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


def iso_map_g1(p):
    if p is None:
        return None
    x, y = p
    xo = _horner_fp(XNUM, x) * F.fp_inv(_horner_fp(XDEN, x)) % P
    yo = y * _horner_fp(YNUM, x) % P * F.fp_inv(_horner_fp(YDEN, x)) % P
    return (xo, yo)


def hash_to_curve_g1(msg: bytes, dst: bytes):
    u0, u1 = hash_to_field_fp(msg, dst, 2)
    r = _affine_add_fp(_sswu_fp(u0), _sswu_fp(u1), ISO_A1)
    out = g1_clear_cofactor(iso_map_g1(r))
    assert G1.is_on_curve(out)
    return out


def _sswu_fp2(u):
    """map_to_curve_simple_swu onto E2': y^2 = x^3 + A*x + B over Fp2,
    Z = Z2."""
    A, B, Z = ISO_A2, ISO_B2, Z2
    tv1 = F.fp2_mul(Z, F.fp2_sqr(u))
    tv2 = F.fp2_add(F.fp2_sqr(tv1), tv1)
    if F.fp2_is_zero(tv2):
        x1 = F.fp2_mul(B, F.fp2_inv(F.fp2_mul(Z, A)))
    else:
        x1 = F.fp2_mul(F.fp2_mul(F.fp2_neg(B), F.fp2_inv(A)),
                       F.fp2_add(F.FP2_ONE, F.fp2_inv(tv2)))

    def g(x):
        return F.fp2_add(F.fp2_add(F.fp2_mul(F.fp2_sqr(x), x),
                                   F.fp2_mul(A, x)), B)

    x2 = F.fp2_mul(tv1, x1)
    if F.fp2_is_square(g(x1)):
        x, y = x1, F.fp2_sqrt(g(x1))
    else:
        x, y = x2, F.fp2_sqrt(g(x2))
    if F.fp2_sgn0(u) != F.fp2_sgn0(y):
        y = F.fp2_neg(y)
    return (x, y)


def _affine_add_fp2(p, q, A):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if F.fp2_eq(x1, x2):
        if F.fp2_is_zero(F.fp2_add(y1, y2)):
            return None
        lam = F.fp2_mul(F.fp2_add(F.fp2_scalar(F.fp2_sqr(x1), 3), A),
                        F.fp2_inv(F.fp2_add(y1, y1)))
    else:
        lam = F.fp2_mul(F.fp2_sub(y2, y1), F.fp2_inv(F.fp2_sub(x2, x1)))
    x3 = F.fp2_sub(F.fp2_sub(F.fp2_sqr(lam), x1), x2)
    y3 = F.fp2_sub(F.fp2_mul(lam, F.fp2_sub(x1, x3)), y1)
    return (x3, y3)


def _horner_fp2(coeffs, x):
    acc = F.FP2_ZERO
    for c in reversed(coeffs):
        acc = F.fp2_add(F.fp2_mul(acc, x), c)
    return acc


def iso_map_g2(p):
    """Map a point on E2' to E2 by the 3-isogeny."""
    if p is None:
        return None
    x, y = p
    xo = F.fp2_mul(_horner_fp2(ISO2.XNUM, x),
                   F.fp2_inv(_horner_fp2(ISO2.XDEN, x)))
    yo = F.fp2_mul(y, F.fp2_mul(_horner_fp2(ISO2.YNUM, x),
                                F.fp2_inv(_horner_fp2(ISO2.YDEN, x))))
    return (xo, yo)


def hash_to_curve_g2(msg: bytes, dst: bytes):
    u0, u1 = hash_to_field_fp2(msg, dst, 2)
    r = _affine_add_fp2(_sswu_fp2(u0), _sswu_fp2(u1), ISO_A2)
    out = g2_clear_cofactor(iso_map_g2(r))
    assert G2.is_on_curve(out)
    return out
