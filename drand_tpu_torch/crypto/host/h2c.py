"""RFC 9380 hash-to-field and hash-to-G1 on the host (hashlib + big ints).

The port's own copy of the G1 parts of drand_tpu/crypto/host/h2c.py:
expand_message_xmd / hash_to_field_fp feed the device pipeline (the FIELDS
front of batched verification), and hash_to_curve_g1 is the pure-Python
reference the device hash-to-G1 is cross-checked against.
Suite: BLS12381G1_XMD:SHA-256_SSWU_RO_.
"""

import hashlib

from . import field as F
from .params import P, HTF_L, ISO_A1, ISO_B1, Z1
from .curve import G1, g1_clear_cofactor
from ._iso_g1 import XNUM, XDEN, YNUM, YDEN


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
