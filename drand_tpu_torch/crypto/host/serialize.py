"""BLS12-381 point serialization (ZCash compressed format), pure Python.

The port's own copy of drand_tpu/crypto/host/serialize.py without the native
C fast path.  G1: 48 bytes, G2: 96 bytes (x.c1 || x.c0).  Byte 0 top bits:
  0x80 compression flag (always set here)
  0x40 infinity flag
  0x20 sign flag: set iff y is the lexicographically larger of {y, -y}
"""

from . import field as F
from .params import P
from .curve import G1, G2


def y_is_larger_fp(y):
    return y > (P - 1) // 2


def y_is_larger_fp2(y):
    c0, c1 = y
    if c1 != 0:
        return c1 > (P - 1) // 2
    return c0 > (P - 1) // 2


def g1_to_bytes(p):
    if p is None:
        out = bytearray(48)
        out[0] = 0xC0
        return bytes(out)
    x, y = p
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= 0x80
    if y_is_larger_fp(y):
        out[0] |= 0x20
    return bytes(out)


def g1_from_bytes(b: bytes, check_subgroup=True):
    if len(b) != 48:
        raise ValueError("G1 compressed point must be 48 bytes")
    flags = b[0]
    if not flags & 0x80:
        raise ValueError("only compressed points supported")
    if flags & 0x40:
        return None
    x = int.from_bytes(bytes([b[0] & 0x1F]) + b[1:], "big")
    if x >= P:
        raise ValueError("x out of range")
    y = F.fp_sqrt((pow(x, 3, P) + 4) % P)
    if y is None:
        raise ValueError("x is not on the curve")
    if bool(flags & 0x20) != y_is_larger_fp(y):
        y = P - y
    pt = (x, y)
    if check_subgroup and not G1.in_subgroup(pt):
        raise ValueError("point not in G1 subgroup")
    return pt


def g2_to_bytes(p):
    if p is None:
        out = bytearray(96)
        out[0] = 0xC0
        return bytes(out)
    (x0, x1), y = p
    out = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    out[0] |= 0x80
    if y_is_larger_fp2(y):
        out[0] |= 0x20
    return bytes(out)


def g2_from_bytes(b: bytes, check_subgroup=True):
    if len(b) != 96:
        raise ValueError("G2 compressed point must be 96 bytes")
    flags = b[0]
    if not flags & 0x80:
        raise ValueError("only compressed points supported")
    if flags & 0x40:
        return None
    x1 = int.from_bytes(bytes([b[0] & 0x1F]) + b[1:48], "big")
    x0 = int.from_bytes(b[48:], "big")
    if x0 >= P or x1 >= P:
        raise ValueError("x out of range")
    x = (x0, x1)
    y2 = F.fp2_add(F.fp2_mul(F.fp2_sqr(x), x), (4, 4))
    y = F.fp2_sqrt(y2)
    if y is None:
        raise ValueError("x is not on the curve")
    if bool(flags & 0x20) != y_is_larger_fp2(y):
        y = F.fp2_neg(y)
    pt = (x, y)
    if check_subgroup and not G2.in_subgroup(pt):
        raise ValueError("point not in G2 subgroup")
    return pt
