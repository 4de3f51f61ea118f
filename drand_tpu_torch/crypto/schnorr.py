"""Schnorr signatures over a scheme's key group (DKG packet auth).

The port's own copy of drand_tpu/crypto/schnorr.py over the port's host
groups (crypto/schemes.py GroupG1 / GroupG2).  drand authenticates DKG
packets with kyber/sign/schnorr over the scheme's key group
(crypto/schemes.go:81-87,103).  Scalar-only host math: this path is
control-plane, never batched.

sig = R_bytes || be32(s)  where  R = g^k,  c = SHA256(R || pub || msg) mod r,
s = k + c·x mod r.
"""

import hashlib
import secrets

from .host.params import R


def _challenge(group, R_bytes: bytes, pub_bytes: bytes, msg: bytes) -> int:
    h = hashlib.sha256()
    h.update(R_bytes)
    h.update(pub_bytes)
    h.update(msg)
    return int.from_bytes(h.digest(), "big") % R


def sign(group, secret: int, msg: bytes) -> bytes:
    g = group.curve
    k = secrets.randbelow(R - 1) + 1
    R_pt = g.mul(g.gen, k)
    R_bytes = group.to_bytes(R_pt)
    pub_bytes = group.to_bytes(g.mul(g.gen, secret))
    c = _challenge(group, R_bytes, pub_bytes, msg)
    s = (k + c * secret) % R
    return R_bytes + s.to_bytes(32, "big")


def verify(group, pub_bytes: bytes, msg: bytes, sig: bytes) -> bool:
    g = group.curve
    plen = group.point_len
    if len(sig) != plen + 32:
        return False
    R_bytes, s_bytes = sig[:plen], sig[plen:]
    try:
        R_pt = group.from_bytes(R_bytes)
        pub = group.from_bytes(pub_bytes)
    except (ValueError, AssertionError):
        return False
    s = int.from_bytes(s_bytes, "big")
    if s >= R:
        return False
    c = _challenge(group, R_bytes, pub_bytes, msg)
    # g^s == R + c·pub
    lhs = g.mul(g.gen, s)
    rhs = g.add(R_pt, g.mul(pub, c))
    return lhs == rhs
