"""The three drand beacon schemes.

Counterpart of drand_tpu/crypto/schemes.py (drand crypto/schemes.go:46-204):

  pedersen-bls-chained    keys G1 (48 B), sigs G2 (96 B), H(prevSig || round)
  pedersen-bls-unchained  keys G1 (48 B), sigs G2 (96 B), H(round)
  bls-unchained-on-g1     keys G2 (96 B), sigs G1 (48 B), H(round)

The digest H is SHA-256, the round 8 bytes big-endian.  DST quirk: this era's
kyber-bls12381 hashes G1 signatures with the G2-suite DST string,
"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_NUL_"; the League of Entropy
mainnet vectors verify only with it.
"""

import hashlib
import secrets
from dataclasses import dataclass
from typing import Optional

from .host import curve as C
from .host import h2c as H2C
from .host import serialize as S
from .host.pairing import pairing_check
from .host.params import DST_G2, R

DEFAULT_SCHEME_ID = "pedersen-bls-chained"
UNCHAINED_SCHEME_ID = "pedersen-bls-unchained"
SHORT_SIG_SCHEME_ID = "bls-unchained-on-g1"


class GroupG1:
    name = "bls12-381.G1"
    point_len = 48
    curve = C.G1
    to_bytes = staticmethod(S.g1_to_bytes)
    from_bytes = staticmethod(S.g1_from_bytes)
    hash_to_curve = staticmethod(H2C.hash_to_curve_g1)


class GroupG2:
    name = "bls12-381.G2"
    point_len = 96
    curve = C.G2
    to_bytes = staticmethod(S.g2_to_bytes)
    from_bytes = staticmethod(S.g2_from_bytes)
    hash_to_curve = staticmethod(H2C.hash_to_curve_g2)


@dataclass(frozen=True)
class Scheme:
    id: str
    sig_group: object
    key_group: object
    chained: bool
    dst: bytes = DST_G2

    def digest_beacon(self, round_: int,
                      prev_sig: Optional[bytes] = None) -> bytes:
        """SHA-256 of prev_sig || round on a chained scheme (a falsy
        prev_sig hashes the round alone), of the round otherwise."""
        h = hashlib.sha256()
        if self.chained and prev_sig:
            h.update(prev_sig)
        h.update(round_.to_bytes(8, "big"))
        return h.digest()

    def sign(self, secret: int, msg: bytes) -> bytes:
        """Host signing (pure Python): the reference for the device path."""
        hp = self.sig_group.hash_to_curve(msg, self.dst)
        return self.sig_group.to_bytes(self.sig_group.curve.mul(hp, secret))

    def verify(self, pub_point, msg: bytes, sig: bytes) -> bool:
        """Verify one signature on the host (pure-Python pairing): the
        verify service's host fallback.  False for a malformed signature
        or a missing key."""
        if pub_point is None:
            return False
        try:
            sp = self.sig_group.from_bytes(sig)
        except (ValueError, AssertionError):
            return False
        if sp is None:
            return False
        hp = self.sig_group.hash_to_curve(msg, self.dst)
        if self.sig_group is GroupG2:
            # pk on G1: e(pk, H(m)) == e(g1, sig)
            return pairing_check([(pub_point, hp), (C.G1.neg(C.G1.gen), sp)])
        # pk on G2: e(H(m), pk) == e(sig, g2)
        return pairing_check([(hp, pub_point), (C.G1.neg(sp), C.G2.gen)])

    def verify_beacon(self, pub_bytes_or_point, round_: int, prev_sig,
                      sig: bytes) -> bool:
        pub = pub_bytes_or_point
        if isinstance(pub, (bytes, bytearray)):
            try:
                pub = self.key_group.from_bytes(bytes(pub))
            except (ValueError, AssertionError):
                return False
        return self.verify(pub, self.digest_beacon(round_, prev_sig), sig)

    def keypair(self, seed: Optional[bytes] = None):
        """(secret scalar, public point); the key lives on key_group."""
        if seed is None:
            s = secrets.randbelow(R - 1) + 1
        else:
            s = int.from_bytes(hashlib.sha512(seed).digest(),
                               "big") % (R - 1) + 1
        return s, self.key_group.curve.mul(self.key_group.curve.gen, s)

    def public_bytes(self, pub_point) -> bytes:
        return self.key_group.to_bytes(pub_point)


def randomness_from_signature(sig: bytes) -> bytes:
    """randomness = SHA256(signature) (drand schemes.go:249-252)."""
    return hashlib.sha256(sig).digest()


_SCHEMES = {
    DEFAULT_SCHEME_ID: Scheme(DEFAULT_SCHEME_ID, GroupG2, GroupG1,
                              chained=True),
    UNCHAINED_SCHEME_ID: Scheme(UNCHAINED_SCHEME_ID, GroupG2, GroupG1,
                                chained=False),
    SHORT_SIG_SCHEME_ID: Scheme(SHORT_SIG_SCHEME_ID, GroupG1, GroupG2,
                                chained=False),
}


def scheme_from_name(name: str) -> Scheme:
    try:
        return _SCHEMES[name]
    except KeyError:
        raise ValueError(f"scheme {name!r} is not ported") from None


def get_scheme_by_id_with_default(id_: str = "") -> Scheme:
    """The scheme of a group file's SchemeID; "" is the default chain's."""
    return scheme_from_name(id_ or DEFAULT_SCHEME_ID)


def list_schemes():
    """The scheme ids, in the reference's order (Control ListSchemes)."""
    return list(_SCHEMES)
