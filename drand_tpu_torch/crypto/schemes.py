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
from dataclasses import dataclass
from typing import Optional

from .host import curve as C
from .host import h2c as H2C
from .host import serialize as S
from .host.params import DST_G2

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
