"""Keypairs, identities, DKG shares, distributed public keys.

The port's copy of drand_tpu/key/keys.py, unchanged but for its imports.

Reference: key/keys.go:20-127 (Pair/Identity + self-signed proof of
possession), keys.go:283-461 (Share/DistPublic).  Identity hashes use
blake2b-256 over the public key bytes only — the address/TLS fields may
change while the node keeps its key (keys.go:50-57).
"""

import hashlib
from dataclasses import dataclass, field, replace
from typing import List, Optional

from ..crypto import schnorr
from ..crypto.schemes import Scheme
from ..crypto.host.tbls import PriShare, PubPoly


def _blake2b256(*parts: bytes) -> bytes:
    h = hashlib.blake2b(digest_size=32)
    for p in parts:
        h.update(p)
    return h.digest()


def minimum_t(n: int) -> int:
    """Default/minimum threshold: floor(n/2) + 1 (keys.go:464-470)."""
    return n // 2 + 1


@dataclass
class Identity:
    """Public half of a node: key + reachable address + self-signature."""

    key: bytes                  # compressed point on scheme.key_group
    addr: str
    scheme: Scheme
    tls: bool = False
    signature: Optional[bytes] = None

    def address(self) -> str:
        return self.addr

    def hash(self) -> bytes:
        """Input to the self-signature; covers the key only (keys.go:50-57)."""
        return _blake2b256(self.key)

    def valid_signature(self) -> bool:
        """Check the proof of possession (keys.go:61-66)."""
        if not self.signature:
            return False
        try:
            pub = self.scheme.key_group.from_bytes(self.key)
        except (ValueError, AssertionError):
            return False
        # AuthScheme == plain BLS with the long-term key (schemes.go:102)
        return self.scheme.verify(pub, self.hash(), self.signature)

    def equal(self, other: "Identity") -> bool:
        return (self.addr == other.addr and self.tls == other.tls
                and self.key == other.key)


@dataclass
class Pair:
    """Private/public long-term node keypair (keys.go:20-24)."""

    key: int                    # scalar on scheme.key_group
    public: Identity

    def self_sign(self) -> None:
        """Attach the proof of possession (keys.go:81-89)."""
        self.public.signature = self.public.scheme.sign(
            self.key, self.public.hash())


def new_keypair(address: str, scheme: Scheme, tls: bool = False,
                seed: Optional[bytes] = None) -> Pair:
    """Fresh self-signed keypair bound to an address (keys.go:92-127)."""
    sec, pub_point = scheme.keypair(seed=seed)
    ident = Identity(key=scheme.public_bytes(pub_point), addr=address,
                     scheme=scheme, tls=tls)
    pair = Pair(key=sec, public=ident)
    pair.self_sign()
    return pair


@dataclass
class DistPublic:
    """Commitments of the collective polynomial; coefficient 0 is *the*
    public key (keys.go:381-461)."""

    coefficients: List[bytes]

    def key(self) -> bytes:
        return self.coefficients[0]

    def pub_poly(self, scheme: Scheme) -> PubPoly:
        group = scheme.key_group
        return PubPoly(group, [group.from_bytes(c) for c in self.coefficients])

    def hash(self) -> bytes:
        return _blake2b256(*self.coefficients)

    def equal(self, other: "DistPublic") -> bool:
        return self.coefficients == other.coefficients


@dataclass
class Share:
    """A node's private output of the DKG (keys.go:283-312): its secret
    share plus the public commitments."""

    scheme: Scheme
    private: PriShare
    commits: List[bytes]        # compressed points (public polynomial)

    def pub_poly(self) -> PubPoly:
        group = self.scheme.key_group
        return PubPoly(group, [group.from_bytes(c) for c in self.commits])

    def public(self) -> DistPublic:
        return DistPublic(list(self.commits))


# -- Schnorr DKG-packet auth over the key group (schemes.go:81-87,103) -------

def dkg_auth_sign(scheme: Scheme, secret: int, msg: bytes) -> bytes:
    return schnorr.sign(scheme.key_group, secret, msg)


def dkg_auth_verify(scheme: Scheme, pub_bytes: bytes, msg: bytes,
                    sig: bytes) -> bool:
    return schnorr.verify(scheme.key_group, pub_bytes, msg, sig)
