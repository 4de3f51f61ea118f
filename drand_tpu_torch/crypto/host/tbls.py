"""Threshold BLS on the host: Shamir shares, partial signatures, Lagrange
coefficients.

The port's own copy of the host parts of drand_tpu/crypto/tbls.py (kyber
sign/tbls wire format): a partial signature is be16(share index) || BLS
signature, and share index i is the polynomial evaluated at x = i + 1.
The port has no host pairing, so partial verification and recovery run
only batched on the device (crypto/partials.py, crypto/batch.py).
"""

import secrets
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from .params import R


@dataclass(frozen=True)
class PriShare:
    index: int
    value: int  # scalar mod R


@dataclass
class PriPoly:
    """Secret-sharing polynomial of degree t-1; coeffs[0] is the secret."""
    coeffs: List[int]

    @classmethod
    def random(cls, threshold: int, secret: Optional[int] = None):
        coeffs = [secret if secret is not None else secrets.randbelow(R)]
        coeffs += [secrets.randbelow(R) for _ in range(threshold - 1)]
        return cls(coeffs)

    def eval(self, index: int) -> PriShare:
        x = index + 1
        acc = 0
        for c in reversed(self.coeffs):
            acc = (acc * x + c) % R
        return PriShare(index, acc)

    def shares(self, n: int) -> List[PriShare]:
        return [self.eval(i) for i in range(n)]

    def secret(self) -> int:
        return self.coeffs[0]

    def commit(self, group) -> "PubPoly":
        g = group.curve
        return PubPoly(group, [g.mul(g.gen, c) for c in self.coeffs])


@dataclass
class PubPoly:
    """Commitments to a PriPoly on a group; commits[0] is the public key.
    Public shares are memoized per index (the commits are never mutated)."""
    group: object
    commits: List[object]
    _eval_cache: Dict[int, object] = field(default_factory=dict, init=False,
                                           repr=False, compare=False)

    @property
    def threshold(self) -> int:
        return len(self.commits)

    def public_key(self):
        return self.commits[0]

    def eval(self, index: int):
        """Public counterpart of share index: sum_j commits[j] * (i+1)^j."""
        cached = self._eval_cache.get(index)
        if cached is not None:
            return cached
        x = index + 1
        g = self.group.curve
        acc = None
        xp = 1
        for c in self.commits:
            acc = g.add(acc, g.mul(c, xp))
            xp = xp * x % R
        self._eval_cache[index] = acc
        return acc

    def prime(self, points: Dict[int, object]) -> None:
        """Prefill the eval memo with public shares computed elsewhere."""
        self._eval_cache.update(points)

    def to_bytes(self) -> bytes:
        return b"".join(self.group.to_bytes(c) for c in self.commits)

    @classmethod
    def from_bytes(cls, group, data: bytes) -> "PubPoly":
        n = group.point_len
        assert len(data) % n == 0
        return cls(group, [group.from_bytes(data[i:i + n])
                           for i in range(0, len(data), n)])


def sign_partial(scheme, share: PriShare, msg: bytes) -> bytes:
    """tbls.Sign: be16(index) || BLS_sign(share.value, msg)."""
    return share.index.to_bytes(2, "big") + scheme.sign(share.value, msg)


def index_of(partial: bytes) -> int:
    """tbls.IndexOf: the signer index of a partial signature."""
    return int.from_bytes(partial[:2], "big")


def _lagrange_coeff(indices: Sequence[int], i: int) -> int:
    """lambda_i for interpolation at 0 over the points x_j = index_j + 1."""
    num, den = 1, 1
    xi = i + 1
    for j in indices:
        if j == i:
            continue
        xj = j + 1
        num = num * xj % R
        den = den * ((xj - xi) % R) % R
    return num * pow(den, R - 2, R) % R
