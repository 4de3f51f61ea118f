"""Beacon: the unit of the randomness chain.

The port's copy of drand_tpu/chain/beacon.py, unchanged but for its imports.

Reference: chain/beacon.go:15-65 (type + hexjson codec + randomness),
chain/store.go:95-101 (genesis beacon).
"""

import json
from dataclasses import dataclass, field
from typing import Optional

from ..crypto.schemes import randomness_from_signature


@dataclass(frozen=True)
class Beacon:
    """`{previous_sig, round, signature}`; signature is the BLS signature
    over the scheme's digest of (round, previous_sig)."""

    round: int
    signature: bytes
    previous_sig: Optional[bytes] = field(default=None)

    def randomness(self) -> bytes:
        """SHA-256 of the signature (chain/beacon.go:43)."""
        return randomness_from_signature(self.signature)

    # -- hexjson codec (storage value format, chain/beacon.go:32-39) --------

    def to_json(self) -> bytes:
        obj = {
            "PreviousSig": self.previous_sig.hex() if self.previous_sig else None,
            "Round": self.round,
            "Signature": self.signature.hex() if self.signature else None,
        }
        return json.dumps(obj, separators=(",", ":")).encode()

    @classmethod
    def from_json(cls, data: bytes) -> "Beacon":
        obj = json.loads(data)
        prev = obj.get("PreviousSig")
        sig = obj.get("Signature")
        return cls(
            round=int(obj["Round"]),
            signature=bytes.fromhex(sig) if sig else b"",
            previous_sig=bytes.fromhex(prev) if prev else None,
        )

    def __str__(self):
        short = lambda b: b[:3].hex() if b else "nil"
        return (f"{{ round: {self.round}, sig: {short(self.signature)}, "
                f"prevSig: {short(self.previous_sig)} }}")


def genesis_beacon(genesis_seed: bytes) -> Beacon:
    """Round-0 beacon carrying the genesis seed as its signature
    (chain/store.go:95-101)."""
    return Beacon(round=0, signature=genesis_seed)
