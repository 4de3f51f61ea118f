"""Chain info: the public root of trust clients pin (chain/info.go:19-72).

The port's copy of drand_tpu/chain/info.py, unchanged but for its imports.

`hash()` is the canonical *chain hash*: SHA256(be32(period) || be64(genesis)
|| pubkey_bytes || genesis_seed [|| beacon_id if non-default]).  It is
constant for the life of a chain, across reshares.
"""

import hashlib
import json
import struct
from dataclasses import dataclass, field
from typing import Optional

from ..common import compare_beacon_ids, is_default_beacon_id


@dataclass(frozen=True)
class Info:
    public_key: bytes          # compressed point on the scheme's key group
    period: int                # seconds
    genesis_time: int          # UNIX seconds
    genesis_seed: bytes
    scheme: str
    beacon_id: str = field(default="")

    def hash(self) -> bytes:
        h = hashlib.sha256()
        h.update(struct.pack(">I", self.period))
        h.update(struct.pack(">q", self.genesis_time))
        h.update(self.public_key)
        h.update(self.genesis_seed)
        if not is_default_beacon_id(self.beacon_id):
            h.update(self.beacon_id.encode())
        return h.digest()

    def hash_string(self) -> str:
        return self.hash().hex()

    def equal(self, other: "Info") -> bool:
        return (self.genesis_time == other.genesis_time
                and self.period == other.period
                and self.public_key == other.public_key
                and self.genesis_seed == other.genesis_seed
                and compare_beacon_ids(self.beacon_id, other.beacon_id))

    # -- JSON codec (public REST /info format) ------------------------------

    def to_json(self) -> bytes:
        obj = {
            "public_key": self.public_key.hex(),
            "period": self.period,
            "genesis_time": self.genesis_time,
            "hash": self.hash_string(),
            "groupHash": self.genesis_seed.hex(),
            "schemeID": self.scheme,
            "metadata": {"beaconID": self.beacon_id or "default"},
        }
        return json.dumps(obj, separators=(",", ":")).encode()

    @classmethod
    def from_json(cls, data: bytes) -> "Info":
        obj = json.loads(data)
        info = cls(
            public_key=bytes.fromhex(obj["public_key"]),
            period=int(obj["period"]),
            genesis_time=int(obj["genesis_time"]),
            genesis_seed=bytes.fromhex(obj["groupHash"]),
            scheme=obj.get("schemeID", "pedersen-bls-chained"),
            beacon_id=obj.get("metadata", {}).get("beaconID", ""),
        )
        want = obj.get("hash")
        if want and want != info.hash_string():
            raise ValueError("chain info hash mismatch")
        return info
