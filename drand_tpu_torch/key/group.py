"""Group: the canonical network configuration artifact.

The port's copy of drand_tpu/key/group.py, unchanged but for its imports.

Reference: key/group.go:30-129 (struct + hash), key/group.go:196-330 (TOML
codec), key/node.go:21-35 (Node).  The group hash pins node set, threshold,
genesis/transition times, collective key and beacon ID; the genesis seed of
a fresh chain IS the group hash (group.go:300-307).

Hash layout parity (group.go:100-129): blake2b-256 over node hashes in index
order, then LE32 threshold, LE64 genesis time, LE64 transition time (only if
non-zero), the DistPublic hash (only if present), and the beacon ID (only if
non-default).
"""

import hashlib
import struct
try:
    import tomllib
except ModuleNotFoundError:   # Python < 3.11: tomli is API-identical
    import tomli as tomllib
from dataclasses import dataclass, field
from typing import List, Optional

from ..common import is_default_beacon_id
from ..crypto.schemes import Scheme, get_scheme_by_id_with_default
from .keys import DistPublic, Identity, minimum_t


def _blake2b256(*parts: bytes) -> bytes:
    h = hashlib.blake2b(digest_size=32)
    for p in parts:
        h.update(p)
    return h.digest()


@dataclass
class Node:
    """Identity + DKG index (key/node.go:21-35)."""

    identity: Identity
    index: int

    def hash(self) -> bytes:
        return _blake2b256(struct.pack("<I", self.index), self.identity.key)

    def equal(self, other: "Node") -> bool:
        return self.index == other.index and self.identity.equal(other.identity)


@dataclass
class Group:
    threshold: int
    period: int                       # seconds
    scheme: Scheme
    nodes: List[Node]
    genesis_time: int
    beacon_id: str = ""
    catchup_period: int = 0           # seconds
    genesis_seed: Optional[bytes] = None
    transition_time: int = 0
    public_key: Optional[DistPublic] = None

    def __len__(self) -> int:
        return len(self.nodes)

    def find(self, ident: Identity) -> Optional[Node]:
        for n in self.nodes:
            if n.identity.equal(ident):
                return n
        return None

    def node(self, index: int) -> Optional[Node]:
        for n in self.nodes:
            if n.index == index:
                return n
        return None

    def hash(self) -> bytes:
        h = hashlib.blake2b(digest_size=32)
        for n in sorted(self.nodes, key=lambda n: n.index):
            h.update(n.hash())
        h.update(struct.pack("<I", self.threshold))
        h.update(struct.pack("<Q", self.genesis_time))
        if self.transition_time != 0:
            h.update(struct.pack("<q", self.transition_time))
        if self.public_key is not None:
            h.update(self.public_key.hash())
        if not is_default_beacon_id(self.beacon_id):
            h.update(self.beacon_id.encode())
        return h.digest()

    def get_genesis_seed(self) -> bytes:
        """Genesis seed; derived from the group hash on first use
        (group.go:300-307)."""
        if self.genesis_seed is None:
            self.genesis_seed = self.hash()
        return self.genesis_seed

    # -- TOML codec (group.go:196-299) --------------------------------------

    def to_toml(self) -> str:
        lines = [
            f"Threshold = {self.threshold}",
            f'Period = "{self.period}s"',
            f'CatchupPeriod = "{self.catchup_period}s"',
            f"GenesisTime = {self.genesis_time}",
        ]
        if self.transition_time != 0:
            lines.append(f"TransitionTime = {self.transition_time}")
        if self.genesis_seed is not None:
            lines.append(f'GenesisSeed = "{self.get_genesis_seed().hex()}"')
        lines.append(f'SchemeID = "{self.scheme.id}"')
        lines.append(f'ID = "{self.beacon_id or "default"}"')
        for n in self.nodes:
            lines += [
                "",
                "[[Nodes]]",
                f'  Address = "{n.identity.addr}"',
                f'  Key = "{n.identity.key.hex()}"',
                f"  TLS = {str(n.identity.tls).lower()}",
                f'  Signature = "{(n.identity.signature or b"").hex()}"',
                f"  Index = {n.index}",
            ]
        if self.public_key is not None:
            lines += ["", "[PublicKey]", "  Coefficients = ["]
            for c in self.public_key.coefficients:
                lines.append(f'    "{c.hex()}",')
            lines += ["  ]"]
        return "\n".join(lines) + "\n"

    @classmethod
    def from_toml(cls, text: str) -> "Group":
        doc = tomllib.loads(text)
        scheme = get_scheme_by_id_with_default(doc.get("SchemeID", ""))
        nodes = []
        for nt in doc.get("Nodes", []):
            ident = Identity(
                key=bytes.fromhex(nt["Key"]), addr=nt["Address"],
                scheme=scheme, tls=bool(nt.get("TLS", False)),
                signature=bytes.fromhex(nt["Signature"]) if nt.get("Signature") else None)
            nodes.append(Node(identity=ident, index=int(nt["Index"])))
        thr = int(doc["Threshold"])
        if thr < minimum_t(len(nodes)):
            raise ValueError("group file threshold below minimum")
        if thr > len(nodes):
            raise ValueError("group file threshold greater than group size")
        pk = None
        if "PublicKey" in doc:
            pk = DistPublic([bytes.fromhex(c)
                             for c in doc["PublicKey"]["Coefficients"]])
        seed = doc.get("GenesisSeed")
        return cls(
            threshold=thr,
            period=_parse_seconds(doc["Period"]),
            catchup_period=_parse_seconds(doc.get("CatchupPeriod", "0s")),
            scheme=scheme,
            nodes=nodes,
            genesis_time=int(doc["GenesisTime"]),
            transition_time=int(doc.get("TransitionTime", 0)),
            genesis_seed=bytes.fromhex(seed) if seed else None,
            public_key=pk,
            beacon_id=doc.get("ID", ""),
        )


def _parse_seconds(s) -> int:
    """Duration string -> seconds ("30s", "1m30s", "2m"; bare int = seconds)."""
    if isinstance(s, int):
        return s
    s = s.strip()
    total, num = 0, ""
    for ch in s:
        if ch.isdigit():
            num += ch
        elif ch == "m":
            total += int(num or 0) * 60
            num = ""
        elif ch == "h":
            total += int(num or 0) * 3600
            num = ""
        elif ch == "s":
            total += int(num or 0)
            num = ""
        else:
            raise ValueError(f"bad duration {s!r}")
    if num:
        total += int(num)
    return total


def new_group(identities: List[Identity], threshold: int, genesis: int,
              period: int, catchup_period: int, scheme: Scheme,
              beacon_id: str = "") -> Group:
    """Build a group with indices = positions in the sorted identity list
    (group.go:318-330)."""
    idents = sorted(identities, key=lambda i: i.key.hex())
    nodes = [Node(identity=ident, index=i) for i, ident in enumerate(idents)]
    return Group(threshold=threshold, period=period,
                 catchup_period=catchup_period, scheme=scheme, nodes=nodes,
                 genesis_time=genesis, beacon_id=beacon_id)
