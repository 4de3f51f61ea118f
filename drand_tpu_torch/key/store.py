"""File-based key/group/share persistence.

Reference: key/store.go:34-177.  Disk layout per beacon:

    <base>/multibeacon/<beaconID>/key/drand_id.private     (0600)
    <base>/multibeacon/<beaconID>/key/drand_id.public
    <base>/multibeacon/<beaconID>/groups/drand_group.toml
    <base>/multibeacon/<beaconID>/share/dist_key.private   (0600)

Private key material is written with owner-only permissions via fs helpers.

The port's copy of drand_tpu/key/store.py, unchanged but for its imports
(`PriShare` from the port's crypto/host/tbls.py).
"""

import os
try:
    import tomllib
except ModuleNotFoundError:   # Python < 3.11: tomli is API-identical
    import tomli as tomllib
from typing import Optional

from .. import fs
from ..common import DEFAULT_BEACON_ID, MULTI_BEACON_FOLDER
from ..crypto.schemes import get_scheme_by_id_with_default
from ..crypto.host.tbls import PriShare
from .group import Group
from .keys import Identity, Pair, Share


class FileStore:
    KEY_FOLDER = "key"
    GROUP_FOLDER = "groups"
    SHARE_FOLDER = "share"
    KEY_FILE = "drand_id"
    GROUP_FILE = "drand_group.toml"
    SHARE_FILE = "dist_key.private"

    # staged reshare output (core/dkg_journal.py pending-transition
    # ledger): the files a successful reshare lands in UNTIL the
    # transition round commits them over the active pair
    STAGED_SUFFIX = ".staged"

    def __init__(self, base_folder: str, beacon_id: str = ""):
        self.beacon_id = beacon_id or DEFAULT_BEACON_ID
        self.base = os.path.join(base_folder, MULTI_BEACON_FOLDER, self.beacon_id)
        self.key_dir = fs.create_secure_folder(os.path.join(self.base, self.KEY_FOLDER))
        self.group_dir = fs.create_secure_folder(os.path.join(self.base, self.GROUP_FOLDER))
        self.share_dir = fs.create_secure_folder(os.path.join(self.base, self.SHARE_FOLDER))
        self.private_key_file = os.path.join(self.key_dir, self.KEY_FILE + ".private")
        self.public_key_file = os.path.join(self.key_dir, self.KEY_FILE + ".public")
        self.group_file = os.path.join(self.group_dir, self.GROUP_FILE)
        self.share_file = os.path.join(self.share_dir, self.SHARE_FILE)
        self.staged_group_file = self.group_file + self.STAGED_SUFFIX
        self.staged_share_file = self.share_file + self.STAGED_SUFFIX

    # -- keypair ------------------------------------------------------------

    def save_keypair(self, pair: Pair) -> None:
        ident = pair.public
        priv = (f'Key = "{pair.key:064x}"\n'
                f'SchemeName = "{ident.scheme.id}"\n')
        fs.write_atomic(self.private_key_file, priv.encode(), secure=True)
        fs.write_atomic(self.public_key_file,
                        self._identity_toml(ident).encode())

    @staticmethod
    def _identity_toml(ident: Identity) -> str:
        return (f'Address = "{ident.addr}"\n'
                f'Key = "{ident.key.hex()}"\n'
                f"TLS = {str(ident.tls).lower()}\n"
                f'Signature = "{(ident.signature or b"").hex()}"\n'
                f'SchemeName = "{ident.scheme.id}"\n')

    def load_keypair(self) -> Pair:
        with open(self.private_key_file, "rb") as f:
            priv = tomllib.load(f)
        ident = self.load_public_identity()
        return Pair(key=int(priv["Key"], 16), public=ident)

    def load_public_identity(self) -> Identity:
        with open(self.public_key_file, "rb") as f:
            doc = tomllib.load(f)
        scheme = get_scheme_by_id_with_default(doc.get("SchemeName", ""))
        return Identity(
            key=bytes.fromhex(doc["Key"]), addr=doc["Address"], scheme=scheme,
            tls=bool(doc.get("TLS", False)),
            signature=bytes.fromhex(doc["Signature"]) if doc.get("Signature") else None)

    # -- group --------------------------------------------------------------

    def save_group(self, group: Group, staged: bool = False) -> None:
        """Atomic (temp + fsync + rename): a crash mid-save leaves the old
        group intact instead of a torn TOML that bricks the node on the
        next load.  `staged=True` writes the reshare staging slot instead
        of the active file (the pending-transition ledger commits it)."""
        path = self.staged_group_file if staged else self.group_file
        fs.write_atomic(path, group.to_toml().encode())

    def load_group(self, staged: bool = False) -> Optional[Group]:
        path = self.staged_group_file if staged else self.group_file
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return Group.from_toml(f.read())

    # -- DKG share ----------------------------------------------------------

    def save_share(self, share: Share, staged: bool = False) -> None:
        """Atomic + owner-only, like save_group: the share is the one
        secret whose loss is unrecoverable without a reshare, so the old
        bytes must survive until the new bytes are durably in place."""
        lines = [f"Index = {share.private.index}",
                 f'Share = "{share.private.value:064x}"',
                 f'SchemeName = "{share.scheme.id}"',
                 "Commits = ["]
        lines += [f'  "{c.hex()}",' for c in share.commits]
        lines += ["]"]
        path = self.staged_share_file if staged else self.share_file
        fs.write_atomic(path, ("\n".join(lines) + "\n").encode(), secure=True)

    def load_share(self, staged: bool = False) -> Optional[Share]:
        path = self.staged_share_file if staged else self.share_file
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            doc = tomllib.load(f)
        scheme = get_scheme_by_id_with_default(doc.get("SchemeName", ""))
        return Share(
            scheme=scheme,
            private=PriShare(index=int(doc["Index"]), value=int(doc["Share"], 16)),
            commits=[bytes.fromhex(c) for c in doc["Commits"]])

    # -- staged reshare output (pending-transition ledger) -------------------

    def promote_staged_group(self) -> bool:
        """Atomically swap the staged group over the active one.  True
        when a staged file was promoted (False = nothing staged, e.g. a
        commit replayed after a crash that already promoted it)."""
        if not os.path.exists(self.staged_group_file):
            return False
        os.replace(self.staged_group_file, self.group_file)
        return True

    def promote_staged_share(self) -> bool:
        if not os.path.exists(self.staged_share_file):
            return False
        os.replace(self.staged_share_file, self.share_file)
        return True

    def discard_staged(self) -> None:
        """Drop any staged reshare output (aborted/tampered session)."""
        for p in (self.staged_group_file, self.staged_share_file):
            if os.path.exists(p):
                os.remove(p)

    def reset(self) -> None:
        """Remove group + share state (CLI `util reset` / `util del-beacon`)."""
        for p in (self.group_file, self.share_file,
                  self.staged_group_file, self.staged_share_file):
            if os.path.exists(p):
                os.remove(p)


def list_beacon_ids(base_folder: str):
    root = os.path.join(base_folder, MULTI_BEACON_FOLDER)
    if not os.path.isdir(root):
        return []
    return sorted(d for d in os.listdir(root)
                  if os.path.isdir(os.path.join(root, d)))
