"""Crypto vault: thread-safe holder of the node's DKG share + group info.

The port's copy of drand_tpu/crypto/vault.py, unchanged but for its imports.

Reference: crypto/vault/vault.go:21-85.  The beacon Handler signs partials
through the vault; at reshare transition the share and group are swapped
atomically (vault.go:74-85, chain/beacon/node.go:257-281).
"""

import threading

from ..common import make_rlock
from typing import Optional

from .schemes import Scheme
from .host import tbls


class Vault:
    def __init__(self, scheme: Scheme, group, share):
        """`group`: key.Group; `share`: key.Share (or None until DKG ends)."""
        self._lock = make_rlock()
        self.scheme = scheme
        self._group = group
        self._share = share
        # one PubPoly per share: rebuilding it per call deserialized all
        # t commitments every round AND defeated the per-instance eval
        # memo (tbls.PubPoly) that un-quadratics committee-scale partial
        # verification
        self._pub_cache = None
        self._pub_for = None

    # -- signing (vault.go:60-68) -------------------------------------------

    def sign_partial(self, msg: bytes) -> bytes:
        with self._lock:
            if self._share is None:
                raise RuntimeError("vault has no share (DKG not run)")
            return tbls.sign_partial(self.scheme, self._share.private, msg)

    # -- reads ---------------------------------------------------------------

    def get_group(self):
        with self._lock:
            return self._group

    def get_share(self):
        with self._lock:
            return self._share

    def get_pub(self) -> Optional[tbls.PubPoly]:
        """The public polynomial for partial verification (vault.go:48-52);
        cached per share so every consumer sees ONE memoized instance."""
        with self._lock:
            if self._share is None:
                return None
            if self._pub_for is not self._share:
                self._pub_cache = self._share.pub_poly()
                self._pub_for = self._share
            return self._pub_cache

    def public_key_bytes(self) -> Optional[bytes]:
        with self._lock:
            if self._share is not None:
                return self._share.commits[0]
            if self._group is not None and self._group.public_key is not None:
                return self._group.public_key.key()
            return None

    # -- reshare transition (vault.go:74-85) --------------------------------

    def set_info(self, group, share) -> None:
        with self._lock:
            self._group = group
            self._share = share
