"""DKG setup plane: leader-side key collection + participant-side group
reception (reference: core/group_setup.go:46-432).

The leader collects `SignalDKGParticipant` packets (dedupe by address and
key, constant-time secret proof check, group_setup.go:207-244,424-432),
creates the group with a genesis time rounded up from
now + 3*dkg_timeout + genesis_offset (group_setup.go:247-276), signs its
hash and pushes it to every participant; participants verify the leader's
signature before accepting (group_setup.go:374-394).

The port's copy of drand_tpu/core/setup.py, unchanged but for its imports.
"""

import hashlib
import hmac
import math
import threading

from ..common import make_lock
from typing import List, Optional

from ..crypto.schemes import Scheme
from ..key.group import Group, new_group
from ..key.keys import Identity, dkg_auth_sign, dkg_auth_verify
from ..log import Logger
from .config import (DEFAULT_GENESIS_OFFSET, DEFAULT_RESHARING_OFFSET)


def hash_secret(secret: bytes) -> bytes:
    """The setup secret never travels in clear (group_setup.go:424-432)."""
    return hashlib.sha256(b"drand-setup-secret:" + secret).digest()


def correct_secret(proof: bytes, secret: bytes) -> bool:
    return hmac.compare_digest(proof, hash_secret(secret))


class SetupManager:
    """Leader-side collection of participant identities for one setup."""

    def __init__(self, log: Logger, scheme: Scheme, beacon_id: str,
                 expected: int, secret: bytes, leader_identity: Identity):
        self.log = log.named("setup")
        self.scheme = scheme
        self.beacon_id = beacon_id
        self.expected = expected
        self.secret = secret
        self._idents: List[Identity] = [leader_identity]
        self._lock = make_lock()
        self.done = threading.Event()

    def received_key(self, ident: Identity, proof: bytes) -> None:
        """SignalDKGParticipant ingress (group_setup.go:200-244)."""
        if not correct_secret(proof, self.secret):
            raise ValueError("wrong setup secret")
        if not ident.valid_signature():
            raise ValueError("invalid identity self-signature")
        with self._lock:
            for known in self._idents:
                if known.addr == ident.addr or known.key == ident.key:
                    return  # duplicate signal; idempotent
            if len(self._idents) >= self.expected:
                return
            self._idents.append(ident)
            self.log.info("setup: new participant", addr=ident.addr,
                          have=len(self._idents), want=self.expected)
            if len(self._idents) == self.expected:
                self.done.set()

    def wait_participants(self, timeout: float) -> List[Identity]:
        if not self.done.wait(timeout):
            with self._lock:
                raise TimeoutError(
                    f"setup: {len(self._idents)}/{self.expected} "
                    "participants before timeout")
        with self._lock:
            return list(self._idents)

    def create_group(self, threshold: int, period: int, catchup_period: int,
                     now: float, dkg_timeout: int) -> Group:
        """Fresh-DKG group; genesis after the full 3-phase DKG window
        (group_setup.go:247-276)."""
        genesis = int(math.ceil(now)) + 3 * dkg_timeout \
            + DEFAULT_GENESIS_OFFSET
        return new_group(list(self._idents), threshold, genesis, period,
                         catchup_period, self.scheme, self.beacon_id)

    def create_reshare_group(self, old_group: Group, threshold: int,
                             now: float,
                             reshare_offset: int = DEFAULT_RESHARING_OFFSET
                             ) -> Group:
        """Reshare group: same genesis/seed/period; transition at the next
        round boundary after now + reshare offset
        (group_setup.go:247-276, drand_beacon_control.go:425-529)."""
        from ..chain.timing import next_round
        target = int(now) + reshare_offset
        _, transition = next_round(target, old_group.period,
                                   old_group.genesis_time)
        g = new_group([i for i in self._idents], threshold,
                      old_group.genesis_time, old_group.period,
                      old_group.catchup_period, self.scheme, self.beacon_id)
        g.genesis_seed = old_group.get_genesis_seed()
        g.transition_time = transition
        return g


def sign_group(group: Group, scheme: Scheme, leader_secret: int) -> bytes:
    """Leader's signature over the group hash, sent in DKGInfoPacket
    (drand_beacon_control.go:1007-1083)."""
    return dkg_auth_sign(scheme, leader_secret, group.hash())


def verify_group_signature(group: Group, leader_key: bytes,
                           signature: bytes) -> bool:
    return dkg_auth_verify(group.scheme, leader_key, group.hash(), signature)


class SetupReceiver:
    """Participant-side wait for the leader's signed group
    (group_setup.go:306-394)."""

    def __init__(self, log: Logger, leader_identity: Identity):
        self.log = log.named("setup-recv")
        self.leader = leader_identity
        self._group: Optional[Group] = None
        self._timeout_s: int = 0
        self._grace_s: float = 0.0
        self.done = threading.Event()

    def push_dkg_info(self, group: Group, signature: bytes,
                      dkg_timeout: int, kickoff_grace_s: float = 0.0) -> None:
        if not verify_group_signature(group, self.leader.key, signature):
            raise ValueError("leader signature invalid on group")
        self._group = group
        self._timeout_s = dkg_timeout
        self._grace_s = kickoff_grace_s
        self.done.set()

    def wait_group(self, timeout: float):
        """Returns (group, dkg phase timeout, leader kickoff grace).  The
        grace comes from the wire: followers must pad their deal-phase
        deadline with the LEADER's value, not their own config — local
        config skew would silently fork QUAL (dkg_runner.py)."""
        if not self.done.wait(timeout):
            raise TimeoutError("no DKG info received from leader")
        return self._group, self._timeout_s, self._grace_s
