"""Node-to-node gRPC client with a lazy per-peer connection pool.

Reference: net/client_grpc.go:31-369 (conn pool :276, SyncChain stream pump
:211-248, 1-minute default timeout :39 overridable via DRAND_DIAL_TIMEOUT).
TLS here means channel credentials from the trusted-cert pool
(net/certs.go:45); plaintext otherwise.

When a `ResiliencePolicy` is attached (net/resilience.py), every unary call
runs through its retry executor — deadline-clamped per-attempt timeouts,
backoff with jitter, per-peer breaker accounting — and the SyncChain stream
feeds the same breakers (a dial failure releases the probe; a half-open
probe is closed by the first delivered beacon; content verdicts stay with
the SyncManager) so one subsystem's failures steer every other subsystem's
peer selection.

The port's copy of drand_tpu/net/client.py, unchanged but for its imports.
"""

import json
import os
import threading

from ..common import make_lock
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Sequence

import grpc

from ..chain.beacon import Beacon
from ..protos import drand_pb2 as pb
from . import convert, services
from .resilience import (HALF_OPEN, BreakerOpen, Deadline, ResiliencePolicy,
                         peer_key)

DEFAULT_TIMEOUT = float(os.environ.get("DRAND_DIAL_TIMEOUT", "60"))


class DialMap:
    """Dial-time address indirection (the fleet chaos harness's hook,
    net/chaosproxy.py): `DRAND_DIAL_MAP` names a JSON file mapping real
    peer addresses to per-link proxy addresses, and every outbound channel
    is dialed at the rewritten target.  The identity layer is untouched —
    peers still advertise (and sign) their real addresses; only the TCP
    connection detours through the proxy.

    The file is re-read on mtime change so a supervisor can write it
    after the daemon is already up (the fleet wires dial maps between
    ready-file collection and the DKG kickoff); a missing or unparsable
    file means identity — a half-written map must never black-hole the
    dialer, so rewrite errors fail open."""

    def __init__(self, path: str = ""):
        self.path = path or os.environ.get("DRAND_DIAL_MAP", "")
        self._stamp = None
        self._map: Dict[str, str] = {}
        self._lock = make_lock()

    def rewrite(self, address: str) -> str:
        if not self.path:
            return address
        try:
            stamp = os.stat(self.path).st_mtime_ns
        except OSError:
            return address
        with self._lock:
            if stamp != self._stamp:
                try:
                    with open(self.path) as f:
                        loaded = json.load(f)
                    self._map = {str(k): str(v) for k, v in loaded.items()}
                    self._stamp = stamp
                except (OSError, ValueError):
                    return address
            return self._map.get(address, address)


@dataclass(frozen=True)
class Peer:
    """Reachable node address (net/peer.go)."""
    address: str
    tls: bool = False


class CertManager:
    """Pool of trusted PEM certs for TLS channels (net/certs.go:45)."""

    def __init__(self):
        self._pems = []

    def add(self, pem_path: str) -> None:
        with open(pem_path, "rb") as f:
            self._pems.append(f.read())

    def credentials(self) -> grpc.ChannelCredentials:
        root = b"".join(self._pems) if self._pems else None
        return grpc.ssl_channel_credentials(root_certificates=root)


class _BeaconStream:
    """Iterator over a SyncChain gRPC call that keeps `cancel()` reachable
    (a bare generator would hide the call object in its frame).  The
    optional breaker hook closes a HALF_OPEN probe on the first delivered
    beacon — a transport-level reachability verdict.  In CLOSED state
    nothing is recorded here: content verdicts belong to the SyncManager,
    and resetting the failure streak on every delivered chunk would let a
    content-Byzantine peer (working transport, forged signatures) oscillate
    between 0 and 1 consecutive failures and never trip its breaker.
    Failures are likewise NOT recorded here: the SyncManager records one
    per fruitless peer-try — accounting in both layers would double-count
    every transport error and halve the configured failure threshold."""

    def __init__(self, call, breaker=None):
        self._call = call
        self._breaker = breaker
        self._delivered = False

    def __iter__(self):
        return self

    def __next__(self) -> Beacon:
        item = next(self._call)
        if not self._delivered:
            self._delivered = True
            if self._breaker is not None \
                    and self._breaker.state == HALF_OPEN:
                self._breaker.record_success()
        return convert.proto_to_beacon(item)

    def cancel(self) -> None:
        try:
            self._call.cancel()
        except Exception:
            pass


class ProtocolClient:
    """Dial-side of the Protocol + Public services, one channel per peer."""

    def __init__(self, certs: Optional[CertManager] = None,
                 timeout: float = DEFAULT_TIMEOUT,
                 resilience: Optional[ResiliencePolicy] = None,
                 dial_map: Optional[DialMap] = None, identity=None):
        self.certs = certs or CertManager()
        self.timeout = timeout
        self.resilience = resilience
        self.dial_map = dial_map or DialMap()
        self.identity = identity      # net/identity.py IdentityPlane or None
        self._conns: Dict[tuple, grpc.Channel] = {}
        self._lock = make_lock()

    # -- pool ----------------------------------------------------------------

    def channel(self, peer: Peer) -> grpc.Channel:
        # dial indirection: the chaos harness reroutes this peer through
        # its per-link proxy; identity (breakers, peer keys, group
        # addresses) stays keyed on the REAL address
        target = self.dial_map.rewrite(peer.address)
        if self.identity is not None:
            # the mesh speaks mTLS on EVERY dial regardless of the peer's
            # advertised tls flag (group files predating the identity
            # plane carry tls=False); the channel cache is keyed on the
            # cert epoch so a hot rotation re-dials with fresh creds
            # instead of reusing a channel pinned to the old client cert
            self.identity.maybe_reload()
            epoch = self.identity.epoch
            key = (target, True, epoch)
            with self._lock:
                ch = self._conns.get(key)
                if ch is None:
                    ch = grpc.secure_channel(
                        target, self.identity.channel_credentials(),
                        options=(("grpc.ssl_target_name_override",
                                  "localhost"),))
                    self._conns[key] = ch
                    # drop channels pinned to superseded cert epochs
                    for k in [k for k in self._conns
                              if len(k) == 3 and k[2] != epoch]:
                        self._conns.pop(k).close()
                return ch
        key = (target, peer.tls)         # a TLS peer must never reuse a
        with self._lock:                 # cached plaintext channel
            ch = self._conns.get(key)
            if ch is None:
                if peer.tls:
                    ch = grpc.secure_channel(target,
                                             self.certs.credentials())
                else:
                    ch = grpc.insecure_channel(target)
                self._conns[key] = ch
            return ch

    def close(self) -> None:
        with self._lock:
            for ch in self._conns.values():
                ch.close()
            self._conns.clear()

    def _protocol(self, peer: Peer):
        return services.PROTOCOL.stub(self.channel(peer))

    def _public(self, peer: Peer):
        return services.PUBLIC.stub(self.channel(peer))

    # -- resilient unary dispatch -------------------------------------------

    def _unary(self, peer: Peer, op: str, fn, timeout: Optional[float] = None,
               deadline: Optional[Deadline] = None, breaker: bool = True):
        """Run `fn(per_attempt_timeout)` under the attached policy (retry +
        breaker + deadline); without a policy, a bare single attempt with
        the deadline still clamping the static timeout.  `breaker=False`
        keeps retries/deadlines but skips breaker accounting — used by the
        DKG setup plane, where the coordinator is EXPECTED to be down until
        the operator runs InitDKG and quarantining it would deadlock the
        join loop."""
        t = timeout or self.timeout
        if self.resilience is None:
            return fn(deadline.clamp(t) if deadline is not None else t)
        return self.resilience.call(fn,
                                    key=peer.address if breaker else None,
                                    op=op, timeout=t, deadline=deadline)

    # -- Protocol service ----------------------------------------------------

    def get_identity(self, peer: Peer, beacon_id: str = "",
                     deadline: Optional[Deadline] = None
                     ) -> pb.IdentityResponse:
        req = pb.IdentityRequest(metadata=convert.metadata(beacon_id))
        return self._unary(
            peer, "get_identity",
            lambda t: self._protocol(peer).get_identity(req, timeout=t),
            deadline=deadline, breaker=False)

    def signal_dkg_participant(self, peer: Peer, packet: pb.SignalDKGPacket,
                               timeout: Optional[float] = None,
                               deadline: Optional[Deadline] = None) -> None:
        self._unary(
            peer, "signal_dkg_participant",
            lambda t: self._protocol(peer).signal_dkg_participant(
                packet, timeout=t),
            timeout=timeout, deadline=deadline, breaker=False)

    def push_dkg_info(self, peer: Peer, packet: pb.DKGInfoPacket,
                      timeout: Optional[float] = None,
                      deadline: Optional[Deadline] = None) -> None:
        self._unary(
            peer, "push_dkg_info",
            lambda t: self._protocol(peer).push_dkg_info(packet, timeout=t),
            timeout=timeout, deadline=deadline)

    def broadcast_dkg(self, peer: Peer, packet: pb.DKGPacket) -> None:
        self._unary(
            peer, "broadcast_dkg",
            lambda t: self._protocol(peer).broadcast_dkg(packet, timeout=t))

    def partial_beacon(self, peer: Peer, packet: pb.PartialBeaconPacket,
                       timeout: Optional[float] = None,
                       deadline: Optional[Deadline] = None) -> None:
        self._unary(
            peer, "partial_beacon",
            lambda t: self._protocol(peer).partial_beacon(packet, timeout=t),
            timeout=timeout, deadline=deadline)

    def handel_aggregate(self, peer: Peer, packet,
                         timeout: Optional[float] = None,
                         deadline: Optional[Deadline] = None) -> None:
        """One Handel candidate aggregate (beacon/handel.py).  Overlay
        sends are latency-critical and redundant across a level's targets,
        so this is a SINGLE attempt under breaker accounting — the next
        tick re-targets by score anyway, and a backoff chain inside the
        tick thread would stall every later level's sends."""
        fn = lambda t: self._protocol(peer).handel_aggregate(  # noqa: E731
            packet, timeout=t)
        t = timeout or self.timeout
        if self.resilience is None:
            fn(deadline.clamp(t) if deadline is not None else t)
            return
        self.resilience.call(fn, key=peer.address, op="handel_aggregate",
                             timeout=t, deadline=deadline, max_attempts=1)

    def sync_chain(self, peer: Peer, from_round: int,
                   beacon_id: str = "") -> "_BeaconStream":
        """Server-stream of BeaconPackets starting at from_round
        (client_grpc.go:211-248).  The returned iterator forwards
        `cancel()` to the underlying gRPC call so sync watchdogs can tear
        down a black-holed stream.  With a policy attached, an open breaker
        rejects the dial outright and the stream's first-item/error events
        feed the breaker."""
        breaker = None
        if self.resilience is not None:
            breaker = self.resilience.breaker(peer_key(peer))
            if not breaker.allow():
                raise BreakerOpen(f"sync_chain {peer.address} open")
        req = pb.SyncRequest(from_round=from_round,
                             metadata=convert.metadata(beacon_id))
        try:
            call = self._protocol(peer).sync_chain(req)
        except Exception:
            if breaker is not None:
                breaker.record_failure()   # dial failed: release the probe
            raise
        return _BeaconStream(call, breaker=breaker)

    def status(self, peer: Peer, beacon_id: str = "",
               check_conn: Sequence[Peer] = ()) -> pb.StatusResponse:
        req = pb.StatusRequest(metadata=convert.metadata(beacon_id))
        for p in check_conn:
            req.check_conn.append(pb.StatusAddress(address=p.address,
                                                   tls=p.tls))
        return self._unary(
            peer, "status",
            lambda t: self._protocol(peer).status(req, timeout=t))

    def metrics(self, peer: Peer, beacon_id: str = "") -> bytes:
        """Fetch a peer's GroupMetrics snapshot (federation; the reference
        proxies HTTP over the gRPC conn instead, client_grpc.go:352-361)."""
        req = pb.MetricsRequest(metadata=convert.metadata(beacon_id))
        return self._unary(
            peer, "metrics",
            lambda t: self._protocol(peer).metrics(req, timeout=t)).metrics

    # -- Public service ------------------------------------------------------

    def public_rand(self, peer: Peer, round_: int = 0,
                    beacon_id: str = "",
                    token: Optional[str] = None) -> pb.PublicRandResponse:
        md = (("authorization", f"Bearer {token}"),) if token else None
        req = pb.PublicRandRequest(round=round_,
                                   metadata=convert.metadata(beacon_id))
        return self._unary(
            peer, "public_rand",
            lambda t: self._public(peer).public_rand(req, timeout=t,
                                                     metadata=md))

    def public_rand_stream(self, peer: Peer, round_: int = 0,
                           beacon_id: str = "") -> Iterator[pb.PublicRandResponse]:
        req = pb.PublicRandRequest(round=round_,
                                   metadata=convert.metadata(beacon_id))
        return self._public(peer).public_rand_stream(req)

    def chain_info(self, peer: Peer, beacon_id: str = "") -> pb.ChainInfoPacket:
        req = pb.ChainInfoRequest(metadata=convert.metadata(beacon_id))
        return self._unary(
            peer, "chain_info",
            lambda t: self._public(peer).chain_info(req, timeout=t))

    def home(self, peer: Peer, beacon_id: str = "") -> pb.HomeResponse:
        req = pb.HomeRequest(metadata=convert.metadata(beacon_id))
        return self._unary(
            peer, "home",
            lambda t: self._public(peer).home(req, timeout=t))
