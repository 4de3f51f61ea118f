"""Echo broadcast: the DKG transport board (core/broadcast.go:50-337).

Rebroadcast-once gossip for DKG bundles: every incoming packet is
signature-verified against the session's participants, deduped by hash,
delivered to the local DKG driver's queues, and re-sent once to every other
participant through per-destination sender threads with bounded queues
(broadcast.go:239-249: queue cap min(3*n, 1000)).  Our own packets bypass
the network and go straight to the application (broadcast.go:187-197).

The port's copy of drand_tpu/core/broadcast.py, unchanged but for its imports.
"""

import queue
import threading

from ..common import make_lock
from typing import Callable, Dict, List, Optional, Sequence

from ..crypto import dkg as D
from ..crypto import schnorr
from ..log import Logger
from ..net import Peer, ProtocolClient
from ..net import convert
from ..protos import drand_pb2 as pb

SENDER_QUEUE_CAP = 1000


class EchoBroadcast:
    """DKG board for one session.

    `to_network(bundle)`: sign-side push of our own bundle — deliver
    locally + fan out.  `received(packet)`: ingress from the gRPC service —
    verify, dedupe, deliver, re-broadcast once.
    """

    def __init__(self, client: ProtocolClient, log: Logger, beacon_id: str,
                 our_address: str, nonce: bytes,
                 dealers: Sequence[D.DkgNode], holders: Sequence[D.DkgNode],
                 peers: Sequence[Peer], scheme):
        self.client = client
        self.log = log.named("broadcast")
        self.beacon_id = beacon_id
        self.our_address = our_address
        self.nonce = nonce
        self.scheme = scheme
        # index -> public key, for packet signature verification; dealers
        # sign deal/justification bundles, holders sign response bundles.
        self.dealer_keys = {n.index: n.public for n in dealers}
        self.holder_keys = {n.index: n.public for n in holders}
        self.peers = [p for p in peers if p.address != our_address]
        self._seen: set = set()
        self._lock = make_lock()
        # local application queues, drained by the DKG driver
        self.deals: "queue.Queue[D.DealBundle]" = queue.Queue()
        self.responses: "queue.Queue[D.ResponseBundle]" = queue.Queue()
        self.justifications: "queue.Queue[D.JustificationBundle]" = queue.Queue()
        # per-destination sender threads (broadcast.go:253-333)
        cap = min(3 * max(len(self.peers), 1), SENDER_QUEUE_CAP)
        self._outboxes: Dict[str, queue.Queue] = {}
        self._senders: List[threading.Thread] = []
        self._stop = threading.Event()
        for peer in self.peers:
            q: queue.Queue = queue.Queue(maxsize=cap)
            self._outboxes[peer.address] = q
            t = threading.Thread(target=self._sender, args=(peer, q),
                                 daemon=True,
                                 name=f"dkg-send-{peer.address}")
            t.start()
            self._senders.append(t)

    # -- egress --------------------------------------------------------------

    def to_network(self, bundle) -> None:
        """Push our own bundle: local fast-path + network fan-out
        (broadcast.go:90-115,187-197)."""
        self._mark_seen(bundle)
        self._deliver_local(bundle)
        self._fan_out(bundle)

    def _fan_out(self, bundle) -> None:
        packet = pb.DKGPacket(
            dkg=convert.dkg_bundle_to_proto(bundle, self.beacon_id),
            metadata=convert.metadata(self.beacon_id))
        for peer in self.peers:
            try:
                self._outboxes[peer.address].put_nowait(packet)
            except queue.Full:
                self.log.warn("dkg sender queue full; dropping",
                              dest=peer.address)

    def _sender(self, peer: Peer, q: queue.Queue) -> None:
        while not self._stop.is_set():
            try:
                packet = q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self.client.broadcast_dkg(peer, packet)
            except Exception as e:
                self.log.warn("dkg broadcast send failed", dest=peer.address,
                              err=str(e))

    # -- ingress -------------------------------------------------------------

    def received(self, packet: pb.DKGPacket) -> None:
        """gRPC BroadcastDKG ingress: verify, dedupe, deliver, re-send once
        (broadcast.go:117-157)."""
        bundle = convert.proto_to_dkg_bundle(packet.dkg)
        if not self._verify(bundle):
            self.log.warn("invalid dkg packet signature; dropping")
            return
        if not self._mark_seen(bundle):
            return  # duplicate — already delivered and re-broadcast
        self._deliver_local(bundle)
        self._fan_out(bundle)

    def _verify(self, bundle) -> bool:
        if isinstance(bundle, D.ResponseBundle):
            pub = self.holder_keys.get(bundle.share_index)
        else:
            pub = self.dealer_keys.get(bundle.dealer_index)
        if pub is None or bundle.session_id != self.nonce:
            return False
        return schnorr.verify(self.scheme.key_group, pub,
                              bundle.hash(self.nonce), bundle.signature)

    def _mark_seen(self, bundle) -> bool:
        key = bundle.hash(self.nonce)
        with self._lock:
            if key in self._seen:
                return False
            self._seen.add(key)
            return True

    def _deliver_local(self, bundle) -> None:
        if isinstance(bundle, D.DealBundle):
            self.deals.put(bundle)
        elif isinstance(bundle, D.ResponseBundle):
            self.responses.put(bundle)
        else:
            self.justifications.put(bundle)

    # -- collection helpers for the phased driver ---------------------------

    def collect(self, q: queue.Queue, want: int, deadline: float,
                clock) -> list:
        """Drain up to `want` bundles from `q` until `deadline` (unix s)."""
        out = []
        while len(out) < want and clock.now() < deadline \
                and not self._stop.is_set():
            try:
                out.append(q.get(timeout=0.1))
            except queue.Empty:
                continue
        # drain whatever else is immediately available
        while True:
            try:
                out.append(q.get_nowait())
            except queue.Empty:
                return out

    def stop(self) -> None:
        self._stop.set()
        for t in self._senders:
            t.join(timeout=2)
