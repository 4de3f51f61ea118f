"""Beacon Handler: the per-chain round loop (chain/beacon/node.go:41-473).

The port's copy of drand_tpu/beacon/node.py.  Owns ticker + aggregator +
vault.  Every tick: read the chain head, sign a partial for head.round+1,
broadcast it to all peers (and feed it to the own aggregator).  When the
head lags the wall-clock round, trigger sync and run catchup rebroadcasts
at the (faster) catchup period so a halted network can fast-forward as
soon as beacons appear (node.go:368-403).

Ingress (`process_partial_beacon`, node.go:109-181) performs the cheap
checks — round window, signer membership, not-self — and feeds the
aggregator, which performs the cryptographic verification in batch at
threshold time (the device-first redesign of node.go:150's per-packet
pairing).

One deliberate difference: `HandlerConfig.verifier_factory` defaults to
`device_verifier_factory`, the daemon's default (the reference daemon's
`use_device_verifier=True`), where the reference `HandlerConfig` defaults
to the host factory.  A Handler therefore checks partials on the card
unless its config says otherwise; without a card it raises at
construction instead of carrying on on the host.  Signing (the Vault) and
recovery (`tbls.recover`) stay on the host, as in the reference.

A second: `_launch` subscribes to the ticker before starting it.  The
reference starts the ticker first, so a node started at or after a round's
time (a restart, a node joining a running chain) can lose that round's
tick, which the ticker fires at once.
"""

import threading

from ..common import make_lock
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from ..chain.beacon import Beacon, genesis_beacon
from ..chain.errors import ErrNoBeaconStored
from ..chain.timing import current_round, time_of_round
from ..crypto.host.tbls import index_of
from ..crypto.vault import Vault
from .chainstore import ChainStore
from .clock import Clock, RealClock
from .ticker import Ticker


@dataclass
class PartialBeaconPacket:
    """Wire form of one partial (protobuf/drand/protocol.proto:83)."""
    round: int
    previous_signature: Optional[bytes]
    partial_sig: bytes            # be16(index) || sig
    beacon_id: str = "default"

    def signer_index(self) -> int:
        return index_of(self.partial_sig)


def _host_verifier_factory(scheme, pub_poly, n_nodes):
    from .chainstore import HostPartialVerifier
    return HostPartialVerifier(scheme, pub_poly)


def device_verifier_factory(scheme, pub_poly, n_nodes, device=None):
    """Factory for the device-batched aggregation-time verifier, on CUDA
    unless `device` says "cpu" (bind it with functools.partial).  Without
    a card and without device="cpu" it raises, as
    `crypto.batch.resolve_device` does.

    Wired through `VerifyService.partials_factory`, the reference daemon
    passes `fallback_factory=_host_verifier_factory`
    (core/beacon_process.py), so a failed device check is redone on the
    host.  The port's wiring passes no fallback: a device failure reaches
    the aggregator as an error, which counts it
    (`beacon_partial_check_errors_total`) and logs it, and the round waits
    for its next partial to retry the check.  Quietly moving the round to
    host pairing would hide a broken card behind a slower chain."""
    from .chainstore import DevicePartialVerifier
    return DevicePartialVerifier(scheme, pub_poly, n_nodes, device=device)


@dataclass
class HandlerConfig:
    group: object                  # key.Group
    share: object                  # key.Share
    index: int                     # our node index in the group
    store: object                  # raw chain.Store backend
    clock: Clock = field(default_factory=RealClock)
    # builds the aggregation-time partial verifier: the card by default
    # (the module doc); _host_verifier_factory for the host path
    verifier_factory: Callable = device_verifier_factory
    # broadcast(packet) must deliver to every OTHER group member
    broadcast: Optional[Callable[[PartialBeaconPacket], None]] = None
    # called with the target round when the chain lags; sync fills the gap
    on_sync_needed: Optional[Callable[[int], None]] = None
    beacon_id: str = "default"


class Handler:
    def __init__(self, cfg: HandlerConfig):
        self.cfg = cfg
        self.group = cfg.group
        self.scheme = cfg.group.scheme
        self.vault = Vault(self.scheme, cfg.group, cfg.share)
        self.clock = cfg.clock
        self.index = cfg.index
        self.catchup_period = cfg.group.catchup_period or cfg.group.period

        # a fresh chain starts from the genesis beacon (node.go:79); must
        # happen before the decorator chain snapshots the chain head
        try:
            cfg.store.last()
        except ErrNoBeaconStored:
            cfg.store.put(genesis_beacon(cfg.group.get_genesis_seed()))

        self.chain = ChainStore(
            cfg.store, self.vault, cfg.clock, cfg.group,
            on_sync_needed=self._sync_needed,
            partial_verifier=cfg.verifier_factory(
                self.scheme, self.vault.get_pub(), len(cfg.group)),
            beacon_id=cfg.beacon_id)
        self.ticker = Ticker(cfg.clock, cfg.group.period, cfg.group.genesis_time)
        # Fast-forward on each stored beacon (node.go:368-403): while the
        # chain lags the wall-clock round, every new beacon immediately
        # triggers the next partial — catching up must not wait for the
        # (possibly frozen fake-clock) catchup timer.  Without this, a node
        # that consumes a tick while still aggregating the previous round
        # never signs the ticked round and a thr-sized network deadlocks.
        self.chain.cbstore.add_callback(
            f"fastforward-{self.index}", self._on_beacon_stored)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._catchup_thread: Optional[threading.Thread] = None
        self._lock = make_lock()
        self._transition_group = None      # (group, share) armed by reshare
        self.running = False

    # -- ingress (node.go:109-181) ------------------------------------------

    def process_partial_beacon(self, packet: PartialBeaconPacket) -> None:
        """Validate window/membership and feed the aggregator.  Raises
        ValueError on protocol violations (mapped to RPC errors upstream)."""
        current = self.ticker.current_round()
        next_round = current + 1
        if packet.round > next_round:
            raise ValueError(
                f"partial for future round {packet.round} (next {next_round})")
        try:
            last = self.chain.last()
            if packet.round <= last.round:
                return  # stale; already have this beacon
        except ErrNoBeaconStored:
            pass
        idx = packet.signer_index()
        node = self.group.node(idx)
        if node is None:
            raise ValueError(f"unknown signer index {idx}")
        if idx == self.index:
            return  # our own partial comes through broadcast_next_partial
        self.chain.new_valid_partial(packet.round, packet.previous_signature,
                                     packet.partial_sig)

    # -- round loop (node.go:322-473) ---------------------------------------

    def start(self) -> None:
        """Start at genesis (DKG fresh-start path, node.go:195)."""
        self._launch()

    def catchup(self) -> None:
        """Start after a restart: sync first, rejoin at the next tick
        (node.go:219-228)."""
        self._sync_needed(self.ticker.current_round())
        self._launch()

    def transition(self, new_group, new_share, on_commit=None) -> None:
        """Arm a reshare transition: at the group's transition time the vault
        swaps to the new share/group atomically (node.go:257-281).

        `on_commit` is the durability hook (core/dkg_journal.py): invoked
        exactly once, at the moment the swap commits, so the staged
        group/share files are promoted over the active ones only when the
        chain no longer needs the old share.  A crash before this point
        restarts with the old state + the pending ledger; a crash after
        it restarts already transitioned."""
        with self._lock:
            self._transition_group = (new_group, new_share, on_commit)

    def _launch(self) -> None:
        if self._thread is not None:
            return
        self.running = True
        # subscribe before the ticker runs: started at or after a round's
        # time, it fires that round at once, and a tick fired before the
        # subscription is lost (the node then signs nothing until the next
        # round)
        self._ticks = self.ticker.channel()
        self.ticker.start()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"handler-{self.index}")
        self._thread.start()
        self._catchup_thread = threading.Thread(
            target=self._run_catchup, daemon=True,
            name=f"catchup-{self.index}")
        self._catchup_thread.start()

    def _run(self) -> None:
        import queue as _q
        while not self._stop.is_set():
            try:
                tick = self._ticks.get(timeout=0.1)
            except _q.Empty:
                continue
            self._maybe_transition()
            try:
                last = self.chain.last()
            except ErrNoBeaconStored:
                continue
            if last.round + 1 < tick.round:
                # gap: we're late — sync, and let catchup rebroadcasts
                # fast-forward us (node.go:358-367)
                self._sync_needed(tick.round)
            self.broadcast_next_partial(last)

    def _on_beacon_stored(self, beacon: Beacon) -> None:
        """Store-driven catchup (node.go:368-403 fast-forward): if we are
        still behind the wall clock after storing `beacon`, sign and
        broadcast the next round's partial right away."""
        if self._stop.is_set() or not self.running:
            return
        try:
            last = self.chain.last()
        except ErrNoBeaconStored:
            return
        if beacon.round != last.round:
            return  # mid-sync backlog: only the head triggers a partial
        self._maybe_transition()
        if beacon.round < self.ticker.current_round():
            self.broadcast_next_partial(beacon)

    def _run_catchup(self) -> None:
        """While behind the wall clock, rebroadcast the next partial every
        catchup period; each stored beacon advances the target immediately
        (node.go:368-403)."""
        while not self._stop.is_set():
            if not self.clock.wait_until(self.clock.now() + self.catchup_period,
                                         self._stop):
                return
            self._maybe_transition()
            try:
                last = self.chain.last()
            except ErrNoBeaconStored:
                continue
            if last.round + 1 < self.ticker.current_round():
                self.broadcast_next_partial(last)

    def _maybe_transition(self) -> None:
        """Share swap at the transition ROUND boundary in chain space
        (node.go:257-281): rounds below the transition round must be signed
        with the OLD share even if the wall clock is already past the
        transition time (a lagging chain first catches its old-key segment
        up; swapping early would sign that segment with the new key and
        stall the chain forever)."""
        with self._lock:
            pending = self._transition_group
            if pending is None:
                return
            new_group, new_share, on_commit = pending
            transition_round = current_round(
                new_group.transition_time, new_group.period,
                new_group.genesis_time)
            try:
                next_to_sign = self.chain.last().round + 1
            except ErrNoBeaconStored:
                next_to_sign = 1
            if int(self.clock.now()) < new_group.transition_time \
                    or next_to_sign < transition_round:
                return
            self._transition_group = None
            # The swap happens INSIDE the lock: every signing path calls
            # _maybe_transition before signing, so a concurrent caller
            # blocks here until the vault/verifier swap is complete
            # instead of seeing `pending is None` mid-swap and signing
            # the transition round with the OLD share (a stray old-share
            # partial does not just fail — it poisons the partial cache's
            # slot for this index, and the rebroadcast-once transport
            # never re-delivers the good one).
            # Promote the staged on-disk state BEFORE the in-memory
            # swap: if the commit lands and we crash, the restart is
            # simply already transitioned; disk failures must not block
            # the live swap.
            if on_commit is not None:
                try:
                    on_commit()
                except Exception:
                    pass        # reported by the owner's own logging
            if new_share is not None:
                self.vault.set_info(new_group, new_share)
                self.group = new_group
                self.chain.group = new_group
                self.chain.partial_verifier = self.cfg.verifier_factory(
                    self.scheme, self.vault.get_pub(), len(new_group))
                self.index = new_share.private.index
                self.catchup_period = new_group.catchup_period \
                    or new_group.period
                return
        # we are not part of the new group: leave the network (outside
        # the lock — stop() joins the very threads that may be parked on
        # _maybe_transition's lock right now)
        # intentional fire-and-forget: the trampoline's whole job is to
        # run stop() outside this lock, and stop() joins every owned thread
        threading.Thread(target=self.stop, daemon=True,
                         name="stop-async-node").start()

    def broadcast_next_partial(self, last: Beacon) -> None:
        """Sign our partial for last.round+1 and fan it out
        (node.go:408-473)."""
        round_ = last.round + 1
        prev = last.signature if self.scheme.chained else None
        msg = self.scheme.digest_beacon(round_, prev)
        try:
            partial = self.vault.sign_partial(msg)
        except RuntimeError:
            return  # no share yet (waiting on DKG)
        packet = PartialBeaconPacket(
            round=round_, previous_signature=prev, partial_sig=partial,
            beacon_id=self.cfg.beacon_id)
        # our own partial goes straight to the aggregator (node.go:444)
        self.chain.new_valid_partial(round_, prev, partial)
        if self.cfg.broadcast is not None:
            self.cfg.broadcast(packet)

    def _sync_needed(self, target_round: int) -> None:
        if self.cfg.on_sync_needed is not None:
            self.cfg.on_sync_needed(target_round)

    # -- lifecycle -----------------------------------------------------------

    def stop(self) -> None:
        self.running = False
        self._stop.set()
        self.ticker.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._catchup_thread is not None:
            self._catchup_thread.join(timeout=5)
            self._catchup_thread = None
        self.chain.stop()
