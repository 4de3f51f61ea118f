"""Observer-mode chain following (drand_beacon_control.go:1097-1227).

`drand sync --follow` on a node that is NOT a group member: fetch the chain
info from the given peers (pinned by chain hash), build a fresh store with
the append/scheme decorators, and batch-verify-sync from the peers while
streaming progress back to the control client.

The port's copy of drand_tpu/core/follow.py, unchanged but for its imports.
"""

import threading
from typing import Iterator, List, Tuple

from ..beacon.stores import AppendStore, CallbackStore, SchemeStore
from ..beacon.sync import SyncManager
from ..chain.beacon import genesis_beacon
from ..chain.errors import ErrNoBeaconStored
from ..chain.timing import current_round
from ..crypto.schemes import scheme_from_name
from ..net import Peer


class FollowFacade:
    """The slice of ChainStore that SyncManager + SyncChainServer need,
    without a vault/aggregator (we hold no share in observer mode)."""

    def __init__(self, backend, chained: bool, genesis_seed: bytes):
        # the genesis beacon must exist BEFORE the append decorator snapshots
        # the chain head (the Handler does the same, node.go:79)
        try:
            backend.last()
        except ErrNoBeaconStored:
            backend.put(genesis_beacon(genesis_seed))
        sch = SchemeStore(backend, chained)
        self._append = AppendStore(sch)
        self.cbstore = CallbackStore(self._append)
        self._backend = backend
        # the chain identity anchor: SyncManager.check_past_beacons hands
        # it to the integrity scanner for trimmed stores with no round-0 row
        self.genesis_seed = genesis_seed

    @property
    def store(self):
        return self.cbstore

    @property
    def backend(self):
        """Raw store below the decorators (integrity scans + repair)."""
        return self._backend

    def last(self):
        return self.cbstore.last()

    def put(self, beacon) -> None:
        self.cbstore.put(beacon)

    def stop(self) -> None:
        self.cbstore.close()


def follow_chain(daemon, bp, nodes: List[str], is_tls: bool, up_to: int,
                 chain_hash: str, stop: threading.Event
                 ) -> Iterator[Tuple[int, int]]:
    """Generator of (current, target) progress pairs."""
    peers = [Peer(n, is_tls) for n in nodes]
    client = daemon.gateway.client

    # Chain info from the first peer that answers; pin against chain_hash.
    info = None
    for peer in peers:
        try:
            from ..net import convert
            info = convert.proto_to_info(client.chain_info(peer,
                                                           bp.beacon_id))
            break
        except Exception:
            continue
    if info is None:
        raise RuntimeError("no peer delivered chain info")
    if chain_hash and info.hash_string() != chain_hash:
        raise ValueError(f"chain hash mismatch: want {chain_hash}, "
                         f"got {info.hash_string()}")

    scheme = scheme_from_name(info.scheme)
    store = bp._create_store()
    facade = FollowFacade(store, scheme.chained, info.genesis_seed)
    # observer-mode sync rides the daemon's resident verify service too:
    # its chunks coalesce with every other consumer's work (and a host
    # handle behind the same submit API when the device path is off)
    verifier = bp.cfg.verify_service().handle(
        scheme, info.public_key, device=bp.cfg.use_device_verifier)
    syncm = SyncManager(
        chain=facade, scheme=scheme, public_key_bytes=info.public_key,
        period=info.period, clock=bp.clock,
        fetch=lambda peer, fr: client.sync_chain(peer, fr, bp.beacon_id),
        peers=peers, chunk=bp.cfg.sync_chunk, verifier=verifier,
        # share the dialing client's policy: ranking and the client-side
        # BreakerOpen rejections must consult the SAME breaker registry
        resilience=getattr(client, "resilience", None),
        sync_budget=bp.cfg.sync_budget or None)

    target = up_to or current_round(int(bp.clock.now()), info.period,
                                    info.genesis_time)
    done = threading.Event()
    err: list = []

    def run():
        try:
            syncm.sync(target, peers)
        except Exception as e:
            err.append(e)
        finally:
            done.set()

    t = threading.Thread(target=run, daemon=True, name="follow-sync")
    t.start()
    last_sent = -1
    try:
        while not done.wait(0.2):
            if stop.is_set():
                break
            cur = facade.last().round
            if cur != last_sent:
                last_sent = cur
                yield cur, target
        cur = facade.last().round
        if cur != last_sent:
            yield cur, target
    finally:
        # the control client may disconnect mid-stream (GeneratorExit at a
        # yield): the sync and stores must be torn down on every exit path;
        # facade.stop() closes the decorator chain down to the backend
        syncm.stop()
        t.join(timeout=2)      # stop() unwedges sync; the worker exits
        facade.stop()
    if err:
        raise err[0]
