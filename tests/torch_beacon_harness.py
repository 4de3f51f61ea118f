"""In-process beacon networks and chain fixtures for the port's beacon layer.

The port's counterpart of tests/harness.py's `LocalNetwork` and
`BeaconScenario` (the core/util_test.go:43-78 pattern: n handlers share one
FakeClock and exchange partials through a LocalNetwork that can drop
nodes), of core/follow.py's `FollowFacade` and of tests/chaos.py's storage
faults, over drand_tpu_torch only.  The port's `HandlerConfig` checks
partials on the card by default, so the scenario passes the verifier
factory explicitly: the host one unless a test asks for another.
"""

import threading
from typing import Dict

from drand_tpu_torch.beacon import FakeClock, Handler, HandlerConfig
from drand_tpu_torch.beacon.node import _host_verifier_factory
from drand_tpu_torch.beacon.stores import (AppendStore, CallbackStore,
                                           SchemeStore)
from drand_tpu_torch.chain import Beacon, Info, MemDBStore, genesis_beacon
from drand_tpu_torch.chain.errors import ErrNoBeaconStored
from drand_tpu_torch.crypto.host import tbls
from drand_tpu_torch.crypto.schemes import scheme_from_name
from drand_tpu_torch.key import DistPublic, Share, new_group, new_keypair


class LocalNetwork:
    """Synchronous in-process partial delivery with per-node kill switches."""

    def __init__(self):
        self.handlers = {}
        self.down = set()
        self._lock = threading.Lock()

    def register(self, index, handler):
        with self._lock:
            self.handlers[index] = handler
            self.down.discard(index)

    def kill(self, index):
        with self._lock:
            self.down.add(index)

    def revive(self, index):
        with self._lock:
            self.down.discard(index)

    def broadcaster(self, sender_index):
        def broadcast(packet):
            with self._lock:
                targets = [(i, h) for i, h in self.handlers.items()
                           if i != sender_index and i not in self.down
                           and sender_index not in self.down]
            for _, h in targets:
                try:
                    h.process_partial_beacon(packet)
                except ValueError:
                    pass
        return broadcast


class BeaconScenario:
    """n-node beacon network under a stepped clock.  `poly_coeffs` fixes
    the group polynomial (its coefficient 0 is the collective secret), so
    two scenarios built alike store the same chain byte for byte."""

    def __init__(self, n, thr, scheme_id="pedersen-bls-chained",
                 period=30, catchup_period=5, genesis_offset=100,
                 store_factory=None, secret=111222333, poly_coeffs=None,
                 verifier_factory=_host_verifier_factory):
        self.scheme = scheme_from_name(scheme_id)
        self.clock = FakeClock(start=1_000_000)
        self.net = LocalNetwork()
        self.period = period
        self.genesis = int(self.clock.now()) + genesis_offset
        self.verifier_factory = verifier_factory

        pairs = [new_keypair(f"127.0.0.1:{9000 + i}", self.scheme,
                             seed=b"scenario%d" % i) for i in range(n)]
        self.group = new_group([p.public for p in pairs], thr,
                               genesis=self.genesis, period=period,
                               catchup_period=catchup_period,
                               scheme=self.scheme)
        self.poly = tbls.PriPoly(list(poly_coeffs)) if poly_coeffs \
            else tbls.PriPoly.random(thr, secret=secret)
        commits = [self.scheme.key_group.to_bytes(c)
                   for c in self.poly.commit(self.scheme.key_group).commits]
        self.group.public_key = DistPublic(commits)
        self.commits = commits
        self.public_key = commits[0]
        self.store_factory = store_factory or (
            lambda i: MemDBStore(buffer_size=100))
        self.handlers = {}
        for node in self.group.nodes:
            self._make_handler(node.index)

    def _make_handler(self, index, store=None):
        share = Share(scheme=self.scheme, private=self.poly.eval(index),
                      commits=self.commits)
        h = Handler(HandlerConfig(
            group=self.group, share=share, index=index,
            store=store if store is not None else self.store_factory(index),
            clock=self.clock, verifier_factory=self.verifier_factory,
            broadcast=self.net.broadcaster(index)))
        self.net.register(index, h)
        self.handlers[index] = h
        return h

    def start_all(self):
        for h in self.handlers.values():
            h.start()

    def advance_to_genesis(self):
        self.clock.set_time(self.genesis)

    def advance_round(self):
        self.clock.advance(self.period)

    def wait_round(self, index, round_, timeout=60):
        b = self.handlers[index].chain.wait_for_round(
            round_, timeout, scheduled_time=True)
        assert b is not None, \
            f"node {index} never reached round {round_}"
        return b

    def wait_all(self, round_, timeout=60):
        return [self.wait_round(i, round_, timeout)
                for i in sorted(self.handlers)]

    def kill(self, index):
        self.net.kill(index)
        h = self.handlers.pop(index)
        store = h.cfg.store
        h.stop()
        return store

    def restart(self, index, store):
        h = self._make_handler(index, store=store)
        self.net.revive(index)
        h.catchup()
        return h

    def stop_all(self):
        for h in list(self.handlers.values()):
            h.stop()


class ChainFacade:
    """The slice of ChainStore that SyncManager and SyncChainServer need,
    without a vault or aggregator (core/follow.py's FollowFacade)."""

    def __init__(self, backend, chained: bool, genesis_seed: bytes):
        try:
            backend.last()
        except ErrNoBeaconStored:
            backend.put(genesis_beacon(genesis_seed))
        self._append = AppendStore(SchemeStore(backend, chained))
        self.cbstore = CallbackStore(self._append)
        self._backend = backend
        self.genesis_seed = genesis_seed

    @property
    def store(self):
        return self.cbstore

    @property
    def backend(self):
        return self._backend

    def last(self):
        return self.cbstore.last()

    def put(self, beacon) -> None:
        self.cbstore.put(beacon)

    def stop(self) -> None:
        self.cbstore.close()


class PortChain:
    """A real-crypto 1-of-1 chain in the port's types, made from a
    reference chain (tests/chaos.py TrueChain, tests/test_client.py
    MockChain): the same scheme, key, seed and signature bytes."""

    def __init__(self, ref):
        self.scheme = scheme_from_name(ref.scheme.id)
        self.public = ref.public
        self.genesis_seed = getattr(ref, "genesis_seed", None) \
            or ref.info.genesis_seed
        self.n = len(ref.beacons)
        if hasattr(ref, "info"):
            i = ref.info
            self.info = Info(public_key=i.public_key, period=i.period,
                             genesis_time=i.genesis_time,
                             genesis_seed=i.genesis_seed, scheme=i.scheme,
                             beacon_id=i.beacon_id)
        self.beacons: Dict[int, Beacon] = {
            r: Beacon(round=b.round, signature=b.signature,
                      previous_sig=b.previous_sig)
            for r, b in ref.beacons.items()}


class PeerStream:
    """A peer's SyncChainServer stream as a transport hands it out: an
    iterator with `cancel()`, which ends the server's live-follow loop
    (a bare generator parked in it could not be stopped from the
    consumer's side)."""

    def __init__(self, server, remote_addr: str, from_round: int):
        self._stop = threading.Event()
        self._gen = server.stream(remote_addr, from_round, stop=self._stop)

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)

    def cancel(self):
        self._stop.set()
        try:
            self._gen.close()       # a suspended stream unregisters now
        except ValueError:
            pass                    # running in a pump thread: it sees stop


def flip_bit(store, beacon_cls, round_, at=None):
    """Rewrite `round_` with one bit of its signature flipped."""
    b = store.get(round_)
    sig = bytearray(b.signature)
    sig[len(sig) // 3 if at is None else at] ^= 0x01
    store.delete(round_)
    store.put(beacon_cls(round=round_, signature=bytes(sig),
                         previous_sig=b.previous_sig))


def tear(store, beacon_cls, round_):
    """Rewrite `round_` with half of its signature (a torn write)."""
    b = store.get(round_)
    store.delete(round_)
    store.put(beacon_cls(round=round_,
                         signature=b.signature[:len(b.signature) // 2],
                         previous_sig=b.previous_sig))


class CachedVerifier:
    """A verifier's `verify_batch` memoized per (round, signature,
    previous signature): the host pairing costs some 0.3 s a round on the
    CPU, and a test scans the same rounds many times.  Verdicts are the
    wrapped verifier's own."""

    def __init__(self, inner):
        self.inner = inner
        self.kind = getattr(inner, "kind", "host")
        self._memo = {}

    def verify_batch(self, rounds, sigs, prev_sigs=None):
        import numpy as np
        prev_sigs = list(prev_sigs) if prev_sigs is not None \
            else [None] * len(rounds)
        keys = [(r, bytes(s), p) for r, s, p in zip(rounds, sigs, prev_sigs)]
        todo = sorted({k for k in keys if k not in self._memo},
                      key=lambda k: k[0])
        if todo:
            got = self.inner.verify_batch([k[0] for k in todo],
                                          [k[1] for k in todo],
                                          [k[2] for k in todo])
            self._memo.update(zip(todo, (bool(g) for g in got)))
        return np.array([self._memo[k] for k in keys], dtype=bool)

