"""In-process beacon networks and chain fixtures for the port's beacon layer.

The port's counterpart of tests/harness.py's `LocalNetwork` and
`BeaconScenario` (the core/util_test.go:43-78 pattern: n handlers share one
FakeClock and exchange partials through a LocalNetwork that can drop
nodes), of core/follow.py's `FollowFacade` and of tests/chaos.py's storage
faults, over drand_tpu_torch only.  The public edge's fixtures: a real-crypto
1-of-1 `MockChain` and its in-memory `MockSource` transport
(tests/test_client.py's), and the slice of a daemon and its beacon process
that the REST edge reads (`ShimDaemon`, `ShimProcess`;
tests/test_http_server.py's shims).  The port's `HandlerConfig` checks
partials on the card by default, so the scenario passes the verifier
factory explicitly: the host one unless a test asks for another.
"""

import threading
import time
from types import SimpleNamespace
from typing import Dict

from drand_tpu_torch.beacon import FakeClock, Handler, HandlerConfig
from drand_tpu_torch.beacon.node import _host_verifier_factory
from drand_tpu_torch.beacon.stores import (AppendStore, CallbackStore,
                                           SchemeStore)
from drand_tpu_torch.chain import Beacon, Info, MemDBStore, genesis_beacon
from drand_tpu_torch.chain.errors import ErrNoBeaconStored
from drand_tpu_torch.client.interface import Client, Result
from drand_tpu_torch.crypto.host import tbls
from drand_tpu_torch.crypto.schemes import scheme_from_name
from drand_tpu_torch.key import DistPublic, Share, new_group, new_keypair
from drand_tpu_torch.log import Logger


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



class MockChain:
    """A real-crypto 1-of-1 chain (mock/grpcserver.go generateMockData;
    tests/test_client.py's MockChain in the port's types: the same key,
    seed and signature bytes).  `sign(msg) -> signature` replaces the host
    signer (a chained round's message needs the previous signature, so the
    rounds are signed one at a time)."""

    def __init__(self, scheme_id="pedersen-bls-chained", n=6,
                 genesis=1_700_000_000, period=30, sign=None):
        self.scheme = scheme_from_name(scheme_id)
        self.secret, pub = self.scheme.keypair(seed=b"client-mock")
        self.public = self.scheme.public_bytes(pub)
        self.info = Info(public_key=self.public, period=period,
                         genesis_time=genesis, genesis_seed=b"\x07" * 32,
                         scheme=scheme_id)
        sign = sign or (lambda m: self.scheme.sign(self.secret, m))
        self.beacons: Dict[int, Beacon] = {}
        # chained chains anchor round 1 on the genesis seed (store.go:95-101)
        prev = self.info.genesis_seed if self.scheme.chained else None
        for r in range(1, n + 1):
            sig = sign(self.scheme.digest_beacon(r, prev))
            self.beacons[r] = Beacon(round=r, signature=sig,
                                     previous_sig=prev)
            if self.scheme.chained:
                prev = sig

    def forged_pair(self, r):
        """A copy of the beacons with round r's signature and round r+1's
        previous signature replaced by the same forged bytes (a valid
        point: another message's signature under the chain's key), so the
        linkage holds and only the signatures fail, at r and r + 1."""
        forged = self.scheme.sign(self.secret,
                                  self.scheme.digest_beacon(r + 10 ** 9))
        out = dict(self.beacons)
        out[r] = Beacon(round=r, signature=forged,
                        previous_sig=out[r].previous_sig)
        out[r + 1] = Beacon(round=r + 1, signature=out[r + 1].signature,
                            previous_sig=forged)
        return out


class MockSource(Client):
    """In-memory transport over a MockChain's beacons (or `beacons`, a
    tampered copy); counts fetches."""

    def __init__(self, chain: MockChain, latency: float = 0.0,
                 fail: bool = False, beacons=None):
        self.chain = chain
        self.beacons = beacons if beacons is not None else chain.beacons
        self.latency = latency
        self.fail = fail
        self.gets = 0

    def get(self, round_: int = 0) -> Result:
        self.gets += 1
        if self.fail:
            raise ConnectionError("source down")
        if self.latency:
            time.sleep(self.latency)
        r = round_ or max(self.beacons)
        if r not in self.beacons:
            raise KeyError(r)
        return Result.from_beacon(self.beacons[r])

    def watch(self, stop=None):
        for r in sorted(self.beacons):
            if stop is not None and stop.is_set():
                return
            if self.fail:
                raise ConnectionError("source down")
            yield Result.from_beacon(self.beacons[r])

    def info(self) -> Info:
        if self.fail:
            raise ConnectionError("source down")
        return self.chain.info


class ShimProcess:
    """The slice of core/beacon_process.py's BeaconProcess that the REST
    edge consumes: `beacon_id`, `handler.chain` (its `cbstore` carries the
    long-poll callback), `chain_info()` and `get_beacon()`."""

    def __init__(self, info: Info, chain, beacon_id="default"):
        self.info = info
        self.handler = SimpleNamespace(chain=chain)
        self.beacon_id = beacon_id

    @classmethod
    def of_scenario(cls, scenario: BeaconScenario, index: int = 0):
        g = scenario.group
        info = Info(public_key=scenario.public_key, period=g.period,
                    genesis_time=g.genesis_time,
                    genesis_seed=g.get_genesis_seed(),
                    scheme=scenario.scheme.id, beacon_id="default")
        return cls(info, scenario.handlers[index].chain)

    @classmethod
    def of_store(cls, info: Info, backend):
        """Over a filled store: a ChainFacade (the genesis row is put if
        the store is empty)."""
        chained = scheme_from_name(info.scheme).chained
        return cls(info, ChainFacade(backend, chained, info.genesis_seed))

    def chain_info(self) -> Info:
        return self.info

    def get_beacon(self, round_):
        if round_ == 0:
            return self.handler.chain.last()
        return self.handler.chain.store.get(round_)


class ShimDaemon:
    """The slice of DrandDaemon that RestServer consumes."""

    def __init__(self, bp: ShimProcess):
        self.processes = {"default": bp}
        self.chain_hashes = {bp.chain_info().hash_string(): "default"}
        self.log = Logger("test")
