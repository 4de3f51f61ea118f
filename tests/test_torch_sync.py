"""The port's sync manager (drand_tpu_torch/beacon/sync.py): chain
validation and repair, catch-up from a live-follow stream, peer failover,
and the serving side.

The cases of tests/test_sync_repair.py run here against the port, rebuilt
over the reference module's globals with the port's names and, in place of
core/follow.py's FollowFacade, the harness's `ChainFacade`
(tests/torch_beacon_harness.py); the cases that import reference modules in
their body are written out below.  The reference's ChaosStore case stays
with it (its fault wrapper is the reference's).  Then the same corrupted
stores give the same faulty rounds through both packages'
`check_past_beacons`, and a node catches up through a peer's
`SyncChainServer` and a verify-service handle.
"""

import threading

import numpy as np
import pytest

import test_sync_repair as ref_sync
import torch_beacon_harness as H
from test_client import MockChain
from torch_service_cases import port_cases

from drand_tpu.beacon.clock import FakeClock as RefClock
from drand_tpu.beacon.sync import SyncManager as RefSyncManager
from drand_tpu.chain.beacon import Beacon as RefBeacon
from drand_tpu.chain.memdb import MemDBStore as RefMemDB
from drand_tpu.core.follow import FollowFacade as RefFacade
from drand_tpu.crypto.hostverify import HostBatchVerifier as RefHost
from drand_tpu_torch.beacon.clock import FakeClock
from drand_tpu_torch.beacon.sync import SyncChainServer, SyncManager
from drand_tpu_torch.chain.beacon import Beacon, genesis_beacon
from drand_tpu_torch.chain.memdb import MemDBStore
from drand_tpu_torch.chain.sqlitedb import SqliteStore
from drand_tpu_torch.crypto.hostverify import HostBatchVerifier
from drand_tpu_torch.net.resilience import (OPEN, BreakerRegistry,
                                            ResiliencePolicy)

N = ref_sync.N
_MEMO = {}


def cached_host(scheme, public):
    key = (scheme.id, bytes(public))
    if key not in _MEMO:
        _MEMO[key] = H.CachedVerifier(HostBatchVerifier(scheme, public))
    return _MEMO[key]


NAMES = dict(SyncManager=SyncManager, Beacon=Beacon,
             genesis_beacon=genesis_beacon, MemDBStore=MemDBStore,
             FollowFacade=H.ChainFacade, HostBatchVerifier=cached_host,
             FakeClock=FakeClock, MockChain=None)
WRITTEN_OUT = (
    "test_check_past_beacons_trimmed_raw_store_is_not_all_faulty",
    "test_corrupted_stream_fails_over_and_opens_breaker",
    "test_sync_server_fills_previous_sig_from_trimmed_store",
    # the reference's ChaosStore wraps the store with its own errors
    "test_chaos_store_faults_detected_and_repaired_through_raw")
CASES = port_cases(ref_sync, NAMES, skip=WRITTEN_OUT)


@pytest.fixture(scope="module")
def ref_chain():
    return MockChain(n=N)


@pytest.fixture(scope="module")
def chain(ref_chain):
    return H.PortChain(ref_chain)


@pytest.mark.parametrize("case", [fn for _, fn in CASES],
                         ids=[n for n, _ in CASES])
def test_reference_case(case, request):
    params = case.__code__.co_varnames[:case.__code__.co_argcount]
    case(**{p: request.getfixturevalue(p) for p in params})


def _manager(chain, facade, fetch=lambda peer, fr: iter(()), **kw):
    return SyncManager(
        chain=facade, scheme=chain.scheme, public_key_bytes=chain.public,
        period=30, clock=kw.pop("clock", FakeClock(1)), fetch=fetch,
        peers=["peer0"], chunk=4,
        verifier=kw.pop("verifier", cached_host(chain.scheme, chain.public)),
        **kw)


def test_check_past_beacons_trimmed_raw_store_is_not_all_faulty(chain,
                                                                tmp_path):
    store = SqliteStore(str(tmp_path / "trimmed.db"))
    facade = H.ChainFacade(store, chain.scheme.chained,
                           chain.info.genesis_seed)
    for r in range(1, N + 1):
        store.put(chain.beacons[r])
    assert store.get(3).previous_sig is None            # really trimmed
    syncm = _manager(chain, facade)
    assert syncm.check_past_beacons(N) == []
    H.flip_bit(store, Beacon, 7, at=0)
    assert 7 in syncm.check_past_beacons(N)
    store.close()


class AutoClock(FakeClock):
    """tests/chaos.py AutoClock on the port's FakeClock: a waiter moves
    time to its deadline, so backoffs and budgets elapse at once."""

    def wait_until(self, deadline, stop):
        if stop.is_set():
            return False
        with self._cond:
            if deadline > self._now:
                self._now = deadline
                self._cond.notify_all()
        return True


def test_corrupted_stream_fails_over_and_opens_breaker(chain):
    """A peer that forges every beacon it serves: its chunks are rejected,
    its breaker opens, and the next sync fails over to the honest peer."""
    clock = AutoClock(1_000.0)
    store = MemDBStore(buffer_size=100)
    facade = H.ChainFacade(store, chain.scheme.chained,
                           chain.info.genesis_seed)

    def fetch(peer, from_round):
        for r in range(from_round, N + 1):
            b = chain.beacons[r]
            if peer == "byzantine":
                sig = bytearray(b.signature)
                sig[len(sig) // 3] ^= 0x01
                b = Beacon(round=r, signature=bytes(sig),
                           previous_sig=b.previous_sig)
            yield b

    policy = ResiliencePolicy(
        clock=clock, seed=13, scope="sync-chaos",
        breakers=BreakerRegistry(clock=clock, failures=1, cooldown=10_000.0,
                                 scope="sync-chaos"))
    syncm = _manager(chain, facade, fetch, clock=clock, resilience=policy,
                     sync_budget=50.0)
    with pytest.raises(Exception):
        syncm.sync(N, ["byzantine"])
    assert policy.breaker("byzantine").state == OPEN
    assert facade.last().round == 0
    syncm.sync(N, ["byzantine", "honest"])
    assert facade.last().round == N
    assert store.get(N).signature == chain.beacons[N].signature


def test_sync_server_fills_previous_sig_from_trimmed_store(tmp_path, chain):
    import types
    store = SqliteStore(str(tmp_path / "trimmed.db"))
    for b in chain.beacons.values():
        store.put(b)

    class _NoCb:
        def add_callback(self, *a):
            pass

        def remove_callback(self, *a):
            pass

    facade = types.SimpleNamespace(
        store=store, cbstore=_NoCb(),
        group=types.SimpleNamespace(scheme=chain.scheme))
    stop = threading.Event()
    gen = SyncChainServer(facade).stream("peer", 2, stop=stop)
    got = [next(gen) for _ in range(N - 1)]
    stop.set()
    gen.close()
    assert [b.round for b in got] == list(range(2, N + 1))
    for b in got:
        assert b.previous_sig == chain.beacons[b.round - 1].signature
    store.close()


# -- the same corrupted stores through both packages --------------------------

FAULTS = {"hole-8-forged-5": ({8}, {5: 6}), "holes-2-11": ({2, 11}, {}),
          "forged-1-12": (set(), {1: 2, 12: 11}), "clean": (set(), {})}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_check_past_beacons_equals_the_reference(fault, chain, ref_chain):
    """Holes and rounds carrying another round's signature, through both
    packages' check_past_beacons and correct_past_beacons: the same faulty
    rounds, and the same healed chain."""
    holes, forged = FAULTS[fault]
    out = {}
    for tag, cls, mem, facade_cls, mgr, clock, src, host in (
            ("ref", RefBeacon, RefMemDB, RefFacade, RefSyncManager, RefClock,
             ref_chain, lambda s, p: H.CachedVerifier(RefHost(s, p))),
            ("port", Beacon, MemDBStore, H.ChainFacade, SyncManager,
             FakeClock, chain, cached_host)):
        store = mem(buffer_size=100)
        facade = facade_cls(store, src.scheme.chained,
                            src.info.genesis_seed)
        for r in range(1, N + 1):
            if r in holes:
                continue
            b = src.beacons[r]
            if r in forged:
                b = cls(round=r, signature=src.beacons[forged[r]].signature,
                        previous_sig=b.previous_sig)
            store.put(b)

        def fetch(peer, from_round, src=src):
            for r in range(from_round, N + 1):
                yield src.beacons[r]

        syncm = mgr(chain=facade, scheme=src.scheme,
                    public_key_bytes=src.public, period=30, clock=clock(1),
                    fetch=fetch, peers=["peer0"], chunk=4,
                    verifier=host(src.scheme, src.public))
        faulty = syncm.check_past_beacons(N)
        left = syncm.correct_past_beacons(store, faulty)
        out[tag] = (faulty, left, syncm.check_past_beacons(N),
                    [(b.round, b.signature) for b in store.cursor()])
    assert out["port"] == out["ref"]
    assert bool(out["port"][0]) == (fault != "clean")
    assert out["port"][1] == out["port"][2] == []


def test_catch_up_through_a_peer_server_and_a_service_handle(chain,
                                                              tmp_path):
    """A fresh sqlite node catches up 12 rounds from a peer's
    SyncChainServer (replay, then live-follow: the stream is cancelled
    when the target is reached) through a host verify-service handle on
    the BACKGROUND lane, with the rounds stored as the peer's bytes."""
    from drand_tpu_torch.crypto import verify_service as VS
    server_store = MemDBStore(buffer_size=100)
    server = H.ChainFacade(server_store, chain.scheme.chained,
                           chain.info.genesis_seed)
    for r in range(1, N + 1):
        server.put(chain.beacons[r])
    store = SqliteStore(str(tmp_path / "node.db"))
    node = H.ChainFacade(store, chain.scheme.chained,
                         chain.info.genesis_seed)
    svc = VS.VerifyService(pad=8)
    try:
        handle = svc.handle(chain.scheme, chain.public, device=False)
        streams = []

        def fetch(peer, from_round):
            streams.append(H.PeerStream(SyncChainServer(server), "node",
                                        from_round))
            return streams[-1]

        syncm = _manager(chain, node, fetch, verifier=handle)
        syncm.chunk = 8
        before = svc.stats()
        syncm.sync(N, ["peer0"])
        st = svc.stats()
    finally:
        svc.stop()
    assert node.last().round == N
    assert [(b.round, b.signature) for b in store.cursor()] == \
        [(0, chain.genesis_seed)] + [(r, chain.beacons[r].signature)
                                     for r in range(1, N + 1)]
    assert st["submitted"] - before["submitted"] == 2      # chunks of 8, 4
    assert st["host_served"] - before["host_served"] == 2
    assert all(s._stop.is_set() for s in streams)
    store.close()
    assert np.array_equal(handle.backend.verify_batch(
        [1], [chain.beacons[1].signature], [chain.genesis_seed]), [True])
