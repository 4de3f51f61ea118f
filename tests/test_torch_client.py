"""The port's client stack (drand_tpu_torch/client/): tests/test_client.py's
grpc-free cases over the port, and the port's VerifyingClient against the
reference's on the same chain: equal results, and raising on the same
rounds with the same message.

Every verification here is a span under 64 rounds, so both clients check
on their verify service's host handle (the reference's device branch
compiles JAX for minutes); the port's device branch is held in
tests/test_torch_edge_walk.py.
"""

import threading

import pytest

from drand_tpu_torch.beacon.clock import FakeClock
from drand_tpu_torch.chain.beacon import Beacon
from drand_tpu_torch.client import (CachingClient, From, OptimizingClient,
                                    VerifyingClient, WatchAggregator,
                                    new_client, with_chain_hash)
from drand_tpu_torch.crypto import verify_service as VS

from torch_beacon_harness import MockChain, MockSource


@pytest.fixture(scope="module")
def chain():
    return MockChain()


@pytest.fixture(autouse=True, scope="module")
def service():
    """A process-default port service for the module (host handles only),
    stopped at the end."""
    svc = VS.VerifyService(clock=FakeClock(0.0))
    old = VS.set_service(svc)
    yield svc
    VS.set_service(old)
    svc.stop()


def _tampered(chain, r, **kw):
    b = chain.beacons[r]
    out = dict(chain.beacons)
    out[r] = Beacon(round=r, signature=kw.get("signature", b.signature),
                    previous_sig=kw.get("previous_sig", b.previous_sig))
    return out


# -- tests/test_client.py over the port ---------------------------------------


def test_verifying_client_accepts_valid(chain):
    vc = VerifyingClient(MockSource(chain), info=chain.info)
    r = vc.get(3)
    assert r.round == 3
    assert r.randomness == chain.beacons[3].randomness()


def test_verifying_client_rejects_corrupt(chain):
    bad = chain.beacons[2]
    src = MockSource(chain, beacons=_tampered(
        chain, 2, signature=b"\x01" + bad.signature[1:]))
    vc = VerifyingClient(src, info=chain.info)
    with pytest.raises(ValueError):
        vc.get(2)


def test_verifying_client_strict_chained_walk(chain):
    """Strict mode verifies the whole span from the trust point — and spots
    a linkage break the per-round check can't see."""
    src = MockSource(chain)
    vc = VerifyingClient(src, info=chain.info, strict=True)
    r = vc.get(4)
    assert r.round == 4
    # walk pulled rounds 1..4; the next strict get continues from trust
    gets_before = src.gets
    vc.get(5)
    assert src.gets - gets_before <= 2  # only round 5 (+maybe latest probe)


def test_caching_client(chain):
    src = MockSource(chain)
    cc = CachingClient(VerifyingClient(src, info=chain.info))
    a = cc.get(3)
    before = src.gets
    b = cc.get(3)
    assert src.gets == before  # served from cache
    assert a == b


def test_optimizing_client_failover(chain):
    down = MockSource(chain, fail=True)
    up = MockSource(chain, latency=0.01)
    oc = OptimizingClient([down, up])
    r = oc.get(1)
    assert r.round == 1
    assert oc.info().hash() == chain.info.hash()


def test_watch_aggregator_fanout(chain):
    agg = WatchAggregator(MockSource(chain))
    got1, got2 = [], []
    stop = threading.Event()

    def sub(sink):
        for r in agg.watch(stop):
            sink.append(r.round)
            if len(sink) >= 3:
                return

    t1 = threading.Thread(target=sub, args=(got1,))
    t2 = threading.Thread(target=sub, args=(got2,))
    t1.start(), t2.start()
    t1.join(10), t2.join(10)
    stop.set()
    agg.close()
    assert len(got1) >= 3 and len(got2) >= 3


def test_new_client_pipeline_with_chain_hash(chain):
    c = new_client(From(MockSource(chain)),
                   with_chain_hash(chain.info.hash_string()))
    r = c.get(2)
    assert r.round == 2
    assert c.round_at(chain.info.genesis_time) == 1
    c.close()


def test_new_client_rejects_wrong_chain_hash(chain):
    with pytest.raises(ValueError):
        new_client(From(MockSource(chain)), with_chain_hash("ab" * 32))


def test_verifying_client_strict_historical_get(chain):
    """After trusting a later round, strict mode must still serve earlier
    rounds (no spurious linkage failure walking 'backwards')."""
    vc = VerifyingClient(MockSource(chain), info=chain.info, strict=True)
    assert vc.get(5).round == 5          # trust point at round 5
    assert vc.get(2).round == 2          # historical get succeeds
    assert vc.get(5).round == 5          # repeated get at the trust point


def test_single_gets_ride_the_host_handle(chain, service):
    """Routing by size: a get, and a strict walk under 64 rounds, go to
    the service's host handle; no device handle is made."""
    vc = VerifyingClient(MockSource(chain), info=chain.info, strict=True)
    before = service.stats()["host_served"]
    vc.get(3)
    assert vc._device_verifier is None
    assert service.stats()["host_served"] > before


# -- the port's VerifyingClient against the reference's -----------------------


def _ref_chain(chain, beacons):
    """The same chain in the reference's types: its Info and Beacons."""
    from drand_tpu.chain.beacon import Beacon as RB
    from drand_tpu.chain.info import Info as RI
    i = chain.info
    info = RI(public_key=i.public_key, period=i.period,
              genesis_time=i.genesis_time, genesis_seed=i.genesis_seed,
              scheme=i.scheme, beacon_id=i.beacon_id)
    return info, {r: RB(round=b.round, signature=b.signature,
                        previous_sig=b.previous_sig)
                  for r, b in beacons.items()}


def _ref_source(info, beacons):
    """A reference-side Client over the reference's beacon copies."""
    from drand_tpu.client.interface import Client, Result

    class RefSource(Client):
        def get(self, round_=0):
            return Result.from_beacon(beacons[round_ or max(beacons)])

        def watch(self, stop=None):
            return iter(())

        def info(self):
            return info
    return RefSource()


def _outcome(client, rounds):
    """Each get's (round, randomness, signature, previous signature), or
    the error it raised, in order."""
    out = []
    for r in rounds:
        try:
            res = client.get(r)
            out.append(("ok", res.round, res.randomness, res.signature,
                        res.previous_signature))
        except ValueError as e:
            out.append(("error", str(e)))
    return out


@pytest.fixture(scope="module")
def ref_service():
    from drand_tpu.beacon.clock import FakeClock as RefClock
    from drand_tpu.crypto import verify_service as RVS
    svc = RVS.VerifyService(clock=RefClock(0.0))
    old = RVS.set_service(svc)
    yield svc
    RVS.set_service(old)
    svc.stop()


@pytest.mark.parametrize("case,strict,rounds", [
    ("valid", False, [3, 1]),
    ("valid", True, [4, 6]),
    ("corrupt_signature", False, [2, 3]),
    ("corrupt_signature", True, [3]),
    ("broken_linkage", True, [5]),
    ("historical", True, [5, 2, 5]),
])
def test_client_verdicts_equal_the_reference(chain, ref_service, case,
                                              strict, rounds):
    from drand_tpu.client import VerifyingClient as RefVerifyingClient
    if case == "corrupt_signature":
        bad = chain.beacons[2].signature
        beacons = _tampered(chain, 2, signature=bad[:-1] + bytes(
            [bad[-1] ^ 0x01]))
    elif case == "broken_linkage":
        beacons = _tampered(chain, 4, previous_sig=chain.beacons[2].signature)
    else:
        beacons = chain.beacons
    port = VerifyingClient(MockSource(chain, beacons=beacons),
                           info=chain.info, strict=strict)
    rinfo, rbeacons = _ref_chain(chain, beacons)
    ref = RefVerifyingClient(_ref_source(rinfo, rbeacons), info=rinfo,
                             strict=strict)
    got, want = _outcome(port, rounds), _outcome(ref, rounds)
    assert got == want
    if case in ("corrupt_signature", "broken_linkage"):
        assert any(o[0] == "error" for o in got)
    else:
        assert all(o[0] == "ok" for o in got)
