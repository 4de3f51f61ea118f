"""The port's beacon engine (drand_tpu_torch/beacon/): ticker, partial
cache, store decorators, and real-crypto networks on the host path.

The 12 cases of tests/test_beacon_engine.py run here against the port, each
rebuilt over the reference module's globals with the engine's names, and
`BeaconScenario`, swapped for the port's (tests/torch_beacon_harness.py;
its handlers check partials with the host factory).
"""

import pytest

import test_beacon_engine as ref_engine
import torch_beacon_harness as H
from torch_service_cases import port_cases

from drand_tpu_torch.beacon import FakeClock, PartialCache, Ticker
from drand_tpu_torch.beacon.stores import (AppendStore, CallbackStore,
                                           DiscrepancyStore,
                                           ErrBeaconAlreadyStored,
                                           SchemeStore)
from drand_tpu_torch.chain import Beacon, MemDBStore, genesis_beacon
from drand_tpu_torch.crypto.schemes import scheme_from_name

NAMES = dict(FakeClock=FakeClock, PartialCache=PartialCache, Ticker=Ticker,
             AppendStore=AppendStore, CallbackStore=CallbackStore,
             DiscrepancyStore=DiscrepancyStore,
             ErrBeaconAlreadyStored=ErrBeaconAlreadyStored,
             SchemeStore=SchemeStore, Beacon=Beacon, MemDBStore=MemDBStore,
             genesis_beacon=genesis_beacon, scheme_from_name=scheme_from_name,
             BeaconScenario=H.BeaconScenario)
CASES = port_cases(ref_engine, NAMES)


def test_all_twelve_cases_are_ported():
    assert len(CASES) == 12


@pytest.mark.parametrize("case", [fn for _, fn in CASES],
                         ids=[n for n, _ in CASES])
def test_reference_case(case):
    case()


def test_handler_subscribes_before_the_ticker_starts(monkeypatch):
    """A node started at or after a round's time gets that round's tick:
    the ticker fires the current round at once, so the Handler subscribes
    before starting it (the reference starts it first and can lose the
    tick).  Started at round 1's time, the one node stores round 1 without
    a clock advance."""
    calls = []
    channel, start = Ticker.channel, Ticker.start
    monkeypatch.setattr(Ticker, "channel", lambda self, *a: (
        calls.append("channel"), channel(self, *a))[1])
    monkeypatch.setattr(Ticker, "start", lambda self: (
        calls.append("start"), start(self))[1])
    sc = H.BeaconScenario(n=1, thr=1, period=30)
    try:
        sc.advance_to_genesis()
        sc.start_all()
        assert calls == ["channel", "start"]
        assert sc.wait_round(0, 1).round == 1
    finally:
        sc.stop_all()


def test_a_check_that_raises_is_counted_logged_and_retried(caplog):
    """With no host fallback behind the partial check, a check that
    raises is counted in beacon_partial_check_errors_total and logged by
    the aggregator, and the round completes when its next partial checks
    the cache again.  Each node's first check (at the second of three
    partials) raises; the third partial's check stores round 1."""
    from drand_tpu_torch import metrics
    from drand_tpu_torch.beacon.chainstore import HostPartialVerifier

    class FailsOnce(HostPartialVerifier):
        calls = 0

        def verify(self, msg, partials):
            self.calls += 1
            if self.calls == 1:
                raise RuntimeError("the card is gone")
            return super().verify(msg, partials)

    errors = metrics.partial_check_errors.labels("default")
    before = errors.value
    caplog.set_level("ERROR", logger="drand_tpu_torch.beacon.chainstore")
    sc = H.BeaconScenario(n=3, thr=2, scheme_id="bls-unchained-on-g1",
                          verifier_factory=lambda s, p, n: FailsOnce(s, p))
    try:
        sc.advance_to_genesis()
        sc.start_all()
        heads = sc.wait_all(1)
    finally:
        sc.stop_all()
    assert {b.round for b in heads} == {1}
    assert len({bytes(b.signature) for b in heads}) == 1
    assert errors.value - before == 3
    failed = [r for r in caplog.records if "failed" in r.getMessage()]
    assert len(failed) == 3
    assert all(r.exc_info and "the card is gone" in str(r.exc_info[1])
               for r in failed)
