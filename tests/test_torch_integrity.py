"""The port's chain-integrity scanner (drand_tpu_torch/chain/integrity.py)
and `SyncManager.heal`.

The scanner cases of tests/test_integrity.py run here against the port,
rebuilt over the reference module's globals with the scanner's names
swapped for the port's (tests/torch_service_cases.py) and the port's
`HostBatchVerifier` behind a memo (tests/torch_beacon_harness.py
`CachedVerifier`: its own verdicts, each (round, signature, previous)
computed once).  The cases that build the reference's storage chaos, chain
doctor or daemon glue stay with the reference; the heal cases are written
out below over the port's `SyncManager` and a facade in place of
core/follow.py's.  Then the same corrupted stores (seeded fault plans and
hand-made faults, memdb and trimmed sqlite) are scanned by both packages:
the findings, as (round, kind), are equal.
"""

import pytest

import test_integrity as ref_integ
import torch_beacon_harness as H
from chaos import (BIT_FLIP, DELETED_ROW, StorageFaultPlan, TrueChain,
                   stable_seed)
from torch_service_cases import port_cases

from drand_tpu.chain import integrity as ref_I
from drand_tpu.chain.beacon import Beacon as RefBeacon
from drand_tpu.chain.memdb import MemDBStore as RefMemDB
from drand_tpu.chain.sqlitedb import SqliteStore as RefSqlite
from drand_tpu.crypto.hostverify import HostBatchVerifier as RefHost
from drand_tpu_torch import metrics
from drand_tpu_torch.chain import integrity as port_I
from drand_tpu_torch.beacon.clock import FakeClock
from drand_tpu_torch.beacon.sync import SyncManager
from drand_tpu_torch.chain.beacon import Beacon, genesis_beacon
from drand_tpu_torch.chain.integrity import (INVALID_SIG, MALFORMED, MISSING,
                                             UNLINKED, IntegrityScanner)
from drand_tpu_torch.chain.memdb import MemDBStore
from drand_tpu_torch.chain.sqlitedb import SqliteStore
from drand_tpu_torch.crypto.hostverify import HostBatchVerifier

N = ref_integ.N
_MEMO = {}


def cached_host(scheme, public):
    """The port's host verifier, one memo per (scheme, key) for the
    module."""
    key = ("port", scheme.id, bytes(public))
    if key not in _MEMO:
        _MEMO[key] = H.CachedVerifier(HostBatchVerifier(scheme, public))
    return _MEMO[key]


def cached_ref_host(scheme, public):
    key = ("ref", scheme.id, bytes(public))
    if key not in _MEMO:
        _MEMO[key] = H.CachedVerifier(RefHost(scheme, public))
    return _MEMO[key]


NAMES = dict(Beacon=Beacon, genesis_beacon=genesis_beacon,
             INVALID_SIG=INVALID_SIG, MALFORMED=MALFORMED, MISSING=MISSING,
             UNLINKED=UNLINKED, IntegrityScanner=IntegrityScanner,
             MemDBStore=MemDBStore, SqliteStore=SqliteStore,
             HostBatchVerifier=cached_host)
NOT_PORTED = (
    # the reference's storage chaos scenario and its fault plan
    "test_storage_chaos_detect_quarantine_repair_converge",
    "test_storage_chaos_deterministic_replay",
    "test_fault_plan_is_pure_function_of_seed",
    # tools/chain_doctor.py and core/beacon_process.py glue
    "test_chain_doctor_scan_clean_uses_device_verifier",
    "test_chain_doctor_repair_from_db", "test_chain_doctor_repair_linkage_mode",
    "test_startup_integrity_pass_glue",
    "test_startup_scan_catches_head_truncation",
    "test_scheduled_scan_resumes_and_reports_metric",
    # written out below for the port
    "test_quarantine_plain_list_skips_absent_rounds",
    "test_heal_with_scan_report_quarantines_and_repairs",
    "test_heal_promotes_unprovable_successor_without_refetch",
    "test_heal_refetches_unprovable_when_promotion_fails")
CASES = port_cases(ref_integ, NAMES, skip=NOT_PORTED)

pytestmark = pytest.mark.storage


@pytest.fixture(scope="module")
def ref_chain():
    return TrueChain(n=N)


@pytest.fixture(scope="module")
def chain(ref_chain):
    return H.PortChain(ref_chain)


@pytest.mark.parametrize("case", [fn for _, fn in CASES],
                         ids=[n for n, _ in CASES])
def test_reference_case(case, request):
    params = case.__code__.co_varnames[:case.__code__.co_argcount]
    case(**{p: request.getfixturevalue(p) for p in params})


def _seeded(chain, store=None, upto=N):
    store = store if store is not None else MemDBStore(buffer_size=100)
    for r in range(1, upto + 1):
        store.put(chain.beacons[r])
    return store


def _scanner(chain, store, beacon_id="test-integrity"):
    return IntegrityScanner(store, chain.scheme,
                            verifier=cached_host(chain.scheme, chain.public),
                            genesis_seed=chain.genesis_seed, chunk=8,
                            beacon_id=beacon_id)


def _manager(chain, store, fetch):
    facade = H.ChainFacade(store, chain.scheme.chained, chain.genesis_seed)
    return SyncManager(
        chain=facade, scheme=chain.scheme, public_key_bytes=chain.public,
        period=30, clock=FakeClock(1), fetch=fetch, peers=["peer0"],
        chunk=8, verifier=cached_host(chain.scheme, chain.public))


def _inject(store, beacon_cls, plan):
    """tests/chaos.py inject_storage_faults for either package's Beacon."""
    faults = plan.assign(N)
    for r, kind in sorted(faults.items()):
        if kind == DELETED_ROW:
            store.delete(r)
        elif kind == BIT_FLIP:
            H.flip_bit(store, beacon_cls, r)
        else:
            H.tear(store, beacon_cls, r)
    return faults


def test_quarantine_plain_list_skips_absent_rounds(chain):
    store = _seeded(chain)
    store.delete(6)
    scanner = IntegrityScanner(store, chain.scheme,
                               beacon_id="test-quarantine-plain")
    child = metrics.integrity_quarantined.labels("test-quarantine-plain")
    before = child.value
    assert scanner.quarantine([3, 6]) == [3]
    assert child.value == before + 1


def test_heal_with_scan_report_quarantines_and_repairs(chain):
    victim = _seeded(chain)
    _inject(victim, Beacon, StorageFaultPlan(seed=stable_seed(11, "heal")))

    def fetch(peer, from_round):
        for r in range(from_round, N + 1):
            yield chain.beacons[r]

    syncm = _manager(chain, victim, fetch)
    scanner = _scanner(chain, victim)
    report = scanner.scan(mode="full", upto=N)
    assert not report.clean
    q = metrics.integrity_quarantined.labels("test-heal")
    rep = metrics.integrity_repaired.labels("test-heal")
    q_before, r_before = q.value, rep.value
    assert syncm.heal(victim, report, beacon_id="test-heal") == []
    assert q.value > q_before
    assert rep.value == r_before + len(report.faulty_rounds)
    assert scanner.scan(mode="full", upto=N).clean


@pytest.mark.parametrize("forge_successor", [False, True])
def test_heal_promotes_or_refetches_the_unprovable_successor(
        chain, forge_successor):
    """Round 10 bit-flipped makes round 11 UNPROVABLE.  With 11's own bytes
    intact, heal re-fetches only 10 and promotes 11 from the quarantine
    side table; with 11 forged too, promotion refuses it and 11 is
    re-fetched."""
    victim = _seeded(chain)
    for r in (10, 11) if forge_successor else (10,):
        H.flip_bit(victim, Beacon, r, at=4)
    scanner = _scanner(chain, victim)
    report = scanner.scan(mode="full", upto=N)
    assert 10 in report.rounds(INVALID_SIG)
    assert {f.kind for f in report.findings if f.round == 11} == {UNLINKED}
    # with 11 forged, 12 fails against it and is unprovable in turn
    assert report.faulty_rounds == ([10, 11, 12] if forge_successor
                                    else [10, 11])
    fetched = []

    def fetch(peer, from_round):
        fetched.append(from_round)
        for r in range(from_round, N + 1):
            yield chain.beacons[r]

    syncm = _manager(chain, victim, fetch)
    promoted = metrics.integrity_promoted.labels("test-promote")
    p_before = promoted.value
    assert syncm.heal(victim, report, beacon_id="test-promote") == []
    assert 10 in fetched
    assert (11 in fetched) == forge_successor
    if not forge_successor:
        assert promoted.value == p_before + 1
    assert victim.tombstoned(11) is None
    assert victim.get(11).signature == chain.beacons[11].signature
    assert scanner.scan(mode="full", upto=N).clean


# -- the same corrupted stores through both packages --------------------------

RECIPES = {
    "plan-11": ("plan", 11), "plan-42": ("plan", 42), "plan-7": ("plan", 7),
    "flip-10-and-11": ("flip", (10, 11)),
    "hole-and-tear": ("mixed", None),
    "unlinked-previous": ("unlinked", 10),
}


def _corrupt(recipe, store, beacon_cls):
    kind, arg = RECIPES[recipe]
    if kind == "plan":
        _inject(store, beacon_cls, StorageFaultPlan(
            seed=stable_seed(arg, "differential"), torn_writes=1,
            bit_flips=2, deleted_rows=1))
    elif kind == "flip":
        for r in arg:
            H.flip_bit(store, beacon_cls, r, at=4)
    elif kind == "mixed":
        store.delete(5)
        H.tear(store, beacon_cls, 9)
        H.flip_bit(store, beacon_cls, 14, at=7)
        for r in range(N - 1, N + 1):
            store.delete(r)
    else:
        b = store.get(arg)
        store.delete(arg)
        store.put(beacon_cls(round=arg, signature=b.signature,
                             previous_sig=b"\x13" * 96))


@pytest.mark.parametrize("recipe,engine", [
    (r, e) for r in sorted(RECIPES) for e in ("memdb", "sqlite")
    # a trimmed store keeps no previous signature to contradict
    if (r, e) != ("unlinked-previous", "sqlite")])
def test_findings_equal_the_reference(recipe, engine, chain, ref_chain,
                                      tmp_path):
    found = {}
    for tag, beacon_cls, mem, sql, I, host, beacons, scheme in (
            ("ref", RefBeacon, RefMemDB, RefSqlite, ref_I, cached_ref_host,
             ref_chain.beacons, ref_chain.scheme),
            ("port", Beacon, MemDBStore, SqliteStore, port_I, cached_host,
             chain.beacons, chain.scheme)):
        store = mem(buffer_size=100) if engine == "memdb" \
            else sql(str(tmp_path / f"{tag}.db"))
        for r in range(1, N + 1):
            store.put(beacons[r])
        _corrupt(recipe, store, beacon_cls)
        scanner = I.IntegrityScanner(
            store, scheme, verifier=host(scheme, chain.public),
            genesis_seed=chain.genesis_seed, chunk=8,
            beacon_id="test-differential")
        found[tag] = {mode: [(f.round, f.kind) for f in
                             scanner.scan(mode=mode, upto=N).findings]
                      for mode in ("linkage", "full")}
        store.close()
    assert found["port"] == found["ref"]
    assert found["port"]["full"], "the recipe planted no finding"
