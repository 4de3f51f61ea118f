"""The port's crash-safe DKG lifecycle, tenancy and key store
(drand_tpu_torch/core/dkg_journal.py, dkg_runner.py, beacon_process.py,
tenancy.py, config.py, key/store.py).

The cases of tests/test_dkg_lifecycle.py, tests/test_tenancy.py and
tests/test_key.py::test_file_store_roundtrip run against the port, rebuilt
over the reference modules' globals with the port's names (`port_cases`),
their bodies' own imports of the reference naming the port
(`port_imports`).  The lifecycle harness (tests/chaos.py's
DkgLifecycleHarness, _LocalDkgNet and AutoClock) is the port's copy in
tests/torch_daemon_harness.py; the tenancy fixtures are written out here
over the port's device pool and REST edge.  tests/test_tenancy.py's
noisy-neighbor acceptance drives tests/chaos.py's NoisyNeighborScenario,
which builds reference objects; it waits for the port's chaos cases.  Two
cases read a series through prometheus_client's internals
(``._value.get()``); they are written out below over the port's metrics,
whose children hold ``.value``.
"""

import pytest

import test_dkg_lifecycle as ref_lifecycle
import test_key as ref_key
import test_tenancy as ref_tenancy
import torch_beacon_harness as BH
import torch_daemon_harness as DH
from torch_service_cases import port_cases, port_imports

from drand_tpu_torch.beacon.clock import FakeClock
from drand_tpu_torch.chain import MemDBStore, genesis_beacon
from drand_tpu_torch.core import dkg_journal as J
from drand_tpu_torch.core.beacon_process import (DKG_DONE, DKG_FAILED,
                                                 DKG_IN_PROGRESS,
                                                 DKG_NOT_STARTED)
from drand_tpu_torch.core.dkg_journal import DKGJournal, recover
from drand_tpu_torch.core.dkg_runner import run_dkg_bounded
from drand_tpu_torch.core.tenancy import (DEFAULT_TENANT, TenantConfig,
                                          TenantRegistry, registry_path)
from drand_tpu_torch.crypto import schnorr
from drand_tpu_torch.crypto.host import tbls
from drand_tpu_torch.crypto.schemes import list_schemes, scheme_from_name
from drand_tpu_torch.crypto.vault import Vault
from drand_tpu_torch.key import (DistPublic, FileStore, Group, Share,
                                 minimum_t, new_group, new_keypair)
from drand_tpu_torch.key.keys import dkg_auth_sign, dkg_auth_verify
from drand_tpu_torch.key.store import list_beacon_ids
from drand_tpu_torch.log import Logger
from drand_tpu_torch.net import admission as A
from drand_tpu_torch.protos import drand_pb2 as pb

LIFECYCLE = port_cases(ref_lifecycle, dict(
    FakeClock=FakeClock, J=J, DKG_DONE=DKG_DONE, DKG_FAILED=DKG_FAILED,
    DKG_IN_PROGRESS=DKG_IN_PROGRESS, DKGJournal=DKGJournal, recover=recover,
    run_dkg_bounded=run_dkg_bounded, tbls=tbls,
    scheme_from_name=scheme_from_name, DistPublic=DistPublic, Share=Share,
    new_group=new_group, new_keypair=new_keypair, FileStore=FileStore,
    Logger=Logger, pb=pb, AutoClock=DH.AutoClock,
    DkgLifecycleHarness=DH.DkgLifecycleHarness,
    SCHEME=scheme_from_name("pedersen-bls-chained")),
    skip=("test_dkg_metrics_move_on_failure",))

TENANCY = port_cases(ref_tenancy, dict(
    FakeClock=FakeClock, DEFAULT_TENANT=DEFAULT_TENANT,
    TenantConfig=TenantConfig, TenantRegistry=TenantRegistry,
    registry_path=registry_path, AdmissionController=A.AdmissionController,
    Shed=A.Shed, CLASS_CRITICAL=A.CLASS_CRITICAL,
    CLASS_NORMAL=A.CLASS_NORMAL, CLASS_SHEDDABLE=A.CLASS_SHEDDABLE,
    LEVEL_SHED_PUBLIC=A.LEVEL_SHED_PUBLIC, REASON_LEVEL=A.REASON_LEVEL,
    REASON_TENANT_LEVEL=A.REASON_TENANT_LEVEL,
    REASON_TENANT_PAUSED=A.REASON_TENANT_PAUSED,
    REASON_TENANT_RATE=A.REASON_TENANT_RATE,
    REASON_TENANT_SHARE=A.REASON_TENANT_SHARE),
    # drives tests/chaos.py's NoisyNeighborScenario (reference objects)
    skip=("test_noisy_neighbor_scenario",
          "test_quota_gauge_tracks_window_drain"))

KEY = [c for c in port_cases(ref_key, dict(
    schnorr=schnorr, tbls=tbls, list_schemes=list_schemes,
    scheme_from_name=scheme_from_name, Vault=Vault, DistPublic=DistPublic,
    FileStore=FileStore, Group=Group, Share=Share, minimum_t=minimum_t,
    new_group=new_group, new_keypair=new_keypair,
    dkg_auth_sign=dkg_auth_sign, dkg_auth_verify=dkg_auth_verify,
    list_beacon_ids=list_beacon_ids,
    SCH=scheme_from_name("pedersen-bls-chained")))
    if c[0] == "test_file_store_roundtrip"]

CASES = [(f"lifecycle::{n}", f) for n, f in LIFECYCLE] + \
        [(f"tenancy::{n}", f) for n, f in TENANCY] + \
        [(f"key::{n}", f) for n, f in KEY]


class _Dev:
    pass


@pytest.fixture
def fake_pool():
    from drand_tpu_torch.crypto.device_pool import (
        DevicePool, _reset_inventory_for_tests)
    _reset_inventory_for_tests([_Dev() for _ in range(4)])
    yield DevicePool()          # 4 groups of 1
    _reset_inventory_for_tests(None)


@pytest.fixture
def rest_edge(tmp_path):
    """The port's REST edge over a 4-round chain, with a tenant registry
    and an admission controller that reads it."""
    from drand_tpu_torch.http_server import RestServer

    clock = FakeClock(1000.0)
    reg = TenantRegistry(path=str(tmp_path / "tenants.json"), clock=clock,
                         device_window=30.0)
    chain = BH.MockChain(n=4)
    store = MemDBStore(buffer_size=16)
    store.put(genesis_beacon(chain.info.genesis_seed))
    store.put_many(chain.beacons[r] for r in range(1, 5))
    daemon = BH.ShimDaemon(BH.ShimProcess.of_store(chain.info, store))
    daemon.tenancy = reg
    ctrl = A.AdmissionController(clock=clock, capacity=16,
                                 critical_reserve=2, tenancy=reg)
    server = RestServer(daemon, "127.0.0.1:0", admission=ctrl)
    server.start()
    yield reg, server, ctrl
    server.stop()


@pytest.mark.parametrize("case", [f for _, f in CASES],
                         ids=[n for n, _ in CASES])
def test_reference_case(case, request):
    params = case.__code__.co_varnames[:case.__code__.co_argcount]
    port_imports(case)(**{p: request.getfixturevalue(p) for p in params})


def test_dkg_metrics_move_on_failure(tmp_path):
    from drand_tpu_torch.metrics import dkg_sessions
    h = DH.DkgLifecycleHarness(str(tmp_path), n=2)
    try:
        series = dkg_sessions.labels("default", "dkg", J.FAILED)
        before = series.value
        h.bps[0]._fail_session("dkg", b"\x10" * 32)
        assert series.value == before + 1
    finally:
        h.stop_all()


def test_quota_gauge_tracks_window_drain(tmp_path):
    """The tenant_quota_level gauge follows the rolling window down when a
    tenant goes idle: admission_view and snapshot() both refresh it."""
    from drand_tpu_torch.metrics import tenant_quota_level
    clock = FakeClock(1000.0)
    reg = TenantRegistry(path=str(tmp_path / "tenants.json"), clock=clock,
                         device_window=10.0)
    reg.set_tenant(TenantConfig(name="spiky", device_budget=0.1))
    reg.account_device_time("spiky", 5.0)       # 5x the window budget
    gauge = tenant_quota_level.labels("spiky")
    assert gauge.value >= 1.0
    clock.advance(11.0)                         # window drains, no traffic
    reg.snapshot()                              # a /health scrape
    assert gauge.value == 0.0
    reg.account_device_time("spiky", 5.0)
    clock.advance(11.0)
    reg.admission_view("spiky")                 # an admission consult
    assert gauge.value == 0.0


# -- the Handel gate where a group's size is first known ---------------------

def _share_local_group(h, threshold=2):
    """Give every node of `h` a share of one locally made group, as a
    finished DKG leaves it, and return the group."""
    scheme = scheme_from_name("pedersen-bls-chained")
    group = new_group([bp.pair.public for bp in h.bps.values()], threshold,
                      genesis=int(h.clock.now()) + 60, period=h.period,
                      catchup_period=5, scheme=scheme)
    poly = tbls.PriPoly.random(threshold, secret=4242)
    commits = [scheme.key_group.to_bytes(c)
               for c in poly.commit(scheme.key_group).commits]
    group.public_key = DistPublic(commits)
    for bp in h.bps.values():
        me = next(n for n in group.nodes
                  if n.identity.addr == bp.pair.public.addr)
        bp.group = group
        bp.share = Share(scheme=scheme, private=poly.eval(me.index),
                         commits=commits)
    return group


@pytest.mark.parametrize("kind", ["dkg", "reshare"])
def test_leader_refuses_a_handel_size_group_before_its_setup(tmp_path,
                                                             kind):
    """A leader asked for a group at Handel size raises before its setup
    manager, journal or status move: nothing waits for participants."""
    h = DH.DkgLifecycleHarness(str(tmp_path), n=3)
    try:
        old = _share_local_group(h)
        leader = h.bps[0]
        h.cfgs[0].handel_min_group = 3
        with pytest.raises(NotImplementedError, match="beacon/handel.py"):
            if kind == "dkg":
                leader.init_dkg_leader(
                    n_nodes=3, threshold=2, period=30, catchup_period=5,
                    secret=b"s", setup_timeout=5.0,
                    scheme=scheme_from_name("pedersen-bls-chained"))
            else:
                leader.init_reshare_leader(old, n_nodes=3, threshold=2,
                                           secret=b"s", setup_timeout=5.0)
        assert leader._setup_manager is None
        assert leader.dkg_status == leader.reshare_status == DKG_NOT_STARTED
        assert leader.journal.load_session() is None
        assert leader.group is old
    finally:
        h.stop_all()


def test_reshare_joiner_refuses_a_handel_size_group_before_the_ceremony(
        tmp_path):
    """A joiner whose gate the new group reaches (its leader's gate is
    the default) raises as soon as the group reaches it, before any
    ceremony: its session fails, nothing is staged, its group and share
    stay, and no transition is pending.  The leader reshares to itself
    and the joiner (a group of 2, the joiner's gate); once the joiner has
    refused, the clock jumps until the leader's session gives up."""
    import threading

    from drand_tpu_torch.net import Peer

    h = DH.DkgLifecycleHarness(str(tmp_path), n=3,
                               clock=DH.AutoClock(start=1_700_000_000.0))
    try:
        old = _share_local_group(h)
        leader, bp = h.bps[0], h.bps[1]
        share = bp.share
        h.cfgs[1].handel_min_group = 2
        lead_err = []

        def reshare():
            try:
                leader.init_reshare_leader(old, n_nodes=2, threshold=2,
                                           secret=h.SECRET,
                                           setup_timeout=20.0)
            except Exception as e:      # noqa: BLE001 — asserted below
                lead_err.append(e)

        lead = threading.Thread(target=reshare, daemon=True,
                                name="resh-leader")
        lead.start()
        h._await_setup(leader)
        with pytest.raises(NotImplementedError, match="beacon/handel.py"):
            bp.join_reshare(leader=Peer(h.addrs[0]), old_group=old,
                            secret=h.SECRET, setup_timeout=20.0)
        assert bp.reshare_status == DKG_FAILED
        assert bp._board is None
        assert bp.group is old and bp.share is share
        assert bp.fs.load_group(staged=True) is None
        assert bp.journal.load_pending() is None
        for _ in range(150):
            if not lead.is_alive():
                break
            h.clock.jump(600)
            lead.join(timeout=0.2)
        assert not lead.is_alive() and lead_err    # its session failed
    finally:
        h.stop_all()
