"""The port's network plane (drand_tpu_torch/net/, protos/): codecs, the
gRPC listener / client / control plane, and admission over real gRPC.

The cases of tests/test_net.py run against the port, rebuilt over the
reference module's globals with the port's names (`port_cases`); its
loopback fixture and its control-plane case are written out here, since
their service impls live in the reference module.  The three gRPC cases of
tests/test_admission.py run on the same `admitted_loopback` fixture,
written out with the port's Listener and AdmissionController.

Then a seeded differential: the port's `net/convert` and the reference's
serialize beacons, chain infos, groups and DKG bundles of all three schemes
to the same bytes, and the port's protos carry the reference's serialized
descriptor byte for byte, so both load in one process and share their
message classes.
"""

import threading
from pathlib import Path

import numpy as np
import pytest

import test_net as ref_net
from torch_service_cases import port_cases

from drand_tpu.chain.beacon import Beacon as RefBeacon
from drand_tpu.chain.info import Info as RefInfo
from drand_tpu.crypto import dkg as RefD
from drand_tpu.crypto.schemes import scheme_from_name as ref_scheme
from drand_tpu.crypto.tbls import PriPoly as RefPriPoly
from drand_tpu.key.group import new_group as ref_new_group
from drand_tpu.key.keys import DistPublic as RefDistPublic
from drand_tpu.key.keys import new_keypair as ref_new_keypair
from drand_tpu.net import convert as ref_convert
from drand_tpu.protos import drand_pb2 as ref_pb
from drand_tpu_torch.beacon.clock import FakeClock
from drand_tpu_torch.chain.beacon import Beacon
from drand_tpu_torch.chain.info import Info
from drand_tpu_torch.crypto import dkg as D
from drand_tpu_torch.crypto.host.tbls import PriPoly
from drand_tpu_torch.crypto.schemes import (DEFAULT_SCHEME_ID, list_schemes,
                                            scheme_from_name)
from drand_tpu_torch.key.group import new_group
from drand_tpu_torch.key.keys import DistPublic, new_keypair
from drand_tpu_torch.net import (ControlClient, ControlListener, Listener,
                                 Peer, ProtocolClient, services)
from drand_tpu_torch.net import convert
from drand_tpu_torch.net.admission import (CLASS_SHEDDABLE,
                                           AdmissionController)
from drand_tpu_torch.protos import drand_pb2 as pb

REPO = Path(__file__).resolve().parents[1]

NAMES = dict(Beacon=Beacon, Info=Info, D=D, scheme_from_name=scheme_from_name,
             new_group=new_group, new_keypair=new_keypair,
             ControlClient=ControlClient, ControlListener=ControlListener,
             Listener=Listener, Peer=Peer, ProtocolClient=ProtocolClient,
             services=services, convert=convert, pb=pb)
# its _Control impl lists the reference's schemes: written out below
CASES = port_cases(ref_net, NAMES, skip=("test_control_plane_loopback",))


@pytest.fixture(scope="module")
def scheme():
    return scheme_from_name(DEFAULT_SCHEME_ID)


class _Protocol:
    """Loopback Protocol impl: records partials, serves a canned stream."""

    def __init__(self):
        self.partials = []
        self.event = threading.Event()

    def get_identity(self, req, ctx):
        return pb.IdentityResponse(address="me", key=b"k",
                                   schemeName=DEFAULT_SCHEME_ID)

    def partial_beacon(self, req, ctx):
        self.partials.append((req.round, req.partial_sig,
                              req.metadata.beaconID))
        self.event.set()
        return pb.Empty()

    def sync_chain(self, req, ctx):
        for r in range(req.from_round, req.from_round + 5):
            yield pb.BeaconPacket(round=r, signature=bytes([r]) * 4)

    def status(self, req, ctx):
        return pb.StatusResponse(
            beacon=pb.BeaconStatusPart(is_running=True))

    def signal_dkg_participant(self, req, ctx):
        return pb.Empty()

    def push_dkg_info(self, req, ctx):
        return pb.Empty()

    def metrics(self, req, ctx):
        return pb.MetricsResponse(metrics=b"# loopback\n")

    def broadcast_dkg(self, req, ctx):
        return pb.Empty()

    def handel_aggregate(self, req, ctx):
        self.partials.append((req.round, tuple(req.partial_sigs),
                              req.metadata.beaconID))
        self.event.set()
        return pb.Empty()


class _Public:
    def public_rand(self, req, ctx):
        return pb.PublicRandResponse(round=req.round or 99,
                                     signature=b"sig")

    def public_rand_stream(self, req, ctx):
        for r in (1, 2):
            yield pb.PublicRandResponse(round=r)

    def chain_info(self, req, ctx):
        return pb.ChainInfoPacket(period=30, schemeID=DEFAULT_SCHEME_ID)

    def home(self, req, ctx):
        return pb.HomeResponse(status="serving")


@pytest.fixture()
def loopback():
    impl = _Protocol()
    lis = Listener("127.0.0.1:0",
                   [(services.PROTOCOL, impl), (services.PUBLIC, _Public())])
    lis.start()
    client = ProtocolClient()
    yield client, Peer(f"127.0.0.1:{lis.port}"), impl
    client.close()
    lis.stop()


@pytest.mark.parametrize("case", [fn for _, fn in CASES],
                         ids=[n for n, _ in CASES])
def test_reference_case(case, request):
    params = case.__code__.co_varnames[:case.__code__.co_argcount]
    case(**{p: request.getfixturevalue(p) for p in params})


class _Control:
    def ping_pong(self, req, ctx):
        return pb.Pong()

    def list_schemes(self, req, ctx):
        return pb.ListSchemesResponse(ids=list_schemes())

    def __getattr__(self, name):
        def _unimpl(req, ctx):
            return pb.Empty()
        return _unimpl


def test_control_plane_loopback():
    lis = ControlListener(_Control(), port=0)
    lis.start()
    cc = ControlClient(lis.port)
    cc.stub.ping_pong(pb.Ping(), timeout=5)
    ids = list(cc.stub.list_schemes(pb.ListSchemesRequest(), timeout=5).ids)
    assert DEFAULT_SCHEME_ID in ids
    assert ids == ["pedersen-bls-chained", "pedersen-bls-unchained",
                   "bls-unchained-on-g1"]
    cc.close()
    lis.stop()


# -- admission over real gRPC (tests/test_admission.py:292-415) --------------

def _controller(**kw):
    kw.setdefault("clock", FakeClock(1_000.0))
    kw.setdefault("capacity", 6)
    kw.setdefault("critical_reserve", 2)
    kw.setdefault("shed_wait", 0.5)
    kw.setdefault("recover_wait", 0.05)
    kw.setdefault("dwell", 2.0)
    kw.setdefault("normal_wait", 1.0)
    return AdmissionController(**kw)


@pytest.fixture()
def admitted_loopback():
    release = threading.Event()

    class _AdmProtocol:
        def partial_beacon(self, req, ctx):
            return pb.Empty()

        def sync_chain(self, req, ctx):
            yield pb.BeaconPacket(round=req.from_round,
                                  signature=b"\x01" * 4)
            release.wait(10)    # hold the stream open for the cap test

        def __getattr__(self, name):
            def f(req, ctx):
                return pb.Empty()
            return f

    class _AdmPublic:
        def public_rand(self, req, ctx):
            return pb.PublicRandResponse(round=req.round or 7,
                                         signature=b"sig")

        def __getattr__(self, name):
            def f(req, ctx):
                return pb.Empty()
            return f

    ctrl = _controller(capacity=8, critical_reserve=2,
                       max_streams_per_peer=2)
    lis = Listener("127.0.0.1:0",
                   [(services.PROTOCOL, _AdmProtocol()),
                    (services.PUBLIC, _AdmPublic())], admission=ctrl)
    lis.start()
    client = ProtocolClient()
    yield client, Peer(f"127.0.0.1:{lis.port}"), ctrl, release
    release.set()
    client.close()
    lis.stop()


def test_grpc_resource_exhausted_shape(admitted_loopback):
    import grpc

    client, peer, ctrl, release = admitted_loopback
    assert client.public_rand(peer).round == 7
    held = [ctrl.admit(CLASS_SHEDDABLE) for _ in range(6)]  # pool full
    with pytest.raises(grpc.RpcError) as e:
        client.public_rand(peer)
    assert e.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
    md = dict(e.value.trailing_metadata() or ())
    assert float(md["retry-after"]) > 0
    assert "sheddable" in e.value.details()
    # critical (partials) rides the reserve straight through
    client.partial_beacon(peer, pb.PartialBeaconPacket(
        round=1, partial_sig=b"x"))
    for t in held:
        t.release()


def test_sync_chain_per_peer_cap_over_grpc(admitted_loopback):
    import grpc

    client, peer, ctrl, release = admitted_loopback
    s1 = client.sync_chain(peer, 1)
    s2 = client.sync_chain(peer, 1)
    assert next(iter(s1)).round == 1        # both streams admitted
    assert next(iter(s2)).round == 1
    s3 = client.sync_chain(peer, 1)
    with pytest.raises(grpc.RpcError) as e:
        next(iter(s3))
    assert e.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
    release.set()                           # drain + release the streams
    list(s1), list(s2)


def test_grpc_worker_pool_sized_past_the_token_pool(admitted_loopback):
    """A Listener built with an admission controller sizes its executor
    past `capacity`, so the interceptor runs before any queueing."""
    from concurrent import futures as _f

    _, _, ctrl, _ = admitted_loopback
    captured = {}
    orig = _f.ThreadPoolExecutor

    class Spy(orig):
        def __init__(self, max_workers=None, **kw):
            captured["max_workers"] = max_workers
            super().__init__(max_workers=max_workers, **kw)

    _f.ThreadPoolExecutor = Spy
    try:
        lis = Listener("127.0.0.1:0", [], admission=ctrl)
    finally:
        _f.ThreadPoolExecutor = orig
    try:
        assert captured["max_workers"] >= ctrl.capacity + 8
    finally:
        lis.stop()


# -- the protos: one serialized descriptor, shared classes -------------------

def test_protos_carry_the_reference_descriptor():
    port = (REPO / "drand_tpu_torch/protos/drand_pb2.py").read_text()
    ref = (REPO / "drand_tpu/protos/drand_pb2.py").read_text()

    def serialized(src):
        return [ln for ln in src.splitlines()
                if "AddSerializedFile(" in ln]

    assert serialized(port) == serialized(ref) and serialized(port)
    assert pb.DESCRIPTOR.serialized_pb == ref_pb.DESCRIPTOR.serialized_pb
    assert pb.Metadata is ref_pb.Metadata
    assert pb.BeaconPacket is ref_pb.BeaconPacket


# -- seeded differential: the same bytes from both codecs --------------------

SCHEMES = ["pedersen-bls-chained", "pedersen-bls-unchained",
           "bls-unchained-on-g1"]


def _wire(msg) -> bytes:
    return msg.SerializeToString(deterministic=True)


@pytest.fixture(scope="module", params=SCHEMES)
def material(request):
    """One scheme's objects, built alike in both packages from one seeded
    generator: beacons (a chained one with its previous signature), a chain
    info, a 4-node group with its collective key, and DKG bundles."""
    sid = request.param
    rng = np.random.default_rng(2024 + SCHEMES.index(sid))
    ps, rs = scheme_from_name(sid), ref_scheme(sid)
    sig_len, key_len = ps.sig_group.point_len, ps.key_group.point_len
    seeds = [rng.bytes(16) for _ in range(4)]
    coeffs = [int.from_bytes(rng.bytes(31), "big") for _ in range(3)]
    genesis = 1_700_000_000 + int(rng.integers(0, 10_000))
    out = {"sid": sid}

    def build(S, new_keypair_, new_group_, DistPublic_, PriPoly_, Beacon_,
              Info_, D_):
        pairs = [new_keypair_(f"10.0.0.{i}:44{i}", S, seed=seeds[i])
                 for i in range(4)]
        g = new_group_([p.public for p in pairs], threshold=3,
                       genesis=genesis, period=3, catchup_period=1,
                       scheme=S)
        poly = PriPoly_(coeffs)
        g.public_key = DistPublic_(
            [S.key_group.to_bytes(c)
             for c in poly.commit(S.key_group).commits])
        raw = np.random.default_rng(7)
        beacons = [Beacon_(round=r, signature=raw.bytes(sig_len),
                           previous_sig=raw.bytes(sig_len)
                           if S.chained else None) for r in (1, 2, 999)]
        info = Info_(public_key=g.public_key.key(), period=3,
                     genesis_time=genesis, genesis_seed=raw.bytes(32),
                     scheme=S.id)
        commits = [raw.bytes(key_len) for _ in range(3)]
        bundles = [
            D_.DealBundle(dealer_index=2, commits=commits,
                          deals=[D_.Deal(share_index=i,
                                         encrypted=raw.bytes(80))
                                 for i in range(4)],
                          session_id=raw.bytes(32), signature=raw.bytes(64)),
            D_.ResponseBundle(
                share_index=1,
                responses=[D_.Response(dealer_index=i,
                                       status=D_.STATUS_SUCCESS if i % 2
                                       else D_.STATUS_COMPLAINT)
                           for i in range(4)],
                session_id=raw.bytes(32), signature=raw.bytes(64)),
            D_.JustificationBundle(
                dealer_index=0,
                justifications=[D_.Justification(
                    share_index=3,
                    share=int.from_bytes(raw.bytes(31), "big"))],
                session_id=raw.bytes(32), signature=raw.bytes(64))]
        return g, beacons, info, bundles

    out["port"] = build(ps, new_keypair, new_group, DistPublic, PriPoly,
                        Beacon, Info, D)
    out["ref"] = build(rs, ref_new_keypair, ref_new_group, RefDistPublic,
                       RefPriPoly, RefBeacon, RefInfo, RefD)
    return out


def test_convert_beacons_same_bytes(material):
    (_, pbs, _, _), (_, rbs, _, _) = material["port"], material["ref"]
    for b, rb in zip(pbs, rbs):
        assert _wire(convert.beacon_to_proto(b, "c")) == \
            _wire(ref_convert.beacon_to_proto(rb, "c"))
        assert _wire(convert.beacon_to_rand(b, "c")) == \
            _wire(ref_convert.beacon_to_rand(rb, "c"))
        assert convert.proto_to_beacon(ref_convert.beacon_to_proto(rb)) == b


def test_convert_group_and_info_same_bytes(material):
    (g, _, info, _), (rg, _, rinfo, _) = material["port"], material["ref"]
    wire = _wire(convert.group_to_proto(g, "c"))
    assert wire == _wire(ref_convert.group_to_proto(rg, "c"))
    assert g.hash() == rg.hash()
    assert convert.proto_to_group(pb.GroupPacket.FromString(wire)).hash() \
        == ref_convert.proto_to_group(ref_pb.GroupPacket.FromString(wire)
                                      ).hash()
    assert _wire(convert.info_to_proto(info)) == \
        _wire(ref_convert.info_to_proto(rinfo))
    assert convert.proto_to_info(ref_convert.info_to_proto(rinfo)).hash() \
        == rinfo.hash()
    for node, rnode in zip(g.nodes, rg.nodes):
        assert _wire(convert.identity_to_proto(node.identity)) == \
            _wire(ref_convert.identity_to_proto(rnode.identity))


def test_convert_dkg_bundles_same_bytes(material):
    (_, _, _, bundles), (_, _, _, rbundles) = material["port"], \
        material["ref"]
    for b, rb in zip(bundles, rbundles):
        wire = _wire(convert.dkg_bundle_to_proto(b, "c"))
        assert wire == _wire(ref_convert.dkg_bundle_to_proto(rb, "c"))
        assert convert.proto_to_dkg_bundle(pb.DKGBundle.FromString(wire)) \
            == b
