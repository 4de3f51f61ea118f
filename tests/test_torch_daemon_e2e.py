"""The port's gRPC daemon end to end over real gRPC on localhost
(drand_tpu_torch/core/daemon.py, beacon_process.py, net/, cli.py).

The cases of tests/test_daemon_e2e.py on port daemons: a 3-node networked
DKG, identical chains, the status / chain-info / federation RPCs and the
scheduled integrity scans; the version-skew gate; the SyncChain stream;
and, marked `slow` as in the reference, the CLI in two real processes, a
reshare that adds a node, an observer following the chain and two chains
on one trio.  The daemons check partials on the host
(`use_device_verifier=False`), as the reference's e2e tests do: the port's
pure-Python pairing takes some 0.2-0.3 s, which the 4 s period absorbs.

Then the port's own start-time seams, on a BeaconProcess built from a
local group: a device chain without a card raises before anything is
built, a group at Handel size raises an error naming the missing overlay,
and the partials factory gets no host fallback.
"""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from drand_tpu_torch.core.config import Config
from drand_tpu_torch.core.daemon import DrandDaemon
from drand_tpu_torch.net import ControlClient, Peer, ProtocolClient
from drand_tpu_torch.net import convert
from drand_tpu_torch.protos import drand_pb2 as pb

from harness import assert_no_leaked_service_threads, service_threads

REPO = Path(__file__).resolve().parents[1]
SECRET = b"e2e-secret"


def _mk_daemon(tmp_path, i, **kw):
    cfg = Config(folder=str(tmp_path / f"n{i}"), control_port=0,
                 private_listen="127.0.0.1:0", dkg_timeout=2,
                 dkg_kickoff_grace=0.8, use_device_verifier=False,
                 db_engine="memdb", reshare_offset=10, **kw)
    d = DrandDaemon(cfg)
    d.start()
    return d


def _run_dkg(daemons, n, thr, period=4, beacon_id="default"):
    leader_addr = daemons[0].gateway.listen_addr
    results = [None] * len(daemons)
    errors = []

    def leader():
        cc = ControlClient(daemons[0].control.port)
        req = pb.InitDKGPacket(
            info=pb.SetupInfo(leader=True, nodes=n, threshold=thr,
                              timeout_seconds=30, secret=SECRET),
            beacon_period_seconds=period,
            metadata=convert.metadata(beacon_id))
        try:
            results[0] = cc.stub.init_dkg(req, timeout=120)
        except Exception as e:
            errors.append(e)

    def follower(i):
        # retry until the leader's setup phase is accepting
        cc = ControlClient(daemons[i].control.port)
        req = pb.InitDKGPacket(
            info=pb.SetupInfo(leader=False, leader_address=leader_addr,
                              timeout_seconds=30, secret=SECRET),
            metadata=convert.metadata(beacon_id))
        join_deadline = time.time() + 30
        while True:
            try:
                results[i] = cc.stub.init_dkg(req, timeout=120)
                return
            except Exception as e:
                if time.time() >= join_deadline:
                    errors.append(e)
                    return
                time.sleep(0.2)

    threads = [threading.Thread(target=leader)] + [
        threading.Thread(target=follower, args=(i,))
        for i in range(1, len(daemons))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=150)
    assert not errors, errors
    assert all(r is not None for r in results)
    groups = [convert.proto_to_group(r) for r in results]
    assert len({g.hash() for g in groups}) == 1, "group divergence"
    # the group hash does not cover the post-DKG commits: compare the
    # collective keys explicitly
    keys = {g.public_key.key() for g in groups}
    assert len(keys) == 1, "collective key fork (QUAL divergence)"
    return groups[0]


def _wait_round(client, addr, round_, timeout=90, beacon_id="default"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            r = client.public_rand(Peer(addr), 0, beacon_id)
            if r.round >= round_:
                return r
        except Exception:
            pass
        time.sleep(0.5)
    raise AssertionError(f"round {round_} not reached on {addr}")


@pytest.fixture()
def trio(tmp_path):
    before = service_threads()
    daemons = [_mk_daemon(tmp_path, i, metrics_port=0,
                          startup_integrity="linkage",
                          integrity_scan_interval=1.0) for i in range(3)]
    yield daemons
    for d in daemons:
        d.stop()
    assert_no_leaked_service_threads(before=before)


def test_dkg_beacons_and_sync(trio):
    """3-node networked DKG -> identical chains -> status/chain-info RPCs,
    federated metrics, scheduled integrity scans."""
    group = _run_dkg(trio, n=3, thr=2)
    assert group.threshold == 2 and len(group) == 3
    assert group.public_key is not None

    pc = ProtocolClient()
    _wait_round(pc, trio[0].gateway.listen_addr, 2)

    sigs = set()
    for d in trio:
        _wait_round(pc, d.gateway.listen_addr, 2)
        got = pc.public_rand(Peer(d.gateway.listen_addr), 2)
        sigs.add(got.signature)
        assert got.randomness
    assert len(sigs) == 1

    infos = {pc.chain_info(Peer(d.gateway.listen_addr)).hash
             for d in trio}
    assert len(infos) == 1

    st = pc.status(Peer(trio[0].gateway.listen_addr))
    assert st.beacon.is_running and not st.chain_store.is_empty

    st = pc.status(Peer(trio[0].gateway.listen_addr),
                   check_conn=[Peer(trio[1].gateway.listen_addr),
                               Peer("127.0.0.1:1")])
    conns = dict(st.connections)
    assert conns[trio[1].gateway.listen_addr] is True
    assert conns["127.0.0.1:1"] is False

    # metrics federation through node 0's /peer/<addr>/metrics route
    import urllib.error
    import urllib.request
    addr1 = trio[1].gateway.listen_addr
    base = f"http://127.0.0.1:{trio[0].metrics.port}"
    body = urllib.request.urlopen(f"{base}/peer/{addr1}/metrics").read()
    assert f"served by {addr1}".encode() in body
    assert b"last_beacon_round" in body
    # the port's addition: the checks' backend, host here
    assert b'beacon_partial_checks_total{backend="host"' in body
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(f"{base}/peer/127.0.0.1:1/metrics")

    # scheduled background integrity scans (integrity_scan_interval=1.0)
    from drand_tpu_torch.metrics import integrity_beacons_scanned
    sched = integrity_beacons_scanned.labels("default", "none", "scheduled")
    deadline = time.time() + 30
    while time.time() < deadline and sched.value == 0:
        time.sleep(0.5)
    assert sched.value > 0, "no scheduled integrity scan ran"


def test_version_skew_gate(trio):
    """An incompatible-major peer is rejected on both the public and
    protocol planes; a compatible-minor mix keeps the network producing."""
    import grpc

    from drand_tpu_torch.net import services

    _run_dkg(trio, n=3, thr=2)
    pc = ProtocolClient()
    addr = trio[0].gateway.listen_addr
    _wait_round(pc, addr, 1)

    chan = grpc.insecure_channel(addr)
    pub = services.PUBLIC.stub(chan)
    proto = services.PROTOCOL.stub(chan)

    def md(maj, mino=0):
        return pb.Metadata(
            node_version=pb.NodeVersion(major=maj, minor=mino, patch=0),
            beaconID="default")

    with pytest.raises(grpc.RpcError) as ei:
        pub.public_rand(pb.PublicRandRequest(round=1, metadata=md(3)))
    assert ei.value.code() == grpc.StatusCode.FAILED_PRECONDITION
    assert "incompatible" in ei.value.details()

    with pytest.raises(grpc.RpcError) as ei:
        proto.partial_beacon(pb.PartialBeaconPacket(
            round=2, partial_sig=b"\x00\x01" + b"\x00" * 48,
            metadata=md(3)))
    assert ei.value.code() == grpc.StatusCode.FAILED_PRECONDITION

    got = pub.public_rand(pb.PublicRandRequest(round=1, metadata=md(2, 7)))
    assert got.round == 1
    nxt = _wait_round(pc, addr, 2)
    assert nxt.round >= 2
    chan.close()


def test_sync_chain_stream(trio):
    """SyncChain serves a verified replay stream (protocol plane)."""
    _run_dkg(trio, n=3, thr=2)
    pc = ProtocolClient()
    addr = trio[0].gateway.listen_addr
    _wait_round(pc, addr, 3)
    got = []
    for b in pc.sync_chain(Peer(addr), 1):
        got.append(b.round)
        if len(got) >= 3:
            break
    assert got == [1, 2, 3]


@pytest.mark.slow
def test_cli_two_real_processes(tmp_path):
    """A daemon started by the port's CLI, and CLI clients pinging,
    listing schemes and stopping it."""
    folder = tmp_path / "proc0"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "drand_tpu_torch.cli", "start",
         "--folder", str(folder), "--control", "0",
         "--private-listen", "127.0.0.1:0", "--db", "memdb", "--no-device"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(REPO), env=env)
    try:
        line = ""
        deadline = time.time() + 60
        while time.time() < deadline:
            line = proc.stdout.readline()
            if "control=" in line:
                break
        assert "control=" in line, f"daemon never came up: {line!r}"
        control_port = int(line.rsplit("control=", 1)[1].strip())

        def cli(*args):
            return subprocess.run(
                [sys.executable, "-m", "drand_tpu_torch.cli", *args,
                 "--control", str(control_port)],
                capture_output=True, text=True, cwd=str(REPO), env=env,
                timeout=60)

        out = cli("util", "ping")
        assert out.returncode == 0 and "pong" in out.stdout
        out = cli("util", "list-schemes")
        assert "pedersen-bls-chained" in out.stdout
        out = cli("stop")
        assert out.returncode == 0
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()


@pytest.mark.slow
def test_reshare_add_node(tmp_path):
    """A 3-node network reshares to 4 nodes (one newcomer); the chain keeps
    its genesis seed and public key and continues past the transition."""
    before = service_threads()
    daemons = [_mk_daemon(tmp_path, i) for i in range(4)]
    try:
        old_group = _run_dkg(daemons[:3], n=3, thr=2)
        pc = ProtocolClient()
        _wait_round(pc, daemons[0].gateway.listen_addr, 1)

        old_path = tmp_path / "old_group.toml"
        old_path.write_text(old_group.to_toml())

        leader_addr = daemons[0].gateway.listen_addr
        results = [None] * 4
        errors = []

        def reshare(i, leader):
            cc = ControlClient(daemons[i].control.port)
            info = pb.SetupInfo(
                leader=leader, leader_address="" if leader else leader_addr,
                nodes=4, threshold=3, timeout_seconds=40, secret=SECRET)
            req = pb.InitResharePacket(
                info=info,
                old_group_path=str(old_path) if i == 3 else "",
                metadata=convert.metadata("default"))
            join_deadline = time.time() + 30
            while True:
                try:
                    results[i] = cc.stub.init_reshare(req, timeout=150)
                    return
                except Exception as e:
                    if leader or time.time() >= join_deadline:
                        errors.append((i, e))
                        return
                    time.sleep(0.2)

        threads = [threading.Thread(target=reshare, args=(i, i == 0))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert not errors, errors
        new_groups = [convert.proto_to_group(r) for r in results]
        assert len({g.hash() for g in new_groups}) == 1
        new_group = new_groups[0]
        assert len(new_group) == 4 and new_group.threshold == 3
        assert new_group.get_genesis_seed() == old_group.get_genesis_seed()
        assert new_group.public_key.key() == old_group.public_key.key()

        transition_round = (new_group.transition_time
                            - new_group.genesis_time) // new_group.period + 1
        target = transition_round + 1
        r = _wait_round(pc, daemons[0].gateway.listen_addr, target,
                        timeout=150)
        assert r.round >= target
        _wait_round(pc, daemons[3].gateway.listen_addr, target, timeout=150)
    finally:
        for d in daemons:
            d.stop()
        assert_no_leaked_service_threads(before=before)


@pytest.mark.slow
def test_follow_chain_observer(tmp_path):
    """A non-member daemon follows the chain in observer mode via the
    control plane (StartFollowChain)."""
    before = service_threads()
    daemons = [_mk_daemon(tmp_path, i) for i in range(3)]
    observer = _mk_daemon(tmp_path, 9)
    try:
        _run_dkg(daemons, n=3, thr=2)
        pc = ProtocolClient()
        _wait_round(pc, daemons[0].gateway.listen_addr, 3)

        cc = ControlClient(observer.control.port)
        req = pb.StartSyncRequest(
            nodes=[d.gateway.listen_addr for d in daemons],
            up_to=3, beaconID="default",
            metadata=convert.metadata("default"))
        progress = [p for p in cc.stub.start_follow_chain(req)]
        assert progress, "no progress events"
        assert progress[-1].current >= 3
    finally:
        observer.stop()
        for d in daemons:
            d.stop()
        assert_no_leaked_service_threads(before=before)


@pytest.mark.slow
def test_multibeacon_routing(tmp_path):
    """One daemon trio hosts two independent chains; RPCs route by
    beaconID."""
    before = service_threads()
    daemons = [_mk_daemon(tmp_path, i) for i in range(3)]
    try:
        g1 = _run_dkg(daemons, n=3, thr=2, period=3, beacon_id="alpha")
        g2 = _run_dkg(daemons, n=3, thr=2, period=4, beacon_id="beta")
        assert g1.hash() != g2.hash()
        pc = ProtocolClient()
        addr = daemons[0].gateway.listen_addr
        _wait_round(pc, addr, 1, beacon_id="alpha")
        _wait_round(pc, addr, 1, beacon_id="beta")
        ia = pc.chain_info(Peer(addr), "alpha")
        ib = pc.chain_info(Peer(addr), "beta")
        assert ia.hash != ib.hash
        assert ia.period == 3 and ib.period == 4
        ra = pc.public_rand(Peer(addr), 1, "alpha")
        rb = pc.public_rand(Peer(addr), 1, "beta")
        assert ra.signature != rb.signature
    finally:
        for d in daemons:
            d.stop()
        assert_no_leaked_service_threads(before=before)


# -- the port's start-time seams ---------------------------------------------

def _local_process(tmp_path, n=3, thr=2, **kw):
    """A BeaconProcess holding node 1's share of a locally made group, as
    a finished DKG leaves it, and nothing started."""
    from drand_tpu_torch.core.beacon_process import BeaconProcess
    from drand_tpu_torch.crypto.host import tbls
    from drand_tpu_torch.crypto.schemes import scheme_from_name
    from drand_tpu_torch.key.group import new_group
    from drand_tpu_torch.key.keys import DistPublic, Share, new_keypair
    from drand_tpu_torch.key.store import FileStore
    from drand_tpu_torch.log import Logger

    scheme = scheme_from_name("bls-unchained-on-g1")
    pairs = [new_keypair(f"127.0.0.1:{9100 + i}", scheme,
                         seed=b"seam%d" % i) for i in range(n)]
    group = new_group([p.public for p in pairs], thr,
                      genesis=int(time.time()) + 3600, period=3,
                      catchup_period=1, scheme=scheme)
    poly = tbls.PriPoly.random(thr, secret=4242)
    commits = [scheme.key_group.to_bytes(c)
               for c in poly.commit(scheme.key_group).commits]
    group.public_key = DistPublic(commits)
    me = group.nodes[0]
    cfg = Config(folder=str(tmp_path / "seam"), control_port=0,
                 db_engine="memdb", **kw)
    bp = BeaconProcess(cfg, FileStore(cfg.folder, "default"), "default",
                       pairs[0], client=None, log=Logger())
    bp.group = group
    bp.share = Share(scheme=scheme, private=poly.eval(me.index),
                     commits=commits)
    return bp


def test_device_chain_without_a_card_raises(tmp_path, monkeypatch):
    """`use_device_verifier` keeps the reference's default (True); on a
    machine without a card starting the chain raises before the store,
    the handler or the service exist."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bp = _local_process(tmp_path)
    assert bp.cfg.use_device_verifier is True
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bp.start_beacon(catchup=False)
    assert bp.store is None and bp.handler is None
    assert bp.cfg._verify_service is None


def test_handel_size_group_raises_a_clear_error(tmp_path):
    """A group at Handel size names the overlay the port lacks instead of
    failing on an import deep in a thread."""
    bp = _local_process(tmp_path, handel_min_group=3,
                        use_device_verifier=False)
    with pytest.raises(NotImplementedError, match="beacon/handel.py"):
        bp.start_beacon(catchup=False)
    assert bp.store is None and bp.handler is None
    assert bp.cfg.handel_min_group_size() == 3
    assert Config().handel_min_group_size() == int(
        os.environ.get("DRAND_HANDEL_MIN_GROUP", "129"))


@pytest.mark.parametrize("device", [True, False], ids=["device", "host"])
def test_partials_factory_gets_no_host_fallback(tmp_path, monkeypatch,
                                                device):
    """`start_beacon` hands the service the device factory (or, with
    `use_device_verifier=False`, the host one) and never a fallback."""
    from drand_tpu_torch.beacon import node
    from drand_tpu_torch.crypto.verify_service import VerifyService

    seen = []

    class Stop(Exception):
        pass

    def spy(self, inner_factory, fallback_factory=None):
        seen.append((inner_factory, fallback_factory))
        raise Stop

    monkeypatch.setattr(VerifyService, "partials_factory", spy)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    bp = _local_process(tmp_path, use_device_verifier=device)
    try:
        with pytest.raises(Stop):
            bp.start_beacon(catchup=False)
    finally:
        bp.cfg.stop_verify_service()
        if bp.store is not None:
            bp.store.close()
    want = node.device_verifier_factory if device \
        else node._host_verifier_factory
    assert seen == [(want, None)]
