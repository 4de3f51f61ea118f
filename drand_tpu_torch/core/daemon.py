"""DrandDaemon: the multi-beacon host process (core/drand_daemon.go:20-333).

One process serves many independent chains: every RPC carries a beaconID
(or chain hash) in its metadata and is routed to the matching BeaconProcess
(drand_daemon_helper.go:77).  The daemon owns the private gRPC gateway, the
localhost control listener, the optional public REST edge and metrics
server, and the on-disk multibeacon layout.

The port's copy of drand_tpu/core/daemon.py, unchanged but for its imports.
"""

import json
import os
import tempfile
import threading
from typing import Dict, Optional

import grpc

from ..chain.errors import ErrNoBeaconSaved, ErrNoBeaconStored
from ..common import DEFAULT_BEACON_ID, MULTI_BEACON_FOLDER, make_lock
from ..crypto.schemes import (get_scheme_by_id_with_default, list_schemes)
from ..key.group import Group
from ..key.keys import new_keypair
from ..key.store import FileStore, list_beacon_ids
from ..log import Logger
from ..metrics import MetricsServer, drand_node_db
from ..net import ControlListener, Peer, PrivateGateway
from ..net import convert
from ..protos import drand_pb2 as pb
from .beacon_process import BeaconProcess
from .config import Config


class DrandDaemon:
    def __init__(self, cfg: Config, log: Optional[Logger] = None):
        self.cfg = cfg
        self.log = (log or Logger()).named("daemon")
        self.processes: Dict[str, BeaconProcess] = {}
        self.chain_hashes: Dict[str, str] = {}      # hex hash -> beacon_id
        self._lock = make_lock()
        self._exit = threading.Event()
        # graceful-shutdown flag (SIGTERM drain): /health flips ready to
        # false the moment the drain starts, so fleet supervisors and
        # orchestrators stop routing to a terminating node
        self.draining = False

        self.resilience = cfg.make_resilience(scope="node")
        # multi-tenant registry (core/tenancy.py): who owns each chain,
        # with what weight/quotas/placement — loaded from the multibeacon
        # layout, edited over the Control plane below
        self.tenancy = cfg.tenancy()
        # one serving-plane admission controller for every inbound
        # surface: the private gRPC gateway below, the REST edge (cli
        # wiring passes daemon.admission into RestServer), and the
        # SyncChain stream pacing — partials stay critical-class while
        # public reads shed first (overload protection); the
        # controller reads the tenant registry for per-tenant sub-budgets
        self.admission = cfg.admission()
        # tenant token authority (core/authz.py): minted/revoked over the
        # Control plane below, consulted by admission + the REST edge
        self.authority = cfg.authority()
        # identity plane (net/identity.py): when a cert dir is configured
        # the private AND control planes require mutual TLS, peers are
        # authenticated by cert SAN, and certs hot-reload on this clock
        self.identity = cfg.identity()
        self.gateway = PrivateGateway(
            cfg.private_listen,
            protocol_impl=ProtocolService(self),
            public_impl=PublicService(self),
            tls_cert=None if cfg.insecure else cfg.tls_cert,
            tls_key=None if cfg.insecure else cfg.tls_key,
            resilience=self.resilience,
            admission=self.admission,
            identity=self.identity)
        self.control = ControlListener(ControlService(self),
                                       port=cfg.control_port,
                                       identity=self.identity)
        self.metrics: Optional[MetricsServer] = None
        if cfg.metrics_port is not None:
            self.metrics = MetricsServer(cfg.metrics_port,
                                         peer_metrics=self._peer_metrics)
        self.http_server = None          # attached by the REST edge (L8)
        drand_node_db.labels(cfg.db_engine).set(1)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._note_start()
        self.gateway.start_all()
        self.control.start()
        if self.metrics is not None:
            self.metrics.start()
        self.log.info("daemon started",
                      private=self.gateway.listen_addr,
                      control=self.control.port)

    def _note_start(self) -> None:
        """Restart observability (fleet harness): bump the persisted
        start counter in <folder>/restarts.json and export it — plus
        this process's start stamp — through /metrics, so a supervisor
        asserts restart counts from a scrape instead of log archaeology.
        The counter survives the process because it lives in the beacon
        folder; the write is atomic (tmp + rename) so a crash mid-write
        never leaves a torn file."""
        from ..metrics import daemon_restarts_total, daemon_start_time_seconds
        daemon_start_time_seconds.set(self.cfg.clock.now())
        os.makedirs(self.cfg.folder, exist_ok=True)
        path = os.path.join(self.cfg.folder, "restarts.json")
        starts = 0
        try:
            with open(path) as f:
                starts = int(json.load(f).get("starts", 0))
        except (OSError, ValueError):
            pass
        starts += 1
        fd, tmp = tempfile.mkstemp(dir=self.cfg.folder,
                                   prefix=".restarts-")
        with os.fdopen(fd, "w") as f:
            json.dump({"starts": starts}, f)
        os.replace(tmp, path)
        if starts > 1:
            daemon_restarts_total.inc(starts - 1)

    def stop(self) -> None:
        for bp in list(self.processes.values()):
            bp.stop()
        self.gateway.stop_all()
        self.control.stop()
        if self.metrics is not None:
            self.metrics.stop()
        if self.http_server is not None:
            self.http_server.stop()
        # the daemon owns the resident verify service (cfg.verify_service
        # is shared by every BeaconProcess, so individual bp.stop()s must
        # not tear it down — the daemon's exit does)
        self.cfg.stop_verify_service()
        self._exit.set()

    def graceful_stop(self, grace: float = 10.0) -> bool:
        """SIGTERM drain path (cli.cmd_start): stop admitting sheddable
        and normal work (critical partials in flight finish), flush the
        verify service's BACKGROUND lane, then run the hard stop().
        Bounded: each drain gets half of `grace` REAL seconds and the
        hard stop runs either way.  Returns True when both drains
        completed in time — the caller maps this to the exit code."""
        self.draining = True
        self.log.info("graceful stop: draining", grace=grace)
        ok = True
        try:
            self.admission.begin_drain()
            ok = self.admission.drained(grace / 2)
            vs = self.cfg._verify_service
            if vs is not None:
                ok = vs.flush_background(grace / 2) and ok
        finally:
            self.stop()
        return ok

    def wait_exit(self, timeout: Optional[float] = None) -> bool:
        return self._exit.wait(timeout)

    # -- beacon process management (drand_daemon.go:161-298) -----------------

    def instantiate_beacon_process(self, beacon_id: str) -> BeaconProcess:
        beacon_id = beacon_id or DEFAULT_BEACON_ID
        fs = FileStore(self.cfg.folder, beacon_id)
        try:
            pair = fs.load_keypair()
        except FileNotFoundError:
            pair = new_keypair(self.gateway.listen_addr,
                               get_scheme_by_id_with_default(""),
                               tls=not self.cfg.insecure)
            fs.save_keypair(pair)
        if not pair.public.valid_signature():
            raise ValueError(
                "keypair possession signature invalid "
                "(run `drand util self-sign`)")
        bp = BeaconProcess(self.cfg, fs, beacon_id, pair,
                           self.gateway.client, self.log)
        with self._lock:
            self.processes[beacon_id] = bp
        return bp

    def load_beacons_from_disk(self) -> None:
        """Resume every beacon found under <folder>/multibeacon
        (drand_daemon.go:254-298)."""
        for beacon_id in list_beacon_ids(self.cfg.folder):
            bp = self.instantiate_beacon_process(beacon_id)
            if bp.load():
                # register BEFORE start_beacon: the verify handles built
                # there resolve their tenant via the registry's pk index
                # (register_chain also notifies, so late creation is
                # re-labelled — this order just avoids the churn)
                self._register_chain_hash(bp)
                bp.start_beacon(catchup=True)
                self.log.info("beacon loaded from disk", beacon_id=beacon_id)
            elif bp.journal.load_pending() is not None:
                # newcomer restart with a staged reshare still pending:
                # load() armed the transition waiter — the beacon starts
                # itself (with catchup + ledger commit) at the handover
                self._register_chain_hash(bp)
                self.log.info("beacon pending reshare transition; will "
                              "start at handover", beacon_id=beacon_id)
            else:
                self.log.info("beacon has no share yet; waiting for DKG",
                              beacon_id=beacon_id)

    def _register_chain_hash(self, bp: BeaconProcess) -> None:
        info = bp.chain_info()
        if info is not None:
            with self._lock:
                self.chain_hashes[info.hash_string()] = bp.beacon_id
            # index the chain for tenant resolution: hash (REST path /
            # gRPC metadata) and public key (the verify service's
            # pk-keyed handles) both map back to the beacon id
            self.tenancy.register_chain(bp.beacon_id,
                                        pk=info.public_key,
                                        chain_hash=info.hash_string())

    # -- routing (drand_daemon_helper.go:77) ---------------------------------

    def bp_for(self, metadata) -> BeaconProcess:
        bid = metadata.beaconID if metadata is not None else ""
        if not bid and metadata is not None and metadata.chain_hash:
            bid = self.chain_hashes.get(metadata.chain_hash.hex(), "")
        bid = bid or DEFAULT_BEACON_ID
        with self._lock:
            bp = self.processes.get(bid)
        if bp is None:
            raise KeyError(f"no beacon process for id {bid!r}")
        return bp

    def _peer_metrics(self, addr: str) -> bytes:
        """Federation: fetch a group member's metrics over the gRPC plane
        (metrics.go:408-492 lazyPeerHandler).  Like the reference, only
        known group members can be scraped — the address must appear in a
        loaded group (metrics.go:447-459); unknown addresses 404."""
        with self._lock:
            procs = list(self.processes.values())
        for bp in procs:
            group = bp.group
            if group is None:
                continue
            for node in group.nodes:
                if node.identity.addr == addr:
                    return self.gateway.client.metrics(
                        Peer(node.identity.addr, node.identity.tls),
                        bp.beacon_id)
        raise KeyError(f"{addr} is not a member of any loaded group")


def _route(daemon: DrandDaemon, context, metadata):
    if not convert.version_compatible(metadata):
        context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                      "incompatible node protocol version")
    try:
        return daemon.bp_for(metadata)
    except KeyError as e:
        context.abort(grpc.StatusCode.NOT_FOUND, str(e))


class ProtocolService:
    """drand.Protocol impl (core/drand_beacon_public.go + daemon routing)."""

    def __init__(self, daemon: DrandDaemon):
        self.daemon = daemon

    def get_identity(self, req, context):
        bp = _route(self.daemon, context, req.metadata)
        ident = bp.pair.public
        return pb.IdentityResponse(
            address=ident.addr, key=ident.key, tls=ident.tls,
            signature=ident.signature or b"",
            metadata=convert.metadata(bp.beacon_id),
            schemeName=ident.scheme.id)

    def signal_dkg_participant(self, req, context):
        bp = _route(self.daemon, context, req.metadata)
        try:
            bp.signal_dkg_participant(req)
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return pb.Empty()

    def push_dkg_info(self, req, context):
        bp = _route(self.daemon, context, req.metadata)
        try:
            bp.push_dkg_info(req)
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return pb.Empty()

    def broadcast_dkg(self, req, context):
        bp = _route(self.daemon, context, req.metadata)
        try:
            bp.broadcast_dkg(req)
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return pb.Empty()

    def partial_beacon(self, req, context):
        bp = _route(self.daemon, context, req.metadata)
        try:
            bp.process_partial(req)
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return pb.Empty()

    def handel_aggregate(self, req, context):
        bp = _route(self.daemon, context, req.metadata)
        from ..net.identity import peer_identity
        try:
            # the transport-level peer authenticates the claimed
            # sender_index (beacon/handel.py sender-binding check);
            # under mTLS the cert's SAN set is the stronger binding —
            # DNS-named rosters get enforcement the IP heuristic
            # could not give them
            bp.process_handel(req, peer=context.peer(),
                              auth=peer_identity(context))
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return pb.Empty()

    def sync_chain(self, req, context):
        bp = _route(self.daemon, context, req.metadata)
        stop = threading.Event()
        context.add_callback(stop.set)
        for beacon in bp.serve_sync(context.peer(), req.from_round,
                                    stop=stop):
            yield convert.beacon_to_proto(beacon, bp.beacon_id)

    def status(self, req, context):
        bp = _route(self.daemon, context, req.metadata)
        return _status_response(self.daemon, bp, req)

    def metrics(self, req, context):
        """Serve the local GroupMetrics snapshot to a federating peer
        (the reference side of net/listener.go:88).  The leading comment
        line identifies the serving node so federated scrapes are
        attributable."""
        from ..metrics import scrape
        banner = (f"# federated metrics served by "
                  f"{self.daemon.gateway.listen_addr}\n").encode()
        return pb.MetricsResponse(
            metrics=banner + scrape("group"),
            metadata=convert.metadata())


class PublicService:
    """drand.Public impl (core/drand_beacon_public.go:67-235)."""

    def __init__(self, daemon: DrandDaemon):
        self.daemon = daemon

    def public_rand(self, req, context):
        bp = _route(self.daemon, context, req.metadata)
        try:
            beacon = bp.get_beacon(req.round)
        except (ErrNoBeaconStored, ErrNoBeaconSaved) as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        return convert.beacon_to_rand(beacon, bp.beacon_id)

    def public_rand_stream(self, req, context):
        """Streams every new beacon from req.round (0 = next) on
        (drand_beacon_public.go:122-150, via the sync stream)."""
        bp = _route(self.daemon, context, req.metadata)
        stop = threading.Event()
        context.add_callback(stop.set)
        from_round = req.round
        if from_round == 0:
            try:
                from_round = bp.get_beacon(0).round + 1
            except (ErrNoBeaconStored, ErrNoBeaconSaved):
                from_round = 1
        for beacon in bp.serve_sync(context.peer(), from_round, stop=stop):
            yield convert.beacon_to_rand(beacon, bp.beacon_id)

    def chain_info(self, req, context):
        bp = _route(self.daemon, context, req.metadata)
        info = bp.chain_info()
        if info is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "no group/DKG yet")
        return convert.info_to_proto(info)

    def home(self, req, context):
        return pb.HomeResponse(
            status="drand up and running",
            metadata=convert.metadata())


def _status_response(daemon: DrandDaemon, bp: BeaconProcess,
                     req) -> pb.StatusResponse:
    """Status incl. optional connectivity probes
    (drand_beacon_control.go:819-921)."""
    resp = pb.StatusResponse(
        dkg=pb.DkgStatusPart(status=bp.dkg_status),
        reshare=pb.DkgStatusPart(status=bp.reshare_status))
    running = bp.handler is not None and bp.handler.running
    resp.beacon.CopyFrom(pb.BeaconStatusPart(
        status=0 if running else 1, is_running=running,
        is_stopped=not running, is_started=running, is_serving=running))
    empty, last_round, length = True, 0, 0
    if bp.handler is not None:
        try:
            last = bp.handler.chain.last()
            empty, last_round = False, last.round
            length = len(bp.handler.chain.store)
        except ErrNoBeaconStored:
            pass
    resp.chain_store.CopyFrom(pb.ChainStoreStatusPart(
        is_empty=empty, last_round=last_round, length=length))
    for a in req.check_conn:
        try:
            daemon.gateway.client.home(Peer(a.address, a.tls))
            resp.connections[a.address] = True
        except Exception:
            resp.connections[a.address] = False
    return resp


class ControlService:
    """drand.Control impl: the localhost CLI plane
    (core/drand_beacon_control.go)."""

    def __init__(self, daemon: DrandDaemon):
        self.daemon = daemon

    def _bp(self, context, metadata, create: bool = False) -> BeaconProcess:
        try:
            return self.daemon.bp_for(metadata)
        except KeyError:
            if create:
                bid = (metadata.beaconID or DEFAULT_BEACON_ID
                       if metadata is not None else DEFAULT_BEACON_ID)
                return self.daemon.instantiate_beacon_process(bid)
            context.abort(grpc.StatusCode.NOT_FOUND, "unknown beacon id")

    def ping_pong(self, req, context):
        return pb.Pong(metadata=convert.metadata())

    def status(self, req, context):
        bp = self._bp(context, req.metadata)
        return _status_response(self.daemon, bp, req)

    def list_schemes(self, req, context):
        return pb.ListSchemesResponse(ids=list_schemes(),
                                      metadata=convert.metadata())

    def list_beacon_ids(self, req, context):
        with self.daemon._lock:
            ids = sorted(self.daemon.processes)
        return pb.ListBeaconIDsResponse(ids=ids, metadata=convert.metadata())

    def init_dkg(self, req, context):
        """Leader or follower DKG kickoff (drand_beacon_control.go:41-117).
        Runs the whole session synchronously; the CLI blocks until the
        group is final (matching `drand share` semantics)."""
        bp = self._bp(context, req.metadata, create=True)
        info = req.info
        scheme = get_scheme_by_id_with_default(req.schemeID)
        try:
            if info.leader:
                group = bp.init_dkg_leader(
                    n_nodes=info.nodes, threshold=info.threshold,
                    period=req.beacon_period_seconds or 60,
                    catchup_period=req.catchup_period_seconds,
                    secret=info.secret,
                    setup_timeout=info.timeout_seconds or 60,
                    scheme=scheme)
            else:
                group = bp.join_dkg(
                    leader=Peer(info.leader_address), secret=info.secret,
                    setup_timeout=info.timeout_seconds or 60)
        except Exception as e:
            context.abort(grpc.StatusCode.ABORTED, f"dkg failed: {e}")
        self.daemon._register_chain_hash(bp)
        bp.start_beacon(catchup=False)
        return convert.group_to_proto(group, bp.beacon_id)

    def init_reshare(self, req, context):
        bp = self._bp(context, req.metadata, create=True)
        info = req.info
        old_group = bp.group
        if req.old_group_path:
            with open(req.old_group_path) as f:
                old_group = Group.from_toml(f.read())
        if old_group is None:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "no previous group for resharing")
        try:
            if info.leader:
                group = bp.init_reshare_leader(
                    old_group, n_nodes=info.nodes,
                    threshold=info.threshold, secret=info.secret,
                    setup_timeout=info.timeout_seconds or 60)
            else:
                group = bp.join_reshare(
                    leader=Peer(info.leader_address), old_group=old_group,
                    secret=info.secret,
                    setup_timeout=info.timeout_seconds or 60)
        except Exception as e:
            context.abort(grpc.StatusCode.ABORTED, f"reshare failed: {e}")
        self.daemon._register_chain_hash(bp)
        return convert.group_to_proto(group, bp.beacon_id)

    def public_key(self, req, context):
        bp = self._bp(context, req.metadata)
        return pb.PublicKeyResponse(pub_key=bp.pair.public.key,
                                    metadata=convert.metadata(bp.beacon_id))

    def private_key(self, req, context):
        bp = self._bp(context, req.metadata)
        return pb.PrivateKeyResponse(
            pri_key=bp.pair.key.to_bytes(32, "big"),
            metadata=convert.metadata(bp.beacon_id))

    def chain_info(self, req, context):
        bp = self._bp(context, req.metadata)
        info = bp.chain_info()
        if info is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "no chain info yet")
        return convert.info_to_proto(info)

    def group_file(self, req, context):
        bp = self._bp(context, req.metadata)
        if bp.group is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "no group yet")
        return convert.group_to_proto(bp.group, bp.beacon_id)

    def shutdown(self, req, context):
        # intentional fire-and-forget: the RPC must return before the
        # daemon tears down the gRPC server it arrived on; daemon.stop()
        # joins every owned thread
        # tpu-vet: disable=threadlife
        threading.Thread(target=self.daemon.stop, daemon=True,
                         name="stop-async-daemon").start()
        return pb.ShutdownResponse(metadata=convert.metadata())

    def load_beacon(self, req, context):
        bp = self._bp(context, req.metadata, create=True)
        if not bp.load():
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "beacon has no stored state")
        self.daemon._register_chain_hash(bp)
        bp.start_beacon(catchup=True)
        return pb.LoadBeaconResponse(metadata=convert.metadata())

    def start_follow_chain(self, req, context):
        """Observer sync into this daemon's store with progress stream
        (drand_beacon_control.go:1097-1227)."""
        bp = self._bp(context, req.metadata, create=True)
        from .follow import follow_chain
        stop = threading.Event()
        context.add_callback(stop.set)
        try:
            for current, target in follow_chain(
                    self.daemon, bp, list(req.nodes), req.is_tls,
                    req.up_to, req.chain_hash, stop):
                yield pb.SyncProgress(current=current, target=target,
                                      metadata=convert.metadata(bp.beacon_id))
        except Exception as e:
            context.abort(grpc.StatusCode.ABORTED, f"follow failed: {e}")

    def start_check_chain(self, req, context):
        """Validate (and optionally repair) the local chain with LIVE
        progress streaming (drand_beacon_control.go:1230-1320)."""
        import queue as _q
        bp = self._bp(context, req.metadata)
        if bp.syncm is None:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "beacon not running")
        upto = req.up_to or (bp.get_beacon(0).round)
        events: "_q.Queue" = _q.Queue()
        result = {}

        def run():
            # integrity_scan returns the full ScanReport that `heal`
            # consumes (check_past_beacons is itself a scanner facade now,
            # but only surfaces the faulty-round list); the scanner
            # carries the linkage anchor itself, so the daemon's raw
            # trimmed store (require_previous=False) validates correctly.
            try:
                result["report"] = bp.handler.chain.integrity_scan(
                    verifier=bp.syncm.verifier, mode="full", upto=upto,
                    beacon_id=bp.beacon_id, trigger="manual",
                    progress=lambda c, t: events.put((c, t)))
            except Exception as e:
                result["error"] = e
            finally:
                events.put(None)

        t = threading.Thread(target=run, daemon=True, name="check-chain")
        t.start()
        while True:
            ev = events.get()
            if ev is None:
                break
            yield pb.SyncProgress(current=ev[0], target=ev[1])
        # the None sentinel comes from the worker's finally: it is already
        # unwinding, so this join is a bounded courtesy, not a wait
        t.join(timeout=2)
        if "error" in result:
            context.abort(grpc.StatusCode.ABORTED,
                          f"check failed: {result['error']}")
        report = result["report"]
        remaining = report.faulty_rounds
        if req.nodes and remaining:
            peers = [Peer(n, req.is_tls) for n in req.nodes]
            # heal = quarantine the bad rows + re-fetch from breaker-ranked
            # peers + integrity metrics (chain/integrity.py wiring)
            remaining = bp.syncm.heal(bp.store, report, peers,
                                      beacon_id=bp.beacon_id)
        # the final frame reports the POST-repair state: a full repair
        # shows current == target, an un-repaired (or repair-less) check
        # shows the shortfall
        yield pb.SyncProgress(current=upto - len(remaining), target=upto)

    def backup_database(self, req, context):
        bp = self._bp(context, req.metadata)
        if bp.store is None:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "beacon not running")
        # atomic snapshot: stream into a sibling temp file, fsync, rename —
        # a crash mid-backup must never leave a torn file where an operator
        # expects a restorable image.  mkstemp (not a fixed name) so two
        # concurrent backup RPCs to the same target can't write over each
        # other's temp file; last rename wins with both images intact.
        out = os.path.abspath(req.output_file)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(out),
                                   prefix=os.path.basename(out) + ".tmp.")
        try:
            with os.fdopen(fd, "wb") as f:
                bp.store.save_to(f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, out)
        finally:
            try:
                os.unlink(tmp)
            except FileNotFoundError:
                pass
        return pb.BackupDBResponse(metadata=convert.metadata(bp.beacon_id))

    # -- multi-tenant registry (core/tenancy.py) -----------------------------

    def _tenant_list_response(self) -> pb.TenantListResponse:
        out = pb.TenantListResponse(metadata=convert.metadata())
        reg = self.daemon.tenancy
        for name in reg.names():
            cfg = reg.get(name)
            if cfg is None:
                continue
            out.tenants.append(pb.TenantConfigPacket(
                name=cfg.name, weight=cfg.weight, rate=cfg.rate,
                burst=cfg.burst, device_budget=cfg.device_budget,
                chains=list(cfg.chains),
                pin_group=-1 if cfg.pin_group is None else cfg.pin_group,
                anti_affinity=cfg.anti_affinity, paused=cfg.paused))
        return out

    def tenant_set(self, req, context):
        """Add or update one tenant (upsert); the registry persists
        atomically and both enforcement planes see the change without a
        restart."""
        from .tenancy import TenantConfig
        try:
            self.daemon.tenancy.set_tenant(TenantConfig(
                name=req.name, weight=req.weight, rate=req.rate,
                burst=req.burst, device_budget=req.device_budget,
                chains=tuple(req.chains),
                pin_group=None if req.pin_group < 0 else req.pin_group,
                anti_affinity=req.anti_affinity, paused=req.paused))
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return self._tenant_list_response()

    def tenant_remove(self, req, context):
        if not self.daemon.tenancy.remove_tenant(req.name):
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"unknown tenant {req.name!r}")
        return self._tenant_list_response()

    def tenant_list(self, req, context):
        return self._tenant_list_response()

    # -- tenant tokens (core/authz.py) ---------------------------------------

    def _token_list_response(self) -> pb.TokenListResponse:
        out = pb.TokenListResponse(metadata=convert.metadata())
        for rec in self.daemon.authority.tokens():
            out.tokens.append(pb.TokenInfo(
                token_id=rec.token_id, tenant=rec.tenant,
                expires=rec.expires, read_only=rec.read_only,
                revoked=rec.revoked, chains=list(rec.chains)))
        return out

    def token_mint(self, req, context):
        """Mint a bearer token; the token string appears in this response
        and nowhere else (the ledger keeps only its metadata)."""
        from ..metrics import authz_tokens
        try:
            token, rec = self.daemon.authority.mint(
                req.tenant, chains=tuple(req.chains),
                ttl=req.ttl_seconds, read_only=req.read_only)
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        authz_tokens.labels("minted").inc()
        return pb.TokenMintResponse(token=token, token_id=rec.token_id,
                                    expires=rec.expires,
                                    metadata=convert.metadata())

    def token_revoke(self, req, context):
        from ..metrics import authz_tokens
        if not self.daemon.authority.revoke(req.token_id):
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"unknown token {req.token_id!r}")
        authz_tokens.labels("revoked").inc()
        return self._token_list_response()

    def token_list(self, req, context):
        return self._token_list_response()

    def remote_status(self, req, context):
        bp = self._bp(context, req.metadata)
        out = pb.RemoteStatusResponse(metadata=convert.metadata())
        for a in req.addresses:
            node = pb.RemoteStatusNode(address=a.address)
            try:
                st = self.daemon.gateway.client.status(
                    Peer(a.address, a.tls), bp.beacon_id)
                node.status.CopyFrom(st)
            except Exception:
                pass
            out.statuses.append(node)
        return out
