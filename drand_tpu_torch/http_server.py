"""REST edge: the public HTTP API (reference: http/server.go:44-605).

Routes (chi-router parity, server.go:87-98):
    /{chainHash}/public/{round}      /{chainHash}/public/latest
    /{chainHash}/info                /chains       /health
plus default-chain aliases without the hash prefix.

`/public/{round}` long-polls when the next round is requested: waiters are
parked and released the moment the beacon is stored (server.go:164-241,
getRand :279-343).  Responses carry `Expires` headers keyed to the round
schedule so CDNs cache correctly.

The port's copy of drand_tpu/http_server.py, its code unchanged: every
import is the port's own (chain/, beacon/clock.py, log.py, metrics.py,
net/admission.py, core/authz.py), and `/health` reads the port's verify
service through `current_service()`, which never creates one.
"""

import json
import queue
import threading

from .common import make_lock
import time
from email.utils import formatdate
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Dict, List, Optional, Tuple

from .beacon.clock import Clock, RealClock
from .chain.beacon import Beacon
from .chain.errors import ErrNoBeaconSaved, ErrNoBeaconStored
from .chain.timing import time_of_round
from .log import Logger
from .metrics import api_call_counter, http_latency, registered_label
from .net.admission import CLASS_SHEDDABLE, Shed

LONG_POLL_TIMEOUT = 60.0

DEFAULT_REST_WORKERS = 16
# accepted-but-not-yet-picked-up connections; beyond this the edge sheds
DEFAULT_REST_BACKLOG = 64


def _shed_bytes(retry_after: float) -> bytes:
    """A complete, well-formed 429 — written raw to the socket BEFORE the
    request line is parsed (shedding must stay cheaper than serving).
    RFC 9110 Retry-After is integer delay-seconds; a fractional value
    would be DISCARDED by conforming intermediaries, turning the header
    into an immediate-retry invitation — round up, floor 1."""
    import math
    body = b'{"error":"overloaded"}'
    return (b"HTTP/1.1 429 Too Many Requests\r\n"
            b"Retry-After: " + str(max(1, math.ceil(retry_after))).encode() +
            b"\r\nContent-Type: application/json\r\n"
            b"Content-Length: " + str(len(body)).encode() +
            b"\r\nConnection: close\r\n\r\n" + body)


class _RestWorkerPool:
    """Fixed pool of DAEMON worker threads over a BOUNDED queue: the
    thread-per-request ThreadingHTTPServer this replaces was itself a
    resource-exhaustion bug (unbounded non-daemon thread growth under a
    read flood, and a wedged handler blocked interpreter exit)."""

    _STOP = object()

    def __init__(self, workers: int, backlog: int):
        self.workers = max(1, workers)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, backlog))
        self._threads = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"rest-worker-{i}")
            for i in range(self.workers)]
        for t in self._threads:
            t.start()

    def submit(self, fn) -> bool:
        """False when the backlog is full — the caller sheds."""
        try:
            self._q.put_nowait(fn)
            return True
        except queue.Full:
            return False

    def _run(self) -> None:
        while True:
            fn = self._q.get()
            if fn is self._STOP:
                return
            try:
                fn()
            except Exception:
                pass        # per-request errors were already reported

    def stop(self, timeout: float = 2.0) -> None:
        for _ in self._threads:
            try:
                self._q.put(self._STOP, timeout=timeout)
            except queue.Full:
                break       # daemon threads; process exit reaps them
        for t in self._threads:
            t.join(timeout=timeout)


class BoundedHTTPServer(HTTPServer):
    """HTTPServer dispatching to a `_RestWorkerPool` with serving-plane
    admission (net/admission.py) checked BEFORE the request is parsed:
    a shed costs one pre-serialized 429 write and a close.  Used by the
    REST edge here and relay.HttpRelay; `admission=None` keeps the
    bounded pool without the shedding (standalone relays)."""

    allow_reuse_address = True

    def __init__(self, addr, handler_cls, workers: int = DEFAULT_REST_WORKERS,
                 backlog: int = DEFAULT_REST_BACKLOG, admission=None):
        super().__init__(addr, handler_cls)
        self.admission = admission
        self.pool = _RestWorkerPool(workers, backlog)
        # the pre-parse admission ticket of the request THIS worker
        # thread is serving: the tenant gate attributes it once the
        # route resolves the chain, so weighted fair queuing sees REST
        # holdings too (one request per worker at a time by design)
        self._serving = threading.local()

    def current_ticket(self):
        return getattr(self._serving, "ticket", None)

    def process_request(self, request, client_address):
        ticket = None
        if self.admission is not None:
            try:
                ticket = self.admission.admit(
                    CLASS_SHEDDABLE, peer=str(client_address[0]))
            except Shed as s:
                self._shed(request, s.retry_after)
                return
        if not self.pool.submit(
                lambda: self._work(request, client_address, ticket)):
            if ticket is not None:
                ticket.release()
            self._shed(request, 1.0)

    def _shed(self, request, retry_after: float) -> None:
        try:
            request.sendall(_shed_bytes(retry_after))
        except OSError:
            pass
        self.shutdown_request(request)

    def _work(self, request, client_address, ticket) -> None:
        self._serving.ticket = ticket
        try:
            self.finish_request(request, client_address)
        except Exception:
            self.handle_error(request, client_address)
        finally:
            self._serving.ticket = None
            self.shutdown_request(request)
            if ticket is not None:
                ticket.release()

    def server_close(self) -> None:
        super().server_close()
        self.pool.stop()


def _beacon_etag(b: Beacon) -> str:
    """Strong ETag for an immutable round: every node of a chain serves
    identical bytes for round N, so hashing (round, signature) gives a
    validator that is stable across the whole edge tier."""
    import hashlib
    h = hashlib.sha256(b.round.to_bytes(8, "big") + bytes(b.signature))
    return '"' + h.hexdigest()[:32] + '"'


def _etag_matches(if_none_match: str, etag: str) -> bool:
    """RFC 9110 If-None-Match: weak comparison (a CDN may weaken our
    strong tag, e.g. after content-coding — `W/"x"` matches `"x"`), and
    `*` matches any current representation."""
    if if_none_match.strip() == "*":
        return True
    for tok in if_none_match.split(","):
        tok = tok.strip()
        if tok.startswith("W/"):
            tok = tok[2:]
        if tok == etag:
            return True
    return False


def _beacon_json(b: Beacon) -> bytes:
    obj = {"round": b.round, "randomness": b.randomness().hex(),
           "signature": b.signature.hex()}
    if b.previous_sig:
        obj["previous_signature"] = b.previous_sig.hex()
    return json.dumps(obj, separators=(",", ":")).encode()


class _BeaconHandler:
    """Per-chain state: latest round + parked long-poll waiters."""

    def __init__(self, bp):
        self.bp = bp
        self.latest_round = 0
        self.pending: List[Tuple[int, threading.Event, list]] = []
        self.lock = make_lock()
        self._registered = False
        self.ensure_callback()

    def ensure_callback(self) -> None:
        """Register the waiter-release callback once the beacon engine is
        up (it may start only after a later DKG) (server.go:164-241)."""
        if not self._registered and self.bp.handler is not None:
            self.bp.handler.chain.cbstore.add_callback(
                "http-longpoll", self._on_beacon)
            self._registered = True
            # seed the head so next-round requests park instead of 404ing
            # (the reference's watch loop does the equivalent initial Get)
            try:
                head = self.bp.get_beacon(0).round
            except (ErrNoBeaconStored, ErrNoBeaconSaved):
                head = 0
            with self.lock:
                self.latest_round = max(self.latest_round, head)

    def _on_beacon(self, b: Beacon) -> None:
        with self.lock:
            self.latest_round = max(self.latest_round, b.round)
            still = []
            for round_, ev, slot in self.pending:
                if round_ <= b.round:
                    slot.append(b if round_ == b.round else None)
                    ev.set()
                else:
                    still.append((round_, ev, slot))
            self.pending = still

    def get(self, round_: int, info) -> Optional[Beacon]:
        try:
            return self.bp.get_beacon(round_)
        except (ErrNoBeaconStored, ErrNoBeaconSaved):
            pass
        if round_ == 0:
            return None
        with self.lock:
            block = self.latest_round != 0 \
                and round_ == self.latest_round + 1
            if block:
                ev = threading.Event()
                slot: list = []
                self.pending.append((round_, ev, slot))
        if block:
            if ev.wait(LONG_POLL_TIMEOUT) and slot and slot[0] is not None:
                return slot[0]
            try:
                return self.bp.get_beacon(round_)
            except (ErrNoBeaconStored, ErrNoBeaconSaved):
                return None
        # never serve futures (getRand server.go:328-332)
        return None


class RestServer:
    """The daemon's public REST face.  `daemon` may host many chains; every
    chain is addressable by hash, the default one also without it."""

    def __init__(self, daemon, listen: str = "127.0.0.1:0",
                 clock: Optional[Clock] = None, admission=None,
                 workers: Optional[int] = None):
        self.daemon = daemon
        self.log = daemon.log.named("http")
        # the daemon's injected clock when it has one (health math must
        # agree with the engine's idea of "now"), else the wall clock
        self.clock = clock \
            or getattr(getattr(daemon, "cfg", None), "clock", None) \
            or RealClock()
        # the daemon's serving-plane admission controller when it has one:
        # REST reads are sheddable-class, first to go under load
        self.admission = admission if admission is not None \
            else getattr(daemon, "admission", None)
        if workers is None:
            workers = getattr(getattr(daemon, "cfg", None),
                              "rest_workers", 0) or DEFAULT_REST_WORKERS
        host, _, port = listen.rpartition(":")
        self._handlers: Dict[str, _BeaconHandler] = {}
        self._hlock = make_lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                t0 = time.perf_counter()
                try:
                    code, body, headers = outer._route(
                        self.path,
                        if_none_match=self.headers.get("If-None-Match"),
                        authorization=self.headers.get("Authorization"))
                except Exception as e:
                    code, body, headers = 500, str(e).encode(), {}
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                for k, v in headers.items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)
                # path leaves include round numbers (/public/1234) — fold
                # everything outside the fixed route set into one bucket
                route = registered_label(
                    self.path.split("/")[-1] or "root",
                    known=("root", "health", "chains", "info", "latest",
                           "metrics"))
                http_latency.labels(route) \
                    .observe(time.perf_counter() - t0)

        self.httpd = BoundedHTTPServer((host or "127.0.0.1", int(port)),
                                       Handler, workers=workers,
                                       admission=self.admission)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # -- routing (server.go:87-98) ------------------------------------------

    def _bp_for_hash(self, chain_hash: str):
        bid = self.daemon.chain_hashes.get(chain_hash)
        if bid is None:
            raise KeyError(f"unknown chain {chain_hash}")
        return self.daemon.processes[bid]

    def _bh(self, bp) -> _BeaconHandler:
        with self._hlock:
            bh = self._handlers.get(bp.beacon_id)
            if bh is None:
                bh = self._handlers[bp.beacon_id] = _BeaconHandler(bp)
            bh.ensure_callback()
            return bh

    def _route(self, path: str, if_none_match: Optional[str] = None,
               authorization: Optional[str] = None):
        parts = [p for p in path.split("/") if p]
        if parts == ["health"]:
            return self._health()
        if parts == ["chains"]:
            return 200, json.dumps(
                sorted(self.daemon.chain_hashes)).encode(), {}
        # default-chain alias vs /{chainHash}/... prefix
        if parts and len(parts[0]) == 64:
            try:
                bp = self._bp_for_hash(parts[0])
            except KeyError:
                return 404, b'{"error":"unknown chain"}', {}
            parts = parts[1:]
        else:
            bp = self.daemon.processes.get("default")
            if bp is None:
                return 404, b'{"error":"no default chain"}', {}
        info = bp.chain_info()
        if info is None:
            return 503, b'{"error":"no group yet"}', {}

        if parts == ["info"]:
            api_call_counter.labels("info").inc()
            return 200, info.to_json(), {}
        if len(parts) == 2 and parts[0] == "public":
            api_call_counter.labels("public").inc()
            # authenticated tenant attribution (core/authz.py): a bearer
            # token names the tenant directly and is verified BEFORE the
            # quota gate spends anything — a bad token is a 401 carrying
            # the rejection reason, never a quota hit against the tenant
            # it claims.  No token (or no authority) keeps the anonymous
            # chain-name path byte-identical.
            tenant = None
            authority = getattr(self.daemon, "authority", None)
            if authority is not None and authority.active() \
                    and authorization is not None:
                from .core.authz import bearer_token
                verdict = authority.verify(bearer_token(authorization),
                                           chain=bp.beacon_id)
                if not verdict.ok:
                    from .metrics import identity_rejections
                    identity_rejections.labels("rest", verdict.reason).inc()
                    body = json.dumps(
                        {"error": "token rejected",
                         "reason": verdict.reason},
                        separators=(",", ":")).encode()
                    return 401, body, {}
                tenant = verdict.tenant
            # multi-tenant quota gate (core/tenancy.py): the pre-parse
            # shed can't see the chain-hash path segment, so the
            # per-tenant rules (pause / rate bucket / over-quota early
            # rung) run here, once the chain — hence the tenant — is
            # known but before any store or device work.  Rejections are
            # well-formed 429s carrying the tenant label, never silent.
            shed = self._tenant_gate(bp, tenant=tenant)
            if shed is not None:
                import math
                body = json.dumps(
                    {"error": "tenant quota exceeded",
                     "tenant": shed.tenant, "reason": shed.reason},
                    separators=(",", ":")).encode()
                return 429, body, {
                    "Retry-After": str(max(1, math.ceil(shed.retry_after)))}
            round_ = 0 if parts[1] == "latest" else int(parts[1])
            beacon = self._bh(bp).get(round_, info)
            if beacon is None:
                return 404, b'{"error":"round not available"}', {}
            headers = self._cache_headers(info, beacon,
                                          latest=(round_ == 0))
            etag = headers.get("ETag")
            if etag is not None and if_none_match is not None \
                    and _etag_matches(if_none_match, etag):
                # revalidation hit: immutable rounds never change, so the
                # edge answers 304 without re-serializing the beacon
                return 304, b"", headers
            return 200, _beacon_json(beacon), headers
        return 404, b'{"error":"no such route"}', {}

    def _tenant_gate(self, bp, tenant: Optional[str] = None):
        """Per-tenant read gate: resolve the chain's tenant and consult
        the admission controller's tenant rules.  None (no registry, no
        controller, or an admitted read) means serve.  `tenant` (from a
        verified bearer token) overrides the chain-name resolution —
        authenticated attribution beats the honor system."""
        tenancy = getattr(self.daemon, "tenancy", None)
        if tenancy is None or self.admission is None \
                or not hasattr(self.admission, "check_tenant_read"):
            return None
        try:
            if tenant is None:
                tenant = tenancy.tenant_for_chain(bp.beacon_id)
            # attribute the pre-parse ticket to the tenant FIRST, so the
            # share check below (and concurrent admissions) count this
            # request's token against the tenant's weighted share
            ticket = self.httpd.current_ticket()
            if ticket is not None \
                    and hasattr(self.admission, "attribute"):
                self.admission.attribute(ticket, tenant)
            return self.admission.check_tenant_read(tenant)
        except Exception:
            return None     # the gate must never cost a healthy read

    def _health(self):
        """200 when the default chain's head is current (server.go health)."""
        bp = self.daemon.processes.get("default")
        status, head, expected = 503, 0, 0
        if bp is not None and bp.handler is not None:
            info = bp.chain_info()
            try:
                head = bp.get_beacon(0).round
            except (ErrNoBeaconStored, ErrNoBeaconSaved):
                head = 0
            from .chain.timing import current_round
            expected = current_round(int(self.clock.now()), info.period,
                                     info.genesis_time)
            if head >= expected - 1:
                status = 200
        payload = {"status": status == 200, "current": head,
                   "expected": expected}
        # DKG/reshare lifecycle (core/dkg_journal.py): session statuses by
        # name, the live phase, and whether a staged reshare output is
        # waiting for its transition round — a wedged or failed session
        # (and a pending handover) must be visible without a metrics
        # scrape.  getattr: shim daemons in tests carry no journal.
        if bp is not None:
            lifecycle = getattr(bp, "dkg_lifecycle", None)
            if callable(lifecycle):
                try:
                    payload["dkg"] = lifecycle()
                except Exception:
                    pass
            # peer reliability (the Handel overlay's one source of truth,
            # net/resilience.py score_snapshot): score + breaker state +
            # last-transition per peer, bounded so a thousand-signer
            # committee can't balloon the health body — the worst-scored
            # peers are the interesting ones, keep those
            res = getattr(bp, "resilience", None)
            scores = getattr(res, "peer_scores", None)
            if callable(scores):
                try:
                    snap = scores()
                    if len(snap) > 64:
                        keep = sorted(snap, key=lambda k: snap[k]["score"])
                        snap = {k: snap[k] for k in keep[:64]}
                    if snap:
                        payload["peers"] = snap
                except Exception:
                    pass
            # committee-scale aggregation (beacon/handel.py): per-chain
            # overlay state so an operator sees the tree working
            handel = getattr(bp, "handel_summary", None)
            if callable(handel):
                try:
                    hs = handel()
                    if hs is not None:
                        payload["handel"] = hs
                except Exception:
                    pass
        # one-line verify-service summary: the daemon-owned service when
        # one exists, else the process default (never create one here)
        svc = None
        if bp is not None:
            svc = getattr(getattr(bp, "cfg", None), "_verify_service", None)
        if svc is None:
            from .crypto.verify_service import current_service
            svc = current_service()
        # serving-plane admission: the degradation-ladder level and the
        # queue-wait p99s an operator (or loadgen) needs to see overload
        # protection working without a metrics scrape
        if self.admission is not None:
            snap = self.admission.snapshot()
            payload["admission"] = {
                "level": snap["level"], "level_name": snap["level_name"],
                "wait_p99": snap["wait_p99"],
                "shed": sum(snap["shed"].values()),
            }
        # multi-tenant serving (core/tenancy.py): per-tenant config +
        # live quota level + admission/device counters, so a noisy
        # neighbor (and the quota squeezing it) is visible without a
        # metrics scrape.  Only present when tenants are registered —
        # single-operator daemons keep their /health shape.
        tenancy = getattr(self.daemon, "tenancy", None)
        if tenancy is not None:
            try:
                tsnap = tenancy.snapshot()
                if tsnap.get("tenants") or tsnap.get("load_error"):
                    payload["tenants"] = tsnap
            except Exception:
                pass
        # identity plane (net/identity.py): cert state
        # (fresh/grace/expired) + reload counters, and whether tenant
        # tokens are live — a mis-rotated cert must be visible here
        # during its grace window, before it ever bricks the mesh.
        # Only present when an identity dir is configured.
        identity = getattr(self.daemon, "identity", None)
        if identity is not None:
            try:
                payload["identity"] = identity.status()
            except Exception:
                pass
        authority = getattr(self.daemon, "authority", None)
        if authority is not None and authority.active():
            try:
                payload["authz"] = {
                    "tokens": len(authority.tokens()),
                    "revoked": sum(1 for r in authority.tokens()
                                   if r.revoked)}
            except Exception:
                pass
        if svc is not None:
            payload["verify"] = svc.summary()
            # occupancy observability: deepest in-flight
            # dispatch window seen and the queue-vs-device latency split,
            # so an occupancy regression is observable, not inferred
            st = svc.stats()
            payload["verify_inflight_depth"] = st["inflight_depth_max"]
            payload["verify_latency_split"] = {
                "pack_s": round(st["pack_time_s"], 3),
                "queue_s": round(st["queue_time_s"], 3),
                "device_s": round(st["device_time_s"], 3)}
            # multi-device scale-out: the device-group view —
            # group count/size, per-group state + dispatch counters and
            # the chain→group affinity map, so a faulted group (and which
            # chains it serves) is visible without a metrics scrape
            if st["n_groups"]:
                payload["verify_groups"] = {
                    "n_groups": st["n_groups"],
                    "n_devices": st["n_devices"],
                    "groups": {str(g): info
                               for g, info in st["groups"].items()},
                    "group_map": st["group_map"],
                    "sharded_dispatches": st["sharded_dispatches"],
                    "migrations": st["migrations"],
                }
            # the failure-domain degraded line: name every backend that is
            # currently failed over to the host path (or mid-probe) so an
            # operator scraping /health sees accelerator loss immediately
            # instead of inferring it from throughput
            degraded = svc.degraded_backends()
            payload["verify_degraded"] = bool(degraded)
            if degraded:
                payload["verify_degraded_backends"] = degraded
        # readiness vs liveness split (fleet harness / orchestrators):
        # `live` means "the process answers HTTP" — true by construction
        # when this handler runs; `ready` means "route traffic to me":
        # DKG complete (a group exists), chain head within one round of
        # clock-expected (status == 200 encodes it), not draining toward
        # a SIGTERM exit, and the verify plane not degraded to the host
        # path.  getattr: shim daemons in tests carry no draining flag.
        payload["live"] = True
        payload["ready"] = bool(
            status == 200
            and bp is not None and getattr(bp, "group", None) is not None
            and not getattr(self.daemon, "draining", False)
            and not payload.get("verify_degraded", False))
        body = json.dumps(payload).encode()
        return status, body, {}

    def _cache_headers(self, info, beacon: Beacon, latest: bool) -> dict:
        """CDN headers (server.go headers + the edge tier).

        `latest` expires at the next round boundary.  A numbered round is
        IMMUTABLE — same bytes forever on every node of the chain — so it
        gets a strong, deterministic `ETag` (derived from the signature,
        which the round's bytes commit to) plus `immutable` cache
        control: a CDN revalidates with If-None-Match and gets a bodyless
        304 instead of re-fetching the beacon."""
        if latest:
            nxt = time_of_round(info.period, info.genesis_time,
                                beacon.round + 1)
            return {"Expires": formatdate(nxt, usegmt=True),
                    "Cache-Control": f"public, max-age={info.period}"}
        return {"Cache-Control": "public, max-age=604800, immutable",
                "ETag": _beacon_etag(beacon)}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="rest-edge")
        self._thread.start()
        self.log.info("REST edge serving", port=self.port)

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2)
