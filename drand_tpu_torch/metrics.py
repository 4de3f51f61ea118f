"""The port's metrics, kept in process, with no prometheus_client.

The port's counterpart of the series of drand_tpu/metrics.py that its
modules touch: the daemon's group series (``last_beacon_round``,
``group_size``, the DKG and reshare states, ``error_sending_partial``) and
its ``drand_node_db`` / restart series, the ``verify_*`` series (the resident verify service, its
failure domain and the device pool), the serving plane's ``admission_*``
series and ``identity_rejections_total`` in the "private" registry, the
resilience (``resilience_*``) and chain-integrity (``chain_integrity_*``)
series in the "group" registry, the REST edge's ``api_call_counter`` and
``http_response_latency_seconds`` in the "http" registry and the HTTP
client's ``client_http_heartbeat`` in the "client" registry, as the
reference splits them.  The same
series names, label names and help text, so a dashboard built on the JAX
daemon reads the port's scrape unchanged.  The machines the port runs on
need not have ``prometheus_client``, so the counters, gauges and histograms
here are plain objects with the client's spelling (``.labels(...)``, then
``.inc()`` / ``.set()`` / ``.observe()``; ``.remove(...)`` raises KeyError
for an absent child) and ``scrape()`` writes the Prometheus text format.
Nothing is registered in prometheus_client's default registry, so a process
that loads both packages never registers a series twice.  ``MetricsServer``
and ``ThresholdMonitor`` are the reference's, over these registries.

Series the reference lacks, for the port's device seam: the aggregator's
partial checks by backend (``beacon_partial_checks_total``), their wall
(``beacon_partial_check_seconds``, ``beacon_partial_check_seconds_max``),
the checks that raised (``beacon_partial_check_errors_total``), all in the
"group" registry, and the verify service's host-served work
(``verify_service_host_served_total``).
"""

import math
import threading
from typing import Callable, Dict, Optional

from .log import Logger

DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75,
                   1.0, 2.5, 5.0, 7.5, 10.0, math.inf)


class Registry:
    """A set of series with unique names; ``scrape()`` renders them."""

    def __init__(self):
        self._metrics = []
        self._lock = threading.Lock()

    def register(self, metric) -> None:
        with self._lock:
            if any(m.name == metric.name for m in self._metrics):
                raise ValueError(f"series {metric.name} registered twice")
            self._metrics.append(metric)

    def scrape(self) -> bytes:
        with self._lock:
            metrics = list(self._metrics)
        lines = []
        for m in metrics:
            lines.append(f"# HELP {m.name} {_escape_help(m.doc)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for suffix, labels, value in m.samples():
                lines.append(f"{m.name}{suffix}{_labels(labels)} "
                             f"{_fmt(value)}")
        return ("\n".join(lines) + "\n").encode()


PRIVATE = Registry()
HTTP = Registry()
GROUP = Registry()
CLIENT = Registry()
_REGISTRIES = {"private": PRIVATE, "http": HTTP, "group": GROUP,
               "client": CLIENT}


def _fmt(v) -> str:
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v)


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _labels(pairs) -> str:
    if not pairs:
        return ""
    esc = lambda v: (v.replace("\\", "\\\\").replace("\n", "\\n")
                     .replace('"', '\\"'))
    return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in sorted(pairs)) + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, doc: str, labelnames=(), registry=None):
        self.name = name
        self.doc = doc
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children = {}
        (registry or PRIVATE).register(self)

    def labels(self, *values):
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: want labels {self.labelnames}, "
                             f"got {values}")
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._child()
        return child

    def remove(self, *values) -> None:
        key = tuple(str(v) for v in values)
        with self._lock:
            del self._children[key]

    def _only(self):
        if self.labelnames:
            raise ValueError(f"{self.name} is labelled: call .labels() first")
        return self.labels()

    def samples(self):
        with self._lock:
            children = sorted(self._children.items())
        for key, child in children:
            pairs = list(zip(self.labelnames, key))
            for suffix, extra, value in child.samples():
                yield suffix, pairs + extra, value


class _Value:
    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def samples(self):
        yield "", [], self.value


class _GaugeValue(_Value):
    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)


class Counter(_Metric):
    kind = "counter"
    _child = _Value

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("a counter only goes up")
        self._only().inc(amount)


class Gauge(_Metric):
    kind = "gauge"
    _child = _GaugeValue

    def set(self, value: float) -> None:
        self._only().set(value)


class _HistogramValue:
    def __init__(self, buckets):
        self._lock = threading.Lock()
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        with self._lock:
            self.sum += value
            self.count += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self.counts[i] += 1

    def samples(self):
        with self._lock:
            counts, total, n = list(self.counts), self.sum, self.count
        for b, c in zip(self.buckets, counts):
            yield "_bucket", [("le", _fmt(b))], c
        yield "_count", [], n
        yield "_sum", [], total


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, doc: str, labelnames=(),
                 buckets=DEFAULT_BUCKETS, registry=None):
        bs = tuple(sorted(float(b) for b in buckets))
        self.buckets = bs if bs[-1] == math.inf else bs + (math.inf,)
        super().__init__(name, doc, labelnames, registry)

    def _child(self):
        return _HistogramValue(self.buckets)

    def observe(self, value: float) -> None:
        self._only().observe(value)


def scrape(which: str = "private") -> bytes:
    """The Prometheus text of a registry ("private", "http", "group" or
    "client", where drand_tpu/metrics.py puts these series)."""
    try:
        return _REGISTRIES[which].scrape()
    except KeyError:
        raise ValueError(f"unknown registry {which!r}") from None


def scrape_all() -> bytes:
    return b"".join(_REGISTRIES[w].scrape()
                    for w in ("private", "http", "group", "client"))


# -- label cardinality control (drand_tpu/metrics.py registered_label):
# naturally unbounded values (peer addresses) pass through
# registered_label(), which admits the first `limit` distinct values of a
# namespace and folds the rest into `fallback`.

_label_sets = {}
_label_lock = threading.Lock()


def registered_label(value, known=None, ns: str = "default",
                     limit: int = 64, fallback: str = "other") -> str:
    """Bound a metric label value: with `known`, membership decides;
    without it, the first `limit` values of `ns` are kept."""
    v = str(value)
    if known is not None:
        return v if v in known else fallback
    with _label_lock:
        seen = _label_sets.setdefault(ns, set())
        if v in seen:
            return v
        if len(seen) < limit:
            seen.add(v)
            return v
    return fallback


# The daemon (core/): the reference's group series (metrics.go:83-88).
beacon_discrepancy_latency = Gauge(
    "beacon_discrepancy_latency",
    "Difference between the expected round time and the storage time (ms)",
    ["beacon_id"], registry=GROUP)
last_beacon_round = Gauge(
    "last_beacon_round", "Last locally stored beacon round",
    ["beacon_id"], registry=GROUP)
group_size = Gauge(
    "group_size", "Number of nodes in the group", ["beacon_id"],
    registry=GROUP)
group_threshold = Gauge(
    "group_threshold", "Threshold of the group", ["beacon_id"],
    registry=GROUP)
dkg_state = Gauge(
    "dkg_state", "DKG state (0 not started .. 4 done)", ["beacon_id"],
    registry=GROUP)
dkg_state_timestamp = Gauge(
    "dkg_state_timestamp", "When the DKG state last changed", ["beacon_id"],
    registry=GROUP)
reshare_state = Gauge(
    "reshare_state", "Reshare state", ["beacon_id"], registry=GROUP)
reshare_state_timestamp = Gauge(
    "reshare_state_timestamp", "When the reshare state last changed",
    ["beacon_id"], registry=GROUP)
drand_node_db = Gauge(
    "drand_node_db", "Storage engine in use", ["db"])
# restart observability: the gauge is this process's start stamp; the
# counter is seeded from the persisted restarts.json in the beacon folder
daemon_start_time_seconds = Gauge(
    "daemon_start_time_seconds", "Unix time this daemon process started")
daemon_restarts_total = Counter(
    "daemon_restarts_total",
    "Daemon starts beyond the first against this beacon folder "
    "(persisted across processes in <folder>/restarts.json)")
error_sending_partial = Counter(
    "error_sending_partial", "Failed partial beacon sends",
    ["beacon_id", "address"], registry=GROUP)
# DKG/reshare lifecycle (core/dkg_journal.py): session outcomes, the live
# session's phase, and whether a reshare output sits staged on disk.
dkg_sessions = Counter(
    "dkg_sessions_total",
    "DKG/reshare sessions by outcome",
    ["beacon_id", "kind", "result"], registry=GROUP)
dkg_phase_gauge = Gauge(
    "dkg_phase",
    "Live DKG session phase (0 idle, 1 setup, 2 deal, 3 response, "
    "4 justification, 5 adopt)",
    ["beacon_id"], registry=GROUP)
reshare_transition_pending = Gauge(
    "reshare_transition_pending",
    "1 while a reshare output is staged on disk awaiting its transition "
    "round (the pending-transition ledger is non-empty)",
    ["beacon_id"], registry=GROUP)
# Multi-tenant serving (core/tenancy.py).
tenant_requests = Counter(
    "tenant_requests_total",
    "Admission decisions attributed to a tenant",
    ["tenant", "decision"])
tenant_device_seconds = Counter(
    "tenant_device_seconds_total",
    "Verify-service device seconds attributed to a tenant (measured off "
    "the pack|queue|device latency split)",
    ["tenant"])
tenant_quota_level = Gauge(
    "tenant_quota_level",
    "Device-time quota level per tenant (used/allowed over the rolling "
    "window; >= 1 is over quota)",
    ["tenant"])
# The mTLS plane (net/identity.py) and the token authority (core/authz.py).
identity_cert_state = Gauge(
    "identity_cert_state",
    "Local mTLS cert expiry state (0 fresh, 1 grace, 2 expired; grace "
    "and expired both keep serving — rotation is overdue, not fatal)")
identity_cert_reloads = Counter(
    "identity_cert_reloads_total",
    "Cert-dir hot reloads by result (ok | error)",
    ["result"])
authz_tokens = Counter(
    "authz_tokens_total",
    "Tenant-token lifecycle events (minted | revoked)",
    ["event"])
# Integrity-scan resumability (chain/integrity.py ScanCheckpoint).
integrity_scan_resumed_from = Gauge(
    "chain_integrity_scan_resumed_from",
    "Round the latest integrity scan resumed from (0 = full rescan)",
    ["beacon_id"], registry=GROUP)

# Resident verify service (crypto/verify_service.py): every verify consumer
# submits through one pipeline; these series answer "is coalescing working"
# (fill ratio up, dispatches well below requests) and "are live rounds
# starved" (live queue depth, preemption count).
verify_requests = Counter(
    "verify_service_requests_total",
    "Verification submissions accepted by the verify service",
    ["lane"])
verify_dispatches = Counter(
    "verify_service_dispatches_total",
    "Device/host dispatches issued by the verify service "
    "(group = the device group whose stream dispatched)",
    ["lane", "group"])
verify_queue_depth = Gauge(
    "verify_service_queue_depth",
    "Requests waiting in a verify-service lane", ["lane"])
verify_fill_ratio = Histogram(
    "verify_service_batch_fill_ratio",
    "Real lanes / padded width per coalesced dispatch",
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0))
verify_dispatch_latency = Histogram(
    "verify_service_dispatch_latency_seconds",
    "Verify-service latency split: phase=pack is host chunk-packing wall "
    "time (numpy wire parse + message packing; the term device "
    "hash-to-field removes the hashing from), phase=queue is "
    "submit-to-gather wait (coalescing window + lane contention, per "
    "batch), phase=device is dispatch-to-verdict wall time (per coalesced "
    "chunk) — occupancy regressions show up as device-time growth, "
    "overload as queue growth, host-bound packing as pack growth",
    ["lane", "phase"])
verify_inflight = Gauge(
    "verify_service_inflight_depth",
    "Dispatches currently enqueued ahead of the resolve point in the "
    "depth-k pipelined executor (0 when idle)")
verify_preemptions = Counter(
    "verify_service_preemptions_total",
    "Background batches preempted at a chunk boundary by live work")
# Device failure domain (the service's watchdog and failover): `chain` is
# "<scheme>:<pk hex prefix>", one series per backend handle.  backend_state
# encodes the failover state machine (0 healthy, 1 suspect, 2 degraded,
# 3 probing); failovers count device->host swaps AND host->device
# re-promotions (the `direction` label tells them apart).
verify_failovers = Counter(
    "verify_service_failovers_total",
    "Verify-service backend swaps (device->host and re-promotions)",
    ["chain", "direction"])
verify_backend_state = Gauge(
    "verify_service_backend_state",
    "Verify backend failover state (0 healthy, 1 suspect, 2 degraded, "
    "3 probing); group = the chain's device-group affinity",
    ["chain", "group"])
# The device pool (crypto/device_pool.py): one series per device group, how
# many devices it owns.
verify_group_devices = Gauge(
    "verify_service_group_devices",
    "Devices owned by each verify-service device group",
    ["group"])
verify_watchdog_trips = Counter(
    "verify_service_watchdog_trips_total",
    "Device dispatches abandoned after blowing their watchdog deadline",
    ["chain"])
verify_host_served = Counter(
    "verify_service_host_served_total",
    "Chunks and aggregation-time partial checks a host backend served "
    "(a host handle, a failover's fallback, a host partial verifier)")
verify_probe_latency = Histogram(
    "verify_service_probe_latency_seconds",
    "Canary probe dispatch latency on a degraded device backend",
    ["chain"])

# Resilience layer (net/resilience.py): per-peer circuit breakers and the
# retry/deadline executor.  `resilience_breaker_state` is 0 closed / 1 open /
# 2 half-open; transitions carry the target state as a label.
breaker_state = Gauge(
    "resilience_breaker_state",
    "Per-peer circuit breaker state (0 closed, 1 open, 2 half-open)",
    ["scope", "address"], registry=GROUP)
breaker_transitions = Counter(
    "resilience_breaker_transitions_total",
    "Circuit breaker state transitions", ["scope", "address", "state"],
    registry=GROUP)
retries_total = Counter(
    "resilience_retries_total", "Retry attempts after a failed call",
    ["scope", "op"], registry=GROUP)
deadline_exceeded_total = Counter(
    "resilience_deadline_exceeded_total",
    "Operations abandoned because their overall budget was spent",
    ["scope", "op"], registry=GROUP)
# Chain-integrity subsystem (chain/integrity.py, beacon/sync.py heal):
# `verifier` is host|device, what the scan's verifier ran on.
integrity_beacons_scanned = Counter(
    "chain_integrity_beacons_scanned_total",
    "Beacon rounds examined by integrity scans",
    ["beacon_id", "verifier", "trigger"], registry=GROUP)
integrity_corrupt_found = Counter(
    "chain_integrity_corrupt_found_total",
    "Corrupt/missing rounds flagged by integrity scans",
    ["beacon_id", "kind", "trigger"], registry=GROUP)
integrity_quarantined = Counter(
    "chain_integrity_quarantined_total",
    "Corrupt rounds deleted (quarantined) pending re-fetch",
    ["beacon_id"], registry=GROUP)
integrity_repaired = Counter(
    "chain_integrity_repaired_total",
    "Quarantined/missing rounds re-fetched, re-verified and restored",
    ["beacon_id"], registry=GROUP)
integrity_promoted = Counter(
    "chain_integrity_promoted_total",
    "Tombstoned rows re-verified against a restored anchor and promoted "
    "back without a peer re-fetch",
    ["beacon_id"], registry=GROUP)
# The aggregator (beacon/chainstore.py): partial checks that raised.  The
# port wires the device check with no host fallback, so this is where a
# broken card shows.
partial_checks = Counter(
    "beacon_partial_checks_total",
    "Aggregation-time partial checks by the backend that ran them "
    "(device | host)", ["beacon_id", "backend"], registry=GROUP)
partial_check_seconds = Histogram(
    "beacon_partial_check_seconds",
    "Wall of one aggregation-time partial check (queue and run)",
    ["beacon_id"],
    buckets=(0.01, 0.025, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.8, 1.0,
             1.5, 2.0, 3.0, 5.0, 10.0), registry=GROUP)
partial_check_seconds_max = Gauge(
    "beacon_partial_check_seconds_max",
    "Longest aggregation-time partial check so far", ["beacon_id"],
    registry=GROUP)
partial_check_errors = Counter(
    "beacon_partial_check_errors_total",
    "Aggregation-time partial checks that raised (the round waits for its "
    "next partial)", ["beacon_id"], registry=GROUP)

# The REST edge (http_server.py) and the HTTP client transport
# (client/transports.py).
api_call_counter = Counter(
    "api_call_counter", "Public API calls", ["api_method"], registry=HTTP)
http_latency = Histogram(
    "http_response_latency_seconds", "REST edge latency", ["route"],
    registry=HTTP)
client_http_heartbeat = Counter(
    "client_http_heartbeat", "HTTP client watch liveness", ["url"],
    registry=CLIENT)
# Serving-plane admission control (net/admission.py): `cls` is
# critical|normal|sheddable, `decision` admitted|shed; `admission_level` is
# the degradation-ladder rung (0 nominal, 1 shed-public, 2
# pause-background, 3 shed-normal).
admission_requests = Counter(
    "admission_requests_total",
    "Serving-plane admission decisions",
    ["cls", "decision"])
admission_wait_seconds = Histogram(
    "admission_wait_seconds",
    "Admission queue wait per admitted request (the ladder's p99 signal)",
    ["cls"],
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0))
admission_level = Gauge(
    "admission_level",
    "Degradation-ladder level (0 nominal .. 3 shed-normal)")
admission_inflight = Gauge(
    "admission_inflight",
    "Requests currently holding an admission token", ["cls"])
admission_background_paused = Gauge(
    "admission_background_paused",
    "1 while the ladder has paused the verify service's background lane")
# The identity plane (core/authz.py): tenant-token verdicts on the REST
# edge, a bounded reason label.
identity_rejections = Counter(
    "identity_rejections_total",
    "Authentication rejections by surface (grpc | rest | handel) and "
    "reason (token REASON_* values, or impersonation)",
    ["surface", "reason"])


class ThresholdMonitor:
    """Escalating alerts when partial-send failures approach the threshold
    (metrics/threshold_monitor.go:12-105)."""

    def __init__(self, beacon_id: str, log: Logger, threshold: int,
                 period: float = 60.0):
        self.beacon_id = beacon_id
        self.log = log
        self.threshold = threshold
        self.period = period
        self._failed: Dict[str, bool] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name=f"thr-mon-{self.beacon_id}")
            self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.period):
            with self._lock:
                failing = sorted(self._failed)
                self._failed = {}
                thr = self.threshold
            if len(failing) >= thr:
                self.log.error("failed connections crossed threshold in the "
                               "last minute", threshold=thr,
                               failures=len(failing), nodes=",".join(failing))
            elif len(failing) >= thr // 2:
                self.log.warn("failed connections crossed half threshold in "
                              "the last minute", threshold=thr,
                              failures=len(failing), nodes=",".join(failing))

    def report_failure(self, addr: str) -> None:
        error_sending_partial.labels(
            self.beacon_id,
            registered_label(addr, ns="peer-address", limit=256)).inc()
        with self._lock:
            self._failed[addr] = True

    def update_threshold(self, new_threshold: int) -> None:
        with self._lock:
            self.threshold = new_threshold

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


class MetricsServer:
    """Plain-HTTP metrics endpoint with profiling and peer federation
    (metrics.go:365-399).

    Routes: `/metrics` (all registries), `/metrics/<registry>`,
    `/debug/gc` (manual GC trigger, metrics.go:390-393), `/debug/pprof`
    (thread stack dump — Python's nearest pprof analogue), and
    `/peer/<addr>/metrics` when a peer-handler is installed."""

    def __init__(self, port: int, host: str = "127.0.0.1",
                 peer_metrics: Optional[Callable[[str], bytes]] = None):
        import http.server

        self.peer_metrics = peer_metrics
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                try:
                    body, ctype = outer._route(self.path)
                except KeyError:
                    self.send_error(404)
                    return
                except Exception as e:   # peer unreachable etc.
                    self.send_error(502, explain=str(e))
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.end_headers()
                self.wfile.write(body)

        self.httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def _route(self, path: str):
        text = "text/plain; version=0.0.4"
        if path == "/metrics":
            return scrape_all(), text
        if path.startswith("/metrics/"):
            try:
                return scrape(path.split("/", 2)[2]), text
            except ValueError:
                raise KeyError(path) from None
        if path == "/debug/gc":
            import gc
            gc.collect()
            return b"GC run\n", "text/plain"
        if path == "/debug/pprof":
            import sys
            import traceback
            frames = sys._current_frames()
            out = []
            for tid, frame in frames.items():
                out.append(f"Thread {tid}:\n"
                           + "".join(traceback.format_stack(frame)))
            return "\n".join(out).encode(), "text/plain"
        if path.startswith("/peer/") and path.endswith("/metrics") \
                and self.peer_metrics is not None:
            addr = path[len("/peer/"):-len("/metrics")]
            return self.peer_metrics(addr), text
        raise KeyError(path)

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="metrics-http")
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
