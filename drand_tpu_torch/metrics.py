"""The port's metrics, kept in process, with no prometheus_client.

The port's counterpart of the series of drand_tpu/metrics.py that its
modules touch: the ``verify_*`` series (the resident verify service, its
failure domain and the device pool) in the "private" registry, and the
resilience (``resilience_*``) and chain-integrity (``chain_integrity_*``)
series in the "group" registry, as the reference splits them.  The same
series names, label names and help text, so a dashboard built on the JAX
daemon reads the port's scrape unchanged.  The machines the port runs on
need not have ``prometheus_client``, so the counters, gauges and histograms
here are plain objects with the client's spelling (``.labels(...)``, then
``.inc()`` / ``.set()`` / ``.observe()``; ``.remove(...)`` raises KeyError
for an absent child) and ``scrape()`` writes the Prometheus text format.
Nothing is registered in prometheus_client's default registry, so a process
that loads both packages never registers a series twice.
"""

import math
import threading

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
GROUP = Registry()
_REGISTRIES = {"private": PRIVATE, "group": GROUP}


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
    """The Prometheus text of a registry ("private" or "group", where
    drand_tpu/metrics.py puts these series)."""
    try:
        return _REGISTRIES[which].scrape()
    except KeyError:
        raise ValueError(f"unknown registry {which!r}") from None


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
partial_check_errors = Counter(
    "beacon_partial_check_errors_total",
    "Aggregation-time partial checks that raised (the round waits for its "
    "next partial)", ["beacon_id"], registry=GROUP)
