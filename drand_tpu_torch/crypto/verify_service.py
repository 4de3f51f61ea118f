"""Resident verify service: ONE owner of the device pipeline for all
verification, the port's copy of drand_tpu/crypto/verify_service.py.

Every consumer of the reference daemon (catch-up sync, client sweeps,
partial aggregation, integrity scans) reaches the device through this
service, never through a bare verifier.  It keeps the reference's structure
and names:

  * **Request coalescing.**  Submissions from all callers of the same chain
    merge into canonical padded batches (default 8192 lanes); each caller
    gets a future for exactly its slice of the verdict array.
  * **Priority lanes.**  Live-round work preempts background work at the
    next chunk boundary; a deadline-aware scheduler on the injected `Clock`
    flushes under-filled background batches once their coalescing window
    expires.
  * **Double-buffered streaming.**  Host packing of chunk k+1 (a packer
    thread) overlaps device compute of chunk k (the group's scheduler
    thread) through the verifier's pack / dispatch / resolve triple, up to
    a depth-k in-flight window.  `pack_chunk` launches nothing: the device
    hash front (H1) runs at the start of `dispatch_packed`.
  * **Device failure domain.**  Every dispatch carries a watchdog deadline
    (max of DRAND_VERIFY_WATCHDOG_FLOOR, 120 s, and a multiple of the
    slot's own p99); a dispatch that blows it or raises marks the backend
    *suspect* and is retried once; a second strike fails the handle over
    (to a healthy sibling device group, else to the caller's host
    fallback, e.g. `crypto.hostverify.HostBatchVerifier`), with every
    in-flight and queued request REQUEUED, never failed.  A rate-limited
    canary probe re-promotes the device backend: `healthy -> suspect ->
    degraded -> probing -> healthy`.
  * **The device pool.**  `crypto/device_pool.py` partitions the CUDA
    devices into groups; every handle gets a sticky least-loaded group and
    each group runs its own scheduler/packer stream.  Batch submissions at
    or above the shard threshold (DRAND_VERIFY_SHARD_THRESHOLD; auto = pad
    x max(2, n_devices)) route to a pool-wide verifier whose RLC passes
    split over every device (crypto/batch.py).

Consumers hold a `VerifyHandle` (from `VerifyService.handle`) exposing the
blocking `verify_batch(rounds, sigs, prev_sigs) -> bool array` and the
async `submit(...) -> VerifyFuture`.

What changed from the reference is only where it touched JAX:

  * a device handle's backend is the port's `BatchBeaconVerifier`, always
    placed on its group's devices (`sharding=group.sharding()`: one device,
    or an ordered list), with the hash front fixed per handle
    (`h2f_device_default(pad)`);
  * the pool enumerates CUDA devices (`device_pool.cuda_devices`), and the
    tuning platform is "cuda" for a pool with a card, "cpu" otherwise;
  * metrics go to the port's `metrics.py`, which needs no
    prometheus_client.

One deliberate difference: ``handle(scheme, pk, device=True)`` on a pool
with no device RAISES a RuntimeError, where the reference quietly hands
out a host handle when jax is absent.  The port never carries on quietly
on the CPU: to run device handles on the CPU (the plain PyTorch versions
of the kernels), build the service with
``pool=DevicePool(devices=[torch.device("cpu")])``.  ``device=False``
still gives the host handle, as in the reference.

A second: a device handle gets no host fallback of its own.  The
reference gives every device handle a lazy `HostBatchVerifier`; here the
supervised failover to the host after two strikes runs only where the
caller passes ``fallback=`` (the daemon's wiring may opt in).  Without
one, a device error that no healthy sibling group can take (a failed
build, a failed launch, a sticky CUDA error) reaches the callers'
futures, so the device's work never moves quietly to host pairing.

This module imports no torch at module scope: device backends are built
lazily on the first device handle.
"""

import os
import threading

from ..common import make_condition, make_lock
from collections import deque
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

LANE_LIVE = "live"
LANE_BACKGROUND = "background"
LANES = (LANE_LIVE, LANE_BACKGROUND)

DEFAULT_PAD = 8192          # the canonical batch width bench.py standardized
DEFAULT_BG_WINDOW = 0.02    # seconds a background batch may wait to fill
DEFAULT_LIVE_WINDOW = 0.0   # live work flushes immediately

# Occupancy knobs.  pad=0 / pipeline_depth=0 on the ctor mean
# AUTO: each handle resolves its (pad, depth) through crypto/tuning.py —
# env override (DRAND_VERIFY_PAD / DRAND_VERIFY_PIPELINE_DEPTH) wins over
# a TUNING.json entry for the current backend platform, which wins over
# the 8192x1 defaults (a container with no chip and no tuning file
# behaves exactly as before).

# Failure-domain knobs (Config.verify_watchdog_factor / verify_probe_interval
# override per daemon; the env vars override the module defaults the same way
# net/resilience.py's DRAND_RETRY_* family does).  The deadline for a device
# dispatch is max(FLOOR, FACTOR * observed p99 of this service's own dispatch
# latencies): the factor keeps a healthy-but-slow chip off the trip wire, the
# floor covers the kernels' first build (nvcc at first use, seconds to
# minutes), which looks exactly like a hang to anything less patient.
# Huge-batch round-axis sharding: a single submission of at
# least this many rounds routes to the pool-wide sharded backend instead
# of its handle's device group.  0 = AUTO: pad x max(2, pool devices) —
# below roughly one pool-wide chunk the per-device shards are too narrow
# to amortize the split and the partial sums' moves.
DEFAULT_SHARD_THRESHOLD = int(
    os.environ.get("DRAND_VERIFY_SHARD_THRESHOLD", "0"))

DEFAULT_WATCHDOG_FACTOR = float(
    os.environ.get("DRAND_VERIFY_WATCHDOG_FACTOR", "8"))
DEFAULT_WATCHDOG_FLOOR = float(
    os.environ.get("DRAND_VERIFY_WATCHDOG_FLOOR", "120"))
DEFAULT_PROBE_INTERVAL = float(
    os.environ.get("DRAND_VERIFY_PROBE_INTERVAL", "5"))

# Backend failover states (the verify_service_backend_state gauge values).
STATE_HEALTHY = "healthy"
STATE_SUSPECT = "suspect"
STATE_DEGRADED = "degraded"
STATE_PROBING = "probing"
_STATE_CODE = {STATE_HEALTHY: 0, STATE_SUSPECT: 1, STATE_DEGRADED: 2,
               STATE_PROBING: 3}

# the submit API's future type: the stdlib one — set_result/set_exception/
# result(timeout)/done() are exactly the contract the service needs, and
# callers get cancellation/done-callbacks for free
VerifyFuture = Future


class DeviceFailure(RuntimeError):
    """A device dispatch was abandoned by the watchdog (hang) or failed
    its retry; surfaced only where no fallback path exists."""


class _Abandoned(Exception):
    """Internal: the watchdog cancelled this dispatch while it was in
    flight — the (stale) executing thread must discard its result and
    never touch the requests' futures."""


class _Requeued(Exception):
    """Internal: this batch's requests were requeued (failover); the
    executing thread unwinds without resolving any future."""


class _Request:
    """One queued unit of work: either a coalescable verify-batch span or
    an opaque callable (the partial-aggregation path, whose batching is
    internal to `BatchPartialVerifier`)."""

    __slots__ = ("kind", "key", "backend", "rounds", "sigs", "prevs", "fn",
                 "lane", "future", "enqueued", "n", "flush", "retried",
                 "sharded")

    def __init__(self, kind, lane, future, enqueued, key=None, backend=None,
                 rounds=None, sigs=None, prevs=None, fn=None, flush=False,
                 sharded=False):
        self.kind = kind            # "batch" | "call"
        self.lane = lane
        self.future = future
        self.enqueued = enqueued
        self.key = key
        self.backend = backend
        self.rounds = rounds
        self.sigs = sigs
        self.prevs = prevs
        self.fn = fn
        self.n = len(rounds) if rounds is not None else 1
        self.flush = flush          # dispatch-ready: skip the window
        self.retried = False        # one watchdog-driven requeue spent
        self.sharded = sharded      # huge batch: pool-wide sharded backend


class _Batch:
    """One coalesced dispatch unit handed to the executor."""

    __slots__ = ("lane", "backend", "requests", "call", "key", "slot",
                 "stream", "sharded")

    def __init__(self, lane, backend=None, requests=None, call=None,
                 key=None, slot=None, stream=None, sharded=False):
        self.lane = lane
        self.backend = backend
        self.requests: List[_Request] = requests or []
        self.call: Optional[_Request] = call
        self.key = key
        self.slot = slot
        self.stream: Optional["_GroupStream"] = stream
        self.sharded = sharded

    @property
    def n(self) -> int:
        return sum(r.n for r in self.requests)

    @property
    def gid(self) -> int:
        return self.stream.gid if self.stream is not None else 0


class _GroupStream:
    """One dispatch stream — the scheduler thread, packer and lane queues
    of ONE device group.  k groups give the service k independent streams:
    k concurrent depth-k in-flight windows on k devices, with per-group
    preemption, failover and accounting (mutable state guarded by the
    service's one `_cond`; threads are per stream)."""

    __slots__ = ("gid", "queues", "thread", "packer", "dispatches",
                 "inflight_max", "active")

    def __init__(self, gid: int):
        self.gid = gid
        self.queues: Dict[str, deque] = {ln: deque() for ln in LANES}
        self.thread = None
        self.packer = None
        self.dispatches = 0         # per-group dispatch counter (stats)
        self.inflight_max = 0       # deepest in-flight window of this group
        self.active = 0             # batches currently executing (depth-2
                                    # max: a live preemption re-enters)


class _Ticket:
    """One in-flight dispatch under watchdog supervision.  Tickets of the
    same slot form one shared-device window: only the OLDEST is eligible
    to trip, and when it retires (success or trip) the survivors'
    deadlines are re-based from `budget` — they were queued behind it,
    not hung."""

    __slots__ = ("slot", "batch", "kind", "started", "deadline_at",
                 "budget", "cancelled")

    def __init__(self, slot, batch, kind, started, deadline_at,
                 budget=None):
        self.slot = slot
        self.batch = batch
        self.kind = kind            # "chunk" | "call" | "probe"
        self.started = started
        self.deadline_at = deadline_at
        self.budget = budget if budget is not None \
            else max(0.0, deadline_at - started)
        self.cancelled = False


class _BackendSlot:
    """Failover state for one handle key: the primary (device) backend,
    the lazily-built fallback, the state machine, and the dispatch
    latency history the watchdog deadline derives from."""

    __slots__ = ("key", "label", "primary", "fallback_factory", "fallback",
                 "state", "latencies", "sample", "failovers", "degraded_at",
                 "first_fault_at", "pad", "depth", "scheme", "pk", "kind",
                 "gid", "group_size", "backend_factory", "pool_backend",
                 "pool_pad", "pool_ok", "pool_retry_at", "migrations",
                 "tenant")

    def __init__(self, key, label, primary, fallback_factory=None,
                 pad=DEFAULT_PAD, depth=1, scheme=None, pk=b"",
                 kind="custom", gid=0, group_size=0, backend_factory=None,
                 tenant=None):
        self.key = key
        self.label = label
        self.primary = primary
        self.fallback_factory = fallback_factory
        self.fallback = None
        self.state = STATE_HEALTHY
        self.latencies: deque = deque(maxlen=64)
        self.pad = pad          # coalesced batch width for this handle
        self.depth = depth      # dispatch-pipeline depth for this handle
        self.scheme = scheme    # retained for sibling-group backend builds
        self.pk = pk
        self.kind = kind        # "device" | "host" | "custom"
        # -- device-group affinity --
        self.gid = gid                  # this handle's device group
        self.group_size = group_size    # devices in that group
        # rebuilds the primary on another group (group→sibling failover);
        # None = not group-backed, the slot degrades straight to host
        self.backend_factory = backend_factory
        self.pool_backend = None        # pool-wide sharded backend (lazy)
        self.pool_pad = 0               # its chunk span (pad x n_devices)
        self.pool_ok = True             # sharding disabled after a pool fault
        self.pool_retry_at = None       # clock time sharding re-arms at
        self.migrations = 0             # group→sibling failovers taken
        # (rounds, sigs, prevs, verdict) of a known-good 1-lane dispatch:
        # the canary probe replays it and requires the same verdict, so a
        # poisoned device (answers, but wrongly) cannot re-promote itself
        self.sample = None
        self.failovers = 0
        self.degraded_at = None
        self.first_fault_at = None
        # multi-tenant serving: the tenant this chain belongs
        # to — device-time accounting + the placement map key
        self.tenant = tenant

    @property
    def can_failover(self) -> bool:
        return self.fallback_factory is not None

    def active(self):
        if self.state in (STATE_DEGRADED, STATE_PROBING) \
                and self.fallback is not None:
            return self.fallback
        return self.primary


class VerifyHandle:
    """Per-chain submit surface; drop-in for the old per-consumer
    verifier objects (`verify_batch` + `kind` for the integrity-scan
    metrics label)."""

    def __init__(self, service: "VerifyService", key, scheme, backend):
        self.service = service
        self.key = key
        self.scheme = scheme
        self.backend = backend
        self.kind = getattr(backend, "kind", "host")

    @property
    def gid(self) -> int:
        """This handle's device-group id (chain→device affinity)."""
        slot = self.service._slots.get(self.key)
        return slot.gid if slot is not None else 0

    def submit(self, rounds, sigs, prev_sigs=None,
               lane: str = LANE_BACKGROUND,
               flush_now: bool = False) -> VerifyFuture:
        return self.service.submit(self, rounds, sigs, prev_sigs, lane=lane,
                                   flush_now=flush_now)

    def verify_batch(self, rounds, sigs, prev_sigs=None,
                     lane: str = LANE_BACKGROUND) -> np.ndarray:
        # a BLOCKING caller cannot submit more work while it waits, so
        # holding its request for the coalescing window buys nothing and
        # costs latency per call (and a serial chunk loop — catch-up
        # sync — would pay it per chunk).  flush_now skips the window;
        # already-queued same-chain work still merges at gather time.
        #
        # The unbounded result() is deliberate: the failure domain
        # guarantees resolution — a hung device dispatch is abandoned at
        # its watchdog deadline and the request requeued to the host
        # fallback, and stop() fails every still-queued future.
        return self.submit(rounds, sigs, prev_sigs, lane=lane,
                           flush_now=True).result()


class _PartialLaneVerifier:
    """Aggregation-time partial verifier routed through the service's
    LIVE lane: wraps any inner `.verify(msg, partials)` implementation
    (Device/HostPartialVerifier) so live-round aggregation preempts
    background scans at the next chunk boundary instead of contending
    for the device ad hoc.  When a fallback factory is provided, a
    device failure (watchdog abandon or repeated raise) falls back to
    the host partial verifier instead of costing the round."""

    def __init__(self, service: "VerifyService", inner,
                 fallback_factory: Optional[Callable] = None):
        self.service = service
        self.inner = inner
        self.kind = getattr(inner, "kind", "host")
        self._fallback_factory = fallback_factory
        self._fallback = None

    def verify(self, msg: bytes, partials):
        fut = self.service.submit_call(
            lambda: self.inner.verify(msg, partials), lane=LANE_LIVE)
        try:
            # bounded by the service watchdog + stop(), like verify_batch
            out = fut.result()
        except Exception:
            if self._fallback_factory is None:
                raise
            if self._fallback is None:
                self._fallback = self._fallback_factory()
            fb = self._fallback
            fut = self.service.submit_call(
                lambda: fb.verify(msg, partials), lane=LANE_LIVE)
            out = fut.result()
            if getattr(fb, "kind", "host") == "host":
                self.service._note_host_served()
            return out
        if self.kind == "host":
            self.service._note_host_served()
        return out


class VerifyService:
    """The daemon-owned coalescing, priority-laned verify dispatcher.

    All mutable scheduler state lives under `self._cond`; device/host
    work always executes OUTSIDE the lock on the single service thread,
    so callers only ever block on their own futures.

    The failure domain rides alongside: `_guarded` registers a watchdog
    ticket around every backend call (an O(1) dict insert on the
    dispatch path — the watchdog OBSERVES, it never sits between submit
    and dispatch), the `verify-watchdog` thread trips tickets that blow
    their deadline, and `verify-probe` canaries degraded backends back
    to health."""

    def __init__(self, clock=None, pad: int = 0,
                 live_window: float = DEFAULT_LIVE_WINDOW,
                 background_window: float = DEFAULT_BG_WINDOW,
                 watchdog_factor: Optional[float] = None,
                 watchdog_floor: Optional[float] = None,
                 probe_interval: Optional[float] = None,
                 pipeline_depth: int = 0,
                 device_groups: int = 0,
                 shard_threshold: int = 0,
                 pool=None):
        if clock is None:
            # deferred import: crypto must not hard-depend on beacon at
            # module scope (same layering softening as net/resilience.py)
            from ..beacon.clock import RealClock
            clock = RealClock()
        self.clock = clock
        # pad/pipeline_depth 0 = AUTO: resolved per handle via
        # crypto/tuning.py (env > TUNING.json > 8192x1); non-zero pins.
        self.pad_override = max(0, int(pad or 0))
        self.depth_override = max(0, int(pipeline_depth or 0))
        self.pad = self.pad_override or DEFAULT_PAD
        self.windows = {LANE_LIVE: live_window,
                        LANE_BACKGROUND: background_window}
        self.watchdog_factor = watchdog_factor or DEFAULT_WATCHDOG_FACTOR
        self.watchdog_floor = watchdog_floor or DEFAULT_WATCHDOG_FLOOR
        self.probe_interval = probe_interval or DEFAULT_PROBE_INTERVAL
        # device pool / sharding knobs: group count 0 = AUTO
        # (one group per device), shard threshold 0 = AUTO (pad x
        # max(2, pool devices)); `pool` injects a prebuilt DevicePool
        # (tests).  The pool itself is built lazily on first handle.
        self.device_groups = max(0, int(device_groups or 0))
        self.shard_threshold = max(0, int(shard_threshold or 0)) \
            or DEFAULT_SHARD_THRESHOLD
        self._pool = pool
        # core/tenancy.py TenantRegistry (duck-typed): placement hints at
        # handle creation, per-tenant device-time accounting per dispatch
        self._tenancy = None
        self._tenant_rebalances = 0
        self._cond = make_condition()
        self._streams: Dict[int, _GroupStream] = {}
        self._handles: Dict[Tuple, VerifyHandle] = {}
        self._slots: Dict[Tuple, _BackendSlot] = {}
        self._tickets: Dict[int, _Ticket] = {}
        self._watchdog_thread: Optional[threading.Thread] = None
        self._probe_thread: Optional[threading.Thread] = None
        self._call_rr = 0           # round-robin lane for opaque calls
        self._stopped = False
        # serving-plane degradation ladder (net/admission.py): while True
        # the BACKGROUND lane does not drive dispatches — its requests
        # queue (requeue-never-fail) and flush when the ladder steps back
        # down.  Live work is never paused, and queued background
        # requests still ride a live dispatch of the same chain for free.
        self._bg_paused = False
        # stats (guarded by _cond; ints so tests need not scrape prom)
        self._submitted = 0
        self._dispatches = 0
        self._dispatch_lanes = 0    # sum of real lanes over all dispatches
        self._dispatch_slots = 0    # sum of padded widths over all dispatches
        self._pack_time = 0.0       # sum of per-chunk host pack wall time
        self._queue_time = 0.0      # sum of per-batch queue waits (oldest rider)
        self._device_time = 0.0     # sum of per-chunk dispatch->verdict time
        self._inflight_max = 0      # deepest in-flight window observed
        self._preemptions = 0
        self._failovers = 0
        self._promotions = 0
        self._watchdog_trips = 0
        self._host_served = 0       # chunks and partial checks the host ran
        self._migrations = 0        # group→sibling backend rebuilds
        self._sharded_dispatches = 0    # pool-wide huge-batch dispatches
        self._concurrent_max = 0    # most streams mid-dispatch at once

    # -- handles / backends --------------------------------------------------

    def handle(self, scheme, public_key_bytes: bytes, device: bool = True,
               backend=None, fallback=None, backend_factory=None,
               pool_backend=None) -> VerifyHandle:
        """The per-chain submit surface.  `device=False` selects the
        `HostBatchVerifier` fallback behind the same API; `device=True` on
        a pool with no device raises (see the module doc); `backend=`
        injects a custom verifier (tests) and `fallback=` its failover
        target.  A device handle fails over to the host only through
        `fallback=` (see the module doc).

        The handle is assigned a DEVICE GROUP from the service's pool
        (sticky least-loaded — chain→device affinity) and dispatches on
        that group's own scheduler stream; `backend_factory` (a callable
        `group -> backend`) makes an injected backend group-backed, so
        it participates in group→sibling failover like a real device
        backend; `pool_backend` injects the pool-wide sharded backend
        huge batches route to (tests — device handles build their own).

        The handle's coalescing pad and dispatch-pipeline depth are
        resolved HERE through crypto/tuning.py for ITS GROUP SIZE
        (explicit ctor values pin; env overrides beat TUNING.json; no
        file + no env = 8192x1 — a 1-device and a 4-device group never
        share a winner)."""
        pk = bytes(public_key_bytes)
        if backend is not None or backend_factory is not None:
            kind = "custom"
        elif device:
            if not self._device_available():
                raise RuntimeError(
                    "no device for a device handle: this process sees no "
                    "CUDA device; build the service with "
                    "pool=DevicePool(devices=[torch.device(\"cpu\")]) to run "
                    "device handles on the CPU, or ask for device=False")
            kind = "device"
        else:
            kind = "host"
        key = (scheme.id, pk, kind,
               id(backend) if backend is not None
               else id(backend_factory) if backend_factory is not None
               else 0)
        with self._cond:
            h = self._handles.get(key)
        if h is not None:
            return h
        pool = self._get_pool()
        # tenant-aware placement: the registry maps the chain
        # public key to its tenant's weight / group pin / anti-affinity;
        # no registry (or an unknown chain) keeps the pre-tenancy
        # least-loaded behavior exactly
        tenant, hints = None, {}
        if self._tenancy is not None:
            try:
                p = self._tenancy.placement_for_pk(pk)
                tenant = p.get("tenant")
                hints = {"tenant": tenant,
                         "weight": p.get("weight", 1.0),
                         "pin": p.get("pin"),
                         "anti_affinity": p.get("anti_affinity", False)}
            except Exception:
                tenant, hints = None, {}
        # host handles get a stream but no placement weight: they never
        # dispatch on the group's devices, and counting them would push
        # real device chains off otherwise-empty groups
        group = pool.assign(key, weigh=(kind != "host"), **hints)
        pad, depth = self._tuned(scheme, max(1, group.n_devices))
        factory = backend_factory
        if backend is None and factory is None and kind == "device":
            def factory(g, s=scheme, p=pk):
                from .batch import BatchBeaconVerifier, h2f_device_default
                fpad, _ = self._tuned(s, max(1, g.n_devices))
                # always placed on the group's devices (the group's
                # placement is built once, DeviceGroup.sharding): the
                # port's verifier has no default device to fall back on,
                # and a CPU pool's group must stay on the CPU.  The hash
                # front is fixed per handle: at/above
                # DRAND_H2F_DEVICE_MIN_N the pack path ships message words
                # and H1 runs inside the dispatch
                return BatchBeaconVerifier(
                    s, p, pad_to=fpad, sharding=g.sharding(),
                    h2f_device=h2f_device_default(fpad))
        if backend is None:
            if factory is not None:
                backend = factory(group)
            else:               # kind == "host": the jax-free fallback
                from .hostverify import HostBatchVerifier
                backend = HostBatchVerifier(scheme, pk)
        h = VerifyHandle(self, key, scheme, backend)
        # a device handle fails over to the host only where the caller
        # passes `fallback=`: without one its device errors reach the
        # callers' futures (host handles have nowhere to go)
        fallback_factory = None if fallback is None \
            else lambda fb=fallback: fb  # noqa: E731
        slot = _BackendSlot(key, f"{scheme.id}:{pk[:4].hex()}", backend,
                            fallback_factory, pad=pad, depth=depth,
                            scheme=scheme, pk=pk, kind=kind,
                            gid=group.gid, group_size=group.n_devices,
                            backend_factory=factory, tenant=tenant)
        if pool_backend is not None:
            slot.pool_backend = pool_backend
            slot.pool_pad = getattr(pool_backend, "pad_to", 0) \
                or pad * max(2, pool.n_devices)
        with self._cond:
            # two racing builders: first insert wins, both see one handle
            h = self._handles.setdefault(key, h)
            slot = self._slots.setdefault(key, slot)
        self._set_state_gauge(slot)
        return h

    def release_handle(self, handle: VerifyHandle) -> None:
        """Drop a handle (multi-tenant churn): its slot and device-group
        assignment are released, so the pool rebalances the next handle
        into the freed group.  Still-queued requests for the key resolve
        against the backend captured at submit time."""
        with self._cond:
            self._handles.pop(handle.key, None)
            slot = self._slots.pop(handle.key, None)
        if self._pool is not None:
            self._pool.release(handle.key)
        if slot is not None:
            from ..metrics import verify_backend_state
            try:
                verify_backend_state.remove(slot.label, str(slot.gid))
            except KeyError:
                pass

    def set_tenancy(self, tenancy) -> None:
        """Install the tenant registry (core/tenancy.py): new handles
        place by tenant weight/pin/anti-affinity, and every device
        dispatch attributes its measured device time to the chain's
        tenant.  Config wires registry changes to `rebalance_tenants`."""
        with self._cond:
            self._tenancy = tenancy

    def rebalance_tenants(self) -> int:
        """Re-apply tenant placement after a registry change (tenant
        add/update/remove, or a reshare swapping chains between
        tenants): slots whose tenant's PIN now names a different group
        move there (backend rebuilt on the target group's devices, the
        _migrate discipline); slots whose tenant label changed just
        re-label (sticky affinity — an unpinned chain is never shuffled,
        churn rebalances it naturally).  Returns the number of slots
        moved."""
        tenancy = self._tenancy
        pool = self._pool
        if tenancy is None or pool is None:
            return 0
        with self._cond:
            if self._stopped:
                return 0
            slots = list(self._slots.values())
        moved = 0
        for slot in slots:
            try:
                p = tenancy.placement_for_pk(slot.pk)
            except Exception:
                continue
            tenant, pin = p.get("tenant"), p.get("pin")
            with self._cond:
                slot.tenant = tenant
            if pin is None or not (0 <= pin < pool.n_groups) \
                    or pin == slot.gid:
                continue
            if self._retarget(slot, pool.group(pin)):
                moved += 1
        if moved:
            with self._cond:
                self._tenant_rebalances += moved
        return moved

    def _retarget(self, slot: _BackendSlot, group) -> bool:
        """Move one GROUP-BACKED slot's affinity and primary backend to
        a specific group — the policy-driven sibling of `_migrate`.
        Slots with no backend factory (explicit `backend=` injections,
        host fallbacks) are never moved: their backend would keep
        executing wherever it was built, so moving only the gid/stream
        would charge the pinned group for work running elsewhere —
        placement accounting must never lie.  A failed rebuild leaves
        the slot untouched."""
        if slot.backend_factory is None:
            return False
        old_gid = slot.gid
        try:
            new_backend = slot.backend_factory(group)
        except BaseException:
            return False
        pad, depth = self._tuned(slot.scheme, max(1, group.n_devices)) \
            if slot.scheme is not None else (slot.pad, slot.depth)
        with self._cond:
            slot.primary = new_backend
            slot.gid = group.gid
            slot.group_size = group.n_devices
            slot.pad, slot.depth = pad, depth
        self._pool.place(slot.key, group.gid)
        self._set_state_gauge(slot, old_gid=old_gid)
        return True

    def _get_pool(self):
        """The service-owned DevicePool, built on first handle (device
        enumeration is lazy and process-cached in device_pool)."""
        pool = self._pool
        if pool is not None:
            return pool
        from .device_pool import DevicePool
        built = DevicePool(n_groups=self.device_groups)
        with self._cond:
            if self._pool is None:
                self._pool = built
            pool = self._pool
        from ..metrics import verify_group_devices
        for g in pool.groups:
            verify_group_devices.labels(str(g.gid)).set(g.n_devices)
        return pool

    def partials_factory(self, inner_factory: Callable,
                         fallback_factory: Optional[Callable] = None
                         ) -> Callable:
        """Wrap a partial-verifier factory (beacon.node.device_verifier_
        factory or _host_verifier_factory) so aggregation-time partial
        verification runs on the service thread in the LIVE lane.  A
        `fallback_factory` (same signature) provides the host path a
        failed device partial-verify falls back to — live partials must
        survive device loss without costing the round."""
        def factory(scheme, pub_poly, n_nodes):
            fb = None
            if fallback_factory is not None:
                fb = lambda: fallback_factory(scheme, pub_poly, n_nodes)  # noqa: E731,E501
            return _PartialLaneVerifier(
                self, inner_factory(scheme, pub_poly, n_nodes), fb)
        return factory

    def _device_available(self) -> bool:
        """True when the service's pool has a device: a CUDA card, or the
        explicit devices it was built with (the CPU included)."""
        return self._get_pool().n_devices > 0

    def _platform(self) -> str:
        """The tuning platform: "cuda" for a pool with a card, else
        "cpu"."""
        pool = self._pool
        devs = pool.devices if pool is not None else []
        return "cuda" if any(getattr(d, "type", None) == "cuda"
                             for d in devs) else "cpu"

    def _tuned(self, scheme, group_size: int = 1):
        """(pad, depth) for a new handle: explicit ctor overrides pin;
        otherwise env > TUNING.json (current platform + scheme kind AT
        THIS GROUP SIZE — `kind@n` entries beat the bare-kind fallback,
        so a 1-device and a 4-device group resolve independently) > the
        8192x1 defaults.  Platform detection is skipped when nothing
        could override anyway."""
        from . import tuning
        if self.pad_override and self.depth_override:
            return self.pad_override, self.depth_override
        sig_group = getattr(scheme, "sig_group", None)
        kind = "g2" if getattr(sig_group, "__name__", "") == "GroupG2" \
            else "g1"
        consult = tuning.tuning_path() is not None \
            or os.environ.get("DRAND_VERIFY_PAD") \
            or os.environ.get("DRAND_VERIFY_PIPELINE_DEPTH")
        platform = self._platform() if consult else "cpu"
        pad, depth, _src = tuning.resolve(
            kind, platform, pad=self.pad_override or None,
            depth=self.depth_override or None, group_size=group_size)
        return pad, depth

    def _pad_of(self, key) -> int:
        """Coalescing width for a handle key (caller holds the lock or
        accepts a benign race on an immutable slot field)."""
        slot = self._slots.get(key)
        if slot is not None:
            return slot.pad
        return self.pad_override or DEFAULT_PAD

    # -- huge-batch round-axis sharding ---------------------------------------

    def _shard_threshold_for(self, slot: _BackendSlot) -> int:
        """Rounds per single submission at or above which the pool-wide
        sharded backend serves it instead of the handle's group."""
        if self.shard_threshold:
            return self.shard_threshold
        pool = self._pool
        n = pool.n_devices if pool is not None else 1
        return slot.pad * max(2, n)

    def _ensure_pool_backend(self, slot: _BackendSlot) -> bool:
        """Build (once) the slot's pool-wide sharded backend: the same
        scheme/pubkey at pad x n_devices over the pool's ONE round-axis
        placement (its RLC passes split over every device).  False when
        sharding cannot help (single device, non-device slot with no
        injected pool backend, or a previous pool fault)."""
        if not slot.pool_ok:
            # a pool fault disables sharding with a probe-cadence
            # cooldown, not forever: a transient collective error during
            # one catch-up sync must not pin every later huge batch to a
            # single group for the process lifetime (a second fault
            # re-arms the cooldown)
            if slot.pool_retry_at is None \
                    or self.clock.monotonic() < slot.pool_retry_at:
                return False
            with self._cond:
                slot.pool_ok = True
                slot.pool_retry_at = None
        if slot.pool_backend is not None:
            return True
        if slot.kind != "device":
            return False
        pool = self._pool
        if pool is None:
            return False
        sharding = pool.pool_sharding()
        if sharding is None:
            return False
        from .batch import BatchBeaconVerifier, h2f_device_default
        pool_pad = slot.pad * pool.n_devices
        pb = BatchBeaconVerifier(slot.scheme, slot.pk, pad_to=pool_pad,
                                 sharding=sharding,
                                 h2f_device=h2f_device_default(pool_pad))
        with self._cond:
            if slot.pool_backend is None:
                slot.pool_backend = pb
                slot.pool_pad = pool_pad
        return True

    # -- submission ----------------------------------------------------------

    def submit(self, handle: VerifyHandle, rounds, sigs, prev_sigs=None,
               lane: str = LANE_BACKGROUND,
               flush_now: bool = False) -> VerifyFuture:
        if lane not in LANES:
            raise ValueError(f"unknown lane {lane!r}")
        fut = VerifyFuture()
        n = len(rounds)
        if n == 0:
            fut.set_result(np.zeros(0, dtype=bool))
            return fut
        # huge single submissions (catch-up sync, integrity scans, the
        # strict-walk sweep) shard over the FULL pool instead of this
        # handle's one group; a sharded batch is dispatch-ready by
        # construction (it already dwarfs the pad)
        sharded = False
        slot = self._slots.get(handle.key)
        if slot is not None and slot.state == STATE_HEALTHY \
                and n >= self._shard_threshold_for(slot):
            sharded = self._ensure_pool_backend(slot)
        req = _Request("batch", lane, fut, self.clock.monotonic(),
                       key=handle.key, backend=handle.backend,
                       rounds=list(rounds), sigs=list(sigs),
                       prevs=list(prev_sigs) if prev_sigs is not None
                       else [None] * n, flush=flush_now or sharded,
                       sharded=sharded)
        self._enqueue(req)
        return fut

    def submit_call(self, fn: Callable, lane: str = LANE_LIVE) -> VerifyFuture:
        """Opaque device work (e.g. a partial-aggregation RLC block) that
        participates in the lanes, preemption and the watchdog but not
        the coalescer."""
        fut = VerifyFuture()
        req = _Request("call", lane, fut, self.clock.monotonic(), fn=fn)
        self._enqueue(req)
        return fut

    def _enqueue(self, req: _Request) -> None:
        from ..metrics import verify_queue_depth, verify_requests
        with self._cond:
            if self._stopped:
                req.future.set_exception(
                    RuntimeError("verify service stopped"))
                return
            stream = self._stream_locked(self._gid_for_locked(req))
            stream.queues[req.lane].append(req)
            self._submitted += 1
            verify_requests.labels(req.lane).inc()
            verify_queue_depth.labels(req.lane).set(
                self._qdepth_locked(req.lane))
            self._ensure_threads_locked(stream)
            self._cond.notify_all()

    def _gid_for_locked(self, req: _Request) -> int:
        """The device group (= dispatch stream) a request rides: its
        handle's slot affinity for batches (so same-chain work always
        shares one stream and coalesces), round-robin over the pool for
        opaque calls (live partial blocks spread across the k streams).
        Caller holds the lock."""
        if req.key is not None:
            slot = self._slots.get(req.key)
            if slot is not None:
                return slot.gid
            return 0
        pool = self._pool
        n = pool.n_groups if pool is not None else 1
        self._call_rr = (self._call_rr + 1) % max(1, n)
        return self._call_rr

    def _stream_locked(self, gid: int) -> _GroupStream:
        st = self._streams.get(gid)
        if st is None:
            st = self._streams[gid] = _GroupStream(gid)
        return st

    def _qdepth_locked(self, lane: str) -> int:
        return sum(len(st.queues[lane]) for st in self._streams.values())

    def _ensure_threads_locked(self, stream: _GroupStream) -> None:
        """Caller holds the lock.  Each group's scheduler starts on its
        first work; the one watchdog starts with the first of them.
        Either may be replaced later (a wedged dispatch abandons its
        thread, see `_trip`)."""
        if stream.thread is None:
            stream.thread = threading.Thread(
                target=self._run, args=(stream,), daemon=True,
                name=f"verify-scheduler-g{stream.gid}")
            stream.thread.start()
        if self._watchdog_thread is None:
            self._watchdog_thread = threading.Thread(
                target=self._watchdog_run, daemon=True,
                name="verify-watchdog")
            self._watchdog_thread.start()

    def _requeue(self, requests: List[_Request]) -> None:
        """Put requests back at the FRONT of their lanes (flush-ready, so
        failover redispatch does not wait out a coalescing window).  The
        stream is re-resolved per request — after a group→sibling
        failover the slot's new group serves the redispatch.  The
        failover contract: requeued, not failed."""
        from ..metrics import verify_queue_depth
        drained = []
        with self._cond:
            if self._stopped:
                drained = list(requests)
            else:
                for r in reversed(requests):
                    r.flush = True
                    stream = self._stream_locked(self._gid_for_locked(r))
                    stream.queues[r.lane].appendleft(r)
                    self._ensure_threads_locked(stream)
                for lane in LANES:
                    verify_queue_depth.labels(lane).set(
                        self._qdepth_locked(lane))
            self._cond.notify_all()
        for r in drained:
            if not r.future.done():
                r.future.set_exception(RuntimeError("verify service stopped"))

    # -- scheduler -----------------------------------------------------------

    def _run(self, stream: _GroupStream) -> None:
        me = threading.current_thread()
        while True:
            with self._cond:
                # a watchdog trip may have replaced this thread while it
                # was wedged in a device call — the queue is no longer ours
                if stream.thread is not me:
                    return
            batch = self._next_batch(stream)
            if batch is None:
                return
            self._execute(batch)

    # Real-seconds ceiling on coalescing waits: the window runs on the
    # injected clock (deterministic under FakeClock), but a daemon wired
    # to a clock that never advances must not hold verification hostage —
    # after this much accumulated real cv-wait the batch flushes anyway.
    REAL_FLUSH_CAP = 5.0

    def _next_batch(self, stream: _GroupStream) -> Optional[_Batch]:
        """Block until a batch is ready on THIS group's stream: live work
        flushes immediately, background work may wait out its coalescing
        window to fill.  The whole lane queue is scanned, not just its
        head — one chain's unexpired window must not head-of-line-block
        another chain's dispatch-ready batch (multi-beacon daemons share
        one service, and several chains can share one group)."""
        waited = 0.0        # accumulated real cv-wait towards the cap
        with self._cond:
            while True:
                if self._stopped \
                        or stream.thread is not threading.current_thread():
                    return None
                if stream.queues[LANE_LIVE]:
                    lane = LANE_LIVE
                elif stream.queues[LANE_BACKGROUND] and not self._bg_paused:
                    lane = LANE_BACKGROUND
                else:
                    self._cond.wait(0.1)
                    waited = 0.0
                    continue
                chosen, next_flush = self._pick_ready_locked(stream, lane,
                                                             waited)
                if chosen is None:
                    # every queued chain is inside its window and under
                    # pad: cv-wait until the earliest flush deadline, with
                    # a real-time bound so a FakeClock advance is observed
                    # promptly; only an actual timeout counts toward the
                    # frozen-clock flush cap
                    step = min(max(next_flush - self.clock.monotonic(),
                                   0.001), 0.05)
                    if not self._cond.wait(step):
                        waited += step
                    continue
                return self._gather_locked(stream, lane, chosen)

    def _pick_ready_locked(self, stream: _GroupStream, lane: str,
                           waited: float):
        """First dispatch-ready request in `lane` FIFO order, plus the
        earliest flush deadline when none is ready.  Ready = an opaque
        call, a chain whose coalesced fill reaches the pad, an expired
        window, or the accumulated real-wait cap.  Caller holds the lock."""
        window = self.windows[lane]
        now = self.clock.monotonic()
        fills: Dict[Tuple, int] = {}
        for ln in LANES:
            for r in stream.queues[ln]:
                if r.kind == "batch":
                    fills[r.key] = fills.get(r.key, 0) + r.n
        next_flush = None
        for r in stream.queues[lane]:
            if r.kind == "call" or r.flush or window <= 0 \
                    or fills[r.key] >= self._pad_of(r.key) \
                    or now >= r.enqueued + window \
                    or waited >= self.REAL_FLUSH_CAP:
                return r, None
            flush_at = r.enqueued + window
            if next_flush is None or flush_at < next_flush:
                next_flush = flush_at
        return None, next_flush

    def _try_next(self, stream: _GroupStream,
                  lane: str) -> Optional[_Batch]:
        """Non-blocking, no window: the preemption path's grab."""
        with self._cond:
            if self._stopped or not stream.queues[lane]:
                return None
            return self._gather_locked(stream, lane,
                                       stream.queues[lane][0])

    def _gather_locked(self, stream: _GroupStream, lane: str,
                       head: _Request) -> _Batch:
        """Pop `head` plus every same-chain batch request from BOTH lanes
        of this stream (they ride the same dispatch for free; sharded and
        unsharded requests never merge — different backend and span).
        The backend is resolved HERE, at dispatch time, through the key's
        failover slot — a degraded chain's requeued requests land on the
        host fallback, a re-promoted one back on the device, a sharded
        batch on the pool-wide backend.  Caller-holds-lock helper: every
        call site sits inside `with self._cond` (same shape as
        sqlitedb._fill_previous).
        """
        from ..metrics import verify_queue_depth
        if head.kind == "call":
            stream.queues[lane].remove(head)
            verify_queue_depth.labels(lane).set(self._qdepth_locked(lane))
            return _Batch(lane, call=head, stream=stream)
        requests = []
        for drain_lane in (lane,) + tuple(l for l in LANES if l != lane):
            keep: deque = deque()
            for r in stream.queues[drain_lane]:
                if r is head or (r.kind == "batch" and r.key == head.key
                                 and r.sharded == head.sharded):
                    requests.append(r)
                else:
                    keep.append(r)
            stream.queues[drain_lane] = keep
            verify_queue_depth.labels(drain_lane).set(self._qdepth_locked(drain_lane))
        slot = self._slots.get(head.key)
        if head.sharded and slot is not None \
                and slot.pool_backend is not None:
            backend = slot.pool_backend
        else:
            backend = slot.active() if slot is not None else head.backend
        return _Batch(lane, backend=backend, requests=requests,
                      key=head.key, slot=slot, stream=stream,
                      sharded=head.sharded)

    # -- execution (service thread, outside the lock) -------------------------

    def _execute(self, batch: _Batch) -> None:
        """Run one batch, tracking how many group streams are mid-dispatch
        at once — `concurrent_streams_max` is the scale-out proof (k
        groups really do run k overlapping windows, not take turns)."""
        stream = batch.stream
        if stream is not None:
            with self._cond:
                stream.active += 1
                busy = sum(1 for s in self._streams.values() if s.active)
                if busy > self._concurrent_max:
                    self._concurrent_max = busy
        try:
            self._execute_inner(batch)
        finally:
            if stream is not None:
                with self._cond:
                    stream.active -= 1

    def _execute_inner(self, batch: _Batch) -> None:
        if batch.call is not None:
            self._execute_call(batch)
            return
        # queue-time half of the dispatch_latency split: how long the
        # OLDEST rider waited between submit and the device seeing work
        # (coalescing window + lane contention; the device half is
        # observed per chunk in _account)
        queued = min((r.enqueued for r in batch.requests),
                     default=self.clock.monotonic())
        self._account_queue(batch.lane,
                            self.clock.monotonic() - queued)
        try:
            results, errors = self._run_chunks(batch)
        except _Abandoned:
            return      # watchdog took this batch over; futures are not ours
        except _Requeued:
            return      # failover requeued every request; a later dispatch
                        # on the fallback backend resolves the futures
        except BaseException as e:
            # belt and braces — chunk errors are contained below, so only
            # bookkeeping bugs land here; never leave a future pending
            for r in batch.requests:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        # fan the verdict array back out, one contiguous slice per caller;
        # a failed chunk's exception reaches ONLY the requests whose span
        # overlaps it — other callers coalesced into the same dispatch get
        # their verdicts (one poisoned chunk must not fail every rider's
        # future)
        off = 0
        for r in batch.requests:
            exc = next((err for lo, hi, err in errors
                        if lo < off + r.n and off < hi), None)
            if not r.future.done():
                if exc is not None:
                    r.future.set_exception(exc)
                else:
                    r.future.set_result(results[off:off + r.n].copy())
            off += r.n

    def _execute_call(self, batch: _Batch) -> None:
        req = batch.call
        t0 = self.clock.monotonic()
        try:
            out = self._guarded(None, batch, req.fn, kind="call")
        except _Abandoned:
            return
        except BaseException:
            try:        # opaque device work gets the same one retry
                out = self._guarded(None, batch, req.fn, kind="call")
            except _Abandoned:
                return
            except BaseException as e2:
                req.future.set_exception(e2)
                self._account(batch.lane, 1, 1,
                              self.clock.monotonic() - t0, gid=batch.gid)
                return
        req.future.set_result(out)
        self._account(batch.lane, 1, 1, self.clock.monotonic() - t0,
                      gid=batch.gid)

    def _run_chunks(self, batch: _Batch):
        rounds: List = []
        sigs: List = []
        prevs: List = []
        for r in batch.requests:
            rounds.extend(r.rounds)
            sigs.extend(r.sigs)
            prevs.extend(r.prevs)
        n = len(rounds)
        # sharded batches chunk at the pool-wide span (pad x n_devices):
        # each device sees a pad-sized shard of every chunk
        if batch.sharded and batch.slot is not None \
                and batch.slot.pool_pad:
            pad = batch.slot.pool_pad
        else:
            pad = self._pad_of(batch.key)
        spans = [(lo, min(lo + pad, n)) for lo in range(0, n, pad)]
        results = np.zeros(n, dtype=bool)
        errors: List[Tuple[int, int, BaseException]] = []
        backend = batch.backend
        slot = batch.slot
        if hasattr(backend, "pack_chunk"):
            self._run_pipelined(batch, slot, backend, rounds, sigs, prevs,
                                spans, pad, results, errors)
        else:
            for lo, hi in spans:
                self._maybe_preempt(batch)
                t0 = self.clock.monotonic()
                try:
                    results[lo:hi] = self._chunk_call(
                        slot, batch,
                        lambda lo=lo, hi=hi: self._call_verify(
                            backend, rounds[lo:hi], sigs[lo:hi],
                            prevs[lo:hi]))
                except (_Abandoned, _Requeued):
                    raise
                except BaseException as e:
                    errors.append((lo, hi, e))
                    continue
                self._account(batch.lane, hi - lo, hi - lo,
                              self.clock.monotonic() - t0, slot=slot,
                              gid=batch.gid, sharded=batch.sharded)
                if getattr(backend, "kind", "host") == "host":
                    self._note_host_served()
                self._stash_sample(slot, rounds, sigs, prevs, results, lo)
        return results, errors

    # host packing is in-process numpy — minutes of silence there means the
    # process is wedged, not slow; bound it so the wait can't be forever
    PACK_TIMEOUT = 600.0

    def _run_pipelined(self, batch, slot, backend, rounds, sigs, prevs,
                       spans, span_pad, results, errors) -> None:
        """Device path: host packing of chunk k+1 overlaps device compute
        of chunk k, generalized to a DEPTH-K in-flight window:
        up to `depth` dispatches stay enqueued ahead of the resolve point
        so the per-dispatch RPC latency amortizes across the window
        instead of being paid serially per chunk.  Preemption checks stay
        at chunk boundaries; per-chunk errors stay contained.  The
        watchdog deadline of each resolve is scaled by the number of
        dispatches sharing the device (deadline on the oldest in-flight
        work, not each dispatch independently)."""
        from ..metrics import verify_inflight
        packer = self._ensure_packer(batch.stream)
        pad_width = max(span_pad, getattr(backend, "pad_to", 0) or 0)
        depth = max(1, slot.depth if slot is not None else 1)
        if hasattr(backend, "pipeline_depth"):
            # the backend clamps by per-chunk footprint: depth x chunk
            # bytes must stay under the in-flight budget (VMEM safety)
            depth = backend.pipeline_depth(depth, pad_width)

        def pack(lo, hi):
            # the pack term of the pack|queue|device latency split: host
            # wall time spent building the chunk encoding (numpy wire
            # parse + message packing; with device h2f there is no host
            # hashing left in here) — observed per chunk, overlapped
            # with device compute by construction
            t0 = self.clock.monotonic()
            packed = backend.pack_chunk(
                rounds[lo:hi], sigs[lo:hi], prevs[lo:hi])
            self._account_pack(batch.lane, self.clock.monotonic() - t0)
            return lo, hi, packed

        def dispatch(item):
            lo, hi, packed = item
            t0 = self.clock.monotonic()
            d = self._chunk_call(slot, batch,
                                 lambda: backend.dispatch_packed(packed))
            return lo, hi, packed, d, t0

        # Per-chunk device time must be the NON-OVERLAPPED interval: under
        # depth-k a chunk's dispatch->verdict wall time includes the k-1
        # predecessors it queued behind, which would inflate the p99 the
        # watchdog scales by the window (k^2 deadlines) and make
        # device_time_s exceed wall clock.  Attribute to each resolve only
        # the time since the later of its own dispatch and the previous
        # resolve — the samples sum to wall time and approximate true
        # per-chunk device time once the pipeline is full.
        last_resolved = [None]

        def resolve(item, window):
            lo, hi, packed, verdict, t0 = item
            results[lo:hi] = self._chunk_call(
                slot, batch, lambda: self._validated(
                    backend.resolve_packed(packed, verdict), hi - lo),
                scale=window)
            end = self.clock.monotonic()
            start = t0 if last_resolved[0] is None \
                else max(t0, last_resolved[0])
            last_resolved[0] = end
            self._account(batch.lane, hi - lo, pad_width, end - start,
                          slot=slot, gid=batch.gid, sharded=batch.sharded)
            self._stash_sample(slot, rounds, sigs, prevs, results, lo)

        inflight: deque = deque()

        def note_depth():
            d = len(inflight)
            verify_inflight.set(d)
            with self._cond:
                if d > self._inflight_max:
                    self._inflight_max = d
                if batch.stream is not None \
                        and d > batch.stream.inflight_max:
                    batch.stream.inflight_max = d

        def advance(p):
            fut, lo, hi = p
            try:
                inflight.append(dispatch(fut.result(self.PACK_TIMEOUT)))
                note_depth()
            except (_Abandoned, _Requeued):
                raise
            except BaseException as e:
                errors.append((lo, hi, e))

        def drain_one():
            window = len(inflight)
            item = inflight.popleft()
            lo, hi = item[0], item[1]
            try:
                resolve(item, window)
            except (_Abandoned, _Requeued):
                raise
            except BaseException as e:
                errors.append((lo, hi, e))

        try:
            pending = None
            for lo, hi in spans:
                self._maybe_preempt(batch)
                nxt = (packer.submit(pack, lo, hi), lo, hi)
                if pending is not None:
                    advance(pending)
                    while len(inflight) > depth:
                        drain_one()
                pending = nxt
            if pending is not None:
                self._maybe_preempt(batch)
                advance(pending)
            while inflight:
                drain_one()
        finally:
            verify_inflight.set(0)

    @staticmethod
    def _call_verify(backend, rounds, sigs, prevs) -> np.ndarray:
        """verify_batch with the verdict validated: a poisoned device that
        answers with the wrong shape (or something that is not a bool
        array at all) is a backend FAULT, not a caller error."""
        out = np.asarray(backend.verify_batch(rounds, sigs, prevs),
                         dtype=bool)
        return VerifyService._validated(out, len(rounds))

    @staticmethod
    def _validated(out, n: int) -> np.ndarray:
        arr = np.asarray(out, dtype=bool)
        if arr.shape != (n,):
            raise DeviceFailure(
                f"backend returned verdict shape {arr.shape}, want ({n},)")
        return arr

    # -- the failure domain ---------------------------------------------------

    def _deadline_for(self, slot: Optional[_BackendSlot],
                      scale: int = 1) -> float:
        """Watchdog deadline: a generous multiple of this slot's observed
        p99 dispatch latency, floored for cold compiles; opaque calls
        (no slot) get the floor.  `scale` is the number of in-flight
        dispatches sharing the device under depth-k pipelining: the
        deadline budget covers the whole window on its OLDEST ticket
        (scaling the p99 term, never the cold-compile floor)."""
        with self._cond:
            lat = sorted(slot.latencies) if slot is not None else []
        if lat:
            p99 = lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))]
            return max(self.watchdog_floor,
                       self.watchdog_factor * p99 * max(1, scale))
        return self.watchdog_floor

    def _guarded(self, slot: Optional[_BackendSlot], batch: _Batch, fn,
                 kind: str = "chunk", scale: int = 1):
        """Run one backend call under watchdog supervision.  The dispatch
        path only registers/deregisters a ticket (O(1) under the lock the
        scheduler already takes); deadline enforcement lives entirely on
        the watchdog thread."""
        deadline = self._deadline_for(slot, scale)
        with self._cond:
            started = self.clock.monotonic()
            ticket = _Ticket(slot, batch, kind, started, started + deadline)
            self._tickets[id(ticket)] = ticket
            self._cond.notify_all()     # the watchdog re-arms on new work
        err = None
        out = None
        try:
            out = fn()
        except BaseException as e:
            err = e
        cleared = None
        with self._cond:
            self._tickets.pop(id(ticket), None)
            self._rebase_slot_tickets_locked(slot, self.clock.monotonic())
            cancelled = ticket.cancelled
            if err is None and not cancelled and kind == "chunk" \
                    and slot is not None and slot.state == STATE_SUSPECT:
                # a successful dispatch clears the strike
                slot.state = STATE_HEALTHY
                cleared = slot
        if cleared is not None:
            self._set_state_gauge(cleared)
        if cancelled:
            raise _Abandoned()
        if err is not None:
            raise err
        return out

    def _rebase_slot_tickets_locked(self, slot, now: float) -> None:
        """A slot ticket retired (success or trip): the survivors were
        queued BEHIND it on the shared device, so their deadlines restart
        from their own budget now that they can make progress.  Caller
        holds the lock."""
        if slot is None:
            return
        for t in self._tickets.values():
            if t.slot is slot and not t.cancelled:
                t.deadline_at = max(t.deadline_at, now + t.budget)

    def _chunk_call(self, slot: Optional[_BackendSlot], batch: _Batch, fn,
                    scale: int = 1):
        """One chunk dispatch with the failover ladder: first failure on
        the primary backend marks it suspect and retries ONCE; a second
        failure takes the group→sibling→host order — the slot's device
        group is marked FAULTED, the backend is rebuilt on a healthy
        sibling group when one exists (`_migrate`), else the slot
        degrades to the host fallback — and every request of the batch
        is requeued.  A pool-wide SHARDED dispatch that faults twice
        falls back to unsharded dispatch on the slot's own group
        (`_unshard`) instead.  Chunks on non-failover backends (host,
        custom-without-fallback, or already-degraded) raise through —
        the caller contains the error to that chunk."""
        try:
            return self._guarded(slot, batch, fn, scale=scale)
        except _Abandoned:
            raise
        except BaseException:
            if slot is None:
                raise
            if batch.sharded and batch.backend is slot.pool_backend:
                try:
                    return self._guarded(slot, batch, fn, scale=scale)
                except _Abandoned:
                    raise
                except BaseException:
                    self._unshard(slot, batch)
                    raise _Requeued()
            if batch.backend is not slot.primary \
                    or not (slot.can_failover or self._migratable(slot)):
                raise
            self._note_fault(slot)
            self._note_suspect(slot)
            try:
                return self._guarded(slot, batch, fn, scale=scale)
            except _Abandoned:
                raise
            except BaseException as e2:
                self._group_fault(slot)
                if not self._migrate(slot):
                    if not slot.can_failover:
                        raise       # nowhere to go: the callers see it
                    self._degrade(slot, e2)
                self._requeue(batch.requests)
                raise _Requeued()

    def _migratable(self, slot: _BackendSlot) -> bool:
        """Group→sibling failover is possible for group-backed slots
        (device handles, or custom handles built via `backend_factory`)
        when the pool has more than one group."""
        return slot.backend_factory is not None and self._pool is not None \
            and self._pool.n_groups > 1

    def _group_fault(self, slot: _BackendSlot) -> None:
        """Mark the slot's device group FAULTED (its devices, not just
        this chain's backend, are the failure domain) and stash the
        faulting backend + its known-good sample as the group's canary
        context — `_probe_group` replays it to re-promote the group."""
        pool = self._pool
        if pool is None or slot.backend_factory is None:
            return      # not group-backed: nothing to quarantine
        from .device_pool import GROUP_FAULTED, GROUP_HEALTHY
        group = pool.group(slot.gid)
        with self._cond:
            if group.state == GROUP_HEALTHY:
                group.state = GROUP_FAULTED
                group.faulted_at = self.clock.monotonic()
                group.probe_backend = slot.primary
                group.probe_sample = slot.sample
        self._ensure_probe()

    def _migrate(self, slot: _BackendSlot) -> bool:
        """Group→sibling failover: rebuild the slot's primary backend on
        the least-loaded HEALTHY sibling group and move its affinity
        there.  The slot stays HEALTHY — the chain never saw the host
        path — and its (pad, depth) re-resolve for the new group size.
        False when no healthy sibling exists (the caller degrades to
        host) or the rebuild itself fails."""
        from ..metrics import verify_failovers
        if not self._migratable(slot):
            return False
        old_gid = slot.gid
        sibling = self._pool.reassign(slot.key)
        if sibling is None:
            return False
        try:
            new_backend = slot.backend_factory(sibling)
        except BaseException:
            # the rebuild failed: the backend still lives on the old
            # group — put the pool affinity back so loads/stats agree
            self._pool.place(slot.key, old_gid)
            return False
        pad, depth = self._tuned(slot.scheme, max(1, sibling.n_devices))
        with self._cond:
            slot.primary = new_backend
            slot.gid = sibling.gid
            slot.group_size = sibling.n_devices
            slot.pad, slot.depth = pad, depth
            slot.state = STATE_HEALTHY
            slot.first_fault_at = None
            slot.migrations += 1
            self._migrations += 1
        verify_failovers.labels(slot.label, "to_sibling").inc()
        self._set_state_gauge(slot, old_gid=old_gid)
        return True

    def _unshard(self, slot: _BackendSlot, batch: _Batch) -> None:
        """A pool-wide sharded dispatch faulted twice: disable sharding
        for this slot for one probe interval (re-promotion also
        re-enables it immediately) and requeue the riders unsharded on
        the slot's own group — requeued, never failed."""
        with self._cond:
            slot.pool_ok = False
            slot.pool_retry_at = self.clock.monotonic() \
                + self.probe_interval
            for r in batch.requests:
                r.sharded = False
        self._requeue(batch.requests)

    def _note_fault(self, slot: _BackendSlot) -> None:
        with self._cond:
            if slot.first_fault_at is None:
                slot.first_fault_at = self.clock.monotonic()

    def _note_suspect(self, slot: _BackendSlot) -> None:
        changed = False
        with self._cond:
            if slot.state == STATE_HEALTHY:
                slot.state = STATE_SUSPECT
                changed = True
        if changed:
            self._set_state_gauge(slot)

    def _degrade(self, slot: _BackendSlot, err: BaseException) -> None:
        """Atomic backend swap: build the fallback outside the lock, then
        flip the slot state; every dispatch gathered after this resolves
        to the fallback.  Idempotent — racing strikes degrade once."""
        from ..metrics import verify_failovers
        fb = None
        if slot.fallback is None and slot.fallback_factory is not None:
            fb = slot.fallback_factory()
        changed = False
        with self._cond:
            if slot.fallback is None and fb is not None:
                slot.fallback = fb
            if slot.state != STATE_DEGRADED:
                was_active = slot.state in (STATE_HEALTHY, STATE_SUSPECT)
                slot.state = STATE_DEGRADED
                if was_active:
                    slot.degraded_at = self.clock.monotonic()
                    slot.failovers += 1
                    self._failovers += 1
                    changed = True
        if changed:
            verify_failovers.labels(slot.label, "to_host").inc()
            self._set_state_gauge(slot)
        self._ensure_probe()

    def _promote(self, slot: _BackendSlot) -> None:
        from ..metrics import verify_failovers
        with self._cond:
            slot.state = STATE_HEALTHY
            slot.first_fault_at = None
            slot.pool_ok = True     # a healthy device re-earns sharding
            slot.pool_retry_at = None
            self._promotions += 1
        # the canary that promoted this slot ran on its group's devices —
        # the GROUP is proven healthy too (it degraded with no sibling
        # available, so the slot kept its original gid)
        pool = self._pool
        if pool is not None and slot.backend_factory is not None:
            from .device_pool import GROUP_HEALTHY
            group = pool.group(slot.gid)
            with self._cond:
                group.state = GROUP_HEALTHY
                group.probe_backend = group.probe_sample = None
        verify_failovers.labels(slot.label, "to_device").inc()
        self._set_state_gauge(slot)

    def _set_state_gauge(self, slot: _BackendSlot,
                         old_gid: Optional[int] = None) -> None:
        from ..metrics import verify_backend_state
        if old_gid is not None and old_gid != slot.gid:
            try:        # retire the migrated-away series
                verify_backend_state.remove(slot.label, str(old_gid))
            except KeyError:
                pass
        verify_backend_state.labels(slot.label, str(slot.gid)).set(
            _STATE_CODE[slot.state])

    # -- watchdog thread ------------------------------------------------------

    def _watchdog_run(self) -> None:
        me = threading.current_thread()
        while True:
            tripped = []
            with self._cond:
                if self._watchdog_thread is not me:
                    return
                if self._stopped and not self._tickets:
                    return
                now = self.clock.monotonic()
                # depth-k pipelining: tickets of the SAME slot share the
                # device, so only the oldest ticket per slot is eligible
                # to trip — its (scaled) deadline covers the whole
                # in-flight window; younger tickets are re-judged once
                # they become oldest.
                oldest: Dict[int, _Ticket] = {}
                for t in self._tickets.values():
                    if t.slot is None:
                        continue
                    cur = oldest.get(id(t.slot))
                    if cur is None or t.started < cur.started:
                        oldest[id(t.slot)] = t
                for tid, t in list(self._tickets.items()):
                    if t.slot is not None and oldest.get(id(t.slot)) is not t:
                        continue
                    if not t.cancelled and now >= t.deadline_at:
                        t.cancelled = True
                        del self._tickets[tid]
                        tripped.append(t)
                        self._rebase_slot_tickets_locked(t.slot, now)
                if not tripped:
                    # real-bounded poll so FakeClock advances are observed;
                    # idle (no tickets) polls more lazily
                    self._cond.wait(0.05 if self._tickets else 0.2)
                    continue
            for t in tripped:
                self._trip(t)

    def _trip(self, ticket: _Ticket) -> None:
        """A dispatch blew its deadline.  The executing thread is wedged
        inside native code and cannot be interrupted — abandon it (it
        discards its result via the cancelled ticket when/if it returns),
        hand its work back to the queue, and hand the queue to a fresh
        scheduler thread."""
        from ..metrics import verify_watchdog_trips
        slot, batch = ticket.slot, ticket.batch
        verify_watchdog_trips.labels(
            slot.label if slot is not None else "call").inc()
        with self._cond:
            self._watchdog_trips += 1
        if ticket.kind == "probe":
            # the probe thread itself is wedged: stay degraded, replace it
            with self._cond:
                if slot is not None and slot.state == STATE_PROBING:
                    slot.state = STATE_DEGRADED
                if self._pool is not None:
                    # a group canary hung mid-probe: the group stays out
                    from .device_pool import GROUP_FAULTED, GROUP_PROBING
                    for g in self._pool.groups:
                        if g.state == GROUP_PROBING:
                            g.state = GROUP_FAULTED
                self._probe_thread = None
            if slot is not None:
                self._set_state_gauge(slot)
            self._ensure_probe()
            return
        if batch.call is not None:
            req = batch.call
            if not req.retried:
                req.retried = True
                self._requeue([req])
            elif not req.future.done():
                req.future.set_exception(DeviceFailure(
                    "device call abandoned twice by the watchdog"))
            self._ensure_scheduler(batch.stream)
            return
        if batch.sharded and slot is not None \
                and batch.backend is slot.pool_backend:
            # a hung pool-wide dispatch: one retry sharded, then fall
            # back to unsharded dispatch on the slot's own group
            if batch.requests and not batch.requests[0].retried:
                for r in batch.requests:
                    r.retried = True
                self._requeue(batch.requests)
            else:
                self._unshard(slot, batch)
        elif slot is not None \
                and (slot.can_failover or self._migratable(slot)) \
                and batch.backend is slot.primary:
            self._note_fault(slot)
            with self._cond:
                first_strike = slot.state == STATE_HEALTHY
                if first_strike:
                    slot.state = STATE_SUSPECT
            self._set_state_gauge(slot)
            err = DeviceFailure(
                "device dispatch blew its watchdog deadline twice")
            if not first_strike:
                # second strike: the group is the failure domain — try a
                # healthy sibling before degrading to host
                self._group_fault(slot)
                if not self._migrate(slot):
                    if not slot.can_failover:
                        # no fallback: the callers see the device failure
                        for r in batch.requests:
                            if not r.future.done():
                                r.future.set_exception(err)
                        self._ensure_scheduler(batch.stream)
                        return
                    self._degrade(slot, err)
            # requeued, not failed — on the device once (the suspect
            # retry), on the sibling/fallback after the second strike
            self._requeue(batch.requests)
        else:
            if batch.requests and not batch.requests[0].retried:
                for r in batch.requests:
                    r.retried = True
                self._requeue(batch.requests)
            else:
                err = DeviceFailure(
                    "dispatch abandoned twice by the watchdog "
                    "(no fallback backend)")
                for r in batch.requests:
                    if not r.future.done():
                        r.future.set_exception(err)
        self._ensure_scheduler(batch.stream)

    def _ensure_scheduler(self, stream: Optional[_GroupStream]) -> None:
        """Replace a wedged group-stream scheduler thread (the tripped
        dispatch still owns the old one — it exits via the staleness
        check when the native call eventually returns)."""
        if stream is None:
            return
        with self._cond:
            if self._stopped:
                return
            if stream.thread is not threading.current_thread():
                stream.thread = threading.Thread(
                    target=self._run, args=(stream,), daemon=True,
                    name=f"verify-scheduler-g{stream.gid}")
                stream.thread.start()

    # -- canary probe ---------------------------------------------------------

    def _ensure_probe(self) -> None:
        with self._cond:
            if self._stopped:
                return
            if self._probe_thread is None or not self._probe_thread.is_alive():
                self._probe_thread = threading.Thread(
                    target=self._probe_run, daemon=True, name="verify-probe")
                self._probe_thread.start()

    # Real-seconds ceiling on the probe's coalesced clock wait, mirroring
    # REAL_FLUSH_CAP: a daemon on a frozen FakeClock must still get its
    # canary eventually.  The probe deliberately does NOT use
    # clock.wait_until — chaos clocks (AutoClock) advance fake time inside
    # wait_until, and a probe loop must observe scenario time, not drive it.
    PROBE_REAL_CAP = 60.0

    def _probe_wait(self, until: float) -> bool:
        """cv-wait until the injected clock reaches `until` (or the real
        cap), without ever advancing the clock itself.  False = stopped
        or this thread was replaced.  The cap measures real ELAPSED time
        (perf_counter delta) rather than counting timed-out waits — a
        busy service notifies the condition on every submit/dispatch, and
        those wakeups must not starve the canary on a frozen clock."""
        from time import perf_counter
        start = perf_counter()
        with self._cond:
            while not self._stopped \
                    and self._probe_thread is threading.current_thread():
                if self.clock.monotonic() >= until \
                        or perf_counter() - start >= self.PROBE_REAL_CAP:
                    return True
                self._cond.wait(0.05)
            return False

    def _probe_run(self) -> None:
        from .device_pool import GROUP_FAULTED
        me = threading.current_thread()
        while True:
            with self._cond:
                if self._stopped or self._probe_thread is not me:
                    return
                degraded = [s for s in self._slots.values()
                            if s.state == STATE_DEGRADED and s.can_failover]
                faulted = [g for g in (self._pool.groups
                                       if self._pool is not None else ())
                           if g.state == GROUP_FAULTED
                           and g.probe_backend is not None]
                if not degraded and not faulted:
                    self._probe_thread = None
                    return
            # rate-limited on the injected clock: one canary round per
            # interval, not a hot loop against a dead chip
            if not self._probe_wait(self.clock.monotonic()
                                    + self.probe_interval):
                return
            for slot in degraded:
                self._probe_slot(slot)
            for group in faulted:
                self._probe_group(group)

    def _probe_slot(self, slot: _BackendSlot) -> None:
        """One canary dispatch against the degraded PRIMARY backend.  The
        probe replays the last known-good 1-lane sample and demands the
        same verdict — a device that answers but answers WRONG (poisoned)
        stays degraded.  With no sample yet, any well-shaped answer
        counts.  The probe runs under the same watchdog as real work, so
        a probe that hangs is abandoned, not waited on."""
        from ..metrics import verify_probe_latency
        with self._cond:
            if self._stopped or slot.state != STATE_DEGRADED:
                return
            slot.state = STATE_PROBING
            sample = slot.sample
        self._set_state_gauge(slot)
        if sample is not None:
            rounds, sigs, prevs, want = sample
        else:
            rounds, sigs, prevs, want = [1], [b""], [None], None
        marker = _Batch(LANE_LIVE)      # ticket context only
        t0 = self.clock.monotonic()
        ok = False
        try:
            out = self._guarded(
                slot, marker,
                lambda: self._call_verify(slot.primary, rounds, sigs, prevs),
                kind="probe")
            ok = want is None or bool(out[0]) == want
        except _Abandoned:
            return      # the watchdog demoted us and replaced this thread
        except BaseException:
            ok = False
        verify_probe_latency.labels(slot.label).observe(
            max(0.0, self.clock.monotonic() - t0))
        if ok:
            self._promote(slot)
        else:
            with self._cond:
                if slot.state == STATE_PROBING:
                    slot.state = STATE_DEGRADED
            self._set_state_gauge(slot)

    def _probe_group(self, group) -> None:
        """One canary dispatch against a FAULTED device group, replayed
        on the backend that was serving there when it faulted (stashed by
        `_group_fault`) with the same verdict-parity bar as the slot
        probe.  Success returns the group to the assignment pool — its
        migrated chains stay where they landed (sticky affinity; new
        handles and churn rebalance into it), a poisoned group stays
        out."""
        from .device_pool import (GROUP_FAULTED, GROUP_HEALTHY,
                                  GROUP_PROBING)
        with self._cond:
            if self._stopped or group.state != GROUP_FAULTED:
                return
            group.state = GROUP_PROBING
            backend, sample = group.probe_backend, group.probe_sample
        if sample is not None:
            rounds, sigs, prevs, want = sample
        else:
            rounds, sigs, prevs, want = [1], [b""], [None], None
        marker = _Batch(LANE_LIVE)      # ticket context only
        ok = False
        try:
            out = self._guarded(
                None, marker,
                lambda: self._call_verify(backend, rounds, sigs, prevs),
                kind="probe")
            ok = want is None or bool(out[0]) == want
        except _Abandoned:
            return      # the watchdog reset us and replaced this thread
        except BaseException:
            ok = False
        with self._cond:
            if group.state != GROUP_PROBING:
                return
            group.state = GROUP_HEALTHY if ok else GROUP_FAULTED
            if ok:
                group.probe_backend = group.probe_sample = None
                group.faulted_at = None

    # -- preemption / packing -------------------------------------------------

    def _maybe_preempt(self, batch: _Batch) -> None:
        """At a chunk boundary of BACKGROUND work, run any queued LIVE
        work of THIS group's stream to completion first (other groups'
        live work runs on their own streams — no cross-group contention
        to yield to).  Live batches never preempt, so the recursion depth
        is bounded at two."""
        from ..metrics import verify_preemptions
        stream = batch.stream
        if batch.lane == LANE_LIVE or stream is None:
            return
        with self._cond:
            if stream.thread is not threading.current_thread():
                return      # stale (abandoned) executor: not our queue
            pending = bool(stream.queues[LANE_LIVE])
            if pending:
                self._preemptions += 1
        if not pending:
            return
        verify_preemptions.inc()
        while True:
            with self._cond:
                if stream.thread is not threading.current_thread():
                    return
            live = self._try_next(stream, LANE_LIVE)
            if live is None:
                return
            self._execute(live)

    def _ensure_packer(self, stream: Optional[_GroupStream]):
        """Per-stream packer: k groups pack k chunks concurrently (host
        packing is numpy + native hash-to-field, which release the GIL)."""
        if stream is None:
            with self._cond:
                stream = self._stream_locked(0)
        if stream.packer is None:
            from concurrent.futures import ThreadPoolExecutor
            stream.packer = ThreadPoolExecutor(
                max_workers=1,
                thread_name_prefix=f"verify-packer-g{stream.gid}")
        return stream.packer

    def _account(self, lane: str, lanes: int, slots: int,
                 elapsed: float, slot: Optional[_BackendSlot] = None,
                 gid: Optional[int] = None, sharded: bool = False) -> None:
        from ..metrics import (verify_dispatch_latency, verify_dispatches,
                               verify_fill_ratio)
        verify_dispatches.labels(lane, str(gid if gid is not None
                                           else 0)).inc()
        verify_fill_ratio.observe(lanes / max(1, slots))
        verify_dispatch_latency.labels(lane, "device").observe(
            max(0.0, elapsed))
        with self._cond:
            self._dispatches += 1
            self._dispatch_lanes += lanes
            self._dispatch_slots += slots
            self._device_time += max(0.0, elapsed)
            if sharded:
                self._sharded_dispatches += 1
            st = self._streams.get(gid) if gid is not None else None
            if st is not None:
                st.dispatches += 1
            if slot is not None:
                # the latency history the watchdog deadline derives from
                slot.latencies.append(max(0.0, elapsed))
        if slot is not None and slot.tenant is not None \
                and self._tenancy is not None:
            # per-tenant device-time accounting: the measured
            # device phase of the pack|queue|device split, attributed to
            # the chain's tenant — the quota the admission plane enforces
            # is occupancy the device actually served, not a guess
            try:
                self._tenancy.account_device_time(slot.tenant,
                                                  max(0.0, elapsed))
            except Exception:
                pass        # accounting must never cost the dispatch

    def _note_host_served(self) -> None:
        from ..metrics import verify_host_served
        with self._cond:
            self._host_served += 1
        verify_host_served.inc()

    def _account_pack(self, lane: str, elapsed: float) -> None:
        """The pack third of the pack|queue|device latency split: host
        packing wall time per chunk (packer thread) — the term the
        device-h2f front shrinks, readable off the same instrumentation
        as the other two."""
        from ..metrics import verify_dispatch_latency
        verify_dispatch_latency.labels(lane, "pack").observe(
            max(0.0, elapsed))
        with self._cond:
            self._pack_time += max(0.0, elapsed)

    def _account_queue(self, lane: str, waited: float) -> None:
        """The queue half of the dispatch-latency split: submit-to-gather
        wait of a batch's oldest rider (coalescing window + lane
        contention), distinct from device time so an occupancy regression
        is observable, not inferred."""
        from ..metrics import verify_dispatch_latency
        verify_dispatch_latency.labels(lane, "queue").observe(
            max(0.0, waited))
        with self._cond:
            self._queue_time += max(0.0, waited)

    def _stash_sample(self, slot: Optional[_BackendSlot], rounds, sigs,
                      prevs, results, lo: int) -> None:
        """Remember one verified lane of a successful dispatch as the
        canary probe's replay sample."""
        if slot is None:
            return
        with self._cond:
            slot.sample = (list(rounds[lo:lo + 1]), list(sigs[lo:lo + 1]),
                           list(prevs[lo:lo + 1]), bool(results[lo]))

    # -- observability / lifecycle -------------------------------------------

    def stats(self) -> dict:
        pool = self._pool
        groups = pool.snapshot() if pool is not None else {}
        with self._cond:
            for gid, g in groups.items():
                st = self._streams.get(gid)
                g["dispatches"] = st.dispatches if st is not None else 0
                g["inflight_max"] = st.inflight_max if st is not None else 0
            return {
                "submitted": self._submitted,
                "dispatches": self._dispatches,
                "preemptions": self._preemptions,
                "failovers": self._failovers,
                "promotions": self._promotions,
                "watchdog_trips": self._watchdog_trips,
                # chunks and aggregation-time partial checks served by a
                # host backend (a host handle, a failover's fallback, a
                # host partial verifier): 0 where every check ran on the
                # card
                "host_served": self._host_served,
                "backends": {s.label: s.state
                             for s in self._slots.values()},
                "fill_ratio": (self._dispatch_lanes /
                               self._dispatch_slots
                               if self._dispatch_slots else 0.0),
                # raw accumulators so callers can delta a measured window
                # (bench config 6) instead of blending cold+warm runs
                "dispatch_lanes": self._dispatch_lanes,
                "dispatch_slots": self._dispatch_slots,
                # occupancy observability: the
                # pack|queue|device latency split and the deepest
                # in-flight dispatch window seen
                "pack_time_s": self._pack_time,
                "queue_time_s": self._queue_time,
                "device_time_s": self._device_time,
                "inflight_depth_max": self._inflight_max,
                "tuning": {s.label: {
                    "pad": s.pad, "depth": s.depth,
                    "h2f_device": bool(getattr(s.primary, "h2f_device",
                                               False))}
                           for s in self._slots.values()},
                "queue_depth": {ln: self._qdepth_locked(ln)
                                for ln in LANES},
                "background_paused": self._bg_paused,
                # multi-device scale-out: the device pool view,
                # chain→group affinity, and the concurrency/sharding proof
                "n_devices": pool.n_devices if pool is not None else 0,
                "n_groups": pool.n_groups if pool is not None else 0,
                "groups": groups,
                "group_map": {s.label: s.gid
                              for s in self._slots.values()},
                "migrations": self._migrations,
                "sharded_dispatches": self._sharded_dispatches,
                "concurrent_streams_max": self._concurrent_max,
                # multi-tenant serving: chain→tenant labels +
                # policy-driven placement moves
                "tenant_map": {s.label: s.tenant
                               for s in self._slots.values()
                               if s.tenant is not None},
                "tenant_rebalances": self._tenant_rebalances,
            }

    def set_background_paused(self, paused: bool) -> None:
        """Admission-ladder hook (net/admission.py): pause/resume the
        BACKGROUND lane's dispatching.  Queued background work waits —
        it is never failed — and resumes flush-ready when the serving
        plane recovers; a blocking background caller still resolves the
        moment the pause lifts (or via stop())."""
        with self._cond:
            if self._bg_paused == paused:
                return
            self._bg_paused = paused
            self._cond.notify_all()

    def background_paused(self) -> bool:
        with self._cond:
            return self._bg_paused

    def flush_background(self, timeout: float) -> bool:
        """Graceful-shutdown flush (SIGTERM drain path): lift any
        admission-ladder pause, mark every queued BACKGROUND request
        flush-ready (so coalescing windows don't hold the drain open),
        and wait until the background queues are empty — bounded by
        `timeout` REAL seconds (condvar waits are wall-clock; a fake
        clock cannot hang this).  Returns True when the lane drained in
        time; the caller proceeds to stop() either way."""
        with self._cond:
            if self._stopped:
                return True
            if self._bg_paused:
                self._bg_paused = False
            for st in self._streams.values():
                for r in st.queues[LANE_BACKGROUND]:
                    r.flush = True
            self._cond.notify_all()
        slices = max(1, int(timeout / 0.05))
        for _ in range(slices):
            with self._cond:
                if self._stopped \
                        or self._qdepth_locked(LANE_BACKGROUND) == 0:
                    return True
                self._cond.wait(0.05)
        with self._cond:
            return self._qdepth_locked(LANE_BACKGROUND) == 0

    def degraded_backends(self) -> List[str]:
        """Labels of backends currently failed over to the host path
        (degraded or mid-probe) — the /health degraded line."""
        with self._cond:
            return sorted(s.label for s in self._slots.values()
                          if s.state in (STATE_DEGRADED, STATE_PROBING))

    def summary(self) -> str:
        """One line for /health."""
        s = self.stats()
        q = s["queue_depth"]
        line = (f"dispatches={s['dispatches']} requests={s['submitted']} "
                f"fill={s['fill_ratio']:.2f} preempt={s['preemptions']} "
                f"queue={q[LANE_LIVE]}/{q[LANE_BACKGROUND]} "
                f"inflight<={s['inflight_depth_max']} "
                f"pt/qt/dt={s['pack_time_s']:.1f}/{s['queue_time_s']:.1f}"
                f"/{s['device_time_s']:.1f}s")
        if s["n_groups"]:
            line += (f" groups={s['n_groups']}"
                     f"x{max(1, s['n_devices']) // max(1, s['n_groups'])}dev")
        if s["sharded_dispatches"]:
            line += f" sharded={s['sharded_dispatches']}"
        if s["migrations"]:
            line += f" migrations={s['migrations']}"
        if s["failovers"] or s["watchdog_trips"]:
            line += (f" failovers={s['failovers']}"
                     f" trips={s['watchdog_trips']}")
        if s["background_paused"]:
            line += " BG-PAUSED"
        bad_groups = sorted(str(gid) for gid, g in s["groups"].items()
                            if g["state"] != "healthy")
        if bad_groups:
            line += " GROUP-FAULTED=g" + ",g".join(bad_groups)
        deg = self.degraded_backends()
        if deg:
            line += " DEGRADED=" + ",".join(deg)
        return line

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            drained = []
            threads = []
            packers = []
            for st in self._streams.values():
                for ln in LANES:
                    drained.extend(st.queues[ln])
                    st.queues[ln] = deque()
                if st.thread is not None:
                    threads.append(st.thread)
                    st.thread = None
                if st.packer is not None:
                    packers.append(st.packer)
                    st.packer = None
            wd, self._watchdog_thread = self._watchdog_thread, None
            probe, self._probe_thread = self._probe_thread, None
            # cancel in-flight tickets so the watchdog exits and any
            # wedged executor discards its result on return
            for t in self._tickets.values():
                t.cancelled = True
            self._tickets.clear()
            self._cond.notify_all()
        for r in drained:
            if not r.future.done():
                r.future.set_exception(RuntimeError("verify service stopped"))
        for t in threads + [wd, probe]:
            if t is not None and t is not threading.current_thread():
                t.join(timeout=5)
        for packer in packers:
            packer.shutdown(wait=False)


# -- process-wide singleton ---------------------------------------------------
#
# Daemons own a service via Config.verify_service() (bound to the injected
# clock); standalone consumers (VerifyingClient, a bare SyncManager) share
# this module-level default.

_global_service: Optional[VerifyService] = None
_global_lock = make_lock()


def get_service(**kwargs) -> VerifyService:
    """The process-default service, created on first use."""
    global _global_service
    with _global_lock:
        if _global_service is None:
            _global_service = VerifyService(**kwargs)
        return _global_service


def set_service(service: Optional[VerifyService]) -> Optional[VerifyService]:
    """Install (or clear) the process-default service; returns the old
    one.  Daemon wiring and tests use this."""
    global _global_service
    with _global_lock:
        old, _global_service = _global_service, service
        return old


def current_service() -> Optional[VerifyService]:
    """The installed default, or None — never creates one (health probes
    must not spin up a worker as a side effect)."""
    with _global_lock:
        return _global_service
