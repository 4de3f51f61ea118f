"""Serving-plane admission control: priority classes, load shedding, and
a graceful-degradation ladder (the resource-exhaustion
failure class of the beacon-client security review, arXiv:2109.11677).

The daemon's inbound surfaces used to be unprotected: a flood of public
reads could occupy every gRPC worker and starve partial-signature
aggregation — costing live rounds to save a CDN a cache miss.  This
module is ONE passive controller every inbound surface consults before
doing work:

  * **Priority classes.**  `critical` (Protocol partials/DKG RPCs) is
    never shed and has reserved concurrency — `critical_reserve` tokens
    no other class can take.  `normal` (SyncChain catch-up streams) gets
    per-peer fair-share caps and chunk pacing so one hungry peer cannot
    monopolize the pool.  `sheddable` (public gRPC/REST reads) is first
    to go: it never waits for a token, and a shed costs one small write
    before any parsing or routing.
  * **Concurrency tokens + queue-wait signal.**  Admission is decided by
    tokens (`capacity` total, `capacity - critical_reserve` for the
    non-critical classes) plus the p99 of recent admission waits,
    measured on the injected Clock.  When the p99 crosses `shed_wait`
    the controller climbs the degradation ladder; it climbs back down
    hysteretically (`recover_wait` < `shed_wait`, one step per `dwell`
    seconds) so a load spike cannot make it flap.
  * **Degradation ladder.**  Levels, in order:
        0 nominal          — everything admitted
        1 shed-public      — sheddable class rejected outright
        2 pause-background — + the verify service's background lane is
                             paused and scheduled integrity scans defer
                             (requeue-never-fail: the work waits, it is
                             not dropped)
        3 shed-normal      — + normal class rejected; critical only
    Background work is sacrificed BEFORE any normal-class shed: a sync
    peer's catch-up matters more than our own housekeeping.
  * **Cheap, well-formed rejections.**  gRPC callers get
    `RESOURCE_EXHAUSTED` with a `retry-after` trailer (the
    `AdmissionInterceptor` below, wired by net/listener.py); the REST
    edge turns a `Shed` into `429` + `Retry-After` before the request
    line is even parsed (http_server.py).

The controller is deliberately PASSIVE — no threads of its own; levels
are reassessed on every admit/release/snapshot from the injected clock —
so it adds one lock acquisition to the serving path and nothing else.

The port's copy of drand_tpu/net/admission.py, its code unchanged.  The
ladder's pause-background rung reaches the port's verify service through
`background_hook` (`VerifyService.set_background_paused`).  grpc is
imported only inside the gRPC wiring at the bottom
(`AdmissionInterceptor` and its abort helpers), so the controller, `Shed`
and the REST edge run where grpc is not installed.
"""

import os
import threading

from ..common import make_condition
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

CLASS_CRITICAL = "critical"
CLASS_NORMAL = "normal"
CLASS_SHEDDABLE = "sheddable"
CLASSES = (CLASS_CRITICAL, CLASS_NORMAL, CLASS_SHEDDABLE)

LEVEL_NOMINAL = 0
LEVEL_SHED_PUBLIC = 1
LEVEL_PAUSE_BACKGROUND = 2
LEVEL_SHED_NORMAL = 3
LEVEL_NAMES = {LEVEL_NOMINAL: "nominal",
               LEVEL_SHED_PUBLIC: "shed-public",
               LEVEL_PAUSE_BACKGROUND: "pause-background",
               LEVEL_SHED_NORMAL: "shed-normal"}

# Module defaults; Config.admission_* overrides per daemon, the env vars
# override the module defaults (the DRAND_RETRY_* convention of
# net/resilience.py).
DEFAULT_CAPACITY = int(os.environ.get("DRAND_ADMISSION_CAPACITY", "64"))
DEFAULT_CRITICAL_RESERVE = int(
    os.environ.get("DRAND_ADMISSION_RESERVE", "8"))
DEFAULT_MAX_STREAMS_PER_PEER = int(
    os.environ.get("DRAND_ADMISSION_PEER_STREAMS", "2"))
DEFAULT_SHED_WAIT = float(os.environ.get("DRAND_ADMISSION_SHED_WAIT", "0.25"))
DEFAULT_RECOVER_WAIT = float(
    os.environ.get("DRAND_ADMISSION_RECOVER_WAIT", "0.05"))
DEFAULT_DWELL = float(os.environ.get("DRAND_ADMISSION_DWELL", "5"))
DEFAULT_NORMAL_WAIT = float(
    os.environ.get("DRAND_ADMISSION_NORMAL_WAIT", "2"))
DEFAULT_PACE_RATE = float(os.environ.get("DRAND_ADMISSION_PACE_RATE", "4096"))
DEFAULT_PACE_BURST = int(os.environ.get("DRAND_ADMISSION_PACE_BURST", "512"))
DEFAULT_RETRY_AFTER = float(
    os.environ.get("DRAND_ADMISSION_RETRY_AFTER", "1"))

# why a request was shed (the Shed.reason field; tests + the ladder
# assertion distinguish anti-monopoly sheds from pressure sheds)
REASON_LEVEL = "level"          # the degradation ladder said no
REASON_CAPACITY = "capacity"    # no token free (and the class won't wait)
REASON_PEER_CAP = "peer-cap"    # per-peer fair-share stream cap
# multi-tenant sub-budgets (core/tenancy.py): every tenant shed
# names the tenant so an over-quota rejection is attributable end to end
REASON_TENANT_PAUSED = "tenant-paused"   # weight 0 / admin pause
REASON_TENANT_RATE = "tenant-rate"       # per-tenant token bucket empty
REASON_TENANT_LEVEL = "tenant-level"     # over-quota: shed one rung early
REASON_TENANT_SHARE = "tenant-share"     # weighted fair share exceeded
REASON_DRAINING = "draining"    # graceful shutdown: only critical admitted


class Shed(Exception):
    """A well-formed rejection: carries the class, the reason, how long
    the caller should back off, and (for tenant-attributed sheds) the
    tenant label.  The transports translate this into HTTP 429 +
    `Retry-After` or gRPC `RESOURCE_EXHAUSTED` + a `retry-after` trailer
    (+ a `tenant` trailer / JSON field when the shed was tenant-scoped)."""

    def __init__(self, cls: str, reason: str, retry_after: float,
                 tenant: Optional[str] = None):
        self.cls = cls
        self.reason = reason
        self.retry_after = max(0.0, retry_after)
        self.tenant = tenant
        label = f" [tenant={tenant}]" if tenant else ""
        super().__init__(
            f"{cls} request shed ({reason}){label}; retry after "
            f"{self.retry_after:g}s")


class Ticket:
    """One admitted request.  Release exactly once (context manager or
    explicit `release()`); normal-class streams additionally call
    `pace(n)` per streamed chunk for the fair-share token bucket."""

    __slots__ = ("controller", "cls", "peer", "stream", "tenant",
                 "_released", "_sent", "_next_ok")

    def __init__(self, controller: "AdmissionController", cls: str,
                 peer: Optional[str], stream: bool,
                 tenant: Optional[str] = None):
        self.controller = controller
        self.cls = cls
        self.peer = peer
        self.stream = stream
        self.tenant = tenant
        self._released = False
        self._sent = 0
        self._next_ok = 0.0

    def __enter__(self) -> "Ticket":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def release(self) -> None:
        self.controller._release(self)

    def pace(self, n: int = 1) -> float:
        """Fair-share pacing for streams: past the burst allowance, each
        item costs 1/rate seconds where rate is the shared pace budget
        divided by the number of active normal streams.  Uncontended (one
        active stream) pacing is off — a lone catch-up peer gets the full
        pipe.  Returns the seconds this call waited (fake seconds under
        an injected test clock)."""
        return self.controller._pace(self, n)


class AdmissionController:
    """The shared serving-plane admission controller (see module doc).

    All state lives under one condition variable; waits are cv-slices
    bounded in REAL time (the verify-service pattern) so a frozen
    FakeClock can never wedge a serving thread, while measured waits read
    the injected clock so tests are deterministic."""

    # real-seconds ceiling on any single admission/pace wait: the fake
    # deadline may never arrive on a frozen test clock
    WAIT_REAL_CAP = 2.0

    def __init__(self, clock=None, capacity: int = 0,
                 critical_reserve: int = 0,
                 max_streams_per_peer: int = 0,
                 shed_wait: float = 0.0, recover_wait: float = 0.0,
                 dwell: float = 0.0, normal_wait: float = 0.0,
                 pace_rate: float = 0.0, pace_burst: int = 0,
                 retry_after: float = 0.0,
                 background_hook: Optional[Callable[[bool], None]] = None,
                 tenancy=None, authority=None):
        if clock is None:
            # deferred import: net must not hard-depend on beacon at
            # module scope (same softening as net/resilience.py)
            from ..beacon.clock import RealClock
            clock = RealClock()
        self.clock = clock
        self.capacity = capacity or DEFAULT_CAPACITY
        self.critical_reserve = min(
            critical_reserve or DEFAULT_CRITICAL_RESERVE, self.capacity - 1)
        self.max_streams_per_peer = (max_streams_per_peer
                                     or DEFAULT_MAX_STREAMS_PER_PEER)
        self.shed_wait = shed_wait or DEFAULT_SHED_WAIT
        self.recover_wait = recover_wait or DEFAULT_RECOVER_WAIT
        self.dwell = dwell or DEFAULT_DWELL
        self.normal_wait = normal_wait or DEFAULT_NORMAL_WAIT
        self.pace_rate = pace_rate or DEFAULT_PACE_RATE
        self.pace_burst = pace_burst or DEFAULT_PACE_BURST
        self.retry_after_s = retry_after or DEFAULT_RETRY_AFTER
        self.background_hook = background_hook
        # core/tenancy.py TenantRegistry (duck-typed: admission_view /
        # weights / note_decision / resolve_metadata) — None keeps every
        # pre-tenancy call site byte-identical in behavior
        self.tenancy = tenancy
        # core/authz.py TokenAuthority (duck-typed: active / verify) —
        # None (or an authority that never minted) keeps the anonymous
        # chain-name attribution path untouched
        self.authority = authority
        self._cond = make_condition()
        self._inflight: Dict[str, int] = {c: 0 for c in CLASSES}
        self._peer_streams: Dict[str, int] = {}
        self._normal_streams = 0
        # (clock.monotonic() stamp, class, measured wait) rolling window
        self._waits: deque = deque(maxlen=1024)
        self._window = max(4 * self.dwell, 20.0)
        self._level = LEVEL_NOMINAL
        self._level_changed_at = self.clock.monotonic()
        self._transitions: List[Tuple[float, int]] = []
        self._admitted: Dict[str, int] = {c: 0 for c in CLASSES}
        self._shed: Dict[Tuple[str, str], int] = {}
        self._shed_log: List[Tuple[float, str, str]] = []
        self._paced_waits = 0
        # per-tenant sub-budget state: NONCRITICAL tokens each tenant
        # currently holds (the WFQ share check) and the per-tenant rate
        # buckets ([tokens, last-refill stamp], injected clock)
        self._tenant_inflight: Dict[str, int] = {}
        self._tenant_buckets: Dict[str, List[float]] = {}
        # graceful-shutdown drain gate: once set, sheddable/normal shed
        # immediately (REASON_DRAINING) while critical keeps flowing so
        # in-flight partials can finish before the process exits
        self._draining = False

    # -- admission ------------------------------------------------------------

    def admit(self, cls: str, peer: Optional[str] = None,
              stream: bool = False, tenant: Optional[str] = None) -> Ticket:
        """Admit or raise `Shed`.  Critical never sheds (the reserve
        guarantees it a token; even a reserve misconfigured to zero only
        costs accounting, never the partial).  Normal waits up to
        `normal_wait` for a token; sheddable never waits.

        `tenant` (with a registry installed) applies the per-tenant
        sub-budgets inside the class: the paused gate, the rate bucket,
        the over-quota one-rung-early level bump, and the weighted fair
        share on token contention.  `tenant=None` (or no registry) is
        byte-identical to the pre-tenancy behavior."""
        if cls not in self._inflight:
            raise ValueError(f"unknown admission class {cls!r}")
        from ..metrics import (admission_inflight, admission_requests,
                               admission_wait_seconds)
        # resolve the tenant OUTSIDE self._cond (registry holds its own
        # lock; keep the order controller-after-registry impossible).
        # `has_tenants` is a lock-free bool: an empty registry (the
        # single-operator common case) costs zero registry round trips
        # per request
        view = weights = None
        if self.tenancy is not None and tenant is not None \
                and getattr(self.tenancy, "has_tenants", lambda: True)():
            view = self.tenancy.admission_view(tenant)
            weights = self.tenancy.weights()
        now0 = self.clock.monotonic()
        hook = None
        try:
            with self._cond:
                hook = self._reassess_locked(now0)
                if self._draining and cls != CLASS_CRITICAL:
                    self._note_shed_locked(cls, REASON_DRAINING, now0)
                    raise Shed(cls, REASON_DRAINING, self.retry_after_s,
                               tenant=view.name if view else None)
                self._check_tenant_locked(cls, view, now0)
                self._check_level_locked(cls, now0, view=view)
                if cls == CLASS_NORMAL and stream and peer is not None \
                        and self._peer_streams.get(peer, 0) \
                        >= self.max_streams_per_peer:
                    self._note_shed_locked(cls, REASON_PEER_CAP, now0)
                    raise Shed(cls, REASON_PEER_CAP, self.retry_after_s,
                               tenant=view.name if view else None)
                waited = self._acquire_locked(cls, now0, view=view,
                                              weights=weights)
                self._waits.append((self.clock.monotonic(), cls, waited))
                self._inflight[cls] += 1
                self._admitted[cls] += 1
                if view is not None and cls != CLASS_CRITICAL:
                    self._tenant_inflight[view.name] = \
                        self._tenant_inflight.get(view.name, 0) + 1
                if cls == CLASS_NORMAL and stream:
                    self._normal_streams += 1
                    if peer is not None:
                        self._peer_streams[peer] = \
                            self._peer_streams.get(peer, 0) + 1
                hook = self._reassess_locked(self.clock.monotonic()) or hook
        except Shed:
            if view is not None:
                self._note_tenant(view.name, False)
            raise
        finally:
            self._run_hook(hook)
        if view is not None:
            self._note_tenant(view.name, True)
        admission_requests.labels(cls, "admitted").inc()
        admission_wait_seconds.labels(cls).observe(max(0.0, waited))
        admission_inflight.labels(cls).set(self._inflight[cls])
        t = Ticket(self, cls, peer, stream,
                   tenant=view.name if view is not None else None)
        t._next_ok = self.clock.monotonic()
        return t

    def try_admit(self, cls: str, peer: Optional[str] = None,
                  stream: bool = False,
                  tenant: Optional[str] = None) -> Tuple[Optional[Ticket],
                                                         Optional[Shed]]:
        """Non-raising admit for transports that translate the rejection
        themselves (the REST edge's pre-parse shed path)."""
        try:
            return self.admit(cls, peer=peer, stream=stream,
                              tenant=tenant), None
        except Shed as s:
            return None, s

    def attribute(self, ticket: Ticket, tenant: Optional[str]) -> None:
        """Late tenant attribution for tickets admitted BEFORE the
        tenant was knowable — the REST edge admits pre-parse (the cheap
        429 path cannot see the chain-hash segment), so its tokens used
        to be invisible to weighted fair queuing: a REST flood held the
        pool under tenant=None and the share check never engaged.  Once
        the route resolves the chain, the edge attributes the held
        ticket here; `release` already decrements the ledger.  No-op for
        critical, already-attributed, or released tickets, and on
        daemons with no tenants registered."""
        if tenant is None or self.tenancy is None \
                or not getattr(self.tenancy, "has_tenants",
                               lambda: True)():
            return
        with self._cond:
            if ticket._released or ticket.tenant is not None \
                    or ticket.cls == CLASS_CRITICAL:
                return
            ticket.tenant = tenant
            self._tenant_inflight[tenant] = \
                self._tenant_inflight.get(tenant, 0) + 1

    def _note_tenant(self, tenant: str, admitted: bool) -> None:
        """Forward the decision to the registry's per-tenant counters +
        tenant_requests_total (outside self._cond)."""
        try:
            self.tenancy.note_decision(tenant, admitted)
        except Exception:
            pass        # accounting must never cost the request

    # -- per-tenant sub-budgets (core/tenancy.py) ------------------------------

    def _check_tenant_locked(self, cls: str, view, now: float) -> None:
        """The tenant gates that run BEFORE any token work: admin pause
        (weight 0) sheds everything non-critical without touching a
        token, and the per-tenant rate bucket bounds sheddable reads.
        Critical is exempt by construction — a tenant's quota can slow
        its readers, never its chain's liveness.  Caller holds the
        lock."""
        if view is None or cls == CLASS_CRITICAL:
            return
        if view.paused:
            self._note_shed_locked(cls, REASON_TENANT_PAUSED, now)
            raise Shed(cls, REASON_TENANT_PAUSED, self.retry_after_s,
                       tenant=view.name)
        if cls == CLASS_SHEDDABLE and view.rate > 0 \
                and not self._tenant_bucket_ok_locked(view, now):
            self._note_shed_locked(cls, REASON_TENANT_RATE, now)
            raise Shed(cls, REASON_TENANT_RATE, self.retry_after_s,
                       tenant=view.name)

    def _tenant_bucket_ok_locked(self, view, now: float) -> bool:
        """Per-tenant token bucket (rate/burst from the registry entry);
        refilled on the injected clock.  Caller holds the lock."""
        cap = float(view.burst) if view.burst else max(1.0, view.rate)
        b = self._tenant_buckets.get(view.name)
        if b is None:
            b = self._tenant_buckets[view.name] = [cap, now]
        tokens = min(cap, b[0] + max(0.0, now - b[1]) * view.rate)
        if tokens >= 1.0:
            b[0], b[1] = tokens - 1.0, now
            return True
        b[0], b[1] = tokens, now
        return False

    def _tenant_over_share_locked(self, view, weights) -> bool:
        """Weighted fair queuing inside the class: under token
        contention a REGISTERED tenant already holding at least its
        weight-proportional share of the noncritical pool is shed
        instead of waiting (or camping), so compliant tenants' requests
        find the tokens the hog would otherwise absorb.  Every tenant
        keeps a floor of one token.  The implicit default tenant (every
        request on a daemon with no registry entry for its chain) is
        exempt — its "share" would be the whole pool, and shedding it at
        capacity would replace the pre-tenancy wait behavior (and the
        timed-out-wait ladder signal) on single-operator daemons.
        Caller holds the lock."""
        if view is None or not view.known:
            return False
        held = self._tenant_inflight.get(view.name, 0)
        if held == 0:
            return False        # the one-token floor
        limit = self.capacity - self.critical_reserve
        weights = weights or {}
        active = set(self._tenant_inflight) | {view.name}
        total = sum(weights.get(t, 1.0) for t in active) or 1.0
        mine = weights.get(view.name, view.weight or 1.0)
        share = max(1, int(limit * mine / total))
        return held >= share

    def _check_level_locked(self, cls: str, now: float,
                            view=None) -> None:
        """The degradation-ladder gate.  An over-quota tenant (device
        budget spent, core/tenancy.py quota level >= 1) is judged one
        rung HIGHER than the ladder's actual level — over-quota tenants
        shed strictly before compliant ones on every rung."""
        bump = 1 if view is not None and view.over_quota else 0
        level = self._level + bump
        tenant = view.name if view is not None else None
        if cls == CLASS_SHEDDABLE and level >= LEVEL_SHED_PUBLIC:
            reason = REASON_LEVEL if self._level >= LEVEL_SHED_PUBLIC \
                else REASON_TENANT_LEVEL
            self._note_shed_locked(cls, reason, now)
            raise Shed(cls, reason, self._retry_after_locked(now),
                       tenant=tenant)
        if cls == CLASS_NORMAL and level >= LEVEL_SHED_NORMAL:
            reason = REASON_LEVEL if self._level >= LEVEL_SHED_NORMAL \
                else REASON_TENANT_LEVEL
            self._note_shed_locked(cls, reason, now)
            raise Shed(cls, reason, self._retry_after_locked(now),
                       tenant=tenant)

    def _acquire_locked(self, cls: str, now0: float, view=None,
                        weights=None) -> float:
        """Take a token; returns the measured wait (injected-clock
        seconds).  Caller holds the lock."""
        from time import perf_counter
        if cls == CLASS_CRITICAL:
            return 0.0      # the reserve guarantees critical a slot
        limit = self.capacity - self.critical_reserve
        real0 = perf_counter()
        while True:
            noncrit = (self._inflight[CLASS_NORMAL]
                       + self._inflight[CLASS_SHEDDABLE])
            if noncrit < limit:
                return self.clock.monotonic() - now0
            now = self.clock.monotonic()
            waited = now - now0
            if self._tenant_over_share_locked(view, weights):
                # WFQ: the pool is contended and this tenant already
                # holds its weighted share — shed instead of competing
                # for the tokens compliant tenants are waiting on
                self._note_shed_locked(cls, REASON_TENANT_SHARE, now)
                raise Shed(cls, REASON_TENANT_SHARE, self.retry_after_s,
                           tenant=view.name)
            if cls == CLASS_SHEDDABLE:
                # shed immediately and cheaply — public reads retry at
                # the edge, they never queue inside the daemon
                self._note_shed_locked(cls, REASON_CAPACITY, now)
                raise Shed(cls, REASON_CAPACITY, self.retry_after_s,
                           tenant=view.name if view else None)
            if waited >= self.normal_wait \
                    or perf_counter() - real0 >= self.WAIT_REAL_CAP:
                # the timed-out wait IS the overload signal: record it so
                # the p99 crosses the shed threshold and the ladder climbs.
                # tpu-vet: disable=lock  (caller holds self._cond, docstring)
                self._waits.append((now, cls, max(waited, self.normal_wait)))
                self._note_shed_locked(cls, REASON_CAPACITY, now)
                raise Shed(cls, REASON_CAPACITY, self.retry_after_s,
                           tenant=view.name if view else None)
            self._check_level_locked(cls, now, view=view)
            # cv-slice bounded in real time; released tokens notify
            self._cond.wait(0.05)

    # -- graceful drain (SIGTERM path) ----------------------------------------

    def begin_drain(self) -> None:
        """Flip the drain gate: from now on sheddable and normal admits
        shed immediately with REASON_DRAINING; critical keeps being
        admitted so in-flight protocol work (partials) can finish.
        Idempotent."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    def is_draining(self) -> bool:
        with self._cond:
            return self._draining

    def drained(self, timeout: float) -> bool:
        """Block until no critical request is in flight, or `timeout`
        REAL seconds elapse (condvar waits are wall-clock; a fake clock
        cannot hang this).  Returns True when the critical lane is dry —
        the caller (graceful_stop) may then tear the services down."""
        slices = max(1, int(timeout / 0.05))
        with self._cond:
            for _ in range(slices):
                if self._inflight[CLASS_CRITICAL] == 0:
                    return True
                self._cond.wait(0.05)
            return self._inflight[CLASS_CRITICAL] == 0

    def _release(self, ticket: Ticket) -> None:
        from ..metrics import admission_inflight
        hook = None
        with self._cond:
            if ticket._released:
                return
            ticket._released = True
            self._inflight[ticket.cls] = max(
                0, self._inflight[ticket.cls] - 1)
            if ticket.tenant is not None and ticket.cls != CLASS_CRITICAL:
                left = self._tenant_inflight.get(ticket.tenant, 1) - 1
                if left <= 0:
                    self._tenant_inflight.pop(ticket.tenant, None)
                else:
                    self._tenant_inflight[ticket.tenant] = left
            if ticket.cls == CLASS_NORMAL and ticket.stream:
                self._normal_streams = max(0, self._normal_streams - 1)
                if ticket.peer is not None:
                    left = self._peer_streams.get(ticket.peer, 1) - 1
                    if left <= 0:
                        self._peer_streams.pop(ticket.peer, None)
                    else:
                        self._peer_streams[ticket.peer] = left
            hook = self._reassess_locked(self.clock.monotonic())
            self._cond.notify_all()
        self._run_hook(hook)
        admission_inflight.labels(ticket.cls).set(self._inflight[ticket.cls])

    def _note_shed_locked(self, cls: str, reason: str, now: float) -> None:
        from ..metrics import admission_requests
        self._shed[(cls, reason)] = self._shed.get((cls, reason), 0) + 1
        self._shed_log.append((now, cls, reason))
        if len(self._shed_log) > 4096:
            del self._shed_log[:2048]
        admission_requests.labels(cls, "shed").inc()

    def _retry_after_locked(self, now: float) -> float:
        """Level-based sheds back callers off until the ladder could next
        step down (the remaining dwell), floored at the static knob."""
        remaining = self.dwell - (now - self._level_changed_at)
        return max(self.retry_after_s, min(remaining, self.dwell))

    # -- the degradation ladder ----------------------------------------------

    def _p99_locked(self, now: float, cls: Optional[str] = None) -> float:
        """p99 of the wait samples inside the window, optionally filtered
        to one class.  Caller holds the lock."""
        cutoff = now - self._window
        recent = sorted(w for t, c, w in self._waits
                        if t >= cutoff and (cls is None or c == cls))
        if not recent:
            return 0.0
        return recent[min(len(recent) - 1,
                          int(round(0.99 * (len(recent) - 1))))]

    def _reassess_locked(self, now: float) -> Optional[Callable]:
        """One ladder step per dwell, driven by the queue-wait p99.
        Returns the background hook invocation to run OUTSIDE the lock
        (the verify service takes its own lock), or None."""
        if now - self._level_changed_at < self.dwell:
            return None
        p99 = self._p99_locked(now)
        new = self._level
        if p99 > self.shed_wait and self._level < LEVEL_SHED_NORMAL:
            new = self._level + 1
        elif p99 < self.recover_wait and self._level > LEVEL_NOMINAL:
            new = self._level - 1
        if new == self._level:
            return None
        crossed_bg = (self._level < LEVEL_PAUSE_BACKGROUND <= new) \
            or (new < LEVEL_PAUSE_BACKGROUND <= self._level)
        self._level = new
        self._level_changed_at = now
        self._transitions.append((now, new))
        from ..metrics import admission_level
        admission_level.set(new)
        if crossed_bg and self.background_hook is not None:
            paused = new >= LEVEL_PAUSE_BACKGROUND
            from ..metrics import admission_background_paused
            admission_background_paused.set(1 if paused else 0)
            hook = self.background_hook
            return lambda: hook(paused)
        return None

    @staticmethod
    def _run_hook(hook: Optional[Callable]) -> None:
        if hook is not None:
            hook()

    # -- stream pacing --------------------------------------------------------

    def _pace(self, ticket: Ticket, n: int) -> float:
        from time import perf_counter
        with self._cond:
            streams = max(1, self._normal_streams)
            if streams < 2:
                # uncontended: a lone catch-up peer gets the full pipe,
                # and the bucket forgives its history so contention later
                # starts from the burst allowance, not from debt
                ticket._sent = 0
                ticket._next_ok = self.clock.monotonic()
                return 0.0
            rate = max(1.0, self.pace_rate / streams)
            ticket._sent += n
            if ticket._sent <= self.pace_burst:
                ticket._next_ok = self.clock.monotonic()
                return 0.0
            ticket._next_ok = max(ticket._next_ok,
                                  self.clock.monotonic()) + n / rate
            until = ticket._next_ok
            self._paced_waits += 1
        t0 = self.clock.monotonic()
        real0 = perf_counter()
        with self._cond:
            while self.clock.monotonic() < until \
                    and perf_counter() - real0 < self.WAIT_REAL_CAP:
                # real-bounded cv-slice: a frozen FakeClock must not wedge
                # a serving stream (the REAL_FLUSH_CAP discipline)
                self._cond.wait(0.02)
        return max(0.0, self.clock.monotonic() - t0)

    # -- observability --------------------------------------------------------

    def level(self) -> int:
        hook = None
        try:
            with self._cond:
                hook = self._reassess_locked(self.clock.monotonic())
                return self._level
        finally:
            self._run_hook(hook)

    def background_paused(self) -> bool:
        """True while the ladder says background work must yield —
        scheduled integrity scans consult this and DEFER (the work waits;
        it is never dropped)."""
        return self.level() >= LEVEL_PAUSE_BACKGROUND

    def check_tenant_read(self, tenant: Optional[str]) -> Optional[Shed]:
        """Post-parse tenant gate for the REST edge: the pre-parse shed
        path cannot see the chain-hash path segment, so the tenant rules
        (pause, rate bucket, over-quota early rung) run here once the
        chain — and therefore the tenant — is known.  No concurrency
        token changes hands (the caller already holds its pre-parse
        ticket); returns the Shed instead of raising so the edge can
        serialize it into a labelled 429."""
        if self.tenancy is None or tenant is None \
                or not getattr(self.tenancy, "has_tenants",
                               lambda: True)():
            return None
        view = self.tenancy.admission_view(tenant)
        weights = self.tenancy.weights()
        now = self.clock.monotonic()
        shed = None
        with self._cond:
            try:
                self._check_tenant_locked(CLASS_SHEDDABLE, view, now)
                self._check_level_locked(CLASS_SHEDDABLE, now, view=view)
                # WFQ for the REST plane: with the noncritical pool
                # contended, a tenant already holding its weighted share
                # (REST tickets count — the edge attributes them before
                # this gate) sheds here like a gRPC admit would
                limit = self.capacity - self.critical_reserve
                noncrit = (self._inflight[CLASS_NORMAL]
                           + self._inflight[CLASS_SHEDDABLE])
                if noncrit >= limit \
                        and self._tenant_over_share_locked(view, weights):
                    self._note_shed_locked(CLASS_SHEDDABLE,
                                           REASON_TENANT_SHARE, now)
                    raise Shed(CLASS_SHEDDABLE, REASON_TENANT_SHARE,
                               self.retry_after_s, tenant=view.name)
            except Shed as s:
                shed = s
        self._note_tenant(view.name, shed is None)
        return shed

    def wait_p99(self, cls: Optional[str] = None) -> float:
        with self._cond:
            return self._p99_locked(self.clock.monotonic(), cls)

    def snapshot(self) -> dict:
        lvl = self.level()      # reassess first
        with self._cond:
            return {
                "level": lvl,
                "level_name": LEVEL_NAMES[lvl],
                "draining": self._draining,
                "inflight": dict(self._inflight),
                "admitted": dict(self._admitted),
                "shed": {f"{c}/{r}": v
                         for (c, r), v in sorted(self._shed.items())},
                "peer_streams": dict(self._peer_streams),
                "tenant_inflight": dict(self._tenant_inflight),
                "paced_waits": self._paced_waits,
                "wait_p99": {c: round(self._p99_locked(
                    self.clock.monotonic(), c), 4) for c in CLASSES},
                "transitions": list(self._transitions),
            }

    def summary(self) -> str:
        """One line for /health."""
        s = self.snapshot()
        i = s["inflight"]
        shed = sum(v for v in self._shed.values())
        return (f"level={s['level_name']} "
                f"inflight={i[CLASS_CRITICAL]}/{i[CLASS_NORMAL]}/"
                f"{i[CLASS_SHEDDABLE]} shed={shed} "
                f"p99={s['wait_p99'][CLASS_NORMAL]:.3f}s")


# -- gRPC wiring ---------------------------------------------------------------


def peer_identity(peer: str) -> str:
    """Fair-share identity for a gRPC peer string: strip the ephemeral
    client port ('ipv4:10.0.0.1:52644' -> 'ipv4:10.0.0.1',
    'ipv6:[::1]:52644' -> 'ipv6:[::1]') so the per-peer stream cap is
    per REMOTE HOST — a hog must not evade `max_streams_per_peer` by
    opening one channel per stream.  Strings without a port component
    (test names, REST client addresses) pass through unchanged."""
    if peer.count(":") >= 2:
        host = peer.rsplit(":", 1)[0]
        # ipv6 literals keep their bracketed form; a bare 'ipv6:[::1]'
        # (no port) must not lose its tail
        if not (peer.startswith("ipv6:") and not host.endswith("]")):
            return host
    return peer


def classify_method(method: str) -> Optional[str]:
    """Wire-path -> admission class.  SyncChain is the one normal-class
    stream; the rest of the node-to-node Protocol plane (partials, DKG,
    identity, status) is critical; the Public API is sheddable.  Control
    (localhost CLI) and anything unknown are exempt (None)."""
    if method == "/drand.Protocol/SyncChain":
        return CLASS_NORMAL
    if method.startswith("/drand.Protocol/"):
        return CLASS_CRITICAL
    if method.startswith("/drand.Public/"):
        return CLASS_SHEDDABLE
    return None


def _shed_abort(context, shed: Shed):
    import grpc
    trailers = [("retry-after", f"{shed.retry_after:g}")]
    if shed.tenant:
        # over-quota rejections carry the tenant label end to end: a
        # multi-tenant client (or its operator) must be able to tell
        # "your quota" from "the daemon is overloaded"
        trailers.append(("tenant", shed.tenant))
    context.set_trailing_metadata(tuple(trailers))
    context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(shed))


def _identity_abort(context, verdict):
    """Reject a bad bearer token BEFORE admission — no quota is spent,
    nothing is attributed to the tenant the token claims, and the
    rejection carries an identity-labelled trailer + metric so theft is
    observable (the StolenIdentityScenario asserts on both)."""
    import grpc
    from ..metrics import identity_rejections
    identity_rejections.labels("grpc", verdict.reason).inc()
    trailers = [("identity-reason", verdict.reason)]
    if verdict.token_id:
        trailers.append(("token-id", verdict.token_id))
    context.set_trailing_metadata(tuple(trailers))
    context.abort(grpc.StatusCode.UNAUTHENTICATED,
                  f"token rejected: {verdict.reason}")


class AdmissionInterceptor:
    """grpc.ServerInterceptor applying the controller to every RPC of a
    listener.  Unary handlers admit/release around the behavior; stream
    handlers hold their ticket for the stream's life and pace each
    response item (the SyncChain fair-share path).  Rejections abort with
    RESOURCE_EXHAUSTED and a `retry-after` trailer before any service
    logic runs."""

    def __init__(self, controller: AdmissionController,
                 classify: Callable[[str], Optional[str]] = classify_method):
        self.controller = controller
        self.classify = classify

    def intercept_service(self, continuation, handler_call_details):
        handler = continuation(handler_call_details)
        if handler is None:
            return None
        cls = self.classify(handler_call_details.method)
        if cls is None:
            return handler
        return self._wrap(handler, cls)

    def _wrap(self, handler, cls: str):
        import grpc
        ctrl = self.controller

        def tenant_of(request) -> Optional[str]:
            # the tenant is named by the chain the request addresses —
            # beaconID (or chain hash) in the standard drand metadata;
            # resolution is one dict lookup in the registry
            tenancy = ctrl.tenancy
            if tenancy is None:
                return None
            try:
                return tenancy.resolve_metadata(
                    getattr(request, "metadata", None))
            except Exception:
                return None

        def tenant_for(request, context) -> Optional[str]:
            """Authenticated tenant attribution (core/authz.py): a
            presented bearer token names the tenant directly — verified
            BEFORE any quota spend, with the chain caveat checked against
            the chain the request addresses.  A bad token aborts
            UNAUTHENTICATED here (never reaching `admit`, so nothing is
            attributed to the claimed tenant); no token at all keeps the
            anonymous chain-name path byte-identical."""
            authority = ctrl.authority
            if authority is not None and authority.active():
                from ..core.authz import REASON_READ_ONLY, TokenVerdict, \
                    grpc_bearer
                token = grpc_bearer(context.invocation_metadata())
                if token is not None:
                    meta = getattr(request, "metadata", None)
                    chain = getattr(meta, "beaconID", "") or None
                    verdict = authority.verify(token, chain=chain)
                    if verdict.ok and verdict.read_only \
                            and cls == CLASS_CRITICAL:
                        # a read-only token must not reach the write-ish
                        # node-to-node plane
                        verdict = TokenVerdict(
                            False, verdict.tenant, REASON_READ_ONLY,
                            token_id=verdict.token_id)
                    if not verdict.ok:
                        _identity_abort(context, verdict)
                    return verdict.tenant
            return tenant_of(request)

        if handler.unary_unary is not None:
            inner = handler.unary_unary

            def unary(request, context):
                try:
                    ticket = ctrl.admit(cls, peer=peer_identity(
                        context.peer()), tenant=tenant_for(request, context))
                except Shed as s:
                    _shed_abort(context, s)
                with ticket:
                    return inner(request, context)

            return grpc.unary_unary_rpc_method_handler(
                unary, request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer)

        if handler.unary_stream is not None:
            inner_s = handler.unary_stream

            def stream(request, context):
                try:
                    ticket = ctrl.admit(cls, peer=peer_identity(
                        context.peer()), stream=True,
                        tenant=tenant_for(request, context))
                except Shed as s:
                    _shed_abort(context, s)

                def gen():
                    with ticket:
                        for item in inner_s(request, context):
                            yield item
                            ticket.pace()

                return gen()

            return grpc.unary_stream_rpc_method_handler(
                stream, request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer)

        return handler      # client-streaming RPCs: none in our specs
