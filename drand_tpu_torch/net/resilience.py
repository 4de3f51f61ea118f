"""Resilience policy layer for the sync/partials hot path.

The port's copy of drand_tpu/net/resilience.py, unchanged but for its imports.

The reference drand survives flaky peers by shuffling sync candidates and
restarting idle streams (chain/beacon/sync_manager.go:302) but has no
structured retry, backoff, or peer-health memory: every dial gets the same
60-second timeout and a Byzantine peer is re-tried as eagerly as a healthy
one.  This module centralizes the three missing pieces:

  * `BackoffPolicy` — exponential backoff with full jitter, sampled from an
    injected `random.Random` so chaos tests replay byte-identically.
  * `CircuitBreaker` / `BreakerRegistry` — per-peer closed → open →
    half-open breakers (the Handel-style "stop paying for unresponsive
    peers" scoring, arXiv:1906.05132 §5), with every state change exported
    through `metrics.py` so an operator can watch a peer get quarantined.
  * `Deadline` — one overall budget for a whole sync pass / round, so a
    chain of RPCs shares a single clamp instead of stacking per-call 60s
    timeouts.

All waiting goes through the injected Clock's `wait_until`, never
`time.sleep`: production uses the daemon's RealClock; the chaos harness
(tests/chaos.py) injects an auto-advancing fake clock so retry/cooldown
schedules run instantly and deterministically.
"""

import os
import random
import threading

from ..common import make_lock
from typing import Callable, Dict, Iterable, List, Optional, Sequence


def _default_clock():
    """Deferred import: the net layer must stay importable without
    loading the beacon package (beacon.sync already imports this module;
    an import-time edge back would be one new beacon-side import away
    from a hard cycle)."""
    from ..beacon.clock import RealClock
    return RealClock()


# -- knobs (env-overridable; COMPONENTS.md "Resilience") ---------------------

DEFAULT_MAX_ATTEMPTS = int(os.environ.get("DRAND_RETRY_MAX_ATTEMPTS", "4"))
DEFAULT_BACKOFF_BASE = float(os.environ.get("DRAND_RETRY_BACKOFF_BASE", "0.25"))
DEFAULT_BACKOFF_CAP = float(os.environ.get("DRAND_RETRY_BACKOFF_CAP", "5.0"))
DEFAULT_BREAKER_FAILURES = int(os.environ.get("DRAND_BREAKER_FAILURES", "5"))
DEFAULT_BREAKER_COOLDOWN = float(os.environ.get("DRAND_BREAKER_COOLDOWN", "30"))
DEFAULT_SYNC_BUDGET = float(os.environ.get("DRAND_SYNC_BUDGET", "120"))

# breaker states (exported as the resilience_breaker_state gauge value)
CLOSED, OPEN, HALF_OPEN = 0, 1, 2
_STATE_NAMES = {CLOSED: "closed", OPEN: "open", HALF_OPEN: "half_open"}

# peer-score bounds (the Handel-style reliability rank, arXiv:1906.05132
# §5): every recorded success is +1, every failure -2, clamped so one
# burst can neither whitewash nor permanently bury a peer
SCORE_MAX = 10.0
SCORE_MIN = -10.0
SCORE_SUCCESS = 1.0
SCORE_FAILURE = -2.0


class DeadlineExceeded(Exception):
    """The operation's overall budget is spent."""


class BreakerOpen(Exception):
    """The peer's circuit breaker is open (cooldown not yet elapsed)."""


class Deadline:
    """Absolute expiry on an injected clock; one instance rides through a
    whole multi-RPC operation so retries share the budget."""

    def __init__(self, clock, expires: float):
        self.clock = clock
        self.expires = expires

    @classmethod
    def after(cls, clock, budget: float) -> "Deadline":
        return cls(clock, clock.now() + budget)

    @classmethod
    def at(cls, clock, when: float) -> "Deadline":
        return cls(clock, when)

    def remaining(self) -> float:
        return max(0.0, self.expires - self.clock.now())

    @property
    def expired(self) -> bool:
        return self.clock.now() >= self.expires

    def clamp(self, timeout: Optional[float] = None) -> float:
        """Per-call timeout bounded by what is left of the budget."""
        rem = self.remaining()
        if rem <= 0:
            raise DeadlineExceeded(f"budget spent at {self.expires}")
        return rem if timeout is None else min(timeout, rem)


class BackoffPolicy:
    """Exponential backoff with full jitter (delay ~ U(0, min(cap,
    base·factor^attempt)); the AWS-style scheme that avoids thundering
    herds).  `rng` is injected for deterministic replays."""

    def __init__(self, base: float = DEFAULT_BACKOFF_BASE,
                 factor: float = 2.0, cap: float = DEFAULT_BACKOFF_CAP,
                 jitter: bool = True):
        self.base = base
        self.factor = factor
        self.cap = cap
        self.jitter = jitter

    def delay(self, attempt: int, rng: Optional[random.Random] = None) -> float:
        top = min(self.cap, self.base * (self.factor ** attempt))
        if not self.jitter:
            return top
        return (rng or random).uniform(0.0, top)


class CircuitBreaker:
    """Closed → open after N consecutive failures → half-open probe after a
    cooldown; one successful probe closes it, a failed probe re-opens it.

    State is exported through metrics on every transition (the scrape shows
    `resilience_breaker_state{address=...}` plus a transitions counter)."""

    def __init__(self, key: str, clock=None,
                 failures: int = DEFAULT_BREAKER_FAILURES,
                 cooldown: float = DEFAULT_BREAKER_COOLDOWN,
                 scope: str = "default"):
        self.key = key
        self.clock = clock or _default_clock()
        self.failure_threshold = max(1, failures)
        self.cooldown = cooldown
        self.scope = scope
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_in_flight = False
        self._probe_started = 0.0
        self._score = 0.0
        self._last_transition = self.clock.now()
        self._lock = make_lock()
        self._export_state()

    # -- state ---------------------------------------------------------------

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    def state_name(self) -> str:
        return _STATE_NAMES[self.state]

    def _set_state(self, new: int) -> None:
        # caller holds the lock
        if new == self._state:
            return
        self._state = new
        self._last_transition = self.clock.now()
        self._export_state()
        from ..metrics import breaker_transitions, registered_label
        breaker_transitions.labels(
            self.scope, registered_label(self.key, ns="peer-address",
                                         limit=256),
            _STATE_NAMES[new]).inc()

    def _export_state(self) -> None:
        from ..metrics import breaker_state, registered_label
        breaker_state.labels(
            self.scope, registered_label(self.key, ns="peer-address",
                                         limit=256)).set(self._state)

    def next_probe_at(self) -> float:
        """Earliest clock time a call could be admitted (now for closed /
        half-open, cooldown expiry for open)."""
        with self._lock:
            if self._state == OPEN:
                return self._opened_at + self.cooldown
            return self.clock.now()

    # -- admission + accounting ----------------------------------------------

    def allow(self) -> bool:
        """True when a call may be attempted now.  An OPEN breaker whose
        cooldown has elapsed transitions to HALF_OPEN and admits exactly one
        probe; concurrent callers are rejected until the probe resolves.

        A probe whose caller never reported back (abandoned stream, caller
        crashed between admission and dial) would otherwise wedge the
        breaker in HALF_OPEN forever — stale probes are reclaimed after one
        cooldown so the breaker always self-heals."""
        with self._lock:
            now = self.clock.now()
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if now < self._opened_at + self.cooldown:
                    return False
                self._set_state(HALF_OPEN)
                self._probe_in_flight = True
                self._probe_started = now
                return True
            # HALF_OPEN: one probe at a time, stale probes reclaimed
            if self._probe_in_flight and \
                    now < self._probe_started + self.cooldown:
                return False
            self._probe_in_flight = True
            self._probe_started = now
            return True

    def force_probe(self) -> None:
        """Last-resort admission: an OPEN breaker transitions to HALF_OPEN
        before its cooldown elapses so the next `allow()` admits a probe.
        Used when EVERY candidate peer is quarantined — a healed partition
        must not idle the caller out for a full cooldown."""
        with self._lock:
            if self._state == OPEN:
                self._probe_in_flight = False
                self._set_state(HALF_OPEN)

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._probe_in_flight = False
            self._score = min(SCORE_MAX, self._score + SCORE_SUCCESS)
            self._set_state(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._probe_in_flight = False
            self._score = max(SCORE_MIN, self._score + SCORE_FAILURE)
            if self._state == HALF_OPEN:
                self._opened_at = self.clock.now()
                self._set_state(OPEN)
                return
            self._consecutive_failures += 1
            if self._state == CLOSED and \
                    self._consecutive_failures >= self.failure_threshold:
                self._opened_at = self.clock.now()
                self._set_state(OPEN)

    @property
    def score(self) -> float:
        with self._lock:
            return self._score

    def snapshot(self) -> dict:
        """Read-only view for consumers that must not reach into breaker
        internals (Handel level scheduling, /health): current score, state
        name, and the clock time of the last state transition."""
        with self._lock:
            return {"score": self._score,
                    "state": _STATE_NAMES[self._state],
                    "last_transition": self._last_transition}


def peer_key(peer) -> str:
    """Stable breaker key for anything the sync/fan-out planes call a peer
    (net.Peer, a bare address string, or a test stand-in)."""
    return getattr(peer, "address", None) or str(peer)


class BreakerRegistry:
    """Per-peer breakers under one scope label, plus the ranking primitive
    the sync path and the client transports share: healthy (closed) peers
    first, probe-ready ones next, quarantined ones last."""

    def __init__(self, clock=None, failures: int = DEFAULT_BREAKER_FAILURES,
                 cooldown: float = DEFAULT_BREAKER_COOLDOWN,
                 scope: str = "default"):
        self.clock = clock or _default_clock()
        self.failures = failures
        self.cooldown = cooldown
        self.scope = scope
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._lock = make_lock()

    def breaker(self, key: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(key)
            if br is None:
                br = CircuitBreaker(key, clock=self.clock,
                                    failures=self.failures,
                                    cooldown=self.cooldown, scope=self.scope)
                self._breakers[key] = br
            return br

    def preference(self, key: str) -> int:
        """0 = closed (or unknown), 1 = probe-eligible, 2 = quarantined."""
        with self._lock:
            br = self._breakers.get(key)
        if br is None:
            return 0
        st = br.state
        if st == CLOSED:
            return 0
        if st == HALF_OPEN or self.clock.now() >= br.next_probe_at():
            return 1
        return 2

    def rank(self, peers: Sequence[object],
             rng: Optional[random.Random] = None,
             key: Callable[[object], str] = peer_key) -> List[object]:
        """Breaker-aware failover order: shuffle (for load spreading), then
        stable-sort by breaker preference so closed-breaker peers lead and
        quarantined ones trail but are never dropped — they are the last
        resort once the healthy set is exhausted."""
        out = list(peers)
        (rng or random).shuffle(out)
        out.sort(key=lambda p: self.preference(key(p)))
        return out

    def next_probe_at(self, keys: Iterable[str]) -> float:
        """Earliest time any of `keys` will admit a call again."""
        now = self.clock.now()
        times = [self.breaker(k).next_probe_at() for k in keys]
        return min(times) if times else now

    def snapshot(self) -> Dict[str, str]:
        with self._lock:
            items = list(self._breakers.items())
        return {k: br.state_name() for k, br in items}

    def score_snapshot(self) -> Dict[str, dict]:
        """Read-only peer-score view — the ONE source of truth shared by
        Handel level scheduling and /health (score + state +
        last-transition per peer key; see CircuitBreaker.snapshot)."""
        with self._lock:
            items = list(self._breakers.items())
        return {k: br.snapshot() for k, br in items}

    def score(self, key: str) -> float:
        """Current score for one peer key (0.0 when unknown — an unseen
        peer ranks level with a neutral one, never below it)."""
        with self._lock:
            br = self._breakers.get(key)
        return 0.0 if br is None else br.score


class ResiliencePolicy:
    """One bundle of clock + backoff + breakers + retry budget, shared by
    every subsystem that talks to the same peer set (so a partial-send
    failure warms the breaker the sync peer-selection consults)."""

    def __init__(self, clock=None, backoff: Optional[BackoffPolicy] = None,
                 breakers: Optional[BreakerRegistry] = None,
                 max_attempts: int = DEFAULT_MAX_ATTEMPTS,
                 scope: str = "default", seed: Optional[int] = None,
                 stop: Optional[threading.Event] = None):
        self.clock = clock or _default_clock()
        self.backoff = backoff or BackoffPolicy()
        self.breakers = breakers or BreakerRegistry(clock=self.clock,
                                                    scope=scope)
        self.max_attempts = max(1, max_attempts)
        self.scope = scope
        self.rng = random.Random(seed)
        self._stop = stop or threading.Event()

    # -- breaker facade ------------------------------------------------------

    def breaker(self, key: str) -> CircuitBreaker:
        return self.breakers.breaker(key)

    def rank(self, peers: Sequence[object],
             key: Callable[[object], str] = peer_key) -> List[object]:
        return self.breakers.rank(peers, rng=self.rng, key=key)

    def peer_scores(self) -> Dict[str, dict]:
        return self.breakers.score_snapshot()

    # -- retry executor ------------------------------------------------------

    def sleep(self, delay: float) -> None:
        if delay > 0:
            self.clock.wait_until(self.clock.now() + delay, self._stop)

    def call(self, fn: Callable[[Optional[float]], object], *,
             key: Optional[str] = None, op: str = "rpc",
             timeout: Optional[float] = None,
             deadline: Optional[Deadline] = None,
             max_attempts: Optional[int] = None):
        """Run `fn(per_attempt_timeout)` with backoff-jittered retries.

        * `key` enables per-peer breaker accounting (None = no breaker, e.g.
          DKG setup signalling where the coordinator is EXPECTED to be down
          at first).
        * `deadline` caps the whole retry chain; each attempt's timeout is
          clamped to the remaining budget and the loop never sleeps past it.
        * raises `BreakerOpen` without dialing when the breaker rejects,
          `DeadlineExceeded` when the budget is spent before an attempt, and
          the last underlying error once attempts are exhausted.
        """
        from ..metrics import deadline_exceeded_total, retries_total
        br = self.breakers.breaker(key) if key is not None else None
        attempts = max_attempts or self.max_attempts
        last_err: Optional[Exception] = None
        for attempt in range(attempts):
            if self._stop.is_set():
                break
            # clamp BEFORE breaker admission: an expired budget must not
            # consume (and then strand) the breaker's half-open probe slot
            try:
                per_call = (deadline.clamp(timeout) if deadline is not None
                            else timeout)
            except DeadlineExceeded:
                deadline_exceeded_total.labels(self.scope, op).inc()
                raise
            if br is not None and not br.allow():
                if last_err is not None:
                    # the breaker was opened by THIS call's own failed
                    # attempt: surface that error, don't mask it as a
                    # client-side rejection (callers treat BreakerOpen as
                    # "nothing was dialed")
                    break
                raise BreakerOpen(f"{self.scope}/{key} open")
            try:
                result = fn(per_call)
            except Exception as e:   # noqa: BLE001 — transport errors vary
                last_err = e
                if br is not None:
                    br.record_failure()
                delay = self.backoff.delay(attempt, self.rng)
                out_of_budget = (deadline is not None
                                 and deadline.remaining() <= delay)
                if attempt + 1 >= attempts or out_of_budget:
                    break
                retries_total.labels(self.scope, op).inc()
                self.sleep(delay)
                continue
            if br is not None:
                br.record_success()
            return result
        if last_err is None:     # stopped before the first attempt completed
            raise DeadlineExceeded(f"{self.scope}/{op} stopped")
        raise last_err
