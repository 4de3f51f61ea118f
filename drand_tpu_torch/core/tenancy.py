"""Multi-tenant beacon-as-a-service: the tenant registry and the quota
model behind it.

The daemon has been multi-beacon since the seed (one process hosting many
`beacon_id`s under `multibeacon/`), and everything below it — the verify
service, the admission controller, TUNING.json — is already keyed
per-chain/handle.  What was missing is the layer that says WHOSE chain a
request belongs to and how much of the shared daemon that owner may use.
Tenant cost is heterogeneous: scheme (G1 vs G2 partials), period, and
committee size change per-round device cost by large factors
(arXiv:2302.00418 measures the verification gap in committee settings),
so a flat per-class admission budget lets one expensive chain starve the
rest.  This module is the registry both enforcement planes read:

  * **Admission** (net/admission.py): per-tenant token-bucket rate
    sub-budgets and weighted fair queuing INSIDE the existing
    critical/normal/sheddable classes.  A tenant over its quota (or
    admin-paused) is shed one degradation-ladder rung EARLIER than
    compliant tenants; rejections stay cheap, well-formed, and carry the
    tenant label.
  * **Placement** (crypto/device_pool.py + verify_service): handle→group
    assignment is weight-proportional, premium tenants may pin a group
    or demand anti-affinity, and the registry accumulates per-tenant
    device-seconds from the verify service's pack|queue|device latency
    split — quota enforcement is MEASURED, not guessed.

The registry itself is deliberately passive state + arithmetic: one lock,
no threads, bounded per-tenant usage windows.  It persists atomically
(`fs.write_atomic`) beside the multibeacon layout
(`<folder>/multibeacon/tenants.json`) and is editable over the Control
plane (TenantSet/TenantRemove/TenantList) without a daemon restart —
change listeners fan the update out to the admission controller and the
verify service's placement rebalancer.

Trust model: tenancy is OPERATOR configuration.  A tenant is resolved
from the chain a request names (beacon_id / chain hash), which is
public information — quotas protect tenants from EACH OTHER's load on
a shared daemon.  The identity plane upgrades this to a
real authorization boundary when the operator opts in: macaroon-style
bearer tokens (core/authz.py) bind a request to a tenant + chain
allowlist BEFORE any quota is spent, and mutual TLS (net/identity.py)
binds node-to-node traffic to roster entries.  Without tokens/mTLS the
pre-PR-19 behavior is unchanged (load isolation only, anonymous reads
byte-identical).  Critical-class traffic (the daemon's own group
partials/DKG) is never shed on a tenant's behalf: a tenant's quota can
slow its readers, never its chain's liveness.

The port's copy of drand_tpu/core/tenancy.py, unchanged but for its imports.
"""

import json
import os
import threading

from ..common import make_rlock
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

DEFAULT_TENANT = "default"

# Rolling window (seconds, injected clock) the device-time quota is
# measured over: budget is device-seconds per wall second, so a tenant
# with budget 0.5 may burn 15 device-seconds of verify time per 30 s
# window before its quota level crosses 1.0.
DEFAULT_DEVICE_WINDOW = float(
    os.environ.get("DRAND_TENANT_DEVICE_WINDOW", "30"))

REGISTRY_FILE = "tenants.json"


@dataclass
class TenantConfig:
    """One tenant's registry entry.  `weight` drives both weighted fair
    queuing in admission and weight-proportional device placement;
    weight 0 (or `paused`) is the admin-pause state — everything
    non-critical sheds, nothing touches device time.  `rate`/`burst`
    bound the tenant's sheddable reads with a token bucket (0 = only the
    class-wide budget applies).  `device_budget` is device-seconds per
    wall second across the tenant's chains (0 = unmetered).  `pin_group`
    pins the tenant's chains to one device group (premium isolation),
    `anti_affinity` prefers a group no other tenant occupies."""

    name: str
    weight: float = 1.0
    rate: float = 0.0
    burst: int = 0
    device_budget: float = 0.0
    chains: Tuple[str, ...] = ()
    pin_group: Optional[int] = None
    anti_affinity: bool = False
    paused: bool = False

    def __post_init__(self):
        self.weight = max(0.0, float(self.weight))
        self.rate = max(0.0, float(self.rate))
        self.burst = max(0, int(self.burst))
        self.device_budget = max(0.0, float(self.device_budget))
        self.chains = tuple(self.chains)

    @property
    def effectively_paused(self) -> bool:
        return self.paused or self.weight <= 0.0

    def to_dict(self) -> dict:
        d = {"name": self.name, "weight": self.weight,
             "chains": list(self.chains)}
        if self.rate:
            d["rate"] = self.rate
        if self.burst:
            d["burst"] = self.burst
        if self.device_budget:
            d["device_budget"] = self.device_budget
        if self.pin_group is not None:
            d["pin_group"] = self.pin_group
        if self.anti_affinity:
            d["anti_affinity"] = True
        if self.paused:
            d["paused"] = True
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TenantConfig":
        return cls(name=str(d["name"]),
                   weight=float(d.get("weight", 1.0)),
                   rate=float(d.get("rate", 0.0)),
                   burst=int(d.get("burst", 0)),
                   device_budget=float(d.get("device_budget", 0.0)),
                   chains=tuple(str(c) for c in d.get("chains", ())),
                   pin_group=(int(d["pin_group"])
                              if d.get("pin_group") is not None else None),
                   anti_affinity=bool(d.get("anti_affinity", False)),
                   paused=bool(d.get("paused", False)))


@dataclass
class AdmissionView:
    """The slice of a tenant the admission controller needs per decision
    (computed once per admit under the registry lock; net/ stays
    layering-loose — it duck-types this object, it never imports core)."""

    name: str
    known: bool = False           # registered tenant vs implicit default
    paused: bool = False
    weight: float = 1.0
    rate: float = 0.0
    burst: int = 0
    over_quota: bool = False      # device-time quota level >= 1
    quota_level: float = 0.0


@dataclass
class _Usage:
    """Per-tenant rolling device-time ledger.  `win_sum` is maintained
    incrementally (evict-on-append/read) so the quota level read on the
    admission hot path is O(evicted), not O(window); `total` is the
    lifetime sum for metrics/snapshot parity.  Bounded: time-trimmed on
    every touch plus a hard sample cap."""

    MAX_SAMPLES = 65536

    samples: deque = field(default_factory=deque)
    win_sum: float = 0.0          # sum of samples inside the window
    total: float = 0.0            # lifetime device-seconds (metrics parity)
    admitted: int = 0
    shed: int = 0

    def append(self, now: float, seconds: float, window: float) -> None:
        self.samples.append((now, seconds))
        self.win_sum += seconds
        self.total += seconds
        self.trim(now - window)
        while len(self.samples) > self.MAX_SAMPLES:
            t, s = self.samples.popleft()
            self.win_sum -= s

    def trim(self, cutoff: float) -> None:
        dq = self.samples
        while dq and dq[0][0] < cutoff:
            t, s = dq.popleft()
            self.win_sum -= s
        if not dq:
            self.win_sum = 0.0    # re-zero accumulated float drift


class TenantRegistry:
    """tenant → (chains, weight, quotas, placement) with atomic
    persistence and change listeners.

    Resolution: a request names a chain (beacon_id in gRPC metadata, the
    chain-hash path segment on REST); `register_chain` — called by the
    daemon whenever a chain hash is registered — indexes beacon_id,
    chain-hash hex, AND the chain's public key bytes, so both the
    serving planes (beacon_id / hash) and the verify service (pk-keyed
    handles) resolve to the same tenant.  Unregistered chains belong to
    the implicit `default` tenant, which is unmetered unless the
    operator registers it explicitly."""

    def __init__(self, path: Optional[str] = None, clock=None,
                 device_window: float = 0.0):
        if clock is None:
            # deferred import mirror of net/admission.py: core must not
            # force a beacon import at module scope
            from ..beacon.clock import RealClock
            clock = RealClock()
        self.clock = clock
        self.path = path
        self.device_window = device_window or DEFAULT_DEVICE_WINDOW
        self._lock = make_rlock()
        self._tenants: Dict[str, TenantConfig] = {}
        self._by_chain: Dict[str, str] = {}     # beacon_id -> tenant
        self._by_hash: Dict[str, str] = {}      # chain-hash hex -> beacon_id
        self._by_pk: Dict[bytes, str] = {}      # chain pk bytes -> beacon_id
        self._usage: Dict[str, _Usage] = {}
        self._version = 0
        self._listeners: List[Callable[[], None]] = []
        self._load_error: Optional[str] = None
        # lock-free emptiness flag (GIL-atomic bool): the admission hot
        # path reads it per request and skips every registry round trip
        # on daemons with no tenants registered
        self._active = False
        if path:
            self._load()

    # -- persistence ----------------------------------------------------------

    def _load(self) -> None:
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return
        try:
            data = json.loads(raw)
            tenants = {}
            for td in data.get("tenants", ()):
                cfg = TenantConfig.from_dict(td)
                tenants[cfg.name] = cfg
        except (ValueError, KeyError, TypeError) as e:
            # torn/corrupt registry file: every WRITE goes through
            # fs.write_atomic, so a torn file means an out-of-band writer
            # or disk fault — park the bytes aside for the operator and
            # start from the empty (unmetered) registry rather than
            # refusing to serve.  The daemon must never be bricked by its
            # own quota config.
            self._load_error = f"{type(e).__name__}: {e}"
            try:
                os.replace(self.path, self.path + ".corrupt")
            except OSError:
                pass
            return
        with self._lock:
            self._tenants = tenants
            self._reindex_locked()

    def _save_locked(self) -> None:
        if not self.path:
            return
        from ..fs import write_atomic
        data = {"version": 1,
                "tenants": [t.to_dict()
                            for _, t in sorted(self._tenants.items())]}
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        write_atomic(self.path,
                     json.dumps(data, indent=1, sort_keys=True).encode())

    def _reindex_locked(self) -> None:
        self._by_chain = {}
        for name, cfg in self._tenants.items():
            for chain in cfg.chains:
                self._by_chain[chain] = name
        self._active = bool(self._tenants)

    def has_tenants(self) -> bool:
        """Lock-free: False on a daemon with no registered tenants —
        the admission controller's zero-cost early-out."""
        return self._active

    # -- mutation (Control plane) --------------------------------------------

    def set_tenant(self, cfg: TenantConfig) -> None:
        """Add or update (upsert) one tenant; persists, then notifies the
        enforcement planes."""
        if not cfg.name:
            raise ValueError("tenant name must be non-empty")
        with self._lock:
            self._tenants[cfg.name] = cfg
            self._reindex_locked()
            self._version += 1
            self._save_locked()
        self._notify()

    def remove_tenant(self, name: str) -> bool:
        """Remove a tenant.  Its chains fall back to the implicit
        default tenant; in-flight work keyed to the dead entry resolves
        against `default` — nothing is requeued into a dead registry
        entry."""
        with self._lock:
            existed = self._tenants.pop(name, None) is not None
            self._usage.pop(name, None)
            if existed:
                self._reindex_locked()
                self._version += 1
                self._save_locked()
        if existed:
            self._remove_series(name)
            self._notify()
        return existed

    def _remove_series(self, name: str) -> None:
        from ..metrics import tenant_quota_level
        try:
            tenant_quota_level.remove(name)
        except KeyError:
            pass

    def on_change(self, cb: Callable[[], None]) -> None:
        """Register an enforcement-plane listener (admission cache,
        placement rebalance); called OUTSIDE the registry lock."""
        with self._lock:
            self._listeners.append(cb)

    def _notify(self) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for cb in listeners:
            try:
                cb()
            except Exception:
                pass        # one plane's hiccup must not block the others

    # -- resolution -----------------------------------------------------------

    def register_chain(self, beacon_id: str, pk: bytes = b"",
                       chain_hash: str = "") -> None:
        """Index a served chain (daemon calls this whenever a chain hash
        is registered) so hash- and pk-keyed consumers resolve without
        knowing beacon ids.

        A NEW index entry fires the change listeners: the verify
        service's handles are typically created (start_beacon) BEFORE
        the daemon registers the chain hash, so the pk→tenant resolution
        at handle-creation time came up empty — the rebalance listener
        re-labels those slots (and applies the tenant's pin) now that
        the mapping exists.  Re-registration of an unchanged mapping is
        a no-op, so restart/reshare paths do not churn placement."""
        changed = False
        with self._lock:
            if chain_hash and self._by_hash.get(chain_hash) != beacon_id:
                self._by_hash[chain_hash] = beacon_id
                changed = True
            if pk and self._by_pk.get(bytes(pk)) != beacon_id:
                self._by_pk[bytes(pk)] = beacon_id
                changed = True
            changed = changed and bool(self._tenants)
        if changed:
            self._notify()

    def tenant_for_chain(self, beacon_id: Optional[str]) -> str:
        with self._lock:
            return self._by_chain.get(beacon_id or "", DEFAULT_TENANT)

    def tenant_for_hash(self, chain_hash: str) -> str:
        with self._lock:
            bid = self._by_hash.get(chain_hash, "")
            return self._by_chain.get(bid, DEFAULT_TENANT)

    def tenant_for_pk(self, pk: bytes) -> str:
        with self._lock:
            bid = self._by_pk.get(bytes(pk), "")
            return self._by_chain.get(bid, DEFAULT_TENANT)

    def resolve_metadata(self, metadata) -> str:
        """gRPC request metadata → tenant (beaconID, else chain_hash)."""
        if metadata is None:
            return DEFAULT_TENANT
        bid = getattr(metadata, "beaconID", "")
        if not bid:
            ch = getattr(metadata, "chain_hash", b"")
            if ch:
                return self.tenant_for_hash(bytes(ch).hex())
        return self.tenant_for_chain(bid)

    def get(self, name: str) -> Optional[TenantConfig]:
        with self._lock:
            return self._tenants.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    def version(self) -> int:
        with self._lock:
            return self._version

    # -- the admission plane's read ------------------------------------------

    def admission_view(self, tenant: Optional[str]) -> AdmissionView:
        name = tenant or DEFAULT_TENANT
        with self._lock:
            cfg = self._tenants.get(name)
            if cfg is None:
                return AdmissionView(name=name)
            level = self._quota_level_locked(name, cfg)
        if cfg.device_budget > 0:
            # keep the gauge live as the window drains: without this an
            # idle over-quota tenant's gauge froze at its last spike and
            # disagreed with /health's recomputed level forever
            from ..metrics import registered_label, tenant_quota_level
            tenant_quota_level.labels(
                registered_label(name, ns="tenant")).set(level)
        return AdmissionView(
            name=name, known=True, paused=cfg.effectively_paused,
            weight=cfg.weight, rate=cfg.rate, burst=cfg.burst,
            over_quota=level >= 1.0, quota_level=level)

    def weights(self) -> Dict[str, float]:
        """Active WFQ weights (registered tenants only; the implicit
        default tenant weighs 1.0 at the controller)."""
        with self._lock:
            return {n: c.weight for n, c in self._tenants.items()}

    def note_decision(self, tenant: str, admitted: bool) -> None:
        """Per-tenant admission bookkeeping + the tenant_requests_total
        series (called by the controller on every tenant-labelled
        decision)."""
        from ..metrics import registered_label, tenant_requests
        name = tenant or DEFAULT_TENANT
        with self._lock:
            u = self._usage.setdefault(name, _Usage())
            if admitted:
                u.admitted += 1
            else:
                u.shed += 1
        tenant_requests.labels(registered_label(name, ns="tenant"),
                               "admitted" if admitted else "shed").inc()

    # -- device-time accounting (the placement plane's write) ----------------

    def account_device_time(self, tenant: Optional[str],
                            seconds: float) -> None:
        """One verify-service device (or pack) interval attributed to a
        tenant — read off the service's pack|queue|device latency split,
        so the quota is enforced on measured device occupancy."""
        if seconds <= 0:
            return
        from ..metrics import tenant_device_seconds, tenant_quota_level
        name = tenant or DEFAULT_TENANT
        now = self.clock.monotonic()
        with self._lock:
            u = self._usage.setdefault(name, _Usage())
            u.append(now, float(seconds), self.device_window)
            cfg = self._tenants.get(name)
            level = self._quota_level_locked(name, cfg) \
                if cfg is not None else 0.0
        from ..metrics import registered_label
        lbl = registered_label(name, ns="tenant")
        tenant_device_seconds.labels(lbl).inc(float(seconds))
        tenant_quota_level.labels(lbl).set(level)

    def device_seconds(self, tenant: str,
                       window: Optional[float] = None) -> float:
        """Device-seconds attributed to `tenant` inside the rolling
        window (window=None uses the registry's quota window; a custom
        window is capped by the retained samples)."""
        now = self.clock.monotonic()
        with self._lock:
            u = self._usage.get(tenant)
            if u is None:
                return 0.0
            if window is None or window >= self.device_window:
                u.trim(now - self.device_window)
                return u.win_sum
            cutoff = now - window
            return sum(s for t, s in u.samples if t >= cutoff)

    def device_seconds_total(self, tenant: str) -> float:
        """Lifetime device-seconds for `tenant` (bench/chaos reporting
        — the rolling window is the quota's business, not the tally's)."""
        with self._lock:
            u = self._usage.get(tenant)
            return u.total if u is not None else 0.0

    def _quota_level_locked(self, name: str, cfg: TenantConfig) -> float:
        """used / allowed over the rolling window; 0 when unmetered.
        O(evicted) — the window sum is maintained incrementally, never
        recomputed (this runs per admission decision)."""
        if cfg is None or cfg.device_budget <= 0:
            return 0.0
        u = self._usage.get(name)
        if u is None:
            return 0.0
        u.trim(self.clock.monotonic() - self.device_window)
        allowed = cfg.device_budget * self.device_window
        return u.win_sum / allowed if allowed > 0 else 0.0

    def quota_level(self, tenant: str) -> float:
        with self._lock:
            cfg = self._tenants.get(tenant)
            if cfg is None:
                return 0.0
            return self._quota_level_locked(tenant, cfg)

    # -- the placement plane's read ------------------------------------------

    def placement_for_pk(self, pk: bytes) -> dict:
        """Placement hints for a verify handle keyed by chain public key:
        tenant name, WFQ weight, optional group pin, anti-affinity.  The
        device pool consumes this as **kwargs.

        A chain resolving to the IMPLICIT default (no registry entry
        names it) gets `tenant: None`: the slot stays unlabelled, so the
        per-dispatch device-time accounting (registry lock + deque +
        two metric label lookups on the hottest path) is NOT paid on
        single-operator daemons — the placement mirror of the admission
        plane's `has_tenants` early-out.  Registering the tenant later
        re-labels live slots via the change listeners."""
        name = self.tenant_for_pk(pk)
        with self._lock:
            cfg = self._tenants.get(name)
            if cfg is None:
                return {"tenant": None, "weight": 1.0, "pin": None,
                        "anti_affinity": False}
            return {"tenant": name,
                    "weight": cfg.weight if not cfg.effectively_paused
                    else 0.0,
                    "pin": cfg.pin_group,
                    "anti_affinity": cfg.anti_affinity}

    # -- observability --------------------------------------------------------

    def snapshot(self) -> dict:
        """The /health `tenants` block: per-tenant config + live quota
        state + admission/device counters (bounded by tenant count; the
        registry is operator-sized, not user-sized)."""
        from ..metrics import tenant_quota_level
        with self._lock:
            out = {}
            for name, cfg in sorted(self._tenants.items()):
                u = self._usage.get(name)
                level = self._quota_level_locked(name, cfg)
                if cfg.device_budget > 0:
                    # refresh the gauge on every /health scrape too (the
                    # idle-tenant freeze fix, for tenants with no
                    # admission traffic at all)
                    from ..metrics import registered_label
                    tenant_quota_level.labels(
                        registered_label(name, ns="tenant")).set(level)
                out[name] = {
                    "weight": cfg.weight,
                    "chains": list(cfg.chains),
                    "paused": cfg.effectively_paused,
                    "quota_level": round(level, 3),
                    "device_budget": cfg.device_budget,
                    "device_seconds_total": round(u.total, 3) if u else 0.0,
                    "admitted": u.admitted if u else 0,
                    "shed": u.shed if u else 0,
                }
                if cfg.pin_group is not None:
                    out[name]["pin_group"] = cfg.pin_group
                if cfg.rate:
                    out[name]["rate"] = cfg.rate
            snap = {"tenants": out, "version": self._version}
            if self._load_error:
                snap["load_error"] = self._load_error
            return snap


def registry_path(folder: str) -> str:
    """Canonical registry location: beside the multibeacon layout, so the
    tenancy config travels with the chains it governs."""
    from ..common import MULTI_BEACON_FOLDER
    return os.path.join(folder, MULTI_BEACON_FOLDER, REGISTRY_FILE)
