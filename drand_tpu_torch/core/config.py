"""Daemon configuration (reference: core/config.go:51-297 functional
options; defaults core/constants.go:13-50).

The port's copy of drand_tpu/core/config.py.  `verify_service()` builds
the port's own `crypto/verify_service.VerifyService` (its pool enumerates
the CUDA devices), and `use_device_verifier` keeps the reference's default
of True: a chain started with it on a machine without a card raises.
`handel_min_group_size()` resolves the Handel gate without importing the
overlay, which is not ported (`beacon/handel.py`).
"""

import os
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..beacon.clock import Clock, RealClock

DEFAULT_CONFIG_FOLDER_NAME = ".drand"
DEFAULT_DB_FOLDER = "db"
DEFAULT_BEACON_PERIOD = 60          # seconds (constants.go:26)
DEFAULT_CONTROL_PORT = 8888         # constants.go:29
DEFAULT_DKG_TIMEOUT = 10            # seconds, FastSync (constants.go:35)
DEFAULT_GENESIS_OFFSET = 1          # seconds (constants.go:44)
DEFAULT_RESHARING_OFFSET = 30       # seconds (constants.go:50)
MAX_WAIT_PREPARE_DKG = 24 * 7 * 2 * 3600   # constants.go:39
CALL_MAX_TIMEOUT = 10               # seconds, setup calls (constants.go:52)


def default_config_folder() -> str:
    return os.path.join(os.path.expanduser("~"), DEFAULT_CONFIG_FOLDER_NAME)


@dataclass
class Config:
    """All daemon knobs, with the reference's defaults.  Python keyword
    arguments replace Go's functional options (config.go:130-297)."""

    folder: str = field(default_factory=default_config_folder)
    db_engine: str = "sqlite"           # sqlite | memdb | postgres
    memdb_size: int = 2000
    pg_dsn: str = ""                    # postgres connection string
    private_listen: str = "127.0.0.1:0"  # node-to-node gRPC bind
    public_listen: str = ""              # REST edge bind ("" = disabled)
    control_port: int = DEFAULT_CONTROL_PORT
    metrics_port: Optional[int] = None   # None = disabled; 0 = ephemeral
    tls_cert: Optional[str] = None
    tls_key: Optional[str] = None
    trusted_certs: tuple = ()
    insecure: bool = True                # no TLS (test networks)
    # identity plane (net/identity.py): a cert dir holding
    # node.key/node.crt/ca.crt switches the node-to-node AND control
    # planes to mutual TLS with hot-reloadable per-node certs; None (the
    # default, env DRAND_IDENTITY_DIR in the CLI) keeps every plane
    # exactly as before.  reload_interval rate-limits the cert-dir sweep;
    # expiry_grace is the metered warning window an expired cert keeps
    # serving through (0 = module defaults).
    identity_dir: Optional[str] = None
    identity_reload_interval: float = 0.0
    identity_expiry_grace: float = 0.0
    _identity: Optional[object] = field(default=None, init=False,
                                        repr=False, compare=False)
    _authority: Optional[object] = field(default=None, init=False,
                                         repr=False, compare=False)
    dkg_timeout: int = DEFAULT_DKG_TIMEOUT
    dkg_kickoff_grace: float = 1.0       # leader wait before phase 1
    reshare_offset: int = DEFAULT_RESHARING_OFFSET
    clock: Clock = field(default_factory=RealClock)
    # called with (beacon_id, group) after a successful DKG — the daemon
    # uses it to register public HTTP handlers (drand_daemon.go:61-71)
    dkg_callback: Optional[Callable] = None
    use_device_verifier: bool = True     # partials checked on the card
    sync_chunk: int = 512
    # resident verify service (crypto/verify_service.py): ONE daemon-owned
    # pipeline that every verify consumer submits to.  verify_pad is the
    # canonical coalesced batch width and verify_pipeline_depth how many
    # dispatches stay enqueued ahead of the resolve point; 0 = AUTO —
    # resolved per handle via crypto/tuning.py (DRAND_VERIFY_PAD /
    # DRAND_VERIFY_PIPELINE_DEPTH env > TUNING.json for the current
    # platform > the 8192x1 defaults, so a no-chip container is
    # unchanged).  verify_window is how long an under-filled BACKGROUND
    # batch may wait for co-riders before flushing; live work always
    # flushes immediately.
    verify_pad: int = 0
    verify_pipeline_depth: int = 0
    verify_window: float = 0.02
    # multi-device scale-out (crypto/device_pool.py): the visible devices
    # partition into this many groups, each with its own dispatch stream
    # and chain→device handle affinity; 0 = AUTO (DRAND_VERIFY_DEVICE_
    # GROUPS env, else one group per device).  Single submissions of at
    # least verify_shard_threshold rounds shard over the FULL pool's
    # persistent round-axis mesh instead of one group; 0 = AUTO
    # (DRAND_VERIFY_SHARD_THRESHOLD env, else pad x max(2, n_devices)).
    verify_device_groups: int = 0
    verify_shard_threshold: int = 0
    # device failure domain (verify_service watchdog/failover/probe):
    # watchdog deadline = max(floor, factor * observed p99 dispatch
    # latency); the probe interval rate-limits the canary that re-promotes
    # a degraded device backend.  0 = module default (itself overridable
    # via DRAND_VERIFY_WATCHDOG_FACTOR / DRAND_VERIFY_WATCHDOG_FLOOR /
    # DRAND_VERIFY_PROBE_INTERVAL).
    verify_watchdog_factor: float = 0.0
    verify_probe_interval: float = 0.0
    _verify_service: Optional[object] = field(default=None, init=False,
                                              repr=False, compare=False)
    # Committee-scale aggregation (beacon/handel.py): groups of
    # at least handel_min_group members aggregate partials over the
    # Handel binomial-tree overlay instead of the flat all-to-all fan-out
    # (0 = module default, env DRAND_HANDEL_MIN_GROUP, itself defaulting
    # to 129 so every existing small-committee deployment is unchanged).
    # fanout/window/bad_limit tune per-level peer selection, the scored
    # verification window, and Byzantine demotion; tick is the overlay
    # cadence in seconds (0 = derived from the beacon period).
    handel_min_group: int = 0
    handel_fanout: int = 0
    handel_window: int = 0
    handel_bad_limit: int = 0
    handel_tick: float = 0.0
    # serving-plane admission control (net/admission.py): one controller
    # per daemon, consulted by the gRPC listener, the REST edge and the
    # SyncChain streams.  0 = module default (env-overridable there via
    # the DRAND_ADMISSION_* family).  capacity is the total concurrency
    # token pool, critical_reserve the slots only partials/DKG may take;
    # shed/recover waits + dwell tune the hysteretic degradation ladder.
    admission_capacity: int = 0
    admission_critical_reserve: int = 0
    admission_max_streams_per_peer: int = 0
    admission_shed_wait: float = 0.0
    admission_recover_wait: float = 0.0
    admission_dwell: float = 0.0
    admission_pace_rate: float = 0.0
    rest_workers: int = 16              # REST edge worker-pool bound
    _admission: Optional[object] = field(default=None, init=False,
                                         repr=False, compare=False)
    # multi-tenant serving (core/tenancy.py): the tenant
    # registry — tenant → chains/weight/quotas/placement — persisted
    # atomically beside the multibeacon layout and editable over the
    # Control plane.  tenancy_device_window is the rolling window
    # (seconds) the device-time quota is measured over; 0 = module
    # default (DRAND_TENANT_DEVICE_WINDOW, else 30 s).
    tenancy_device_window: float = 0.0
    _tenancy: Optional[object] = field(default=None, init=False,
                                       repr=False, compare=False)
    # startup chain-integrity pass (chain/integrity.py): "off" trusts the
    # disk, "linkage" is the structural host-only scan (gaps, torn rows,
    # prev_sig linkage), "full" adds batched signature verification —
    # cheap on device, which is what makes it a startup option at all.
    # Corrupt rounds found are quarantined and re-fetched from peers in
    # the background (SyncManager.heal, under the sync budget).
    startup_integrity: str = "off"       # off | linkage | full
    # scheduled background integrity scans: rerun the
    # startup-style pass every N seconds on the daemon clock, submitting
    # verification through the service's BACKGROUND lane so live partials
    # preempt it at chunk boundaries.  0 = disabled.  The scheduled pass
    # uses the startup_integrity mode ("linkage" when that is "off").
    integrity_scan_interval: float = 0.0
    # resilience layer (net/resilience.py; every default is additionally
    # env-overridable there: DRAND_RETRY_*, DRAND_BREAKER_*, DRAND_SYNC_BUDGET)
    retry_max_attempts: int = 0          # 0 = module default
    retry_backoff_base: float = 0.0      # 0 = module default
    breaker_failures: int = 0            # consecutive failures before OPEN
    breaker_cooldown: float = 0.0        # seconds before a half-open probe
    sync_budget: float = 0.0             # overall budget of one sync pass

    def make_resilience(self, scope: str = "node"):
        """One shared policy per daemon: partial fan-out, sync peer
        selection, and DKG retries all feed the same per-peer breakers."""
        from ..net.resilience import (BackoffPolicy, BreakerRegistry,
                                      ResiliencePolicy)
        kw = {}
        if self.retry_backoff_base:
            kw["backoff"] = BackoffPolicy(base=self.retry_backoff_base)
        breg = {}
        if self.breaker_failures:
            breg["failures"] = self.breaker_failures
        if self.breaker_cooldown:
            breg["cooldown"] = self.breaker_cooldown
        return ResiliencePolicy(
            clock=self.clock,
            breakers=BreakerRegistry(clock=self.clock, scope=scope, **breg),
            **({"max_attempts": self.retry_max_attempts}
               if self.retry_max_attempts else {}),
            scope=scope, **kw)

    def verify_service(self):
        """The daemon-owned resident verify service, created on first use
        and bound to the daemon's injected clock.  Every BeaconProcess of
        this daemon (and its follow/sync planes) shares it, so partials,
        integrity scans, catch-up sync and client sweeps coalesce into
        the same device batches."""
        if self._verify_service is None:
            from ..crypto.verify_service import VerifyService
            self._verify_service = VerifyService(
                clock=self.clock, pad=self.verify_pad,
                background_window=self.verify_window,
                watchdog_factor=self.verify_watchdog_factor or None,
                probe_interval=self.verify_probe_interval or None,
                pipeline_depth=self.verify_pipeline_depth,
                device_groups=self.verify_device_groups,
                shard_threshold=self.verify_shard_threshold)
            # a service created while the admission ladder already has
            # background work paused must start paused, not race a level
            # change it never saw
            adm = self._admission
            if adm is not None and adm.background_paused():
                self._verify_service.set_background_paused(True)
            # tenant-aware placement + per-tenant device-time accounting
            self._verify_service.set_tenancy(self.tenancy())
        return self._verify_service

    def tenancy(self):
        """The daemon-owned tenant registry (core/tenancy.py), created on
        first use: persisted at `<folder>/multibeacon/tenants.json`,
        bound to the daemon clock, and wired so a Control-plane tenant
        change reaches both enforcement planes without a restart (the
        admission controller reads the registry live; the verify service
        re-applies placement via `rebalance_tenants`)."""
        if self._tenancy is None:
            from .tenancy import TenantRegistry, registry_path
            self._tenancy = TenantRegistry(
                path=registry_path(self.folder), clock=self.clock,
                device_window=self.tenancy_device_window)
            self._tenancy.on_change(self._on_tenancy_change)
        return self._tenancy

    def _on_tenancy_change(self) -> None:
        """Registry change listener: placement rebalance on the live
        service (never CREATE one — adding a tenant to an idle daemon
        must not spin up the verify pipeline as a side effect)."""
        svc = self._verify_service
        if svc is not None:
            svc.rebalance_tenants()

    def identity(self):
        """The daemon-owned identity plane (net/identity.py) when
        `identity_dir` is set, else None.  Created on first use, bound to
        the daemon clock so hot-reload sweeps and the expiry-grace window
        are deterministic under a FakeClock."""
        if self.identity_dir and self._identity is None:
            from ..net.identity import IdentityPlane
            kw = {}
            if self.identity_reload_interval:
                kw["reload_interval"] = self.identity_reload_interval
            if self.identity_expiry_grace:
                kw["expiry_grace"] = self.identity_expiry_grace
            self._identity = IdentityPlane(self.identity_dir,
                                           clock=self.clock, **kw)
        return self._identity

    def authority(self):
        """The daemon-owned token authority (core/authz.py), created on
        first use beside the tenant registry.  A daemon that never mints
        stays fileless and the admission path skips token work."""
        if self._authority is None:
            from .authz import TokenAuthority
            self._authority = TokenAuthority(
                os.path.join(self.folder, "multibeacon"), clock=self.clock)
        return self._authority

    def handel_config(self):
        """The overlay knob bundle (beacon/handel.py HandelConfig); zeros
        defer to the module's env-overridable defaults."""
        from ..beacon.handel import HandelConfig
        return HandelConfig(
            min_group=self.handel_min_group, fanout=self.handel_fanout,
            window=self.handel_window, bad_limit=self.handel_bad_limit,
            tick=self.handel_tick)

    def handel_min_group_size(self) -> int:
        """The group size from which partials aggregate over the Handel
        overlay: `handel_min_group`, else beacon/handel.py's default
        (env DRAND_HANDEL_MIN_GROUP, else 129), read here because the
        overlay itself is not ported."""
        return self.handel_min_group or int(
            os.environ.get("DRAND_HANDEL_MIN_GROUP", "129"))

    def admission(self):
        """The daemon-owned serving-plane admission controller
        (net/admission.py), created on first use and bound to the
        daemon's injected clock.  The gRPC listener, the REST edge and
        the SyncChain streams all consult this one controller; its
        degradation ladder pauses the verify service's background lane
        before any normal-class traffic is shed."""
        if self._admission is None:
            from ..net.admission import AdmissionController
            self._admission = AdmissionController(
                clock=self.clock,
                capacity=self.admission_capacity,
                critical_reserve=self.admission_critical_reserve,
                max_streams_per_peer=self.admission_max_streams_per_peer,
                shed_wait=self.admission_shed_wait,
                recover_wait=self.admission_recover_wait,
                dwell=self.admission_dwell,
                pace_rate=self.admission_pace_rate,
                background_hook=self._pause_background,
                tenancy=self.tenancy(),
                authority=self.authority())
        return self._admission

    def _pause_background(self, paused: bool) -> None:
        """Degradation-ladder hook: forward the pause to the verify
        service when one exists (never CREATE one here — a load spike on
        a daemon that has not needed verification yet must not spin up
        the whole pipeline as a side effect)."""
        svc = self._verify_service
        if svc is not None:
            svc.set_background_paused(paused)

    def stop_verify_service(self) -> None:
        """Tear the daemon-owned service down (scheduler + packer threads,
        cached backends).  Called from DrandDaemon.stop() — NOT from
        BeaconProcess.stop(), since every process of the daemon shares the
        one service.  Idempotent; a later verify_service() call builds a
        fresh one."""
        svc, self._verify_service = self._verify_service, None
        if svc is not None:
            svc.stop()

    def db_folder(self, beacon_id: str) -> str:
        from ..common import DEFAULT_BEACON_ID
        return os.path.join(self.folder, "multibeacon",
                            beacon_id or DEFAULT_BEACON_ID, DEFAULT_DB_FOLDER)
