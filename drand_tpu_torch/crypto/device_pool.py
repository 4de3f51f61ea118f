"""Device pool: inventory, per-handle device groups, and the pool-wide
round-axis placement of the verify service.

The port's copy of drand_tpu/crypto/device_pool.py:

  * **Per-handle device groups.**  The visible CUDA devices are partitioned
    into `n_groups` groups (`DRAND_VERIFY_DEVICE_GROUPS`; 0 = AUTO, one
    group per device) and every `VerifyService` handle is assigned one:
    sticky chain->device affinity, least-loaded at assignment, so k cards
    run k dispatch streams instead of sharing one.  A group whose device
    faults is marked and new work avoids it; its handles fail over to a
    healthy sibling group before falling to the host.
  * **Pool-wide round-axis placement.**  An ordered list of every device
    for huge batches (catch-up sync, integrity scans): the verifier splits
    a chunk's rounds into one contiguous shard a device, runs each shard's
    stages up to its partial point sums there, and adds the partial sums on
    the first device (crypto/batch.py), the counterpart of the JAX pool's
    round-axis `NamedSharding`.

`cuda_devices()` is the one place the port enumerates devices, cached for
the process.  What the JAX pool calls a sharding is here a placement: None
(no devices: nothing to pin), one `torch.device`, or an ordered list of
them (`build_round_sharding`); the method names stay the reference's.  A
pool may also be built from explicit devices, `DevicePool(devices=[...])`,
the CPU included: the CPU tests run the service's device handles on
`DevicePool(devices=[torch.device("cpu")])`.
"""

import os
from typing import Dict, List, Optional, Tuple

from ..common import make_lock

DEFAULT_GROUPS = int(os.environ.get("DRAND_VERIFY_DEVICE_GROUPS", "0"))

GROUP_HEALTHY = "healthy"
GROUP_FAULTED = "faulted"
GROUP_PROBING = "probing"

_inventory_lock = make_lock()
_inventory: Optional[list] = None


def cuda_devices() -> list:
    """The CUDA devices of this process, enumerated once and cached (the
    JAX pool's `jax_devices`).  [] when torch sees no GPU; an enumeration
    that raises is not cached, so the next caller retries."""
    global _inventory
    with _inventory_lock:
        if _inventory is not None:
            return list(_inventory)
    try:
        import torch
        devs = ([torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
                if torch.cuda.is_available() else [])
    except Exception:
        return []
    with _inventory_lock:
        if _inventory is None:
            _inventory = devs
        return list(_inventory)


def _reset_inventory_for_tests(devices=None) -> None:
    """Test hook: override (or clear) the cached inventory."""
    global _inventory
    with _inventory_lock:
        _inventory = list(devices) if devices is not None else None


def build_round_sharding(devices):
    """The one place a round-axis placement is built: None for no devices
    (nothing to pin), the device itself for one, the ordered list for
    several (the verifier shards a chunk's rounds over them)."""
    devices = list(devices)
    if not devices:
        return None
    if len(devices) == 1:
        return devices[0]
    return devices


def placement_devices(placement) -> list:
    """The devices of a placement, in order ([] for None)."""
    if placement is None:
        return []
    if isinstance(placement, (list, tuple)):
        return list(placement)
    return [placement]


class DeviceGroup:
    """One failure/dispatch domain: a slice of the device inventory with a
    placement built once (one device, an ordered list for several, None
    for a deviceless host group)."""

    __slots__ = ("gid", "devices", "state", "faulted_at", "probe_backend",
                 "probe_sample", "_placement", "_placement_built")

    def __init__(self, gid: int, devices: list):
        self.gid = gid
        self.devices = list(devices)
        self.state = GROUP_HEALTHY
        self.faulted_at: Optional[float] = None
        # the canary context stashed when the group faults: the backend
        # that was serving on it and its last known-good 1-lane sample
        self.probe_backend = None
        self.probe_sample = None
        self._placement = None
        self._placement_built = False

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def sharding(self):
        """This group's placement, built once."""
        if not self._placement_built:
            self._placement = build_round_sharding(self.devices)
            self._placement_built = True
        return self._placement

    def __repr__(self):
        return (f"DeviceGroup(gid={self.gid}, devices={self.n_devices}, "
                f"state={self.state})")


class DevicePool:
    """Owns the device inventory and the handle->group assignment map.

    Assignment is sticky (chain->device affinity: a chain's verifier keeps
    its tensors on its group's devices) and least-loaded among HEALTHY
    groups at creation time; `release` drops an assignment so handle churn
    rebalances: the next assignment fills the emptied group.
    """

    def __init__(self, n_groups: int = 0, devices: Optional[list] = None):
        devs = list(devices) if devices is not None else cuda_devices()
        want = int(n_groups) if n_groups and int(n_groups) > 0 \
            else (DEFAULT_GROUPS or 0)
        if want <= 0:
            want = max(1, len(devs))        # AUTO: one group per device
        want = max(1, min(want, max(1, len(devs))))
        self.groups: List[DeviceGroup] = []
        if devs:
            base, extra = divmod(len(devs), want)
            lo = 0
            for g in range(want):
                hi = lo + base + (1 if g < extra else 0)
                self.groups.append(DeviceGroup(g, devs[lo:hi]))
                lo = hi
        else:
            self.groups.append(DeviceGroup(0, []))  # deviceless host group
        self._devices = devs
        self._assignments: Dict[Tuple, int] = {}
        # keys whose handles never dispatch on the group's devices (host
        # fallback handles): they keep a stream affinity but must not
        # weigh on the least-loaded placement of real device chains
        self._weightless: set = set()
        # tenant-aware placement: per-key weight (a weight-3 tenant's chain
        # loads a group 3x as much as a weight-1 chain) and the key's
        # tenant label for anti-affinity and the snapshot
        self._weights: Dict[Tuple, float] = {}
        self._tenants: Dict[Tuple, str] = {}
        self._lock = make_lock()
        self._pool_placement = None
        self._pool_placement_built = False

    # -- inventory ------------------------------------------------------------

    @property
    def devices(self) -> list:
        return list(self._devices)

    @property
    def n_devices(self) -> int:
        return len(self._devices)

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    def group(self, gid: int) -> DeviceGroup:
        return self.groups[gid]

    def healthy_groups(self) -> List[DeviceGroup]:
        return [g for g in self.groups if g.state == GROUP_HEALTHY]

    def pool_sharding(self):
        """ONE round-axis placement over the FULL pool, the huge-batch
        (catch-up sync / integrity scan) path: the ordered device list.
        None with fewer than 2 devices: one device gains nothing from
        splitting a chunk."""
        if not self._pool_placement_built:
            self._pool_placement = build_round_sharding(self._devices) \
                if len(self._devices) >= 2 else None
            self._pool_placement_built = True
        return self._pool_placement

    # -- assignment -----------------------------------------------------------

    def _loads_locked(self) -> Dict[int, float]:
        loads = {g.gid: 0.0 for g in self.groups}
        for key, gid in self._assignments.items():
            if key not in self._weightless:
                loads[gid] = loads.get(gid, 0.0) \
                    + self._weights.get(key, 1.0)
        return loads

    def assign(self, key, weigh: bool = True, tenant: Optional[str] = None,
               weight: float = 1.0, pin: Optional[int] = None,
               anti_affinity: bool = False) -> DeviceGroup:
        """Sticky least-loaded assignment, weight-proportional.  Healthy
        groups are preferred; with every group faulted the least-loaded
        one is used anyway (the service's own failover ladder handles the
        fault).  `weigh=False` grants a stream affinity without counting
        toward group load: host-fallback handles never dispatch on the
        devices, so they must not push device chains off a group.

        Tenant hints: `weight` scales this key's contribution to group
        load, `pin` forces a specific group (ignored when out of range; a
        FAULTED pinned group still pins, its failover is the service's
        ladder), and `anti_affinity` prefers a healthy group no OTHER
        tenant's keys occupy when one exists."""
        with self._lock:
            gid = self._assignments.get(key)
            if gid is not None:
                return self.groups[gid]
            if tenant is not None:
                self._tenants[key] = tenant
            self._weights[key] = max(0.0, float(weight))
            if pin is not None and 0 <= pin < len(self.groups):
                self._assignments[key] = pin
                if not weigh:
                    self._weightless.add(key)
                return self.groups[pin]
            loads = self._loads_locked()
            candidates = [g for g in self.groups
                          if g.state == GROUP_HEALTHY] or self.groups
            if anti_affinity and tenant is not None:
                empty = [g for g in candidates
                         if not any(gid == g.gid
                                    and self._tenants.get(k) != tenant
                                    and k not in self._weightless
                                    for k, gid in self._assignments.items())]
                if empty:
                    candidates = empty
            best = min(candidates, key=lambda g: (loads[g.gid], g.gid))
            self._assignments[key] = best.gid
            if not weigh:
                self._weightless.add(key)
            return best

    def reassign(self, key) -> Optional[DeviceGroup]:
        """Move `key` to the least-loaded HEALTHY group other than its
        current one (group failover: handle -> healthy sibling).  None when
        no healthy sibling exists: the caller falls to the host."""
        with self._lock:
            cur = self._assignments.get(key)
            loads = self._loads_locked()
            candidates = [g for g in self.groups
                          if g.state == GROUP_HEALTHY and g.gid != cur]
            if not candidates:
                return None
            best = min(candidates, key=lambda g: (loads[g.gid], g.gid))
            self._assignments[key] = best.gid
            return best

    def place(self, key, gid: int) -> None:
        """Force an assignment (the migrate-revert path: a failed sibling
        rebuild puts the affinity back where the backend still lives)."""
        with self._lock:
            self._assignments[key] = gid

    def release(self, key) -> None:
        """Drop an assignment (handle churn): the next `assign` call
        rebalances into the emptied group."""
        with self._lock:
            self._assignments.pop(key, None)
            self._weightless.discard(key)
            self._weights.pop(key, None)
            self._tenants.pop(key, None)

    def loads(self) -> Dict[int, float]:
        with self._lock:
            return self._loads_locked()

    def gid_of(self, key) -> Optional[int]:
        with self._lock:
            return self._assignments.get(key)

    def snapshot(self) -> dict:
        """Per-group view for stats(): device count, state, weighted handle
        load, and which tenants' chains live there."""
        with self._lock:
            loads = self._loads_locked()
            tenants = {g.gid: set() for g in self.groups}
            for key, gid in self._assignments.items():
                t = self._tenants.get(key)
                if t is not None and key not in self._weightless:
                    tenants.setdefault(gid, set()).add(t)
        return {g.gid: {"devices": g.n_devices, "state": g.state,
                        "handles": loads.get(g.gid, 0),
                        **({"tenants": sorted(tenants[g.gid])}
                           if tenants.get(g.gid) else {})}
                for g in self.groups}
