"""Aggregator: collect validated partials, recover at threshold, verify,
append (chain/beacon/chainstore.go:24-333).

The port's copy of drand_tpu/beacon/chainstore.py.  A single aggregator
thread consumes validated partials from a queue (the reference's
`runAggregator` goroutine).  When a (round, prev_sig) cache reaches the
group threshold it verifies the partials it has not checked yet in one
batch (`partial_verifier`), Lagrange-recovers the full signature on the
host (tbls.Recover, chainstore.go:202), verifies it against the collective
key (chainstore.go:207) and appends through the decorator chain; the cache
is flushed on every store (partials for stored rounds are dead weight).

What changed from the reference is the device seam: `DevicePartialVerifier`
takes a `device` (CUDA unless "cpu", resolved at construction, so without a
card it raises) and pads its one row to the group's n slots, so every
aggregation-time check is one `(1, n)` block of
`crypto.partials.BatchPartialVerifier` whatever the number of unchecked
partials.  The port wires that check with no host fallback
(`node.device_verifier_factory`), so a check that raises is counted in
`beacon_partial_check_errors_total` and logged here; the reference
aggregator drops it unseen, its host fallback having redone the check.
"""

import logging
import queue
import threading

from ..common import make_condition
from typing import Callable, Optional

from ..chain.beacon import Beacon
from ..chain.errors import ErrNoBeaconSaved, ErrNoBeaconStored
from ..crypto.host import tbls
from ..crypto.vault import Vault
from .cache import PartialCache
from .clock import Clock
from .stores import (AppendStore, CallbackStore, DiscrepancyStore,
                     ErrBeaconAlreadyStored, SchemeStore)

log = logging.getLogger(__name__)


class HostPartialVerifier:
    """Serial host verification (the reference's per-packet path)."""

    kind = "host"

    def __init__(self, scheme, pub_poly):
        self.scheme = scheme
        self.pub_poly = pub_poly

    def verify(self, msg: bytes, partials):
        return [tbls.verify_partial(self.scheme, self.pub_poly, msg, p)
                for p in partials]


class DevicePartialVerifier:
    """Batched verification on the device (crypto/partials.py), the
    design's point: partials are validated in one RLC block at aggregation
    time instead of one 2-pairing check per packet (node.go:150).  The row
    is padded to `n_nodes` slots (a pad slot is invalid and costs no
    pairing), so every call has the shape (1 round, n slots); more
    partials than that are checked n at a time."""

    kind = "device"

    def __init__(self, scheme, pub_poly, n_nodes: int, device=None):
        from ..crypto.partials import BatchPartialVerifier
        self.n_nodes = n_nodes
        self._bv = BatchPartialVerifier(scheme, pub_poly, n_nodes,
                                        device=device)

    def verify(self, msg: bytes, partials):
        partials = list(partials)
        out = []
        for lo in range(0, len(partials), self.n_nodes):
            part = partials[lo:lo + self.n_nodes]
            row = part + [None] * (self.n_nodes - len(part))
            out += self._bv.verify_partials([msg], [row])[0][
                :len(part)].tolist()
        return out


class ChainStore:
    def __init__(self, backend, vault: Vault, clock: Clock, group,
                 on_sync_needed: Optional[Callable[[int], None]] = None,
                 on_discrepancy=None, partial_verifier=None,
                 beacon_id: str = "default"):
        """`backend`: raw chain.Store; `group`: key.Group (threshold, times).

        Decorator assembly mirrors chainstore.go:43-75.  Partials get their
        cryptographic check at aggregation time through `partial_verifier`
        (host serial when none is given; the Handler passes the one its
        config's factory builds, DevicePartialVerifier by default)."""
        self.vault = vault
        self.group = group
        self.beacon_id = beacon_id
        self.backend = backend      # raw store: integrity scans + repair
        self.partial_verifier = partial_verifier or HostPartialVerifier(
            vault.scheme, vault.get_pub())
        disc = DiscrepancyStore(backend, clock, group.period,
                                group.genesis_time, on_discrepancy)
        sch = SchemeStore(disc, vault.scheme.chained)
        self._append = AppendStore(sch)
        self.cbstore = CallbackStore(self._append)
        self.cache = PartialCache()
        self.on_sync_needed = on_sync_needed
        self._partials: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._new_beacon = make_condition()
        self._thread = threading.Thread(target=self._run_aggregator,
                                        daemon=True, name="aggregator")
        self._thread.start()

    # -- store facade (reads/writes go through the decorator chain) ---------

    @property
    def store(self):
        return self.cbstore

    def last(self) -> Beacon:
        return self.cbstore.last()

    def put(self, beacon: Beacon) -> None:
        self.cbstore.put(beacon)
        self._on_stored(beacon)

    def _on_stored(self, beacon: Beacon) -> None:
        self.cache.flush_rounds(beacon.round)
        with self._new_beacon:
            self._new_beacon.notify_all()

    def integrity_scan(self, verifier=None, mode: str = "full",
                       upto: Optional[int] = None, progress=None,
                       beacon_id: str = "default", chunk: int = 512,
                       trigger: str = "startup", resume=None):
        """Scan the RAW backend (below the decorators — corruption hides
        underneath them) against this chain's scheme + genesis seed.
        Returns a chain.integrity.ScanReport; pair with
        `SyncManager.heal` to quarantine + re-fetch what it finds.
        `resume` (a chain.integrity.ScanCheckpoint) skips the prefix a
        previous scan already proved clean."""
        from ..chain.integrity import IntegrityScanner
        return IntegrityScanner(
            self.backend, self.vault.scheme, verifier=verifier,
            genesis_seed=self.group.get_genesis_seed(), chunk=chunk,
            beacon_id=beacon_id, trigger=trigger).scan(mode=mode, upto=upto,
                                                       progress=progress,
                                                       resume=resume)

    def wait_for_round(self, round_: int, timeout: float,
                       scheduled_time: bool = False) -> Optional[Beacon]:
        """Block until the chain reaches `round_`.

        With ``scheduled_time=False`` (default) the timeout is plain wall
        time — what an RPC-deadline caller expects.

        ``scheduled_time=True`` (used by the test harness) makes the
        timeout *starvation-aware*: on a loaded box (e.g. sibling test
        workers cold-compiling XLA programs on the one host core) a 0.1 s
        condition wait can take seconds of wall time while this process is
        descheduled.  Charging raw wall time against the deadline makes
        tests flake exactly when the machine is busy — so each iteration
        charges at most 2x the requested wait, i.e. the deadline counts
        (mostly-)scheduled time.  A hard wall cap of 20x the timeout still
        bounds genuine deadlocks."""
        # The monotonic() reads below deliberately bypass the injected
        # clock: this loop measures raw WALL time to detect OS
        # descheduling (charged-vs-elapsed) — a FakeClock would defeat
        # the starvation-awareness that is its whole point.
        import time as _t
        charged = 0.0
        wall_cap = (20 if scheduled_time else 1) * timeout
        wall_deadline = _t.monotonic() + wall_cap
        while True:
            try:
                last = self.last()
                if last.round >= round_:
                    if last.round == round_:
                        return last
                    try:
                        return self.cbstore.get(round_)
                    except ErrNoBeaconSaved:
                        return None  # trimmed/skipped (e.g. memdb ring buffer)
            except ErrNoBeaconStored:
                pass
            if charged >= timeout or _t.monotonic() >= wall_deadline:
                return None
            step = min(timeout - charged, 0.1)
            t0 = _t.monotonic()
            with self._new_beacon:
                self._new_beacon.wait(step)
            charged += min(_t.monotonic() - t0, 2 * step)

    # -- aggregation ---------------------------------------------------------

    def new_valid_partial(self, round_: int, prev_sig: Optional[bytes],
                          partial: bytes) -> None:
        """Feed one ingress-validated partial (chainstore.go:106)."""
        self._partials.put((round_, prev_sig, partial))

    def aggregate_verified(self, round_: int, prev_sig: Optional[bytes],
                           partials) -> None:
        """Handel delivery (beacon/handel.py): the overlay hands over a
        set of partials it ALREADY batch-verified through the verify
        service.  The verdicts are recorded in the round cache keyed by
        exact bytes — the same structure the aggregator consults — so
        recovery proceeds without re-verifying, and a partial the flat
        path would have rejected can never sneak in (a pre-existing False
        verdict for the same bytes is never overwritten).  Insertion uses
        `put_verified`: a known-good partial may displace an UNVERIFIED
        squatter in its signer slot (an ingress forgery with a valid
        index would otherwise hold the slot until threshold-time
        verification pops it — after the overlay's delivery was already
        consumed, wedging the round at threshold-1).  Processing still
        rides the single aggregator thread."""
        for p in partials:
            self.cache.put_verified(round_, prev_sig, p)
            self._partials.put((round_, prev_sig, p))

    def _run_aggregator(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._partials.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                self._process_partial(*item)
            except Exception:
                pass

    def _process_partial(self, round_: int, prev_sig: Optional[bytes],
                         partial: bytes) -> None:
        try:
            last = self.cbstore.last()
        except ErrNoBeaconStored:
            return
        if round_ <= last.round:
            return  # already have that beacon
        rc = self.cache.append(round_, prev_sig, partial)
        thr = self.group.threshold
        if len(rc) < thr:
            return

        scheme = self.vault.scheme
        msg = scheme.digest_beacon(round_, prev_sig if scheme.chained else None)

        # Verify whatever the cache holds unchecked, in one batch (the
        # device-first move of node.go:150's per-packet pairing to
        # aggregation time).  Verdicts are keyed by the exact partial bytes: a dropped
        # invalid partial does not block a later honest partial from the
        # same signer index from being verified and used.
        unchecked = [p for p in rc.partials.values() if p not in rc.checked]
        if unchecked:
            try:
                results = self.partial_verifier.verify(msg, unchecked)
            except Exception:   # noqa: BLE001 — counted, logged, retried
                # nothing redoes the check on the host: the round waits
                # for its next partial, which checks the cache again
                from ..metrics import partial_check_errors
                partial_check_errors.labels(self.beacon_id).inc()
                log.exception("beacon %s: the check of %d partials of "
                              "round %d failed", self.beacon_id,
                              len(unchecked), round_)
                return
            for p, ok in zip(unchecked, results):
                if ok:
                    rc.checked[p] = True
                else:
                    rc.mark_bad(p)
                    # drop the slot only if it still holds THESE bytes —
                    # popping by index alone could evict a good partial
                    # that re-occupied the slot while this one verified
                    if rc.partials.get(tbls.index_of(p)) == p:
                        rc.partials.pop(tbls.index_of(p), None)
        good = [p for p in rc.partials.values() if rc.checked.get(p)]
        if len(good) < thr:
            return

        pub_poly = self.vault.get_pub()
        try:
            sig = tbls.recover(scheme, pub_poly, msg, good[:thr],
                               thr, len(self.group), verify_each=False)
        except ValueError:
            return
        pub = self.vault.public_key_bytes()
        if not scheme.verify_beacon(pub, round_, prev_sig, sig):
            # should be unreachable once partials are verified; drop and wait
            # for more honest partials (chainstore.go:207-218)
            rc.partials.clear()
            rc.checked.clear()
            return
        beacon = Beacon(round=round_, signature=sig, previous_sig=prev_sig)
        self._try_append(last, beacon)

    def _try_append(self, last: Beacon, beacon: Beacon) -> None:
        if last.round + 1 < beacon.round:
            # we aggregated a round ahead of our chain: sync the gap first
            if self.on_sync_needed is not None:
                self.on_sync_needed(beacon.round)
            return
        try:
            self.put(beacon)
        except ErrBeaconAlreadyStored:
            pass  # racing with the sync path is benign (chainstore.go:253-265)
        except ValueError:
            pass

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        self.cbstore.close()
