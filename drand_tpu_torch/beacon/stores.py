"""Store decorator chain (chain/beacon/store.go:35-279).

The port's copy of drand_tpu/beacon/stores.py, unchanged but for its imports.

Assembled bottom-up as
    backend -> discrepancy (timing metrics) -> scheme (linkage rules)
            -> append (strict monotonic rounds) -> callback (subscribers)
exactly like chainstore.go:43-75.  Each decorator is itself a chain.Store.
"""

import queue
import threading

from ..common import make_lock
from typing import Callable, Dict, Optional

from ..chain.beacon import Beacon
from ..chain.store import Cursor, Store
from ..chain.timing import time_of_round
from ..chain.errors import ErrNoBeaconStored
from .clock import Clock


class ErrBeaconAlreadyStored(Exception):
    """Duplicate round put (store.go:53); racing writers treat it as benign."""


class _Decorator(Store):
    def __init__(self, inner: Store):
        self.inner = inner

    @property
    def DURABILITY(self):  # noqa: N802 — contract attribute (chain/store.py)
        """Decorators add semantics, not persistence: durability is
        whatever the wrapped backend provides."""
        return self.inner.DURABILITY

    def __len__(self):
        return len(self.inner)

    def put(self, beacon: Beacon) -> None:
        self.inner.put(beacon)

    def last(self) -> Beacon:
        return self.inner.last()

    def get(self, round_: int) -> Beacon:
        return self.inner.get(round_)

    def cursor(self) -> Cursor:
        return self.inner.cursor()

    def close(self) -> None:
        self.inner.close()

    def delete(self, round_: int) -> None:
        self.inner.delete(round_)

    # two-phase quarantine (chain/store.py contract): delegate so the
    # side table lives with the BACKEND, not per decorator layer
    def tombstone(self, round_: int) -> bool:
        return self.inner.tombstone(round_)

    def tombstoned(self, round_: int):
        return self.inner.tombstoned(round_)

    def drop_tombstone(self, round_: int) -> None:
        self.inner.drop_tombstone(round_)

    def save_to(self, fileobj) -> None:
        self.inner.save_to(fileobj)


class AppendStore(_Decorator):
    """Strict `round == last+1` appends; duplicates raise
    ErrBeaconAlreadyStored (store.go:35-77)."""

    def __init__(self, inner: Store):
        super().__init__(inner)
        self._lock = make_lock()
        try:
            self._last: Optional[Beacon] = inner.last()
        except ErrNoBeaconStored:
            self._last = None

    def put(self, beacon: Beacon) -> None:
        with self._lock:
            last = self._last
            if last is not None:
                if beacon.round <= last.round:
                    raise ErrBeaconAlreadyStored(
                        f"round {beacon.round} already stored (last {last.round})")
                if beacon.round != last.round + 1:
                    raise ValueError(
                        f"invalid round inserted: last {last.round}, new {beacon.round}")
            elif beacon.round != 0 and len(self.inner) > 0:
                raise ValueError("store not empty but last unknown")
            self.inner.put(beacon)
            self._last = beacon

    def delete(self, round_: int) -> None:
        """Deleting (e.g. a rolled-back head) must invalidate the cached
        last beacon or the round stays unwritable forever."""
        with self._lock:
            self.inner.delete(round_)
            try:
                self._last = self.inner.last()
            except ErrNoBeaconStored:
                self._last = None


class SchemeStore(_Decorator):
    """Linkage rules by scheme (store.go:80-124): chained beacons must carry
    previous_sig == last.signature; unchained beacons store no previous_sig."""

    def __init__(self, inner: Store, chained: bool):
        super().__init__(inner)
        self.chained = chained
        self._lock = make_lock()

    def put(self, beacon: Beacon) -> None:
        with self._lock:
            if self.chained:
                try:
                    last = self.inner.last()
                except ErrNoBeaconStored:
                    last = None
                if last is not None and beacon.round == last.round + 1 \
                        and beacon.previous_sig != last.signature:
                    raise ValueError(
                        f"invalid previous signature for round {beacon.round}")
            elif beacon.previous_sig is not None:
                beacon = Beacon(round=beacon.round, signature=beacon.signature)
            self.inner.put(beacon)


class DiscrepancyStore(_Decorator):
    """Records wall-clock discrepancy vs the expected round time
    (store.go:127-173; feeds beacon_discrepancy_latency)."""

    def __init__(self, inner: Store, clock: Clock, period: int, genesis: int,
                 on_discrepancy: Optional[Callable[[int, float], None]] = None):
        super().__init__(inner)
        self.clock = clock
        self.period = period
        self.genesis = genesis
        self.on_discrepancy = on_discrepancy
        self.last_discrepancy_ms: Optional[float] = None

    def put(self, beacon: Beacon) -> None:
        self.inner.put(beacon)
        expected = time_of_round(self.period, self.genesis, beacon.round)
        disc_ms = (self.clock.now() - expected) * 1000.0
        self.last_discrepancy_ms = disc_ms
        if self.on_discrepancy is not None:
            self.on_discrepancy(beacon.round, disc_ms)


class CallbackStore(_Decorator):
    """Fan-out of stored beacons to named subscribers, each served by its own
    worker thread with a bounded queue (store.go:176-279) — a slow consumer
    (HTTP watcher, sync stream) cannot stall the aggregator."""

    QUEUE_SIZE = 100

    def __init__(self, inner: Store):
        super().__init__(inner)
        self._lock = make_lock()
        self._subs: Dict[str, queue.Queue] = {}
        self._threads: Dict[str, threading.Thread] = {}

    def put(self, beacon: Beacon) -> None:
        self.inner.put(beacon)
        with self._lock:
            qs = list(self._subs.values())
        for q in qs:
            try:
                q.put_nowait(beacon)
            except queue.Full:
                pass  # slow subscriber drops ticks; sync repairs later

    def add_callback(self, id_: str, fn: Callable[[Beacon], None]) -> None:
        """Replaces any existing subscriber with the same id
        (sync_manager.go:542-560 re-request behavior)."""
        self.remove_callback(id_)
        q: queue.Queue = queue.Queue(maxsize=self.QUEUE_SIZE)

        def worker():
            while True:
                b = q.get()
                if b is None:
                    return
                try:
                    fn(b)
                except Exception:
                    pass

        t = threading.Thread(target=worker, daemon=True,
                             name=f"callback-{id_}")
        with self._lock:
            self._subs[id_] = q
            self._threads[id_] = t
        t.start()

    def remove_callback(self, id_: str) -> None:
        with self._lock:
            q = self._subs.pop(id_, None)
            t = self._threads.pop(id_, None)
        if q is not None:
            q.put(None)
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2)

    def close(self) -> None:
        with self._lock:
            ids = list(self._subs)
        for id_ in ids:
            self.remove_callback(id_)
        self.inner.close()
