"""In-memory ring-buffer store (chain/memdb/store.go:15-198).

The port's copy of drand_tpu/chain/memdb.py, unchanged but for its imports.

Keeps at most `buffer_size` newest beacons, sorted by round; duplicate
rounds are ignored.  Used for stateless nodes that bootstrap their chain
head from peers at startup (core/drand_beacon.go:484-529).
"""

import bisect
import threading

from ..common import make_rlock
from typing import Optional

from .beacon import Beacon
from .errors import ErrNoBeaconSaved, ErrNoBeaconStored
from .store import Cursor, Store


class MemDBStore(Store):
    DURABILITY = "volatile"
    MIN_BUFFER = 10

    def __init__(self, buffer_size: int = 2000):
        if buffer_size < self.MIN_BUFFER:
            raise ValueError(
                f"in-memory buffer size cannot be smaller than {self.MIN_BUFFER},"
                f" got {buffer_size} (recommended at least 2000)")
        self._lock = make_rlock()
        self._rounds: list = []     # sorted round numbers
        self._beacons: list = []    # parallel list of Beacons
        self._buffer_size = buffer_size

    def __len__(self) -> int:
        with self._lock:
            return len(self._beacons)

    def put(self, beacon: Beacon) -> None:
        with self._lock:
            i = bisect.bisect_left(self._rounds, beacon.round)
            if i < len(self._rounds) and self._rounds[i] == beacon.round:
                return  # duplicate rounds are a no-op (store.go:53-57)
            self._rounds.insert(i, beacon.round)
            self._beacons.insert(i, beacon)
            if len(self._beacons) > self._buffer_size:
                trim = len(self._beacons) - self._buffer_size
                del self._rounds[:trim]
                del self._beacons[:trim]

    def last(self) -> Beacon:
        with self._lock:
            if not self._beacons:
                raise ErrNoBeaconStored()
            return self._beacons[-1]

    def get(self, round_: int) -> Beacon:
        with self._lock:
            i = bisect.bisect_left(self._rounds, round_)
            if i < len(self._rounds) and self._rounds[i] == round_:
                return self._beacons[i]
            raise ErrNoBeaconSaved()

    def delete(self, round_: int) -> None:
        with self._lock:
            i = bisect.bisect_left(self._rounds, round_)
            if i < len(self._rounds) and self._rounds[i] == round_:
                del self._rounds[i]
                del self._beacons[i]

    def close(self) -> None:
        pass

    def cursor(self) -> Cursor:
        return _MemCursor(self)


class _MemCursor(Cursor):
    def __init__(self, store: MemDBStore):
        self._store = store
        self._pos = -1

    def _snapshot(self):
        with self._store._lock:
            return list(self._store._beacons)

    def first(self) -> Optional[Beacon]:
        self._pos = 0
        return self._at()

    def next(self) -> Optional[Beacon]:
        self._pos += 1
        return self._at()

    def last(self) -> Optional[Beacon]:
        snap = self._snapshot()
        self._pos = len(snap) - 1
        return snap[-1] if snap else None

    def seek(self, round_: int) -> Optional[Beacon]:
        with self._store._lock:
            self._pos = bisect.bisect_left(self._store._rounds, round_)
        return self._at()

    def _at(self) -> Optional[Beacon]:
        snap = self._snapshot()
        if 0 <= self._pos < len(snap):
            return snap[self._pos]
        return None
