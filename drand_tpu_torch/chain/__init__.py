"""Chain core: beacon type, chain info, round/time math, stores and the
integrity scanner.

The port's copy of drand_tpu/chain/ without the postgres engine: beacons
are immutable dataclasses, stores are plain Python classes with an
abstract interface, and the durable engine is sqlite.
"""

from .beacon import Beacon, genesis_beacon
from .errors import ErrMissingPrevious, ErrNoBeaconStored, ErrNoBeaconSaved
from .info import Info
from .integrity import (Finding, IntegrityScanner, ScanReport,
                        MODE_FULL, MODE_LINKAGE)
from .timing import (TIME_OF_ROUND_ERROR, current_round, next_round,
                     time_of_round)
from .store import Cursor, Store, round_to_bytes, bytes_to_round
from .memdb import MemDBStore
from .sqlitedb import SqliteStore

__all__ = [
    "Beacon", "genesis_beacon", "Info",
    "ErrNoBeaconStored", "ErrNoBeaconSaved", "ErrMissingPrevious",
    "Finding", "IntegrityScanner", "ScanReport", "MODE_FULL", "MODE_LINKAGE",
    "TIME_OF_ROUND_ERROR", "time_of_round", "current_round", "next_round",
    "Store", "Cursor", "round_to_bytes", "bytes_to_round",
    "MemDBStore", "SqliteStore",
]
