"""Store interface + cursor (chain/store.go:16-56,82-92).

The port's copy of drand_tpu/chain/store.py, unchanged but for its imports.

Stores hold the beacon chain ordered by round.  All methods are synchronous;
engines guard their own state (the beacon engine calls them from multiple
threads).

Durability / consistency contract (every backend declares where it sits
via the `DURABILITY` class attribute; tests/test_chain.py pins the matrix):

  * ``volatile``   — contents die with the process (memdb).  `put` is
    atomic w.r.t. concurrent readers but nothing survives a crash.
  * ``crash-safe`` — a `put`/`put_many`/`delete` that returned has been
    committed through a journal and survives a PROCESS crash (sqlitedb
    under WAL).  With `synchronous=NORMAL` an OS/power failure may lose a
    tail of recently-committed transactions but can never tear one: the
    store reopens to some clean prefix of commit order, which the
    integrity scan + peer repair path re-fills.
  * ``server``     — durability is delegated to an external database's
    own guarantees (postgresdb).

Shared semantics all backends must honour (the cross-backend contract
suite enforces them):

  * `put` of an already-stored round is a no-op or an equal-content
    overwrite — never an error.  Callers that need replace-with-different
    -content (the repair path) must `delete` first.
  * `get`/`last` raise the Err* types below; they never return torn or
    half-written rows.
  * `put_many` writes the batch in ONE transaction where the engine has
    transactions: after a crash either none or a prefix-in-commit-order
    of the batch is visible, never an interleaving.  Caveat (memdb): the
    ring buffer has no transactions, so its `put_many` is per-put atomic
    only — a CONCURRENT READER can observe a partially-applied batch
    (crash atomicity is moot: the store is volatile).  Irrelevant for
    the append path (the ring ingests one head at a time) but a repair
    writer + an iterating reader on memdb can see a half-healed chain;
    re-scan after repair, as `heal` does, rather than assuming batch
    visibility.
  * Trimmed-format engines (sqlite, postgres) reconstruct `previous_sig`
    from round-1 when `require_previous=True`; if that prior row is
    absent they raise `ErrMissingPrevious` instead of fabricating a
    beacon that cannot re-verify.  Round 1 is exempt — its anchor is the
    genesis seed (chain metadata), not a stored row.
  * **Two-phase quarantine** (`tombstone`/`tombstoned`/`drop_tombstone`):
    a row flagged by the integrity scan is MOVED to a quarantine side
    table, not destroyed — it disappears from every normal read
    (`get`/`last`/cursors/`len`) but its bytes are retained, so an
    intact-but-unPROVABLE row (UNLINKED: its anchor rotted, not its own
    bytes) can be promoted back once the anchor is restored, instead of
    re-downloaded from peers.  Durable engines keep the side table on
    disk; the base implementation keeps it in process memory (volatile
    backends lose tombstones with the process, which costs at most a
    re-fetch).  `tombstone` of an absent round returns False;
    `drop_tombstone` is idempotent.
"""

import struct
from abc import ABC, abstractmethod
from typing import Iterator, Optional

from .beacon import Beacon


def round_to_bytes(r: int) -> bytes:
    """8-byte fixed-length big-endian round key (store.go:82)."""
    return struct.pack(">Q", r)


def bytes_to_round(b: bytes) -> int:
    return struct.unpack(">Q", b)[0]


class Cursor(ABC):
    """Iterates beacons in ascending round order."""

    @abstractmethod
    def first(self) -> Optional[Beacon]: ...

    @abstractmethod
    def next(self) -> Optional[Beacon]: ...

    @abstractmethod
    def seek(self, round_: int) -> Optional[Beacon]: ...

    @abstractmethod
    def last(self) -> Optional[Beacon]: ...

    def __iter__(self) -> Iterator[Beacon]:
        b = self.first()
        while b is not None:
            yield b
            b = self.next()


class Store(ABC):
    """Beacon chain storage (chain/store.go:16-24).

    See the module docstring for the durability/consistency contract that
    `DURABILITY` and `put_many` are part of."""

    DURABILITY = "volatile"

    @abstractmethod
    def __len__(self) -> int: ...

    @abstractmethod
    def put(self, beacon: Beacon) -> None: ...

    def put_many(self, beacons) -> None:
        """Store a batch of beacons; engines with transactions override
        this with a single-transaction write (see the module contract)."""
        for b in beacons:
            self.put(b)

    @abstractmethod
    def last(self) -> Beacon:
        """Raises ErrNoBeaconStored when empty."""

    @abstractmethod
    def get(self, round_: int) -> Beacon:
        """Raises ErrNoBeaconSaved when absent."""

    @abstractmethod
    def cursor(self) -> Cursor: ...

    @abstractmethod
    def close(self) -> None: ...

    @abstractmethod
    def delete(self, round_: int) -> None: ...

    # -- two-phase quarantine (see the module contract) ----------------------

    def tombstone(self, round_: int) -> bool:
        """Move `round_` to the quarantine side table; True when a row
        was moved.  Base implementation: in-memory side dict over
        get+delete (durable engines override with a real side table that
        also captures rows a strict `get` refuses to materialize)."""
        try:
            b = self.get(round_)
        except Exception:
            return False
        self.delete(round_)
        self._tombs()[round_] = Beacon(round=b.round, signature=b.signature,
                                       previous_sig=b.previous_sig)
        return True

    def tombstoned(self, round_: int) -> Optional[Beacon]:
        """The quarantined row's retained bytes, or None."""
        return self._tombs().get(round_)

    def drop_tombstone(self, round_: int) -> None:
        self._tombs().pop(round_, None)

    def _tombs(self) -> dict:
        # lazily attached: Store is an ABC whose subclasses don't all
        # call super().__init__()
        t = getattr(self, "_tombstone_rows", None)
        if t is None:
            t = self._tombstone_rows = {}
        return t

    def save_to(self, fileobj) -> None:
        """Stream a backup of the full store (chain/store.go:24).

        Default: hexjson lines in round order (engines may override with a
        native snapshot)."""
        cur = self.cursor()
        for b in cur:
            fileobj.write(b.to_json() + b"\n")
