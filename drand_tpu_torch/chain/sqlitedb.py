"""Durable embedded store on sqlite — the boltdb-equivalent engine.

The port's copy of drand_tpu/chain/sqlitedb.py, unchanged but for its imports.

Uses the reference's *trimmed* format (chain/boltdb/trimmed.go:20-322): only
(round, signature) is persisted; `previous_sig` is reconstructed from round-1
on read when the caller asks for it (chained schemes need it to re-derive the
digest; unchained schemes never do).  One table keyed by round — the direct
analogue of boltdb's single `beacons` bucket keyed by be64(round)
(chain/boltdb/store.go:24-329).
"""

import sqlite3
import threading

from ..common import make_rlock
from typing import Optional

from .beacon import Beacon
from .errors import ErrMissingPrevious, ErrNoBeaconSaved, ErrNoBeaconStored
from .store import Cursor, Store

# how long a writer waits on a competing writer's lock before SQLITE_BUSY
# surfaces as an exception (a second process — the doctor CLI — may hold
# the db while the daemon runs)
BUSY_TIMEOUT_MS = 5_000


class SqliteStore(Store):
    DURABILITY = "crash-safe"

    def __init__(self, path: str, require_previous: bool = False):
        """`require_previous`: reconstruct previous_sig on reads (set for
        chained schemes; chain/beacon.go:90-97 context flag).  When the
        prior round is absent, reads raise ErrMissingPrevious — see the
        chain/store.py contract.

        Durability discipline: WAL journal (readers never block the
        writer, a crash mid-commit rolls back to the last complete
        transaction) + `synchronous=NORMAL` (fsync on WAL checkpoints,
        not on every commit — a process crash loses nothing, an OS crash
        may lose a tail of recent commits but never tears one)."""
        self._conn = sqlite3.connect(path, check_same_thread=False,
                                     timeout=BUSY_TIMEOUT_MS / 1000.0)
        self._lock = make_rlock()
        self.require_previous = require_previous
        with self._lock:
            # pragmas first: the table create below should already ride WAL
            self._conn.execute(f"PRAGMA busy_timeout={BUSY_TIMEOUT_MS}")
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA synchronous=NORMAL")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS beacons ("
                " round INTEGER PRIMARY KEY,"
                " signature BLOB NOT NULL)")
            # two-phase quarantine side table (chain/store.py contract):
            # corrupt rows are MOVED here, not destroyed, so an
            # unprovable-but-intact row can be promoted back once its
            # anchor is restored instead of re-downloaded
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS quarantine ("
                " round INTEGER PRIMARY KEY,"
                " signature BLOB NOT NULL)")
            self._conn.commit()

    def __len__(self) -> int:
        with self._lock:
            (n,) = self._conn.execute("SELECT COUNT(*) FROM beacons").fetchone()
            return n

    def put(self, beacon: Beacon) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO beacons (round, signature) VALUES (?, ?)",
                (beacon.round, beacon.signature))
            self._conn.commit()

    def put_many(self, beacons) -> None:
        """Batched insert in ONE transaction: either the whole batch
        commits or none of it does (sync stores a verified chunk at a
        time — a crash must not leave half a chunk)."""
        with self._lock:
            try:
                self._conn.executemany(
                    "INSERT OR REPLACE INTO beacons (round, signature)"
                    " VALUES (?, ?)",
                    [(b.round, b.signature) for b in beacons])
            except BaseException:
                self._conn.rollback()
                raise
            self._conn.commit()

    def _fill_previous(self, round_: int, signature: bytes) -> Beacon:
        prev = None
        if self.require_previous and round_ > 0:
            # caller holds self._lock: get/last and the cursor all enter
            # with it held; this helper is never called bare
            row = self._conn.execute(
                "SELECT signature FROM beacons WHERE round = ?",
                (round_ - 1,)).fetchone()
            if row is None:
                # Round 1 anchors on the genesis SEED, which lives outside
                # the store — an absent round-0 row is normal, and the
                # caller supplies the seed.  Any other absent prior row is
                # a hole: raise instead of fabricating a beacon that can
                # never re-verify (chain/store.py contract).
                if round_ > 1:
                    raise ErrMissingPrevious(round_)
            else:
                prev = bytes(row[0])
        return Beacon(round=round_, signature=bytes(signature), previous_sig=prev)

    def last(self) -> Beacon:
        with self._lock:
            row = self._conn.execute(
                "SELECT round, signature FROM beacons"
                " ORDER BY round DESC LIMIT 1").fetchone()
            if row is None:
                raise ErrNoBeaconStored()
            return self._fill_previous(row[0], row[1])

    def get(self, round_: int) -> Beacon:
        with self._lock:
            row = self._conn.execute(
                "SELECT signature FROM beacons WHERE round = ?",
                (round_,)).fetchone()
            if row is None:
                raise ErrNoBeaconSaved()
            return self._fill_previous(round_, row[0])

    def delete(self, round_: int) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM beacons WHERE round = ?", (round_,))
            self._conn.commit()

    def tombstone(self, round_: int) -> bool:
        """Move the row to the quarantine table in ONE transaction — raw
        SQL on purpose: a strict-previous get() would refuse to
        materialize exactly the torn rows quarantine exists for."""
        with self._lock:
            try:
                cur = self._conn.execute(
                    "INSERT OR REPLACE INTO quarantine (round, signature)"
                    " SELECT round, signature FROM beacons WHERE round = ?",
                    (round_,))
                moved = cur.rowcount > 0
                if moved:
                    self._conn.execute(
                        "DELETE FROM beacons WHERE round = ?", (round_,))
            except BaseException:
                self._conn.rollback()
                raise
            self._conn.commit()
            return moved

    def tombstoned(self, round_: int) -> Optional[Beacon]:
        with self._lock:
            row = self._conn.execute(
                "SELECT signature FROM quarantine WHERE round = ?",
                (round_,)).fetchone()
        if row is None:
            return None
        return Beacon(round=round_, signature=bytes(row[0]),
                      previous_sig=None)

    def drop_tombstone(self, round_: int) -> None:
        with self._lock:
            self._conn.execute(
                "DELETE FROM quarantine WHERE round = ?", (round_,))
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    def cursor(self) -> Cursor:
        return _SqliteCursor(self)

    def save_to(self, fileobj) -> None:
        """Native snapshot: the serialized sqlite image (BackupDatabase RPC,
        chain/store.go:24 SaveTo analogue).  Connection.serialize() needs
        Python 3.11; older runtimes snapshot through the online backup API
        into a temp file — same bytes, one extra disk round trip."""
        with self._lock:
            if hasattr(self._conn, "serialize"):
                # fold the WAL into the main image first, or commits since
                # the last checkpoint would be missing from the snapshot
                self._conn.execute("PRAGMA wal_checkpoint(TRUNCATE)")
                fileobj.write(self._conn.serialize())
                return
            import os
            import sqlite3
            import tempfile
            fd, tmp = tempfile.mkstemp(suffix=".db")
            os.close(fd)
            try:
                dst = sqlite3.connect(tmp)
                try:
                    self._conn.backup(dst)
                    dst.commit()
                finally:
                    dst.close()
                with open(tmp, "rb") as f:
                    fileobj.write(f.read())
            finally:
                os.unlink(tmp)


class _SqliteCursor(Cursor):
    def __init__(self, store: SqliteStore):
        self._store = store
        self._round: Optional[int] = None

    def _row_to_beacon(self, row) -> Optional[Beacon]:
        if row is None:
            self._round = None
            return None
        self._round = row[0]
        with self._store._lock:
            return self._store._fill_previous(row[0], row[1])

    def _query(self, sql, args=()):
        with self._store._lock:
            return self._store._conn.execute(sql, args).fetchone()

    def first(self) -> Optional[Beacon]:
        return self._row_to_beacon(self._query(
            "SELECT round, signature FROM beacons ORDER BY round ASC LIMIT 1"))

    def next(self) -> Optional[Beacon]:
        if self._round is None:
            return None
        return self._row_to_beacon(self._query(
            "SELECT round, signature FROM beacons WHERE round > ?"
            " ORDER BY round ASC LIMIT 1", (self._round,)))

    def seek(self, round_: int) -> Optional[Beacon]:
        return self._row_to_beacon(self._query(
            "SELECT round, signature FROM beacons WHERE round >= ?"
            " ORDER BY round ASC LIMIT 1", (round_,)))

    def last(self) -> Optional[Beacon]:
        return self._row_to_beacon(self._query(
            "SELECT round, signature FROM beacons ORDER BY round DESC LIMIT 1"))
