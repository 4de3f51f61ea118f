"""Crash-safe DKG/reshare lifecycle state: session journal + pending-
transition ledger.

The DKG/reshare plane was the last subsystem with zero crash tolerance:
`_adopt_reshare_output` used to overwrite the ACTIVE group/share files the
moment a reshare succeeded — minutes before the transition round — so a
node that crashed in that window restarted believing it had already
transitioned, signed pre-transition rounds with the wrong share, and had
destroyed its old share forever.  Exactly the non-atomic key/state
persistence hazard the beacon-client security review (arXiv:2109.11677)
ranks top of the consensus-client failure classes.

Two on-disk artifacts per beacon, both written atomically
(fs.write_atomic: temp + fsync + rename, like scan_checkpoint.json):

  * ``session.json`` — one record per DKG/reshare session: beacon id,
    epoch nonce (the group hash), role, kind, the phase reached, and the
    outcome.  A restart that finds ``outcome == "running"`` knows the
    previous process died mid-session: the session is unresumable (the
    in-memory generator state is gone), so it is finished as
    ``"aborted"`` and the beacon surfaces ``DKG_FAILED`` instead of
    wedging at IN_PROGRESS forever.
  * ``pending_transition.json`` — the ledger entry a successful reshare
    writes NEXT TO the staged group/share files (key/store.py
    ``*.staged``): old/new group hashes, the transition time, and sha256
    digests of the staged bytes.  The active files are only swapped when
    the handler's transition commits at the transition round, so the old
    share survives exactly as long as the chain still needs it.

Restart recovery (``recover``, called from BeaconProcess.load):

  * ledger present, node HAS an active (old) share → re-arm, regardless
    of the wall clock: the handler's transition gate is the only safe
    commit point, because it checks BOTH ``now >= transition_time`` and
    ``next_to_sign >= transition_round`` — committing on wall time alone
    would destroy the old share while the chain head may still sit below
    the transition round (a stalled old-key segment can only be finished
    with OLD shares; see Handler._maybe_transition).  A restart long
    after the handover simply catch-up-syncs the missing rounds and the
    armed swap fires the moment the head crosses the boundary.
  * ledger present, NO active share (newcomer): ``now <
    transition_time`` re-arms the ``_start_at_transition`` waiter;
    ``now >= transition_time`` commits immediately and starts with
    catchup — a newcomer has no old share to protect and nothing to
    serve pre-transition.
  * staged files missing/tampered (digest mismatch, unparseable, group
    hash != ledger) → discard the ledger + staged files and keep the old
    state; the reshare outcome is lost but the node stays consistent.

Commit is idempotent: each staged file is promoted by rename, and a
replayed commit (crash mid-commit) treats an already-promoted file —
active digest == ledger digest — as done.

The port's copy of drand_tpu/core/dkg_journal.py, unchanged but for its imports.
"""

import hashlib
import json
import os
from dataclasses import dataclass
from typing import Optional

from .. import fs
from ..log import Logger

# session phases, in order (the `dkg_phase` gauge encodes the index)
PHASE_IDLE = "idle"
PHASE_SETUP = "setup"
PHASE_DEAL = "deal"
PHASE_RESPONSE = "response"
PHASE_JUSTIFICATION = "justification"
PHASE_ADOPT = "adopt"
PHASES = (PHASE_IDLE, PHASE_SETUP, PHASE_DEAL, PHASE_RESPONSE,
          PHASE_JUSTIFICATION, PHASE_ADOPT)

# session outcomes
RUNNING = "running"
SUCCESS = "success"
FAILED = "failed"
ABORTED = "aborted"          # crash-restart found the session mid-flight

DKG_FOLDER = "dkg"
SESSION_FILE = "session.json"
LEDGER_FILE = "pending_transition.json"


def phase_index(phase: str) -> int:
    try:
        return PHASES.index(phase)
    except ValueError:
        return 0


def _sha256_file(path: str) -> Optional[str]:
    try:
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    except OSError:
        return None


@dataclass
class SessionRecord:
    """One DKG/reshare session as the journal saw it."""

    beacon_id: str
    kind: str                    # "dkg" | "reshare"
    role: str                    # "leader" | "follower"
    nonce: str = ""              # group-hash epoch, hex ("" until known)
    phase: str = PHASE_SETUP
    outcome: str = RUNNING
    started_at: float = 0.0
    updated_at: float = 0.0

    def to_json(self) -> str:
        return json.dumps(self.__dict__, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "SessionRecord":
        d = json.loads(text)
        return cls(beacon_id=str(d["beacon_id"]), kind=str(d["kind"]),
                   role=str(d["role"]), nonce=str(d.get("nonce", "")),
                   phase=str(d.get("phase", PHASE_SETUP)),
                   outcome=str(d.get("outcome", RUNNING)),
                   started_at=float(d.get("started_at", 0.0)),
                   updated_at=float(d.get("updated_at", 0.0)))


@dataclass
class PendingTransition:
    """Ledger entry for a reshare output staged but not yet committed."""

    beacon_id: str
    old_group_hash: str          # hex; "" for a newcomer with no old state
    new_group_hash: str
    transition_time: int
    has_share: bool              # False = leaver: staged group, no share
    staged_group_sha: str
    staged_share_sha: str = ""   # "" when has_share is False
    staged_at: float = 0.0

    def to_json(self) -> str:
        return json.dumps(self.__dict__, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "PendingTransition":
        d = json.loads(text)
        return cls(beacon_id=str(d["beacon_id"]),
                   old_group_hash=str(d.get("old_group_hash", "")),
                   new_group_hash=str(d["new_group_hash"]),
                   transition_time=int(d["transition_time"]),
                   has_share=bool(d["has_share"]),
                   staged_group_sha=str(d["staged_group_sha"]),
                   staged_share_sha=str(d.get("staged_share_sha", "")),
                   staged_at=float(d.get("staged_at", 0.0)))


@dataclass
class RecoveryResult:
    """What `recover` decided at daemon load time."""

    action: str                  # "none" | "rearm" | "committed" | "discarded"
    pending: Optional[PendingTransition] = None
    group: Optional[object] = None       # staged key.Group (rearm/committed)
    share: Optional[object] = None       # staged key.Share or None (leaver)
    aborted_session: Optional[SessionRecord] = None
    detail: str = ""


class DKGJournal:
    """Per-beacon journal over one FileStore's disk layout.

    All writes are atomic; all reads tolerate a missing or torn file
    (a torn journal is discarded, never trusted)."""

    def __init__(self, file_store, clock=None):
        self.fs = file_store
        self.clock = clock
        self.dir = fs.create_secure_folder(
            os.path.join(file_store.base, DKG_FOLDER))
        self.session_path = os.path.join(self.dir, SESSION_FILE)
        self.ledger_path = os.path.join(self.dir, LEDGER_FILE)

    def _now(self) -> float:
        return float(self.clock.now()) if self.clock is not None else 0.0

    # -- session journal -----------------------------------------------------

    def begin(self, kind: str, role: str, nonce: bytes = b"") -> SessionRecord:
        rec = SessionRecord(beacon_id=self.fs.beacon_id, kind=kind,
                            role=role, nonce=nonce.hex(),
                            phase=PHASE_SETUP, outcome=RUNNING,
                            started_at=self._now(), updated_at=self._now())
        self._write_session(rec)
        return rec

    def set_nonce(self, nonce: bytes) -> None:
        rec = self.load_session()
        if rec is not None:
            rec.nonce = nonce.hex()
            self._write_session(rec)

    def phase(self, phase: str) -> None:
        rec = self.load_session()
        if rec is not None:
            rec.phase = phase
            rec.updated_at = self._now()
            self._write_session(rec)

    def finish(self, outcome: str) -> None:
        rec = self.load_session()
        if rec is not None:
            rec.outcome = outcome
            rec.updated_at = self._now()
            self._write_session(rec)

    def load_session(self) -> Optional[SessionRecord]:
        try:
            with open(self.session_path, "r", encoding="utf-8") as f:
                return SessionRecord.from_json(f.read())
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def _write_session(self, rec: SessionRecord) -> None:
        fs.write_atomic(self.session_path, rec.to_json().encode())

    # -- pending-transition ledger -------------------------------------------

    def stage_transition(self, old_group, new_group, new_share
                         ) -> PendingTransition:
        """Land a successful reshare's output in the STAGED files + the
        ledger.  The active group/share are untouched: the old share keeps
        signing until the transition round, and a crash anywhere in here
        leaves either no ledger (reshare outcome lost, state consistent)
        or a complete one (recovery re-arms the swap)."""
        self.fs.save_group(new_group, staged=True)
        if new_share is not None:
            self.fs.save_share(new_share, staged=True)
        pending = PendingTransition(
            beacon_id=self.fs.beacon_id,
            old_group_hash=old_group.hash().hex() if old_group else "",
            new_group_hash=new_group.hash().hex(),
            transition_time=int(new_group.transition_time),
            has_share=new_share is not None,
            staged_group_sha=_sha256_file(self.fs.staged_group_file) or "",
            staged_share_sha=(_sha256_file(self.fs.staged_share_file) or ""
                              if new_share is not None else ""),
            staged_at=self._now())
        # the ledger is written LAST: it is the commit point of staging —
        # a ledger always points at complete staged files
        fs.write_atomic(self.ledger_path, pending.to_json().encode())
        return pending

    def load_pending(self) -> Optional[PendingTransition]:
        try:
            with open(self.ledger_path, "r", encoding="utf-8") as f:
                return PendingTransition.from_json(f.read())
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def verify_staged(self, pending: PendingTransition):
        """Validate the staged files against the ledger.  Returns the
        parsed (group, share) on success, None on any mismatch — missing
        file, digest drift, unparseable TOML, or a staged group whose
        hash is not the one the ledger recorded.  A file that was already
        PROMOTED by a crashed commit (active digest == ledger digest)
        counts as valid; commit() will skip it."""
        group = share = None
        sha = _sha256_file(self.fs.staged_group_file)
        promoted = sha is None \
            and _sha256_file(self.fs.group_file) == pending.staged_group_sha
        if sha is not None and sha != pending.staged_group_sha:
            return None
        if sha is None and not promoted:
            return None
        try:
            group = self.fs.load_group(staged=not promoted)
        except Exception:
            return None
        if group is None or group.hash().hex() != pending.new_group_hash:
            return None
        if pending.has_share:
            ssha = _sha256_file(self.fs.staged_share_file)
            spromoted = ssha is None \
                and _sha256_file(self.fs.share_file) == pending.staged_share_sha
            if ssha is not None and ssha != pending.staged_share_sha:
                return None
            if ssha is None and not spromoted:
                return None
            try:
                share = self.fs.load_share(staged=not spromoted)
            except Exception:
                return None
            if share is None:
                return None
        return group, share

    def commit_pending(self) -> bool:
        """Promote the staged files over the active ones and clear the
        ledger.  Idempotent: a commit replayed after a crash promotes
        whatever is still staged and clears the ledger.  Returns True
        when a ledger existed."""
        pending = self.load_pending()
        if pending is None:
            return False
        if pending.has_share:
            self.fs.promote_staged_share()
        else:
            # leaver: not a member of the new group — the (now useless)
            # old share is removed with the group promotion so a restart
            # does not believe it still serves this chain
            self.fs.promote_staged_group()
            try:
                if os.path.exists(self.fs.share_file):
                    os.remove(self.fs.share_file)
            except OSError:
                pass
            self._clear_ledger()
            return True
        self.fs.promote_staged_group()
        self._clear_ledger()
        return True

    def discard_pending(self) -> None:
        """Abort path: drop the staged files AND the ledger (order
        matters the other way around here — a ledger pointing at deleted
        staged files is exactly the tamper case recovery discards, so
        remove the ledger first)."""
        self._clear_ledger()
        self.fs.discard_staged()

    def _clear_ledger(self) -> None:
        try:
            os.remove(self.ledger_path)
        except FileNotFoundError:
            pass

    def clear_session(self) -> None:
        try:
            os.remove(self.session_path)
        except FileNotFoundError:
            pass


def recover(journal: DKGJournal, clock, log: Optional[Logger] = None
            ) -> RecoveryResult:
    """Daemon-load recovery: resolve a crashed session and a pending
    transition into one of the four actions documented in the module
    docstring.  Pure function of (journal state, clock) — chaos and the
    tier-1 recovery matrix drive exactly this entry point."""
    log = log or Logger("dkg-recover")
    aborted = None
    rec = journal.load_session()
    if rec is not None and rec.outcome == RUNNING:
        # the previous process died mid-session; the generator state is
        # gone, so the session cannot be resumed — only reported
        rec.outcome = ABORTED
        journal.finish(ABORTED)
        aborted = rec
        log.warn("dkg session aborted by restart", kind=rec.kind,
                 phase=rec.phase, nonce=rec.nonce[:16])

    pending = journal.load_pending()
    if pending is None:
        return RecoveryResult(action="none", aborted_session=aborted)
    staged = journal.verify_staged(pending)
    if staged is None:
        log.warn("pending-transition ledger invalid (staged files "
                 "missing or tampered); discarding, keeping old state",
                 new_group=pending.new_group_hash[:16])
        journal.discard_pending()
        return RecoveryResult(action="discarded", pending=pending,
                              aborted_session=aborted,
                              detail="staged files missing or tampered")
    group, share = staged
    # immediate commit is the NEWCOMER-only fast path: a running member
    # holds an old share the chain may still need (its head can lag the
    # transition round), so it always re-arms and lets the handler's
    # time+round dual gate decide when to commit
    is_member = journal.fs.load_share() is not None \
        and journal.fs.load_group() is not None
    if not is_member and clock.now() >= pending.transition_time:
        journal.commit_pending()
        log.info("pending reshare transition committed at load",
                 transition_time=pending.transition_time)
        return RecoveryResult(action="committed", pending=pending,
                              group=group, share=share,
                              aborted_session=aborted)
    log.info("pending reshare transition re-armed",
             transition_time=pending.transition_time,
             past_transition=clock.now() >= pending.transition_time)
    return RecoveryResult(action="rearm", pending=pending,
                          group=group, share=share,
                          aborted_session=aborted)
