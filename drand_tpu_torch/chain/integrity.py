"""Chain-integrity scan + quarantine: the chain-doctor core.

The port's copy of drand_tpu/chain/integrity.py, unchanged but for its
imports.  A stored chain is made re-verifiable:

  * **linkage mode** — structural host-only pass: round gaps, malformed
    signature encodings, and chained `previous_sig` linkage where the
    store materializes it.  O(n) dict/bytes work, no crypto.
  * **full mode** — linkage + batched signature verification.  The
    verifier is pluggable: a verify-service handle or
    `crypto.batch.BatchBeaconVerifier` runs whole chunks as one device RLC
    pairing check with bisect-to-culprit on failure,
    `crypto.hostverify.HostBatchVerifier` checks one round at a time on
    the host.

The scanner walks the RAW store through a cursor and carries the linkage
anchor itself (the previous row's stored signature), so it works on
trimmed-format stores (sqlite persists only (round, signature)) and on
full-beacon stores (memdb) alike.  Findings feed `quarantine` (tombstone
the bad rows, count them in metrics) and the repair path
(`beacon.sync.SyncManager.heal` re-fetches from breaker-ranked peers
under the sync budget).
"""

import hashlib
import json
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

from .beacon import Beacon
from .errors import ErrNoBeaconSaved, ErrNoBeaconStored

# finding kinds (the `kind` label on chain_integrity_corrupt_found_total)
MISSING = "missing"              # round absent from the store
INVALID_SIG = "invalid_signature"  # stored signature fails verification
UNLINKED = "unlinked"            # stored previous_sig breaks the chain walk
MALFORMED = "malformed"          # signature is not a valid point encoding

MODE_LINKAGE = "linkage"
MODE_FULL = "full"

DEFAULT_CHUNK = 512

# initial state of the rolling scan digest (a fixed domain-separation
# constant, so an empty-prefix checkpoint is distinguishable from junk)
_DIGEST_SEED = hashlib.sha256(b"drand-tpu-scan-digest-v1").hexdigest()


def _roll_digest(digest_hex: str, round_: int, sig: bytes) -> str:
    return hashlib.sha256(bytes.fromhex(digest_hex)
                          + round_.to_bytes(8, "big")
                          + bytes(sig)).hexdigest()


@dataclass(frozen=True)
class ScanCheckpoint:
    """Resumability watermark (ROADMAP item 6): the highest round R such
    that every round 1..R scanned CLEAN, plus a rolling digest over those
    rounds' (round, signature) pairs and the checkpoint row's own
    signature hash.  A scheduled scan resumes at R+1 after re-reading row
    R and matching `sig_sha` — the ONLY check a resume performs:
    re-verifying the whole prefix would cost the O(chain) pass
    resumability exists to skip, so a resume trusts the prefix on the
    strength of that one row.  A truncated, restored-from-backup, or
    row-R-rewritten store fails the match and triggers a full rescan; a
    prefix rewritten UNDER an intact row R is caught by the next
    full-walk trigger (the startup pass never resumes).  The rolling
    `digest` is carried forward as an audit fingerprint of the vouched
    prefix — comparable across scans, replicas, and backups by
    operators/tooling — and is deliberately NOT re-derived on resume.
    `mode` records what the prefix was proven AT: a full-crypto scan may
    resume from a full checkpoint only (a linkage checkpoint never had
    its signatures verified); a linkage scan resumes from either."""

    round: int
    digest: str      # rolling sha256 hex over the clean prefix
    sig_sha: str     # sha256 hex of row `round`'s signature bytes
    mode: str = MODE_FULL

    def to_json(self) -> str:
        return json.dumps({"round": self.round, "digest": self.digest,
                           "sig_sha": self.sig_sha, "mode": self.mode},
                          sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ScanCheckpoint":
        d = json.loads(text)
        return cls(round=int(d["round"]), digest=str(d["digest"]),
                   sig_sha=str(d["sig_sha"]),
                   mode=str(d.get("mode", MODE_FULL)))

    def covers(self, mode: str) -> bool:
        return self.mode == MODE_FULL or self.mode == mode


@dataclass(frozen=True)
class Finding:
    round: int
    kind: str
    detail: str = ""


@dataclass
class ScanReport:
    mode: str
    upto: int = 0
    scanned: int = 0
    verifier: str = "none"
    findings: List[Finding] = field(default_factory=list)
    # resumability: where this scan started (0 = genesis) and the new
    # watermark for the next scan (None when no clean prefix exists)
    resumed_from: int = 0
    checkpoint: Optional[ScanCheckpoint] = None

    @property
    def clean(self) -> bool:
        return not self.findings

    @property
    def faulty_rounds(self) -> List[int]:
        return sorted({f.round for f in self.findings})

    def rounds(self, kind: str) -> List[int]:
        return sorted({f.round for f in self.findings if f.kind == kind})

    @property
    def quarantinable_rounds(self) -> List[int]:
        """Rounds with a bad row on disk (missing rounds have nothing to
        delete, but still need re-fetching)."""
        return sorted({f.round for f in self.findings if f.kind != MISSING})

    def to_dict(self) -> dict:
        return {
            "mode": self.mode, "upto": self.upto, "scanned": self.scanned,
            "verifier": self.verifier, "clean": self.clean,
            "resumed_from": self.resumed_from,
            "findings": [{"round": f.round, "kind": f.kind,
                          "detail": f.detail} for f in self.findings],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def summary(self) -> str:
        if self.clean:
            return (f"clean: {self.scanned} beacons scanned up to round "
                    f"{self.upto} ({self.mode}/{self.verifier})")
        kinds = {}
        for f in self.findings:
            kinds[f.kind] = kinds.get(f.kind, 0) + 1
        parts = ", ".join(f"{k}={v}" for k, v in sorted(kinds.items()))
        return (f"{len(self.findings)} findings over {self.scanned} scanned "
                f"up to round {self.upto} ({parts})")


def verifier_kind(verifier) -> str:
    """host|device|none label for the metrics series.  Verifier classes
    self-describe via a `kind` attribute; anything unknown counts as host
    (it runs on this process's CPU by definition)."""
    if verifier is None:
        return "none"
    return getattr(verifier, "kind", "host")


class IntegrityScanner:
    """Scan one store against one chain identity (scheme + genesis seed).

    `verifier` must expose `verify_batch(rounds, sigs, prev_sigs) ->
    bool array` (BatchBeaconVerifier or HostBatchVerifier); it is only
    required for full-mode scans."""

    def __init__(self, store, scheme, verifier=None,
                 genesis_seed: Optional[bytes] = None,
                 chunk: int = DEFAULT_CHUNK, beacon_id: str = "default",
                 trigger: str = "startup"):
        self.store = store
        self.scheme = scheme
        self.verifier = verifier
        self.genesis_seed = genesis_seed
        self.chunk = max(1, chunk)
        self.beacon_id = beacon_id
        # metrics label: what started this scan (startup | scheduled |
        # manual) — a daemon rerunning the pass on integrity_scan_interval
        # or an operator's check-chain RPC must be distinguishable from
        # the boot-time pass in one scrape
        self.trigger = trigger

    # -- scanning ------------------------------------------------------------

    def scan(self, mode: str = MODE_FULL, upto: Optional[int] = None,
             progress: Optional[Callable[[int, int], None]] = None,
             resume: Optional[ScanCheckpoint] = None) -> ScanReport:
        """Walk rounds 1..upto (default: the store head) and report every
        integrity violation.  Emits per-chunk `progress(done, upto)` and
        the chain_integrity_* metrics counters.

        `resume` skips the already-proven clean prefix: the checkpoint
        row is re-read and its signature hash must match, else the scan
        silently falls back to a full walk (`report.resumed_from` says
        which happened).  Every scan emits a fresh `report.checkpoint`
        advancing the watermark over the rounds that scanned clean."""
        from ..metrics import integrity_beacons_scanned, integrity_corrupt_found
        if mode not in (MODE_LINKAGE, MODE_FULL):
            raise ValueError(f"unknown scan mode {mode!r}")
        if mode == MODE_FULL and self.verifier is None:
            raise ValueError("full-mode scan needs a verifier")
        vfy_kind = (verifier_kind(self.verifier)
                    if mode == MODE_FULL else "none")
        report = ScanReport(mode=mode, verifier=vfy_kind)

        try:
            head = self.store.last().round
        except ErrNoBeaconStored:
            # An empty store is only trivially clean when the caller did
            # not name a target: with an explicit `upto`, zero rows means
            # rounds 1..upto are MISSING (a fully truncated chain is the
            # at-rest disaster this scanner exists for) — fall through so
            # the tail-gap loop below flags them.
            head = 0
        report.upto = upto if upto is not None else head

        sig_len = self.scheme.sig_group.point_len
        anchor = self._anchor()                 # signature of round 0
        prev_sig: Optional[bytes] = anchor
        prev_round = 0
        digest = _DIGEST_SEED
        start_round = 1
        if resume is not None and resume.covers(mode) \
                and 1 <= resume.round <= report.upto:
            row = self._checkpoint_row(resume, sig_len)
            if row is not None:
                # clean prefix re-anchored: resume right after it
                prev_sig = row.signature
                prev_round = resume.round
                digest = resume.digest
                start_round = resume.round + 1
                report.resumed_from = resume.round
        buf: List[Beacon] = []
        buf_prevs: List[Optional[bytes]] = []
        unverified = set()      # rounds whose signature never reached verify
        unflushed = 0           # rounds examined since the last flush —
                                # counts malformed/unlinked rows too, which
                                # never enter the verify buffer

        def flush(done_round: int) -> None:
            nonlocal unflushed
            if buf:
                self._verify_chunk(report, buf, buf_prevs, mode)
                buf.clear()
                buf_prevs.clear()
            if unflushed:
                integrity_beacons_scanned.labels(
                    self.beacon_id, vfy_kind, self.trigger).inc(unflushed)
                unflushed = 0
            # watermark: commit only while the scan is STILL clean — the
            # first finding freezes the checkpoint at the previous flush,
            # so the next resume re-examines everything from there on
            if not report.findings and prev_round >= 1 \
                    and prev_sig is not None:
                report.checkpoint = ScanCheckpoint(
                    prev_round, digest,
                    hashlib.sha256(prev_sig).hexdigest(), mode)
            if progress is not None:
                progress(done_round, report.upto)

        cur = self.store.cursor()
        b = _cursor_seek(cur, start_round)
        while b is not None and b.round <= report.upto:
            r = b.round
            if r > prev_round + 1:
                for gap in range(prev_round + 1, r):
                    report.findings.append(Finding(gap, MISSING))
                # the walk anchor is lost across a hole; fall back to the
                # store's own previous_sig below when it has one
                prev_sig = None
            report.scanned += 1
            unflushed += 1
            sig = b.signature
            well_formed = len(sig) == sig_len
            if not well_formed:
                # torn write: the row exists but is not a point encoding
                unverified.add(r)
                report.findings.append(Finding(
                    r, MALFORMED,
                    f"signature is {len(sig)} bytes, want {sig_len}"))
            elif self.scheme.chained:
                if b.previous_sig is not None and prev_sig is not None \
                        and r == prev_round + 1 and b.previous_sig != prev_sig:
                    report.findings.append(Finding(
                        r, UNLINKED,
                        "stored previous_sig does not match round "
                        f"{r - 1}'s stored signature"))
                use_prev = prev_sig if prev_sig is not None else b.previous_sig
                if use_prev is None:
                    # hole below on a trimmed store: the digest cannot be
                    # rebuilt, so the round cannot be proven valid — flag
                    # it for re-fetch rather than vouch for it blindly
                    unverified.add(r)
                    report.findings.append(Finding(
                        r, UNLINKED,
                        "previous signature unavailable (hole below)"))
                else:
                    buf.append(b)
                    buf_prevs.append(use_prev)
            else:
                buf.append(b)
                buf_prevs.append(None)
            # a torn row can't anchor the next round's linkage
            prev_sig = sig if well_formed else None
            prev_round = r
            if well_formed:
                digest = _roll_digest(digest, r, sig)
            if len(buf) >= self.chunk:
                flush(r)
            b = cur.next()
        for gap in range(prev_round + 1, report.upto + 1):
            report.findings.append(Finding(gap, MISSING))
        flush(report.upto)

        self._reclassify_corrupt_anchors(report, unverified)
        for f in report.findings:
            integrity_corrupt_found.labels(self.beacon_id, f.kind,
                                           self.trigger).inc()
        report.findings.sort(key=lambda f: (f.round, f.kind))
        return report

    def _reclassify_corrupt_anchors(self, report: ScanReport,
                                    unverified: set) -> None:
        """A chained round that failed verification against an anchor that
        is itself corrupt or unproven is not PROVABLY invalid — its own
        bytes may be intact and only the round below rotted.  Report it as
        UNLINKED (unprovable; re-fetch to decide) instead of INVALID_SIG.
        Failures cascade upward only until the first passing round: a
        round that verifies against its stored anchor vouches for that
        anchor (the group signed exactly that digest)."""
        if not self.scheme.chained:
            return
        # rounds whose stored signature is corrupt or was never proven —
        # precomputed, so the INVALID_SIG→UNLINKED rewrite below doesn't
        # stop the cascade at the rewritten round
        unreliable = unverified | {
            f.round for f in report.findings if f.kind == INVALID_SIG}
        for i, f in enumerate(report.findings):
            if f.kind == INVALID_SIG and f.round - 1 in unreliable:
                report.findings[i] = Finding(
                    f.round, UNLINKED,
                    f"failed verification against round {f.round - 1}'s "
                    "signature, which is itself corrupt/unproven — not "
                    "provably invalid; re-fetch to decide")

    def _checkpoint_row(self, resume: ScanCheckpoint,
                        sig_len: int) -> Optional[Beacon]:
        """Re-read the checkpoint row and demand its signature hash still
        matches; None (= full rescan) when the row vanished, changed, or
        is malformed.  One point read buys skipping the whole prefix."""
        try:
            row = self.store.get(resume.round)
        except Exception:
            return None
        if row is None or len(row.signature) != sig_len:
            return None
        if hashlib.sha256(row.signature).hexdigest() != resume.sig_sha:
            return None
        return row

    def _anchor(self) -> Optional[bytes]:
        """Round 1's previous signature: the stored genesis beacon (round
        0 carries the genesis seed as its signature) or the configured
        genesis seed."""
        if not self.scheme.chained:
            return None
        try:
            return self.store.get(0).signature
        except Exception:
            return self.genesis_seed

    def _verify_chunk(self, report: ScanReport, chunk: Sequence[Beacon],
                      prevs: Sequence[Optional[bytes]], mode: str) -> None:
        if mode != MODE_FULL or not chunk:
            return
        ok = self.verifier.verify_batch(
            [b.round for b in chunk],
            [b.signature for b in chunk],
            list(prevs))
        for b, good in zip(chunk, ok):
            if not good:
                report.findings.append(Finding(b.round, INVALID_SIG))

    # -- quarantine ----------------------------------------------------------

    def quarantine(self, report_or_rounds) -> List[int]:
        """Remove the corrupt rows from serving; returns the rounds
        acted on.  Two-phase (ROADMAP item 6): rows are TOMBSTONED to the
        store's quarantine side table when the backend supports it — the
        bytes survive, so an intact-but-unprovable successor can be
        promoted back once its anchor is restored (`SyncManager.heal`'s
        promote pass) instead of re-downloaded.  Backends without a side
        table fall back to the old destructive delete.  Missing rounds
        are skipped (nothing on disk); the repair path re-fetches the
        union of quarantined + missing."""
        from ..metrics import integrity_quarantined
        if isinstance(report_or_rounds, ScanReport):
            rounds = report_or_rounds.quarantinable_rounds
        else:
            rounds = sorted(set(report_or_rounds))
        deleted = []
        tomb = getattr(self.store, "tombstone", None)
        for r in rounds:
            if tomb is not None:
                try:
                    if tomb(r):
                        deleted.append(r)
                        continue
                except Exception:
                    pass    # side table unavailable: destructive fallback
            try:
                self.store.get(r)
            except (ErrNoBeaconSaved, ErrNoBeaconStored):
                continue    # no row on disk (engines no-op missing
                            # deletes, which would inflate the metric)
            except Exception:
                pass        # row exists but won't materialize (e.g.
                            # ErrMissingPrevious on a strict store): delete
            try:
                self.store.delete(r)
                deleted.append(r)
            except Exception:
                pass
        if deleted:
            integrity_quarantined.labels(self.beacon_id).inc(len(deleted))
        return deleted


def _cursor_seek(cur, round_: int):
    """seek(1) that tolerates a stored genesis row at round 0."""
    b = cur.seek(round_)
    while b is not None and b.round < round_:
        b = cur.next()
    return b
