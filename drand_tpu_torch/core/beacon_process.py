"""BeaconProcess: one chain's full lifecycle inside a daemon
(reference: core/drand_beacon.go:31-614 + the DKG orchestration spread
across core/drand_beacon_control.go:41-624).

Owns keypair, group, share, the beacon Handler, the chain store and the
sync plane; drives DKG/reshare sessions over the network through the
EchoBroadcast board and the setup managers.

The port's copy of drand_tpu/core/beacon_process.py.  Where it differs, on
purpose:

  * `start_beacon` wires aggregation-time partial checks through
    `VerifyService.partials_factory(device_verifier_factory)` with no
    `fallback_factory`: a device error is counted in
    `beacon_partial_check_errors_total` and the round waits for catch-up
    (the reference redoes the check on the host).  With
    `use_device_verifier=False` the host factory is chosen as in the
    reference;
  * a group at or above the Handel size (`Config.handel_min_group_size()`)
    raises `NotImplementedError`, for the overlay (beacon/handel.py) is not
    ported: a DKG or reshare leader refuses it before its setup, a joiner
    as soon as the group reaches it, before the ceremony, and
    `start_beacon` before it builds anything (a group loaded from disk).
    Without the overlay `self.handel` stays None, so its RPC ingress
    answers "not active" and partials take the flat fan-out;
  * before it builds anything, `start_beacon` raises for a device chain on
    a machine without a card, as every device entry point of the port
    does;
  * `db_engine="postgres"` raises: chain/postgresdb.py is not ported.
"""

import os
import threading

from ..common import make_lock
from typing import Iterator, List, Optional

from ..beacon.node import (Handler, HandlerConfig, PartialBeaconPacket,
                           device_verifier_factory, _host_verifier_factory)
from ..beacon.sync import SyncChainServer, SyncManager
from ..chain.beacon import Beacon
from ..chain.errors import ErrNoBeaconStored
from ..chain.info import Info
from ..chain.memdb import MemDBStore
from ..chain.sqlitedb import SqliteStore
from ..crypto import dkg as D
from ..key.group import Group
from ..key.keys import Pair, Share
from ..key.store import FileStore
from ..log import Logger
from ..metrics import (ThresholdMonitor, beacon_discrepancy_latency,
                       dkg_phase_gauge, dkg_sessions, group_size,
                       group_threshold, last_beacon_round,
                       reshare_transition_pending)
from ..chain.timing import time_of_round
from ..net import Peer, ProtocolClient
from ..net import convert
from ..net.resilience import BreakerOpen, Deadline, DeadlineExceeded
from ..protos import drand_pb2 as pb
from . import dkg_journal as J
from .broadcast import EchoBroadcast
from .config import CALL_MAX_TIMEOUT, Config
from .dkg_journal import DKGJournal
from .dkg_runner import run_dkg_bounded
from .setup import (SetupManager, SetupReceiver, hash_secret, sign_group)

# DKG status enum (core/drand_status.go:36-101).  DKG_FAILED is the
# crash-hygiene terminal state: every aborted/failed session must land
# here — a beacon wedged at IN_PROGRESS can never accept a fresh InitDKG.
DKG_NOT_STARTED, DKG_WAITING, DKG_IN_PROGRESS, DKG_DONE = 0, 1, 2, 3
DKG_FAILED = 4

DKG_STATUS_NAMES = {DKG_NOT_STARTED: "not_started", DKG_WAITING: "waiting",
                    DKG_IN_PROGRESS: "in_progress", DKG_DONE: "done",
                    DKG_FAILED: "failed"}


class BeaconProcess:
    def __init__(self, cfg: Config, file_store: FileStore, beacon_id: str,
                 pair: Pair, client: ProtocolClient, log: Logger):
        self.cfg = cfg
        self.fs = file_store
        self.beacon_id = beacon_id or "default"
        self.pair = pair
        self.client = client
        self.log = log.named(self.beacon_id)
        self.clock = cfg.clock
        # one policy for everything this process does on the wire: the
        # client's (daemon-wide) when it has one, so partial-send failures
        # and sync failovers share per-peer breaker state
        self.resilience = getattr(client, "resilience", None) \
            or cfg.make_resilience(scope=self.beacon_id)
        self.group: Optional[Group] = None
        self.share: Optional[Share] = None
        self.handler: Optional[Handler] = None
        self.syncm: Optional[SyncManager] = None
        self.sync_server: Optional[SyncChainServer] = None
        self.store = None
        # committee-scale aggregation overlay (beacon/handel.py): not
        # ported, so always None; groups at its size are refused
        self.handel = None
        self.dkg_status = DKG_NOT_STARTED
        self.reshare_status = DKG_NOT_STARTED
        self.monitor: Optional[ThresholdMonitor] = None
        # live DKG session plumbing (filled during a session)
        self._setup_manager: Optional[SetupManager] = None
        self._setup_receiver: Optional[SetupReceiver] = None
        self._board: Optional[EchoBroadcast] = None
        # bundles that raced ahead of board creation (a peer can start
        # dealing the instant it has the group, before our board is up)
        self._pending_dkg: List[pb.DKGPacket] = []
        # crash-safe session lifecycle (core/dkg_journal.py): the on-disk
        # session journal + pending-transition ledger, the nonces of
        # aborted epochs (their late bundles are rejected, not parked),
        # and the staged (group, share) a restart re-arms at start_beacon
        self.journal = DKGJournal(file_store, clock=self.clock)
        self._failed_nonces: set = set()
        self._armed_transition = None      # (group, share) from recovery
        # transition waiters park on this instead of a never-set Event so
        # daemon stop() reaps them (the leaked transition-<id> thread fix)
        self._transition_stop = threading.Event()
        # scheduled background integrity scans (cfg.integrity_scan_interval)
        self._scan_stop: Optional[threading.Event] = None
        self._scan_thread: Optional[threading.Thread] = None
        self._repair_thread: Optional[threading.Thread] = None
        # integrity-scan resumability watermark (chain/integrity.py
        # ScanCheckpoint): in-memory always, persisted next to the sqlite
        # db so a restart resumes instead of rescanning from genesis
        self._scan_ckpt = None
        self._lock = make_lock()

    # -- persistence (drand_beacon.go:110-162) ------------------------------

    def load(self) -> bool:
        """Restore group + share from disk; True when this beacon has
        state to serve NOW.

        Crash recovery runs first (core/dkg_journal.py): a session the
        previous process died inside is finished as aborted (status
        DKG_FAILED, staged output discarded unless a complete ledger
        exists), and a pending reshare transition is resolved — committed
        immediately when the transition time has passed, re-armed for the
        handler swap (running member) or the transition waiter (newcomer)
        when it has not, discarded when the staged files are missing or
        tampered."""
        rec = J.recover(self.journal, self.clock, self.log)
        if rec.aborted_session is not None:
            ab = rec.aborted_session
            if ab.kind == "reshare":
                self.reshare_status = DKG_FAILED
            else:
                self.dkg_status = DKG_FAILED
            if ab.nonce:
                with self._lock:
                    self._failed_nonces.add(bytes.fromhex(ab.nonce))
            dkg_sessions.labels(self.beacon_id, ab.kind, J.ABORTED).inc()
            if rec.action == "none":
                # no ledger survived the crash: any staged partials are
                # unaccounted for — remove them so a later session cannot
                # confuse them with its own output
                self.fs.discard_staged()
        self.group = self.fs.load_group()
        if rec.action == "rearm":
            reshare_transition_pending.labels(self.beacon_id).set(1)
            self.reshare_status = DKG_DONE
            if self.fs.load_share() is not None and self.group is not None:
                # running member: serve the old state now, swap at the
                # transition round (armed by start_beacon)
                with self._lock:
                    self._armed_transition = (rec.group, rec.share)
            else:
                # newcomer: no old state to serve — adopt the staged
                # state in memory and join at the transition, committing
                # the ledger the moment the waiter fires
                self.group = rec.group
                self.share = rec.share
                self._start_at_transition(rec.group, commit=True)
                return False
        elif rec.action == "committed":
            # newcomer fast path: recover() promoted the active files
            # BEFORE the load_group() above, which therefore already read
            # the new epoch — nothing to re-read
            reshare_transition_pending.labels(self.beacon_id).set(0)
            self.reshare_status = DKG_DONE
        if self.group is None:
            return False
        self.share = self.fs.load_share()
        if self.share is not None:
            self.dkg_status = DKG_DONE
        elif self.dkg_status != DKG_FAILED:
            self.dkg_status = DKG_NOT_STARTED
        return self.share is not None

    # -- store / handler plumbing -------------------------------------------

    def _create_store(self):
        """Storage backend switch (drand_beacon.go:340-373):
        sqlite (bolt-equivalent embedded, default) | memdb | postgres."""
        if self.cfg.db_engine == "memdb":
            return MemDBStore(self.cfg.memdb_size)
        if self.cfg.db_engine == "postgres":
            raise NotImplementedError(
                "db engine 'postgres' needs chain/postgresdb.py, which the "
                "port does not have yet; use sqlite or memdb")
        if self.cfg.db_engine != "sqlite":
            raise ValueError(f"unknown db engine {self.cfg.db_engine!r}")
        db_dir = self.cfg.db_folder(self.beacon_id)
        os.makedirs(db_dir, mode=0o700, exist_ok=True)
        return SqliteStore(os.path.join(db_dir, "chain.db"))

    def chain_info(self) -> Optional[Info]:
        if self.group is None or self.group.public_key is None:
            return None
        return Info(public_key=self.group.public_key.key(),
                    period=self.group.period,
                    genesis_time=self.group.genesis_time,
                    genesis_seed=self.group.get_genesis_seed(),
                    scheme=self.group.scheme.id,
                    beacon_id=self.beacon_id)

    def dkg_lifecycle(self) -> dict:
        """The /health `dkg` block: statuses by name, the live session's
        phase, and whether a staged reshare awaits its transition."""
        out = {
            "status": DKG_STATUS_NAMES.get(self.dkg_status, "unknown"),
            "reshare": DKG_STATUS_NAMES.get(self.reshare_status, "unknown"),
        }
        rec = self.journal.load_session()
        if rec is not None and rec.outcome == J.RUNNING:
            out["phase"] = rec.phase
            out["kind"] = rec.kind
        pending = self.journal.load_pending()
        out["transition_pending"] = pending is not None
        if pending is not None:
            out["transition_time"] = pending.transition_time
            out["new_group"] = pending.new_group_hash[:16]
        return out

    def _peers(self, group: Optional[Group] = None) -> List[Peer]:
        g = group or self.group
        return [Peer(n.identity.addr, n.identity.tls) for n in g.nodes
                if n.identity.addr != self.pair.public.addr]

    def _broadcast_dispatch(self, packet: PartialBeaconPacket) -> None:
        """Handler broadcast hook: the Handel overlay above the committee
        threshold (our partial seeds the per-round session and travels up
        the tree), the flat all-to-all fan-out below it."""
        if self.handel is not None:
            self.handel.submit_own(packet.round, packet.previous_signature,
                                   packet.partial_sig)
            return
        self._broadcast_partial(packet)

    def _broadcast_partial(self, packet: PartialBeaconPacket) -> None:
        """Fan the partial out to every peer, one thread each
        (node.go:445-472); failures feed the threshold monitor.

        All sends share ONE deadline — the end of the round being built
        (a partial delivered after that is useless), so retries inside the
        client's resilience policy are budget-clamped instead of stacking
        per-call 60s timeouts.  When enough sends have terminally failed
        that the threshold cannot be met this round, gathering degrades to
        catchup-sync: peers that did aggregate will feed us the beacon."""
        proto = pb.PartialBeaconPacket(
            round=packet.round,
            previous_signature=packet.previous_signature or b"",
            partial_sig=packet.partial_sig,
            metadata=convert.metadata(self.beacon_id))
        peers = self._peers()
        round_end = time_of_round(self.group.period, self.group.genesis_time,
                                  packet.round + 1)
        # catchup rebroadcasts sign rounds whose end time is already past
        # (node.go:368-403): those sends get one catchup-period of budget,
        # not a degenerate already-expired deadline
        grace = float(max(self.group.catchup_period or self.group.period, 5))
        deadline = Deadline.at(self.clock,
                               max(round_end, self.clock.now() + grace))
        # we need threshold-1 partials from others on top of our own; once
        # more than len(peers) - (threshold-1) sends failed, this round's
        # gathering mathematically cannot reach the threshold
        degrade_at = len(peers) - (self.group.threshold - 1) + 1
        state = {"failed": 0}
        lock = make_lock()

        def send(peer: Peer):
            try:
                self.client.partial_beacon(peer, proto, deadline=deadline)
            except Exception as e:
                # a BreakerOpen fast-fail still counts toward the degrade
                # decision (the peer is unreachable on recent evidence) but
                # is not a NEW dial failure for the threshold monitor
                if self.monitor is not None \
                        and not isinstance(e, BreakerOpen):
                    self.monitor.report_failure(peer.address)
                self.log.debug("partial send failed", dest=peer.address,
                               err=str(e))
                with lock:
                    state["failed"] += 1
                    crossed = state["failed"] == degrade_at
                if crossed and degrade_at > 0:
                    self.log.warn("partial gathering cannot reach threshold; "
                                  "degrading to catchup sync",
                                  round=packet.round,
                                  failed=state["failed"])
                    self._on_sync_needed(packet.round)

        for peer in peers:
            # intentional fire-and-forget fan-out: the beacon loop must
            # not block on any peer; each send is bounded by the client
            # RPC timeout and exits
            # tpu-vet: disable=threadlife
            threading.Thread(target=send, args=(peer,), daemon=True,
                             name=f"partial-send-{packet.round}").start()

    def _check_handel_gate(self, n: int) -> None:
        """A group of `n` at Handel size aggregates over beacon/handel.py,
        which the port does not have: refuse it where its size is first
        known (a DKG's or reshare's setup, a loaded group's start), before
        any ceremony or transition runs."""
        gate = self.cfg.handel_min_group_size()
        if n >= gate:
            raise NotImplementedError(
                f"beacon {self.beacon_id}: a group of {n} nodes reaches the "
                f"Handel overlay (handel_min_group {gate}), and the port has "
                "no beacon/handel.py yet; run groups below that size")

    def handel_summary(self):
        """The /health `handel` block (None when the overlay is off)."""
        return self.handel.summary() if self.handel is not None else None

    def process_handel(self, req, peer: Optional[str] = None,
                       auth=None) -> None:
        """RPC ingress for drand.Protocol/HandelAggregate.  The future-
        round window check mirrors process_partial: without it a flood
        of far-future rounds would churn the coordinator's session cap
        and evict the LIVE round's aggregation state.  `peer` is the
        transport-level gRPC sender: the coordinator rejects packets
        whose claimed sender_index is registered at a different host
        (score demotion must not be griefable by
        impersonation).  `auth` (net/identity.py PeerIdentity, mTLS
        only) is the cert-backed identity: when present the binding is
        enforced on the cert's SAN set instead of the IP heuristic, so
        DNS-named rosters get enforcement too."""
        if self.handel is None:
            raise ValueError("handel overlay not active")
        if self.handler is not None:
            next_round = self.handler.ticker.current_round() + 1
            if req.round > next_round:
                raise ValueError(
                    f"handel aggregate for future round {req.round} "
                    f"(next {next_round})")
        self.handel.receive(req, peer=peer, auth=auth)

    def start_beacon(self, catchup: bool) -> None:
        """Create store + handler + sync plane and start the round loop
        (drand_beacon.go:240-268, newBeacon :375)."""
        with self._lock:
            if self.handler is not None:
                return
            assert self.group is not None and self.share is not None
            self._check_handel_gate(len(self.group))
            if self.cfg.use_device_verifier:
                # no card and no "cpu": raises, before the store opens
                from ..crypto.batch import resolve_device
                resolve_device(None)
            self.store = self._create_store()
            # ONE daemon-owned verify pipeline for everything this chain
            # verifies: aggregation-time partials ride the LIVE lane
            # (preempting background work at chunk boundaries), while the
            # sync plane / integrity scans below share the BACKGROUND lane
            # of the same service
            verify_svc = self.cfg.verify_service()
            # no host fallback for the device check: a device error is
            # counted (beacon_partial_check_errors_total) and the round
            # waits for catch-up, so a broken card shows
            verifier_factory = verify_svc.partials_factory(
                device_verifier_factory if self.cfg.use_device_verifier
                else _host_verifier_factory)
            self.monitor = ThresholdMonitor(self.beacon_id, self.log,
                                            self.group.threshold)
            self.monitor.start()
            handler_cfg = HandlerConfig(
                group=self.group,
                share=self.share,
                index=self.share.private.index,
                store=self.store,
                clock=self.clock,
                verifier_factory=verifier_factory,
                broadcast=self._broadcast_dispatch,
                on_sync_needed=self._on_sync_needed,
                beacon_id=self.beacon_id)
            self.handler = Handler(handler_cfg)
            self.sync_server = SyncChainServer(self.handler.chain)
            sync_verifier = verify_svc.handle(
                self.group.scheme, self.group.public_key.key(),
                device=self.cfg.use_device_verifier)
            self.syncm = SyncManager(
                chain=self.handler.chain,
                scheme=self.group.scheme,
                public_key_bytes=self.group.public_key.key(),
                period=self.group.period,
                clock=self.clock,
                fetch=lambda peer, fr: self.client.sync_chain(
                    peer, fr, self.beacon_id),
                peers=self._peers(),
                chunk=self.cfg.sync_chunk,
                verifier=sync_verifier,
                resilience=self.resilience,
                sync_budget=self.cfg.sync_budget or None)
            self.syncm.start()
            self.handler.chain.cbstore.add_callback(
                "metrics", self._metrics_callback)
            group_size.labels(self.beacon_id).set(len(self.group))
            group_threshold.labels(self.beacon_id).set(self.group.threshold)
            if self._armed_transition is not None:
                # restart recovery (load): a reshare output staged before
                # the crash still awaits its transition round — re-arm
                # the swap exactly as the original session would have
                g, s = self._armed_transition
                self._armed_transition = None
                self.handler.transition(
                    g, s, on_commit=self._commit_closure(g, s))
        if self.cfg.startup_integrity not in ("off", "linkage", "full"):
            # fail fast: a typo'd value must not silently degrade the scan
            raise ValueError(
                "startup_integrity must be off|linkage|full, got "
                f"{self.cfg.startup_integrity!r}")
        if self.cfg.startup_integrity != "off":
            self._integrity_pass(trigger="startup")
        if self.cfg.integrity_scan_interval > 0:
            self._start_scheduled_scans()
        if catchup:
            self.handler.catchup()
        else:
            self.handler.start()
        self.log.info("beacon started", catchup=catchup,
                      genesis=self.group.genesis_time)

    def _expected_head_round(self) -> int:
        """The round the chain SHOULD be at per the clock (the
        head-truncation probe): a deleted tail is invisible to a scan
        that asks the store its own length, so the startup pass derives
        the expected head from `current_round(now, period, genesis)` and
        compares it to the stored head — a missing suffix is flagged and
        handed to catch-up sync instead of passing silently as clean.
        Before genesis nothing is expected (a fresh network's empty
        store is genuinely clean)."""
        from ..chain.timing import current_round
        now = int(self.clock.now())
        if self.group is None or now < self.group.genesis_time:
            return 0
        return current_round(now, self.group.period,
                             self.group.genesis_time)

    def _integrity_pass(self, trigger: str = "startup") -> None:
        """Scan the store against its own chain identity
        (cfg.startup_integrity: linkage | full).  At startup the scan is
        synchronous — it is the point of the knob — but the repair runs
        on a daemon thread so unreachable peers can't stall startup past
        the sync budget; until repair lands the corrupt rounds are
        quarantined (deleted), which is strictly safer than serving them.
        Scheduled reruns (`trigger="scheduled"`, cfg.integrity_scan_
        interval) take the same path on the scan thread: full-mode
        verification submits through the verify service's BACKGROUND
        lane, so live partials preempt a scan at every chunk boundary."""
        mode = self.cfg.startup_integrity
        if mode == "off":
            mode = "linkage"    # scheduled scans with no startup knob set
        verifier = self.syncm.verifier if mode == "full" else None
        try:
            stored_head = self.handler.chain.last().round
        except ErrNoBeaconStored:
            stored_head = 0
        # Head-truncation probe: the store cannot
        # name rounds it has lost off its tail, so compare its head to
        # the CLOCK-derived expected round.  The missing suffix — be it
        # truncation or ordinary downtime, indistinguishable here — is
        # flagged for catch-up sync (ONE collapsing stream), never fed
        # to heal's per-round re-fetch: a week offline on a 30 s chain
        # is ~20k rounds of routine catch-up, not corruption.  The -1
        # grace mirrors /health: the round being produced right now is
        # not yet "missing".
        expected = self._expected_head_round()
        behind = expected - 1 - stored_head
        if behind > 0:
            self.log.warn("chain head behind clock; flagging for "
                          "catch-up sync", head=stored_head,
                          expected=expected, behind=behind)
            self._on_sync_needed(expected)
        # Resumability: scheduled reruns skip the prefix
        # a previous scan proved clean (the checkpoint re-anchors against
        # the stored row — a mismatch falls back to a full walk).  The
        # startup pass deliberately re-walks everything: it is the once-
        # per-boot paranoia pass, and it refreshes the watermark.
        resume = self._load_scan_checkpoint() if trigger == "scheduled" \
            else None
        try:
            report = self.handler.chain.integrity_scan(
                verifier=verifier, mode=mode, upto=stored_head or None,
                beacon_id=self.beacon_id, trigger=trigger,
                **({"resume": resume} if resume is not None else {}))
        except Exception as e:
            self.log.error("integrity scan failed", trigger=trigger,
                           err=str(e))
            return
        if trigger == "scheduled":
            from ..metrics import integrity_scan_resumed_from
            integrity_scan_resumed_from.labels(self.beacon_id).set(
                report.resumed_from)
        if report.checkpoint is not None:
            self._save_scan_checkpoint(report.checkpoint)
        if report.clean:
            self.log.info("integrity scan clean", trigger=trigger,
                          mode=mode, scanned=report.scanned,
                          resumed_from=report.resumed_from)
            return
        faulty = report.faulty_rounds
        shown = ",".join(str(r) for r in faulty[:20])
        if len(faulty) > 20:
            shown += f",+{len(faulty) - 20} more"
        self.log.warn("integrity scan found corruption; "
                      "quarantining and re-fetching from peers",
                      trigger=trigger, mode=mode,
                      findings=len(report.findings), rounds=shown)
        # quarantine SYNCHRONOUSLY — the docstring's guarantee is that a
        # known-corrupt round is never served, so the deletes cannot wait
        # for the repair thread (a peer could sync the bad row in that
        # window).  heal() re-quarantines idempotently: already-deleted
        # rows are skipped without double-counting the metric.
        from ..chain.integrity import IntegrityScanner
        IntegrityScanner(self.handler.chain.backend, self.syncm.scheme,
                         beacon_id=self.beacon_id,
                         trigger=trigger).quarantine(report)

        def repair():
            try:
                remaining = self.syncm.heal(
                    self.handler.chain.backend, report,
                    peers=self._peers(), beacon_id=self.beacon_id)
            except Exception as e:
                self.log.error("integrity repair failed", err=str(e))
                return
            finally:
                with self._lock:
                    self._repair_thread = None
            if remaining:
                self.log.error("integrity repair incomplete; rounds remain "
                               "quarantined",
                               rounds=",".join(str(r) for r in remaining))
            else:
                self.log.info("integrity repair complete",
                              repaired=len(report.faulty_rounds))

        # one repair in flight at a time: a SCHEDULED pass that re-finds
        # the same quarantined rounds while peers are unreachable must not
        # stack another heal() (each retries under a multi-minute sync
        # budget — unbounded thread growth and duplicated peer traffic)
        with self._lock:
            if self._repair_thread is not None \
                    and self._repair_thread.is_alive():
                self.log.warn("integrity repair already in flight; "
                              "scan findings left for it", trigger=trigger)
                return
            self._repair_thread = threading.Thread(
                target=repair, daemon=True,
                name=f"integrity-repair-{self.beacon_id}")
            self._repair_thread.start()

    def _scan_checkpoint_path(self) -> Optional[str]:
        """Sidecar file for the scan watermark — sqlite only (memdb is
        volatile by contract, postgres is a server whose client may not
        even share a filesystem; both keep the in-memory watermark)."""
        if self.cfg.db_engine != "sqlite":
            return None
        return os.path.join(self.cfg.db_folder(self.beacon_id),
                            "scan_checkpoint.json")

    def _load_scan_checkpoint(self):
        path = self._scan_checkpoint_path()
        if path is None:
            return self._scan_ckpt
        from ..chain.integrity import ScanCheckpoint
        try:
            with open(path, "r", encoding="utf-8") as f:
                return ScanCheckpoint.from_json(f.read())
        except (OSError, ValueError, KeyError, TypeError):
            return self._scan_ckpt      # unreadable/corrupt: full rescan

    def _save_scan_checkpoint(self, ckpt) -> None:
        self._scan_ckpt = ckpt
        path = self._scan_checkpoint_path()
        if path is None:
            return
        from .. import fs as _fs
        try:
            # temp + fsync + rename: a crash mid-write must leave the old
            # (or no) watermark, never a torn one (worst = full rescan)
            _fs.write_atomic(path, ckpt.to_json().encode())
        except OSError:
            pass

    def _start_scheduled_scans(self) -> None:
        """Rerun the integrity pass every cfg.integrity_scan_interval
        seconds on the daemon clock (scans must not be a
        startup-only event — at-rest corruption happens while serving
        too).  Full-mode verification rides the verify service's
        BACKGROUND lane, so a scan never starves live partials; each
        scheduled pass resumes from the persisted clean-prefix watermark
        (O(delta) instead of O(chain), see ScanCheckpoint) and defers
        outright while the admission ladder has background work paused."""
        with self._lock:
            if self._scan_thread is not None:
                return
            interval = self.cfg.integrity_scan_interval
            self._scan_stop = stop = threading.Event()

        def loop():
            while True:
                if not self.clock.wait_until(self.clock.now() + interval,
                                             stop):
                    return      # stopped
                if stop.is_set() or self.handler is None \
                        or self.syncm is None:
                    return      # beacon stopped under us
                # degradation ladder (net/admission.py): while the serving
                # plane is overloaded, background housekeeping DEFERS to
                # the next tick — the requeue-never-fail discipline; the
                # scan is postponed, never dropped
                adm = getattr(self.cfg, "_admission", None)
                if adm is not None and adm.background_paused():
                    self.log.warn("scheduled integrity scan deferred: "
                                  "serving plane overloaded",
                                  level=adm.level())
                    continue
                try:
                    self._integrity_pass(trigger="scheduled")
                except Exception as e:
                    self.log.error("scheduled integrity scan failed",
                                   err=str(e))

        with self._lock:
            self._scan_thread = threading.Thread(
                target=loop, daemon=True,
                name=f"integrity-scan-{self.beacon_id}")
            self._scan_thread.start()

    def _metrics_callback(self, b: Beacon) -> None:
        last_beacon_round.labels(self.beacon_id).set(b.round)
        expected = time_of_round(self.group.period, self.group.genesis_time,
                                 b.round)
        beacon_discrepancy_latency.labels(self.beacon_id).set(
            (self.clock.now() - expected) * 1000.0)

    def _on_sync_needed(self, target_round: int) -> None:
        if self.syncm is not None:
            self.syncm.send_sync_request(target_round)

    def stop(self) -> None:
        # reap any parked transition waiter (it must not outlive the
        # daemon); a later restart re-creates the event, so a stopped
        # process can still be started again by the control plane
        self._transition_stop.set()
        self._transition_stop = threading.Event()
        with self._lock:
            scan_t, self._scan_thread = self._scan_thread, None
            repair_t, self._repair_thread = self._repair_thread, None
            if self._scan_stop is not None:
                self._scan_stop.set()
            syncm = self.syncm
            handler, self.handler = self.handler, None
            monitor = self.monitor
            board = self._board
            store = self.store
        # stop the components OUTSIDE the lock: each stop() joins its
        # worker threads, and the workers take self._lock on their way
        # out — stopping them under the lock is a join-under-lock
        # deadlock candidate (the lock checker's transitive-blocking
        # rule and the runtime sanitizer both flag it)
        if syncm is not None:
            syncm.stop()
        if handler is not None:
            handler.stop()
        if monitor is not None:
            monitor.stop()
        if board is not None:
            board.stop()
        if store is not None:
            store.close()
        # The repair budget is minutes, so this is a bounded courtesy
        # wait for the common fast exit, not a completion guarantee —
        # both are daemon threads already signalled to stop
        for t in (scan_t, repair_t):
            if t is not None and t is not threading.current_thread():
                t.join(timeout=2)

    # -- RPC ingress (routed here by the daemon services) --------------------

    def process_partial(self, req: pb.PartialBeaconPacket) -> None:
        if self.handler is None:
            raise ValueError("beacon not running")
        self.handler.process_partial_beacon(PartialBeaconPacket(
            round=req.round,
            previous_signature=req.previous_signature or None,
            partial_sig=req.partial_sig,
            beacon_id=self.beacon_id))

    def serve_sync(self, remote_addr: str, from_round: int,
                   stop: Optional[threading.Event] = None) -> Iterator[Beacon]:
        if self.sync_server is None:
            raise ValueError("beacon not running")
        return self.sync_server.stream(remote_addr, from_round, stop=stop)

    def get_beacon(self, round_: int) -> Beacon:
        """round 0 = latest (core/drand_beacon_public.go:67-101)."""
        if self.handler is None:
            raise ErrNoBeaconStored("beacon not running")
        if round_ == 0:
            return self.handler.chain.last()
        return self.handler.chain.store.get(round_)

    # -- DKG failure hygiene -------------------------------------------------

    def _fail_session(self, kind: str, nonce: Optional[bytes] = None) -> None:
        """Every abort path lands here: status DKG_FAILED (never a wedged
        IN_PROGRESS), staged output gone, the epoch's nonce blacklisted so
        stragglers' bundles are rejected, the journal closed, the outcome
        counted.  After this the beacon is immediately serveable and a
        fresh InitDKG/InitReshare on the same id succeeds."""
        if kind == "reshare":
            self.reshare_status = DKG_FAILED
        else:
            self.dkg_status = DKG_FAILED
        if nonce:
            with self._lock:
                self._failed_nonces.add(nonce)
        # staged cleanup, scoped to THIS epoch: a pending ledger staged by
        # an earlier successful reshare (still awaiting its transition)
        # must survive an unrelated later session's failure
        pending = self.journal.load_pending()
        if pending is not None and nonce is not None \
                and pending.new_group_hash == nonce.hex():
            self.journal.discard_pending()
            reshare_transition_pending.labels(self.beacon_id).set(0)
        self.journal.finish(J.FAILED)
        dkg_sessions.labels(self.beacon_id, kind, J.FAILED).inc()
        dkg_phase_gauge.labels(self.beacon_id).set(0)

    # -- DKG: leader path (drand_beacon_control.go:41-117,275-411) ----------

    def init_dkg_leader(self, n_nodes: int, threshold: int, period: int,
                        catchup_period: int, secret: bytes,
                        setup_timeout: float, scheme) -> Group:
        self._check_handel_gate(n_nodes)
        self.dkg_status = DKG_WAITING
        self.journal.begin("dkg", "leader")
        dkg_phase_gauge.labels(self.beacon_id).set(
            J.phase_index(J.PHASE_SETUP))
        self._setup_manager = SetupManager(
            self.log, scheme, self.beacon_id, n_nodes, secret,
            self.pair.public)
        group = None
        try:
            self._setup_manager.wait_participants(setup_timeout)
            group = self._setup_manager.create_group(
                threshold, period, catchup_period, self.clock.now(),
                self.cfg.dkg_timeout)
            self._push_dkg_info(group)
            out_group = self._run_dkg_session(group, leader=True)
        except BaseException:
            self._fail_session("dkg",
                               group.hash() if group is not None else None)
            raise
        finally:
            self._setup_manager = None
        return out_group

    def _push_dkg_info(self, group: Group,
                       secret_proof: bytes = b"") -> None:
        """Signed group to every participant (drand_beacon_control.go:
        988-1083); all pushes must succeed for a fresh DKG.

        Partial-push arming: when only a SUBSET of followers accepted the
        group, the leader raises here — but the armed followers are
        already sitting in a session that will never run.  There is no
        abort RPC in the protocol, so the contract is deadline-unwind:
        the armed followers' deal/response phases expire on their own
        clocks, the too-few-bundles DkgError surfaces, and their failure
        hygiene lands them at DKG_FAILED (never a wedged WAITING) ready
        for the retry — pinned by the partial-push lifecycle test."""
        sig = sign_group(group, group.scheme, self.pair.key)
        packet = pb.DKGInfoPacket(
            new_group=convert.group_to_proto(group, self.beacon_id),
            secret_proof=secret_proof,
            dkg_timeout=self.cfg.dkg_timeout,
            signature=sig,
            kickoff_grace_ms=int(self.cfg.dkg_kickoff_grace * 1000),
            metadata=convert.metadata(self.beacon_id))
        errors = []
        for peer in self._peers(group):
            try:
                self.client.push_dkg_info(peer, packet,
                                          timeout=CALL_MAX_TIMEOUT)
            except Exception as e:
                errors.append((peer.address, e))
        if errors:
            raise RuntimeError(f"push_dkg_info failed: {errors}")

    # -- DKG: follower path (drand_beacon_control.go:536-624) ---------------

    def join_dkg(self, leader: Peer, secret: bytes,
                 setup_timeout: float) -> Group:
        self.dkg_status = DKG_WAITING
        self.journal.begin("dkg", "follower")
        dkg_phase_gauge.labels(self.beacon_id).set(
            J.phase_index(J.PHASE_SETUP))
        group = None
        try:
            self._setup_receiver = SetupReceiver(
                self.log, self._fetch_leader_identity(leader))
            sig_packet = pb.SignalDKGPacket(
                node=convert.identity_to_proto(self.pair.public),
                secret_proof=hash_secret(secret),
                metadata=convert.metadata(self.beacon_id))
            self._signal_with_retry(leader, sig_packet, setup_timeout)
            group, timeout_s, grace_s = self._setup_receiver.wait_group(
                setup_timeout)
            self._check_handel_gate(len(group))
            return self._run_dkg_session(
                group, leader=False, phase_timeout=timeout_s,
                first_phase_extra=grace_s + 1.0)
        except BaseException:
            self._fail_session("dkg",
                               group.hash() if group is not None else None)
            raise
        finally:
            self._setup_receiver = None

    def _signal_with_retry(self, leader: Peer, packet, budget: float,
                           backoff: float = 0.5) -> None:
        """The leader may not have run InitDKG yet when we signal; keep
        retrying within the setup budget (the reference CLI loops the same
        way while the coordinator comes up).  Waits go through the shared
        policy's injected clock, and the client layer's own retry chain is
        clamped by the same Deadline — no breaker here, an absent
        coordinator is the EXPECTED starting state."""
        deadline = Deadline.after(self.clock, budget)
        while True:
            try:
                self.client.signal_dkg_participant(leader, packet,
                                                   timeout=CALL_MAX_TIMEOUT,
                                                   deadline=deadline)
                return
            except DeadlineExceeded:
                raise
            except Exception:
                if deadline.remaining() <= backoff:
                    raise
                self.resilience.sleep(backoff)

    def _fetch_leader_identity(self, leader: Peer, budget: float = 30.0):
        deadline = Deadline.after(self.clock, budget)
        while True:
            try:
                resp = self.client.get_identity(leader, self.beacon_id,
                                                deadline=deadline)
                break
            except DeadlineExceeded:
                raise
            except Exception:
                if deadline.remaining() <= 0.5:
                    raise
                self.resilience.sleep(0.5)
        from ..crypto.schemes import get_scheme_by_id_with_default
        scheme = get_scheme_by_id_with_default(resp.schemeName)
        ident = convert.proto_to_identity(resp, scheme)
        if not ident.valid_signature():
            raise ValueError("leader identity signature invalid")
        return ident

    # -- shared DKG session (fresh) ------------------------------------------

    def _dkg_nodes(self, group: Group) -> List[D.DkgNode]:
        return [D.DkgNode(n.index, n.identity.key) for n in group.nodes]

    def _journal_phase(self, phase: str) -> None:
        """run_dkg's on_phase hook: persist the phase reached (a restart
        reports how far the dead session got) + the live gauge."""
        self.journal.phase(phase)
        dkg_phase_gauge.labels(self.beacon_id).set(J.phase_index(phase))

    def _run_dkg_session(self, group: Group, leader: bool,
                         phase_timeout: int = 0,
                         first_phase_extra: float = 0.0) -> Group:
        self.dkg_status = DKG_IN_PROGRESS
        nonce = group.hash()
        self.journal.set_nonce(nonce)
        # a RETRY of a failed epoch can legitimately reuse the same group
        # hash (same membership/threshold/transition round): the nonce is
        # live again the moment a local session adopts it — un-blacklist,
        # or this node would reject every bundle of its own retry
        with self._lock:
            self._failed_nonces.discard(nonce)
        nodes = self._dkg_nodes(group)
        board = EchoBroadcast(
            self.client, self.log, self.beacon_id,
            self.pair.public.addr, nonce, dealers=nodes, holders=nodes,
            peers=[Peer(n.identity.addr, n.identity.tls)
                   for n in group.nodes],
            scheme=group.scheme)
        self._install_board(board)
        try:
            if leader:
                # grace beat so followers can bring their boards up before
                # our deals hit the wire (the pending buffer catches any
                # stragglers anyway); followers learn this value from the
                # DKGInfoPacket and pad their deal deadline past it
                self.clock.wait_until(
                    self.clock.now() + self.cfg.dkg_kickoff_grace,
                    threading.Event())
            gen = D.DistKeyGenerator(D.DkgConfig(
                scheme=group.scheme, longterm=self.pair.key, nonce=nonce,
                new_nodes=nodes, threshold=group.threshold))
            out = run_dkg_bounded(
                gen, board, self.clock,
                phase_timeout or self.cfg.dkg_timeout, self.log,
                first_phase_extra=first_phase_extra,
                on_phase=self._journal_phase)
        finally:
            self._clear_board(board)
        return self._adopt_dkg_output(group, out)

    def _adopt_dkg_output(self, group: Group, out: D.DkgOutput) -> Group:
        """Filter QUAL, persist share + completed group, start the chain
        (WaitDKG, core/drand_beacon.go:167-236).  A fresh DKG has no old
        state to protect, so the output lands in the ACTIVE files
        directly — atomically (key/store.py temp+fsync+rename), so a
        crash mid-adopt leaves either no state (retry the DKG) or
        complete state, never a torn TOML."""
        from ..key.keys import DistPublic
        self._journal_phase(J.PHASE_ADOPT)
        group.public_key = DistPublic(list(out.commits))
        self.group = group
        self.share = (Share(scheme=group.scheme, private=out.share,
                            commits=list(out.commits))
                      if out.share is not None else None)
        self.fs.save_group(group)
        if self.share is not None:
            self.fs.save_share(self.share)
        self.dkg_status = DKG_DONE
        self.journal.finish(J.SUCCESS)
        dkg_sessions.labels(self.beacon_id, "dkg", J.SUCCESS).inc()
        dkg_phase_gauge.labels(self.beacon_id).set(0)
        if self.cfg.dkg_callback is not None:
            self.cfg.dkg_callback(self.beacon_id, group)
        return group

    # -- resharing (drand_beacon_control.go:123-234,425-529) -----------------

    def init_reshare_leader(self, old_group: Group, n_nodes: int,
                            threshold: int, secret: bytes,
                            setup_timeout: float) -> Group:
        self._check_handel_gate(n_nodes)
        self.reshare_status = DKG_IN_PROGRESS
        self.journal.begin("reshare", "leader")
        dkg_phase_gauge.labels(self.beacon_id).set(
            J.phase_index(J.PHASE_SETUP))
        self._setup_manager = SetupManager(
            self.log, old_group.scheme, self.beacon_id, n_nodes, secret,
            self.pair.public)
        new_group = None
        try:
            self._setup_manager.wait_participants(setup_timeout)
            new_group = self._setup_manager.create_reshare_group(
                old_group, threshold, self.clock.now(),
                reshare_offset=self.cfg.reshare_offset)
            self._push_dkg_info(new_group)
            return self._run_reshare_session(old_group, new_group)
        except BaseException:
            self._fail_session(
                "reshare",
                new_group.hash() if new_group is not None else None)
            raise
        finally:
            self._setup_manager = None

    def join_reshare(self, leader: Peer, old_group: Group, secret: bytes,
                     setup_timeout: float) -> Group:
        self.reshare_status = DKG_IN_PROGRESS
        self.journal.begin("reshare", "follower")
        dkg_phase_gauge.labels(self.beacon_id).set(
            J.phase_index(J.PHASE_SETUP))
        new_group = None
        try:
            self._setup_receiver = SetupReceiver(
                self.log, self._fetch_leader_identity(leader))
            sig_packet = pb.SignalDKGPacket(
                node=convert.identity_to_proto(self.pair.public),
                secret_proof=hash_secret(secret),
                previous_group_hash=old_group.hash(),
                metadata=convert.metadata(self.beacon_id))
            self._signal_with_retry(leader, sig_packet, setup_timeout)
            new_group, timeout_s, grace_s = self._setup_receiver.wait_group(
                setup_timeout)
            if new_group.get_genesis_seed() != old_group.get_genesis_seed():
                raise ValueError("reshare group does not extend our chain")
            self._check_handel_gate(len(new_group))
            return self._run_reshare_session(
                old_group, new_group, phase_timeout=timeout_s,
                first_phase_extra=grace_s + 1.0)
        except BaseException:
            self._fail_session(
                "reshare",
                new_group.hash() if new_group is not None else None)
            raise
        finally:
            self._setup_receiver = None

    def _run_reshare_session(self, old_group: Group, new_group: Group,
                             phase_timeout: int = 0,
                             first_phase_extra: float = 0.0) -> Group:
        nonce = new_group.hash()
        self.journal.set_nonce(nonce)
        # same-epoch retry: see _run_dkg_session
        with self._lock:
            self._failed_nonces.discard(nonce)
        old_nodes = self._dkg_nodes(old_group)
        new_nodes = self._dkg_nodes(new_group)
        union_peers = {n.identity.addr: Peer(n.identity.addr, n.identity.tls)
                       for g in (old_group, new_group) for n in g.nodes}
        board = EchoBroadcast(
            self.client, self.log, self.beacon_id,
            self.pair.public.addr, nonce,
            dealers=old_nodes, holders=new_nodes,
            peers=list(union_peers.values()), scheme=new_group.scheme)
        self._install_board(board)
        try:
            if self._setup_manager is not None:    # we are the leader
                self.clock.wait_until(
                    self.clock.now() + self.cfg.dkg_kickoff_grace,
                    threading.Event())
            gen = D.DistKeyGenerator(D.DkgConfig(
                scheme=new_group.scheme, longterm=self.pair.key, nonce=nonce,
                new_nodes=new_nodes, threshold=new_group.threshold,
                old_nodes=old_nodes, old_threshold=old_group.threshold,
                share=self.share.private if self.share else None,
                public_coeffs=(list(old_group.public_key.coefficients)
                               if old_group.public_key else None)))
            out = run_dkg_bounded(
                gen, board, self.clock,
                phase_timeout or self.cfg.dkg_timeout, self.log,
                first_phase_extra=first_phase_extra,
                on_phase=self._journal_phase)
        finally:
            self._clear_board(board)
        new_group = self._adopt_reshare_output(old_group, new_group, out)
        return new_group

    def _adopt_reshare_output(self, old_group: Group, new_group: Group,
                              out: D.DkgOutput) -> Group:
        """STAGED adoption (the crash-safety core of this plane): the
        reshare output lands in the staged files + the pending-transition
        ledger, and the ACTIVE group/share stay untouched until the
        handler's transition commits at the transition round.  The old
        share therefore survives exactly as long as the chain still needs
        it — a crash in the success→transition window restarts with the
        old state plus the ledger, re-arms the swap, and never signs a
        pre-transition round with the new share (nor loses the old share
        when pre-transition rounds still need signing)."""
        from ..key.keys import DistPublic
        self._journal_phase(J.PHASE_ADOPT)
        new_group.public_key = DistPublic(list(out.commits))
        new_share = (Share(scheme=new_group.scheme, private=out.share,
                           commits=list(out.commits))
                     if out.share is not None else None)
        self.journal.stage_transition(old_group, new_group, new_share)
        reshare_transition_pending.labels(self.beacon_id).set(1)
        self.reshare_status = DKG_DONE
        self.journal.finish(J.SUCCESS)
        dkg_sessions.labels(self.beacon_id, "reshare", J.SUCCESS).inc()
        dkg_phase_gauge.labels(self.beacon_id).set(0)
        commit = self._commit_closure(new_group, new_share)
        if self.handler is not None:
            # running member: swap shares at transition time
            # (node.go:257-281); leavers get (group, None) and stop.
            self.handler.transition(new_group, new_share, on_commit=commit)
            self.group = new_group if new_share is not None else self.group
            self.share = new_share or self.share
        elif new_share is not None:
            # newcomer: adopt state now, start syncing, join at transition
            self.group = new_group
            self.share = new_share
            self._start_at_transition(new_group, commit=True)
        return new_group

    def _commit_closure(self, new_group: Group, new_share: Optional[Share]):
        """The on_commit hook for Handler.transition: promote the staged
        files at the moment the handler swaps shares."""
        def commit():
            self._commit_pending_transition(new_group, new_share)
        return commit

    def _commit_pending_transition(self, new_group: Group,
                                   new_share: Optional[Share]) -> None:
        """Promote the staged reshare output over the active files and
        retire the ledger.  Idempotent (a replay after a crashed commit
        finishes the promotion); failures are logged, never raised — the
        in-memory transition must proceed regardless, and load-time
        recovery will re-commit from the ledger if the disk swap was
        lost."""
        try:
            committed = self.journal.commit_pending()
        except Exception as e:
            self.log.error("pending-transition commit failed; ledger "
                           "kept for load-time recovery", err=str(e))
            return
        reshare_transition_pending.labels(self.beacon_id).set(0)
        if committed:
            self.log.info("reshare transition committed",
                          transition_time=new_group.transition_time)
        self.group = new_group if new_share is not None else self.group
        self.share = new_share if new_share is not None else self.share

    def _start_at_transition(self, group: Group, commit: bool = False)\
            -> None:
        """Newcomer path: park until the transition time, then commit the
        staged state (when `commit`) and start the beacon with catchup.
        The waiter parks on the process stop event — NOT a never-set
        Event — so a daemon stop reaps it instead of leaking a
        transition-<id> thread past the process lifecycle."""
        stop = self._transition_stop

        def waiter():
            if not self.clock.wait_until(group.transition_time, stop):
                return      # daemon stopped before the transition
            if commit:
                self._commit_pending_transition(group, self.share)
            self.start_beacon(catchup=True)
        # intentional fire-and-forget: the waiter parks on
        # _transition_stop, which stop() sets — reaping is by event, not
        # join, per the docstring above
        # tpu-vet: disable=threadlife
        threading.Thread(target=waiter, daemon=True,
                         name=f"transition-{self.beacon_id}").start()

    # -- setup-plane ingress (routed by daemon services) ---------------------

    def signal_dkg_participant(self, req: pb.SignalDKGPacket) -> None:
        if self._setup_manager is None:
            raise ValueError("no DKG setup in progress")
        scheme = self._setup_manager.scheme
        ident = convert.proto_to_identity(req.node, scheme)
        self._setup_manager.received_key(ident, req.secret_proof)

    def push_dkg_info(self, req: pb.DKGInfoPacket) -> None:
        if self._setup_receiver is None:
            raise ValueError("not waiting for DKG info")
        group = convert.proto_to_group(req.new_group)
        self._setup_receiver.push_dkg_info(
            group, req.signature, req.dkg_timeout,
            kickoff_grace_s=req.kickoff_grace_ms / 1000.0)

    @staticmethod
    def _packet_nonce(req: pb.DKGPacket) -> bytes:
        """The session nonce a DKG packet claims, without full bundle
        decoding (cheap enough for the reject-before-park check)."""
        dkg = req.dkg
        which = dkg.WhichOneof("bundle")
        if which == "deal":
            return dkg.deal.session_id
        if which == "response":
            return dkg.response.session_id
        if which == "justification":
            return dkg.justification.session_id
        return b""

    def broadcast_dkg(self, req: pb.DKGPacket) -> None:
        with self._lock:
            # stale-epoch rejection: bundles from an aborted/failed
            # session must not park in the pending buffer waiting for the
            # NEXT board (they would be dropped there too, but an
            # explicit error tells the straggling peer its epoch is dead)
            nonce = self._packet_nonce(req)
            if nonce and nonce in self._failed_nonces:
                raise ValueError("stale DKG bundle: session "
                                 f"{nonce.hex()[:16]} was aborted")
            if self._board is None:
                # board not up yet (setup still finishing): park the packet;
                # _install_board replays it.  Bad/stale packets are dropped
                # by the board's signature + session checks at replay time.
                if len(self._pending_dkg) < 4096:
                    self._pending_dkg.append(req)
                return
            board = self._board
        board.received(req)

    def _install_board(self, board: EchoBroadcast) -> None:
        with self._lock:
            self._board = board
            pending, self._pending_dkg = self._pending_dkg, []
        for req in pending:
            try:
                board.received(req)
            except Exception:
                pass

    def _clear_board(self, board: EchoBroadcast) -> None:
        with self._lock:
            self._board = None
            self._pending_dkg = []
        board.stop()
