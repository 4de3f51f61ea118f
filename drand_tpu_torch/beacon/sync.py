"""SyncManager + SyncChain server (chain/beacon/sync_manager.go:28-590).

The port's copy of drand_tpu/beacon/sync.py, unchanged but for its
imports.  The device-first redesign of the reference's sync path: where
the Go code verifies each streamed beacon with one CPU pairing
(sync_manager.go:406), beacons here are buffered into chunks and verified
in ONE device RLC pass per chunk through the verify service's
`BatchBeaconVerifier`, with the chained-linkage check done as the cheap
host-side prefix pass.

Components:
  * `SyncManager.run` — serializes sync requests (queue 3), restarts a sync
    idle for > 2·period (sync_manager.go:52-53,154-162), shuffles peers for
    failover (sync_manager.go:302).
  * `check_past_beacons` / `correct_past_beacons` — full-chain validation
    and repair (sync_manager.go:170-268); repair writes through the RAW
    store, bypassing the append decorator (the "insecure store" ReSync path,
    sync_manager.go:411-416).
  * `SyncChainServer` — the serving side of a sync stream: cursor replay
    from `from_round`, then live-follow via a store callback registered
    under the remote address (replaced on re-request, sync_manager.go:542-560).
"""

import queue
import threading
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

from ..chain.beacon import Beacon
from ..chain.errors import ErrNoBeaconStored
from ..net.resilience import (DEFAULT_SYNC_BUDGET, BreakerOpen, Deadline,
                              ResiliencePolicy, peer_key)
from .stores import ErrBeaconAlreadyStored

DEFAULT_CHUNK = 512
SYNC_QUEUE = 3


class ErrFailedAll(Exception):
    """Every candidate peer failed to advance the sync (sync_manager.go:59)."""


class SyncManager:
    """Pulls missing rounds from peers with batched device verification.

    `fetch(peer, from_round)` must return an iterator of Beacons streamed by
    the peer (the net layer's SyncChain client; tests wire SyncChainServer
    generators directly)."""

    def __init__(self, chain, scheme, public_key_bytes: bytes, period: int,
                 clock, fetch: Callable[[object, int], Iterable[Beacon]],
                 peers: Sequence[object] = (), chunk: int = DEFAULT_CHUNK,
                 verifier=None, resilience: Optional[ResiliencePolicy] = None,
                 sync_budget: Optional[float] = None):
        self.chain = chain                  # ChainStore facade (decorators)
        self.scheme = scheme
        self.period = period
        self.clock = clock
        self.fetch = fetch
        self.peers = list(peers)
        self.chunk = chunk
        if verifier is None:                # lazy: keep torch out of host-only
            # all device dispatch goes through the resident verify
            # service (one owner, coalesced batches, priority lanes) —
            # sync/heal work rides the BACKGROUND lane so live-round
            # partial aggregation preempts it at chunk boundaries
            from ..crypto.verify_service import get_service
            verifier = get_service().handle(scheme, public_key_bytes)
        self.verifier = verifier
        # shared policy: the daemon passes the one its ProtocolClient uses,
        # so partial-send failures steer sync peer selection and vice versa
        self.resilience = resilience or ResiliencePolicy(clock=clock,
                                                         scope="sync")
        self.sync_budget = sync_budget or DEFAULT_SYNC_BUDGET
        self._requests: queue.Queue = queue.Queue(maxsize=SYNC_QUEUE)
        self._stop = threading.Event()
        self._last_progress = None
        self._thread: Optional[threading.Thread] = None

    # -- request plane -------------------------------------------------------

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self.run, daemon=True,
                                            name="sync-manager")
            self._thread.start()

    def send_sync_request(self, target_round: int,
                          peers: Optional[Sequence[object]] = None) -> None:
        """Non-blocking enqueue; a full queue drops the request — the next
        gap detection re-issues it (sync_manager.go:121-142)."""
        try:
            self._requests.put_nowait((target_round, list(peers or self.peers)))
        except queue.Full:
            pass

    def run(self) -> None:
        while not self._stop.is_set():
            try:
                target, peers = self._requests.get(timeout=0.1)
            except queue.Empty:
                continue
            # collapse queued requests to the farthest target
            try:
                while True:
                    t2, p2 = self._requests.get_nowait()
                    if t2 > target:
                        target, peers = t2, p2
            except queue.Empty:
                pass
            if target <= self._head_round():
                continue
            try:
                self.sync(target, peers)
            except ErrFailedAll:
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- the sync itself -----------------------------------------------------

    def _head_round(self) -> int:
        head = self._head_beacon()
        return head.round if head is not None else 0

    def _head_beacon(self) -> Optional[Beacon]:
        try:
            return self.chain.last()
        except ErrNoBeaconStored:
            return None   # fresh store (follow-mode bootstrap)

    def sync(self, target_round: int, peers: Sequence[object]) -> None:
        """Stream from peers until the chain reaches target_round, under ONE
        overall budget (`sync_budget`) instead of per-call timeouts.

        Peer order is breaker-aware (closed-breaker peers first, quarantined
        ones last, shuffled within each health bucket for load spreading —
        the Handel-style de-prioritization of unresponsive peers).
        Quarantined peers are skipped while any healthier candidate exists,
        but when EVERY peer is quarantined they are dialed anyway (last
        resort — a healed partition must not idle out a full cooldown); a
        pass that makes no progress backs off with jitter, and
        `ErrFailedAll` is raised only once the budget is spent."""
        peers = list(peers)
        if not peers:
            raise ErrFailedAll("no peers to sync from")
        deadline = Deadline.after(self.clock, self.sync_budget)
        strikes = 0
        while True:
            progressed = False
            # ONE preference snapshot per pass drives both the ranking and
            # the quarantine skip — querying the registry twice would let a
            # cooldown that elapses mid-pass make the two disagree
            prefs = {peer_key(p): self.resilience.breakers.preference(
                peer_key(p)) for p in peers}
            all_quarantined = all(v == 2 for v in prefs.values())
            order = list(peers)
            self.resilience.rng.shuffle(order)
            order.sort(key=lambda p: prefs[peer_key(p)])
            for peer in order:
                if self._stop.is_set():
                    return
                if deadline.expired:
                    raise ErrFailedAll(
                        f"no peer could sync us to round {target_round} "
                        f"within the {self.sync_budget}s budget")
                key = peer_key(peer)
                br = self.resilience.breaker(key)
                if prefs[key] == 2:
                    if not all_quarantined:
                        continue    # quarantined: cooldown not yet elapsed
                    # last resort: every peer is quarantined — admit a
                    # probe NOW (OPEN → HALF_OPEN before the cooldown
                    # elapses), or the production fetch path would raise
                    # BreakerOpen at the client and the dial-anyway promise
                    # above would be dead code
                    br.force_probe()
                before = self._head_round()
                try:
                    reached, aborted = self._try_peer(peer, target_round,
                                                      deadline)
                except BreakerOpen:
                    continue        # client-side rejection, not a failure
                except Exception:
                    br.record_failure()
                    continue
                if self._head_round() > before:
                    progressed = True
                    br.record_success()
                elif not reached and not aborted:
                    # transport was fine but the content didn't advance us
                    # (empty, stale, or Byzantine stream); an `aborted` try
                    # (stop() or budget expiry mid-stream) is OUR exit, not
                    # the peer's fault — no strike
                    br.record_failure()
                if reached:
                    return
            if self._stop.is_set():
                return
            if deadline.expired:
                raise ErrFailedAll(
                    f"no peer could sync us to round {target_round} "
                    f"within the {self.sync_budget}s budget")
            strikes = 0 if progressed else strikes + 1
            # back off before the next pass (full jitter, never past the
            # deadline); a fruitless pass also waits for the earliest
            # breaker probe so a fully-quarantined peer set isn't hot-looped
            delay = max(self.resilience.backoff.delay(strikes,
                                                      self.resilience.rng),
                        0.05)
            wake = min(self.clock.now() + delay, deadline.expires)
            if not progressed:
                probe_at = self.resilience.breakers.next_probe_at(
                    [peer_key(p) for p in peers])
                wake = min(max(wake, probe_at), deadline.expires)
            self.clock.wait_until(wake, self._stop)

    def _try_peer(self, peer, target_round: int,
                  deadline: Optional[Deadline] = None) -> tuple:
        """One streaming attempt against `peer`.  Returns (reached,
        aborted): `aborted` means WE bailed (stop() or budget expiry), so
        the caller must not blame the peer for the lack of progress."""
        head = self._head_beacon()
        buf: List[Beacon] = []
        aborted = False
        # Idle watchdog: a peer that stops producing for > 2·period is
        # abandoned so sync() can fail over (sync_manager.go:52-53,154-162);
        # without it a black-holed TCP stream stalls the manager forever.
        stream = _IdleTimeoutIter(
            self.fetch(peer, (head.round + 1) if head else 1),
            idle=max(2 * self.period, 10), stop=self._stop)
        try:
            for b in stream:
                if self._stop.is_set():
                    return False, True
                if deadline is not None and deadline.expired:
                    aborted = True
                    break       # budget spent mid-stream: flush what we have
                buf.append(b)
                # flush on a full chunk OR once the target is covered: the
                # serving side live-follows forever (sync_manager.go:468),
                # so waiting for a full chunk would buffer one round per
                # period indefinitely and never store anything
                if len(buf) >= self.chunk or b.round >= target_round:
                    head = self._verify_and_store(head, buf)
                    buf = []
                    if head is None:
                        return False, False
                    if head.round >= target_round:
                        return True, False
            if buf:
                head = self._verify_and_store(head, buf)
            reached = head is not None and head.round >= target_round
            return reached, aborted
        finally:
            # every exit path must tear the stream down, or the pump thread
            # keeps draining the peer's live-follow stream forever
            stream.close()

    def _verify_and_store(self, head: Optional[Beacon], chunk: List[Beacon]
                          ) -> Optional[Beacon]:
        """One device pass for the whole chunk; store on full success.

        Returns the new head, or None if the peer's stream is invalid
        (caller fails over to the next peer)."""
        # The aggregator may have stored rounds while we streamed
        # (chainstore.go:253-265): advance to the freshest head and drop the
        # now-stale prefix BEFORE the linkage check, or an honest peer would
        # be blamed for the overlap.
        cur = self._head_beacon()
        if cur is not None and (head is None or cur.round > head.round):
            head = cur
            chunk = [b for b in chunk if b.round > head.round]
            if not chunk:
                return head
        if not self._chunk_links(head, chunk):
            return None
        ok = self.verifier.verify_batch(
            [b.round for b in chunk],
            [b.signature for b in chunk],
            [b.previous_sig for b in chunk])
        if not ok.all():
            return None
        for b in chunk:
            try:
                self.chain.put(b)
            except (ErrBeaconAlreadyStored, ValueError):
                # racing the aggregator is benign (chainstore.go:253-265)
                pass
        self._last_progress = self.clock.now()
        return chunk[-1]

    def _chunk_links(self, head: Optional[Beacon], chunk: List[Beacon]) -> bool:
        """Host-side linkage prefix pass (SURVEY.md §5.7).

        With no local head (fresh store) the first streamed beacon anchors
        the walk; its own validity is established by the signature check."""
        prev = head
        for b in chunk:
            if prev is not None:
                if b.round != prev.round + 1:
                    return False
                if self.scheme.chained and prev.round > 0 \
                        and b.previous_sig != prev.signature:
                    return False
            prev = b
        return True

    # -- chain validation & repair (sync_manager.go:170-268) -----------------

    def check_past_beacons(self, upto: int,
                           progress: Optional[Callable[[int, int], None]] = None
                           ) -> List[int]:
        """Validate rounds 1..upto of our own store in device chunks;
        returns the faulty round numbers (missing, failing signature
        verification, or breaking the chained linkage).

        Facade over `chain.integrity.IntegrityScanner` (ROADMAP storage
        follow-up): the pre-scanner implementation verified against the
        STORE-RETURNED `previous_sig`, which a raw trimmed store (the
        daemon default, `require_previous=False`) materializes as None —
        so a chained-scheme check flagged every round.  The scanner
        carries the linkage anchor itself (the previous row's stored
        signature, seeded from a stored genesis row or the configured
        genesis seed), so trimmed and full-beacon stores validate alike.
        Prefer `ChainStore.integrity_scan` for new callers — it returns
        the full ScanReport that `heal` consumes."""
        from ..chain.integrity import MODE_FULL
        report = self._scanner().scan(mode=MODE_FULL, upto=upto,
                                      progress=progress)
        return report.faulty_rounds

    def _scanner(self):
        from ..chain.integrity import IntegrityScanner
        # scan the RAW backend when the chain exposes one — corruption
        # hides underneath the decorators (same choice as
        # ChainStore.integrity_scan) — and recover the genesis anchor
        # from whichever facade we were handed: FollowFacade carries
        # genesis_seed directly, ChainStore derives it from the group.
        store = getattr(self.chain, "backend", None) or self.chain.store
        seed = getattr(self.chain, "genesis_seed", None)
        if seed is None:
            group = getattr(self.chain, "group", None)
            if group is not None:
                seed = group.get_genesis_seed()
        return IntegrityScanner(
            store, self.scheme, verifier=self.verifier,
            genesis_seed=seed, chunk=self.chunk)

    def correct_past_beacons(self, raw_store, faulty: Sequence[int],
                             peers: Optional[Sequence[object]] = None) -> List[int]:
        """Re-fetch faulty rounds from peers, verify, and overwrite through
        the RAW store (the append decorator would reject non-head writes).

        Returns the rounds that could not be repaired."""
        peers = self.resilience.rank(list(peers or self.peers))
        remaining = sorted(set(faulty))
        for peer in peers:
            if not remaining:
                break
            br = self.resilience.breaker(peer_key(peer))
            dialed = False
            fetched = []
            for r in remaining:
                try:
                    b = self._fetch_one(peer, r)
                    dialed = True
                except BreakerOpen:
                    # client-side rejection: nothing was dialed, and every
                    # further round would be rejected too — next peer
                    break
                except Exception:
                    dialed = True
                    b = None
                fetched.append((r, b))
            got = [(r, b) for r, b in fetched if b is not None]
            repaired = set()
            if got:
                # one device pass for everything this peer produced
                ok = self.verifier.verify_batch(
                    [b.round for _, b in got],
                    [b.signature for _, b in got],
                    [b.previous_sig for _, b in got])
                goods = [(r, b) for (r, b), good in zip(got, ok) if good]
                for r, _ in goods:
                    raw_store.delete(r)
                try:
                    # one transaction for the whole batch on engines that
                    # support it (chain/store.py put_many contract)
                    raw_store.put_many([b for _, b in goods])
                    repaired = {r for r, _ in goods}
                except Exception:
                    # the rows are already deleted — salvage row by row so
                    # a batch-level failure (e.g. SQLITE_BUSY past the
                    # timeout) loses at most the rows that individually
                    # fail, not every verified replacement in hand
                    for r, b in goods:
                        try:
                            raw_store.put(b)
                            repaired.add(r)
                        except Exception:
                            pass
                remaining = [r for r in remaining if r not in repaired]
            # repair-path breaker accounting: a peer that produced nothing
            # usable (unreachable, or only forged rounds) trips towards
            # open — but only an ACTUAL dial outcome counts; a BreakerOpen
            # fast-fail is not new evidence against the peer
            if repaired:
                br.record_success()
            elif dialed:
                br.record_failure()
        return remaining

    def heal(self, raw_store, report_or_rounds, peers=None,
             beacon_id: str = "default") -> List[int]:
        """Quarantine + repair rounds flagged by an integrity scan
        (chain/integrity.py): corrupt rows are tombstoned to the
        quarantine side table first so this node stops serving them, then
        repair runs in two phases:

          1. provably-bad rounds (invalid signature, malformed, missing)
             are re-fetched from breaker-ranked peers
             (correct_past_beacons — the existing repair machinery with
             its peer accounting), verified in device batches, and
             written back through the RAW store;
          2. rounds that were merely UNPROVABLE (their anchor rotted, not
             their own bytes) get a PROMOTE pass: the tombstoned bytes
             are re-verified against the now-restored anchor and put back
             without touching the network (ROADMAP item 6 two-phase
             quarantine).  Only the rounds promotion cannot prove fall
             through to a peer fetch.

        Accepts a ScanReport or a plain round list (list = no kind
        information, everything is treated as provably bad).  Returns the
        rounds that could not be repaired (every peer failed or served
        forgeries); those stay quarantined rather than corrupt."""
        from ..chain.integrity import (UNLINKED, IntegrityScanner,
                                       ScanReport)
        from ..metrics import integrity_repaired
        unprovable: set = set()
        if isinstance(report_or_rounds, ScanReport):
            bad_rows = report_or_rounds.quarantinable_rounds
            faulty = report_or_rounds.faulty_rounds
            # promotable = rounds whose EVERY finding is UNLINKED: their
            # own bytes were never proven bad, only unprovable
            kinds: dict = {}
            for f in report_or_rounds.findings:
                kinds.setdefault(f.round, set()).add(f.kind)
            unprovable = {r for r, ks in kinds.items() if ks == {UNLINKED}}
        else:
            faulty = sorted(set(report_or_rounds))
            bad_rows = faulty
        if not faulty:
            return []
        IntegrityScanner(raw_store, self.scheme,
                         beacon_id=beacon_id).quarantine(bad_rows)
        fetch_first = [r for r in faulty if r not in unprovable]
        remaining = self.correct_past_beacons(raw_store, fetch_first, peers) \
            if fetch_first else []
        if unprovable:
            promoted = self._promote_tombstoned(raw_store,
                                                sorted(unprovable),
                                                beacon_id=beacon_id)
            leftover = [r for r in sorted(unprovable) if r not in promoted]
            if leftover:
                remaining += self.correct_past_beacons(raw_store, leftover,
                                                       peers)
        remaining = sorted(set(remaining))
        # a repaired round's stale tombstone must not linger (a later
        # promote pass could resurrect pre-repair bytes)
        drop = getattr(raw_store, "drop_tombstone", None)
        if drop is not None:
            for r in faulty:
                if r not in remaining:
                    try:
                        drop(r)
                    except Exception:
                        pass
        healed = len(faulty) - len(remaining)
        if healed > 0:
            integrity_repaired.labels(beacon_id).inc(healed)
        return remaining

    def _promote_tombstoned(self, raw_store, rounds: List[int],
                            beacon_id: str = "default") -> set:
        """Phase-2 repair: re-verify each tombstoned row against its (now
        hopefully restored) anchor and promote it back into the chain.
        Ascending order on purpose — a promoted round is the anchor of
        the next one, so a whole unprovable RUN above one corrupt row
        heals from a single peer-fetched anchor."""
        from ..metrics import integrity_promoted
        promoted: set = set()
        tombstoned = getattr(raw_store, "tombstoned", None)
        if tombstoned is None:
            return promoted
        for r in rounds:
            try:
                row = tombstoned(r)
            except Exception:
                row = None
            if row is None:
                continue
            prev = None
            if self.scheme.chained:
                try:
                    prev = raw_store.get(r - 1).signature
                except Exception:
                    continue        # anchor still missing: cannot prove
            try:
                ok = self.verifier.verify_batch([r], [row.signature], [prev])
            except Exception:
                continue
            if not bool(ok[0]):
                continue
            raw_store.put(Beacon(round=r, signature=row.signature,
                                 previous_sig=prev))
            raw_store.drop_tombstone(r)
            promoted.add(r)
        if promoted:
            integrity_promoted.labels(beacon_id).inc(len(promoted))
        return promoted

    def _fetch_one(self, peer, round_: int) -> Optional[Beacon]:
        """Single-round fetch.  Lets `BreakerOpen` propagate (client-side
        rejection — no dial happened) and tears the stream down on every
        exit: the production fetch is a SyncChain stream that live-follows
        forever after the replay, so returning mid-iteration without
        cancel() would leak one server-side stream per repaired round."""
        stream = self.fetch(peer, round_)
        try:
            for b in stream:
                if b.round == round_:
                    return b
                if b.round > round_:
                    return None
            return None
        finally:
            for name in ("cancel", "close"):
                fn = getattr(stream, name, None)
                if callable(fn):
                    try:
                        fn()
                    except Exception:
                        pass
                    break


class SyncChainServer:
    """Serving side of a sync stream (sync_manager.go:468-570)."""

    def __init__(self, chain):
        self.chain = chain                  # ChainStore facade

    def stream(self, remote_addr: str, from_round: int,
               stop: Optional[threading.Event] = None) -> Iterator[Beacon]:
        """Replay from `from_round` via cursor, then live-follow stored
        beacons through a callback keyed by the remote address — a
        re-request from the same address replaces the old stream's callback
        (sync_manager.go:542-560)."""
        stop = stop or threading.Event()
        q: queue.Queue = queue.Queue(maxsize=100)
        cb_id = f"sync-{remote_addr}"
        self.chain.cbstore.add_callback(cb_id, lambda b: _offer(q, b))
        sent = from_round - 1
        last = [None]       # previous STORE row yielded (the walk anchor)
        try:
            sent = yield from self._replay(from_round, sent, last)
            while not stop.is_set():
                try:
                    b = q.get(timeout=0.1)
                except queue.Empty:
                    continue
                if b is None:
                    return
                if b.round > sent + 1:
                    # the bounded queue dropped beacons (slow consumer):
                    # re-replay the hole from the store before following on
                    sent = yield from self._replay(sent + 1, sent, last)
                if b.round > sent:
                    yield self._fill_prev(b, last[0])
                    last[0] = b
                    sent = b.round
        finally:
            self.chain.cbstore.remove_callback(cb_id)

    def _replay(self, from_round: int, sent: int, last: list):
        """Cursor replay of stored rounds >= from_round; returns new `sent`."""
        cur = self.chain.store.cursor()
        b = cur.seek(from_round) if from_round > 0 else cur.first()
        while b is not None:
            if b.round > sent:
                yield self._fill_prev(b, last[0])
                last[0] = b
                sent = b.round
            b = cur.next()
        return sent

    def _fill_prev(self, b: Beacon, last: Optional[Beacon]) -> Beacon:
        """Trimmed stores (sqlite/postgres) materialize rows WITHOUT
        previous_sig, but a chained-scheme peer cannot link or verify a
        stream that omits it — fill it on the serving side from the walk
        itself (or one point read at the stream head).  Rounds whose
        anchor genuinely isn't stored (round 1, a hole) stream as-is and
        the peer anchors on its own head."""
        scheme = getattr(getattr(self.chain, "group", None), "scheme", None)
        if scheme is None or not scheme.chained \
                or b.previous_sig is not None:
            return b
        if last is not None and last.round == b.round - 1:
            prev_sig = last.signature
        else:
            try:
                prev_sig = self.chain.store.get(b.round - 1).signature
            except Exception:
                return b
        return Beacon(round=b.round, signature=b.signature,
                      previous_sig=prev_sig)


def _offer(q: queue.Queue, item) -> None:
    try:
        q.put_nowait(item)
    except queue.Full:
        pass  # slow stream consumer; the live loop's gap replay repairs


class _IdleTimeoutIter:
    """Iterator wrapper that gives up when the source is idle too long.

    The source is drained on a daemon thread into a queue; `__next__`
    raises StopIteration after `idle` seconds without an item, and the
    underlying gRPC call is cancelled if it exposes `cancel()`."""

    _END = object()

    def __init__(self, source, idle: float, stop: threading.Event):
        self._source = source
        self._idle = idle
        self._stop = stop
        self._dead = False          # consumer gave up; pump must exit
        self._q: queue.Queue = queue.Queue(maxsize=64)
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="sync-stream-pump")
        self._thread.start()

    def _pump(self):
        try:
            for item in self._source:
                while not self._stop.is_set() and not self._dead:
                    try:
                        self._q.put(item, timeout=1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set() or self._dead:
                    self._cancel()
                    return
        except Exception:
            pass
        finally:
            # the END sentinel must be delivered even through a full queue,
            # or the consumer only notices stream end after the idle timeout
            while not self._stop.is_set() and not self._dead:
                try:
                    self._q.put(self._END, timeout=1)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        try:
            item = self._q.get(timeout=self._idle)
        except queue.Empty:
            self._dead = True
            self._cancel()
            raise StopIteration
        if item is self._END:
            raise StopIteration
        return item

    def close(self):
        """Consumer is done with the stream: stop the pump + cancel the RPC."""
        self._dead = True
        self._cancel()
        # the pump exits within one queue-put timeout of _dead flipping;
        # bounded join so a close() during teardown reaps it
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2)

    def _cancel(self):
        cancel = getattr(self._source, "cancel", None)
        if callable(cancel):
            try:
                cancel()
            except Exception:
                pass
