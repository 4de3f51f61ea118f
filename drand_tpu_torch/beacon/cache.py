"""Partial-signature cache with anti-DoS bounds (chain/beacon/cache.go:17-168).

The port's copy of drand_tpu/beacon/cache.py, unchanged but for its imports.

Partials are cached per (round, previous_sig) key — a malicious node cannot
poison a round by sending a partial with a different previous signature than
honest nodes'.  Each signer index may occupy at most MAX_PARTIALS_PER_NODE
cached rounds; its oldest round is evicted beyond that (constants.go:14)."""

import threading

from ..common import make_lock
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..crypto.host.tbls import index_of

MAX_PARTIALS_PER_NODE = 100
# How many distinct INVALID partials one signer index may submit to a single
# round before that index is banned for the round.  Bounds both the `checked`
# map and the device-verification work an equivocating member can force
# (without it, distinct garbage blobs re-admit forever on a round that never
# reaches threshold).
MAX_BAD_PER_INDEX = 3


class _RoundCache:
    def __init__(self, round_: int, prev_sig: Optional[bytes]):
        self.round = round_
        self.prev_sig = prev_sig
        self.partials: Dict[int, bytes] = {}
        # partial BYTES -> verification outcome, filled at aggregation time.
        # Keyed by the exact bytes (not the signer index) so that dropping an
        # invalid partial and later receiving an honest one from the same
        # index forces re-verification, and an evicted-then-replaced partial
        # can never inherit a stale verdict.
        self.checked: Dict[bytes, bool] = {}
        self.bad_count: Dict[int, int] = {}

    def mark_bad(self, partial: bytes) -> None:
        """Record a failed verification verdict (called by the aggregator)."""
        self.checked[partial] = False
        idx = index_of(partial)
        self.bad_count[idx] = self.bad_count.get(idx, 0) + 1

    def append(self, partial: bytes) -> bool:
        idx = index_of(partial)
        if idx in self.partials:
            return False
        if self.bad_count.get(idx, 0) >= MAX_BAD_PER_INDEX:
            return False  # index banned for this round (anti-DoS)
        if self.checked.get(partial) is False:
            return False  # known-bad bytes; don't re-admit
        self.partials[idx] = partial
        return True

    def __len__(self) -> int:
        return len(self.partials)


class PartialCache:
    def __init__(self, max_per_node: int = MAX_PARTIALS_PER_NODE):
        self._lock = make_lock()
        self._rounds: Dict[Tuple[int, bytes], _RoundCache] = {}
        # per-signer FIFO of cache keys it occupies (eviction order)
        self._per_node: Dict[int, OrderedDict] = {}
        self._max_per_node = max_per_node

    @staticmethod
    def _key(round_: int, prev_sig: Optional[bytes]):
        return (round_, prev_sig or b"")

    def append(self, round_: int, prev_sig: Optional[bytes],
               partial: bytes) -> "_RoundCache":
        """Cache one partial; returns the round cache it landed in."""
        idx = index_of(partial)
        key = self._key(round_, prev_sig)
        with self._lock:
            rc = self._rounds.get(key)
            if rc is None:
                rc = self._rounds[key] = _RoundCache(round_, prev_sig)
            if rc.append(partial):
                self._note_occupancy_locked(idx, key)
            return rc

    def put_verified(self, round_: int, prev_sig: Optional[bytes],
                     partial: bytes) -> "_RoundCache":
        """Insert a partial KNOWN-GOOD for this (round, prev_sig) — the
        Handel overlay batch-verified it against the same digest.  Unlike
        `append`, it may EVICT an occupant of the signer slot whose bytes
        are not themselves verified-good: an ingress forgery (valid index,
        garbage sig — the cheap checks can't tell) must not squat the slot
        of an honestly verified partial, or one packet per node per round
        wedges aggregation at threshold-1.  A verified-good occupant is
        never displaced, and bytes previously marked bad never re-enter."""
        idx = index_of(partial)
        key = self._key(round_, prev_sig)
        with self._lock:
            rc = self._rounds.get(key)
            if rc is None:
                rc = self._rounds[key] = _RoundCache(round_, prev_sig)
            if rc.checked.get(partial) is False:
                return rc       # an explicit bad verdict is final
            rc.checked[partial] = True
            cur = rc.partials.get(idx)
            if cur is None or (cur != partial
                               and rc.checked.get(cur) is not True):
                rc.partials[idx] = partial
                self._note_occupancy_locked(idx, key)
            return rc

    def _note_occupancy_locked(self, idx: int, key) -> None:
        """Per-signer FIFO bookkeeping + eviction.  Caller holds _lock
        (both call sites acquire it around the whole insert)."""
        seen = self._per_node.setdefault(idx, OrderedDict())
        if key not in seen:
            seen[key] = True
            if len(seen) > self._max_per_node:
                evict_key, _ = seen.popitem(last=False)
                evicted = self._rounds.get(evict_key)
                if evicted is not None:
                    evicted.partials.pop(idx, None)
                    if not evicted.partials:
                        del self._rounds[evict_key]

    def get(self, round_: int, prev_sig: Optional[bytes]) -> Optional[_RoundCache]:
        with self._lock:
            return self._rounds.get(self._key(round_, prev_sig))

    def get_round_partials(self, round_: int) -> List[bytes]:
        """All partials cached for a round across prev-sig variants."""
        with self._lock:
            out = []
            for (r, _), rc in self._rounds.items():
                if r == round_:
                    out.extend(rc.partials.values())
            return out

    def flush_rounds(self, upto: int) -> None:
        """Drop every cached round <= upto (cache.go:55-70): once a beacon is
        stored, its partials are useless."""
        with self._lock:
            for key in [k for k in self._rounds if k[0] <= upto]:
                del self._rounds[key]
            for seen in self._per_node.values():
                for key in [k for k in seen if k[0] <= upto]:
                    del seen[key]
