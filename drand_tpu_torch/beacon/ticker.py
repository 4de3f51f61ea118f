"""Genesis-anchored round ticker (chain/beacon/ticker.go:13-131).

The port's copy of drand_tpu/beacon/ticker.py, unchanged but for its imports.

One thread computes each round boundary from (genesis, period) — never by
accumulating sleeps, so drift cannot build up — and fans (round, time) ticks
out to subscriber queues.  Subscribers registered with a `start_at` time only
see ticks from that time on (ticker.go:42-58)."""

import queue
import threading

from ..common import make_lock
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..chain.timing import current_round, time_of_round
from .clock import Clock


@dataclass
class Tick:
    round: int
    time: int


class Ticker:
    def __init__(self, clock: Clock, period: int, genesis_time: int):
        self.clock = clock
        self.period = period
        self.genesis = genesis_time
        self._subs: List[Tuple[queue.Queue, int]] = []
        self._lock = make_lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def current_round(self) -> int:
        return current_round(int(self.clock.now()), self.period, self.genesis)

    def channel(self, start_at: int = 0) -> "queue.Queue[Tick]":
        """Queue of future ticks; only ticks at/after `start_at` delivered."""
        q: queue.Queue = queue.Queue()
        with self._lock:
            self._subs.append((q, start_at))
        return q

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ticker")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        last_fired = 0
        while not self._stop.is_set():
            now = int(self.clock.now())
            if now < self.genesis:
                if not self.clock.wait_until(self.genesis, self._stop):
                    return
                continue
            r = current_round(now, self.period, self.genesis)
            if last_fired >= r:
                # current round already fired; wait for the next boundary.
                # A (fake) clock jumping several periods fires only the then-
                # current round — missed rounds are the catchup path's job.
                if not self.clock.wait_until(
                        time_of_round(self.period, self.genesis, last_fired + 1),
                        self._stop):
                    return
                continue
            t = time_of_round(self.period, self.genesis, r)
            tick = Tick(round=r, time=t)
            last_fired = r
            with self._lock:
                subs = list(self._subs)
            for q, start_at in subs:
                if t >= start_at:
                    q.put(tick)
