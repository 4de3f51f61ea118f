"""Watch aggregator + polling watcher.

`WatchAggregator` (client/aggregator.go:26-219): fans ONE upstream watch
out to any number of subscribers, with auto-restart when the upstream
stream dies.  `PollingWatcher` (client/poll.go:17-62): synthesizes a watch
for transports with no streaming (plain HTTP) by polling `get` aligned to
the round schedule.

The port's copy of drand_tpu/client/aggregator.py, unchanged.
"""

import queue
import random
import threading

from ..common import make_lock
from typing import Iterator, List, Optional

from ..beacon.clock import Clock, RealClock
from ..chain.info import Info
from ..chain.timing import time_of_round
from ..net.resilience import BackoffPolicy
from .interface import Client, Result


class WatchAggregator(Client):
    def __init__(self, inner: Client, auto_watch: bool = False,
                 backoff: Optional[BackoffPolicy] = None,
                 rng: Optional[random.Random] = None):
        self.inner = inner
        # reconnect schedule for a dying upstream: exponential backoff with
        # full jitter (was a fixed 1s — a flapping upstream got hammered at
        # 1 Hz by every aggregator in the fleet simultaneously)
        self.backoff = backoff or BackoffPolicy(base=0.5, cap=15.0)
        self.rng = rng or random.Random()
        self._consecutive_failures = 0
        self._subs: List[queue.Queue] = []
        self._lock = make_lock()
        self._stop = threading.Event()
        self._pump: Optional[threading.Thread] = None
        if auto_watch:
            self._ensure_pump()

    def _ensure_pump(self) -> None:
        with self._lock:
            if self._pump is None:
                self._pump = threading.Thread(target=self._run, daemon=True,
                                              name="watch-aggregator")
                self._pump.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                for result in self.inner.watch(self._stop):
                    self._consecutive_failures = 0   # stream is live again
                    with self._lock:
                        subs = list(self._subs)
                    for q in subs:
                        try:
                            q.put_nowait(result)
                        except queue.Full:
                            pass
                    if self._stop.is_set():
                        return
            except Exception:
                pass
            # upstream died: retry with jittered backoff (aggregator.go
            # restarts the watch; the schedule grows while it keeps dying)
            delay = max(self.backoff.delay(self._consecutive_failures,
                                           self.rng), 0.2)
            self._consecutive_failures += 1
            self._stop.wait(delay)

    def get(self, round_: int = 0) -> Result:
        return self.inner.get(round_)

    def watch(self, stop: Optional[threading.Event] = None
              ) -> Iterator[Result]:
        self._ensure_pump()
        q: queue.Queue = queue.Queue(maxsize=32)
        with self._lock:
            self._subs.append(q)
        try:
            while not self._stop.is_set() \
                    and not (stop is not None and stop.is_set()):
                try:
                    yield q.get(timeout=0.2)
                except queue.Empty:
                    continue
        finally:
            with self._lock:
                self._subs.remove(q)

    def info(self) -> Info:
        return self.inner.info()

    def close(self) -> None:
        self._stop.set()
        with self._lock:
            pump, self._pump = self._pump, None
        if pump is not None:
            # the pump wakes from inner.watch/backoff on the stop event;
            # bounded join so a wedged upstream can't hang close()
            pump.join(timeout=2)
        self.inner.close()


class PollingWatcher(Client):
    """Wraps a get-only transport; watch polls once per round, aligned to
    the round schedule (client/poll.go:17-62)."""

    def __init__(self, inner: Client, clock: Optional[Clock] = None):
        self.inner = inner
        self.clock = clock or RealClock()

    def get(self, round_: int = 0) -> Result:
        return self.inner.get(round_)

    def info(self) -> Info:
        return self.inner.info()

    def watch(self, stop: Optional[threading.Event] = None
              ) -> Iterator[Result]:
        stop = stop or threading.Event()
        info = self.info()
        last = 0
        while not stop.is_set():
            try:
                result = self.inner.get(0)
                if result.round > last:
                    last = result.round
                    yield result
            except Exception:
                pass
            # sleep to just after the next round boundary ON the injected
            # clock — wait_until, not stop.wait(delay), so a FakeClock
            # test steps the schedule without real sleeps.  The floor of
            # now()+0.1 keeps a lagging watcher from busy-polling when
            # the boundary is already behind us; the one-period cap keeps
            # a bogus future round from the server (inflated `last`) from
            # parking the watcher past the next boundary it must re-check.
            nxt = time_of_round(info.period, info.genesis_time, last + 1)
            now = self.clock.now()
            deadline = min(max(nxt, now) + 0.1, now + info.period)
            if not self.clock.wait_until(deadline, stop):
                return

    def close(self) -> None:
        self.inner.close()
