"""Injectable clocks: the port's copy of drand_tpu/beacon/clock.py (the
clockwork pattern of drand's core/util_test.go:43-78).  The verify service
never calls time.time() directly, so tests can step time deterministically."""

import threading
import time
from abc import ABC, abstractmethod

from ..common import make_condition


class Clock(ABC):
    @abstractmethod
    def now(self) -> float: ...

    def monotonic(self) -> float:
        """Elapsed-time source for measuring DURATIONS (queue age,
        timeouts) as opposed to reading the schedule.  Defaults to now()
        — fake clocks only move forward, so their one timeline serves
        both — but RealClock overrides it with time.monotonic() so an
        NTP step or VM suspend/resume can't corrupt a duration."""
        return self.now()

    @abstractmethod
    def wait_until(self, deadline: float, stop: threading.Event) -> bool:
        """Block until now() >= deadline or `stop` is set.  Returns True if
        the deadline was reached (False = stopped)."""


class RealClock(Clock):
    def now(self) -> float:
        return time.time()

    def monotonic(self) -> float:
        return time.monotonic()

    def wait_until(self, deadline: float, stop: threading.Event) -> bool:
        while not stop.is_set():
            delta = deadline - self.now()
            if delta <= 0:
                return True
            stop.wait(min(delta, 0.5))
        return False


class FakeClock(Clock):
    """Manually advanced clock; all waiters share one condition variable."""

    def __init__(self, start: float = 0.0):
        self._now = start
        self._cond = make_condition()

    def now(self) -> float:
        with self._cond:
            return self._now

    def set_time(self, t: float) -> None:
        with self._cond:
            if t < self._now:
                raise ValueError("fake clock cannot go backwards")
            self._now = t
            self._cond.notify_all()

    def advance(self, dt: float) -> None:
        with self._cond:
            self._now += dt
            self._cond.notify_all()

    def wait_until(self, deadline: float, stop: threading.Event) -> bool:
        with self._cond:
            while self._now < deadline:
                if stop.is_set():
                    return False
                # Poll stop with a real-time bound so shutdown can't hang a
                # waiter whose fake deadline never arrives.
                self._cond.wait(0.05)
            return not stop.is_set() or self._now >= deadline
