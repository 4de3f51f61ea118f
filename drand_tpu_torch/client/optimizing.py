"""Optimizing client (reference: client/optimizing.go:36-638).

Tracks per-source latency, re-probing every `speed_test_interval`; `get`
races the top-2 fastest sources with a stagger and returns the first
success; `watch` follows the fastest source and fails over on error.

Ranking is breaker-aware (net/resilience.py): a source that keeps failing
trips its circuit breaker and sinks to the back of the ranking until its
cooldown elapses, regardless of how fast it was when it last answered —
latency measures the happy path, the breaker remembers the sad one.

The port's copy of drand_tpu/client/optimizing.py, unchanged.
"""

import threading

from ..common import make_lock
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Iterator, List, Optional

from ..chain.info import Info
from ..log import Logger
from ..net.resilience import ResiliencePolicy
from .interface import Client, Result

SPEED_TEST_INTERVAL = 300.0     # optimizing.go: 5 min
RACE_STAGGER = 0.5              # head start for the fastest source (s)
DEFAULT_TIMEOUT = 5.0


class _Source:
    def __init__(self, client: Client, key: str):
        self.client = client
        self.key = key              # breaker key for this transport
        self.latency = float("inf")

    def probe(self) -> None:
        t0 = time.perf_counter()
        try:
            self.client.get(0)
            self.latency = time.perf_counter() - t0
        except Exception:
            self.latency = float("inf")


class OptimizingClient(Client):
    def __init__(self, sources: List[Client],
                 speed_test_interval: float = SPEED_TEST_INTERVAL,
                 log: Optional[Logger] = None,
                 resilience: Optional[ResiliencePolicy] = None):
        if not sources:
            raise ValueError("optimizing client needs at least one source")
        self.sources = [_Source(c, f"source-{i}")
                        for i, c in enumerate(sources)]
        self.log = (log or Logger()).named("optimizing")
        self.resilience = resilience or ResiliencePolicy(scope="client")
        self._stop = threading.Event()
        self._lock = make_lock()
        self._interval = speed_test_interval
        self._prober: Optional[threading.Thread] = None

    def start_speed_tests(self) -> None:
        """Periodic latency ranking (optimizing.go testSpeed)."""
        if self._prober is None:
            self._prober = threading.Thread(target=self._probe_loop,
                                            daemon=True, name="speed-test")
            self._prober.start()

    def _probe_loop(self) -> None:
        while not self._stop.is_set():
            for s in self.sources:
                if self._stop.is_set():
                    return
                s.probe()
            self._stop.wait(self._interval)

    def _ranked(self) -> List[_Source]:
        """Closed-breaker sources first (then by latency); quarantined ones
        last, but never dropped — they are the fallback of last resort."""
        pref = self.resilience.breakers.preference
        with self._lock:
            return sorted(self.sources,
                          key=lambda s: (pref(s.key), s.latency))

    def _record(self, src: _Source, ok: bool) -> None:
        br = self.resilience.breaker(src.key)
        br.record_success() if ok else br.record_failure()

    # -- Client --------------------------------------------------------------

    def get(self, round_: int = 0) -> Result:
        """Race the two fastest sources with a stagger
        (optimizing.go:233-266,287-350)."""
        ranked = self._ranked()
        racers = ranked[:2]
        errors: List[Exception] = []
        with ThreadPoolExecutor(max_workers=len(racers)) as pool:
            futures = {}
            for i, src in enumerate(racers):
                if i > 0:
                    done, _ = wait(futures, timeout=RACE_STAGGER,
                                   return_when=FIRST_COMPLETED)
                    for f in done:
                        # pop: a failure resolved here must not be counted
                        # against the breaker again by the final loop below
                        f_src = futures.pop(f)
                        try:
                            # f is in the `done` set of wait() above —
                            # result() cannot block
                            # tpu-vet: disable=wait
                            result = f.result()
                            self._record(f_src, ok=True)
                            return result
                        except Exception as e:
                            self._record(f_src, ok=False)
                            errors.append(e)
                futures[pool.submit(src.client.get, round_)] = src
            for f, src in futures.items():
                try:
                    result = f.result(timeout=DEFAULT_TIMEOUT)
                    src.latency = min(src.latency, DEFAULT_TIMEOUT)
                    self._record(src, ok=True)
                    return result
                except Exception as e:
                    src.latency = float("inf")
                    self._record(src, ok=False)
                    errors.append(e)
        raise errors[-1] if errors else RuntimeError("no source succeeded")

    def watch(self, stop: Optional[threading.Event] = None
              ) -> Iterator[Result]:
        """Follow the fastest source; on stream failure fail over to the
        next (optimizing.go watch failover)."""
        stop = stop or self._stop
        last_round = 0
        while not stop.is_set():
            progressed = False
            for src in self._ranked():
                src_progressed = False
                try:
                    for result in src.client.watch(stop):
                        if result.round > last_round:
                            last_round = result.round
                            if not src_progressed:
                                src_progressed = True
                                self._record(src, ok=True)
                            progressed = True
                            yield result
                        if stop.is_set():
                            return
                except Exception as e:
                    self._record(src, ok=False)
                    self.log.warn("watch source failed; failing over",
                                  err=str(e))
                    continue
            if not progressed:
                # every source failed without yielding: back off briefly
                if stop.wait(1.0):
                    return

    def info(self) -> Info:
        err: Optional[Exception] = None
        for src in self._ranked():
            try:
                return src.client.info()
            except Exception as e:
                err = e
        raise err or RuntimeError("no source for info")

    def close(self) -> None:
        self._stop.set()
        prober, self._prober = self._prober, None
        if prober is not None:
            prober.join(timeout=2)
        for s in self.sources:
            s.client.close()
