"""Verifying client (reference: client/verify.go:13-199 — north-star loop #2).

The port's copy of drand_tpu/client/verify.py.  Every result is verified
against the chain info before it is returned.  In strict chained mode the
client walks from its last point of trust to the requested round: it
checks the linkage on the host, then submits the whole span as ONE
``verify_batch`` to the process-default verify service
(``crypto/verify_service.py``), which coalesces it with every other
caller's work into padded batches: the chain-catchup case.

Where each check runs:

  * a span of ``DEVICE_MIN_BATCH`` (64) rounds or more goes to the
    service's device handle, on the LIVE lane.  The handle runs on the
    card (``handle(device=True)``); in a process without one it raises,
    and the CPU is reached only through a service built on a CPU pool and
    installed with ``set_service``.  The handle has no ``fallback=``, so a
    card failure during a sweep reaches the caller as an exception;
  * a single get, and a span under 64 rounds, goes to the service's host
    handle (``device=False``): routing by size, as the reference does, not
    a fallback.  ``verify_beacon_with_info`` (the relays' check) verifies
    one beacon on the host too.
"""

import threading

from ..common import make_lock
from typing import Iterator, Optional

from ..chain.beacon import Beacon
from ..chain.info import Info
from ..crypto.schemes import scheme_from_name
from ..log import Logger
from .interface import Client, Result


def verify_beacon_with_info(info: Info, beacon: Beacon) -> bool:
    scheme = scheme_from_name(info.scheme)
    return scheme.verify_beacon(info.public_key, beacon.round,
                                beacon.previous_sig, beacon.signature)


class VerifyingClient(Client):
    def __init__(self, inner: Client, info: Optional[Info] = None,
                 strict: bool = False, log: Optional[Logger] = None):
        """`strict`: full chained-walk verification from the last verified
        point of trust (client.WithFullChainVerification)."""
        self.inner = inner
        self._info = info
        self.strict = strict
        self.log = (log or Logger()).named("verify")
        self._lock = make_lock()
        self._trusted: Optional[Beacon] = None   # last verified beacon
        self._scheme = None
        self._verifier = None

    # -- plumbing ------------------------------------------------------------

    def info(self) -> Info:
        if self._info is None:
            self._info = self.inner.info()
        return self._info

    # spans below this size verify on the host handle: a device pass only
    # pays off on real sweeps
    DEVICE_MIN_BATCH = 64

    def _ensure_crypto(self):
        if self._verifier is None:
            # the host handle behind the verify service's submit API:
            # single interactive gets ride the LIVE-priority host path (a
            # device round trip is wrong for a one-beacon check)
            from ..crypto.verify_service import get_service
            info = self.info()
            self._scheme = scheme_from_name(info.scheme)
            self._verifier = get_service().handle(self._scheme,
                                                  info.public_key,
                                                  device=False)
            self._device_verifier = None
        return self._scheme, self._verifier

    def _sweep_verifier(self, n: int):
        """The verify service's device handle for large spans (no
        fallback: its errors reach the caller), the host handle otherwise
        (the service coalesces sweep chunks from all clients into
        canonical padded batches)."""
        if n < self.DEVICE_MIN_BATCH:
            return self._verifier
        if self._device_verifier is None:
            from ..crypto.verify_service import get_service
            info = self.info()
            self._device_verifier = get_service().handle(self._scheme,
                                                         info.public_key)
        return self._device_verifier

    # -- Client --------------------------------------------------------------

    def get(self, round_: int = 0) -> Result:
        result = self.inner.get(round_)
        return self._verified(result)

    def watch(self, stop: Optional[threading.Event] = None
              ) -> Iterator[Result]:
        for result in self.inner.watch(stop):
            try:
                yield self._verified(result)
            except ValueError as e:
                self.log.warn("dropping unverifiable watch result",
                              round=result.round, err=str(e))

    def close(self) -> None:
        self.inner.close()

    # -- verification --------------------------------------------------------

    def _verified(self, result: Result) -> Result:
        scheme, verifier = self._ensure_crypto()
        beacon = result.beacon()
        if self.strict and scheme.chained:
            self._walk_to(beacon)
        elif not verifier.verify_batch(
                [beacon.round], [beacon.signature],
                [beacon.previous_sig], lane="live").all():
            raise ValueError(f"round {beacon.round}: invalid signature")
        with self._lock:
            if self._trusted is None or beacon.round > self._trusted.round:
                self._trusted = beacon
        # randomness is recomputed locally, never trusted from the wire
        # (verify.go:197)
        return Result.from_beacon(beacon)

    def _walk_to(self, target: Beacon) -> None:
        """Chained catch-up from the last point of trust, batch-verified
        (getTrustedPreviousSignature verify.go:109-171, redesigned as one
        sweep through the verify service)."""
        scheme, verifier = self._ensure_crypto()
        with self._lock:
            trusted = self._trusted
        if trusted is not None and target.round <= trusted.round:
            # historical round at or before the trust point: the chain walk
            # doesn't apply (it only extends the frontier); verify the
            # signature directly
            if not verifier.verify_batch([target.round], [target.signature],
                                         [target.previous_sig],
                                         lane="live").all():
                raise ValueError(
                    f"round {target.round}: invalid signature")
            return
        start = trusted.round + 1 if trusted is not None else 1
        span: list = []
        for r in range(start, target.round):
            span.append(self.inner.get(r).beacon())
        span.append(target)
        # host linkage prefix pass, then one signature sweep
        prev = trusted
        for b in span:
            if prev is not None and b.previous_sig != prev.signature:
                raise ValueError(f"round {b.round}: chain linkage broken")
            prev = b
        # ONE submission for the whole span: the verify service splits it
        # into canonical padded chunks itself (and overlaps host packing
        # with device compute).  Live lane like the sibling point checks:
        # the walk serves an interactive get(), so it preempts background
        # scans rather than queueing behind them
        sweeper = self._sweep_verifier(len(span))
        ok = sweeper.verify_batch(
            [b.round for b in span],
            [b.signature for b in span],
            [b.previous_sig for b in span], lane="live")
        if not ok.all():
            bad = [b.round for b, good in zip(span, ok) if not good]
            raise ValueError(f"invalid signatures at rounds {bad}")
