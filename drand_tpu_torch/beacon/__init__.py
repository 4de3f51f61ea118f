"""Beacon protocol engine (the port's copy of drand_tpu/beacon/, without
Handel): clocks, ticker, partial cache, aggregator, store decorators, the
round-loop handler and the sync manager."""

from .clock import Clock, FakeClock, RealClock
from .ticker import Ticker
from .cache import PartialCache
from .chainstore import ChainStore
from .node import Handler, HandlerConfig

__all__ = ["Clock", "RealClock", "FakeClock", "Ticker", "PartialCache",
           "ChainStore", "Handler", "HandlerConfig"]
