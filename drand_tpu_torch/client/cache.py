"""LRU caching client (reference: client/cache.go:13-119; LRU size 32).

The port's copy of drand_tpu/client/cache.py, unchanged.
"""

import threading

from ..common import make_lock
from collections import OrderedDict
from typing import Iterator, Optional

from ..chain.info import Info
from .interface import Client, Result

CACHE_SIZE = 32


class CachingClient(Client):
    def __init__(self, inner: Client, size: int = CACHE_SIZE):
        self.inner = inner
        self.size = size
        self._cache: "OrderedDict[int, Result]" = OrderedDict()
        self._lock = make_lock()

    def get(self, round_: int = 0) -> Result:
        if round_ != 0:
            with self._lock:
                hit = self._cache.get(round_)
                if hit is not None:
                    self._cache.move_to_end(round_)
                    return hit
        result = self.inner.get(round_)
        self._remember(result)
        return result

    def _remember(self, result: Result) -> None:
        with self._lock:
            self._cache[result.round] = result
            self._cache.move_to_end(result.round)
            while len(self._cache) > self.size:
                self._cache.popitem(last=False)

    def watch(self, stop: Optional[threading.Event] = None
              ) -> Iterator[Result]:
        for result in self.inner.watch(stop):
            self._remember(result)
            yield result

    def info(self) -> Info:
        return self.inner.info()

    def close(self) -> None:
        self.inner.close()
