"""Client interfaces (reference: client/interface.go:13-41).

A `Client` fetches verified randomness from one or more drand nodes.
`Result` carries one round's randomness; `watch()` yields results as new
rounds land.

The port's copy of drand_tpu/client/interface.py, unchanged.
"""

import threading
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Iterator, Optional

from ..chain.beacon import Beacon
from ..chain.info import Info
from ..chain.timing import current_round


@dataclass(frozen=True)
class Result:
    round: int
    randomness: bytes
    signature: bytes
    previous_signature: Optional[bytes] = None

    @classmethod
    def from_beacon(cls, b: Beacon) -> "Result":
        return cls(round=b.round, randomness=b.randomness(),
                   signature=b.signature, previous_signature=b.previous_sig)

    def beacon(self) -> Beacon:
        return Beacon(round=self.round, signature=self.signature,
                      previous_sig=self.previous_signature)


class Client(ABC):
    @abstractmethod
    def get(self, round_: int = 0) -> Result:
        """Fetch one round (0 = latest)."""

    @abstractmethod
    def watch(self, stop: Optional[threading.Event] = None
              ) -> Iterator[Result]:
        """Yield results as rounds are produced."""

    @abstractmethod
    def info(self) -> Info:
        """The chain info (root of trust)."""

    def round_at(self, t: float) -> int:
        info = self.info()
        return current_round(int(t), info.period, info.genesis_time)

    def close(self) -> None:
        pass
