"""Client transports: REST/HTTP (client/http/http.go:35-396).

The port's copy of drand_tpu/client/transports.py without its gRPC
transport (client/grpc/client.go:24-146), which waits for the port's
net/client.py; `HttpTransport` is unchanged.
"""

import json
import threading
import urllib.request
from typing import Iterator, Optional

from ..chain.beacon import Beacon
from ..chain.info import Info
from ..metrics import client_http_heartbeat, registered_label
from .interface import Client, Result


class HttpTransport(Client):
    """REST consumer of the L8 edge: `/info`, `/public/{round|latest}`
    (client/http/http.go; validates randomness == SHA256(sig),
    http.go:341-354).  Watch is by polling (wrap in PollingWatcher)."""

    def __init__(self, base_url: str, chain_hash: str = "",
                 timeout: float = 10.0):
        self.base = base_url.rstrip("/")
        if chain_hash:
            self.base = f"{self.base}/{chain_hash}"
        self.timeout = timeout
        self._info: Optional[Info] = None

    def _fetch(self, path: str) -> dict:
        url = f"{self.base}{path}"
        with urllib.request.urlopen(url, timeout=self.timeout) as r:
            # endpoints come from operator config, but cap the series set
            # anyway — a misconfigured rotating gateway URL must not mint
            # a fresh time series per request
            client_http_heartbeat.labels(
                registered_label(self.base, ns="client-endpoint",
                                 limit=16)).inc()
            return json.loads(r.read())

    def get(self, round_: int = 0) -> Result:
        path = f"/public/{round_}" if round_ else "/public/latest"
        obj = self._fetch(path)
        beacon = Beacon(
            round=int(obj["round"]),
            signature=bytes.fromhex(obj["signature"]),
            previous_sig=(bytes.fromhex(obj["previous_signature"])
                          if obj.get("previous_signature") else None))
        rand = bytes.fromhex(obj.get("randomness", ""))
        if rand and rand != beacon.randomness():
            raise ValueError("server randomness != SHA256(signature)")
        return Result.from_beacon(beacon)

    def watch(self, stop: Optional[threading.Event] = None
              ) -> Iterator[Result]:
        from .aggregator import PollingWatcher
        return PollingWatcher(self).watch(stop)

    def info(self) -> Info:
        if self._info is None:
            self._info = Info.from_json(
                json.dumps(self._fetch("/info")).encode())
        return self._info
