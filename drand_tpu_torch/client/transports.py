"""Client transports: gRPC (client/grpc/client.go:24-146) and REST/HTTP
(client/http/http.go:35-396).

The port's copy of drand_tpu/client/transports.py.  `GrpcTransport` imports
the gRPC plane (net/client.py, net/convert.py) when it is built rather
than at module import, so the REST client runs where grpc is absent.
"""

import json
import threading
import urllib.request
from typing import Iterator, Optional

from ..chain.beacon import Beacon
from ..chain.info import Info
from ..metrics import client_http_heartbeat, registered_label
from .interface import Client, Result


class GrpcTransport(Client):
    """`client.Client` over the Public gRPC service."""

    def __init__(self, address: str, beacon_id: str = "", tls: bool = False,
                 client=None):
        from ..net import Peer, ProtocolClient, convert
        self._convert = convert
        self.peer = Peer(address, tls)
        self.beacon_id = beacon_id
        self.client = client or ProtocolClient()
        self._own_client = client is None

    def get(self, round_: int = 0) -> Result:
        resp = self.client.public_rand(self.peer, round_, self.beacon_id)
        return Result.from_beacon(self._convert.rand_to_beacon(resp))

    def watch(self, stop: Optional[threading.Event] = None
              ) -> Iterator[Result]:
        stop = stop or threading.Event()
        for resp in self.client.public_rand_stream(self.peer, 0,
                                                   self.beacon_id):
            if stop.is_set():
                return
            yield Result.from_beacon(self._convert.rand_to_beacon(resp))

    def info(self) -> Info:
        return self._convert.proto_to_info(
            self.client.chain_info(self.peer, self.beacon_id))

    def close(self) -> None:
        if self._own_client:
            self.client.close()


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
