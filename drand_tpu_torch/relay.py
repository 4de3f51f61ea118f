"""Relays: re-serve a drand chain from any client stack.

The port's copy of drand_tpu/relay.py, without its gRPC fan-out and gossip
relays (`GrpcRelayNode`, `GossipRelayNode`), which wait for the port's gRPC
transport.  Reference surface:
  * HTTP relay (cmd/relay/main.go:1-184): standalone REST frontend over a
    client.Client — same routes as the daemon's edge, but backed by remote
    sources.
  * S3 relay (cmd/relay-s3/main.go:43-199): uploads every round as a
    public JSON object + a `latest` pointer.  The object-store interface is
    pluggable: a local-directory backend, and an S3 backend over the
    stdlib SigV4 client (s3.py).
  * `ValidatingWatch`: the gossip validator semantic
    (lp2p/client/validator.go:18-68) over any client's watch, with full BLS
    validation before a round is relayed.
"""

import json
import os
import threading

from typing import Iterator, Optional

from .beacon.clock import Clock, RealClock
from .client.interface import Client, Result
from .client.verify import verify_beacon_with_info
from .log import Logger


# ---------------------------------------------------------------------------
# Validating watch: the gossip validator semantic (validator.go:18-68)
# ---------------------------------------------------------------------------

class ValidatingWatch:
    """Wraps a client's watch: drops future rounds, duplicates, and
    anything that fails full BLS verification — the relay never
    republishes junk."""

    def __init__(self, client: Client, log: Logger,
                 clock: Optional[Clock] = None):
        self.client = client
        self.log = log
        self.clock = clock or RealClock()
        self.info = client.info()
        self._seen_max = 0

    def watch(self, stop: Optional[threading.Event] = None
              ) -> Iterator[Result]:
        from .chain.timing import current_round
        for res in self.client.watch(stop):
            now_round = current_round(int(self.clock.now()),
                                      self.info.period,
                                      self.info.genesis_time)
            if res.round > now_round + 1:
                self.log.warn("dropping future round", round=res.round)
                continue
            if res.round <= self._seen_max:
                continue
            if not verify_beacon_with_info(self.info, res.beacon()):
                self.log.warn("dropping invalid beacon", round=res.round)
                continue
            self._seen_max = res.round
            yield res


# ---------------------------------------------------------------------------
# Object-store relay (the S3 relay shape)
# ---------------------------------------------------------------------------

class ObjectStore:
    """Object-store interface (cmd/relay-s3's S3 usage)."""

    def put(self, key: str, data: bytes, content_type: str) -> None:
        raise NotImplementedError

    def get(self, key: str):
        """Returns bytes or None when absent."""
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        return self.get(key) is not None


class DirObjectStore(ObjectStore):
    """Local-directory backend (any FUSE/rclone-mounted bucket)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def put(self, key: str, data: bytes, content_type: str) -> None:
        path = os.path.join(self.root, key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path + ".tmp", "wb") as f:
            f.write(data)
        os.replace(path + ".tmp", path)

    def get(self, key: str):
        try:
            with open(os.path.join(self.root, key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def exists(self, key: str) -> bool:
        return os.path.exists(os.path.join(self.root, key))


class S3ObjectStore(ObjectStore):
    """S3 backend over the stdlib SigV4 client (s3.py) — rounds
    are immutable public JSON objects (cmd/relay-s3/main.go:127-146:
    public-read ACL + a week-long immutable cache-control)."""

    IMMUTABLE_CC = "public, max-age=604800, immutable"

    def __init__(self, bucket: str, region: str = "us-east-1",
                 endpoint=None, access_key=None, secret_key=None):
        from .s3 import S3Client
        self.client = S3Client(bucket, region, endpoint=endpoint,
                               access_key=access_key, secret_key=secret_key)

    def put(self, key: str, data: bytes, content_type: str) -> None:
        # `latest`/`info` pointers are mutable; round objects immutable
        cc = None if key.endswith(("/latest", "/info")) else self.IMMUTABLE_CC
        self.client.put_object(key, data, content_type, cache_control=cc)

    def get(self, key: str):
        return self.client.get_object(key)

    def exists(self, key: str) -> bool:
        return self.client.head_object(key)


class ObjectStoreRelay:
    """Uploads every verified round as `<chain-hash>/public/<round>` JSON
    plus a `latest` pointer (cmd/relay-s3/main.go:43-199)."""

    def __init__(self, client: Client, store: ObjectStore,
                 log: Optional[Logger] = None,
                 clock: Optional[Clock] = None):
        self.client = client
        self.store = store
        self.log = (log or Logger()).named("s3-relay")
        self.clock = clock or RealClock()
        self.info = client.info()
        self.prefix = self.info.hash().hex()
        self.valid = ValidatingWatch(client, self.log, clock=self.clock)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _obj(self, res: Result) -> bytes:
        obj = {"round": res.round, "randomness": res.randomness.hex(),
               "signature": res.signature.hex()}
        if res.previous_signature:
            obj["previous_signature"] = res.previous_signature.hex()
        return json.dumps(obj, separators=(",", ":")).encode()

    def upload(self, res: Result, update_latest: bool = True) -> None:
        data = self._obj(res)
        self.store.put(f"{self.prefix}/public/{res.round}", data,
                       "application/json")
        if update_latest:
            self.store.put(f"{self.prefix}/public/latest", data,
                           "application/json")

    def sync(self, from_round: int, to_round: int) -> int:
        """Backfill rounds [from, to] against the bucket, skipping objects
        already uploaded (cmd/relay-s3/main.go:149-199 `sync`; the skip is
        the main.go:181 TODO made real)."""
        n = 0
        for r in range(from_round, to_round + 1):
            if self.store.exists(f"{self.prefix}/public/{r}"):
                continue
            res = self.client.get(r)
            if verify_beacon_with_info(self.info, res.beacon()):
                # backfill must not rewind the `latest` pointer
                self.upload(res, update_latest=False)
                n += 1
        return n

    def start(self) -> None:
        self.store.put(f"{self.prefix}/info", self.info.to_json(),
                       "application/json")

        def run():
            while not self._stop.is_set():
                try:
                    for res in self.valid.watch(self._stop):
                        self.upload(res)
                        if self._stop.is_set():
                            return
                except Exception as e:
                    self.log.warn("relay watch failed; retrying", err=str(e))
                self._stop.wait(1.0)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="s3-relay")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)


# ---------------------------------------------------------------------------
# HTTP relay (cmd/relay): REST frontend over a client stack
# ---------------------------------------------------------------------------

class HttpRelay:
    """Serves /info /public/{round}|latest /health from a client stack."""

    def __init__(self, client: Client, listen: str = "127.0.0.1:0",
                 log: Optional[Logger] = None):
        from http.server import BaseHTTPRequestHandler

        from .http_server import BoundedHTTPServer

        self.client = client
        self.info = client.info()
        self.log = (log or Logger()).named("http-relay")
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                try:
                    code, body = outer._route(self.path)
                except Exception as e:
                    code, body = 500, json.dumps({"error": str(e)}).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body)

        host, _, port = listen.rpartition(":")
        # bounded worker pool, not thread-per-request: an edge relay is
        # the FIRST thing a read flood hits (net/admission.py doctrine)
        self.httpd = BoundedHTTPServer((host or "127.0.0.1", int(port)),
                                       Handler, workers=8)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def _route(self, path: str):
        parts = [p for p in path.split("/") if p]
        if parts and len(parts[0]) == 64:
            if parts[0] != self.info.hash().hex():
                return 404, b'{"error":"unknown chain"}'
            parts = parts[1:]
        if parts == ["info"]:
            return 200, self.info.to_json()
        if parts == ["health"]:
            return 200, b'{"status":true}'
        if len(parts) == 2 and parts[0] == "public":
            round_ = 0 if parts[1] == "latest" else int(parts[1])
            res = self.client.get(round_)
            obj = {"round": res.round, "randomness": res.randomness.hex(),
                   "signature": res.signature.hex()}
            if res.previous_signature:
                obj["previous_signature"] = res.previous_signature.hex()
            return 200, json.dumps(obj, separators=(",", ":")).encode()
        return 404, b'{"error":"no such route"}'

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="http-relay")
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)
        self.client.close()
