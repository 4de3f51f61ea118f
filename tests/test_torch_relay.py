"""The port's relays and S3 client (drand_tpu_torch/relay.py, s3.py):
tests/test_relay_http.py's grpc-free cases over the port, with its fake
S3 endpoint, and the HTTP relay's routes beside the reference's."""

import json
import threading
import urllib.error
import urllib.request

import pytest

from drand_tpu_torch.chain.beacon import Beacon
from drand_tpu_torch.log import Logger
from drand_tpu_torch.relay import (DirObjectStore, HttpRelay,
                                   ObjectStoreRelay, S3ObjectStore,
                                   ValidatingWatch)

from test_relay_http import _FakeS3
from test_torch_client import _ref_chain, _ref_source
from torch_beacon_harness import MockChain, MockSource


@pytest.fixture(scope="module")
def chain():
    return MockChain(n=5)


def test_validating_watch_drops_invalid(chain):
    # round 3 carries round 4's signature in a copy of the chain
    beacons = dict(chain.beacons)
    good = chain.beacons[3]
    beacons[3] = Beacon(round=3, signature=chain.beacons[4].signature,
                        previous_sig=good.previous_sig)
    vw = ValidatingWatch(MockSource(chain, beacons=beacons), Logger())
    rounds = [r.round for r in vw.watch(threading.Event())]
    assert 3 not in rounds
    assert set(rounds) == {1, 2, 4, 5}


def test_object_store_relay(chain, tmp_path):
    store = DirObjectStore(str(tmp_path / "bucket"))
    relay = ObjectStoreRelay(MockSource(chain), store)
    n = relay.sync(1, 5)
    assert n == 5
    prefix = chain.info.hash().hex()
    obj = json.loads((tmp_path / "bucket" / prefix / "public" / "3").read_text())
    assert obj["round"] == 3
    assert obj["randomness"] == chain.beacons[3].randomness().hex()
    # live upload path writes latest too
    relay.upload(relay.client.get(5))
    latest = json.loads(
        (tmp_path / "bucket" / prefix / "public" / "latest").read_text())
    assert latest["round"] == 5


def test_sigv4_canonical_uri_single_encoded():
    """The canonical URI must be the already-encoded URL path verbatim —
    re-quoting double-encodes keys with space/%/non-ASCII and AWS rejects
    the signature.  Pinned against an independent reference computation."""
    import datetime
    import hashlib
    import hmac as hmac_mod

    from drand_tpu_torch.s3 import SigV4Signer

    signer = SigV4Signer("AK", "SK", "r1")
    now = datetime.datetime(2026, 1, 2, 3, 4, 5,
                            tzinfo=datetime.timezone.utc)
    # key "a b.txt" -> once-encoded path /bkt/a%20b.txt (as _url builds it)
    url = "https://s3.test/bkt/a%20b.txt"
    hdrs = signer.sign("PUT", url, {}, b"payload", now=now)
    sig = hdrs["Authorization"].rsplit("Signature=", 1)[1]

    # independent AWS SigV4 reference: canonical URI is the single-encoded
    # path, NOT quote()d again
    payload_hash = hashlib.sha256(b"payload").hexdigest()
    canonical = "\n".join([
        "PUT", "/bkt/a%20b.txt", "",
        "host:s3.test\n"
        f"x-amz-content-sha256:{payload_hash}\n"
        "x-amz-date:20260102T030405Z\n",
        "host;x-amz-content-sha256;x-amz-date", payload_hash])
    scope = "20260102/r1/s3/aws4_request"
    to_sign = "\n".join([
        "AWS4-HMAC-SHA256", "20260102T030405Z", scope,
        hashlib.sha256(canonical.encode()).hexdigest()])
    k = b"AWS4SK"
    for part in ("20260102", "r1", "s3", "aws4_request"):
        k = hmac_mod.new(k, part.encode(), hashlib.sha256).digest()
    expect = hmac_mod.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
    assert sig == expect


def test_s3_relay_backfill_and_latest(chain):
    """The S3 backend end-to-end: SigV4-signed PUT/HEAD/GET against an
    S3-compatible endpoint, backfill skipping existing objects, immutable
    round objects + mutable latest pointer (cmd/relay-s3/main.go:43-199)."""
    srv = _FakeS3()
    srv.start()
    try:
        store = S3ObjectStore("bkt", region="test-1",
                              endpoint=f"http://127.0.0.1:{srv.port}",
                              access_key="AK", secret_key="SK")
        relay = ObjectStoreRelay(MockSource(chain), store)
        prefix = chain.info.hash().hex()
        # pre-seed round 2 to prove backfill skips existing objects
        store.put(f"{prefix}/public/2", b"preseeded", "application/json")
        n = relay.sync(1, 5)
        assert n == 4, "round 2 existed; only 4 uploads expected"
        assert srv.objects[f"{prefix}/public/2"] == b"preseeded"
        obj = json.loads(srv.objects[f"{prefix}/public/3"])
        assert obj["round"] == 3
        assert obj["randomness"] == chain.beacons[3].randomness().hex()
        # backfill must not have written the latest pointer...
        assert f"{prefix}/public/latest" not in srv.objects
        # ...the live upload path does
        relay.upload(relay.client.get(5))
        latest = json.loads(srv.objects[f"{prefix}/public/latest"])
        assert latest["round"] == 5
        assert store.exists(f"{prefix}/public/5")
        assert store.get(f"{prefix}/public/404") is None
        assert not srv.bad_auth, f"unsigned requests: {srv.bad_auth}"
    finally:
        srv.stop()


def test_http_relay_routes(chain):
    relay = HttpRelay(MockSource(chain))
    relay.start()
    try:
        base = f"http://127.0.0.1:{relay.port}"
        info = json.loads(urllib.request.urlopen(f"{base}/info").read())
        assert info["hash"] == chain.info.hash().hex()
        obj = json.loads(urllib.request.urlopen(f"{base}/public/2").read())
        assert obj["round"] == 2
        latest = json.loads(
            urllib.request.urlopen(f"{base}/public/latest").read())
        assert latest["round"] == 5
        # chain-hash-prefixed route
        obj = json.loads(urllib.request.urlopen(
            f"{base}/{chain.info.hash().hex()}/public/1").read())
        assert obj["round"] == 1
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/{'ab'*32}/public/1")
    finally:
        relay.stop()


def test_http_relay_routes_equal_the_reference(chain):
    """The port's HttpRelay and the reference's over the same chain: the
    same status and body on every route."""
    from drand_tpu.relay import HttpRelay as RefHttpRelay

    def fetch(relay, path):
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{relay.port}{path}", timeout=10) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    port = HttpRelay(MockSource(chain))
    ref = RefHttpRelay(_ref_source(*_ref_chain(chain, chain.beacons)))
    port.start()
    ref.start()
    try:
        h = chain.info.hash().hex()
        for path in ("/info", "/health", "/public/1", "/public/4",
                     "/public/latest", f"/{h}/public/2", f"/{h}/info",
                     f"/{'ab' * 32}/public/1", "/nope"):
            assert fetch(port, path) == fetch(ref, path), path
    finally:
        port.stop()
        ref.stop()
