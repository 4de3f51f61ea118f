"""The port's REST edge (drand_tpu_torch/http_server.py): tests/
test_http_server.py's cases over the port's beacon network
(tests/torch_beacon_harness.py), and the port's RestServer beside the
reference's on the same chain: equal bodies and equal ETag / Cache-Control
/ Expires headers on every route (Date excluded)."""

import json
import threading
import urllib.error
import urllib.request

import pytest

from drand_tpu_torch.beacon.clock import FakeClock
from drand_tpu_torch.chain import MemDBStore, genesis_beacon, time_of_round
from drand_tpu_torch.http_server import RestServer

from torch_beacon_harness import (BeaconScenario, MockChain, ShimDaemon,
                                  ShimProcess)


@pytest.fixture(scope="module")
def served():
    sc = BeaconScenario(n=3, thr=2, period=30)
    sc.start_all()
    sc.advance_to_genesis()
    sc.wait_all(1, timeout=120)        # generous under full-suite CPU load
    sc.advance_round()
    sc.wait_all(2, timeout=120)
    bp = ShimProcess.of_scenario(sc)
    server = RestServer(ShimDaemon(bp), "127.0.0.1:0")
    server.start()
    yield sc, server, bp
    server.stop()
    sc.stop_all()


def _get(server, path):
    url = f"http://127.0.0.1:{server.port}{path}"
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read()), dict(r.headers)


def test_info_and_chains(served):
    sc, server, bp = served
    info, _ = _get(server, "/info")
    assert info["public_key"] == sc.public_key.hex()
    chains, _ = _get(server, "/chains")
    assert bp.chain_info().hash_string() in chains


def test_public_round_and_latest(served):
    sc, server, _ = served
    obj, headers = _get(server, "/public/1")
    assert obj["round"] == 1
    assert "immutable" in headers.get("Cache-Control", "")
    latest, headers = _get(server, "/public/latest")
    assert latest["round"] >= 2
    assert "Expires" in headers
    # chain-hash prefixed alias
    h = served[2].chain_info().hash_string()
    obj2, _ = _get(server, f"/{h}/public/1")
    assert obj2 == obj


def test_immutable_round_etag_and_304(served):
    """Immutable rounds carry a strong deterministic ETag + immutable
    cache-control, and If-None-Match revalidation gets a bodyless 304."""
    sc, server, _ = served
    obj, headers = _get(server, "/public/1")
    etag = headers.get("ETag")
    assert etag and etag.startswith('"') and etag.endswith('"')
    assert "immutable" in headers.get("Cache-Control", "")
    assert "max-age=" in headers.get("Cache-Control", "")
    # same round, same ETag (deterministic across requests/nodes)
    _, headers2 = _get(server, "/public/1")
    assert headers2.get("ETag") == etag
    # conditional request: 304, empty body, ETag still present
    url = f"http://127.0.0.1:{server.port}/public/1"
    req = urllib.request.Request(url, headers={"If-None-Match": etag})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=10)
    assert e.value.code == 304
    assert e.value.headers.get("ETag") == etag
    # weak comparison (RFC 9110): a CDN-weakened validator and `*` still
    # revalidate to 304
    for inm in (f"W/{etag}", "*", f'"zzz", {etag}'):
        req = urllib.request.Request(url, headers={"If-None-Match": inm})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 304, inm
    # a stale/mismatched validator still gets the full body
    req = urllib.request.Request(url, headers={"If-None-Match": '"nope"'})
    with urllib.request.urlopen(req, timeout=10) as r:
        assert json.loads(r.read())["round"] == 1
    # `latest` is mutable: no ETag, Expires instead
    _, lheaders = _get(server, "/public/latest")
    assert "ETag" not in lheaders


def test_health_includes_verify_service_summary(served):
    """/health carries the one-line verify-service summary when the
    process has a port service installed."""
    from drand_tpu_torch.crypto.verify_service import (VerifyService,
                                                       set_service)

    svc = VerifyService(clock=FakeClock(0.0))
    old = set_service(svc)
    try:
        url = f"http://127.0.0.1:{served[1].port}/health"
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                body = json.loads(r.read())
        except urllib.error.HTTPError as e:
            body = json.loads(e.read())
        assert "verify" in body
        assert "dispatches=" in body["verify"]
        # occupancy observability: inflight depth + the pack|queue|device
        # latency split ride along
        assert body["verify_inflight_depth"] == 0
        assert set(body["verify_latency_split"]) == \
            {"pack_s", "queue_s", "device_s"}
    finally:
        set_service(old)
        svc.stop()


def test_health_never_creates_a_service(served):
    """With no service installed /health reports none and creates none."""
    from drand_tpu_torch.crypto import verify_service as VS

    old = VS.set_service(None)
    try:
        url = f"http://127.0.0.1:{served[1].port}/health"
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                body = json.loads(r.read())
        except urllib.error.HTTPError as e:
            body = json.loads(e.read())
        assert "verify" not in body
        assert VS.current_service() is None
    finally:
        VS.set_service(old)


def test_future_round_404(served):
    _, server, _ = served
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server, "/public/999")
    assert e.value.code == 404


def test_long_poll_releases_on_next_round(served):
    sc, server, bp = served
    head = bp.get_beacon(0).round
    result = {}

    def waiter():
        try:
            result["obj"], _ = _get(server, f"/public/{head + 1}")
        except Exception as e:
            result["err"] = e

    t = threading.Thread(target=waiter)
    t.start()
    t.join(1.0)
    assert t.is_alive(), "long-poll should be parked"
    sc.advance_round()          # the network produces the next round
    t.join(30)
    assert not t.is_alive()
    assert result["obj"]["round"] == head + 1


def test_health(served):
    sc, server, _ = served
    # the fake clock lags real time, so health reports catching-up (503)
    url = f"http://127.0.0.1:{server.port}/health"
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            body = json.loads(r.read())
            assert body["status"] is True
    except urllib.error.HTTPError as e:
        assert e.code == 503
        body = json.loads(e.read())
        assert body["current"] >= 1


# -- the port's RestServer beside the reference's ------------------------------


N_DIFF = 6


@pytest.fixture(scope="module")
def both_servers():
    """One chain in a port and a reference memdb store, each behind its
    package's RestServer on a fake clock five seconds past round
    N_DIFF's time; a fresh, idle verify service installed on each side."""
    from drand_tpu.beacon.clock import FakeClock as RefClock
    from drand_tpu.beacon.stores import CallbackStore as RefCallbackStore
    from drand_tpu.chain.beacon import Beacon as RB
    from drand_tpu.chain.info import Info as RI
    from drand_tpu.chain.memdb import MemDBStore as RefMemDB
    from drand_tpu.crypto import verify_service as RVS
    from drand_tpu.http_server import RestServer as RefRestServer
    from drand_tpu.log import Logger as RefLogger
    from drand_tpu_torch.crypto import verify_service as VS
    from types import SimpleNamespace

    chain = MockChain(n=N_DIFF)
    i = chain.info
    now = time_of_round(i.period, i.genesis_time, N_DIFF) + 5
    store = MemDBStore(buffer_size=100)
    store.put(genesis_beacon(i.genesis_seed))
    store.put_many(chain.beacons[r] for r in sorted(chain.beacons))
    port = RestServer(ShimDaemon(ShimProcess.of_store(i, store)),
                      "127.0.0.1:0", clock=FakeClock(now))

    rinfo = RI(public_key=i.public_key, period=i.period,
               genesis_time=i.genesis_time, genesis_seed=i.genesis_seed,
               scheme=i.scheme, beacon_id=i.beacon_id)
    rstore = RefMemDB(buffer_size=100)
    rstore.put(RB(round=0, signature=i.genesis_seed))
    for r in sorted(chain.beacons):
        b = chain.beacons[r]
        rstore.put(RB(round=r, signature=b.signature,
                      previous_sig=b.previous_sig))
    rchain = SimpleNamespace(cbstore=RefCallbackStore(rstore))

    class RefProcess:
        beacon_id = "default"
        handler = SimpleNamespace(chain=rchain)

        def chain_info(self):
            return rinfo

        def get_beacon(self, round_):
            return rstore.last() if round_ == 0 else rstore.get(round_)

    rbp = RefProcess()
    rdaemon = SimpleNamespace(processes={"default": rbp},
                              chain_hashes={rinfo.hash_string(): "default"},
                              log=RefLogger("test"))
    ref = RefRestServer(rdaemon, "127.0.0.1:0", clock=RefClock(now))
    psvc, rsvc = VS.VerifyService(clock=FakeClock(0.0)), \
        RVS.VerifyService(clock=RefClock(0.0))
    old_p, old_r = VS.set_service(psvc), RVS.set_service(rsvc)
    port.start()
    ref.start()
    yield chain, port, ref
    port.stop()
    ref.stop()
    VS.set_service(old_p)
    RVS.set_service(old_r)
    psvc.stop()
    rsvc.stop()
    rchain.cbstore.close()


def _raw(server, path, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{server.port}{path}",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


HEADERS = ("Content-Type", "ETag", "Cache-Control", "Expires")


def test_rest_edge_equals_the_reference(both_servers):
    chain, port, ref = both_servers
    h = chain.info.hash_string()
    paths = ["/info", f"/{h}/info", "/chains", "/public/1", "/public/3",
             f"/public/{N_DIFF}", f"/{h}/public/2", "/public/latest",
             f"/{h}/public/latest", "/public/999", f"/{'ab' * 32}/info",
             "/nope", "/health"]
    for path in paths:
        got, want = _raw(port, path), _raw(ref, path)
        assert got[0] == want[0], path
        assert got[1] == want[1], path
        for k in HEADERS:
            assert got[2].get(k) == want[2].get(k), (path, k)
    # the health body: the same keys and values, the idle services' lines
    # included
    health = json.loads(_raw(port, "/health")[1])
    assert health["status"] is True and health["current"] == N_DIFF
    assert "dispatches=0" in health["verify"]
    # revalidation: the same 304 on both
    etag = _raw(port, "/public/3")[2]["ETag"]
    for inm in (etag, f"W/{etag}", "*", '"nope"'):
        got = _raw(port, "/public/3", {"If-None-Match": inm})
        want = _raw(ref, "/public/3", {"If-None-Match": inm})
        assert (got[0], got[1]) == (want[0], want[1]), inm
        for k in HEADERS:
            assert got[2].get(k) == want[2].get(k), (inm, k)
