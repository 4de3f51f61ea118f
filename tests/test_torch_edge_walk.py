"""The strict client's device branch in the port: a chained catch-up of 64
rounds (`VerifyingClient.DEVICE_MIN_BATCH`) fetched over the port's REST
edge and verified in ONE submission to the verify service's device handle,
here a service on a CPU pool installed with `set_service` (its passes run
the kernels' plain versions).  Without a card and without such a service
the handle raises, and nothing falls back to the host.

A CPU RLC pass of the chained scheme at pad 64 costs some 30 s here; the
forged pair's walk adds an exact pass at 64 (some 100 s in all), so it
carries the `slow` marker.
"""

import pytest
import torch

from drand_tpu_torch.chain import MemDBStore, genesis_beacon
from drand_tpu_torch.client import (From, HttpTransport, new_client,
                                    with_chain_hash,
                                    with_full_chain_verification)
from drand_tpu_torch.crypto import device_pool, verify_service as VS
from drand_tpu_torch.crypto.device_pool import DevicePool
from drand_tpu_torch.http_server import RestServer

from torch_beacon_harness import MockChain, ShimDaemon, ShimProcess

N = 64
FORGED = 20


@pytest.fixture(scope="module")
def chain():
    return MockChain(n=N)


def _serve(chain, beacons):
    store = MemDBStore(buffer_size=N + 8)
    store.put(genesis_beacon(chain.info.genesis_seed))
    store.put_many(beacons[r] for r in sorted(beacons))
    server = RestServer(ShimDaemon(ShimProcess.of_store(chain.info, store)),
                        "127.0.0.1:0")
    server.start()
    return server


def _client(chain, server):
    return new_client(
        From(HttpTransport(f"http://127.0.0.1:{server.port}")),
        with_chain_hash(chain.info.hash_string()),
        with_full_chain_verification())


@pytest.fixture()
def cpu_service():
    # the watchdog's default floor (120 s) is sized for a card's first
    # kernel build; this pass runs the plain versions on the CPU, which a
    # loaded test machine can stretch past 120 s, and a trip there would
    # requeue the span (a second dispatch) for no fault of the code
    svc = VS.VerifyService(pool=DevicePool(devices=[torch.device("cpu")]),
                           pad=N, watchdog_floor=900.0)
    old = VS.set_service(svc)
    yield svc
    VS.set_service(old)
    svc.stop()


def test_strict_walk_through_the_edge_on_a_cpu_service(chain, cpu_service):
    server = _serve(chain, chain.beacons)
    try:
        res = _client(chain, server).get(N)
    finally:
        server.stop()
    assert res.round == N
    assert res.randomness == chain.beacons[N].randomness()
    st = cpu_service.stats()
    # the whole span in one device dispatch; nothing on the host handle
    assert st["dispatches"] == 1 and st["dispatch_lanes"] == N
    assert st["host_served"] == 0
    assert st["backends"] and all(v == "healthy"
                                  for v in st["backends"].values())


def test_strict_walk_without_a_card_raises(chain, monkeypatch):
    """No card and no CPU service installed: the span's device handle
    raises and the walk fails; nothing is verified on the host."""
    monkeypatch.setattr(device_pool, "_inventory", [])   # no CUDA device
    svc = VS.VerifyService()
    old = VS.set_service(svc)
    server = _serve(chain, chain.beacons)
    try:
        with pytest.raises(RuntimeError, match="no device"):
            _client(chain, server).get(N)
        assert svc.stats()["host_served"] == 0
        assert svc.stats()["dispatches"] == 0
    finally:
        server.stop()
        VS.set_service(old)
        svc.stop()


@pytest.mark.slow
def test_strict_walk_names_the_forged_pair(chain, cpu_service):
    """Round FORGED's signature and round FORGED + 1's previous signature
    replaced by the same forged bytes: the linkage holds, and the device
    sweep (RLC pass, then the exact pass) names exactly the pair."""
    server = _serve(chain, chain.forged_pair(FORGED))
    try:
        with pytest.raises(ValueError) as e:
            _client(chain, server).get(N)
    finally:
        server.stop()
    assert str(e.value) == \
        f"invalid signatures at rounds {[FORGED, FORGED + 1]}"
    assert cpu_service.stats()["host_served"] == 0
