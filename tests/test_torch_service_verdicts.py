"""Real verdicts through the port's verify service on the CPU.

A device handle on ``DevicePool(devices=[cpu])`` at pad 16 (the port's
verifier, its kernels' plain versions on the CPU) verifies 16 rounds with
two bad slots, one signature of another round and one malformed, on each
of the three schemes; its verdicts equal the reference's
``HostBatchVerifier`` on the same inputs, and the handle stays healthy.
Then the service's own host fallback (the port's pure-Python pairing)
gives the same verdicts on a host handle.
"""

import pytest
import torch

from drand_tpu.crypto import schemes as ref_schemes
from drand_tpu.crypto.hostverify import HostBatchVerifier as RefHost
from drand_tpu_torch.beacon.clock import FakeClock
from drand_tpu_torch.crypto import schemes as S
from drand_tpu_torch.crypto.device_pool import DevicePool
from drand_tpu_torch.crypto.verify_service import VerifyService

N = 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run as thousands of small int64 ops; under
    several test workers torch's intra-op threads only contend, so this
    module runs on one, restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _beacons(name):
    """16 rounds signed by the reference's host code; slot 3 carries round
    3's signature (a valid point, the wrong message), slot 10 is
    malformed."""
    sch = ref_schemes.scheme_from_name(name)
    sec, pub = sch.keypair(seed=b"service-verdicts")
    rounds, sigs, prevs, prev = [], [], [], b"\x42" * 32
    for r in range(1, N + 1):
        p = prev if sch.chained else None
        sig = sch.sign(sec, sch.digest_beacon(r, p))
        rounds.append(r)
        sigs.append(sig)
        prevs.append(p)
        prev = sig
    sigs[3] = sigs[2]
    sigs[10] = b"\x00" * len(sigs[10])
    return sch.public_bytes(pub), rounds, sigs, prevs


@pytest.mark.parametrize("name", ["bls-unchained-on-g1",
                                  "pedersen-bls-chained",
                                  "pedersen-bls-unchained"])
def test_device_handle_on_cpu_matches_reference_host(name):
    pk, rounds, sigs, prevs = _beacons(name)
    want = RefHost(ref_schemes.scheme_from_name(name), pk).verify_batch(
        rounds, sigs, prevs)
    assert (~want).nonzero()[0].tolist() == [3, 10]
    svc = VerifyService(clock=FakeClock(0.0), pad=N, pipeline_depth=1,
                        background_window=0.0,
                        pool=DevicePool(devices=[torch.device("cpu")]))
    scheme = S.scheme_from_name(name)
    h = svc.handle(scheme, pk, device=True)
    assert h.kind == "device" and h.backend.device.type == "cpu"
    got = h.verify_batch(rounds, sigs, prevs)
    assert got.tolist() == want.tolist()
    st = svc.stats()
    assert list(st["backends"].values()) == ["healthy"]
    assert st["failovers"] == 0 and st["dispatches"] == 1
    host = svc.handle(scheme, pk, device=False)
    assert host.kind == "host"
    assert host.verify_batch(rounds[:5], sigs[:5], prevs[:5]).tolist() \
        == want[:5].tolist()
    svc.stop()
