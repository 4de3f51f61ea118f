"""The port's device pool (drand_tpu_torch/crypto/device_pool.py) and the
verifier's placement over it (drand_tpu_torch/crypto/batch.py).

The cases of tests/test_multidevice.py run here against the port's pool and
service, with the same stub backends and a FakeClock, over eight CPU
devices (the reference's conftest forces eight virtual CPU devices): each
case is rebuilt over its module's globals with the pool's and service's
names swapped for the port's (tests/torch_service_cases.py).  The two cases
that read JAX objects or the reference's metrics are written out below.
The chaos scenarios (test_group_isolation_chaos_scenario,
test_group_isolation_without_siblings_degrades_to_host,
test_group_isolation_scenario_is_seed_deterministic) build the reference
service inside tests/chaos.py, so they wait for the daemon wiring.

The placement: a verifier on [cpu, cpu] at pad 512 splits its RLC pass in
two shards and adds their partial sums; with the same coefficients its sums
equal the one-device pass's bit for bit, and so does its verdict.
"""

import pytest
import torch

import test_multidevice as ref_md
from torch_service_cases import port_cases, run_case

from drand_tpu_torch import metrics
from drand_tpu_torch.beacon.clock import FakeClock
from drand_tpu_torch.crypto import batch as B
from drand_tpu_torch.crypto import device_pool as DP
from drand_tpu_torch.crypto import schemes as S
from drand_tpu_torch.crypto import verify_service as VS
from drand_tpu_torch.ops import curve as DC

CPU = torch.device("cpu")
CASES = port_cases(ref_md, dict(
    FakeClock=FakeClock, VerifyService=VS.VerifyService,
    LANE_BACKGROUND=VS.LANE_BACKGROUND, LANE_LIVE=VS.LANE_LIVE,
    DevicePool=DP.DevicePool, GROUP_FAULTED=DP.GROUP_FAULTED,
    GROUP_HEALTHY=DP.GROUP_HEALTHY, jax_devices=DP.cuda_devices), skip=(
    "test_pool_partitions_devices_into_groups",
    "test_group_metrics_series_exist",
    "test_group_isolation_chaos_scenario",
    "test_group_isolation_without_siblings_degrades_to_host",
    "test_group_isolation_scenario_is_seed_deterministic"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run as thousands of small int64 ops; under
    several test workers torch's intra-op threads only contend, so this
    module runs on one, restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def eight_cpu_devices():
    DP._reset_inventory_for_tests([CPU] * 8)
    yield
    DP._reset_inventory_for_tests(None)


@pytest.mark.parametrize("case", [fn for _, fn in CASES],
                         ids=[name for name, _ in CASES])
def test_reference_case(case, request):
    run_case(case, request)


def test_pool_partitions_devices_into_groups():
    devs = DP.cuda_devices()
    assert len(devs) == 8
    pool = DP.DevicePool()                  # AUTO: one group per device
    assert pool.n_groups == 8 and pool.n_devices == 8
    assert all(g.n_devices == 1 for g in pool.groups)
    assert [g.sharding() for g in pool.groups] == [CPU] * 8
    quad = DP.DevicePool(n_groups=4)
    assert [g.n_devices for g in quad.groups] == [2, 2, 2, 2]
    assert quad.groups[1].sharding() == [CPU, CPU]
    assert quad.pool_sharding() == [CPU] * 8
    assert DP.DevicePool(devices=[CPU]).pool_sharding() is None


def test_group_metrics_series_exist():
    metrics.verify_group_devices.labels("0").set(4)
    metrics.verify_dispatches.labels("live", "3").inc()
    metrics.verify_backend_state.labels("stub:chain", "2").set(0)
    blob = metrics.scrape("private").decode()
    assert 'verify_service_group_devices{group="0"} 4.0' in blob
    assert ('verify_service_dispatches_total{group="3",lane="live"}'
            in blob)
    assert ('verify_service_backend_state{chain="stub:chain",group="2"}'
            in blob)


def test_cuda_enumeration_is_cached_and_empty_without_a_card(monkeypatch):
    DP._reset_inventory_for_tests(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert DP.cuda_devices() == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert DP.cuda_devices() == []          # cached for the process
    DP._reset_inventory_for_tests(None)
    assert DP.cuda_devices() == [torch.device("cuda", 0),
                                 torch.device("cuda", 1)]
    assert DP.DevicePool().n_groups == 2
    assert DP.DevicePool().groups[1].sharding() == torch.device("cuda", 1)


def test_placement_pins_the_verifier_to_its_devices():
    sch = S.scheme_from_name("bls-unchained-on-g1")
    _, pub = sch.keypair(seed=b"pin")
    pk = sch.public_bytes(pub)
    one = B.BatchBeaconVerifier(sch, pk, sharding=CPU)
    assert one.device == CPU and one.shard_devices == []
    two = B.BatchBeaconVerifier(sch, pk, sharding=[CPU, CPU])
    assert two.sharding == [CPU, CPU] and two.shard_devices == [CPU, CPU]
    assert two._split_devices(512) == [CPU, CPU]
    assert two._split_devices(256) == []    # below SHARD_MIN_PAD
    assert B.BatchBeaconVerifier(sch, pk, sharding=[CPU] * 3) \
        ._split_devices(512) == []          # 512 does not split in three
    with pytest.raises(RuntimeError):       # a CUDA placement needs a card
        B.BatchBeaconVerifier(sch, pk, sharding=torch.device("cuda", 0))


def test_two_device_rlc_pass_equals_one_device(monkeypatch):
    """pad 512 over [cpu, cpu]: the same coefficient planes, drawn for the
    whole pad before the split, give summed points (A, B) bit-equal to the
    one-device stages', and the pass's verdict on valid rounds is True."""
    sch = S.scheme_from_name("bls-unchained-on-g1")
    sec, pub = sch.keypair(seed=b"placement")
    pk = sch.public_bytes(pub)
    n, pad = 24, 512
    rounds = list(range(1, n + 1))
    sigs = [sch.sign(sec, sch.digest_beacon(r)) for r in rounds]
    two = B.BatchBeaconVerifier(sch, pk, pad_to=pad, sharding=[CPU, CPU])
    packed = two.pack_chunk(rounds, sigs)
    enc = two._fields_enc(packed[1], packed[3])
    bits = B._device_rlc_bits(B._rlc_keys(), B._rlc_mask(enc[1], n))
    affine = lambda pts: [DC.G1.to_affine(p)[:2] for p in pts]
    sub_ok, A, Bp = B._rlc_sums_g1sig(*enc, *bits)      # one device
    want = affine((A, Bp))
    monkeypatch.setattr(B, "_device_rlc_bits", lambda *a, **k: bits)
    got = []
    real = B._rlc_check_g1sig

    def spy(A, Bp, pk_aff, neg_g2_aff):
        got.append(affine((A, Bp)))
        return real(A, Bp, pk_aff, neg_g2_aff)

    monkeypatch.setattr(B, "_rlc_check_g1sig", spy)
    split = []
    real_split = two._sharded_sums
    two._sharded_sums = lambda *a: split.append(1) or real_split(*a)
    assert two._rlc_ok(enc, n) is True
    assert split == [1] and len(got) == 1
    for p, q in zip(want, got[0]):
        for x, y in zip(p, q):
            assert torch.equal(x, y)
    assert bool(sub_ok.all()) and want[0][0].any()   # a real, nonzero sum
