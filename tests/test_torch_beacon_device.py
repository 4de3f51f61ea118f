"""The beacon layer's device seams, run on the CPU (`device="cpu"`: every
kernel wrapper runs its plain PyTorch version).

* One round aggregated by a node whose partial checks go through
  `device_verifier_factory` (a `(1, n)` block of BatchPartialVerifier, the
  row padded to the group's n slots), with a forged partial first: each
  batch's verdicts equal the reference's `HostPartialVerifier` on the same
  partials, the forged one is dropped and the round is the collective
  signature.
* One catch-up of 64 rounds through a port `VerifyService` on a [cpu] pool:
  one 64-lane chunk on the BACKGROUND lane, one RLC pass, nothing served by
  the host.
* Without a card and without `device="cpu"`, the factory and
  `DevicePartialVerifier` raise, and so does a Handler built on the
  port's default config, which is the device factory.
"""

import functools

import numpy as np
import pytest
import torch

import torch_beacon_harness as H

from drand_tpu.beacon.chainstore import HostPartialVerifier as RefHostPV
from drand_tpu.crypto import tbls as ref_tbls
from drand_tpu.crypto.schemes import scheme_from_name as ref_scheme
from drand_tpu_torch.beacon import FakeClock
from drand_tpu_torch.beacon import node as NODE
from drand_tpu_torch.beacon.chainstore import DevicePartialVerifier
from drand_tpu_torch.beacon.sync import SyncChainServer, SyncManager
from drand_tpu_torch.chain import Beacon, MemDBStore, SqliteStore
from drand_tpu_torch.crypto import batch as B
from drand_tpu_torch.crypto import verify_service as VS
from drand_tpu_torch.crypto.device_pool import DevicePool
from drand_tpu_torch.crypto.host import tbls
from drand_tpu_torch.crypto.schemes import scheme_from_name
from drand_tpu_torch.key import Share

QUICKNET = "bls-unchained-on-g1"
COEFFS = [0x1234567 * (i + 3) + 11 for i in range(3)]      # t = 3
N_NODES = 5
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


class Recording:
    """A partial verifier that records each batch and its verdicts."""

    def __init__(self, inner):
        self.inner = inner
        self.kind = inner.kind
        self.calls = []

    def verify(self, msg, partials):
        out = self.inner.verify(msg, partials)
        self.calls.append((msg, list(partials), list(out)))
        return out


def test_one_round_with_a_forged_partial_matches_the_host_verdicts():
    sc = H.BeaconScenario(N_NODES, 3, scheme_id=QUICKNET, poly_coeffs=COEFFS)
    try:
        h = sc.handlers[0]
        rec = Recording(NODE.device_verifier_factory(
            sc.scheme, h.vault.get_pub(), N_NODES, device="cpu"))
        h.chain.partial_verifier = rec
        sch = sc.scheme
        msg = sch.digest_beacon(1)
        parts = {i: tbls.sign_partial(sch, sc.poly.eval(i), msg)
                 for i in range(N_NODES)}
        forged = (1).to_bytes(2, "big") + parts[2][2:]
        # the forged partial, then signers 3 and 2 (threshold: one batch of
        # three with the forgery), then signer 4 (a batch of one)
        for p in (forged, parts[3], parts[2], parts[4]):
            h.chain.new_valid_partial(1, None, p)
        b = h.chain.wait_for_round(1, 600, scheduled_time=True)
    finally:
        sc.stop_all()
    assert b is not None and b.signature == sch.sign(COEFFS[0], msg)
    ref_sch = ref_scheme(QUICKNET)
    ref_pub = ref_tbls.PriPoly(list(COEFFS)).commit(ref_sch.key_group)
    want = [RefHostPV(ref_sch, ref_pub).verify(m, ps)
            for m, ps, _ in rec.calls]
    assert [v for _, _, v in rec.calls] == want == [[False, True, True],
                                                   [True]]


def test_catch_up_64_rounds_through_a_cpu_pool_service(tmp_path):
    sch = scheme_from_name(QUICKNET)
    secret = COEFFS[0]
    pk = sch.key_group.to_bytes(sch.key_group.curve.mul(
        sch.key_group.curve.gen, secret))
    seed = b"\x05" * 32
    peer = H.ChainFacade(MemDBStore(buffer_size=100), False, seed)
    for r in range(1, 65):
        peer.put(Beacon(round=r, signature=sch.sign(
            secret, sch.digest_beacon(r))))
    store = SqliteStore(str(tmp_path / "node.db"))
    node = H.ChainFacade(store, False, seed)
    svc = VS.VerifyService(pad=64, pool=DevicePool(devices=[CPU]))
    try:
        handle = svc.handle(sch, pk)
        assert handle.kind == "device"
        syncm = SyncManager(
            chain=node, scheme=sch, public_key_bytes=pk, period=3,
            clock=FakeClock(1), peers=["peer0"], chunk=64,
            verifier=handle, fetch=lambda p, fr: H.PeerStream(
                SyncChainServer(peer), "node", fr))
        before, passes0 = svc.stats(), B.pass_counts()
        syncm.sync(64, ["peer0"])
        st, passes = svc.stats(), B.pass_counts()
    finally:
        svc.stop()
    assert node.last().round == 64
    assert [b.signature for b in store.cursor()][1:] == \
        [peer.store.get(r).signature for r in range(1, 65)]
    assert st["dispatches"] - before["dispatches"] == 1
    assert st["dispatch_lanes"] - before["dispatch_lanes"] == 64
    assert st["host_served"] == st["failovers"] == 0
    assert passes["rlc"] - passes0["rlc"] == 1
    assert passes["exact"] - passes0["exact"] == 0
    store.close()


def test_device_factory_and_verifier_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("holds what happens without a card")
    sc = H.BeaconScenario(3, 2, scheme_id=QUICKNET)
    sc.stop_all()
    pub = sc.poly.commit(sc.scheme.key_group)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NODE.device_verifier_factory(sc.scheme, pub, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DevicePartialVerifier(sc.scheme, pub, 3)
    bound = functools.partial(NODE.device_verifier_factory, device="cpu")
    assert bound(sc.scheme, pub, 3).kind == "device"
    # the port's HandlerConfig defaults to the device factory, so a Handler
    # built without one raises here instead of checking on the host
    field = NODE.HandlerConfig.__dataclass_fields__["verifier_factory"]
    assert field.default is NODE.device_verifier_factory
    cfg = NODE.HandlerConfig(
        group=sc.group, index=0, store=MemDBStore(buffer_size=100),
        share=Share(scheme=sc.scheme, private=sc.poly.eval(0),
                    commits=sc.commits), clock=sc.clock)
    assert cfg.verifier_factory is NODE.device_verifier_factory
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NODE.Handler(cfg)


def test_padded_row_keeps_verdicts_aligned():
    """More partials than n slots are checked n at a time; fewer are
    padded with invalid slots that never surface."""
    sch = scheme_from_name(QUICKNET)
    poly = tbls.PriPoly(list(COEFFS))
    pub = poly.commit(sch.key_group)

    class Stub:
        def __init__(self):
            self.rows = []

        def verify_partials(self, msgs, rows):
            self.rows.append(rows[0])
            return np.array([[p is not None and p[-1] % 2 == 0
                              for p in rows[0]]])

    v = DevicePartialVerifier.__new__(DevicePartialVerifier)
    v.n_nodes, v._bv = 3, Stub()
    parts = [bytes([0, i, 7, i * 2]) for i in range(5)]
    assert v.verify(b"m", parts) == [True] * 5
    assert [len(r) for r in v._bv.rows] == [3, 3]
    assert v._bv.rows[1][2:] == [None]
    assert pub.threshold == 3
