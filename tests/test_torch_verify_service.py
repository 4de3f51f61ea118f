"""The port's verify service (drand_tpu_torch/crypto/verify_service.py).

The cases of tests/test_verify_service.py and tests/test_occupancy.py run
here against the port, with the same stub backends and a FakeClock: each
case is rebuilt over its module's globals with the service's names swapped
for the port's (tests/torch_service_cases.py), and the port's pool sees
eight CPU devices, as the reference's sees eight virtual CPU devices.  The
cases that import a reference module in their body are written out below
for the port.  The chaos scenarios (test_device_flap_chaos_scenario,
test_device_flap_scenario_is_seed_deterministic,
test_device_death_mid_catchup_sync_converges_via_host) build the reference
service inside tests/chaos.py, so they wait for the daemon wiring.

Then: one seeded script of submissions through the reference service and
the port's, with recording stub backends, must give the same dispatches
(width, lane, order), results and failover state walk; a device handle on a
pool with no device raises; a device handle without `fallback=` hands its
device errors to its callers; pack_chunk launches no kernel; the metrics work
without prometheus_client; the kernel wrappers enter the tensor's device; a
fresh interpreter that runs a CPU device handle imports no jax.
"""

import json
import os
import re
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import test_occupancy as ref_occ
import test_verify_service as ref_vs
from torch_service_cases import port_cases, run_case

from drand_tpu.beacon.clock import FakeClock as RefClock
from drand_tpu.crypto import device_pool as ref_pool
from drand_tpu.crypto import verify_service as ref_svc
from drand_tpu_torch import metrics
from drand_tpu_torch.beacon.clock import FakeClock
from drand_tpu_torch.crypto import batch as B
from drand_tpu_torch.crypto import device_pool as DP
from drand_tpu_torch.crypto import schemes as S
from drand_tpu_torch.crypto import tuning
from drand_tpu_torch.crypto import verify_service as VS
from drand_tpu_torch.crypto.hostverify import HostBatchVerifier
from drand_tpu_torch.ops import kernels as K

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SERVICE_NAMES = dict(
    FakeClock=FakeClock, VerifyService=VS.VerifyService,
    LANE_BACKGROUND=VS.LANE_BACKGROUND, LANE_LIVE=VS.LANE_LIVE,
    DEFAULT_PAD=VS.DEFAULT_PAD, current_service=VS.current_service,
    get_service=VS.get_service, set_service=VS.set_service, tuning=tuning)
CHAOS = ("test_device_flap_chaos_scenario",
         "test_device_flap_scenario_is_seed_deterministic",
         "test_device_death_mid_catchup_sync_converges_via_host")
CASES = (port_cases(ref_vs, SERVICE_NAMES, skip=CHAOS + (
    "test_service_host_handle_matches_host_batch_verifier",
    "test_device_backend_gets_group_placement_and_pool_sharding")) +
    port_cases(ref_occ, SERVICE_NAMES, skip=(
        "test_verifier_pipeline_depth_math",
        "test_watchdog_trips_only_the_oldest_ticket_per_slot",
        "test_metrics_series_exist")))


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


# -- the reference cases that import reference modules, for the port ----------


def _chained_beacons(scheme, secret, n, prev=b"\x42" * 32):
    rounds, sigs, prevs = [], [], []
    for r in range(1, n + 1):
        sig = scheme.sign(secret, scheme.digest_beacon(r, prev))
        rounds.append(r)
        sigs.append(sig)
        prevs.append(prev)
        prev = sig
    return rounds, sigs, prevs


def test_service_host_handle_matches_host_batch_verifier():
    scheme = S.scheme_from_name("pedersen-bls-chained")
    sec, pub = scheme.keypair(seed=b"verify-service-test")
    pk = scheme.public_bytes(pub)
    rounds, sigs, prevs = _chained_beacons(scheme, sec, 8)
    sigs[4] = sigs[3]                       # corrupt round 5
    svc = VS.VerifyService(clock=FakeClock(1000.0), pad=8,
                           background_window=100.0)
    h = svc.handle(scheme, pk, device=False)
    assert h.kind == "host"
    f1 = h.submit(rounds[:3], sigs[:3], prevs[:3])
    f2 = h.submit(rounds[3:], sigs[3:], prevs[3:])
    svc.clock.advance(101.0)
    got = np.concatenate([f1.result(60), f2.result(60)])
    want = HostBatchVerifier(scheme, pk).verify_batch(rounds, sigs, prevs)
    assert (got == want).all()
    assert not got[4] and got.sum() == 7
    svc.stop()


def test_device_backend_gets_group_placement_and_pool_sharding():
    """A device handle's backend is pinned to its device group (one of the
    eight CPU devices under the AUTO one-group-per-device layout), and the
    pool-wide backend spans every device: its RLC passes split over them.
    No pass runs."""
    scheme = S.scheme_from_name("pedersen-bls-chained")
    _, pub = scheme.keypair(seed=b"shard-test")
    pk = scheme.public_bytes(pub)
    svc = VS.VerifyService(clock=FakeClock(1000.0), pad=512,
                           background_window=0.0)
    h = svc.handle(scheme, pk, device=True)
    assert h.kind == "device"
    ver = h.backend
    assert isinstance(ver, B.BatchBeaconVerifier) and ver.pad_to == 512
    group = svc._pool.group(h.gid)
    assert group.n_devices == 1 and group.sharding() == CPU
    assert ver.device == CPU and ver.shard_devices == []
    assert ver._split_devices(512) == []
    assert svc.handle(scheme, pk, device=True) is h
    slot = svc._slots[h.key]
    assert svc._ensure_pool_backend(slot)
    pool_ver = slot.pool_backend
    assert pool_ver.pad_to == 512 * 8
    assert pool_ver._split_devices(pool_ver.pad_to) == [CPU] * 8
    assert pool_ver._split_devices(256) == []       # narrow: pinned
    assert pool_ver._split_devices(1028) == []      # uneven: pinned
    svc.stop()


def test_verifier_pipeline_depth_math():
    sch = S.scheme_from_name("bls-unchained-on-g1")
    _, pub = sch.keypair(seed=b"occupancy-depth")
    ver = B.BatchBeaconVerifier(sch, sch.public_bytes(pub), pad_to=8192,
                                device="cpu")
    assert ver.pipeline_depth(1, 8192) == 1
    cap = B.max_pipeline_depth(8192, g2sig=False)
    assert ver.pipeline_depth(10 ** 6, 8192) == cap
    assert B.max_pipeline_depth(8192, True) < cap
    assert B.chunk_footprint_bytes(16384, False) \
        == 2 * B.chunk_footprint_bytes(8192, False)


def test_watchdog_trips_only_the_oldest_ticket_per_slot():
    svc = VS.VerifyService(clock=FakeClock(1000.0), pad=8,
                           background_window=0.0, watchdog_floor=5.0)
    h = svc.handle(ref_occ.SCHEME, ref_occ.PK,
                   backend=ref_occ.PipelinedStub(),
                   fallback=ref_occ.PipelinedStub())
    slot = svc._slots[h.key]
    now = svc.clock.monotonic()
    old = VS._Ticket(slot, VS._Batch(VS.LANE_LIVE), "chunk", now, now + 1.0)
    young = VS._Ticket(slot, VS._Batch(VS.LANE_LIVE), "chunk", now + 0.5,
                       now + 1.5)
    trips = []
    svc._trip = lambda t: trips.append(t)
    with svc._cond:
        svc._ensure_threads_locked(svc._stream_locked(slot.gid))
        svc._tickets[id(old)] = old
        svc._tickets[id(young)] = young
        svc._cond.notify_all()
    svc.clock.advance(2.0)
    for _ in range(100):
        if trips:
            break
        time.sleep(0.05)
    assert [t is old for t in trips] == [True], trips
    assert not young.cancelled
    svc.stop()


def test_metrics_series_exist():
    metrics.verify_inflight.set(3)
    metrics.verify_dispatch_latency.labels("live", "queue").observe(0.1)
    metrics.verify_dispatch_latency.labels("live", "device").observe(0.2)
    metrics.verify_dispatch_latency.labels("live", "pack").observe(0.05)
    blob = metrics.scrape("private").decode()
    assert "verify_service_inflight_depth 3.0" in blob
    assert ('verify_service_dispatch_latency_seconds_count'
            '{lane="live",phase="queue"}') in blob
    assert ('verify_service_dispatch_latency_seconds_count'
            '{lane="live",phase="pack"}') in blob


# -- the same script through the reference service and the port's ------------

PAD = 8
WINDOW = 0.5
PROBE = 5.0
_LANE = threading.local()


def _rule(r, sig):
    return sig == b"sig-%d" % r


class Recorder:
    """Records every dispatch as (lane, width, first round); verdicts by
    the stub rule.  While `armed`, a dispatch holding one of `fail`
    (or any round, with fail=None) raises."""

    kind = "stub"

    def __init__(self, fail=()):
        self.seen = []
        self.fail = fail
        self.armed = False

    def verify_batch(self, rounds, sigs, prev_sigs=None):
        self.seen.append((getattr(_LANE, "lane", None), len(rounds),
                          rounds[0]))
        if self.armed and (self.fail is None
                           or set(self.fail) & set(rounds)):
            raise ConnectionError("chunk fault")
        return np.array([_rule(r, s) for r, s in zip(rounds, sigs)])


def _script(seed=2026, steps=10):
    """A seeded list of steps: per chain (A, B), submissions of 1-3 x pad
    rounds in either lane, where only a chain's last submission of a step
    may make it dispatch-ready (live, or the pad filled), so the order of
    dispatches does not depend on thread timing.  Step 4 arms A's backend
    (its dispatches raise until the step is over: failover to the host
    stub, then the probe re-promotes), step 6 arms B's fault on one chunk
    (no fallback: only its callers see the error), step 7 releases B and
    hands its group to chain C."""
    rng = np.random.RandomState(seed)
    sizes = (1, 3, 5, PAD, PAD + 3, 2 * PAD, 2 * PAD + 3, 3 * PAD)
    rnd, out = 1, []
    for step in range(steps):
        subs = {}
        for chain in ("A", "B"):
            fill, lst = 0, []
            for k in range(rng.randint(1, 4)):
                last = k == 2 or rng.rand() < 0.3
                size = int(rng.choice(sizes)) if last \
                    else int(rng.randint(1, max(2, PAD - fill)))
                if not last and fill + size >= PAD:
                    break
                lane = VS.LANE_LIVE if last and rng.rand() < 0.4 \
                    else VS.LANE_BACKGROUND
                bad = {rnd + int(rng.randint(size))} if rng.rand() < 0.5 \
                    else set()
                lst.append((lane, list(range(rnd, rnd + size)), bad))
                rnd += size + 7
                fill += size
                if last:
                    break
            subs[chain] = lst
        out.append(subs)
    return out


def _drive(svc, clock):
    """Run the script through `svc`; returns (dispatch records, results,
    state walk, C's group)."""
    walk = []
    real_gauge, real_exec = svc._set_state_gauge, svc._execute

    def gauge(slot, old_gid=None):
        walk.append((slot.label, slot.state))
        real_gauge(slot, old_gid)

    def execute(batch):
        prev = getattr(_LANE, "lane", None)
        _LANE.lane = batch.lane
        try:
            real_exec(batch)
        finally:
            _LANE.lane = prev

    svc._set_state_gauge, svc._execute = gauge, execute
    scheme = types.SimpleNamespace(id="diff")
    recs = {"A": Recorder(fail=None), "B": Recorder(), "fb": Recorder(),
            "C": Recorder()}
    handles = {"A": svc.handle(scheme, b"\x0a" * 48, backend=recs["A"],
                               fallback=recs["fb"]),
               "B": svc.handle(scheme, b"\x0b" * 48, backend=recs["B"])}
    results, c_gid = [], None
    for step, subs in enumerate(_script()):
        if step == 4:
            recs["A"].armed = True
        if step == 6:
            recs["B"].fail = [r for _, rs, _ in subs["B"] for r in rs][-1:]
            recs["B"].armed = bool(recs["B"].fail)
        if step == 7:
            svc.release_handle(handles.pop("B"))
            handles["B"] = svc.handle(scheme, b"\x0c" * 48,
                                      backend=recs["C"])
            c_gid = handles["B"].gid
        futs = []
        for chain in ("A", "B"):
            mine = []
            for lane, rounds, bad in subs[chain]:
                sigs = [b"forged" if r in bad else b"sig-%d" % r
                        for r in rounds]
                mine.append(handles[chain].submit(rounds, sigs, lane=lane))
            ready = subs[chain] and (
                subs[chain][-1][0] == VS.LANE_LIVE
                or sum(len(r) for _, r, _ in subs[chain]) >= PAD)
            if ready:
                for f in mine:
                    f.exception(30)
            futs += mine
        clock.advance(WINDOW + 0.1)
        for f in futs:
            exc = f.exception(30)
            results.append(("err", type(exc).__name__) if exc is not None
                           else ("ok", f.result().tolist()))
        recs["A"].armed = recs["B"].armed = False
        slot = svc._slots[handles["A"].key]
        deadline = time.monotonic() + 20
        while slot.state != VS.STATE_HEALTHY \
                and time.monotonic() < deadline:
            clock.advance(PROBE + 1.0)
            time.sleep(0.02)
        assert slot.state == VS.STATE_HEALTHY
    svc.stop()
    return ({k: r.seen for k, r in recs.items()}, results, walk, c_gid)


def test_reference_and_port_services_agree_on_a_seeded_script():
    kw = dict(pad=PAD, pipeline_depth=1, background_window=WINDOW,
              probe_interval=PROBE)
    rclock = RefClock(1000.0)
    ref = _drive(ref_svc.VerifyService(
        clock=rclock, pool=ref_pool.DevicePool(
            n_groups=2, devices=ref_pool.jax_devices()[:2]), **kw),
        rclock)
    pclock = FakeClock(1000.0)
    port = _drive(VS.VerifyService(
        clock=pclock, pool=DP.DevicePool(n_groups=2, devices=[CPU, CPU]),
        **kw), pclock)
    seen, results, walk, c_gid = port
    assert seen == ref[0]
    assert results == ref[1]
    assert walk == ref[2]
    assert c_gid == ref[3] == 1
    # the script reached every path it was written for
    # lanes of the dispatches; None is the probe's canary
    assert {ln for ln, _, _ in seen["A"] + seen["B"]} == {
        "live", "background", None}
    assert max(w for _, w, _ in seen["A"]) == PAD and seen["fb"] and seen["C"]
    assert ("err", "ConnectionError") in results
    assert [s for _, s in walk].count("degraded") == 1
    assert walk[-1][1] == "healthy" and ("diff:0a0a0a0a", "probing") in walk


# -- the port's own rules -----------------------------------------------------


def test_device_handle_on_a_deviceless_pool_raises():
    DP._reset_inventory_for_tests([])
    svc = VS.VerifyService(clock=FakeClock(0.0))
    scheme = S.scheme_from_name("bls-unchained-on-g1")
    _, pub = scheme.keypair(seed=b"no-device")
    pk = scheme.public_bytes(pub)
    with pytest.raises(RuntimeError, match=r"DevicePool\(devices="):
        svc.handle(scheme, pk, device=True)
    assert svc.handle(scheme, pk, device=False).kind == "host"
    svc.stop()


@pytest.mark.parametrize("n_groups", [1, 2])
def test_device_handle_without_fallback_surfaces_the_device_error(
        monkeypatch, n_groups):
    """A device handle gets no host fallback unless the caller passes
    `fallback=`: a dispatch fault on every group of the pool (after the
    sibling migration, where there is a sibling) reaches the caller's
    future, the slot never degrades and no HostBatchVerifier is built."""
    from drand_tpu_torch.crypto import hostverify
    built = []

    class Spy(hostverify.HostBatchVerifier):
        def __init__(self, *a, **k):
            built.append(a)
            super().__init__(*a, **k)

    def fault(self, *a, **k):
        raise RuntimeError("injected device fault")

    monkeypatch.setattr(hostverify, "HostBatchVerifier", Spy)
    monkeypatch.setattr(B.BatchBeaconVerifier, "dispatch_packed", fault)
    monkeypatch.setattr(B.BatchBeaconVerifier, "verify_batch", fault)
    svc = VS.VerifyService(clock=FakeClock(0.0), pad=16, pipeline_depth=1,
                           background_window=0.0,
                           pool=DP.DevicePool(n_groups=n_groups,
                                              devices=[CPU] * n_groups))
    scheme = S.scheme_from_name("bls-unchained-on-g1")
    _, pub = scheme.keypair(seed=b"no-fallback")
    h = svc.handle(scheme, scheme.public_bytes(pub), device=True)
    assert h.kind == "device"
    fut = h.submit([1, 2, 3], [b"\x00" * 48] * 3, lane=VS.LANE_LIVE)
    with pytest.raises(RuntimeError, match="injected device fault"):
        fut.result(60)
    slot = svc._slots[h.key]
    assert not slot.can_failover and slot.fallback is None
    assert slot.state != VS.STATE_DEGRADED
    st = svc.stats()
    assert st["failovers"] == 0 and st["migrations"] == n_groups - 1
    assert built == []
    svc.stop()


def test_pack_chunk_launches_nothing(monkeypatch):
    """The packer thread only parses and copies: a raw front's pack makes
    no kernel call and no hash_to_field; H1 runs in dispatch_packed."""
    calls = []
    for name in ("hash_to_field", "sha256_words", "expand_msg_xmd",
                 "_launch"):
        real = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _n=name, _r=real, **k:
                            calls.append(_n) or _r(*a, **k))
    sch = S.scheme_from_name("bls-unchained-on-g1")
    sec, pub = sch.keypair(seed=b"pack")
    ver = B.BatchBeaconVerifier(sch, sch.public_bytes(pub), pad_to=64,
                                device="cpu", h2f_device=True)
    rounds = list(range(1, 65))
    sigs = [b"\x00" * 48] * 64
    packed = ver.pack_chunk(rounds, sigs)
    assert calls == [] and packed[3] == B.FRONT_RAW_UNCHAINED
    assert ver.dispatch_packed(packed) is None     # malformed: no RLC
    assert calls == ["hash_to_field"] and packed[3] == B.FRONT_FIELDS


def test_kernel_wrapper_enters_the_tensor_device(monkeypatch):
    """A launch runs under torch.cuda.device(the tensor's device) and gets
    that device's stream; every launch site goes through _launch."""
    entered, current = [], []

    class Ctx:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            entered.append(self.dev)
            current.append(self.dev)

        def __exit__(self, *exc):
            current.pop()

    monkeypatch.setattr(torch.cuda, "device", Ctx)
    monkeypatch.setattr(K, "_stream", lambda dev: ("stream", dev))
    seen = []
    K._launch(torch.device("cuda", 3), "probe",
              lambda *a: seen.append((list(current), a)) or 0, 7, 8)
    cuda3 = torch.device("cuda", 3)
    assert entered == [cuda3]
    assert seen == [([cuda3], (7, 8, ("stream", cuda3)))]
    with pytest.raises(RuntimeError, match="cudaError 2"):
        K._launch(cuda3, "probe", lambda *a: 2)
    src = (REPO / "drand_tpu_torch" / "ops" / "kernels.py").read_text()
    # _stream and _check: each its def and _launch's call
    assert len(re.findall(r"\b_stream\(", src)) == 2
    assert len(re.findall(r"\b_check\(", src)) == 2


def test_metrics_need_no_prometheus_client():
    code = ("import sys\n"
            "sys.modules['prometheus_client'] = None\n"
            "from drand_tpu_torch import metrics\n"
            "from drand_tpu_torch.crypto import verify_service\n"
            "metrics.verify_failovers.labels('c:01', 'to_host').inc()\n"
            "metrics.verify_backend_state.labels('c:01', '0').set(2)\n"
            "metrics.verify_backend_state.remove('c:01', '0')\n"
            "metrics.verify_fill_ratio.observe(0.5)\n"
            "print(metrics.scrape().decode())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    text = out.stdout
    assert ('verify_service_failovers_total{chain="c:01",'
            'direction="to_host"} 1.0') in text
    assert "verify_service_backend_state{" not in text
    assert 'verify_service_batch_fill_ratio_bucket{le="0.5"} 1.0' in text
    assert 'verify_service_batch_fill_ratio_bucket{le="+Inf"} 1.0' in text
    assert "verify_service_batch_fill_ratio_count 1.0" in text
    with pytest.raises(KeyError):
        metrics.verify_backend_state.remove("never", "0")
    with pytest.raises(ValueError):
        metrics.Gauge("verify_service_queue_depth", "twice", ["lane"])


_CHILD = r"""
import json, sys, torch
from drand_tpu_torch.crypto import schemes as S
from drand_tpu_torch.crypto.device_pool import DevicePool
from drand_tpu_torch.crypto.verify_service import VerifyService
from drand_tpu_torch.crypto.host.curve import G2
from drand_tpu_torch.crypto.host.serialize import g2_to_bytes
svc = VerifyService(pad=8, pool=DevicePool(devices=[torch.device("cpu")]))
h = svc.handle(S.scheme_from_name(S.SHORT_SIG_SCHEME_ID),
               g2_to_bytes(G2.mul(G2.gen, 5)))
ok = h.verify_batch([1], [b"\x00" * 48]).tolist()
kind = h.kind
svc.stop()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "drand_tpu"
             or m.startswith("drand_tpu."))
print(json.dumps({"ok": ok, "kind": kind, "bad": bad}))
"""


def test_service_device_handle_leaves_jax_out():
    """A fresh interpreter that imports the service and runs a CPU device
    handle imports neither jax nor drand_tpu."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"ok": [False], "kind": "device", "bad": []}
