"""The port's serving-plane admission control (drand_tpu_torch/net/
admission.py) and its REST wiring: tests/test_admission.py's cases that
reach no grpc, over the port — priority-class reservation, per-peer fair
share, hysteresis, the HTTP 429 shape, the degradation ladder reaching the
port's verify service, and the bounded REST edge.  The gRPC interceptor's
cases and the overload scenario come with the port's gRPC listener."""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from drand_tpu_torch.beacon.clock import FakeClock, RealClock
from drand_tpu_torch.net.admission import (CLASS_CRITICAL, CLASS_NORMAL,
                                           CLASS_SHEDDABLE, LEVEL_NOMINAL,
                                           LEVEL_PAUSE_BACKGROUND,
                                           LEVEL_SHED_NORMAL, REASON_PEER_CAP,
                                           AdmissionController, Shed,
                                           classify_method)

from harness import assert_no_leaked_rest_threads, rest_threads


def _controller(**kw):
    kw.setdefault("clock", FakeClock(1_000.0))
    kw.setdefault("capacity", 6)
    kw.setdefault("critical_reserve", 2)
    kw.setdefault("shed_wait", 0.5)
    kw.setdefault("recover_wait", 0.05)
    kw.setdefault("dwell", 2.0)
    kw.setdefault("normal_wait", 1.0)
    return AdmissionController(**kw)


# -- priority classes ---------------------------------------------------------


def test_critical_reserved_while_sheddable_sheds():
    """The reserve: with every non-critical token taken, sheddable sheds
    immediately and critical keeps being admitted — partials must never
    wait behind public reads."""
    ctrl = _controller()                    # 6 total, 4 non-critical
    held = [ctrl.admit(CLASS_SHEDDABLE) for _ in range(4)]
    with pytest.raises(Shed) as e:
        ctrl.admit(CLASS_SHEDDABLE)
    assert e.value.cls == CLASS_SHEDDABLE
    assert e.value.retry_after > 0
    crit = [ctrl.admit(CLASS_CRITICAL) for _ in range(8)]
    assert ctrl.wait_p99(CLASS_CRITICAL) == 0.0
    for t in crit + held:
        t.release()


def test_normal_times_out_and_the_wait_is_recorded():
    """A normal request that cannot get a token within `normal_wait`
    sheds, and its timed-out wait lands in the p99 window — the overload
    signal the ladder climbs on."""
    clock = FakeClock(1_000.0)
    ctrl = _controller(clock=clock)
    held = [ctrl.admit(CLASS_SHEDDABLE) for _ in range(4)]
    out = {}

    def attempt():
        try:
            out["t"] = ctrl.admit(CLASS_NORMAL, peer="peer1")
        except Shed as s:
            out["s"] = s

    th = threading.Thread(target=attempt, daemon=True)
    th.start()
    deadline = time.monotonic() + 5
    while th.is_alive() and time.monotonic() < deadline:
        clock.advance(0.25)
        time.sleep(0.02)
    th.join(2)
    assert "s" in out, "normal admit should have timed out"
    assert ctrl.wait_p99(CLASS_NORMAL) >= ctrl.normal_wait
    for t in held:
        t.release()


def test_per_peer_fair_share_stream_cap():
    ctrl = _controller(max_streams_per_peer=2)
    a1 = ctrl.admit(CLASS_NORMAL, peer="hog", stream=True)
    a2 = ctrl.admit(CLASS_NORMAL, peer="hog", stream=True)
    with pytest.raises(Shed) as e:
        ctrl.admit(CLASS_NORMAL, peer="hog", stream=True)
    assert e.value.reason == REASON_PEER_CAP
    # a DIFFERENT peer is not punished for the hog's appetite
    b1 = ctrl.admit(CLASS_NORMAL, peer="polite", stream=True)
    for t in (a1, a2, b1):
        t.release()
    # the cap is per-CONCURRENT-streams: after release the peer is fine
    again = ctrl.admit(CLASS_NORMAL, peer="hog", stream=True)
    again.release()


def test_pacing_bucket_math():
    """Past the burst allowance, each streamed item costs 1/rate seconds
    of bucket time at the fair-share rate; uncontended streams are never
    paced (and their history is forgiven)."""
    clock = FakeClock(1_000.0)
    ctrl = _controller(clock=clock, pace_rate=100.0, pace_burst=10)
    ctrl.WAIT_REAL_CAP = 0.05       # the fake deadline never arrives here
    solo = ctrl.admit(CLASS_NORMAL, peer="a", stream=True)
    assert solo.pace(1_000) == 0.0              # uncontended: full pipe
    other = ctrl.admit(CLASS_NORMAL, peer="b", stream=True)
    t0 = clock.monotonic()
    for _ in range(2):
        solo.pace(10)                           # 20 items, burst is 10
    # 2 streams -> 50 items/s fair share; 10 past-burst items owe 0.2s
    assert solo._next_ok - t0 >= 10 / 50 - 1e-9
    solo.release()
    other.release()


# -- hysteresis ---------------------------------------------------------------


def _drive_timeout(ctrl, clock, peer="p"):
    """One normal-class admission timeout with the clock stepped from the
    main thread (deterministic fake-time wait)."""
    out = {}

    def attempt():
        try:
            out["t"] = ctrl.admit(CLASS_NORMAL, peer=peer)
        except Shed as s:
            out["s"] = s

    th = threading.Thread(target=attempt, daemon=True)
    th.start()
    deadline = time.monotonic() + 5
    while th.is_alive() and time.monotonic() < deadline:
        clock.advance(0.25)
        time.sleep(0.015)
    th.join(2)
    if "t" in out:
        out["t"].release()
    return out


def test_ladder_hysteresis_no_flapping_on_fakeclock():
    """The ladder climbs one rung per dwell under pressure, never
    oscillates while the p99 sits between the recover and shed
    thresholds, and steps back down one rung per dwell once the window
    drains — strictly up, then strictly down, no flapping."""
    clock = FakeClock(1_000.0)
    ctrl = _controller(clock=clock, dwell=2.0)
    held = [ctrl.admit(CLASS_SHEDDABLE) for _ in range(4)]

    # sustained pressure: timed-out normal waits while the pool is full
    levels = [ctrl.level()]
    for _ in range(8):
        _drive_timeout(ctrl, clock)
        clock.advance(ctrl.dwell)
        levels.append(ctrl.level())
    assert max(levels) == LEVEL_SHED_NORMAL
    ups = [lv for lv in levels if lv != 0]
    assert ups == sorted(ups), f"ladder flapped on the way up: {levels}"

    # pressure stops: tokens free, the wait window drains, and the
    # ladder walks down one rung per dwell without ever bouncing back
    for t in held:
        t.release()
    clock.advance(ctrl._window + 1)
    down = []
    for _ in range(8):
        clock.advance(ctrl.dwell)
        down.append(ctrl.level())
    assert down[-1] == LEVEL_NOMINAL
    assert down == sorted(down, reverse=True), f"flapped down: {down}"
    # transition log shows single-step moves only
    steps = [lvl for _, lvl in ctrl.snapshot()["transitions"]]
    assert all(abs(b - a) == 1 for a, b in zip(steps, steps[1:]))


def test_ladder_orders_background_pause_before_normal_shed():
    """Level 2 (pause background) is strictly below level 3 (shed
    normal): the hook fires before any normal-class level shed, and
    resumes on the way down."""
    clock = FakeClock(1_000.0)
    events = []
    ctrl = _controller(clock=clock, dwell=2.0,
                       background_hook=lambda p: events.append(
                           (clock.monotonic(), p)))
    held = [ctrl.admit(CLASS_SHEDDABLE) for _ in range(4)]
    first_normal_level_shed = None
    for _ in range(6):
        _drive_timeout(ctrl, clock)
        clock.advance(ctrl.dwell)
        lvl = ctrl.level()
        if lvl >= LEVEL_SHED_NORMAL and first_normal_level_shed is None:
            with pytest.raises(Shed):
                ctrl.admit(CLASS_NORMAL, peer="x")
            first_normal_level_shed = clock.monotonic()
    assert first_normal_level_shed is not None
    assert events and events[0][1] is True
    assert events[0][0] < first_normal_level_shed
    assert ctrl.background_paused()
    for t in held:
        t.release()
    clock.advance(ctrl._window + 1)
    for _ in range(6):
        clock.advance(ctrl.dwell)
        ctrl.level()
    assert events[-1][1] is False and not ctrl.background_paused()


def test_background_pause_reaches_verify_service():
    """The ladder's hook pauses the port's verify service's BACKGROUND
    lane (the daemon wires `background_hook` to
    `VerifyService.set_background_paused`): queued work waits (never
    fails) and flushes when the ladder steps back down, while LIVE work
    keeps flowing."""
    import numpy as np

    from drand_tpu_torch.crypto.schemes import scheme_from_name
    from drand_tpu_torch.crypto.verify_service import VerifyService

    class _Echo:            # instant fake backend
        kind = "host"

        def verify_batch(self, rounds, sigs, prevs=None):
            return np.ones(len(rounds), dtype=bool)

    svc = VerifyService(clock=RealClock(), live_window=0.0,
                        background_window=0.0)
    clock = FakeClock(1_000.0)
    ctrl = _controller(clock=clock, dwell=2.0,
                       background_hook=svc.set_background_paused)
    try:
        scheme = scheme_from_name("pedersen-bls-chained")
        # distinct chains: a queued background request of the SAME chain
        # would legitimately ride the live dispatch for free
        h_bg = svc.handle(scheme, b"\x01" * 96, backend=_Echo())
        h_live = svc.handle(scheme, b"\x02" * 96, backend=_Echo())
        held = [ctrl.admit(CLASS_SHEDDABLE) for _ in range(4)]
        for _ in range(6):
            if ctrl.level() >= LEVEL_PAUSE_BACKGROUND:
                break
            _drive_timeout(ctrl, clock)
            clock.advance(ctrl.dwell)
        assert ctrl.level() >= LEVEL_PAUSE_BACKGROUND
        assert svc.background_paused()
        bg = h_bg.submit([1], [b"x"], lane="background", flush_now=True)
        live = h_live.submit([2], [b"y"], lane="live", flush_now=True)
        assert live.result(5).all()         # live unaffected
        time.sleep(0.2)
        assert not bg.done()                # background parked, not failed
        for t in held:
            t.release()
        clock.advance(ctrl._window + 1)
        for _ in range(6):
            clock.advance(ctrl.dwell)
            if ctrl.level() < LEVEL_PAUSE_BACKGROUND:
                break
        assert not svc.background_paused()
        assert bg.result(5).all()           # resumes flush-ready
    finally:
        svc.stop()


# -- wire shapes --------------------------------------------------------------


def test_rest_429_shape_and_recovery():
    """The REST edge sheds BEFORE parsing with a complete 429: status,
    Retry-After, JSON body, connection close — and serves again the
    moment a token frees."""
    from types import SimpleNamespace

    from drand_tpu_torch.http_server import RestServer
    from drand_tpu_torch.log import Logger

    ctrl = _controller(capacity=3, critical_reserve=2)  # 1 sheddable token
    daemon = SimpleNamespace(processes={}, chain_hashes={},
                             log=Logger("t"))
    server = RestServer(daemon, "127.0.0.1:0", admission=ctrl,
                        clock=RealClock(), workers=2)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        with urllib.request.urlopen(base + "/chains", timeout=5) as r:
            assert r.status == 200
        # the serving worker releases its token asynchronously after the
        # response body: retry-grab the one sheddable token briefly
        deadline = time.monotonic() + 3
        while True:
            try:
                held = ctrl.admit(CLASS_SHEDDABLE)
                break
            except Shed:
                assert time.monotonic() < deadline
                time.sleep(0.02)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/chains", timeout=5)
        assert e.value.code == 429
        assert float(e.value.headers["Retry-After"]) > 0
        assert e.value.headers["Connection"] == "close"
        assert json.loads(e.value.read())["error"] == "overloaded"
        held.release()
        with urllib.request.urlopen(base + "/chains", timeout=5) as r:
            assert r.status == 200
    finally:
        server.stop()


def test_peer_identity_strips_ephemeral_port():
    """The fair-share key is the remote HOST: a hog must not evade the
    stream cap by opening one channel (one ephemeral port) per stream."""
    from drand_tpu_torch.net.admission import peer_identity

    assert peer_identity("ipv4:10.0.0.1:52644") == "ipv4:10.0.0.1"
    assert peer_identity("ipv4:10.0.0.1:9") == \
        peer_identity("ipv4:10.0.0.1:52645")
    assert peer_identity("ipv6:[::1]:52644") == "ipv6:[::1]"
    assert peer_identity("ipv6:[::1]") == "ipv6:[::1]"
    assert peer_identity("hog") == "hog"            # scenario names
    assert peer_identity("127.0.0.1") == "127.0.0.1"  # REST client addr


def test_classify_method_map():
    assert classify_method("/drand.Protocol/PartialBeacon") == CLASS_CRITICAL
    assert classify_method("/drand.Protocol/BroadcastDKG") == CLASS_CRITICAL
    assert classify_method("/drand.Protocol/SyncChain") == CLASS_NORMAL
    assert classify_method("/drand.Public/PublicRand") == CLASS_SHEDDABLE
    assert classify_method("/drand.Public/ChainInfo") == CLASS_SHEDDABLE
    assert classify_method("/drand.Control/Shutdown") is None


# -- the bounded REST edge ----------------------------------------------------


def test_rest_worker_pool_is_bounded_and_reaped():
    """Request traffic must never grow the thread set (the
    old ThreadingHTTPServer spawned one non-daemon thread per request),
    and stop() reaps acceptor + workers (harness leak check)."""
    from types import SimpleNamespace

    from drand_tpu_torch.http_server import RestServer
    from drand_tpu_torch.log import Logger

    before = rest_threads()
    daemon = SimpleNamespace(processes={}, chain_hashes={},
                             log=Logger("t"))
    server = RestServer(daemon, "127.0.0.1:0", clock=RealClock(),
                        workers=4)
    server.start()
    base = f"http://127.0.0.1:{server.port}"

    def hit():
        try:
            with urllib.request.urlopen(base + "/chains", timeout=5) as r:
                r.read()
        except Exception:
            pass

    for _ in range(30):                     # sequential
        hit()
    burst = [threading.Thread(target=hit, daemon=True) for _ in range(12)]
    for t in burst:
        t.start()
    mid = [t for t in rest_threads() if t not in before]
    for t in burst:
        t.join(5)
    # acceptor + exactly `workers` pool threads, regardless of traffic
    assert len(mid) <= 1 + 4, [t.name for t in mid]
    assert all(t.daemon for t in mid)
    server.stop()
    assert_no_leaked_rest_threads(before=before)
