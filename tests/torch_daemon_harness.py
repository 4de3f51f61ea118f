"""Port-side fixtures for the daemon's tests: tests/chaos.py's AutoClock,
_LocalDkgNet and DkgLifecycleHarness over drand_tpu_torch.

The same classes as the reference's, their imports naming the port: n real
port BeaconProcesses over one in-process DKG network and a shared
FakeClock, each with its own folder.  Free of jax and drand_tpu.
"""

import os
import threading
from typing import Dict, List, Optional

from drand_tpu_torch.beacon.clock import FakeClock


class AutoClock(FakeClock):
    """FakeClock whose waiters advance time themselves: `wait_until` jumps
    straight to the deadline.  Backoff schedules, breaker cooldowns, and
    deadline budgets all elapse instantly AND deterministically — fake time
    only moves when someone asks to wait for it."""

    def wait_until(self, deadline: float, stop: threading.Event) -> bool:
        if stop.is_set():
            return False
        with self._cond:
            if deadline > self._now:
                self._now = deadline
                self._cond.notify_all()
        return True

    def jump(self, dt: float) -> None:
        """advance() that tolerates concurrent callers (fault injectors
        advance from stream pump threads)."""
        with self._cond:
            self._now += dt
            self._cond.notify_all()



class _LocalDkgNet:
    """ProtocolClient stand-in: routes by address with kill switches, an
    inbound-DKG drop gate (a node that can send but not receive — the
    hang that turns into a mid-deal crash), and a tap recording every
    routed DKG packet (stale-bundle tests replay from it)."""

    resilience = None           # BeaconProcess falls back to cfg's policy

    def __init__(self):
        self.procs: Dict[str, object] = {}
        self.down: set = set()
        self.drop_dkg_to: set = set()
        self.fail_push_to: set = set()    # push_dkg_info raises (partial
                                          # group arming)
        self.taps: List[tuple] = []       # (dest addr, DKGPacket)
        self._lock = threading.Lock()

    def register(self, bp) -> None:
        with self._lock:
            self.procs[bp.pair.public.addr] = bp
            self.down.discard(bp.pair.public.addr)

    def kill(self, addr: str) -> None:
        with self._lock:
            self.down.add(addr)

    def _bp(self, peer):
        addr = getattr(peer, "address", None) or str(peer)
        with self._lock:
            if addr in self.down:
                raise ConnectionError(f"{addr} is down")
            bp = self.procs.get(addr)
        if bp is None:
            raise ConnectionError(f"no node at {addr}")
        return bp

    # -- the ProtocolClient surface BeaconProcess consumes -------------------

    def get_identity(self, peer, beacon_id: str = "", deadline=None,
                     timeout=None):
        from drand_tpu_torch.net import convert
        from drand_tpu_torch.protos import drand_pb2 as pb
        ident = self._bp(peer).pair.public
        return pb.IdentityResponse(
            address=ident.addr, key=ident.key, tls=ident.tls,
            signature=ident.signature or b"",
            metadata=convert.metadata(beacon_id),
            schemeName=ident.scheme.id)

    def signal_dkg_participant(self, peer, packet, timeout=None,
                               deadline=None):
        self._bp(peer).signal_dkg_participant(packet)

    def push_dkg_info(self, peer, packet, timeout=None):
        bp = self._bp(peer)
        with self._lock:
            if bp.pair.public.addr in self.fail_push_to:
                raise ConnectionError(
                    f"{bp.pair.public.addr} refused the group push")
        bp.push_dkg_info(packet)

    def broadcast_dkg(self, peer, packet):
        bp = self._bp(peer)
        addr = bp.pair.public.addr
        with self._lock:
            self.taps.append((addr, packet))
            if addr in self.drop_dkg_to:
                return          # delivered nowhere: inbound partition
        bp.broadcast_dkg(packet)

    def partial_beacon(self, peer, packet, deadline=None, timeout=None):
        bp = self._bp(peer)
        try:
            bp.process_partial(packet)
        except ValueError:
            pass                # stale/window rejections are per-protocol

    def sync_chain(self, peer, from_round: int, beacon_id: str = ""):
        # peers serve nothing: the lifecycle scenarios run thr == n, so
        # the chain only advances in lockstep and nobody ever NEEDS sync
        self._bp(peer)
        return iter(())


class DkgLifecycleHarness:
    """n real BeaconProcesses over one _LocalDkgNet + shared FakeClock,
    each with its own tmpdir FileStore (journal, staged files, sqlite
    chain).  thr == n, so every node's partial is load-bearing: a node
    signing any round with the wrong share stalls the chain — 'no
    invalid partials' is asserted by progress itself."""

    SECRET = b"lifecycle-secret"

    def __init__(self, root: str, n: int = 3, period: int = 30,
                 clock=None, dkg_timeout: int = 4, reshare_offset: int = 45,
                 db_engine: str = "sqlite"):
        self.root = str(root)
        self.n = n
        self.period = period
        self.dkg_timeout = dkg_timeout
        self.reshare_offset = reshare_offset
        self.db_engine = db_engine
        self.clock = clock if clock is not None \
            else FakeClock(start=1_700_000_000.0)
        self.net = _LocalDkgNet()
        self.addrs = [f"127.0.0.1:{7100 + i}" for i in range(n)]
        self.bps: Dict[int, object] = {}
        self.cfgs: Dict[int, object] = {}
        for i in range(n):
            self.build_process(i)

    def build_process(self, i: int):
        """(Re)create node i's BeaconProcess over its on-disk state —
        construction + load() IS the restart path under test."""
        from drand_tpu_torch.core.beacon_process import BeaconProcess
        from drand_tpu_torch.core.config import Config
        from drand_tpu_torch.crypto.schemes import get_scheme_by_id_with_default
        from drand_tpu_torch.key.keys import new_keypair
        from drand_tpu_torch.key.store import FileStore
        from drand_tpu_torch.log import Logger

        folder = os.path.join(self.root, f"n{i}")
        cfg = Config(folder=folder, clock=self.clock,
                     db_engine=self.db_engine, use_device_verifier=False,
                     dkg_timeout=self.dkg_timeout, dkg_kickoff_grace=0.0,
                     reshare_offset=self.reshare_offset, sync_budget=5.0,
                     insecure=True)
        fstore = FileStore(folder, "default")
        try:
            pair = fstore.load_keypair()
        except FileNotFoundError:
            pair = new_keypair(self.addrs[i],
                               get_scheme_by_id_with_default(""),
                               tls=False, seed=b"lifecycle-%d" % i)
            fstore.save_keypair(pair)
        bp = BeaconProcess(cfg, fstore, "default", pair, self.net,
                           Logger(f"n{i}"))
        self.net.register(bp)
        self.bps[i] = bp
        self.cfgs[i] = cfg
        return bp

    # -- sessions ------------------------------------------------------------

    def run_dkg(self, threshold: Optional[int] = None, secret: bytes = b"",
                setup_timeout: float = 30.0, leader: int = 0,
                start_beacons: bool = True, timeout: float = 120.0):
        """Full networked DKG through the real control-plane entry points
        (leader thread + follower threads, like the daemon's InitDKG)."""
        from drand_tpu_torch.crypto.schemes import get_scheme_by_id_with_default
        from drand_tpu_torch.net import Peer as NetPeer

        secret = secret or self.SECRET
        thr = threshold if threshold is not None else self.n
        results: Dict[int, object] = {}
        errors: List[tuple] = []

        def lead():
            try:
                results[leader] = self.bps[leader].init_dkg_leader(
                    n_nodes=self.n, threshold=thr, period=self.period,
                    catchup_period=5, secret=secret,
                    setup_timeout=setup_timeout,
                    scheme=get_scheme_by_id_with_default(""))
            except Exception as e:
                errors.append((leader, e))

        def follow(i):
            try:
                results[i] = self.bps[i].join_dkg(
                    leader=NetPeer(self.addrs[leader]), secret=secret,
                    setup_timeout=setup_timeout)
            except Exception as e:
                errors.append((i, e))

        lt = threading.Thread(target=lead, daemon=True, name="dkg-leader")
        lt.start()
        self._await_setup(self.bps[leader])
        fts = [threading.Thread(target=follow, args=(i,), daemon=True,
                                name=f"dkg-follow-{i}")
               for i in range(self.n) if i != leader]
        for t in fts:
            t.start()
        for t in [lt] + fts:
            t.join(timeout=timeout)
        if errors:
            raise RuntimeError(f"dkg failed: {errors}")
        group = results[leader]
        if start_beacons:
            for i in range(self.n):
                self.bps[i].start_beacon(catchup=False)
        return group

    def run_reshare(self, old_group, threshold: Optional[int] = None,
                    secret: bytes = b"", setup_timeout: float = 30.0,
                    leader: int = 0, timeout: float = 120.0):
        from drand_tpu_torch.net import Peer as NetPeer

        secret = secret or self.SECRET
        thr = threshold if threshold is not None else self.n
        results: Dict[int, object] = {}
        errors: List[tuple] = []

        def lead():
            try:
                results[leader] = self.bps[leader].init_reshare_leader(
                    old_group, n_nodes=self.n, threshold=thr,
                    secret=secret, setup_timeout=setup_timeout)
            except Exception as e:
                errors.append((leader, e))

        def follow(i):
            try:
                results[i] = self.bps[i].join_reshare(
                    leader=NetPeer(self.addrs[leader]),
                    old_group=self.bps[i].group or old_group,
                    secret=secret, setup_timeout=setup_timeout)
            except Exception as e:
                errors.append((i, e))

        lt = threading.Thread(target=lead, daemon=True, name="resh-leader")
        lt.start()
        self._await_setup(self.bps[leader])
        fts = [threading.Thread(target=follow, args=(i,), daemon=True,
                                name=f"resh-follow-{i}")
               for i in range(self.n) if i != leader]
        for t in fts:
            t.start()
        for t in [lt] + fts:
            t.join(timeout=timeout)
        if errors:
            raise RuntimeError(f"reshare failed: {errors}")
        return results[leader]

    @staticmethod
    def _await_setup(bp, timeout: float = 30.0) -> None:
        """Block (real time) until the leader's setup manager is up, so
        follower signals never hit the retry/backoff path (whose sleeps
        ride the frozen fake clock)."""
        import time as _t
        deadline = _t.monotonic() + timeout
        while bp._setup_manager is None:
            if _t.monotonic() >= deadline:
                raise TimeoutError("leader setup never came up")
            _t.sleep(0.01)

    # -- round production ----------------------------------------------------

    def set_genesis(self, group) -> None:
        self.clock.set_time(group.genesis_time)

    def advance_round(self) -> None:
        self.clock.advance(self.period)

    def wait_all(self, round_: int, timeout: float = 120.0) -> List[object]:
        out = []
        for i in sorted(self.bps):
            bp = self.bps[i]
            if bp.handler is None:
                continue
            b = bp.handler.chain.wait_for_round(round_, timeout,
                                                scheduled_time=True)
            assert b is not None, f"node {i} never reached round {round_}"
            out.append(b)
        return out

    # -- crash / restart -----------------------------------------------------

    def crash(self, i: int, hard: bool = False):
        """Process death.  `hard=False` also runs bp.stop() to reap the
        beacon/sync threads (we share one interpreter with the 'dead'
        process) — stop() never touches the journal/ledger/key files, so
        the DISK is exactly what the dead process last wrote.  `hard=True`
        skips stop() entirely: required when the victim dies MID-SESSION,
        where stop()'s board teardown would let the session thread unwind
        and overwrite the journal a real crash leaves behind."""
        bp = self.bps.pop(i)
        self.net.kill(self.addrs[i])
        if not hard:
            bp.stop()
            self.cfgs[i].stop_verify_service()
        return bp

    def restart(self, i: int, start: bool = True):
        bp = self.build_process(i)
        loaded = bp.load()
        if loaded and start:
            bp.start_beacon(catchup=True)
        return bp, loaded

    def stop_all(self) -> None:
        for i in list(self.bps):
            try:
                self.bps[i].stop()
            except Exception:
                pass
        for cfg in self.cfgs.values():
            try:
                cfg.stop_verify_service()
            except Exception:
                pass


