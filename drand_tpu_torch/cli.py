"""drand_tpu_torch command-line interface (reference:
cmd/drand-cli/cli.go:60-580).

    python -m drand_tpu_torch.cli <command> ...

Daemon-side commands talk to a running daemon over the localhost control
plane (net/control.go); `start` runs the daemon itself.  Flags accept
`DRAND_*` environment fallbacks like the reference's urfave/cli setup.

The port's copy of drand_tpu/cli.py.  `start` checks partials on the card
unless `--no-device` is given (`--no-tpu` is kept as its alias); without a
card a device chain raises when it starts.  The lock sanitizer's held-lock
table (the reference's analysis/tsan.py, under DRAND_TSAN=1) is not
ported, so SIGUSR1 dumps the threads' stacks alone, and `--db postgres`
is refused.
"""

import argparse
import os
import signal
import sys
import time

from . import log as dlog
from .common import DEFAULT_BEACON_ID
from .core.config import (Config, DEFAULT_CONTROL_PORT,
                          default_config_folder)
from .net import ControlClient, Peer, ProtocolClient
from .net import convert
from .protos import drand_pb2 as pb


def _env(name: str, default):
    return os.environ.get(f"DRAND_{name.upper().replace('-', '_')}", default)


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--folder", default=_env("folder", default_config_folder()),
                   help="config folder (~/.drand)")
    p.add_argument("--control", type=int,
                   default=int(_env("control", DEFAULT_CONTROL_PORT)),
                   help="control port of the local daemon")
    p.add_argument("--id", default=_env("beacon_id", DEFAULT_BEACON_ID),
                   help="beacon id (multi-beacon daemons)")
    p.add_argument("--json", action="store_true", help="JSON log output")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--identity-dir", default=_env("identity_dir", ""),
                   help="cert dir (node.key/node.crt/ca.crt) for mutual "
                        "TLS — on `start` it arms the identity plane; on "
                        "control commands it authenticates the client "
                        "(DRAND_IDENTITY_DIR)")


def _control(args) -> ControlClient:
    return ControlClient(args.control,
                         identity_dir=getattr(args, "identity_dir", "")
                         or None)


def _md(args):
    return convert.metadata(args.id)


# -- commands ----------------------------------------------------------------

def cmd_generate_keypair(args) -> int:
    from .crypto.schemes import get_scheme_by_id_with_default
    from .key.keys import new_keypair
    from .key.store import FileStore
    scheme = get_scheme_by_id_with_default(args.scheme)
    pair = new_keypair(args.address, scheme, tls=args.tls)
    FileStore(args.folder, args.id).save_keypair(pair)
    print(f"Generated keys for {args.address} (scheme {scheme.id})")
    print(f"Public key: {pair.public.key.hex()}")
    return 0


# service threads that must be gone after a clean stop (mirrors
# tests/harness.SERVICE_THREAD_PREFIXES — the daemon-side copy backs the
# leaked-thread exit code, so fleet runs catch leaks without importing
# test code into the child process)
_SERVICE_THREAD_PREFIXES = ("verify-scheduler", "verify-packer",
                            "verify-watchdog", "verify-probe",
                            "transition-", "handel-")


def _write_ready_file(path: str, daemon, cfg) -> None:
    """Atomically publish this daemon's pid + bound ports (the fleet
    supervisor binds everything ephemeral and reads the roster back from
    here — no port races)."""
    import json
    import tempfile
    info = {
        "pid": os.getpid(),
        "private": daemon.gateway.listen_addr,
        "control": daemon.control.port,
        "metrics": daemon.metrics.port if daemon.metrics is not None
        else None,
        "public": daemon.http_server.port
        if daemon.http_server is not None else None,
        "folder": cfg.folder,
    }
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".ready-")
    with os.fdopen(fd, "w") as f:
        json.dump(info, f)
    os.replace(tmp, path)


def _leaked_service_threads() -> list:
    import threading
    return sorted(t.name for t in threading.enumerate()
                  if t.name.startswith(_SERVICE_THREAD_PREFIXES))


def _install_dump_handler() -> None:
    """SIGUSR1 -> all-thread stack dump on stderr, the operator's answer
    to "what is this daemon doing right now".  No-op on platforms
    without SIGUSR1."""
    if not hasattr(signal, "SIGUSR1"):
        return

    def _dump(_s, _f):
        import faulthandler
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        sys.stderr.flush()

    signal.signal(signal.SIGUSR1, _dump)


def cmd_start(args) -> int:
    identity_dir = getattr(args, "identity_dir", "") or None
    cfg = Config(
        folder=args.folder,
        private_listen=args.private_listen,
        public_listen=args.public_listen or "",
        control_port=args.control,
        metrics_port=args.metrics,
        db_engine=args.db,
        insecure=not (identity_dir or (args.tls_cert and args.tls_key)),
        tls_cert=args.tls_cert, tls_key=args.tls_key,
        identity_dir=identity_dir,
        dkg_timeout=args.dkg_timeout,
        use_device_verifier=not args.no_device)
    from .core.daemon import DrandDaemon
    daemon = DrandDaemon(cfg)
    daemon.start()
    if cfg.public_listen:
        from .http_server import RestServer
        daemon.http_server = RestServer(daemon, cfg.public_listen,
                                        admission=daemon.admission)
        daemon.http_server.start()
    daemon.load_beacons_from_disk()
    if args.ready_file:
        _write_ready_file(args.ready_file, daemon, cfg)
    import threading
    stopping = []
    stoppers = []
    drain_ok = []

    def _graceful():
        drain_ok.append(daemon.graceful_stop(grace=args.grace))

    def _sig(s, _f):
        if stopping:
            return
        stopping.append(1)
        if s == signal.SIGTERM:
            # drain off the signal frame: the handler runs on the main
            # thread mid-wait_exit, and graceful_stop blocks on condvars
            t = threading.Thread(target=_graceful, daemon=True,
                                 name="stop-graceful")
            stoppers.append(t)
            t.start()
        else:
            daemon.stop()
    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    _install_dump_handler()
    print(f"drand daemon up: private={daemon.gateway.listen_addr} "
          f"control={daemon.control.port}", flush=True)
    try:
        while not daemon.wait_exit(0.5):
            pass
    except KeyboardInterrupt:
        daemon.stop()
    for t in stoppers:
        t.join(timeout=args.grace + 5)
    # teardown verdict: 0 clean; 1 drain timed out; 3 leaked service
    # threads — the fleet invariant checker reads these exit codes
    settle = threading.Event()
    leaked = _leaked_service_threads()
    for _ in range(20):
        if not leaked:
            break
        settle.wait(0.1)
        leaked = _leaked_service_threads()
    if leaked:
        print(f"leaked service threads: {leaked}", file=sys.stderr)
        return 3
    if drain_ok and not drain_ok[0]:
        return 1
    return 0


def cmd_stop(args) -> int:
    cc = _control(args)
    cc.stub.shutdown(pb.ShutdownRequest(metadata=_md(args)))
    print("daemon stopped")
    return 0


def _read_secret(args) -> bytes:
    if args.secret_file:
        with open(args.secret_file, "rb") as f:
            return f.read().strip()
    env = os.environ.get("DRAND_SHARE_SECRET")
    if env:
        return env.encode()
    raise SystemExit("need --secret-file or DRAND_SHARE_SECRET")


def cmd_share(args) -> int:
    """DKG / reshare kickoff (cli.go shareCmd; control.go:877)."""
    cc = _control(args)
    info = pb.SetupInfo(
        leader=args.leader, leader_address=args.connect or "",
        nodes=args.nodes, threshold=args.threshold,
        timeout_seconds=args.setup_timeout, secret=_read_secret(args))
    # Session timeout: setup window + DKG phases + margin.
    rpc_timeout = args.setup_timeout + 120
    if args.transition or args.from_group:
        req = pb.InitResharePacket(info=info,
                                   old_group_path=args.from_group or "",
                                   metadata=_md(args))
        group = cc.stub.init_reshare(req, timeout=rpc_timeout)
    else:
        req = pb.InitDKGPacket(
            info=info, beacon_period_seconds=args.period,
            catchup_period_seconds=args.catchup_period,
            schemeID=args.scheme, metadata=_md(args))
        group = cc.stub.init_dkg(req, timeout=rpc_timeout)
    g = convert.proto_to_group(group)
    print(f"Group created: {len(g)} nodes, threshold {g.threshold}, "
          f"genesis {g.genesis_time}")
    print(f"Group hash: {g.hash().hex()}")
    if g.public_key is not None:
        print(f"Collective key: {g.public_key.key().hex()}")
    return 0


def cmd_get(args) -> int:
    """Fetch + verify randomness from a remote node's public API
    (cmd/client + core/client_public.go)."""
    client = ProtocolClient()
    peer = Peer(args.url, args.tls)
    if args.what == "chain-info":
        info = convert.proto_to_info(client.chain_info(peer, args.id))
        sys.stdout.buffer.write(info.to_json() + b"\n")
        return 0
    resp = client.public_rand(peer, args.round, args.id)
    beacon = convert.rand_to_beacon(resp)
    if args.chain_hash:
        from .client.verify import verify_beacon_with_info
        info = convert.proto_to_info(client.chain_info(peer, args.id))
        if info.hash_string() != args.chain_hash:
            print("chain hash mismatch", file=sys.stderr)
            return 1
        if not verify_beacon_with_info(info, beacon):
            print("beacon verification FAILED", file=sys.stderr)
            return 1
    print(f"round: {beacon.round}")
    print(f"randomness: {beacon.randomness().hex()}")
    print(f"signature: {beacon.signature.hex()}")
    return 0


def cmd_show(args) -> int:
    cc = _control(args)
    if args.what == "group":
        group = cc.stub.group_file(pb.GroupRequest(metadata=_md(args)))
        print(convert.proto_to_group(group).to_toml())
    elif args.what == "chain-info":
        packet = cc.stub.chain_info(pb.ChainInfoRequest(metadata=_md(args)))
        sys.stdout.buffer.write(
            convert.proto_to_info(packet).to_json() + b"\n")
    elif args.what == "public":
        resp = cc.stub.public_key(pb.PublicKeyRequest(metadata=_md(args)))
        print(resp.pub_key.hex())
    return 0


def cmd_sync(args) -> int:
    """Follow (observer) or check/repair the local chain
    (cli.go syncCmd; control.go follow/check)."""
    cc = _control(args)
    req = pb.StartSyncRequest(
        nodes=args.sync_nodes, is_tls=args.tls, up_to=args.up_to,
        beaconID=args.id, chain_hash=args.chain_hash or "",
        metadata=_md(args))
    stream = (cc.stub.start_follow_chain if args.follow
              else cc.stub.start_check_chain)
    for progress in stream(req):
        print(f"\rsync {progress.current}/{progress.target}", end="",
              flush=True)
    print()
    return 0


def cmd_token(args) -> int:
    """Tenant token mint/revoke/list over the Control plane.
    The minted token string is printed exactly once — the daemon's ledger
    keeps only its id and caveat metadata."""
    cc = _control(args)
    if args.token_cmd == "mint":
        resp = cc.stub.token_mint(pb.TokenMintRequest(
            tenant=args.tenant, chains=args.chains,
            ttl_seconds=args.ttl, read_only=args.read_only,
            metadata=_md(args)))
        print(f"token-id: {resp.token_id}")
        if resp.expires:
            print(f"expires: {resp.expires:.0f}")
        print(resp.token)
        return 0
    if args.token_cmd == "revoke":
        cc.stub.token_revoke(pb.TokenRequest(token_id=args.token_id,
                                             metadata=_md(args)))
        print(f"revoked {args.token_id}")
        return 0
    for t in cc.stub.token_list(pb.TokenRequest(metadata=_md(args))).tokens:
        state = "revoked" if t.revoked else "active"
        caveats = []
        if t.chains:
            caveats.append("chains=" + ",".join(t.chains))
        if t.expires:
            caveats.append(f"expires={t.expires:.0f}")
        if t.read_only:
            caveats.append("read-only")
        print(f"{t.token_id}  {t.tenant}  {state}"
              + ("  " + " ".join(caveats) if caveats else ""))
    return 0


def cmd_identity(args) -> int:
    """Provision the mTLS identity plane: a CA plus one cert dir per
    roster entry (net/identity.py).  `name=host:port` pairs come from the
    group roster; each node then starts with --identity-dir."""
    from .net.identity import provision_fleet
    roster = {}
    for entry in args.nodes:
        name, _, addr = entry.partition("=")
        if not addr:
            raise SystemExit(f"expected name=host[:port], got {entry!r}")
        host = addr.rsplit(":", 1)[0] if ":" in addr else addr
        roster[name] = [host]
    dirs = provision_fleet(args.out, roster, days=args.days)
    for name, d in sorted(dirs.items()):
        print(f"{name}: {d}")
    return 0


def cmd_util(args) -> int:
    cc_lazy = lambda: _control(args)
    if args.util == "check":
        # connectivity probe of listed addresses (cli.go checkCmd)
        client = ProtocolClient()
        bad = 0
        for addr in args.addresses:
            try:
                client.home(Peer(addr, args.tls))
                print(f"{addr}: ok")
            except Exception as e:
                print(f"{addr}: FAIL ({e})")
                bad += 1
        return 1 if bad else 0
    if args.util == "ping":
        cc_lazy().stub.ping_pong(pb.Ping(metadata=_md(args)))
        print("pong")
        return 0
    if args.util == "list-schemes":
        for s in cc_lazy().stub.list_schemes(
                pb.ListSchemesRequest(metadata=_md(args))).ids:
            print(s)
        return 0
    if args.util == "status":
        st = cc_lazy().stub.status(pb.StatusRequest(metadata=_md(args)))
        print(st)
        return 0
    if args.util == "remote-status":
        req = pb.RemoteStatusRequest(metadata=_md(args))
        for a in args.addresses:
            req.addresses.append(pb.StatusAddress(address=a, tls=args.tls))
        print(cc_lazy().stub.remote_status(req))
        return 0
    if args.util == "self-sign":
        from .key.store import FileStore
        fs = FileStore(args.folder, args.id)
        pair = fs.load_keypair()
        pair.self_sign()
        fs.save_keypair(pair)
        print("keypair self-signed")
        return 0
    if args.util == "backup":
        cc_lazy().stub.backup_database(
            pb.BackupDBRequest(output_file=args.out, metadata=_md(args)))
        print(f"backup written to {args.out}")
        return 0
    if args.util == "migrate":
        from .migration import migrate
        did = migrate(args.folder, args.id or "default")
        print("migrated" if did else "nothing to migrate")
        return 0
    if args.util in ("reset", "del-beacon"):
        from .key.store import FileStore
        import shutil
        fs = FileStore(args.folder, args.id)
        fs.reset()
        db = os.path.join(args.folder, "multibeacon",
                          args.id or DEFAULT_BEACON_ID, "db")
        if args.util == "del-beacon" and os.path.isdir(db):
            shutil.rmtree(db)
        print(f"{args.util}: done for beacon {args.id!r}")
        return 0
    raise SystemExit(f"unknown util command {args.util!r}")


# -- parser ------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    root = argparse.ArgumentParser(
        prog="drand", description="drand daemon and tools on the GPU")
    sub = root.add_subparsers(dest="command", required=True)

    p = sub.add_parser("generate-keypair", help="create a longterm keypair")
    _add_common(p)
    p.add_argument("address", help="public host:port of this node")
    p.add_argument("--scheme", default="", help="scheme id")
    p.add_argument("--tls", action="store_true")
    p.set_defaults(fn=cmd_generate_keypair)

    p = sub.add_parser("start", help="run the daemon")
    _add_common(p)
    p.add_argument("--private-listen", default="127.0.0.1:0",
                   help="node-to-node gRPC bind address")
    p.add_argument("--public-listen", default="",
                   help="REST edge bind address (empty = off)")
    p.add_argument("--metrics", type=int, default=None,
                   help="metrics HTTP port (omit = disabled; 0 = ephemeral)")
    p.add_argument("--db", default="sqlite", choices=["sqlite", "memdb"])
    p.add_argument("--tls-cert")
    p.add_argument("--tls-key")
    p.add_argument("--dkg-timeout", type=int, default=10)
    p.add_argument("--no-device", "--no-tpu", dest="no_device",
                   action="store_true",
                   help="host-only partial verification (default: the card)")
    p.add_argument("--ready-file", default=_env("ready_file", ""),
                   help="write pid + bound ports here once serving "
                        "(fleet supervisors; DRAND_READY_FILE)")
    p.add_argument("--grace", type=float,
                   default=float(_env("grace", 10.0)),
                   help="SIGTERM drain budget in seconds (DRAND_GRACE)")
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("stop", help="shut the daemon down")
    _add_common(p)
    p.set_defaults(fn=cmd_stop)

    p = sub.add_parser("share", help="run a DKG or reshare")
    _add_common(p)
    p.add_argument("--leader", action="store_true")
    p.add_argument("--connect", help="leader address (followers)")
    p.add_argument("--nodes", type=int, default=0)
    p.add_argument("--threshold", type=int, default=0)
    p.add_argument("--period", type=int, default=30)
    p.add_argument("--catchup-period", type=int, default=0)
    p.add_argument("--scheme", default="")
    p.add_argument("--secret-file")
    p.add_argument("--setup-timeout", type=int, default=60)
    p.add_argument("--transition", action="store_true",
                   help="reshare from the stored group")
    p.add_argument("--from", dest="from_group",
                   help="reshare from this group TOML (newcomers)")
    p.set_defaults(fn=cmd_share)

    p = sub.add_parser("get", help="fetch randomness from a node")
    _add_common(p)
    p.add_argument("what", choices=["public", "chain-info"])
    p.add_argument("url", help="node gRPC address")
    p.add_argument("--round", type=int, default=0)
    p.add_argument("--tls", action="store_true")
    p.add_argument("--chain-hash", help="verify against this chain hash")
    p.set_defaults(fn=cmd_get)

    p = sub.add_parser("show", help="inspect local daemon state")
    _add_common(p)
    p.add_argument("what", choices=["group", "chain-info", "public"])
    p.set_defaults(fn=cmd_show)

    p = sub.add_parser("sync", help="follow or check a chain")
    _add_common(p)
    p.add_argument("--follow", action="store_true")
    p.add_argument("--sync-nodes", nargs="+", default=[])
    p.add_argument("--up-to", type=int, default=0)
    p.add_argument("--chain-hash")
    p.add_argument("--tls", action="store_true")
    p.set_defaults(fn=cmd_sync)

    p = sub.add_parser("token", help="tenant bearer tokens (mint/revoke/list)")
    _add_common(p)
    p.add_argument("token_cmd", choices=["mint", "revoke", "list"])
    p.add_argument("--tenant", default="", help="tenant the token names")
    p.add_argument("--chains", nargs="*", default=[],
                   help="beacon-id allowlist caveat (empty = any chain)")
    p.add_argument("--ttl", type=float, default=0.0,
                   help="seconds until expiry (0 = no expiry caveat)")
    p.add_argument("--read-only", action="store_true")
    p.add_argument("--token-id", default="", help="id to revoke")
    p.set_defaults(fn=cmd_token)

    p = sub.add_parser("identity",
                       help="provision mTLS certs for a roster")
    _add_common(p)
    p.add_argument("nodes", nargs="+", metavar="name=host[:port]",
                   help="roster entries to issue certs for")
    p.add_argument("--out", default="identity",
                   help="output root (CA + one cert dir per node)")
    p.add_argument("--days", type=int, default=365,
                   help="certificate validity in days")
    p.set_defaults(fn=cmd_identity)

    p = sub.add_parser("util", help="maintenance helpers")
    _add_common(p)
    p.add_argument("util", choices=[
        "check", "ping", "list-schemes", "status", "remote-status",
        "self-sign", "backup", "reset", "del-beacon", "migrate"])
    p.add_argument("addresses", nargs="*", default=[])
    p.add_argument("--tls", action="store_true")
    p.add_argument("--out", default="backup.db")
    p.set_defaults(fn=cmd_util)

    return root


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dlog.configure(level="debug" if args.verbose else "info",
                   json_output=args.json)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
