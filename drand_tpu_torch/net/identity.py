"""Identity plane: mTLS peer identity for the node-to-node gRPC planes.

Until this module, TLS on the private plane was server-side only and the
Handel `sender_index` binding fell back to an IP-literal heuristic — the
overlay's Byzantine defenses (demotion, impersonation rejection, breaker
scoring) assumed an identity the transport never actually provided.  The
identity plane closes that gap in three pieces:

  * **Provisioning** (`provision_ca` / `issue_cert` / `provision_fleet`):
    a private CA plus per-node EC-P256 certs whose SANs carry the node's
    roster hosts (DNS name + IP literals + localhost for the control
    plane).  Pure `openssl`-CLI subprocess work — the container has no
    Python `cryptography` package, and key material never transits this
    process beyond the files openssl itself writes (0600).

  * **`IdentityPlane`**: the daemon-side credential holder.  Watches a
    cert dir (`node.key`, `node.crt`, `ca.crt`), reloads atomically on
    mtime change (rate-limited on the daemon clock), and exposes

      - `server_credentials()` — `grpc.dynamic_ssl_server_credentials`
        with client-auth REQUIRED; the per-handshake fetcher picks up
        rotated certs without a listener restart,
      - `channel_credentials()` — client cert + CA roots for outbound
        dials, epoch-tagged so connection pools rebuild after rotation,
      - an expiry state machine: ``fresh`` -> ``grace`` (cert past
        notAfter but within the grace window: metered warning, still
        serving) -> ``expired`` (still serving — a mis-rotated cert
        degrades loudly, it never bricks a live committee).

  * **`PeerIdentity`**: the authenticated identity of an inbound peer,
    extracted from the gRPC auth context (cert SANs + CN).  The Handel
    coordinator binds claimed `sender_index` values to it — cert SAN <->
    roster entry — which makes DNS-named rosters enforceable where the
    old heuristic could only pin IP literals.

Layering: this module must not import core/ or beacon/ — consumers hand
in clocks and rosters; everything here is transport-level.

The port's copy of drand_tpu/net/identity.py, unchanged but for its imports.
"""

import os
import ssl
import subprocess
import threading

from ..common import make_lock
from dataclasses import dataclass, field
from typing import Optional, Tuple

import grpc

# cert-dir file layout (one dir per node)
KEY_FILE = "node.key"
CERT_FILE = "node.crt"
CA_FILE = "ca.crt"

DEFAULT_RELOAD_INTERVAL = 5.0       # seconds between cert-dir stat sweeps
DEFAULT_EXPIRY_GRACE = 24 * 3600.0  # warning window past notAfter

STATE_FRESH = "fresh"
STATE_GRACE = "grace"
STATE_EXPIRED = "expired"
_STATE_GAUGE = {STATE_FRESH: 0, STATE_GRACE: 1, STATE_EXPIRED: 2}

OPENSSL = os.environ.get("DRAND_OPENSSL", "openssl")


class IdentityError(RuntimeError):
    """Provisioning or credential-load failure."""


# -- provisioning (openssl CLI; no Python crypto dependency) ------------------

def _run_openssl(args, workdir: Optional[str] = None) -> str:
    proc = subprocess.run([OPENSSL] + args, capture_output=True, text=True,
                          timeout=60, cwd=workdir)
    if proc.returncode != 0:
        raise IdentityError(
            f"openssl {args[0]} failed rc={proc.returncode}: "
            f"{proc.stderr.strip()[:500]}")
    return proc.stdout


def provision_ca(ca_dir: str, cn: str = "drand-identity-ca",
                 days: int = 365) -> str:
    """Create a self-signed CA (EC P-256) under `ca_dir`; returns the dir.
    Idempotent: an existing ca.key/ca.crt pair is left untouched."""
    os.makedirs(ca_dir, exist_ok=True)
    key = os.path.join(ca_dir, "ca.key")
    crt = os.path.join(ca_dir, CA_FILE)
    if os.path.exists(key) and os.path.exists(crt):
        return ca_dir
    _run_openssl(["req", "-x509", "-newkey", "ec", "-pkeyopt",
                  "ec_paramgen_curve:prime256v1", "-nodes",
                  "-keyout", key, "-out", crt,
                  "-subj", f"/CN={cn}", "-days", str(days)])
    os.chmod(key, 0o600)
    return ca_dir


def _san_entries(hosts) -> str:
    parts = []
    for h in hosts:
        h = str(h).strip()
        if not h:
            continue
        is_ip = h.replace(".", "").replace(":", "").isdigit() or ":" in h
        parts.append(f"IP:{h}" if is_ip else f"DNS:{h}")
    if not parts:
        raise IdentityError("cert needs at least one SAN host")
    return ",".join(parts)


def issue_cert(cert_dir: str, name: str, hosts, ca_dir: str,
               days: int = 365) -> str:
    """Issue `cert_dir/node.{key,crt}` for `name` with SANs for every
    entry in `hosts`, signed by `ca_dir`'s CA, and copy ca.crt alongside.
    The cert carries both serverAuth and clientAuth EKUs — one identity
    serves and dials.  Returns cert_dir."""
    os.makedirs(cert_dir, exist_ok=True)
    key = os.path.join(cert_dir, KEY_FILE)
    csr = os.path.join(cert_dir, ".node.csr")
    crt = os.path.join(cert_dir, CERT_FILE)
    ext = os.path.join(cert_dir, ".san.ext")
    _run_openssl(["req", "-new", "-newkey", "ec", "-pkeyopt",
                  "ec_paramgen_curve:prime256v1", "-nodes",
                  "-keyout", key, "-out", csr, "-subj", f"/CN={name}"])
    os.chmod(key, 0o600)
    with open(ext, "w") as f:
        f.write(f"subjectAltName={_san_entries(hosts)}\n"
                "extendedKeyUsage=serverAuth,clientAuth\n")
    _run_openssl(["x509", "-req", "-in", csr,
                  "-CA", os.path.join(ca_dir, CA_FILE),
                  "-CAkey", os.path.join(ca_dir, "ca.key"),
                  "-CAcreateserial", "-out", crt,
                  "-days", str(days), "-extfile", ext])
    # a rotation must land atomically from the plane's point of view:
    # the watcher reads key+crt only after both mtimes settle, and the
    # csr/ext scratch files are removed so the dir holds only the trio
    for scratch in (csr, ext):
        try:
            os.unlink(scratch)
        except OSError:
            pass
    with open(os.path.join(ca_dir, CA_FILE), "rb") as f:
        ca_pem = f.read()
    with open(os.path.join(cert_dir, CA_FILE), "wb") as f:
        f.write(ca_pem)
    return cert_dir


def provision_fleet(root: str, names_to_hosts, days: int = 365) -> dict:
    """Provision a CA at `root/ca` plus one cert dir per roster entry:
    `names_to_hosts` maps node name -> iterable of hosts (the roster
    address hosts; 127.0.0.1/localhost are always appended so the
    control plane and loopback dials verify).  Returns {name: cert_dir}."""
    ca = provision_ca(os.path.join(root, "ca"), days=days)
    out = {}
    for name, hosts in names_to_hosts.items():
        all_hosts = list(hosts)
        for extra in ("127.0.0.1", "localhost"):
            if extra not in all_hosts:
                all_hosts.append(extra)
        out[name] = issue_cert(os.path.join(root, name), name, all_hosts,
                               ca, days=days)
    return out


# -- cert inspection ----------------------------------------------------------

def cert_facts(path: str) -> dict:
    """notAfter (epoch seconds) + SAN names + CN of a PEM cert, without
    the `cryptography` package: the stdlib test decoder first, the
    openssl CLI as fallback.  Unknown fields come back as None/()."""
    not_after, names, cn = None, (), ""
    try:
        info = ssl._ssl._test_decode_cert(path)      # noqa: SLF001
        if info.get("notAfter"):
            not_after = ssl.cert_time_to_seconds(info["notAfter"])
        names = tuple(v for k, v in info.get("subjectAltName", ())
                      if k in ("DNS", "IP Address"))
        for rdn in info.get("subject", ()):
            for k, v in rdn:
                if k == "commonName":
                    cn = v
    except Exception:
        try:
            out = _run_openssl(["x509", "-in", path, "-noout", "-enddate"])
            stamp = out.split("=", 1)[1].strip()
            not_after = ssl.cert_time_to_seconds(stamp)
        except Exception:
            not_after = None
    return {"not_after": not_after, "names": names, "common_name": cn}


# -- authenticated peer identity ----------------------------------------------

@dataclass(frozen=True)
class PeerIdentity:
    """The transport-authenticated identity of an inbound peer: the SAN
    names (DNS + IP) and CN of the client cert the mTLS handshake
    verified.  `matches(host)` is the roster-binding primitive: a claimed
    roster entry is this peer iff its host appears among the cert names."""

    names: Tuple[str, ...] = ()
    common_name: str = ""

    def matches(self, host: str) -> bool:
        if not host:
            return False
        h = host.lower()
        return any(h == n.lower() for n in self.names) \
            or (self.common_name and h == self.common_name.lower())

    @property
    def label(self) -> str:
        """Metrics/trailer label: the stable name of this identity."""
        return self.common_name or (self.names[0] if self.names else "?")


def peer_identity(context) -> Optional[PeerIdentity]:
    """Extract the authenticated PeerIdentity from a gRPC servicer
    context, or None on a plaintext / unauthenticated transport."""
    try:
        auth = context.auth_context()
    except Exception:
        return None
    if not auth or not auth.get("transport_security_type"):
        return None
    sans = tuple(v.decode("utf-8", "replace")
                 for v in auth.get("x509_subject_alternative_name", ()))
    cns = auth.get("x509_common_name", ())
    cn = cns[0].decode("utf-8", "replace") if cns else ""
    if not sans and not cn:
        return None
    return PeerIdentity(names=sans, common_name=cn)


# -- the daemon-side credential plane -----------------------------------------

@dataclass
class _Creds:
    """One loaded credential generation (immutable once published).
    The private key stays out of __repr__ — a generation that surfaces
    in a log line or exception must never carry key material."""
    key_pem: bytes = field(repr=False)
    cert_pem: bytes
    ca_pem: bytes
    not_after: Optional[float]
    names: Tuple[str, ...]
    common_name: str
    stamp: tuple                      # (key mtime_ns, crt mtime_ns, ca ...)
    epoch: int = 0
    channel: Optional[grpc.ChannelCredentials] = field(
        default=None, repr=False)


class IdentityPlane:
    """Hot-reloadable mTLS credentials for one node.

    Reads `node.key` / `node.crt` / `ca.crt` from `cert_dir`; rotation =
    overwrite those files (the issue path above, or any external PKI) —
    the plane picks the new trio up atomically on the next
    `maybe_reload()` sweep (rate-limited on the injected daemon clock;
    the server-credential fetcher and /health both drive it, so a live
    daemon converges within one handshake or health probe).

    Expiry never hard-fails serving: past `notAfter` the plane enters a
    metered ``grace`` state, past `notAfter + expiry_grace` it reports
    ``expired`` — both keep the last-good credentials active, because a
    committee bricked by a calendar is strictly worse than one serving
    on a stale cert while the operator rotates."""

    def __init__(self, cert_dir: str, clock=None,
                 reload_interval: float = DEFAULT_RELOAD_INTERVAL,
                 expiry_grace: float = DEFAULT_EXPIRY_GRACE, log=None):
        self.cert_dir = cert_dir
        self.clock = clock
        self.reload_interval = reload_interval
        self.expiry_grace = expiry_grace
        self.log = log
        self._lock = make_lock()
        self._creds: Optional[_Creds] = None
        self._next_sweep = float("-inf")
        self._reloads = 0
        self._last_state = None
        self._load(initial=True)

    # -- clock ---------------------------------------------------------------

    def _now(self) -> float:
        if self.clock is None:
            from ..beacon.clock import RealClock
            self.clock = RealClock()
        return self.clock.now()

    # -- loading -------------------------------------------------------------

    def _paths(self):
        return (os.path.join(self.cert_dir, KEY_FILE),
                os.path.join(self.cert_dir, CERT_FILE),
                os.path.join(self.cert_dir, CA_FILE))

    def _stamp(self) -> Optional[tuple]:
        try:
            return tuple(os.stat(p).st_mtime_ns for p in self._paths())
        except OSError:
            return None

    def _load(self, initial: bool = False) -> bool:
        """Read the trio into a fresh generation and swap it in.  All
        three files are read BEFORE the swap — a torn rotation (key
        written, crt not yet) fails wholesale and keeps the last-good
        generation."""
        from ..metrics import identity_cert_reloads
        key_p, crt_p, ca_p = self._paths()
        stamp = self._stamp()
        if stamp is None:
            if initial:
                raise IdentityError(
                    f"identity cert dir incomplete: {self.cert_dir} needs "
                    f"{KEY_FILE} + {CERT_FILE} + {CA_FILE}")
            identity_cert_reloads.labels("error").inc()
            return False
        try:
            with open(key_p, "rb") as f:
                key_pem = f.read()
            with open(crt_p, "rb") as f:
                cert_pem = f.read()
            with open(ca_p, "rb") as f:
                ca_pem = f.read()
            facts = cert_facts(crt_p)
        except OSError as e:
            if initial:
                raise IdentityError(f"identity load failed: {e}")
            identity_cert_reloads.labels("error").inc()
            return False
        with self._lock:
            epoch = 0 if self._creds is None else self._creds.epoch + 1
            self._creds = _Creds(
                key_pem=key_pem, cert_pem=cert_pem, ca_pem=ca_pem,
                not_after=facts["not_after"], names=facts["names"],
                common_name=facts["common_name"], stamp=stamp, epoch=epoch)
        if not initial:
            self._reloads += 1
            identity_cert_reloads.labels("ok").inc()
            if self.log is not None:
                self.log.info("identity certs reloaded", epoch=epoch,
                              names=list(facts["names"]))
        return True

    def maybe_reload(self, force: bool = False) -> bool:
        """Rate-limited cert-dir sweep; returns True when a new
        generation was swapped in."""
        now = self._now()
        if not force and now < self._next_sweep:
            return False
        self._next_sweep = now + self.reload_interval
        stamp = self._stamp()
        with self._lock:
            current = self._creds.stamp if self._creds is not None else None
        if stamp is None or stamp == current:
            self._refresh_state_metric()
            return False
        ok = self._load()
        self._refresh_state_metric()
        return ok

    # -- expiry state machine ------------------------------------------------

    def state(self) -> str:
        with self._lock:
            not_after = self._creds.not_after if self._creds else None
        if not_after is None:
            return STATE_FRESH
        now = self._now()
        if now <= not_after:
            return STATE_FRESH
        if now <= not_after + self.expiry_grace:
            return STATE_GRACE
        return STATE_EXPIRED

    def _refresh_state_metric(self) -> None:
        from ..metrics import identity_cert_state
        st = self.state()
        identity_cert_state.set(_STATE_GAUGE[st])
        if st != self._last_state:
            if st != STATE_FRESH and self.log is not None:
                self.log.warning("identity cert past notAfter",
                                 state=st, cert_dir=self.cert_dir)
            self._last_state = st

    # -- credentials -----------------------------------------------------------

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._creds.epoch if self._creds is not None else -1

    def names(self) -> Tuple[str, ...]:
        with self._lock:
            return self._creds.names if self._creds is not None else ()

    def server_credentials(self) -> grpc.ServerCredentials:
        """Dynamic server credentials with REQUIRED client auth.  gRPC
        calls the fetcher on every handshake; it sweeps the cert dir and
        republishes the config only when the generation changed."""
        with self._lock:
            creds = self._creds
        initial = grpc.ssl_server_certificate_configuration(
            ((creds.key_pem, creds.cert_pem),),
            root_certificates=creds.ca_pem)
        served_epoch = [creds.epoch]

        def fetch():
            self.maybe_reload()
            with self._lock:
                cur = self._creds
            if cur.epoch == served_epoch[0]:
                return None                     # keep the current config
            served_epoch[0] = cur.epoch
            return grpc.ssl_server_certificate_configuration(
                ((cur.key_pem, cur.cert_pem),),
                root_certificates=cur.ca_pem)

        return grpc.dynamic_ssl_server_credentials(
            initial, fetch, require_client_authentication=True)

    def channel_credentials(self) -> grpc.ChannelCredentials:
        """Client-side credentials (CA roots + this node's cert/key),
        cached per generation — dial pools key their channels on
        `epoch`, so a rotation rebuilds connections lazily."""
        with self._lock:
            creds = self._creds
            if creds.channel is None:
                creds.channel = grpc.ssl_channel_credentials(
                    root_certificates=creds.ca_pem,
                    private_key=creds.key_pem,
                    certificate_chain=creds.cert_pem)
            return creds.channel

    # -- observability ---------------------------------------------------------

    def status(self) -> dict:
        """/health identity block (also drives the reload sweep, so a
        probed daemon converges on rotated certs without traffic)."""
        self.maybe_reload()
        with self._lock:
            creds = self._creds
        return {
            "cert_dir": self.cert_dir,
            "state": self.state(),
            "not_after": creds.not_after if creds else None,
            "names": list(creds.names) if creds else [],
            "common_name": creds.common_name if creds else "",
            "epoch": creds.epoch if creds else -1,
            "reloads": self._reloads,
            "expiry_grace": self.expiry_grace,
        }
