"""Tenant authorization: macaroon-style bearer tokens for the read planes.

The TenantRegistry resolves the tenant from the *public* chain name,
so quota attribution is honest only against honest clients — anyone can
spend any tenant's read budget by naming the tenant's chain.  This module
makes attribution trustworthy: a tenant presents a bearer token whose
caveats (tenant id, chain allowlist, expiry, read-only) are chained with
HMAC-SHA256 in the macaroon construction:

    sig_0 = HMAC(root_key, token_id)
    sig_i = HMAC(sig_{i-1}, caveat_i)          # caveats are ordered
    token = "dt1." + token_id + "." + b64u(caveat_1) + ... + "." + hex(sig_n)

Verification recomputes the chain and compares with a constant-time
digest compare; tampering with any caveat (or reordering) breaks every
downstream signature.  Tokens are minted and revoked over the Control
plane; the root key and the token ledger persist beside the tenant
registry via `fs.write_atomic` (the key file 0600).

Hot-path discipline: `verify()` is called on the admission path before
any quota spend.  A verified token is cached by its raw string, so the
steady state is one dict hit plus an expiry/chain re-check — no HMAC, no
splitting, no allocation.  Revocation and re-mint bump a generation that
clears the cache.

The whole plane is opt-in: with no tokens minted, `active()` is False,
no files exist, and anonymous reads resolve exactly as before — an
untenanted daemon is byte-identical to the pre-identity build.

The port's copy of drand_tpu/core/authz.py, its code unchanged.
"""

import base64
import hmac
import hashlib
import json
import os
import secrets
import threading

from ..common import make_lock
from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional, Tuple

from ..fs import write_atomic

TOKEN_PREFIX = "dt1"
KEY_FILE = "tokens.key"
LEDGER_FILE = "tokens.json"

# acceptance leeway for clock skew between minting and verifying nodes:
# a token expiring within this window is still honored
DEFAULT_SKEW = float(os.environ.get("DRAND_TOKEN_SKEW", "30"))

_CACHE_MAX = 1024

# rejection reasons (metric label + trailer values; bounded set)
REASON_MALFORMED = "malformed"
REASON_BAD_SIGNATURE = "bad-signature"
REASON_UNKNOWN = "unknown"
REASON_EXPIRED = "expired"
REASON_REVOKED = "revoked"
REASON_WRONG_CHAIN = "wrong-chain"
REASON_READ_ONLY = "read-only"


class TokenVerdict(NamedTuple):
    ok: bool
    tenant: str
    reason: str                  # "" when ok; REASON_* otherwise
    read_only: bool = False
    chains: Tuple[str, ...] = ()
    expires: float = 0.0         # 0 = never
    token_id: str = ""


_REJECT = TokenVerdict(False, "", REASON_MALFORMED)


@dataclass
class TokenRecord:
    """Ledger row for one minted token.  Only metadata lives here — the
    token itself is derivable from the root key and is never persisted."""
    token_id: str
    tenant: str
    chains: Tuple[str, ...] = ()
    expires: float = 0.0
    read_only: bool = False
    revoked: bool = False

    def to_dict(self) -> dict:
        return {"token_id": self.token_id, "tenant": self.tenant,
                "chains": list(self.chains), "expires": self.expires,
                "read_only": self.read_only, "revoked": self.revoked}

    @classmethod
    def from_dict(cls, d: dict) -> "TokenRecord":
        return cls(token_id=str(d.get("token_id", "")),
                   tenant=str(d.get("tenant", "")),
                   chains=tuple(d.get("chains", ())),
                   expires=float(d.get("expires", 0.0)),
                   read_only=bool(d.get("read_only", False)),
                   revoked=bool(d.get("revoked", False)))


def _b64u(raw: bytes) -> str:
    return base64.urlsafe_b64encode(raw).rstrip(b"=").decode("ascii")


def _unb64u(part: str) -> bytes:
    pad = "=" * (-len(part) % 4)
    return base64.urlsafe_b64decode(part + pad)


def _caveats_for(record: TokenRecord) -> Tuple[str, ...]:
    """The ordered caveat list a token carries.  Order is part of the
    signature chain; every field is always present so two mints of the
    same record are byte-identical."""
    return (f"t={record.tenant}",
            f"c={','.join(record.chains)}",
            f"e={record.expires:.0f}" if record.expires else "e=0",
            f"ro={1 if record.read_only else 0}")


def _chain_sig(root_key: bytes, token_id: str, caveats) -> bytes:
    sig = hmac.new(root_key, token_id.encode(), hashlib.sha256).digest()
    for c in caveats:
        sig = hmac.new(sig, c.encode(), hashlib.sha256).digest()
    return sig


class TokenAuthority:
    """Mint / verify / revoke tenant tokens for one daemon.

    `folder` is the multibeacon dir (beside tenants.json).  Files are
    created lazily on the first mint; a daemon that never mints stays
    fileless and `active()` stays False."""

    def __init__(self, folder: str, clock=None, skew: float = DEFAULT_SKEW,
                 log=None):
        self.folder = folder
        self.clock = clock
        self.skew = skew
        self.log = log
        self._lock = make_lock()
        self._root_key: Optional[bytes] = None
        self._records: Dict[str, TokenRecord] = {}
        # lock-free fast-path flag (mirrors TenantRegistry.has_tenants):
        # the admission interceptor reads it per-RPC
        self._active = False
        self._cache: Dict[str, TokenVerdict] = {}
        self._load()

    # -- clock ----------------------------------------------------------------

    def _now(self) -> float:
        if self.clock is None:
            from ..beacon.clock import RealClock
            self.clock = RealClock()
        return self.clock.now()

    # -- persistence -----------------------------------------------------------

    def _key_path(self) -> str:
        return os.path.join(self.folder, KEY_FILE)

    def _ledger_path(self) -> str:
        return os.path.join(self.folder, LEDGER_FILE)

    def _load(self) -> None:
        with self._lock:
            try:
                with open(self._key_path(), "rb") as f:
                    raw = f.read().strip()
                self._root_key = bytes.fromhex(raw.decode("ascii"))
            except (OSError, ValueError):
                self._root_key = None
                return
            try:
                with open(self._ledger_path()) as f:
                    data = json.load(f)
                for d in data.get("tokens", []):
                    rec = TokenRecord.from_dict(d)
                    if rec.token_id:
                        self._records[rec.token_id] = rec
            except (OSError, ValueError):
                # a torn ledger fails CLOSED: tokens verify structurally
                # but their records are gone, so _recheck rejects them as
                # unknown — revocation must never be forgotten by a crash
                pass
            self._active = True

    def _save_locked(self) -> None:
        payload = {"version": 1,
                   "tokens": [r.to_dict()
                              for _, r in sorted(self._records.items())]}
        os.makedirs(self.folder, exist_ok=True)
        write_atomic(self._ledger_path(),
                     json.dumps(payload, indent=1).encode())

    def _ensure_key_locked(self) -> bytes:
        if self._root_key is None:
            os.makedirs(self.folder, exist_ok=True)
            key = secrets.token_bytes(32)
            write_atomic(self._key_path(), key.hex().encode(), secure=True)
            # tpu-vet: disable=lock  (caller holds self._lock, _locked suffix)
            self._root_key = key
            # tpu-vet: disable=lock  (caller holds self._lock, _locked suffix)
            self._active = True
        return self._root_key

    # -- surface ---------------------------------------------------------------

    def active(self) -> bool:
        """Lock-free: has a root key ever been created here?  False means
        the admission path skips token work entirely."""
        return self._active

    def mint(self, tenant: str, chains=(), ttl: float = 0.0,
             read_only: bool = False) -> Tuple[str, TokenRecord]:
        """Mint a token for `tenant`; `ttl` seconds from now (0 = no
        expiry), `chains` restricts to a beacon-id allowlist.  Returns
        (token string, ledger record)."""
        if not tenant:
            raise ValueError("token needs a tenant")
        expires = self._now() + ttl if ttl > 0 else 0.0
        record = TokenRecord(token_id=secrets.token_hex(8), tenant=tenant,
                             chains=tuple(chains), expires=expires,
                             read_only=read_only)
        caveats = _caveats_for(record)
        with self._lock:
            key = self._ensure_key_locked()
            sig = _chain_sig(key, record.token_id, caveats)
            self._records[record.token_id] = record
            self._save_locked()
        token = ".".join((TOKEN_PREFIX, record.token_id)
                         + tuple(_b64u(c.encode()) for c in caveats)
                         + (sig.hex(),))
        if self.log is not None:
            self.log.info("token minted", token_id=record.token_id,
                          tenant=tenant, read_only=read_only,
                          chains=list(record.chains))
        return token, record

    def revoke(self, token_id: str) -> bool:
        with self._lock:
            rec = self._records.get(token_id)
            if rec is None:
                return False
            rec.revoked = True
            self._save_locked()
            self._cache.clear()
        if self.log is not None:
            self.log.info("token revoked", token_id=token_id,
                          tenant=rec.tenant)
        return True

    def tokens(self):
        with self._lock:
            return [self._records[k] for k in sorted(self._records)]

    # -- verification ----------------------------------------------------------

    def verify(self, token: str, chain: Optional[str] = None) -> TokenVerdict:
        """Verify a presented token; `chain` (a beacon id) additionally
        enforces the chain-allowlist caveat.  Steady state is one cache
        hit + an expiry/revocation/chain recheck; the full HMAC chain
        runs only on first sight of a token string."""
        base = self._cache.get(token)
        if base is None:
            base = self._verify_slow(token)
            if not base.ok:
                # garbage strings are NOT cached (an unauthenticated
                # flood must not grow the cache)
                return base
            # the cached entry is the STRUCTURAL verdict (prefix + HMAC
            # chain + caveat parse); time/chain/revocation are re-derived
            # on every call below, so caching never freezes them
            with self._lock:
                if len(self._cache) >= _CACHE_MAX:
                    self._cache.clear()
                self._cache[token] = base
        return self._recheck(base, chain)

    def _recheck(self, base: TokenVerdict, chain: Optional[str]
                 ) -> TokenVerdict:
        rec = self._records.get(base.token_id)
        if rec is None:
            return TokenVerdict(False, base.tenant, REASON_UNKNOWN,
                                token_id=base.token_id)
        if rec.revoked:
            return TokenVerdict(False, base.tenant, REASON_REVOKED,
                                token_id=base.token_id)
        if base.expires and self._now() > base.expires + self.skew:
            return TokenVerdict(False, base.tenant, REASON_EXPIRED,
                                token_id=base.token_id)
        if chain is not None and base.chains and chain not in base.chains:
            return TokenVerdict(False, base.tenant, REASON_WRONG_CHAIN,
                                token_id=base.token_id)
        return base

    def _verify_slow(self, token: str) -> TokenVerdict:
        if not isinstance(token, str) or len(token) > 4096:
            return _REJECT
        parts = token.split(".")
        if len(parts) < 3 or parts[0] != TOKEN_PREFIX:
            return _REJECT
        token_id, sig_hex = parts[1], parts[-1]
        with self._lock:
            key = self._root_key
        if key is None:
            return TokenVerdict(False, "", REASON_UNKNOWN)
        try:
            presented = bytes.fromhex(sig_hex)
            caveats = [_unb64u(p).decode("utf-8") for p in parts[2:-1]]
        except (ValueError, UnicodeDecodeError):
            return _REJECT
        expected = _chain_sig(key, token_id, caveats)
        if not hmac.compare_digest(presented, expected):
            return TokenVerdict(False, "", REASON_BAD_SIGNATURE,
                                token_id=token_id)
        tenant, chains, expires, read_only = "", (), 0.0, False
        for c in caveats:
            k, _, v = c.partition("=")
            if k == "t":
                tenant = v
            elif k == "c":
                chains = tuple(x for x in v.split(",") if x)
            elif k == "e":
                try:
                    expires = float(v)
                except ValueError:
                    return _REJECT
            elif k == "ro":
                read_only = v == "1"
            else:
                # fail closed on caveats this build does not understand:
                # honoring an unknown restriction as a no-op would WIDEN
                # the token's authority
                return TokenVerdict(False, "", REASON_MALFORMED,
                                    token_id=token_id)
        if not tenant:
            return TokenVerdict(False, "", REASON_MALFORMED,
                                token_id=token_id)
        return TokenVerdict(True, tenant, "", read_only=read_only,
                            chains=chains, expires=expires,
                            token_id=token_id)


# -- transport helpers ---------------------------------------------------------

def bearer_token(authorization: Optional[str]) -> Optional[str]:
    """Extract the token from an Authorization value (REST header or
    gRPC `authorization` metadata).  Accepts `Bearer <tok>` or a bare
    token; returns None when absent/empty."""
    if not authorization:
        return None
    value = authorization.strip()
    if value.lower().startswith("bearer "):
        value = value[7:].strip()
    return value or None


def grpc_bearer(invocation_metadata) -> Optional[str]:
    """The bearer token carried in gRPC invocation metadata, if any."""
    if not invocation_metadata:
        return None
    for key, value in invocation_metadata:
        if key == "authorization":
            return bearer_token(value)
    return None
