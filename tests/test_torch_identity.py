"""The port's tenant tokens (drand_tpu_torch/core/authz.py): the token
cases of tests/test_identity.py over the port — the caveat matrix (expiry
+ skew, chain allowlist, tampered HMAC chain, revocation through the
cache, unknown caveats fail closed, torn-ledger fail-closed), persistence,
the bearer helpers, and an untenanted authority staying inert.  The cert
and Handel cases come with the port's identity plane."""

import os

from drand_tpu_torch.beacon import FakeClock
from drand_tpu_torch.core.authz import (REASON_BAD_SIGNATURE,
                                        REASON_EXPIRED, REASON_MALFORMED,
                                        REASON_REVOKED, REASON_UNKNOWN,
                                        REASON_WRONG_CHAIN, TokenAuthority,
                                        _b64u, _chain_sig, bearer_token,
                                        grpc_bearer)


def mk_authority(tmp_path, clock=None, **kw):
    return TokenAuthority(str(tmp_path / "multibeacon"),
                          clock=clock or FakeClock(1000.0), **kw)


# ---------------------------------------------------------------------------
# token caveat matrix
# ---------------------------------------------------------------------------


def test_token_mint_verify_roundtrip(tmp_path):
    clock = FakeClock(1000.0)
    auth = mk_authority(tmp_path, clock)
    token, rec = auth.mint("acme", chains=("default", "c2"),
                           ttl=600.0, read_only=True)
    v = auth.verify(token)
    assert v.ok and v.tenant == "acme" and v.read_only
    assert v.chains == ("default", "c2")
    assert v.expires == 1600.0
    assert v.token_id == rec.token_id
    # chain allowlist: listed chains pass, others are wrong-chain
    assert auth.verify(token, chain="default").ok
    assert auth.verify(token, chain="c2").ok
    bad = auth.verify(token, chain="other")
    assert not bad.ok and bad.reason == REASON_WRONG_CHAIN
    # an unrestricted token (empty chains caveat) serves any chain
    tok2, _ = auth.mint("acme")
    assert auth.verify(tok2, chain="anything").ok


def test_token_expiry_honors_skew_boundary(tmp_path):
    clock = FakeClock(1000.0)
    auth = mk_authority(tmp_path, clock, skew=30.0)
    token, _ = auth.mint("acme", ttl=100.0)       # expires at 1100
    clock.set_time(1100.0 + 30.0)                 # exactly expiry + skew
    assert auth.verify(token).ok, "inside the skew window must pass"
    clock.advance(1.0)
    v = auth.verify(token)
    assert not v.ok and v.reason == REASON_EXPIRED
    # no-expiry tokens never age out
    forever, _ = auth.mint("acme")
    clock.advance(10 ** 9)
    assert auth.verify(forever).ok


def test_token_tampering_breaks_the_hmac_chain(tmp_path):
    auth = mk_authority(tmp_path)
    token, _ = auth.mint("acme", read_only=True)
    parts = token.split(".")
    # rewrite the ro=1 caveat to ro=0 without re-signing
    ro_idx = next(i for i, p in enumerate(parts[2:-1], start=2)
                  if p == _b64u(b"ro=1"))
    parts[ro_idx] = _b64u(b"ro=0")
    v = auth.verify(".".join(parts))
    assert not v.ok and v.reason == REASON_BAD_SIGNATURE
    # reordering caveats breaks it too (order is part of the chain)
    parts = token.split(".")
    parts[2], parts[3] = parts[3], parts[2]
    assert auth.verify(".".join(parts)).reason == REASON_BAD_SIGNATURE
    # and a flipped signature byte
    parts = token.split(".")
    parts[-1] = ("0" if parts[-1][0] != "0" else "1") + parts[-1][1:]
    assert auth.verify(".".join(parts)).reason == REASON_BAD_SIGNATURE


def test_token_malformed_inputs_rejected(tmp_path):
    auth = mk_authority(tmp_path)
    auth.mint("acme")          # ensure a root key exists
    for junk in ("", "garbage", "dt1.only-two", "dt2.x.y.z",
                 "dt1." + "x" * 5000, None, 42):
        v = auth.verify(junk)
        assert not v.ok and v.reason == REASON_MALFORMED


def test_token_unknown_caveat_fails_closed(tmp_path):
    """A correctly-SIGNED token carrying a caveat this build does not
    understand is rejected: honoring it as a no-op would widen the
    token's authority."""
    auth = mk_authority(tmp_path)
    auth.mint("acme")
    key = auth._root_key
    caveats = ("t=acme", "c=", "e=0", "ro=0", "x=later-feature")
    sig = _chain_sig(key, "cafe0123", caveats)
    token = ".".join(("dt1", "cafe0123")
                     + tuple(_b64u(c.encode()) for c in caveats)
                     + (sig.hex(),))
    v = auth.verify(token)
    assert not v.ok and v.reason == REASON_MALFORMED


def test_token_revocation_pierces_the_cache(tmp_path):
    auth = mk_authority(tmp_path)
    token, rec = auth.mint("acme")
    assert auth.verify(token).ok          # primes the structural cache
    assert auth.revoke(rec.token_id)
    v = auth.verify(token)
    assert not v.ok and v.reason == REASON_REVOKED
    assert not auth.revoke("no-such-id")
    # revocation survives a restart (ledger persisted atomically)
    auth2 = TokenAuthority(auth.folder, clock=FakeClock(1000.0))
    assert auth2.verify(token).reason == REASON_REVOKED


def test_token_torn_ledger_fails_closed(tmp_path):
    """Key survives but the ledger is torn/lost: tokens still verify
    structurally, but without a record they are UNKNOWN — a crash must
    never resurrect a revoked token."""
    auth = mk_authority(tmp_path)
    token, _ = auth.mint("acme")
    os.unlink(os.path.join(auth.folder, "tokens.json"))
    auth2 = TokenAuthority(auth.folder, clock=FakeClock(1000.0))
    v = auth2.verify(token)
    assert not v.ok and v.reason == REASON_UNKNOWN


def test_token_foreign_key_rejected(tmp_path):
    """A token minted under another daemon's root key fails the
    signature check here."""
    theirs = TokenAuthority(str(tmp_path / "theirs"), clock=FakeClock(0))
    ours = TokenAuthority(str(tmp_path / "ours"), clock=FakeClock(0))
    token, _ = theirs.mint("acme")
    ours.mint("other")          # give ours a (different) root key
    assert ours.verify(token).reason == REASON_BAD_SIGNATURE


def test_token_persistence_across_restart(tmp_path):
    auth = mk_authority(tmp_path)
    token, rec = auth.mint("acme", chains=("default",), ttl=500.0)
    auth2 = TokenAuthority(auth.folder, clock=FakeClock(1000.0))
    assert auth2.active()
    v = auth2.verify(token, chain="default")
    assert v.ok and v.tenant == "acme"
    assert [r.token_id for r in auth2.tokens()] == \
        [r.token_id for r in auth.tokens()]
    key_mode = os.stat(os.path.join(auth.folder, "tokens.key")).st_mode
    assert key_mode & 0o077 == 0, "root key must not be group/world readable"


def test_bearer_extraction_helpers():
    assert bearer_token(None) is None
    assert bearer_token("") is None
    assert bearer_token("Bearer abc.def") == "abc.def"
    assert bearer_token("bearer abc") == "abc"
    assert bearer_token("abc") == "abc"
    assert grpc_bearer(None) is None
    assert grpc_bearer([("x-other", "1")]) is None
    assert grpc_bearer([("authorization", "Bearer tok")]) == "tok"


# ---------------------------------------------------------------------------
# anonymous-read byte-identity: no tokens ever minted => the authz plane
# is inert — no files, no active() flag, no state growth on probes
# ---------------------------------------------------------------------------


def test_untenanted_authority_stays_inert(tmp_path):
    folder = tmp_path / "multibeacon"
    auth = TokenAuthority(str(folder), clock=FakeClock(0))
    assert not auth.active()
    # probing with garbage (or even well-formed foreign tokens) creates
    # no files and flips no state
    assert not auth.verify("dt1.aa.dD0x.deadbeef").ok
    assert not auth.verify("garbage").ok
    assert not auth.active()
    assert not folder.exists(), "verification must never create files"
    assert auth.tokens() == []
