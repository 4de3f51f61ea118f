"""League of Entropy mainnet vectors of the G2-signature schemes through
the port's verifier (drand_tpu_torch/crypto/batch.py, plain versions on
the CPU): chained rounds 2634945 and 3361396 with their previous
signatures, unchained round 7601003 (tests/test_host_crypto.py).  Each
genuine signature verifies and a tampered copy (compression flag cleared:
a wire-malformed slot, so one exact pass and no RLC pass) does not; the
port's digests and host signing equal the JAX package's.
"""

import pytest

from drand_tpu.crypto import schemes as JS

from drand_tpu_torch.crypto import batch as B
from drand_tpu_torch.crypto import schemes as S
from drand_tpu_torch.crypto.host import serialize as HS

from test_host_crypto import MAINNET_BEACONS

G2_VECTORS = [v for v in MAINNET_BEACONS if v[0] != S.SHORT_SIG_SCHEME_ID]


@pytest.mark.parametrize("scheme_id,round_,pk,sig,prev", G2_VECTORS,
                         ids=[f"{v[0]}-{v[1]}" for v in G2_VECTORS])
def test_mainnet_vector_and_tampered_copy(scheme_id, round_, pk, sig, prev):
    sch = S.scheme_from_name(scheme_id)
    pk, sig = bytes.fromhex(pk), bytes.fromhex(sig)
    prev = bytes.fromhex(prev) if prev else None
    tampered = bytes([sig[0] & 0x7F]) + sig[1:]
    v = B.BatchBeaconVerifier(sch, pk, device="cpu")
    before = B.pass_counts()
    got = v.verify_batch([round_, round_], [sig, tampered], [prev, prev])
    assert got.tolist() == [True, False]
    assert B.pass_counts()["exact"] - before["exact"] == 1
    jsch = JS.scheme_from_name(scheme_id)
    assert jsch.verify_beacon(pk, round_, prev, sig)
    assert sch.digest_beacon(round_, prev) == jsch.digest_beacon(round_, prev)


def test_schemes_match_jax_package():
    for sid in (S.DEFAULT_SCHEME_ID, S.UNCHAINED_SCHEME_ID,
                S.SHORT_SIG_SCHEME_ID):
        sch, jsch = S.scheme_from_name(sid), JS.scheme_from_name(sid)
        assert (sch.chained, sch.dst) == (jsch.chained, jsch.dst)
        assert sch.sig_group.point_len == jsch.sig_group.point_len
        for prev in (b"prev", None, b""):
            assert sch.digest_beacon(9, prev) == jsch.digest_beacon(9, prev)
    assert S.DEFAULT_SCHEME_ID == JS.DEFAULT_SCHEME_ID
    sch = S.scheme_from_name(S.DEFAULT_SCHEME_ID)
    msg = sch.digest_beacon(5, b"\x01" * 96)
    sig = sch.sign(12345, msg)
    assert sig == JS.scheme_from_name(S.DEFAULT_SCHEME_ID).sign(12345, msg)
    assert HS.g2_from_bytes(sig) is not None
