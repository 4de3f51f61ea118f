"""RLC bisection in the port's verify_batch (drand_tpu_torch/crypto/batch.py,
plain versions on the CPU) against the host verifier.

A 16-round batch holds the good, tampered, malformed, infinity,
off-subgroup and misplaced slots of tests/test_torch_batch.py in its first
half and one more misplaced signature in its second.  With _BISECT_MIN
lowered to 4, the batch bisects as the JAX verifier's _verify_range does:
ranges holding a malformed slot skip their RLC check, failing ranges of at
most 4 rounds go to the exact pass, and the verdicts equal the host's
``Scheme.verify`` at every slot.
"""

import pytest
import torch

from drand_tpu.crypto import batch as JB

from drand_tpu_torch import convert as CV
from drand_tpu_torch.crypto import batch as B

from test_torch_batch import (EXPECTED, GOOD, JSCHEME, PK, PK_BYTES, ROUNDS,
                              SCHEME, SIGS, SK, _host_verdicts)

ROUNDS16 = ROUNDS + list(range(109, 117))
SIGS16 = SIGS + [JSCHEME.sign(SK, JSCHEME.digest_beacon(r, None))
                 for r in ROUNDS16[8:]]
SIGS16[13] = SIGS16[12]                       # round 113 carries 112's sig
EXPECTED16 = EXPECTED + [True] * 5 + [False] + [True] * 2


@pytest.fixture(scope="module")
def bisected():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(B.BatchBeaconVerifier, "_BISECT_MIN", 4)
        v = B.BatchBeaconVerifier(SCHEME, PK_BYTES, device="cpu")
        before = B.pass_counts()
        got = v.verify_batch(ROUNDS16, SIGS16)
        after = B.pass_counts()
    return got, {k: after[k] - before[k] for k in after}


def test_bisection_verdicts_match_host_verify(bisected):
    got, _ = bisected
    host = _host_verdicts(PK, ROUNDS16[8:], SIGS16[8:])
    assert EXPECTED16 == EXPECTED + host
    assert got.tolist() == EXPECTED16


def test_bisection_pass_counts(bisected):
    """[0, 8) holds malformed slots: its halves skip the RLC and run the
    exact pass.  [8, 16) fails its RLC; [8, 12) passes one, [12, 16) fails
    one and runs the exact pass."""
    _, passes = bisected
    assert passes == {"rlc": 3, "exact": 3}


def test_slice_enc_matches_jax():
    """Sub-ranges padded back to a power of two with head slots."""
    jv = JB.BatchBeaconVerifier(JSCHEME, PK_BYTES)
    v = B.BatchBeaconVerifier(SCHEME, PK_BYTES, device="cpu")
    msgs = [JSCHEME.digest_beacon(r, None) for r in ROUNDS16]
    jenc, _ = jv._encode(SIGS16, msgs, 16)
    enc = CV.encoding(jenc)
    for lo, hi in ((0, 16), (8, 12), (3, 8), (12, 16), (0, 8)):
        for want, got in zip(CV.encoding(jv._slice_enc(jenc, lo, hi)),
                             v._slice_enc(enc, lo, hi)):
            assert torch.equal(want, got)
