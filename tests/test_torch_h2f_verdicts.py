"""The device hash front's verdicts equal the FIELDS front's (the host
hash_to_field), on valid and corrupted slots, at small pads.

``BatchBeaconVerifier.verify_batch`` with ``h2f_device`` pinned to each
front, for ``bls-unchained-on-g1`` (the raw unchained front) and
``pedersen-bls-chained`` with a 32-byte genesis seed as one previous
signature (the DIGEST front, host digests expanded by H1); the partials
are in tests/test_torch_h2f_partials.py.  On CPU tensors H1 runs its plain
version.  Each batch holds a malformed encoding, so the RLC pass is
skipped and one exact pass localizes every bad slot.  Every case is
checked against the verdicts known by construction, so the two fronts
agree slot for slot.
"""

import numpy as np
import pytest
import torch

from drand_tpu_torch.crypto import batch as B
from drand_tpu_torch.crypto import schemes
from drand_tpu_torch.crypto.host.params import R

RNG = np.random.default_rng(20241012)
FRONTS = {"device": True, "fields": False}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run as thousands of small int64 ops; under
    several test workers torch's intra-op threads only contend, so this
    module runs on one, restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _sk():
    return int.from_bytes(RNG.bytes(32), "big") % (R - 1) + 1


def _flip(sig):
    b = bytearray(sig)
    b[20] ^= 0x55
    return bytes(b)


def _passes(fn):
    before = B.pass_counts()
    out = fn()
    after = B.pass_counts()
    return out, {k: after[k] - before[k] for k in after}


# bls-unchained-on-g1: rounds 1-6; slot 1 a flipped byte, slot 3 a short
# encoding, slot 4 the signature of another round
G1 = schemes.scheme_from_name(schemes.SHORT_SIG_SCHEME_ID)
G1_SK = _sk()
G1_PK = G1.key_group.to_bytes(G1.key_group.curve.mul(G1.key_group.curve.gen,
                                                     G1_SK))
G1_ROUNDS = list(range(1, 7))
G1_SIGS = [G1.sign(G1_SK, G1.digest_beacon(r)) for r in G1_ROUNDS]
G1_SIGS[1] = _flip(G1_SIGS[1])
G1_SIGS[3] = G1_SIGS[3][:47]
G1_SIGS[4] = G1_SIGS[5]
G1_EXPECTED = [True, False, True, False, False, True]


@pytest.mark.parametrize("front", list(FRONTS))
def test_g1_unchained_verdicts_equal_on_both_fronts(front):
    v = B.BatchBeaconVerifier(G1, G1_PK, device="cpu",
                              h2f_device=FRONTS[front])
    assert v.pack_chunk(G1_ROUNDS, G1_SIGS)[3] == (
        B.FRONT_RAW_UNCHAINED if FRONTS[front] else B.FRONT_FIELDS)
    got, passes = _passes(lambda: v.verify_batch(G1_ROUNDS, G1_SIGS))
    assert got.tolist() == G1_EXPECTED
    assert passes == {"rlc": 0, "exact": 1}


# pedersen-bls-chained: rounds 1-5, round 1's previous signature a 32-byte
# genesis seed; slot 1 a short encoding, slot 3 a flipped byte
G2 = schemes.scheme_from_name(schemes.DEFAULT_SCHEME_ID)
G2_SK = _sk()
G2_PK = G2.key_group.to_bytes(G2.key_group.curve.mul(G2.key_group.curve.gen,
                                                     G2_SK))
G2_ROUNDS = list(range(1, 6))
G2_PREVS = [RNG.bytes(32)] + [RNG.bytes(96) for _ in G2_ROUNDS[1:]]
G2_SIGS = [G2.sign(G2_SK, G2.digest_beacon(r, p))
           for r, p in zip(G2_ROUNDS, G2_PREVS)]
G2_SIGS[1] = G2_SIGS[1][:95]
G2_SIGS[3] = _flip(G2_SIGS[3])
G2_EXPECTED = [True, False, True, False, True]


@pytest.mark.parametrize("front", list(FRONTS))
def test_g2_chained_genesis_verdicts_equal_on_both_fronts(front):
    v = B.BatchBeaconVerifier(G2, G2_PK, device="cpu",
                              h2f_device=FRONTS[front])
    assert v.pack_chunk(G2_ROUNDS, G2_SIGS, G2_PREVS)[3] == (
        B.FRONT_DIGEST if FRONTS[front] else B.FRONT_FIELDS)
    got, passes = _passes(lambda: v.verify_batch(G2_ROUNDS, G2_SIGS,
                                                 G2_PREVS))
    assert got.tolist() == G2_EXPECTED
    assert passes == {"rlc": 0, "exact": 1}
