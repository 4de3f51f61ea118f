"""The port's slice end to end: ``BatchBeaconVerifier.verify_batch`` of
``bls-unchained-on-g1`` (drand_tpu_torch/crypto/batch.py, plain versions on
the CPU) vs the JAX package.

Tier-1: the port's verdicts against the JAX package's host verifier
(``Scheme.verify`` per round) on good, tampered, malformed and
non-subgroup slots and on the League of Entropy mainnet vector; the port's
wire parse, batch encoding and key state against the JAX verifier's, moved
across with drand_tpu_torch.convert.  Marked slow + heavy_compile: the
verdicts bit for bit against the JAX exact pipeline
(``batch._exact_run_g1sig``) and the JAX ``verify_batch``, whose cold CPU
pairing compiles take minutes.
"""

import jax
import numpy as np
import pytest
import torch

from drand_tpu.crypto import batch as JB
from drand_tpu.crypto import schemes as JS
from drand_tpu.crypto.host import field as JHF
from drand_tpu.crypto.host import params as JP
from drand_tpu.crypto.host import _iso_g1 as JISO
from drand_tpu.crypto.host.curve import G1 as JG1, G2 as JG2
from drand_tpu.crypto.host.serialize import g1_to_bytes, g2_to_bytes
from drand_tpu.ops import pallas_field as PF

from drand_tpu_torch import convert as CV
from drand_tpu_torch.crypto import batch as B
from drand_tpu_torch.crypto import schemes as S
from drand_tpu_torch.crypto.host import _iso_g1 as ISO
from drand_tpu_torch.crypto.host import params as PP
from drand_tpu_torch.ops import kernels as K

JSCHEME = JS.scheme_from_name(JS.SHORT_SIG_SCHEME_ID)
SCHEME = S.scheme_from_name(S.SHORT_SIG_SCHEME_ID)
RNG = np.random.default_rng(20240607)

SK = int.from_bytes(RNG.bytes(32), "big") % (JP.R - 1) + 1
PK = JG2.mul(JG2.gen, SK)
PK_BYTES = g2_to_bytes(PK)

# League of Entropy mainnet, bls-unchained-on-g1, round 3
# (tests/test_host_crypto.py MAINNET_BEACONS)
LOE_PK = bytes.fromhex(
    "876f6fa8073736e22f6ff4badaab35c637503718f7a452d178ce69c45d2d8129"
    "a54ad2f988ab10c9666f87ab603c59bf013409a5b500555da31720f8eec294d9"
    "809b8796f40d5372c71a44ca61226f1eb978310392f98074a608747f77e66c5a")
LOE_SIG = bytes.fromhex(
    "ac7c3ca14bc88bd014260f22dc016b4fe586f9313c3a549c83d195811a99a5d2"
    "d4999d4df6daec73ff51fafadd6d5bb5")


def _off_subgroup_point():
    x = 1
    while True:
        y = JHF.fp_sqrt((x ** 3 + 4) % JP.P)
        if y is not None and not JG1.in_subgroup((x, y)):
            return (x, y)
        x += 1


def _flip(sig, i, mask):
    s = bytearray(sig)
    s[i] ^= mask
    return bytes(s)


ROUNDS = list(range(101, 109))                        # 8 rounds, pad 8
GOOD = [JSCHEME.sign(SK, JSCHEME.digest_beacon(r, None)) for r in ROUNDS]
SIGS = list(GOOD)
SIGS[1] = _flip(GOOD[1], 20, 0x55)                    # tampered
SIGS[2] = _flip(GOOD[2], 0, 0x80)                     # no compression flag
SIGS[3] = GOOD[3][:47]                                # short encoding
SIGS[4] = g1_to_bytes(None)                           # infinity
SIGS[5] = g1_to_bytes(_off_subgroup_point())          # on E1, not in G1
SIGS[6] = GOOD[7]                                     # another round's sig
EXPECTED = [True, False, False, False, False, False, False, True]

# wire-parse corner cases: x >= p, x = p - 1, both sign flags, garbage
WIRE = SIGS + [
    _flip((JP.P).to_bytes(48, "big"), 0, 0x80),
    _flip((JP.P - 1).to_bytes(48, "big"), 0, 0xA0),
    b"\xff" * 48, b"", b"\x80" + b"\x00" * 47,
]


def _host_verdicts(pk_point, rounds, sigs):
    return [JSCHEME.verify(pk_point, JSCHEME.digest_beacon(r, None), s)
            for r, s in zip(rounds, sigs)]


@pytest.fixture(scope="module")
def port_verdicts():
    v = B.BatchBeaconVerifier(SCHEME, PK_BYTES, device="cpu")
    K.reset_launches()
    got = v.verify_batch(ROUNDS, SIGS)
    assert all(c == 0 for c in K.LAUNCHES.values())   # plain versions only
    return got


def test_verify_batch_matches_host_verify(port_verdicts):
    assert port_verdicts.dtype == bool and port_verdicts.shape == (8,)
    host = _host_verdicts(PK, ROUNDS, SIGS)
    assert host == EXPECTED
    assert port_verdicts.tolist() == host


def test_loe_mainnet_vector_through_verify_chain():
    class Beacon:
        def __init__(self, round_, signature):
            self.round, self.signature = round_, signature

    v = B.BatchBeaconVerifier(SCHEME, LOE_PK, device="cpu")
    tampered = _flip(LOE_SIG, 47, 0x01)
    all_ok, valid = v.verify_chain([Beacon(3, LOE_SIG), Beacon(3, tampered)])
    want = [JSCHEME.verify_beacon(LOE_PK, 3, None, s)
            for s in (LOE_SIG, tampered)]
    assert want == [True, False]
    assert valid.tolist() == want and all_ok is False


def test_wire_parse_matches_jax():
    x, sign, bad = B._wire_parse(WIRE)
    jx, jsign, jbad = JB._wire_parse(WIRE, False)
    np.testing.assert_array_equal(bad, jbad)
    np.testing.assert_array_equal(x, jx.astype(np.int64))
    np.testing.assert_array_equal(sign, jsign.astype(np.int64))
    # slots 2-4 and x >= p, all-ones and empty fail on the wire; the
    # tampered, off-subgroup and misplaced signatures only on the device
    assert np.nonzero(bad)[0].tolist() == [2, 3, 4, 8, 10, 11]


def test_encoding_and_key_state_match_jax_verifier():
    """The JAX verifier's encoding and key state, moved across with
    convert.py, equal the port's own: the port then runs the same inputs."""
    jv = JB.BatchBeaconVerifier(JSCHEME, PK_BYTES)
    pv = B.BatchBeaconVerifier(SCHEME, PK_BYTES, device="cpu")
    msgs = [JSCHEME.digest_beacon(r, None) for r in ROUNDS]
    assert msgs == pv._messages(ROUNDS)
    jenc, jbad = jv._encode(SIGS, msgs, 16)
    penc, pbad = pv._encode(SIGS, msgs, 16)
    np.testing.assert_array_equal(pbad, jbad)
    for want, got in zip(CV.encoding(jenc), penc):
        assert torch.equal(want, got)
    state = CV.verifier_state(jv)
    for name in ("pk_aff", "fixed_aff"):
        for want, got in zip(jax.tree.leaves(state[name]),
                             jax.tree.leaves(getattr(pv, name))):
            assert torch.equal(want, got)
    assert CV.tree_to_numpy(pv.pk_aff)[0][0].dtype == np.uint32


def test_kernel_constant_bundle_matches_jax():
    got = CV.const_bundle(PF._const_entries())
    assert torch.equal(got, K.const_rows())


def test_host_copies_match_jax_package():
    for name in ("X", "P", "R", "H1", "H_EFF_G1", "B1", "B2", "G1_GEN",
                 "G2_GEN", "ISO_A1", "ISO_B1", "Z1", "DST_G1", "DST_G2"):
        assert getattr(PP, name) == getattr(JP, name), name
    PP.validate()
    for name in ("XNUM", "XDEN", "YNUM", "YDEN"):
        assert list(getattr(ISO, name)) == list(getattr(JISO, name)), name
    assert S.GroupG1.from_bytes(GOOD[0]) == JSCHEME.sig_group.from_bytes(
        GOOD[0])
    assert SCHEME.dst == JSCHEME.dst == JP.DST_G2      # the G2 DST quirk
    assert SCHEME.digest_beacon(7) == JSCHEME.digest_beacon(7, None)
    assert S.GroupG2.from_bytes(PK_BYTES) == PK
    assert SCHEME.sign(SK, JSCHEME.digest_beacon(101, None)) == GOOD[0]


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        B.BatchBeaconVerifier(SCHEME, PK_BYTES)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert B.resolve_device(None) == torch.device("cuda")
    assert B.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.slow
@pytest.mark.heavy_compile
def test_exact_pipeline_bit_exact_vs_jax(port_verdicts):
    jv = JB.BatchBeaconVerifier(JSCHEME, PK_BYTES)
    msgs = [JSCHEME.digest_beacon(r, None) for r in ROUNDS]
    jenc, bad = jv._encode(SIGS, msgs, 8)
    want = np.asarray(jax.jit(JB._exact_run_g1sig)(
        *jenc, jv.pk_aff, jv.fixed_aff))
    state = CV.verifier_state(jv)
    got = B._exact_run_g1sig(*CV.encoding(jenc), state["pk_aff"],
                             state["fixed_aff"]).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jv.verify_batch(ROUNDS, SIGS),
                                  port_verdicts)
    assert (want[:8] & ~bad).tolist() == EXPECTED
