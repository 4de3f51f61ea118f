"""The port's G2-signature schemes end to end: ``BatchBeaconVerifier`` of
``pedersen-bls-chained`` and ``pedersen-bls-unchained`` (drand_tpu_torch/
crypto/batch.py, plain versions on the CPU) vs the JAX package.

Tier-1: verdicts against the JAX package's host verifier
(``Scheme.verify_beacon`` per round) on good, corrupt, malformed,
infinity-flag, off-subgroup and wrong-prev slots and the chained genesis
slot (exact passes at pad 8); chained linkage through verify_chain on 12
rounds at pad 16 with one RLC pass, whose bit planes are injected so that
its two point sums can be held against the host's sum k_i S_i and
sum k_i H_i, k = b0 + x b1 + x^2 b2 + x^3 b3 (the psi split's lane
order); the wire parse (c1 then c0), the batch encoding and key state
against the JAX verifier's; the four-way device bit planes.  Marked slow +
heavy_compile: the fused verdict and subgroup mask bit for bit against the
JAX ``_rlc_run_g2sig`` fed the same planes, and the exact pass against
``_exact_run_g2sig`` (cold CPU compiles of minutes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drand_tpu.crypto import batch as JB
from drand_tpu.crypto import schemes as JS
from drand_tpu.crypto.host import field as JHF
from drand_tpu.crypto.host import params as JP
from drand_tpu.crypto.host.curve import G1 as JG1, G2 as JG2
from drand_tpu.crypto.host.serialize import g1_to_bytes, g2_to_bytes

from drand_tpu_torch import convert as CV
from drand_tpu_torch.crypto import batch as B
from drand_tpu_torch.crypto import schemes as S
from drand_tpu_torch.crypto.host import h2c as H2C
from drand_tpu_torch.ops import curve as DC
from drand_tpu_torch.ops import kernels as K

JCHAINED = JS.scheme_from_name("pedersen-bls-chained")
JUNCHAINED = JS.scheme_from_name("pedersen-bls-unchained")
CHAINED = S.scheme_from_name(S.DEFAULT_SCHEME_ID)
UNCHAINED = S.scheme_from_name(S.UNCHAINED_SCHEME_ID)
RNG = np.random.default_rng(20240619)

SK = int.from_bytes(RNG.bytes(32), "big") % (JP.R - 1) + 1
PK = JG1.mul(JG1.gen, SK)
PK_BYTES = g1_to_bytes(PK)
GENESIS = RNG.bytes(32)                   # the chained genesis slot's prev


def _flip(sig, i, mask):
    s = bytearray(sig)
    s[i] ^= mask
    return bytes(s)


def _off_subgroup_point():
    a = 1
    while True:
        x = (a, 2)
        y = JHF.fp2_sqrt(JHF.fp2_add(JHF.fp2_mul(JHF.fp2_sqr(x), x), (4, 4)))
        if y is not None and not JG2.in_subgroup((x, y)):
            return (x, y)
        a += 1


def _chain(rounds, prev):
    sigs, prevs = [], []
    for r in rounds:
        sig = JCHAINED.sign(SK, JCHAINED.digest_beacon(r, prev))
        sigs.append(sig)
        prevs.append(prev)
        prev = sig
    return sigs, prevs


CHAIN_ROUNDS = list(range(1, 13))         # round 1 is the genesis slot
CHAIN, CHAIN_PREVS = _chain(CHAIN_ROUNDS, GENESIS)
ROUNDS, GOOD, PREVS = CHAIN_ROUNDS[:8], CHAIN[:8], CHAIN_PREVS[:8]
SIGS = list(GOOD)
SIGS[2] = _flip(GOOD[2], 50, 0x55)                     # corrupt
SIGS[3] = GOOD[3][:95]                                 # malformed length
SIGS[4] = g2_to_bytes(None)                            # infinity flag
SIGS[5] = g2_to_bytes(_off_subgroup_point())           # on E2, not in G2
SIGS[6] = JCHAINED.sign(SK, JCHAINED.digest_beacon(7, GOOD[0]))  # wrong prev
EXPECTED = [True, True, False, False, False, False, False, True]

UROUNDS = list(range(20, 28))
UGOOD = [JUNCHAINED.sign(SK, JUNCHAINED.digest_beacon(r, None))
         for r in UROUNDS]
USIGS = list(UGOOD)
USIGS[1] = _flip(UGOOD[1], 95, 0x01)
USIGS[2] = _flip(UGOOD[2], 0, 0x80)                    # no compression flag
USIGS[4] = g2_to_bytes(_off_subgroup_point())
USIGS[7] = UGOOD[0]                                    # another round's sig
UEXPECTED = [True, False, False, True, False, True, True, False]


class Beacon:
    def __init__(self, round_, signature, previous_sig=None):
        self.round, self.signature = round_, signature
        self.previous_sig = previous_sig


def _host_verdicts(jscheme, rounds, sigs, prevs):
    return [jscheme.verify_beacon(PK, r, p, s)
            for r, s, p in zip(rounds, sigs, prevs)]


def verifier(scheme, **kw):
    return B.BatchBeaconVerifier(scheme, PK_BYTES, device="cpu", **kw)


def passes_of(fn):
    before = B.pass_counts()
    out = fn()
    after = B.pass_counts()
    return out, {k: after[k] - before[k] for k in after}


def test_chained_verdicts_match_host_at_pad_8():
    """A malformed slot skips the RLC: one exact pass over the 8 rounds."""
    K.reset_launches()
    got, passes = passes_of(lambda: verifier(CHAINED).verify_batch(
        ROUNDS, SIGS, PREVS))
    assert all(c == 0 for c in K.LAUNCHES.values())   # plain versions only
    assert passes == {"rlc": 0, "exact": 1}
    assert _host_verdicts(JCHAINED, ROUNDS, SIGS, PREVS) == EXPECTED
    assert got.tolist() == EXPECTED


def test_unchained_verdicts_match_host_at_pad_8():
    got, passes = passes_of(lambda: verifier(UNCHAINED).verify_batch(
        UROUNDS, USIGS, [None] * len(UROUNDS)))
    assert passes == {"rlc": 0, "exact": 1}
    assert _host_verdicts(JUNCHAINED, UROUNDS, USIGS,
                          [None] * len(UROUNDS)) == UEXPECTED
    assert got.tolist() == UEXPECTED


def test_verify_chain_linkage_and_split_sums_at_pad_16(monkeypatch):
    """12 chained rounds, pad 16.  Round 6 carries a signature that
    verifies over its own (wrong) previous_sig: its signature is good, its
    link to round 5 is broken, and so is round 7's link to it.  Every
    signature verifies, so one RLC pass and no exact pass; with the bit
    planes injected (pad lanes zero), the pass's two point sums are
    sum k_i S_i and sum k_i H_i."""
    n, pad = len(CHAIN_ROUNDS), 16
    beacons = [Beacon(r, s, p)
               for r, s, p in zip(CHAIN_ROUNDS, CHAIN, CHAIN_PREVS)]
    beacons[5] = Beacon(6, JCHAINED.sign(SK, JCHAINED.digest_beacon(
        6, CHAIN[0])), CHAIN[0])
    b = RNG.integers(0, 2, (4, 32, pad), dtype=np.uint32)
    b[:, :, n:] = 0
    monkeypatch.setattr(B, "_device_rlc_bits",
                        lambda keys, mask, split=2: CV.rlc_bits(b))
    sums = []
    real = K.sum_points
    monkeypatch.setattr(K, "sum_points", lambda p: sums.append(real(p))
                        or sums[-1])
    v = verifier(CHAINED)
    (all_ok, valid), passes = passes_of(lambda: v.verify_chain(beacons))
    assert passes == {"rlc": 1, "exact": 0}
    assert all_ok is False
    assert valid.tolist() == [True] * 5 + [False, False] + [True] * 5
    k = [sum(int("".join(str(int(c)) for c in b[j][:, i]), 2) * JP.X ** j
             for j in range(4)) % JP.R for i in range(n)]
    sig_pts = [JCHAINED.sig_group.from_bytes(bc.signature) for bc in beacons]
    msgs = v._messages([bc.round for bc in beacons],
                       [bc.previous_sig for bc in beacons])
    h_pts = [H2C.hash_to_curve_g2(m, CHAINED.dst) for m in msgs]
    one = lambda pt: DC._tmap(lambda t: t[None], pt)
    for got, pts in zip(sums, (sig_pts, h_pts)):
        want = None
        for pt, ki in zip(pts, k):
            want = JG2.add(want, JG2.mul(pt, ki))
        assert DC.decode_g2_points(one(got)) == [want]


def test_wire_parse_matches_jax():
    wire = SIGS + [
        _flip((JP.P).to_bytes(48, "big") + bytes(48), 0, 0x80),    # c1 = p
        _flip(bytes(48) + (JP.P).to_bytes(48, "big"), 0, 0x80),    # c0 = p
        _flip((JP.P - 1).to_bytes(48, "big") * 2, 0, 0xA0),
        b"\xff" * 96, b"",
    ]
    x, sign, bad = B._wire_parse(wire, True)
    jx, jsign, jbad = JB._wire_parse(wire, True)
    np.testing.assert_array_equal(bad, jbad)
    np.testing.assert_array_equal(x, jx.astype(np.int64))
    np.testing.assert_array_equal(sign, jsign.astype(np.int64))
    assert np.nonzero(bad)[0].tolist() == [3, 4, 8, 9, 11, 12]


def test_encoding_and_key_state_match_jax_verifier():
    jv = JB.BatchBeaconVerifier(JCHAINED, PK_BYTES)
    pv = verifier(CHAINED)
    msgs = [JCHAINED.digest_beacon(r, p) for r, p in zip(ROUNDS, PREVS)]
    assert msgs == pv._messages(ROUNDS, PREVS)
    assert pv._messages([1], [b""]) == [JCHAINED.digest_beacon(1, None)]
    jenc, jbad = jv._encode(SIGS, msgs, 8)
    penc, pbad = pv._encode(SIGS, msgs, 8)
    np.testing.assert_array_equal(pbad, jbad)
    for want, got in zip(jax.tree.leaves(CV.encoding(jenc)),
                         jax.tree.leaves(penc)):
        assert torch.equal(want, got)
    state = CV.verifier_state(jv)
    for name in ("pk_aff", "fixed_aff"):
        for want, got in zip(jax.tree.leaves(state[name]),
                             jax.tree.leaves(getattr(pv, name))):
            assert torch.equal(want, got)
    assert B.chunk_footprint_bytes(8, True) > B.chunk_footprint_bytes(8)
    assert pv.pipeline_depth(10 ** 9) == B.max_pipeline_depth(8192, True)


def test_device_bits_split_four_ways_zero_on_pad_lanes():
    mask = torch.arange(16) < 5
    keys = B._rlc_keys()
    planes = B._device_rlc_bits(keys, mask, split=4)
    assert len(planes) == 4
    for b in planes:
        assert b.shape == (32, 16) and b.dtype == torch.int32
        assert not b[:, 5:].any() and b[:, :5].any()
    assert torch.equal(torch.cat(planes), torch.cat(
        B._device_rlc_bits(keys, mask, split=2)))


@pytest.mark.slow
@pytest.mark.heavy_compile
def test_rlc_and_exact_passes_match_jax_with_same_planes(monkeypatch):
    """The JAX sampler is replaced by one that returns its `keys` operand
    (the four planes, stacked), so both engines take the same bits."""
    monkeypatch.setattr(JB, "_device_rlc_bits",
                        lambda keys, mask, split: tuple(keys))
    jv = JB.BatchBeaconVerifier(JCHAINED, PK_BYTES)
    state = CV.verifier_state(jv)
    msgs = [JCHAINED.digest_beacon(r, p) for r, p in zip(ROUNDS, PREVS)]
    run = jax.jit(JB._rlc_run_g2sig)
    for sigs, n, want in ((SIGS, 8, False), (GOOD, 8, True), (SIGS, 2, True)):
        planes = JB._rlc_scalars(n, 8, split=4)
        jenc, _ = jv._encode(sigs, msgs, 8)
        want_sub, want_ok = run(*jenc, jnp.stack(planes), jnp.uint32(n),
                                jv.pk_aff, jv.fixed_aff)
        got_sub, got_ok = B._rlc_run_g2sig(
            *CV.encoding(jenc), n, state["pk_aff"], state["fixed_aff"],
            bits=CV.rlc_bits(planes))
        np.testing.assert_array_equal(got_sub.numpy(), np.asarray(want_sub))
        assert bool(got_ok) is bool(want_ok) is want
    jenc, bad = jv._encode(SIGS, msgs, 8)
    want = np.asarray(jax.jit(JB._exact_run_g2sig)(*jenc, jv.pk_aff,
                                                   jv.fixed_aff))
    got = B._exact_run_g2sig(*CV.encoding(jenc), state["pk_aff"],
                             state["fixed_aff"]).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want & ~bad).tolist() == EXPECTED
