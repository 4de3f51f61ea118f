"""The port's batched signing and tBLS recovery (drand_tpu_torch/crypto/
batch.py sign_batch, recover_batch; ops/curve.py scalars_to_bits and the
signed-digit GLV decompositions) vs the JAX package and its host golden
code.

Both run on CPU tensors (device="cpu"): every kernel wrapper, K6 included,
runs its plain version.  Signatures and recovered signatures must equal the
host's byte for byte (BLS is deterministic); the GLV digits must equal the
JAX package's arrays exactly.  The slow + heavy_compile cases hold the port
against the JAX sign_batch and recover_batch pipelines themselves (cold
CPU compiles of minutes).
"""

import numpy as np
import pytest
import torch

from drand_tpu.crypto import batch as JB
from drand_tpu.crypto import schemes as JS
from drand_tpu.crypto import tbls as JT
from drand_tpu.crypto.host import serialize as JHS
from drand_tpu.crypto.host.params import R
from drand_tpu.ops import curve as JC

from drand_tpu_torch import convert as CV
from drand_tpu_torch.crypto import batch as B
from drand_tpu_torch.crypto import schemes
from drand_tpu_torch.crypto.host import tbls as HT
from drand_tpu_torch.ops import curve as DC
from drand_tpu_torch.ops import kernels as K

RNG = np.random.default_rng(20240622)
G1_ID, CHAINED_ID, UNCHAINED_ID = ("bls-unchained-on-g1",
                                   "pedersen-bls-chained",
                                   "pedersen-bls-unchained")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run as thousands of small int64 ops.  Under
    several test workers on one machine, torch's intra-op threads only
    contend with each other, so this module runs on one, restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def rand_scalar():
    return int.from_bytes(RNG.bytes(32), "big") % R


# ---------------------------------------------------------------------------
# Host scalar encodings
# ---------------------------------------------------------------------------

def test_scalars_to_bits_matches_jax():
    ks = [0, 1, R - 1, R, R + 5] + [rand_scalar() for _ in range(4)]
    for nbits in (256, 64):
        np.testing.assert_array_equal(
            DC.scalars_to_bits(ks, nbits),
            np.asarray(JC.scalars_to_bits(ks, nbits)))


@pytest.mark.parametrize("group", ["G1", "G2"])
def test_glv_decompose_matches_jax(group):
    ks = [0, 1, 2, R - 1, R - 2] + [rand_scalar() for _ in range(27)]
    port = DC.glv_decompose_g1 if group == "G1" else DC.glv_decompose_g2
    jax_ = JC.glv_decompose_g1 if group == "G1" else JC.glv_decompose_g2
    bits, neg = port(ks)
    jbits, jneg = jax_(ks)
    assert bits.shape == jbits.shape and neg.shape == jneg.shape
    np.testing.assert_array_equal(bits, np.asarray(jbits))
    np.testing.assert_array_equal(neg, np.asarray(jneg))


def test_lagrange_and_shares_match_jax_host():
    """The port's host tbls: shares, public shares and Lagrange
    coefficients equal the JAX package's."""
    coeffs = [rand_scalar() for _ in range(3)]
    poly, jpoly = HT.PriPoly(list(coeffs)), JT.PriPoly(list(coeffs))
    assert poly.shares(5) == [HT.PriShare(s.index, s.value)
                              for s in jpoly.shares(5)]
    sch, jsch = schemes.scheme_from_name(G1_ID), JS.scheme_from_name(G1_ID)
    pp, jpp = poly.commit(sch.key_group), jpoly.commit(jsch.key_group)
    assert [pp.eval(i) for i in range(5)] == [jpp.eval(i) for i in range(5)]
    for idx in ([0, 2, 4], [4, 1], [3]):
        for i in idx:
            assert HT._lagrange_coeff(idx, i) == JT._lagrange_coeff(idx, i)
    msg = b"\x01" * 32
    assert HT.sign_partial(sch, poly.eval(3), msg) == \
        JT.sign_partial(jsch, jpoly.eval(3), msg)
    assert HT.index_of(b"\x01\x02rest") == 258


# ---------------------------------------------------------------------------
# sign_batch
# ---------------------------------------------------------------------------

def test_entry_points_need_a_gpu_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    sch = schemes.scheme_from_name(G1_ID)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        B.sign_batch(sch, 5, [b"m"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        B.recover_batch(sch, [[0]], [[b"\x00" * 48]])


def test_sign_batch_g1_matches_host():
    sch, jsch = schemes.scheme_from_name(G1_ID), JS.scheme_from_name(G1_ID)
    sk = rand_scalar()
    msgs = [sch.digest_beacon(r) for r in (1, 2, 77)]
    K.reset_launches()
    got = B.sign_batch(sch, sk, msgs, device="cpu")
    assert all(c == 0 for c in K.LAUNCHES.values())
    assert got == [jsch.sign(sk, m) for m in msgs]
    assert B.sign_batch(sch, sk, [], device="cpu") == []


def test_sign_batch_g2_matches_host():
    """One G2 call (one 256-bit ladder) signs chained and unchained
    digests: sign_batch depends on the scheme only through its group and
    DST, which the two G2 schemes share."""
    ch, jch = (schemes.scheme_from_name(CHAINED_ID),
               JS.scheme_from_name(CHAINED_ID))
    jun = JS.scheme_from_name(UNCHAINED_ID)
    sk = rand_scalar()
    prev = RNG.bytes(96)
    msgs = [ch.digest_beacon(5, prev), ch.digest_beacon(6, None),
            jun.digest_beacon(5, None), jun.digest_beacon(900, None)]
    got = B.sign_batch(ch, sk, msgs, device="cpu")
    assert got[:2] == [jch.sign(sk, m) for m in msgs[:2]]
    assert got[2:] == [jun.sign(sk, m) for m in msgs[2:]]


# ---------------------------------------------------------------------------
# recover_batch
# ---------------------------------------------------------------------------

def threshold_grid(scheme_id, t=3, n=5):
    """A random (t, n) group, two rounds signed by different subsets of t
    signers (host golden signing).  Returns (port scheme, JAX scheme, JAX
    polynomial, msgs, indices, partial signatures without index)."""
    sch, jsch = (schemes.scheme_from_name(scheme_id),
                 JS.scheme_from_name(scheme_id))
    jpoly = JT.PriPoly([rand_scalar() for _ in range(t)])
    shares = jpoly.shares(n)
    msgs = [sch.digest_beacon(r) for r in (11, 12)]
    indices = [[(3 * r + 2 * j) % n for j in range(t)] for r in (0, 1)]
    parts = [[jsch.sign(shares[i].value, m) for i in row]
             for row, m in zip(indices, msgs)]
    return sch, jsch, jpoly, msgs, indices, parts


@pytest.mark.parametrize("scheme_id", [G1_ID, CHAINED_ID])
def test_recover_batch_matches_host(scheme_id):
    sch, jsch, jpoly, msgs, indices, parts = threshold_grid(scheme_id)
    K.reset_launches()
    got = B.recover_batch(sch, indices, parts, device="cpu")
    assert all(c == 0 for c in K.LAUNCHES.values())
    jpp = jpoly.commit(jsch.key_group)
    t, n = len(indices[0]), 5
    for r, (row, m) in enumerate(zip(indices, msgs)):
        wire = [i.to_bytes(2, "big") + p for i, p in zip(row, parts[r])]
        want = JT.recover(jsch, jpp, m, wire, t, n, verify_each=False)
        assert got[r] == want == jsch.sign(jpoly.secret(), m)


def test_recover_run_takes_jax_digits():
    """The device run of recovery fed the JAX package's GLV digits
    (carried across by convert.glv_digits) gives the recovered
    signatures."""
    sch, jsch, jpoly, msgs, indices, parts = threshold_grid(G1_ID)
    t, nr = len(indices[0]), len(indices)
    lams = [JT._lagrange_coeff(indices[r], indices[r][j])
            for j in range(t) for r in range(nr)]
    bits, neg = CV.glv_digits(*JC.glv_decompose_g1(lams))
    xw, sgn, bad = B._parse_grid(parts, t, nr, False)
    assert not bad.any()
    x, y, ok = B._recover_run(False, torch.from_numpy(xw),
                              torch.from_numpy(sgn),
                              bits.reshape(bits.shape[0], -1, nr),
                              neg.reshape(-1, nr))
    assert bool(ok)
    assert B._to_wire(False, x, y) == [jsch.sign(jpoly.secret(), m)
                                       for m in msgs]


def test_recover_batch_rejects_bad_encodings():
    """A wrong length raises before any device work; an x with no y on
    the curve raises from the device's decompression (test_batch.py's
    case)."""
    sch, _, _, _, indices, parts = threshold_grid(G1_ID, t=2, n=3)
    row, good = indices[:1], parts[0]
    with pytest.raises(ValueError):
        B.recover_batch(sch, row, [[good[0], good[1][:-1]]], device="cpu")
    for tweak in range(1, 64):
        cand = bytearray(good[1])
        cand[-1] ^= tweak
        try:
            JHS.g1_from_bytes(bytes(cand), check_subgroup=False)
        except (ValueError, AssertionError):
            break
    else:
        pytest.fail("no non-decompressable tweak found in 64 tries")
    with pytest.raises(ValueError):
        B.recover_batch(sch, row, [[good[0], bytes(cand)]], device="cpu")


# ---------------------------------------------------------------------------
# Side by side with the JAX pipelines (cold CPU compiles: slow)
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.heavy_compile
@pytest.mark.parametrize("scheme_id", [G1_ID, UNCHAINED_ID])
def test_sign_batch_matches_jax_sign_batch(scheme_id):
    sch, jsch = (schemes.scheme_from_name(scheme_id),
                 JS.scheme_from_name(scheme_id))
    sk = rand_scalar()
    msgs = [sch.digest_beacon(r) for r in range(40, 45)]
    assert B.sign_batch(sch, sk, msgs, device="cpu") == \
        JB.sign_batch(jsch, sk, msgs)


@pytest.mark.slow
@pytest.mark.heavy_compile
@pytest.mark.parametrize("scheme_id", [G1_ID, UNCHAINED_ID])
def test_recover_batch_matches_jax_recover_batch(scheme_id):
    sch, jsch, _, _, indices, parts = threshold_grid(scheme_id)
    assert B.recover_batch(sch, indices, parts, device="cpu") == \
        JB.recover_batch(jsch, indices, parts)
