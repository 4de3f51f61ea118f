"""The port's device hash front (drand_tpu_torch/ops/sha256.py, ops/h2c.py
``*_dev``, limbs.be_words_to_mont, crypto/batch.py's fronts) vs hashlib,
the RFC 9380 K.1 vectors, the host oracle and the JAX package.

On CPU tensors every H1 wrapper runs its plain version; the same numpy
words go through the JAX package's ``drand_tpu.ops.h2c`` device stages and
the port's, and the canonical integers (and limbs) must be equal.  The
host-C++ build of H1 (csrc/h2f.cu) is held against the same plain versions
in tests/test_torch_kernels_host.py; the fronts' verdicts against the
FIELDS front's in tests/test_torch_h2f_verdicts.py.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drand_tpu.crypto import batch as JB
from drand_tpu.crypto.host.params import DST_G1, DST_G2
from drand_tpu.ops import h2c as JH
from drand_tpu.ops import limbs as JL
from drand_tpu.ops import sha256 as JSHA

from drand_tpu_torch.crypto import batch as B
from drand_tpu_torch.crypto import partials as PP
from drand_tpu_torch.crypto import schemes
from drand_tpu_torch.crypto.host import h2c as HH
from drand_tpu_torch.crypto.host import tbls as HT
from drand_tpu_torch.ops import h2c as DH
from drand_tpu_torch.ops import kernels as K
from drand_tpu_torch.ops import limbs as L
from drand_tpu_torch.ops import sha256 as SHA
from drand_tpu_torch.crypto.host.params import P

RNG = np.random.default_rng(20241011)

# RFC 9380 Appendix K.1: expand_message_xmd(SHA-256), DST
# "QUUX-V01-CS02-with-expander-SHA256-128", the published vectors as hex
_XMD_DST = b"QUUX-V01-CS02-with-expander-SHA256-128"
_XMD_KATS = [
    (b"", 0x20,
     "68a985b87eb6b46952128911f2a4412bbc302a9d759667f87f7a21d803f07235"),
    (b"abc", 0x20,
     "d8ccab23b5985ccea865c6c97b6e5b8350e794e603b4b97902f53a8a0d605615"),
    (b"abcdef0123456789", 0x20,
     "eff31487c770a893cfb36f912fbfcbff40d5661771ca4b2cb4eafe524333f5c1"),
    (b"", 0x80,
     "af84c27ccfd45d41914fdff5df25293e221afc53d8ad2ac06d5e3e29485dadbe"
     "e0d121587713a3e0dd4d5e69e93eb7cd4f5df4cd103e188cf60cb02edc3edf18"
     "eda8576c412b18ffb658e3dd6ec849469b979d444cf7b26911a08e63cf31f9dc"
     "c541708d3491184472c2c29bb749d4286b004ceb5ee6b9a7fa5b646c993f0ced"),
    (b"abc", 0x80,
     "abba86a6129e366fc877aab32fc4ffc70120d8996c88aee2fe4b32d6c7b6437a"
     "647e6c3163d40b76a73cf6a5674ef1d890f95b664ee0afa5359a5c4e07985635"
     "bbecbac65d747d3d2da7ec2b8221b17b0ca9dc8a1ac1c07ea6a1e60583e2cb00"
     "058e77b7b72a298425cd1b941ad4ec65e8afc50303a22c0f99b0509b4c895f40"),
]


def _words(msgs, n=None):
    return torch.from_numpy(SHA.pack_msgs_to_words(msgs, n))


def _dev_expand(msg: bytes, dst: bytes, n: int) -> bytes:
    out = DH.expand_msg_xmd_dev(_words([msg, msg], len(msg)), len(msg), dst,
                                (n + 3) // 4 * 4).numpy()
    rows = [out[i].astype(">u4").tobytes()[:n] for i in range(2)]
    assert rows[0] == rows[1]           # lanes are independent
    return rows[0]


@pytest.mark.parametrize("msg,n,want", _XMD_KATS,
                         ids=[f"{len(m)}B-{n}" for m, n, _ in _XMD_KATS])
def test_expand_message_xmd_kats_host_and_device(msg, n, want):
    assert HH.expand_message_xmd(msg, _XMD_DST, n).hex() == want
    assert _dev_expand(msg, _XMD_DST, n).hex() == want


@pytest.mark.parametrize("msg", [b"q128_" + b"q" * 123, b"a512_" + b"a" * 507,
                                 b"x" * 17, b"y" * 31, b"", b"abc"],
                         ids=["q128", "a512", "17B", "31B", "empty", "abc"])
def test_expand_device_matches_host_long_and_odd_messages(msg):
    """Beyond the pinned vectors: device == host for long and
    non-word-aligned messages (the partial-word merge)."""
    for n in (0x20, 0x80):
        assert _dev_expand(msg, _XMD_DST, n) == \
            HH.expand_message_xmd(msg, _XMD_DST, n)


@pytest.mark.parametrize("size", [0, 3, 8, 17, 31, 32, 56, 64, 104, 200])
def test_sha256_matches_hashlib_all_beacon_shapes(size):
    """Unchained 8-byte, chained 56- and 104-byte (G1 / G2 prev widths),
    the 32-byte digest, and odd lengths through the merge."""
    msgs = [RNG.bytes(size) for _ in range(3)]
    got = SHA.digest_bytes(SHA.sha256_words(_words(msgs, size), size))
    assert got == [hashlib.sha256(m).digest() for m in msgs]
    # the dispatching wrapper takes the plain version on a CPU tensor
    assert SHA.digest_bytes(K.sha256_words(_words(msgs, size), size)) == got


def test_host_midstate_and_compression_match_hashlib():
    """_compress_host / _midstate (the host side of the frames) against
    hashlib over whole blocks."""
    data = RNG.bytes(128)
    st = SHA._midstate(data)
    tail = SHA._suffix_bytes(128, b"")
    state = SHA._compress_host(tuple(int(x) for x in st), tail)
    assert b"".join(x.to_bytes(4, "big") for x in state) == \
        hashlib.sha256(data).digest()


_DIGESTS = [hashlib.sha256(bytes([i])).digest() for i in range(5)]


@pytest.mark.parametrize("dst", [DST_G1, DST_G2], ids=["dst_g1", "dst_g2"])
@pytest.mark.parametrize("fp2", [False, True], ids=["fp", "fp2"])
def test_hash_to_field_matches_jax_and_host(dst, fp2):
    """hash_to_field_fp_dev / _fp2_dev against the JAX package's on the
    same numpy words, limb for limb, and the host oracle as integers."""
    words = SHA.pack_msgs_to_words(_DIGESTS, 32)
    jw = jnp.asarray(words.astype(np.uint32))
    if fp2:
        (a0, a1), (b0, b1) = DH.hash_to_field_fp2_dev(
            torch.from_numpy(words), 32, dst)
        got = [a0, a1, b0, b1]
        (c0, c1), (d0, d1) = JH.hash_to_field_fp2_dev(jw, 32, dst)
        want = [c0, c1, d0, d1]
        host = [[c for u in HH.hash_to_field_fp2(m, dst, 2) for c in u]
                for m in _DIGESTS]
    else:
        got = list(DH.hash_to_field_fp_dev(torch.from_numpy(words), 32, dst))
        want = list(JH.hash_to_field_fp_dev(jw, 32, dst))
        host = [HH.hash_to_field_fp(m, dst, 2) for m in _DIGESTS]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(w).astype(np.int64))
    ints = [L.decode_mont(g) for g in got]
    assert [list(col) for col in zip(*ints)] == host
    assert [JL.decode_mont(w) for w in want] == ints


def test_be_words_to_mont_matches_jax_and_int():
    """OS2IP chunks at the edges (0, p - 1, p, p + 1, 2^384 - 1 as the low
    half, every word 0xffffffff) and random ones: the low half may be >= p,
    the output is canonical Montgomery, bit for bit the JAX package's."""
    vals = [0, P - 1, P, P + 1, (1 << 384) - 1, (1 << 512) - 1,
            (1 << 511) + P]
    vals += [int.from_bytes(RNG.bytes(64), "big") for _ in range(9)]
    words = np.array([[(v >> (32 * (15 - i))) & 0xFFFFFFFF for i in range(16)]
                      for v in vals], np.int64)
    got = L.be_words_to_mont(torch.from_numpy(words))
    want = JL.be_words_to_mont(jnp.asarray(words.astype(np.uint32)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))
    assert L.decode_mont(got) == [v % P for v in vals]
    assert (got.numpy() < (1 << 16)).all() and \
        all(x < P for x in L.limbs_to_ints(got.numpy()))


def test_beacon_digests_parity_and_genesis_slot():
    """beacon_digests_dev == Scheme.digest_beacon and the JAX package's,
    chained (the genesis slot with no previous signature included) and
    unchained."""
    sch = schemes.scheme_from_name(schemes.DEFAULT_SCHEME_ID)
    schu = schemes.scheme_from_name(schemes.UNCHAINED_SCHEME_ID)
    prevs = [b"\x11" * 96, None, RNG.bytes(96), b""]
    rounds = [1, 2, 2 ** 40 + 7, 4]
    rw = SHA.pack_msgs_to_words([r.to_bytes(8, "big") for r in rounds])
    pw = SHA.pack_msgs_to_words([p if p else b"\x00" * 96 for p in prevs])
    hp = np.array([1, 0, 1, 0], np.int64)
    msg = tuple(torch.from_numpy(a) for a in (pw, rw, hp))
    got = SHA.digest_bytes(DH.beacon_digests_dev(msg))
    assert got == [sch.digest_beacon(r, p) for r, p in zip(rounds, prevs)]
    jmsg = tuple(jnp.asarray(a.astype(np.uint32)) for a in (pw, rw, hp))
    assert got == JSHA.digest_bytes(JH.beacon_digests_dev(jmsg))
    got_u = SHA.digest_bytes(DH.beacon_digests_dev((torch.from_numpy(rw),)))
    assert got_u == [schu.digest_beacon(r, None) for r in rounds]


@pytest.mark.parametrize("front", ["raw_unchained", "raw_chained", "digest"])
@pytest.mark.parametrize("fp2", [False, True], ids=["fp", "fp2"])
def test_hash_to_field_front_matches_host_oracle(front, fp2):
    """The front H1 runs on the card (digest + xmd + hash_to_field), plain
    here, against the host digest and hash_to_field, genesis slots and
    zero pad lanes included."""
    sch = schemes.scheme_from_name(schemes.DEFAULT_SCHEME_ID)
    rounds = [3, 1, 2 ** 33 + 5, 0]
    prevs = [RNG.bytes(96), None, RNG.bytes(96), None]
    rw = torch.from_numpy(SHA.pack_msgs_to_words(
        [r.to_bytes(8, "big") for r in rounds]))
    if front == "raw_unchained":
        msg, msgs = (rw,), [sch.digest_beacon(r, None) for r in rounds]
    else:
        msgs = [sch.digest_beacon(r, p) for r, p in zip(rounds, prevs)]
        if front == "digest":
            msg = (_words(msgs, 32),)
        else:
            pw = _words([p or b"\x00" * 96 for p in prevs])
            msg = (pw, rw, torch.tensor([int(bool(p)) for p in prevs]))
    dst = DST_G2 if fp2 else DST_G1
    u0, u1 = DH.hash_to_field_front(front, msg, dst, fp2)
    if fp2:
        got = [list(zip(L.decode_mont(u[0]), L.decode_mont(u[1])))
               for u in (u0, u1)]
        want = [HH.hash_to_field_fp2(m, dst, 2) for m in msgs]
    else:
        got = [L.decode_mont(u0), L.decode_mont(u1)]
        want = [HH.hash_to_field_fp(m, dst, 2) for m in msgs]
    assert [list(col) for col in zip(*got)] == [list(w) for w in want]


# -- front selection ---------------------------------------------------------

def _verifier(scheme_id, h2f_device=None, sk=987654321):
    sch = schemes.scheme_from_name(scheme_id)
    pub = sch.key_group.curve.mul(sch.key_group.curve.gen, sk)
    return sch, B.BatchBeaconVerifier(sch, sch.key_group.to_bytes(pub),
                                      device="cpu", h2f_device=h2f_device)


def test_h2f_device_default_threshold(monkeypatch):
    monkeypatch.setenv("DRAND_H2F_DEVICE_MIN_N", "64")
    monkeypatch.delenv("DRAND_H2F_DEVICE", raising=False)
    assert B.h2f_device_min_n() == 64
    assert not B.h2f_device_default(8)
    assert not B.h2f_device_default(63)
    assert B.h2f_device_default(64)
    assert B.h2f_device_default(8192)
    monkeypatch.setenv("DRAND_H2F_DEVICE", "0")
    assert not B.h2f_device_default(8192)
    monkeypatch.setenv("DRAND_H2F_DEVICE", "1")
    assert B.h2f_device_default(8)
    monkeypatch.setenv("DRAND_H2F_DEVICE", "auto")
    monkeypatch.setenv("DRAND_H2F_DEVICE_MIN_N", "16")
    assert B.h2f_device_default(16) and not B.h2f_device_default(8)
    monkeypatch.delenv("DRAND_H2F_DEVICE_MIN_N")
    assert B.h2f_device_min_n() == 64


def test_pack_fronts_resolve_per_shape():
    """raw fronts for uniform chunks, the digest front for an irregular
    chained chunk (a seed-width previous_sig), fields when pinned off."""
    _, ver = _verifier(schemes.SHORT_SIG_SCHEME_ID, h2f_device=True)
    assert ver.pack_chunk([1, 2], [b"\x00" * 48] * 2)[3] == \
        B.FRONT_RAW_UNCHAINED
    _, verc = _verifier(schemes.DEFAULT_SCHEME_ID, h2f_device=True)
    assert verc.pack_chunk([2, 3], [b"\x00" * 96] * 2,
                           [b"\x09" * 96] * 2)[3] == B.FRONT_RAW_CHAINED
    # genesis chunk: a 32-byte seed previous_sig is not signature-width
    assert verc.pack_chunk([1, 2], [b"\x00" * 96] * 2,
                           [b"\x09" * 32, b"\x08" * 96])[3] == B.FRONT_DIGEST
    # a chained chunk whose only prevs are absent still ships raw
    assert verc.pack_chunk([1, 2], [b"\x00" * 96] * 2,
                           [None, b""])[3] == B.FRONT_RAW_CHAINED
    _, verh = _verifier(schemes.SHORT_SIG_SCHEME_ID, h2f_device=False)
    assert verh.pack_chunk([1, 2], [b"\x00" * 48] * 2)[3] == B.FRONT_FIELDS
    _, vera = _verifier(schemes.SHORT_SIG_SCHEME_ID)
    assert vera.pack_chunk([1, 2], [b"\x00" * 48] * 2)[3] == B.FRONT_FIELDS
    assert vera.pack_chunk(list(range(1, 41)), [b"\x00" * 48] * 40)[3] == \
        B.FRONT_RAW_UNCHAINED              # 40 rounds pad to 64


def _chained_chunk(n, genesis):
    sch = schemes.scheme_from_name(schemes.DEFAULT_SCHEME_ID)
    rounds = list(range(1, n + 1))
    prevs = [RNG.bytes(96) for _ in rounds]
    prevs[0] = RNG.bytes(32) if genesis else None
    sigs = [RNG.bytes(96) for _ in rounds]
    return rounds, sigs, prevs


@pytest.mark.parametrize("case", ["g1_unchained", "g2_unchained",
                                  "g2_chained", "g2_chained_genesis"])
def test_device_fronts_give_the_fields_front_encoding(monkeypatch, case):
    """Each device front, hashed (plain here, H1 on the card), equals the
    FIELDS front's host encoding limb for limb at pad 64: the same inputs
    to every pass, so the same verdicts; pack_chunk hashed nothing on the
    host and launched nothing."""
    sid = {"g1_unchained": schemes.SHORT_SIG_SCHEME_ID,
           "g2_unchained": schemes.UNCHAINED_SCHEME_ID}.get(
               case, schemes.DEFAULT_SCHEME_ID)
    _, ver = _verifier(sid)
    if case.startswith("g2_chained"):
        rounds, sigs, prevs = _chained_chunk(40, case.endswith("genesis"))
    else:
        rounds = list(range(7, 47))
        sigs = [RNG.bytes(ver.scheme.sig_group.point_len) for _ in rounds]
        prevs = None
    monkeypatch.setattr(HH, "hash_to_field_fp", _no_host_hash)
    monkeypatch.setattr(HH, "hash_to_field_fp2", _no_host_hash)
    K.reset_launches()
    n, enc, bad, front = ver.pack_chunk(rounds, sigs, prevs)
    assert not any(K.LAUNCHES.values())
    assert front == {"g2_chained": B.FRONT_RAW_CHAINED,
                     "g2_chained_genesis": B.FRONT_DIGEST}.get(
                         case, B.FRONT_RAW_UNCHAINED)
    got = ver._fields_enc(enc, front)
    monkeypatch.undo()
    want, wbad = ver._encode(sigs, ver._messages(rounds, prevs), 64)
    np.testing.assert_array_equal(bad, wbad)
    flat = lambda t: [x for c in t for x in
                      (c if isinstance(c, tuple) else (c,))]
    for g, w in zip(flat(got[:2]), flat(want[:2])):
        assert torch.equal(g, w)
    # the messages' field elements, real lanes (pad lanes hash another
    # filler message on each front; they are inert in every pass)
    for g, w in zip(flat(got[2:]), flat(want[2:])):
        assert torch.equal(g[:n], w[:n])


def _no_host_hash(*a, **k):
    raise AssertionError("host hash_to_field above the threshold")


def test_pack_does_no_host_hashing_above_threshold(monkeypatch):
    """With h2f_device auto, pack_chunk at pad 64 never calls the host
    hash_to_field (patched to raise) and launches no kernel, while the
    pack clock still ticks; at pad 8 the host front calls it."""
    monkeypatch.delenv("DRAND_H2F_DEVICE", raising=False)
    monkeypatch.delenv("DRAND_H2F_DEVICE_MIN_N", raising=False)
    monkeypatch.setattr(HH, "hash_to_field_fp", _no_host_hash)
    monkeypatch.setattr(HH, "hash_to_field_fp2", _no_host_hash)
    rounds = list(range(1, 41))
    for sid in (schemes.SHORT_SIG_SCHEME_ID, schemes.DEFAULT_SCHEME_ID):
        _, ver = _verifier(sid)
        sigs = [b"\xa0" + b"\x00" * (ver.scheme.sig_group.point_len - 1)
                ] * len(rounds)
        prevs = [b"\x01" * ver.scheme.sig_group.point_len] * len(rounds)
        t0 = B.pack_seconds()
        K.reset_launches()
        packed = ver.pack_chunk(rounds, sigs, prevs)
        assert packed[3] != B.FRONT_FIELDS
        assert not any(K.LAUNCHES.values())
        assert B.pack_seconds() > t0
        with pytest.raises(AssertionError, match="host hash_to_field"):
            ver.pack_chunk(rounds[:5], sigs[:5], prevs[:5])


def test_partials_msg_enc_fronts(monkeypatch):
    """BatchPartialVerifier._msg_enc: the DIGEST front at or above the
    threshold with 32-byte digests (H1 expands them: equal to the host
    oracle), the FIELDS front below it or for other lengths."""
    monkeypatch.delenv("DRAND_H2F_DEVICE", raising=False)
    monkeypatch.setenv("DRAND_H2F_DEVICE_MIN_N", "4")
    sch = schemes.scheme_from_name(schemes.SHORT_SIG_SCHEME_ID)
    poly = HT.PriPoly([5, 6])
    bv = PP.BatchPartialVerifier(sch, poly.commit(sch.key_group), 3,
                                 device="cpu")
    msgs = [sch.digest_beacon(r) for r in range(1, 5)]
    front, msg = bv._msg_enc(msgs)
    assert front == B.FRONT_DIGEST
    got = DH.hash_to_field_front(front, msg, sch.dst, False)
    front_h, want = bv._msg_enc(msgs[:3])
    assert front_h == B.FRONT_FIELDS
    for g, w in zip(got, want):
        assert torch.equal(g[:3], w)
    assert bv._msg_enc(msgs[:3] + [b"\x01" * 31])[0] == B.FRONT_FIELDS


def test_legacy_fields_encoding_still_accepted():
    """_encode's 4-tuple (the FIELDS front, still what the chip smoke's
    stage split and external callers hold) normalizes to the 3-tuple."""
    _, ver = _verifier(schemes.SHORT_SIG_SCHEME_ID)
    enc = (1, 2, (3, 4))
    norm, front = ver._norm_enc((1, 2, 3, 4))
    assert norm == enc and front == B.FRONT_FIELDS
    norm, front = ver._norm_enc(enc, B.FRONT_RAW_UNCHAINED)
    assert norm == enc and front == B.FRONT_RAW_UNCHAINED
    assert ver._fields_enc((1, 2, 3, 4)) == (1, 2, 3, 4)


def test_round_words_encoding():
    got = B.BatchBeaconVerifier._round_words([1, 2 ** 40 + 7, 2 ** 64 - 1], 4)
    assert got.shape == (4, 2) and got.dtype == np.int64
    for i, r in enumerate([1, 2 ** 40 + 7, 2 ** 64 - 1, 0]):
        assert (int(got[i, 0]) << 32) | int(got[i, 1]) == r
    want = JB.BatchBeaconVerifier._round_words([1, 2 ** 40 + 7,
                                                2 ** 64 - 1], 4)
    np.testing.assert_array_equal(got, want.astype(np.int64))
