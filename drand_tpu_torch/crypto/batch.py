"""Batched beacon verification of all three drand schemes, batched signing
and batched threshold recovery.

Counterpart of drand_tpu/crypto/batch.py, with its four message fronts
(host hash-to-field, or the device hash front H1).  The N verification
equations

    e(S_i, -g2) * e(H(m_i), pk) == 1     bls-unchained-on-g1 (sigs on G1)
    e(-g1, S_i) * e(pk, H(m_i)) == 1     pedersen-bls-chained / -unchained
                                         (sigs on G2, keys on G1)

collapse to ONE two-pair check by a random linear combination (RLC),

    e(sum r_i S_i, -g2) * e(sum r_i H_i, pk) == 1       (r_i random),

(and its G2 mirror) sound except with probability ~2^-128 because pk is
the same for every round.  ``verify_batch`` runs one RLC pass over the
padded batch; on a failure it bisects with RLC halves down to 64 rounds
and runs the exact per-round pass on each failing range, with the same
verdict at every slot as the JAX verifier.

G1 signatures: one RLC pass launches K1 four times (the shared sqrt scan
at width 3N, the batch inversion of the GLV tables and the two to_affine
at one lane), K2 three times (two |x| ladders of the subgroup check, one
cofactor clearing), K8 once (2N lanes), K7 once (both point sums, two
rows of N), K3 once (2 pairs) and K4 once (1 lane).  One exact pass launches K1 three
times (the sqrt scan and two to_affine at N), K2 three times, K3 once (2N
pairs) and K4 once (N lanes).

G2 signatures: one RLC pass launches K5 once (the shared E2 scan at 3N),
K2-G2 three times (the |x| ladder of the subgroup check, two in cofactor
clearing), K8-G2 once (4N lanes: [S, psi S, H, psi H] with the 128-bit
coefficient split four ways across psi), K7-G2 once (two rows), K1 three
times at one lane (the Fp2 inverses of the batch inversion and of the two
to_affine), K3 once and K4 once; the exact pass K5 once, K2-G2 three times,
K1 twice at N (two to_affine), K3 once (2N pairs) and K4 once (N lanes).

Host/device split: the host parses wire signatures with numpy; every
curve and pairing operation runs on the device, and so do the RLC
randomizers.  Malformed and padding slots carry the generator encoding:
zero RLC coefficient, exact result discarded, verdict from the host's bad
mask.  The messages take one of four fronts (FRONT_*), fixed per pad width
(``h2f_device_default``, or the ``h2f_device=`` pin): above the threshold
the host packs raw message words with numpy (the rounds, and the previous
signatures on a chained scheme) or, for an irregular chained chunk, host
digests, and the digest, expand_message_xmd and hash_to_field run on the
device in one H1 launch at the start of the dispatch stage; below it the
host hashes to the field (hashlib, the FIELDS front).  Either way the
passes and bisection see field elements, so nothing is hashed twice.

``sign_batch`` signs many messages with one secret: hash-to-curve, one K6
ladder at 256 bits, to_affine.  ``recover_batch`` interpolates t verified
partials per round in the exponent: Lagrange coefficients and their signed
GLV digits on the host, decompression (K1 or K5), one K6 ladder over the
phi (G1, 130 bits) or psi (G2, 66 bits) lanes of all partials, a sum per
round.
"""

import os
import secrets
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .host import h2c as H2C
from .host import serialize as HS
from .host import tbls as HT
from .host.params import P, G1_GEN, G2_GEN
from .host.serialize import y_is_larger_fp, y_is_larger_fp2
from .host.curve import G1, G2
from .device_pool import placement_devices
from .schemes import Scheme, GroupG1, GroupG2
from ..ops import curve as DC
from ..ops import h2c as DH
from ..ops import kernels as K
from ..ops import limbs as L
from ..ops import pairing as DP
from ..ops import sha256 as SHA

SECURITY_BITS = 128      # RLC randomizer width
_MIN_BATCH = 8

# Depth of the verify_stream window (chunks packed and dispatched ahead of
# the resolve point) unless the caller asks for another, and the cap on
# depth x chunk encoding bytes (the JAX package's defaults).
DEFAULT_PIPELINE_DEPTH = 1
INFLIGHT_BUDGET_BYTES = 64 << 20

_NEG_G1 = G1.neg(G1_GEN)
_NEG_G2 = G2.neg(G2_GEN)
_P_LIMBS = L.int_to_limbs(P)
# canonical generator x limbs and sign flags for malformed and padding
# slots; G2's x is (c0, c1)
_GEN_X_G1 = L.int_to_limbs(G1_GEN[0])
_GEN_SIGN_G1 = int(y_is_larger_fp(G1_GEN[1]))
_GEN_X_G2 = np.stack([L.int_to_limbs(G2_GEN[0][0]),
                      L.int_to_limbs(G2_GEN[0][1])])
_GEN_SIGN_G2 = int(y_is_larger_fp2(G2_GEN[1]))
# in-pipeline generator substitute (Montgomery Jacobian, z = 1)
_mont = lambda x: x * L.R_MONT % P
_GEN_JAC_G1 = (_mont(G1_GEN[0]), _mont(G1_GEN[1]), L.R_MONT)
_GEN_JAC_G2 = ((_mont(G2_GEN[0][0]), _mont(G2_GEN[0][1])),
               (_mont(G2_GEN[1][0]), _mont(G2_GEN[1][1])), (L.R_MONT, 0))

# Message fronts of the verify passes.  The device fronts ship message words
# and hash on the device (H1): "raw_unchained" the rounds, "raw_chained"
# the previous signatures and the rounds, "digest" host-computed 32-byte
# digests (an irregular chained chunk -- a genesis seed's previous_sig is
# not signature-width -- and the partials' round digests).  "fields" is
# the host hash_to_field, the oracle and the below-threshold front.
FRONT_FIELDS = "fields"
FRONT_DIGEST = "digest"
FRONT_RAW_UNCHAINED = "raw_unchained"
FRONT_RAW_CHAINED = "raw_chained"


def h2f_device_min_n() -> int:
    """Batch width at or above which packing ships message words and
    hash-to-field runs on the device (DRAND_H2F_DEVICE_MIN_N, default
    64)."""
    return int(os.environ.get("DRAND_H2F_DEVICE_MIN_N", "64"))


def h2f_device_default(width: int) -> bool:
    """Front selection for a `width`-lane batch: DRAND_H2F_DEVICE=0 forces
    the host front, =1 the device front, anything else compares the width
    with h2f_device_min_n().  Deterministic per width."""
    mode = os.environ.get("DRAND_H2F_DEVICE", "auto")
    if mode == "0":
        return False
    if mode == "1":
        return True
    return width >= h2f_device_min_n()


# Host pack wall time (pack_chunk) and device passes, process-wide.
_PACK_SECONDS = {"t": 0.0}
_PASSES = {"rlc": 0, "exact": 0}
_LOCK = threading.Lock()


def pack_seconds() -> float:
    return _PACK_SECONDS["t"]


def _count_dispatch(kind: str) -> None:
    with _LOCK:
        _PASSES[kind] += 1


def dispatch_count() -> int:
    """Process-wide count of device passes (RLC and exact), as the JAX
    module's dispatch_count counts its pipeline invocations."""
    return sum(_PASSES.values())


def pass_counts() -> dict:
    """The same count split by kind: {"rlc": ..., "exact": ...}."""
    return dict(_PASSES)


def chunk_footprint_bytes(pad: int, g2sig: bool = False) -> int:
    """Device bytes of one packed chunk encoding (sig x limbs, sign flag,
    two hash-to-field elements; int64 limbs; Fp2 doubles x and the field
    elements), the unit the in-flight budget divides."""
    limb_bytes = L.NLIMB * 8
    return pad * ((6 if g2sig else 3) * limb_bytes + 8)


def max_pipeline_depth(pad: int, g2sig: bool = False) -> int:
    return max(1, INFLIGHT_BUDGET_BYTES
               // max(1, chunk_footprint_bytes(pad, g2sig)))


def resolve_device(device=None) -> torch.device:
    """The device a verifier runs on: CUDA unless the caller asks for the
    CPU explicitly.  Without a GPU and without an explicit "cpu" this
    raises; it never carries on quietly on the CPU."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the plain PyTorch versions on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def _ge_p(limbs: np.ndarray) -> np.ndarray:
    """x >= p over (n, 24) little-endian limb arrays (host range check)."""
    diff = limbs.astype(np.int64) - _P_LIMBS[None]
    nz = diff != 0
    any_nz = nz.any(axis=1)
    top = 23 - np.argmax(nz[:, ::-1], axis=1)
    return np.where(any_nz, diff[np.arange(len(limbs)), top] > 0, True)


def _wire_parse(sigs, g2: bool = False):
    """Compressed wire signatures -> (x limbs, sign bits, bad mask), all
    numpy.  x: (n, 24) on G1, (n, 2, 24) [c0, c1] on G2, whose wire order
    is c1 then c0."""
    n = len(sigs)
    nb = (GroupG2 if g2 else GroupG1).point_len
    bad = np.zeros(n, dtype=bool)
    arr = np.zeros((n, nb), np.uint8)
    ok_len = [i for i, s in enumerate(sigs) if len(s) == nb]
    if ok_len:
        arr[ok_len] = np.frombuffer(
            b"".join(bytes(sigs[i]) for i in ok_len), np.uint8
        ).reshape(len(ok_len), nb)
    bad[[i for i in range(n) if len(sigs[i]) != nb]] = True
    flags = arr[:, 0]
    bad |= (flags & 0x80) == 0
    bad |= (flags & 0x40) != 0                  # infinity: invalid signature
    sign = ((flags >> 5) & 1).astype(np.int64)
    arr[:, 0] &= 0x1F

    def limbs(block):                           # 48 BE bytes -> 24 LE limbs
        w = (block[:, ::2].astype(np.int64) << 8) | block[:, 1::2]
        return np.ascontiguousarray(w[:, ::-1])

    if g2:
        x1, x0 = limbs(arr[:, :48]), limbs(arr[:, 48:])
        bad |= _ge_p(x0) | _ge_p(x1)
        return np.stack([x0, x1], axis=1), sign, bad
    x = limbs(arr)
    bad |= _ge_p(x)
    return x, sign, bad


def _pad_msgs(msgs, pad: int):
    """Pad a message list to `pad` entries, keeping uniform lengths."""
    uniform = msgs and all(len(m) == len(msgs[0]) for m in msgs)
    pad_msg = b"\x00" * len(msgs[0]) if uniform else b""
    return list(msgs) + [pad_msg] * (pad - len(msgs))


def _pad_len(n: int) -> int:
    m = _MIN_BATCH
    while m < n:
        m *= 2
    return m


def hash_msgs_to_field_g1(msgs, dst, device):
    """Host hash_to_field (count 2) -> (u0, u1) Montgomery limb tensors:
    the FIELDS front, the oracle of the device fronts."""
    u0s, u1s = [], []
    for m in msgs:
        u0, u1 = H2C.hash_to_field_fp(m, dst, 2)
        u0s.append(u0)
        u1s.append(u1)
    return L.encode_mont(u0s, device), L.encode_mont(u1s, device)


def hash_msgs_to_field_g2(msgs, dst, device):
    """Host hash_to_field over Fp2 (count 2) -> (u0, u1), each an Fp2 pair
    of Montgomery limb tensors."""
    cols = [[], [], [], []]
    for m in msgs:
        (a0, a1), (b0, b1) = H2C.hash_to_field_fp2(m, dst, 2)
        for c, v in zip(cols, (a0, a1, b0, b1)):
            c.append(v)
    e = [L.encode_mont(c, device) for c in cols]
    return (e[0], e[1]), (e[2], e[3])


# ---------------------------------------------------------------------------
# RLC randomizers
# ---------------------------------------------------------------------------

def _rlc_keys():
    """Two independent 64-bit generator seeds: 128 bits of key material for
    the device randomizer stream.  The streams they seed are XORed, so
    equal streams would cancel to all-zero coefficients and the pairing
    check would pass vacuously.  A CUDA generator takes a whole 64-bit key;
    the CPU generator keeps only a seed's low 32 bits, so there each 32-bit
    word of the keys seeds a stream of its own (_stream_seeds).  Resample
    until the four words differ, so that no two streams can cancel on
    either device."""
    while True:
        raw = secrets.token_bytes(16)
        if len({raw[i:i + 4] for i in range(0, 16, 4)}) == 4:
            return (int.from_bytes(raw[:8], "little"),
                    int.from_bytes(raw[8:], "little"))


def _stream_seeds(keys, dev):
    """The seeds of the XORed streams: the 64-bit keys on the card, their
    32-bit words (low word first) on the CPU."""
    if dev.type == "cuda":
        return list(keys)
    return [k >> s & 0xFFFFFFFF for k in keys for s in (0, 32)]


def _device_rlc_bits(keys, mask, split: int = 2):
    """Uniform RLC randomizer bits drawn ON THE DEVICE, fresh per pass: the
    XOR of streams, each from its own ``torch.Generator``, seeded with the
    two 64-bit keys (CUDA) or their four 32-bit words (CPU), so predicting
    them needs all 128 bits of key.  (The JAX package XORs two threefry
    streams the same way; the bits themselves differ.)
    Lanes where `mask` is False get zero coefficients.  Returns the 128-bit
    coefficient in split form, `split` (128/split, pad) int32 MSB-first
    planes: split=2 gives (b0, b1) with k = k0 + lambda*k1
    (curve.g1_glv_msm_terms), split=4 the base-x quarters (b0..b3) with
    k = k0 + x k1 + x^2 k2 + x^3 k3 (the G2 psi split)."""
    dev, pad = mask.device, mask.shape[0]
    w = None
    for seed in _stream_seeds(keys, dev):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        words = torch.randint(0, 1 << 32, (SECURITY_BITS // 32, pad),
                              generator=gen, device=dev, dtype=torch.int64)
        w = words if w is None else w ^ words
    shifts = torch.arange(31, -1, -1, device=dev)
    bits = (w[:, None, :] >> shifts[None, :, None]) & 1
    bits = (bits.reshape(SECURITY_BITS, pad) * mask[None, :]).to(torch.int32)
    part = SECURITY_BITS // split
    return tuple(bits[i * part:(i + 1) * part] for i in range(split))


# ---------------------------------------------------------------------------
# Device passes
# ---------------------------------------------------------------------------

def _gen_sub(curve, gen, pt, ok):
    """Replace slots whose decompression failed with the generator (`gen`:
    Montgomery Jacobian ints, nested like the point); the ok mask carries
    the verdict."""
    like = DC._leaf(pt[0])
    genb = DC._tmap(lambda c: L.const(c, str(like.device)).expand(like.shape),
                    gen)
    return curve.select(ok, pt, genb)


def _fused_verdict(sub_ok, ok, n):
    """RLC ok AND every real lane's parse and subgroup check ok, as one
    device scalar."""
    lanes = torch.arange(sub_ok.shape[0], device=sub_ok.device)
    return ok & torch.all(sub_ok | (lanes >= n))


def _rlc_mask(sign, n):
    """Lanes of a padded batch whose coefficients are drawn: the first n."""
    return torch.arange(sign.shape[0], device=sign.device) < n


def _rlc_sums_g1sig(sig_x, sign, u0, u1, b0, b1):
    """The stages of a G1 RLC pass up to its point sums, over any run of
    lanes (a whole batch, or one device's shard of it): decompress + hash,
    subgroup check per lane (a batched check is unsound on G1), lanes
    [S, H] with the same coefficient (planes b0, b1) on S_i and H_i, the
    GLV MSM (K8), A = sum over the S half and B over the H half (K7, the
    two rows of one launch).  Returns (sub_ok, A, B), A and B Jacobian."""
    sig_jac, parse_ok, hm = DH.g1_decompress_and_hash(sig_x, sign, u0, u1)
    sig_jac = _gen_sub(DC.G1, _GEN_JAC_G1, sig_jac, parse_ok)
    sub_ok = DC.g1_in_subgroup(sig_jac) & parse_ok
    both = tuple(torch.cat([a, b], 0) for a, b in zip(sig_jac, hm))
    mult = DC.g1_glv_msm_terms(both, torch.cat([b0, b0], 1),
                               torch.cat([b1, b1], 1))
    half = b0.shape[1]
    sums = K.sum_rows(tuple(t.reshape(2, half, t.shape[-1]) for t in mult))
    A, B = (tuple(c[i] for c in sums) for i in (0, 1))
    return sub_ok, A, B


def _rlc_check_g1sig(A, B, pk_aff, neg_g2_aff):
    """e(A, -g2) * e(B, pk) == 1 in one 2-pair Miller loop, as a device
    bool."""
    ax, ay, _ = DC.G1.to_affine(A)
    bx, by, _ = DC.G1.to_affine(B)
    # e(A, -g2) * e(B, pk): the two pairs share one Miller launch
    px, py = torch.stack([ax, bx]), torch.stack([ay, by])
    pair = lambda a, b: torch.stack([a, b])
    qx = (pair(neg_g2_aff[0][0], pk_aff[0][0]),
          pair(neg_g2_aff[0][1], pk_aff[0][1]))
    qy = (pair(neg_g2_aff[1][0], pk_aff[1][0]),
          pair(neg_g2_aff[1][1], pk_aff[1][1]))
    return DP.paired_product_is_one(px, py, (qx, qy), 2)


def _rlc_run_g1sig(sig_x, sign, u0, u1, n, pk_aff, neg_g2_aff, bits=None):
    """One RLC check over a padded batch of which the first n lanes are
    real: the sums (_rlc_sums_g1sig), then e(A, -g2) * e(B, pk) == 1.

    bits: the (b0, b1) planes of the coefficients, (64, pad) each; None
    draws them on the device from fresh keys.  Returns (sub_ok, verdict)."""
    if bits is None:
        bits = _device_rlc_bits(_rlc_keys(), _rlc_mask(sign, n))
    sub_ok, A, B = _rlc_sums_g1sig(sig_x, sign, u0, u1, *bits)
    ok = _rlc_check_g1sig(A, B, pk_aff, neg_g2_aff)
    return sub_ok, _fused_verdict(sub_ok, ok, n)


def _exact_g1sig_core(sig_jac, hm, pk_aff, neg_g2_aff):
    sub_ok = DC.g1_in_subgroup(sig_jac)
    sx, sy, _ = DC.G1.to_affine(sig_jac)
    hx, hy, _ = DC.G1.to_affine(hm)
    shape = sx.shape
    # e(S, -g2) * e(H_i, pk) == 1: the two pairs of a round share one
    # Miller launch (pair axis first)
    px = torch.stack([sx, hx])
    py = torch.stack([sy, hy])
    pair = lambda a, b: torch.stack([a.expand(shape), b.expand(shape)])
    qx = (pair(neg_g2_aff[0][0], pk_aff[0][0]),
          pair(neg_g2_aff[0][1], pk_aff[0][1]))
    qy = (pair(neg_g2_aff[1][0], pk_aff[1][0]),
          pair(neg_g2_aff[1][1], pk_aff[1][1]))
    ok = DP.paired_product_is_one(px, py, (qx, qy), 2)
    return sub_ok & ok


def _exact_run_g1sig(sig_x, sign, u0, u1, pk_aff, neg_g2_aff):
    """Per-round exact check: decompress + hash (one K1 launch at 3N),
    subgroup check, two to_affine, one Miller loop over 2N pairs and one
    final exponentiation over N lanes."""
    sig_jac, parse_ok, hm = DH.g1_decompress_and_hash(sig_x, sign, u0, u1)
    sig_jac = _gen_sub(DC.G1, _GEN_JAC_G1, sig_jac, parse_ok)
    return parse_ok & _exact_g1sig_core(sig_jac, hm, pk_aff, neg_g2_aff)


def _pair_g2(a, b):
    """Two G2 affine points (x, y) -> the (x, y) Fp2 pairs stacked on a
    leading pair axis."""
    st = lambda u, v: torch.stack([u, v])
    return tuple(DC._tmap(st, ca, cb) for ca, cb in zip(a, b))


def _rlc_sums_g2sig(sig_x, sign, u0, u1, b0, b1, b2, b3):
    """The stages of a G2 RLC pass up to its point sums, over any run of
    lanes (a whole batch, or one device's shard of it).  Front end: ONE K5
    E2 scan fuses decompression and both SSWU maps.  MSM: the 128-bit
    coefficient comes as base-x quarters (b0..b3); lanes [S, psi S, H,
    psi H] run the 32-step psi^2-joint ladder (K8-G2) with bl = [b0, b1,
    b0, b1], bh = [b2, b3, b2, b3], so S_i and H_i get k_i = b0 + x b1 +
    x^2 b2 + x^3 b3; A sums the S half and B the H half (K7-G2, the two
    rows of one launch).  Returns (sub_ok, A, B), A and B Jacobian."""
    sig_jac, parse_ok, hm = DH.g2_decompress_and_hash(sig_x[0], sig_x[1],
                                                      sign, u0, u1)
    sig_jac = _gen_sub(DC.G2, _GEN_JAC_G2, sig_jac, parse_ok)
    sub_ok = DC.g2_in_subgroup(sig_jac) & parse_ok
    base = DC._cat_lanes(sig_jac, DC.g2_psi(sig_jac), hm, DC.g2_psi(hm))
    mult = DC.g2_glv_msm_terms(base, torch.cat([b0, b1, b0, b1], 1),
                               torch.cat([b2, b3, b2, b3], 1))
    half = 2 * b0.shape[1]
    sums = K.sum_rows(DC._tmap(lambda t: t.reshape(2, half, t.shape[-1]),
                               mult))
    A, B = (DC._tmap(lambda c: c[i], sums) for i in (0, 1))
    return sub_ok, A, B


def _rlc_check_g2sig(A, B, pk_aff, neg_g1_aff):
    """e(-g1, A) * e(pk, B) == 1 in one 2-pair Miller loop, as a device
    bool."""
    ax, ay, _ = DC.G2.to_affine(A)
    bx, by, _ = DC.G2.to_affine(B)
    px = torch.stack([neg_g1_aff[0], pk_aff[0]])
    py = torch.stack([neg_g1_aff[1], pk_aff[1]])
    return DP.paired_product_is_one(px, py, _pair_g2((ax, ay), (bx, by)), 2)


def _rlc_run_g2sig(sig_x, sign, u0, u1, n, pk_aff, neg_g1_aff, bits=None):
    """One RLC check for the schemes with signatures on G2 and keys on G1
    (pedersen-bls-chained / -unchained), first n lanes real: the sums
    (_rlc_sums_g2sig), then e(-g1, A) * e(pk, B) == 1.

    bits: the planes (b0, b1, b2, b3), (32, pad) each; None draws them on
    the device from fresh keys.  Returns (sub_ok, verdict)."""
    if bits is None:
        bits = _device_rlc_bits(_rlc_keys(), _rlc_mask(sign, n), split=4)
    sub_ok, A, B = _rlc_sums_g2sig(sig_x, sign, u0, u1, *bits)
    ok = _rlc_check_g2sig(A, B, pk_aff, neg_g1_aff)
    return sub_ok, _fused_verdict(sub_ok, ok, n)


def _exact_run_g2sig(sig_x, sign, u0, u1, pk_aff, neg_g1_aff):
    """Per-round exact check e(-g1, S_i) * e(pk, H_i) == 1: decompress +
    hash (one K5 launch at 3N), subgroup check, two to_affine, one Miller
    loop over 2N pairs and one final exponentiation over N lanes."""
    sig_jac, parse_ok, hm = DH.g2_decompress_and_hash(sig_x[0], sig_x[1],
                                                      sign, u0, u1)
    sig_jac = _gen_sub(DC.G2, _GEN_JAC_G2, sig_jac, parse_ok)
    sub_ok = DC.g2_in_subgroup(sig_jac) & parse_ok
    sx, sy, _ = DC.G2.to_affine(sig_jac)
    hx, hy, _ = DC.G2.to_affine(hm)
    shape = sx[0].shape
    pair = lambda a, b: torch.stack([a.expand(shape), b.expand(shape)])
    px = pair(neg_g1_aff[0], pk_aff[0])
    py = pair(neg_g1_aff[1], pk_aff[1])
    ok = DP.paired_product_is_one(px, py, _pair_g2((sx, sy), (hx, hy)), 2)
    return sub_ok & ok


class BatchBeaconVerifier:
    """Batched verifier for one chain (fixed scheme + collective key).

    Runs on the CUDA device unless ``device="cpu"`` is passed; the kernels
    run only on CUDA tensors, the CPU runs their plain versions.  pad_to:
    an optional canonical batch width every batch pads up to.  h2f_device:
    None picks the message front per pad width (h2f_device_default);
    True / False pin the device or the host front.

    Placement (crypto/device_pool.py): `sharding` (None, one device, or an
    ordered list of devices) pins the verifier to its devices and wins over
    `device`.  On one device every
    tensor lives there.  On several, an RLC pass at pad >= SHARD_MIN_PAD
    that divides evenly draws the coefficients for the whole pad, runs each
    contiguous shard's stages up to its partial point sums on its own
    device, adds the partial sums on the first (lowest-index) device and
    runs one pairing check there: the JAX verifier's cross-shard reduction.
    Everything else (packing, H1, the exact pass, a narrow or uneven batch)
    runs on that first device, as the JAX verifier's _pin_fallback pins
    it."""

    kind = "device"        # metrics label, as the JAX verifier's

    # A failing range of at most this many rounds goes to the exact pass;
    # a larger one bisects with RLC halves (every level a power of two).
    _BISECT_MIN = 64

    # Below this batch width a split leaves devices idle for nothing.
    SHARD_MIN_PAD = 512

    def __init__(self, scheme: Scheme, public_key_bytes: bytes,
                 pad_to=None, device=None, h2f_device=None, sharding=None):
        self.scheme = scheme
        self.g2sig = scheme.sig_group is GroupG2
        self.pad_to = pad_to
        self.h2f_device = h2f_device
        self.sharding = sharding
        placed = sorted((resolve_device(d)
                         for d in placement_devices(sharding)),
                        key=lambda d: d.index or 0)
        self.shard_devices = placed if len(placed) > 1 else []
        self.device = placed[0] if placed else resolve_device(device)
        self.pub_point = scheme.key_group.from_bytes(public_key_bytes)
        if self.pub_point is None:
            raise ValueError("public key is the point at infinity")
        enc = lambda c: L.encode_mont(c, self.device)
        if self.g2sig:          # key and -g1 on G1: affine Fp coordinates
            self.pk_aff = (enc(self.pub_point[0]), enc(self.pub_point[1]))
            self.fixed_aff = (enc(_NEG_G1[0]), enc(_NEG_G1[1]))
        else:                   # key and -g2 on G2: Fp2 pairs
            (x0, x1), (y0, y1) = self.pub_point
            self.pk_aff = ((enc(x0), enc(x1)), (enc(y0), enc(y1)))
            (x0, x1), (y0, y1) = _NEG_G2
            self.fixed_aff = ((enc(x0), enc(x1)), (enc(y0), enc(y1)))

    # -- host-side packing ---------------------------------------------------

    def _messages(self, rounds, prev_sigs=None):
        """The digest of each round on the host: SHA-256 of prev_sig ||
        round on a chained scheme, of the round otherwise (the FIELDS and
        DIGEST fronts; the raw fronts digest on the device)."""
        if not self.scheme.chained or prev_sigs is None:
            prev_sigs = [None] * len(rounds)
        return [self.scheme.digest_beacon(int(r), p)
                for r, p in zip(rounds, prev_sigs)]

    def _pad_for(self, n: int) -> int:
        return max(_pad_len(n), self.pad_to or 0)

    def _encode_sigs(self, sigs, pad):
        """Numpy wire parse -> (sig_x tensor, sign flags, bad mask); bad and
        padding slots carry the generator encoding."""
        n = len(sigs)
        xw, sign, bad = _wire_parse(sigs, self.g2sig)
        gx = _GEN_X_G2 if self.g2sig else _GEN_X_G1
        gsign = _GEN_SIGN_G2 if self.g2sig else _GEN_SIGN_G1
        full_x = np.empty((pad,) + gx.shape, np.int64)
        full_sign = np.empty(pad, np.int64)
        full_x[:n], full_sign[:n] = xw, sign
        full_x[:n][bad] = gx
        full_sign[:n][bad] = gsign
        full_x[n:] = gx
        full_sign[n:] = gsign
        x = torch.from_numpy(full_x).to(self.device)
        sig_x = (x[:, 0], x[:, 1]) if self.g2sig else x
        return sig_x, torch.from_numpy(full_sign).to(self.device), bad

    def _encode(self, sigs, msgs, pad):
        """Host packing (FIELDS front): wire parse and host hash-to-field.
        Returns ((sig_x, sign, u0, u1), bad)."""
        sig_x, sign, bad = self._encode_sigs(sigs, pad)
        pmsgs = _pad_msgs(msgs, pad)
        h2f = hash_msgs_to_field_g2 if self.g2sig else hash_msgs_to_field_g1
        u0, u1 = h2f(pmsgs, self.scheme.dst, self.device)
        return (sig_x, sign, u0, u1), bad

    @staticmethod
    def _round_words(rounds, pad) -> np.ndarray:
        """(pad, 2) int64 BE words of the 8-byte big-endian rounds."""
        r = np.zeros(pad, np.uint64)
        r[:len(rounds)] = np.asarray([int(x) for x in rounds], np.uint64)
        return np.stack([(r >> np.uint64(32)).astype(np.int64),
                         (r & np.uint64(0xFFFFFFFF)).astype(np.int64)], 1)

    def _msg_front(self, rounds, prev_sigs, pad):
        """The device front's message, packed with numpy and copied to the
        device, no hashing: the round words (and, chained, the previous
        signatures' words with a has_prev flag, 0 where it is absent) for a
        uniform chunk, else host digests as words (the DIGEST front: an
        irregular chained chunk, e.g. a 32-byte genesis seed as
        previous_sig).  Returns (front, msg)."""
        to = lambda a: torch.from_numpy(a).to(self.device)
        rw = self._round_words(rounds, pad)
        if not self.scheme.chained:
            return FRONT_RAW_UNCHAINED, (to(rw),)
        if prev_sigs is None:
            prev_sigs = [None] * len(rounds)
        plen = self.scheme.sig_group.point_len
        if {len(p) for p in prev_sigs if p} <= {plen}:
            prev = np.zeros((pad, plen), np.uint8)
            has = np.zeros(pad, np.int64)
            idx = [i for i, p in enumerate(prev_sigs) if p]
            if idx:
                flat = np.frombuffer(
                    b"".join(bytes(prev_sigs[i]) for i in idx), np.uint8)
                prev[idx] = flat.reshape(len(idx), plen)
                has[idx] = 1
            pw = prev.reshape(pad, plen // 4, 4).view(">u4") \
                .reshape(pad, plen // 4).astype(np.int64)
            return FRONT_RAW_CHAINED, (to(pw), to(rw), to(has))
        msgs = _pad_msgs(self._messages(rounds, prev_sigs), pad)
        return FRONT_DIGEST, (to(SHA.pack_msgs_to_words(msgs, 32)),)

    def _pack_enc(self, rounds, sigs, prev_sigs, pad):
        """Front-aware packing -> ((sig_x, sign, msg), bad, front).  The
        front follows the pad width (h2f_device_default) unless the
        constructor pinned it; FIELDS hashes to the field on the host, the
        others ship message words (no host hashing)."""
        use_dev = self.h2f_device if self.h2f_device is not None \
            else h2f_device_default(pad)
        if use_dev:
            sig_x, sign, bad = self._encode_sigs(sigs, pad)
            front, msg = self._msg_front(rounds, prev_sigs, pad)
            return (sig_x, sign, msg), bad, front
        (sig_x, sign, u0, u1), bad = self._encode(
            sigs, self._messages(rounds, prev_sigs), pad)
        return (sig_x, sign, (u0, u1)), bad, FRONT_FIELDS

    @staticmethod
    def _norm_enc(enc, front=None):
        """Both encoding spellings -> ((sig_x, sign, msg), front): the
        legacy 4-tuple (sig_x, sign, u0, u1) of _encode (the FIELDS front)
        and the front-aware 3-tuple of _pack_enc."""
        if len(enc) == 4:
            sig_x, sign, u0, u1 = enc
            return (sig_x, sign, (u0, u1)), FRONT_FIELDS
        return enc, (front or FRONT_FIELDS)

    def _fields_enc(self, enc, front=None):
        """Any encoding -> the passes' (sig_x, sign, u0, u1): a device
        front's message goes through H1 (digest, expand_message_xmd,
        hash_to_field in one launch); FIELDS passes through."""
        (sig_x, sign, msg), front = self._norm_enc(enc, front)
        if front == FRONT_FIELDS:
            u0, u1 = msg
        else:
            u0, u1 = DH.hash_to_field_front(front, msg, self.scheme.dst,
                                            self.g2sig)
        return sig_x, sign, u0, u1

    # -- verification ---------------------------------------------------------

    def _slice_enc(self, enc, lo, hi):
        """The batch encoding cut to [lo, hi), padded back to a power of two
        with slots from the head of the batch: pad slots are inert (zero
        RLC coefficients, exact results discarded), so any encoded slot
        serves, and nothing is hashed or encoded twice."""
        padlen = _pad_len(hi - lo)
        extra = padlen - (hi - lo)

        def cut(t):
            if lo == 0 and t.shape[0] == padlen:
                return t
            s = t[lo:hi]
            return torch.cat([s, t[:extra]], 0) if extra else s

        return DC._tmap(cut, enc)

    def _rlc_dispatch(self, enc, n, front=None):
        """One RLC pass with fresh device randomizers, split over the
        placement's devices where it can be; returns the verdict as a
        device scalar."""
        enc = self._fields_enc(enc, front)
        _count_dispatch("rlc")
        devs = self._split_devices(enc[1].shape[0])
        if devs:
            split = 4 if self.g2sig else 2
            bits = _device_rlc_bits(_rlc_keys(), _rlc_mask(enc[1], n), split)
            sub_ok, A, B = self._sharded_sums(enc, bits, devs)
            check = _rlc_check_g2sig if self.g2sig else _rlc_check_g1sig
            ok = check(A, B, self.pk_aff, self.fixed_aff)
            return _fused_verdict(sub_ok, ok, n)
        run = _rlc_run_g2sig if self.g2sig else _rlc_run_g1sig
        _, all_ok = run(*enc, n, self.pk_aff, self.fixed_aff)
        return all_ok

    def _split_devices(self, pad: int):
        """The devices an RLC pass of `pad` lanes splits over: every device
        of a multi-device placement when the pad is wide enough and divides
        evenly, else none (the pass runs on self.device)."""
        devs = self.shard_devices
        if len(devs) > 1 and pad >= self.SHARD_MIN_PAD \
                and pad % len(devs) == 0:
            return devs
        return []

    def _sharded_sums(self, enc, bits, devs):
        """The RLC pass's stages up to the point sums, one contiguous shard
        of the lanes (and of the coefficient planes `bits`, drawn for the
        whole pad) on each device, then the partial sums brought to
        self.device and added there.  Returns (sub_ok, A, B) on
        self.device."""
        sums = _rlc_sums_g2sig if self.g2sig else _rlc_sums_g1sig
        curve = DC.G2 if self.g2sig else DC.G1
        pad = enc[1].shape[0]
        step = pad // len(devs)
        home = lambda t: t.to(self.device)
        oks, total = [], None
        for i, dev in enumerate(devs):
            lo, hi = i * step, (i + 1) * step
            shard = DC._tmap(lambda t: t[lo:hi].to(dev), enc)
            planes = tuple(b[:, lo:hi].to(dev) for b in bits)
            sub_ok, A, B = sums(*shard, *planes)
            oks.append(home(sub_ok))
            part = DC._tmap(home, (A, B))
            total = part if total is None else (
                curve.add(total[0], part[0]), curve.add(total[1], part[1]))
        return torch.cat(oks), total[0], total[1]

    def _rlc_ok(self, enc, n, front=None) -> bool:
        """One RLC check over an encoded range: True iff all n rounds
        verify."""
        return bool(self._rlc_dispatch(enc, n, front))

    def _exact(self, enc, n, front=None) -> np.ndarray:
        """Per-round exact pairing checks over an encoded batch."""
        run = _exact_run_g2sig if self.g2sig else _exact_run_g1sig
        enc = self._fields_enc(enc, front)
        _count_dispatch("exact")
        ok = run(*enc, self.pk_aff, self.fixed_aff)
        return ok.cpu().numpy()[:n]

    def _verify_range(self, enc, lo, hi, bad, top=False) -> np.ndarray:
        """Verdicts of rounds [lo, hi): a range with a malformed slot skips
        its RLC and bisects; a failing range of at most _BISECT_MIN rounds
        runs the exact pass.  `top`: enc is the whole batch at its pad."""
        n = hi - lo
        sub = enc if top else self._slice_enc(enc, lo, hi)
        if not bad[lo:hi].any() and self._rlc_ok(sub, n):
            return np.ones(n, dtype=bool)
        if n <= self._BISECT_MIN:
            return self._exact(sub, n) & ~bad[lo:hi]
        mid = lo + n // 2
        return np.concatenate([self._verify_range(enc, lo, mid, bad),
                               self._verify_range(enc, mid, hi, bad)])

    def verify_batch(self, rounds, sigs, prev_sigs=None) -> np.ndarray:
        """Verify N beacons; returns a bool validity array of length N.

        One RLC check over the whole batch; on failure RLC bisection
        narrows to the bad region and exact per-round checks locate the
        invalid rounds.  The batch is encoded once; bisection works on
        slices of that encoding (field elements: a device front hashes
        once, before the first pass).  prev_sigs: each round's previous
        signature, read by a chained scheme's digest only (a falsy one,
        as at the genesis slot, hashes the round alone)."""
        n = len(rounds)
        if n == 0:
            return np.zeros(0, dtype=bool)
        enc, bad, front = self._pack_enc(rounds, sigs, prev_sigs,
                                         self._pad_for(n))
        return self._verify_range(self._fields_enc(enc, front), 0, n, bad,
                                  top=True)

    # -- pack / dispatch / resolve -------------------------------------------

    def pack_chunk(self, rounds, sigs, prev_sigs=None):
        """Stage 1, host side: wire parse, the message front's packing
        (numpy message words above the threshold, no hashing and no
        kernel launch; the host hash-to-field below it) and the copy to
        the device.  Returns an opaque packed list [n, enc, bad, front]
        for dispatch/resolve; the wall time accumulates into
        pack_seconds()."""
        t0 = time.perf_counter()
        n = len(rounds)
        enc, bad, front = self._pack_enc(rounds, sigs, prev_sigs,
                                         self._pad_for(n))
        with _LOCK:
            _PACK_SECONDS["t"] += time.perf_counter() - t0
        return [n, enc, bad, front]

    def dispatch_packed(self, packed):
        """Stage 2: a device front's hash (H1) into field elements, kept in
        the packed list so resolve and bisection never hash again, then one
        RLC pass; returns its verdict as a device scalar, or None when
        malformed slots force the bisection path.  (The JAX package
        donates the encoding to the device program here; PyTorch has no
        buffer donation, so the chunk's tensors stay alive until
        resolve_packed drops the packed list.)"""
        n, enc, bad, front = packed
        packed[1] = enc = self._fields_enc(enc, front)
        packed[3] = FRONT_FIELDS
        if bad.any():
            return None
        return self._rlc_dispatch(enc, n)

    def resolve_packed(self, packed, verdict) -> np.ndarray:
        """Stage 3: read the verdict; bisect to the culprits on failure."""
        n, enc, bad, front = packed
        if verdict is not None and bool(verdict):
            return np.ones(n, dtype=bool)
        return self._verify_range(self._fields_enc(enc, front), 0, n, bad,
                                  top=True)

    def pipeline_depth(self, depth=None, chunk_size: int = 8192) -> int:
        """The requested depth (default DEFAULT_PIPELINE_DEPTH) clamped so
        depth x chunk encoding stays under INFLIGHT_BUDGET_BYTES."""
        want = depth if depth is not None else DEFAULT_PIPELINE_DEPTH
        return max(1, min(int(want), max_pipeline_depth(
            self._pad_for(chunk_size), self.g2sig)))

    def verify_stream(self, beacons, chunk_size: int = 8192, depth=None):
        """Streamed verification of an iterable of beacons (objects with
        .round, .signature, optionally .previous_sig).  A host thread packs
        chunk i+1 while the device runs chunk i on the current stream; up
        to `depth` chunks stay dispatched ahead of the resolve point.
        Yields (rounds, ok ndarray) per chunk."""

        def pack(chunk):
            rounds = [b.round for b in chunk]
            return rounds, self.pack_chunk(
                rounds, [b.signature for b in chunk],
                [getattr(b, "previous_sig", None) for b in chunk])

        def chunks():
            buf = []
            for b in beacons:
                buf.append(b)
                if len(buf) == chunk_size:
                    yield buf
                    buf = []
            if buf:
                yield buf

        def dispatch(item):
            rounds, packed = item
            return rounds, packed, self.dispatch_packed(packed)

        def resolve(item):
            rounds, packed, verdict = item
            return rounds, self.resolve_packed(packed, verdict)

        inflight = deque()
        k = self.pipeline_depth(depth, chunk_size)
        pack_timeout = 600.0        # a wedged packer, not a slow one
        with ThreadPoolExecutor(max_workers=1) as ex:
            pending = None
            for chunk in chunks():
                nxt = ex.submit(pack, chunk)
                if pending is not None:
                    inflight.append(dispatch(pending.result(pack_timeout)))
                    while len(inflight) > k:
                        yield resolve(inflight.popleft())
                pending = nxt
            if pending is not None:
                inflight.append(dispatch(pending.result(pack_timeout)))
            while inflight:
                yield resolve(inflight.popleft())

    def verify_chain(self, beacons):
        """Verify a sequence of beacons (objects with .round, .signature,
        optionally .previous_sig): on a chained scheme the host checks the
        linkage (each previous_sig is the signature before it), and every
        signature is verified in one batch.  Returns (all_ok, per-beacon
        validity array)."""
        n = len(beacons)
        prevs = [getattr(b, "previous_sig", None) for b in beacons]
        link_ok = np.ones(n, dtype=bool)
        if self.scheme.chained:
            for i in range(1, n):
                link_ok[i] = prevs[i] == beacons[i - 1].signature
        valid = link_ok & self.verify_batch(
            [b.round for b in beacons], [b.signature for b in beacons], prevs)
        return bool(valid.all()), valid


# ---------------------------------------------------------------------------
# Batched signing
# ---------------------------------------------------------------------------

def _sign_run(g2sig, u0, u1, bits):
    """hash_to_curve of the padded messages, one K6 ladder at 256 bits with
    the secret's bits on every lane, to_affine.  Returns (x, y, is_inf)."""
    curve = DC.G2 if g2sig else DC.G1
    hm = (DH.hash_to_g2_jac if g2sig else DH.hash_to_g1_jac)(u0, u1)
    return curve.to_affine(curve.scalar_mul_bits(hm, bits))


def _affine_g1_to_host(x, y):
    xs, ys = L.decode_mont(x), L.decode_mont(y)
    if isinstance(xs, int):
        xs, ys = [xs], [ys]
    return list(zip(xs, ys))


def _affine_g2_to_host(x, y):
    x0, x1 = L.decode_mont(x[0]), L.decode_mont(x[1])
    y0, y1 = L.decode_mont(y[0]), L.decode_mont(y[1])
    if isinstance(x0, int):
        x0, x1, y0, y1 = [x0], [x1], [y0], [y1]
    return [((a, b), (c, d)) for a, b, c, d in zip(x0, x1, y0, y1)]


def _to_wire(g2sig, x, y) -> list:
    """Affine device points -> compressed wire signatures (host)."""
    if g2sig:
        return [HS.g2_to_bytes(pt) for pt in _affine_g2_to_host(x, y)]
    return [HS.g1_to_bytes(pt) for pt in _affine_g1_to_host(x, y)]


def sign_batch(scheme: Scheme, secret: int, msgs, device=None) -> list:
    """BLS-sign many messages with one secret on the device (CUDA unless
    ``device="cpu"``); returns the compressed signatures."""
    device = resolve_device(device)
    n = len(msgs)
    if n == 0:
        return []
    pad = _pad_len(n)
    g2sig = scheme.sig_group is GroupG2
    h2f = hash_msgs_to_field_g2 if g2sig else hash_msgs_to_field_g1
    u0, u1 = h2f(_pad_msgs(msgs, pad), scheme.dst, device)
    bits = torch.from_numpy(DC.scalars_to_bits([secret] * pad)).to(device)
    x, y, _ = _sign_run(g2sig, u0, u1, bits)
    return _to_wire(g2sig, x, y)[:n]


# ---------------------------------------------------------------------------
# Batched tBLS recovery: Lagrange interpolation in the exponent as one MSM
# per round (kyber tbls.Recover, drand chainstore.go:202)
# ---------------------------------------------------------------------------

def _parse_grid(sig_grid, t: int, nr: int, g2sig: bool):
    """(rounds, t) wire signatures -> (x limbs (t*nr, ...), sign flags, bad
    mask), signer-major: entry j*nr + r is signer slot j of round r."""
    flat = [bytes(sig_grid[r][j]) for j in range(t) for r in range(nr)]
    return _wire_parse(flat, g2sig)


def _recover_run(g2sig, sig_x, sign, bits, neg):
    """Decompress the t*nr partials (one K1 or K5 launch), spread each over
    its GLV lanes (phi on G1, psi^0..3 on G2), negate the lanes whose digit
    is negative, one K6 ladder over the (L*t, nr) lanes, a leading-axis sum
    per round and to_affine.  bits (nbits, L*t, nr), neg (L*t, nr).
    Returns (x, y, every partial decompressed)."""
    curve = DC.G2 if g2sig else DC.G1
    if g2sig:
        sig_jac, ok = DH.g2_recover_y(sig_x[0], sig_x[1], sign)
        lanes = DC.g2_psi_lanes(sig_jac)
    else:
        sig_jac, ok = DH.g1_recover_y(sig_x, sign)
        lanes = DC.g1_phi_lanes(sig_jac)
    nlanes, nr = bits.shape[1], bits.shape[2]
    base = curve.select(neg.reshape(-1) == 1, curve.neg(lanes), lanes)
    base = DC._tmap(lambda a: a.reshape((nlanes, nr) + a.shape[1:]), base)
    acc = curve.sum_points(curve.scalar_mul_bits(base, bits))
    x, y, _ = curve.to_affine(acc)
    return x, y, torch.all(ok)


def recover_batch(scheme: Scheme, indices, partial_sigs, device=None) -> list:
    """Recover the full signature of many rounds at once (CUDA unless
    ``device="cpu"``).

    indices: (rounds, t) signer indices; partial_sigs: (rounds, t) BLS
    signatures without the 2-byte index prefix, already verified (the
    aggregator feeds only valid partials, chainstore.go:241).  Raises
    ValueError on a bad encoding or an x with no y on the curve."""
    device = resolve_device(device)
    nr = len(indices)
    if nr == 0:
        return []
    t = len(indices[0])
    g2sig = scheme.sig_group is GroupG2
    lams = [HT._lagrange_coeff(indices[r], indices[r][j])
            for j in range(t) for r in range(nr)]
    if g2sig:
        decompose, nlanes = DC.glv_decompose_g2, DC.GLV_G2_LANES
    else:
        decompose, nlanes = DC.glv_decompose_g1, DC.GLV_G1_LANES
    bits, neg = decompose(lams)             # (nbits, L, t*nr), (L, t*nr)
    bits = bits.reshape(bits.shape[0], nlanes * t, nr)
    neg = neg.reshape(nlanes * t, nr)
    xw, sgn, bad = _parse_grid(partial_sigs, t, nr, g2sig)
    if bad.any():
        raise ValueError("invalid partial signature encoding")
    x = torch.from_numpy(xw).to(device)
    sig_x = (x[:, 0], x[:, 1]) if g2sig else x
    to = lambda a: torch.from_numpy(a).to(device)
    x, y, dec_ok = _recover_run(g2sig, sig_x, to(sgn), to(bits), to(neg))
    if not bool(dec_ok):
        raise ValueError("invalid partial signature encoding")
    return _to_wire(g2sig, x, y)
