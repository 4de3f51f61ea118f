"""Batched beacon verification for the short-signature scheme (sigs on G1).

Counterpart of drand_tpu/crypto/batch.py for ``bls-unchained-on-g1`` on
the FIELDS front (host hash-to-field).  The N verification equations

    e(S_i, -g2) * e(H(m_i), pk) == 1

collapse to ONE two-pair check by a random linear combination (RLC),

    e(sum r_i S_i, -g2) * e(sum r_i H_i, pk) == 1       (r_i random),

sound except with probability ~2^-128 because pk is the same for every
round.  ``verify_batch`` runs one RLC pass over the padded batch; on a
failure it bisects with RLC halves down to 64 rounds and runs the exact
per-round pass on each failing range, with the same verdict at every slot
as the JAX verifier.

One RLC pass launches K1 four times (the shared sqrt scan at width 3N, the
batch inversion of the GLV tables and the two to_affine at one lane), K2
three times (two |x| ladders of the subgroup check, one cofactor
clearing), K8 once (2N lanes), K7 twice per point sum (two sums), K3 once
(2 pairs) and K4 once (1 lane).  One exact pass launches K1 three times
(the sqrt scan and two to_affine at N), K2 three times, K3 once (2N pairs)
and K4 once (N lanes).

Host/device split: the host parses wire signatures with numpy and hashes
messages to field elements (hashlib); every curve and pairing operation
runs on the device, and so do the RLC randomizers.  Malformed and padding
slots carry the generator encoding: zero RLC coefficient, exact result
discarded, verdict from the host's bad mask.
"""

import secrets
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .host import h2c as H2C
from .host.params import P, G1_GEN, G2_GEN
from .host.serialize import y_is_larger_fp
from .host.curve import G2
from .schemes import Scheme, GroupG1
from ..ops import curve as DC
from ..ops import h2c as DH
from ..ops import kernels as K
from ..ops import limbs as L
from ..ops import pairing as DP

SECURITY_BITS = 128      # RLC randomizer width
_MIN_BATCH = 8

# Depth of the verify_stream window (chunks packed and dispatched ahead of
# the resolve point) unless the caller asks for another, and the cap on
# depth x chunk encoding bytes (the JAX package's defaults).
DEFAULT_PIPELINE_DEPTH = 1
INFLIGHT_BUDGET_BYTES = 64 << 20

_NEG_G2 = G2.neg(G2_GEN)
_P_LIMBS = L.int_to_limbs(P)
_GEN_X_G1 = L.int_to_limbs(G1_GEN[0])
_GEN_SIGN_G1 = int(y_is_larger_fp(G1_GEN[1]))
# in-pipeline generator substitute (Montgomery Jacobian, z = 1)
_GEN_JAC_G1 = tuple(G1_GEN[i] * L.R_MONT % P for i in range(2)) + (L.R_MONT,)

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


def chunk_footprint_bytes(pad: int) -> int:
    """Device bytes of one packed chunk encoding (sig x limbs, sign flag,
    two hash-to-field elements; int64 limbs), the unit the in-flight
    budget divides."""
    limb_bytes = L.NLIMB * 8
    return pad * (3 * limb_bytes + 8)


def max_pipeline_depth(pad: int) -> int:
    return max(1, INFLIGHT_BUDGET_BYTES // max(1, chunk_footprint_bytes(pad)))


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


def _wire_parse(sigs):
    """Compressed G1 wire signatures -> (x limbs (n, 24), sign bits, bad
    mask), all numpy."""
    n = len(sigs)
    nb = GroupG1.point_len
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
    w = (arr[:, ::2].astype(np.int64) << 8) | arr[:, 1::2]  # 24 BE limbs
    x = np.ascontiguousarray(w[:, ::-1])                    # -> LE limbs
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
    """Host hash_to_field (count 2) -> (u0, u1) Montgomery limb tensors."""
    u0s, u1s = [], []
    for m in msgs:
        u0, u1 = H2C.hash_to_field_fp(m, dst, 2)
        u0s.append(u0)
        u1s.append(u1)
    return L.encode_mont(u0s, device), L.encode_mont(u1s, device)


# ---------------------------------------------------------------------------
# RLC randomizers
# ---------------------------------------------------------------------------

def _rlc_keys():
    """Two independent 64-bit generator seeds: 128 bits of key material for
    the device randomizer stream.  The two streams are XORed, so EQUAL
    halves would cancel to all-zero coefficients and the pairing check
    would pass vacuously: resample, so that event cannot happen."""
    raw = secrets.token_bytes(16)
    while raw[:8] == raw[8:]:
        raw = secrets.token_bytes(16)
    return (int.from_bytes(raw[:8], "little"),
            int.from_bytes(raw[8:], "little"))


def _device_rlc_bits(keys, mask):
    """Uniform RLC randomizer bits drawn ON THE DEVICE, fresh per pass: the
    XOR of two streams, each from its own ``torch.Generator`` seeded with
    one 64-bit key, so predicting them needs both keys.  (The JAX package
    XORs two threefry streams the same way; the bits themselves differ.)
    Lanes where `mask` is False get zero coefficients.  Returns the 128-bit
    coefficient in split form (b0, b1), two (64, pad) int32 MSB-first
    planes: k = k0 + lambda*k1 (curve.g1_glv_msm_terms)."""
    dev, pad = mask.device, mask.shape[0]
    w = None
    for key in keys:
        gen = torch.Generator(device=dev)
        gen.manual_seed(key)
        words = torch.randint(0, 1 << 32, (SECURITY_BITS // 32, pad),
                              generator=gen, device=dev, dtype=torch.int64)
        w = words if w is None else w ^ words
    shifts = torch.arange(31, -1, -1, device=dev)
    bits = (w[:, None, :] >> shifts[None, :, None]) & 1
    bits = (bits.reshape(SECURITY_BITS, pad) * mask[None, :]).to(torch.int32)
    half = SECURITY_BITS // 2
    return bits[:half], bits[half:]


# ---------------------------------------------------------------------------
# Device passes
# ---------------------------------------------------------------------------

def _gen_sub(pt, ok):
    """Replace slots whose decompression failed with the generator; the
    ok mask carries the verdict."""
    gen = [L.const(c, str(pt[0].device)) for c in _GEN_JAC_G1]
    return DC.G1.select(ok, pt, tuple(g.expand(pt[0].shape) for g in gen))


def _fused_verdict(sub_ok, ok, n):
    """RLC ok AND every real lane's parse and subgroup check ok, as one
    device scalar."""
    lanes = torch.arange(sub_ok.shape[0], device=sub_ok.device)
    return ok & torch.all(sub_ok | (lanes >= n))


def _rlc_run_g1sig(sig_x, sign, u0, u1, n, pk_aff, neg_g2_aff, bits=None):
    """One RLC check over a padded batch of which the first n lanes are
    real: decompress + hash, subgroup check per lane (a batched check is
    unsound on G1), lanes [S, H] with the same coefficient on S_i and H_i,
    the GLV MSM (K8), A = sum over the S half and B over the H half (K7),
    and e(A, -g2) * e(B, pk) == 1 in one 2-pair Miller loop.

    bits: the (b0, b1) planes of the coefficients, (64, pad) each; None
    draws them on the device from fresh keys.  Returns (sub_ok, verdict)."""
    sig_jac, parse_ok, hm = DH.g1_decompress_and_hash(sig_x, sign, u0, u1)
    sig_jac = _gen_sub(sig_jac, parse_ok)
    sub_ok = DC.g1_in_subgroup(sig_jac) & parse_ok
    both = tuple(torch.cat([a, b], 0) for a, b in zip(sig_jac, hm))
    if bits is None:
        mask = torch.arange(sub_ok.shape[0], device=sub_ok.device) < n
        bits = _device_rlc_bits(_rlc_keys(), mask)
    b0, b1 = bits
    mult = DC.g1_glv_msm_terms(both, torch.cat([b0, b0], 1),
                               torch.cat([b1, b1], 1))
    half = b0.shape[1]
    A = K.sum_points(tuple(t[:half] for t in mult))
    B = K.sum_points(tuple(t[half:] for t in mult))
    ax, ay, _ = DC.G1.to_affine(A)
    bx, by, _ = DC.G1.to_affine(B)
    # e(A, -g2) * e(B, pk): the two pairs share one Miller launch
    px, py = torch.stack([ax, bx]), torch.stack([ay, by])
    pair = lambda a, b: torch.stack([a, b])
    qx = (pair(neg_g2_aff[0][0], pk_aff[0][0]),
          pair(neg_g2_aff[0][1], pk_aff[0][1]))
    qy = (pair(neg_g2_aff[1][0], pk_aff[1][0]),
          pair(neg_g2_aff[1][1], pk_aff[1][1]))
    ok = DP.paired_product_is_one(px, py, (qx, qy), 2)
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
    sig_jac = _gen_sub(sig_jac, parse_ok)
    return parse_ok & _exact_g1sig_core(sig_jac, hm, pk_aff, neg_g2_aff)


class BatchBeaconVerifier:
    """Batched verifier for one chain (fixed scheme + collective key).

    Runs on the CUDA device unless ``device="cpu"`` is passed; the kernels
    run only on CUDA tensors, the CPU runs their plain versions.  pad_to:
    an optional canonical batch width every batch pads up to."""

    kind = "device"        # metrics label, as the JAX verifier's

    # A failing range of at most this many rounds goes to the exact pass;
    # a larger one bisects with RLC halves (every level a power of two).
    _BISECT_MIN = 64

    def __init__(self, scheme: Scheme, public_key_bytes: bytes,
                 pad_to=None, device=None):
        if scheme.sig_group is not GroupG1:
            raise ValueError(f"scheme {scheme.id} is not ported")
        self.scheme = scheme
        self.pad_to = pad_to
        self.device = resolve_device(device)
        self.pub_point = scheme.key_group.from_bytes(public_key_bytes)
        if self.pub_point is None:
            raise ValueError("public key is the point at infinity")
        enc = lambda c: L.encode_mont(c, self.device)
        (x0, x1), (y0, y1) = self.pub_point
        self.pk_aff = ((enc(x0), enc(x1)), (enc(y0), enc(y1)))
        (x0, x1), (y0, y1) = _NEG_G2
        self.fixed_aff = ((enc(x0), enc(x1)), (enc(y0), enc(y1)))

    # -- host-side packing ---------------------------------------------------

    def _messages(self, rounds):
        return [self.scheme.digest_beacon(int(r)) for r in rounds]

    def _pad_for(self, n: int) -> int:
        return max(_pad_len(n), self.pad_to or 0)

    def _encode_sigs(self, sigs, pad):
        """Numpy wire parse -> (sig_x tensor, sign flags, bad mask); bad and
        padding slots carry the generator encoding."""
        n = len(sigs)
        xw, sign, bad = _wire_parse(sigs)
        full_x = np.empty((pad, L.NLIMB), np.int64)
        full_sign = np.empty(pad, np.int64)
        full_x[:n], full_sign[:n] = xw, sign
        full_x[:n][bad] = _GEN_X_G1
        full_sign[:n][bad] = _GEN_SIGN_G1
        full_x[n:] = _GEN_X_G1
        full_sign[n:] = _GEN_SIGN_G1
        return (torch.from_numpy(full_x).to(self.device),
                torch.from_numpy(full_sign).to(self.device), bad)

    def _encode(self, sigs, msgs, pad):
        """Host packing (FIELDS front): wire parse and host hash-to-field.
        Returns ((sig_x, sign, u0, u1), bad)."""
        sig_x, sign, bad = self._encode_sigs(sigs, pad)
        pmsgs = _pad_msgs(msgs, pad)
        u0, u1 = hash_msgs_to_field_g1(pmsgs, self.scheme.dst, self.device)
        return (sig_x, sign, u0, u1), bad

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

        return tuple(cut(t) for t in enc)

    def _rlc_dispatch(self, enc, n):
        """One RLC pass with fresh device randomizers; returns the verdict
        as a device scalar."""
        sig_x, sign, u0, u1 = enc
        _count_dispatch("rlc")
        _, all_ok = _rlc_run_g1sig(sig_x, sign, u0, u1, n, self.pk_aff,
                                   self.fixed_aff)
        return all_ok

    def _rlc_ok(self, enc, n) -> bool:
        """One RLC check over an encoded range: True iff all n rounds
        verify."""
        return bool(self._rlc_dispatch(enc, n))

    def _exact(self, enc, n) -> np.ndarray:
        """Per-round exact pairing checks over an encoded batch."""
        sig_x, sign, u0, u1 = enc
        _count_dispatch("exact")
        ok = _exact_run_g1sig(sig_x, sign, u0, u1, self.pk_aff,
                              self.fixed_aff)
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
        slices of that encoding.  prev_sigs is the JAX signature's: the
        unchained scheme's digest does not read it."""
        n = len(rounds)
        if n == 0:
            return np.zeros(0, dtype=bool)
        enc, bad = self._encode(sigs, self._messages(rounds), self._pad_for(n))
        return self._verify_range(enc, 0, n, bad, top=True)

    # -- pack / dispatch / resolve -------------------------------------------

    def pack_chunk(self, rounds, sigs, prev_sigs=None):
        """Stage 1, host side: wire parse, host hash-to-field and the copy
        to the device.  Returns an opaque packed list for dispatch/resolve;
        the wall time accumulates into pack_seconds()."""
        t0 = time.perf_counter()
        n = len(rounds)
        enc, bad = self._encode(sigs, self._messages(rounds), self._pad_for(n))
        with _LOCK:
            _PACK_SECONDS["t"] += time.perf_counter() - t0
        return [n, enc, bad]

    def dispatch_packed(self, packed):
        """Stage 2: one RLC pass; returns its verdict as a device scalar, or
        None when malformed slots force the bisection path.  (The JAX
        package donates the encoding to the device program here; PyTorch
        has no buffer donation, so the chunk's tensors stay alive until
        resolve_packed drops the packed list.)"""
        n, enc, bad = packed
        if bad.any():
            return None
        return self._rlc_dispatch(enc, n)

    def resolve_packed(self, packed, verdict) -> np.ndarray:
        """Stage 3: read the verdict; bisect to the culprits on failure."""
        n, enc, bad = packed
        if verdict is not None and bool(verdict):
            return np.ones(n, dtype=bool)
        return self._verify_range(enc, 0, n, bad, top=True)

    def pipeline_depth(self, depth=None, chunk_size: int = 8192) -> int:
        """The requested depth (default DEFAULT_PIPELINE_DEPTH) clamped so
        depth x chunk encoding stays under INFLIGHT_BUDGET_BYTES."""
        want = depth if depth is not None else DEFAULT_PIPELINE_DEPTH
        return max(1, min(int(want),
                          max_pipeline_depth(self._pad_for(chunk_size))))

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
        optionally .previous_sig); the scheme is unchained, so there is no
        linkage to check.  Returns (all_ok, per-beacon validity array)."""
        valid = self.verify_batch(
            [b.round for b in beacons], [b.signature for b in beacons],
            [getattr(b, "previous_sig", None) for b in beacons])
        return bool(valid.all()), valid
