"""Batched beacon verification for the short-signature scheme (sigs on G1).

Counterpart of drand_tpu/crypto/batch.py, first slice: the EXACT per-round
pairing check of ``bls-unchained-on-g1``,

    e(S_i, -g2) * e(H(m_i), pk) == 1          for every round i,

with S_i decompressed and H(m_i) hashed to G1 on the device.  One pass over
the padded batch launches K1 three times (the shared sqrt scan at width 3N
and the two to_affine inversions), K2 three times (two |x| ladders of the
subgroup check, one cofactor clearing), K3 once (2N pairs) and K4 once.

The JAX ``verify_batch`` first tries one random-linear-combination (RLC)
check over the whole batch and bisects on failure; it reaches this same
exact pass on every failing range of at most 64 rounds and on any chunk
with malformed slots, with the same per-round verdicts.  The RLC pass and
its bisection come with the GLV ladder and point-sum kernels in a later
slice.

Host/device split: the host parses wire signatures with numpy and hashes
messages to field elements (hashlib); every curve and pairing operation
runs on the device.  Malformed and padding slots carry the generator
encoding; their verdicts come from the host's bad mask or are discarded.
"""

import numpy as np
import torch

from .host import h2c as H2C
from .host.params import P, G1_GEN, G2_GEN
from .host.serialize import y_is_larger_fp
from .host.curve import G2
from .schemes import Scheme, GroupG1
from ..ops import curve as DC
from ..ops import h2c as DH
from ..ops import limbs as L
from ..ops import pairing as DP

_MIN_BATCH = 8

_NEG_G2 = G2.neg(G2_GEN)
_P_LIMBS = L.int_to_limbs(P)
_GEN_X_G1 = L.int_to_limbs(G1_GEN[0])
_GEN_SIGN_G1 = int(y_is_larger_fp(G1_GEN[1]))
# in-pipeline generator substitute (Montgomery Jacobian, z = 1)
_GEN_JAC_G1 = tuple(G1_GEN[i] * L.R_MONT % P for i in range(2)) + (L.R_MONT,)


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


def _gen_sub(pt, ok):
    """Replace slots whose decompression failed with the generator; the
    ok mask carries the verdict."""
    gen = [L.const(c, str(pt[0].device)) for c in _GEN_JAC_G1]
    return DC.G1.select(ok, pt, tuple(g.expand(pt[0].shape) for g in gen))


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
    run only on CUDA tensors, the CPU runs their plain versions."""

    def __init__(self, scheme: Scheme, public_key_bytes: bytes, device=None):
        if scheme.sig_group is not GroupG1:
            raise ValueError(f"scheme {scheme.id} is not ported")
        self.scheme = scheme
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

    def _exact(self, enc, n) -> np.ndarray:
        """Per-round exact pairing checks over an encoded batch."""
        sig_x, sign, u0, u1 = enc
        ok = _exact_run_g1sig(sig_x, sign, u0, u1, self.pk_aff,
                              self.fixed_aff)
        return ok.cpu().numpy()[:n]

    def verify_batch(self, rounds, sigs) -> np.ndarray:
        """Verify N beacons; returns a bool validity array of length N.

        This slice packs once and runs the exact per-round check over the
        whole padded batch; the RLC fast path and its bisection come in
        the next slice, with the same verdicts."""
        n = len(rounds)
        if n == 0:
            return np.zeros(0, dtype=bool)
        pad = _pad_len(n)
        enc, bad = self._encode(sigs, self._messages(rounds), pad)
        return self._exact(enc, n) & ~bad

    def verify_chain(self, beacons):
        """Verify a sequence of beacons (objects with .round, .signature);
        the scheme is unchained, so there is no linkage to check.
        Returns (all_ok, per-beacon validity array)."""
        valid = self.verify_batch([b.round for b in beacons],
                                  [b.signature for b in beacons])
        return bool(valid.all()), valid
