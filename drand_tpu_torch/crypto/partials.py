"""Batched threshold-partial verification.

Counterpart of drand_tpu/crypto/partials.py, with its DIGEST front (the
round digests expanded to the field on the device, H1) at or above the
threshold and its FIELDS front (host hash-to-field) below it.  A node
checks each incoming partial with two pairings (drand
``tbls.VerifyPartial``, chain/beacon/node.go:150); here a whole
(rounds x slots) block collapses into ONE Miller product by a per-slot
random linear combination:

    for all (r, j):  e(-g1, S_rj) * e(pk_idx(rj), H_r) == 1
    ==>  e(-g1, sum c_rj S_rj) * prod_i e(pk_i, T_i) == 1,
         T_i = sum over the slots signed by i of c_rj H_r

(and its mirror for signatures on G1), sound except with probability
~2^-128.  The public shares pk_i = PubPoly.eval(i) are evaluated once per
group (dkg_device.prime_public_shares at committee scale); the Miller
product has (#distinct signers + 1) pairs.
When the RLC check fails, the exact pass checks every slot with two
pairings.

Slots: callers pass ragged per-round lists of wire partials (be16(index)
|| signature); rows pad to the widest row and pad slots are False.  The
host parses with numpy and never decompresses a point: the y recovery
rides the same K1 (G1) or K5 (G2) scan as both hash maps, on the device.
"""

import numpy as np
import torch

from .batch import (FRONT_DIGEST, FRONT_FIELDS, _NEG_G1, _NEG_G2,
                    _GEN_JAC_G1, _GEN_JAC_G2, _GEN_SIGN_G1, _GEN_SIGN_G2,
                    _GEN_X_G1, _GEN_X_G2, _count_dispatch, _device_rlc_bits,
                    _gen_sub, _pair_g2, _rlc_keys, _wire_parse,
                    h2f_device_default, hash_msgs_to_field_g1,
                    hash_msgs_to_field_g2, resolve_device)
from . import dkg_device
from .host import tbls as HT
from .schemes import Scheme, GroupG2
from ..ops import curve as DC
from ..ops import h2c as DH
from ..ops import kernels as K
from ..ops import limbs as L
from ..ops import pairing as DP
from ..ops import sha256 as SHA

_cat = DC._cat_lanes


def _tile_rounds(pt, k):
    """(r, ...) point -> (r*k, ...): slot (r, j) sees round r's value."""
    return DC._tmap(lambda t: torch.repeat_interleave(t, k, dim=0), pt)


def _rlc_sums(curve, s_pts, h_pts, onehot):
    """S = the sum of the weighted signatures and the per-signer sums T_i =
    the sum over the slots with onehot[i] == 1 (masked-out slots become
    infinity): 1 + p rows of one width, one sum_rows (one K7 launch), each
    row in the association of the JAX package's sum_points (its S sum and
    its lax.scan over the signer axis).  Returns the sums stacked on a
    leading axis, S first."""
    inf = curve.infinity_like(DC._leaf(h_pts[0]))
    return K.sum_rows(_prepend_point(s_pts,
                                     curve.select(onehot == 1, h_pts, inf)))


def _prepend_point(single, stacked):
    """Prepend one unbatched point to a (k, ...)-stacked point."""
    return DC._tmap(lambda s, t: torch.cat([s[None], t], 0), single, stacked)


def _partials_verdict(sub_ok, ok, valid):
    """RLC ok AND every valid slot's decompression and subgroup check ok,
    as one device scalar (a slot whose decompression failed carries the
    generator and a live coefficient, so the RLC fails too and the exact
    pass localizes it)."""
    return ok & torch.all(sub_ok | ~valid.bool())


def _rlc_partials_run_g1sig(sig_x, sign, u0, u1, valid, onehot, pk_sel,
                            neg_g2_aff, bits=None):
    """Signatures on G1, public shares on G2.  sig_x (rk, 24) wire x limbs,
    sign (rk,), u0/u1 (r, 24), valid (rk,) slot mask, onehot (p, rk),
    pk_sel the p signers' affine G2 shares.  One K1 scan decompresses the
    slots and runs both SSWU maps; the phi-split GLV ladder (K8, 64 steps)
    weights [S, H] with the same coefficient.  bits: the (b0, b1) planes,
    (64, rk) each; None draws them on the device.  Returns (sub_ok,
    verdict)."""
    rk = onehot.shape[1]
    k = rk // u0.shape[0]
    sig_jac, parse_ok, hm_r = DH.g1_decompress_and_hash(sig_x, sign, u0, u1)
    sig_jac = _gen_sub(DC.G1, _GEN_JAC_G1, sig_jac, parse_ok)
    sub_ok = DC.g1_in_subgroup(sig_jac) & parse_ok
    hm = _tile_rounds(hm_r, k)
    if bits is None:
        bits = _device_rlc_bits(_rlc_keys(), valid.bool(), split=2)
    b0, b1 = bits
    mult = DC.g1_glv_msm_terms(_cat(sig_jac, hm), torch.cat([b0, b0], 1),
                               torch.cat([b1, b1], 1))
    px, py, _ = DC.G1.to_affine(_rlc_sums(
        DC.G1, DC._tmap(lambda t: t[:rk], mult),
        DC._tmap(lambda t: t[rk:], mult), onehot))
    qx = _prepend_point(neg_g2_aff[0], pk_sel[0])
    qy = _prepend_point(neg_g2_aff[1], pk_sel[1])
    ok = DP.paired_product_is_one(px, py, (qx, qy), onehot.shape[0] + 1)
    return sub_ok, _partials_verdict(sub_ok, ok, valid)


def _rlc_partials_run_g2sig(sig_x, sign, u0, u1, valid, onehot, pk_sel,
                            neg_g1_aff, bits=None):
    """Signatures on G2, public shares on G1.  sig_x the (x0, x1) wire
    limbs, u0/u1 Fp2 pairs.  One K5 scan decompresses the slots and runs
    both SSWU maps; the psi-split GLV ladder (K8-G2, 32 steps) over lanes
    [S, psi S, H, psi H] with the quarters (b0, b1, b2, b3), (32, rk) each,
    shared by S_rj and H_r.  Returns (sub_ok, verdict)."""
    rk = onehot.shape[1]
    k = rk // u0[0].shape[0]
    sig_jac, parse_ok, hm_r = DH.g2_decompress_and_hash(
        sig_x[0], sig_x[1], sign, u0, u1)
    sig_jac = _gen_sub(DC.G2, _GEN_JAC_G2, sig_jac, parse_ok)
    sub_ok = DC.g2_in_subgroup(sig_jac) & parse_ok
    hm = _tile_rounds(hm_r, k)
    if bits is None:
        bits = _device_rlc_bits(_rlc_keys(), valid.bool(), split=4)
    b0, b1, b2, b3 = bits
    base = _cat(sig_jac, DC.g2_psi(sig_jac), hm, DC.g2_psi(hm))
    mult = DC.g2_glv_msm_terms(base, torch.cat([b0, b1, b0, b1], 1),
                               torch.cat([b2, b3, b2, b3], 1))
    qx, qy, _ = DC.G2.to_affine(_rlc_sums(
        DC.G2, DC._tmap(lambda t: t[:2 * rk], mult),
        DC._tmap(lambda t: t[2 * rk:], mult), torch.cat([onehot, onehot], 1)))
    px = _prepend_point(neg_g1_aff[0], pk_sel[0])
    py = _prepend_point(neg_g1_aff[1], pk_sel[1])
    ok = DP.paired_product_is_one(px, py, (qx, qy), onehot.shape[0] + 1)
    return sub_ok, _partials_verdict(sub_ok, ok, valid)


def _exact_partials_run_g1sig(sig_x, sign, u0, u1, pk_slot, neg_g2_aff):
    """Every slot checked alone, e(S, -g2) * e(H, pk_slot) == 1: one Miller
    launch over 2rk pairs, one final exponentiation over rk lanes."""
    rk = sig_x.shape[0]
    k = rk // u0.shape[0]
    sig_jac, parse_ok, hm_r = DH.g1_decompress_and_hash(sig_x, sign, u0, u1)
    sig_jac = _gen_sub(DC.G1, _GEN_JAC_G1, sig_jac, parse_ok)
    sub_ok = DC.g1_in_subgroup(sig_jac) & parse_ok
    sx, sy, s_inf = DC.G1.to_affine(sig_jac)
    hx, hy, _ = DC.G1.to_affine(_tile_rounds(hm_r, k))
    bc = lambda c: c.expand(rk, L.NLIMB)
    pair = lambda a, b: DC._tmap(lambda u, v: torch.stack([bc(u), v]), a, b)
    ok = DP.paired_product_is_one(
        torch.stack([sx, hx]), torch.stack([sy, hy]),
        (pair(neg_g2_aff[0], pk_slot[0]), pair(neg_g2_aff[1], pk_slot[1])),
        2)
    return sub_ok & ~s_inf & ok


def _exact_partials_run_g2sig(sig_x, sign, u0, u1, pk_slot, neg_g1_aff):
    """Every slot checked alone, e(-g1, S) * e(pk_slot, H) == 1."""
    rk = sig_x[0].shape[0]
    k = rk // u0[0].shape[0]
    sig_jac, parse_ok, hm_r = DH.g2_decompress_and_hash(
        sig_x[0], sig_x[1], sign, u0, u1)
    sig_jac = _gen_sub(DC.G2, _GEN_JAC_G2, sig_jac, parse_ok)
    sub_ok = DC.g2_in_subgroup(sig_jac) & parse_ok
    sx, sy, s_inf = DC.G2.to_affine(sig_jac)
    hx, hy, _ = DC.G2.to_affine(_tile_rounds(hm_r, k))
    bc = lambda c: c.expand(rk, L.NLIMB)
    px = torch.stack([bc(neg_g1_aff[0]), pk_slot[0]])
    py = torch.stack([bc(neg_g1_aff[1]), pk_slot[1]])
    ok = DP.paired_product_is_one(px, py, _pair_g2((sx, sy), (hx, hy)), 2)
    return sub_ok & ~s_inf & ok


class BatchPartialVerifier:
    """Verifies (round, slot) blocks of threshold partials for one group.

    Runs on the CUDA device unless ``device="cpu"`` is passed.  The public
    shares are evaluated once per group: in one dkg_device dispatch on the
    verifier's device from ``dkg_device.MIN_N`` signers on (it primes the
    PubPoly memo, so the evals below are lookups), by ``pub_poly.eval`` on
    the host below it."""

    def __init__(self, scheme: Scheme, pub_poly: HT.PubPoly, n_nodes: int,
                 device=None):
        self.scheme = scheme
        self.g2sig = scheme.sig_group is GroupG2
        self.n_nodes = n_nodes
        self.device = resolve_device(device)
        if dkg_device.use_device(n_nodes):
            dkg_device.prime_public_shares(pub_poly, n_nodes,
                                           device=self.device)
        self.pub_points = [pub_poly.eval(i) for i in range(n_nodes)]
        enc = lambda vals: L.encode_mont(vals, self.device)
        pts = self.pub_points
        if self.g2sig:          # shares and -g1 on G1
            self.pk_x = enc([p[0] for p in pts])
            self.pk_y = enc([p[1] for p in pts])
            self.fixed_aff = (enc(_NEG_G1[0]), enc(_NEG_G1[1]))
        else:                   # shares and -g2 on G2: Fp2 pairs
            self.pk_x = (enc([p[0][0] for p in pts]),
                         enc([p[0][1] for p in pts]))
            self.pk_y = (enc([p[1][0] for p in pts]),
                         enc([p[1][1] for p in pts]))
            (x0, x1), (y0, y1) = _NEG_G2
            self.fixed_aff = ((enc(x0), enc(x1)), (enc(y0), enc(y1)))

    # -- host-side packing ---------------------------------------------------

    def _parse(self, rows, k):
        """-> (x limbs, sign flags, slot indices (r, k), valid (r, k)), all
        numpy.  A missing slot, a wrong length, bad flags, x >= p or a
        signer index out of range lands in the valid mask, and the slot
        carries the generator encoding (zero RLC coefficient); an x with no
        y on the curve is caught on the device and localized by the exact
        pass."""
        nb = 96 if self.g2sig else 48
        sig_bytes, idxs, idx_ok = [], [], []
        for row in rows:
            for j in range(k):
                p = bytes(row[j]) if j < len(row) and row[j] is not None \
                    else b""
                idx = HT.index_of(p) if len(p) >= 2 else 0
                if len(p) != nb + 2 or not (0 <= idx < self.n_nodes):
                    sig_bytes.append(b"")
                    idxs.append(0)
                    idx_ok.append(False)
                    continue
                sig_bytes.append(p[2:])
                idxs.append(idx)
                idx_ok.append(True)
        xw, sign, bad = _wire_parse(sig_bytes, self.g2sig)
        bad |= ~np.asarray(idx_ok)
        xw[bad] = _GEN_X_G2 if self.g2sig else _GEN_X_G1
        sign[bad] = _GEN_SIGN_G2 if self.g2sig else _GEN_SIGN_G1
        idxa = np.array(idxs)
        idxa[bad] = 0
        shape = (len(rows), k)
        return xw, sign, idxa.reshape(shape), (~bad).reshape(shape)

    def _pk_sel(self, signer_list):
        """The affine public shares of the given signer indices."""
        ix = torch.as_tensor(np.asarray(signer_list, dtype=np.int64),
                             device=self.device)
        return (DC._tmap(lambda t: t[ix], self.pk_x),
                DC._tmap(lambda t: t[ix], self.pk_y))

    def _msg_enc(self, msgs):
        """(front, msg) for the round digests: at or above the threshold,
        with every digest 32 bytes, the DIGEST front (the digests as
        words; H1 expands them on the device); otherwise the FIELDS
        front, the host hash_to_field oracle, msg = (u0, u1)."""
        if h2f_device_default(len(msgs)) and all(len(m) == 32
                                                 for m in msgs):
            words = SHA.pack_msgs_to_words(msgs, 32)
            return FRONT_DIGEST, (torch.from_numpy(words).to(self.device),)
        h2f = hash_msgs_to_field_g2 if self.g2sig else hash_msgs_to_field_g1
        return FRONT_FIELDS, h2f(msgs, self.scheme.dst, self.device)

    def _encode(self, msgs, partial_rows, k):
        """Packing: parse the slots, hash the round digests to the field
        (_msg_enc's front: H1 on the device, or the host).  Returns
        ((sig_x, sign, u0, u1), slot indices, valid)."""
        xw, sign, idxs, valid = self._parse(partial_rows, k)
        x = torch.from_numpy(xw).to(self.device)
        sig_x = (x[:, 0], x[:, 1]) if self.g2sig else x
        front, msg = self._msg_enc(msgs)
        u0, u1 = msg if front == FRONT_FIELDS else DH.hash_to_field_front(
            front, msg, self.scheme.dst, self.g2sig)
        return ((sig_x, torch.from_numpy(sign).to(self.device), u0, u1),
                idxs, valid)

    # -- verification --------------------------------------------------------

    def _rlc(self, enc, idxs, valid, bits=None):
        """One RLC pass over the encoded block (counted in
        batch.pass_counts); returns (sub_ok, verdict) as device tensors."""
        flat_valid = valid.reshape(-1)
        flat_idx = idxs.reshape(-1)
        signers = sorted(set(flat_idx[flat_valid].tolist()))
        onehot = np.stack([(flat_idx == s) & flat_valid for s in signers])
        run = _rlc_partials_run_g2sig if self.g2sig \
            else _rlc_partials_run_g1sig
        _count_dispatch("rlc")
        return run(*enc, torch.from_numpy(flat_valid).to(self.device),
                   torch.from_numpy(onehot.astype(np.int32)).to(self.device),
                   self._pk_sel(signers), self.fixed_aff, bits=bits)

    def _exact(self, enc, idxs):
        """Per-slot exact checks with per-slot public shares."""
        run = _exact_partials_run_g2sig if self.g2sig \
            else _exact_partials_run_g1sig
        _count_dispatch("exact")
        return run(*enc, self._pk_sel(idxs.reshape(-1)), self.fixed_aff)

    def verify_partials(self, msgs, partial_rows) -> np.ndarray:
        """msgs: one digest per round; partial_rows: ragged per-round lists
        of wire partials (be16(index) || sig).  Returns an (r, kmax)
        validity mask (padded slots are False)."""
        r = len(msgs)
        if r == 0:
            return np.zeros((0, 0), dtype=bool)
        k = max((len(row) for row in partial_rows), default=0)
        if k == 0:
            return np.zeros((r, 0), dtype=bool)
        enc, idxs, valid = self._encode(msgs, partial_rows, k)
        if not valid.any():
            return valid
        _, all_ok = self._rlc(enc, idxs, valid)
        if bool(all_ok):
            return valid
        got = self._exact(enc, idxs).cpu().numpy()
        return got.reshape(r, k) & valid
