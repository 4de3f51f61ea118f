"""Pedersen DKG + resharing: the distributed key generation state machine.

The port's own copy of drand_tpu/crypto/dkg.py: the same types, byte
formats, tags, hashes and verdicts, so a bundle made by either
implementation is accepted or rejected identically by the other
(``convert.dkg_wire`` carries them across).  It re-creates the capability
surface of kyber/share/dkg as drand drives it
(core/drand_beacon_control.go:333-529, ``dkg.Config{FastSync: true, Nonce,
Auth}`` over an echo-broadcast board):

  * `DistKeyGenerator` is a pure state machine: `generate_deals()`,
    `process_deal_bundles()`, `process_response_bundles()`,
    `process_justification_bundles()`, with no threads, clocks or
    transport.
  * FastSync: every share holder responds with a status for EVERY dealer,
    so one response round suffices when nobody misbehaves.
  * Packets are authenticated with Schnorr over the scheme's key group
    (crypto/schnorr.py), bound to the session nonce.
  * Deal shares are encrypted to the recipient with a static-DH stream
    cipher + HMAC (the wire format is the JAX package's own).

Resharing: old-group members deal a fresh polynomial whose constant term is
their OLD share; node i's new share is the Lagrange combination (at 0, over
the qualified old dealers) of the dealt evaluations, so the collective
public key, and therefore the chain, is preserved.

Where it runs.  Three seams are O(n·t) scalar multiplications: the
reshare constant-term pin (`_constant_terms_ok`), share verification
(`_adopt_matching_shares`) and the finalization combine (`_finalize`).
Each goes to crypto/dkg_device.py once its lane count reaches
``dkg_device.MIN_N`` (``DRAND_DKG_DEVICE_MIN_N``, default 64), on
``DkgConfig.device``: CUDA unless it says "cpu".  Below it the host loops
run.  The device is resolved only when a call crosses the threshold, so a
small session needs no card; a large one without a card and without
``device="cpu"`` raises.  ``DRAND_DKG_DEVICE=0`` keeps every seam on the
host.
"""

import hashlib
import hmac as _hmac
import secrets
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from . import schnorr
from .host.params import R
from .schemes import Scheme
from .host.tbls import PriPoly, PriShare, PubPoly, _lagrange_coeff

_TAG_DEAL = b"drand-tpu:dkg:deal:v1"
_TAG_RESP = b"drand-tpu:dkg:resp:v1"
_TAG_JUST = b"drand-tpu:dkg:just:v1"
_TAG_ENC = b"drand-tpu:dkg:enc:v1"

STATUS_SUCCESS = 0
STATUS_COMPLAINT = 1


@dataclass(frozen=True)
class DkgNode:
    """One participant: DKG index + long-term public key on key_group."""
    index: int
    public: bytes


@dataclass
class DkgConfig:
    """Mirror of dkg.Config (drand_beacon_control.go:339-350 usage).

    Fresh DKG: leave old_nodes None; every new node is also a dealer.
    Reshare:   old_nodes holds the previous group (dealers), `share` the
               dealer's old PriShare, `public_coeffs` the previous public
               polynomial (required by everyone to pin dealer key shares).
    """
    scheme: Scheme
    longterm: int                      # our long-term secret scalar
    nonce: bytes                       # session binding (getNonce, control.go:1084)
    new_nodes: List[DkgNode]
    threshold: int
    old_nodes: Optional[List[DkgNode]] = None
    old_threshold: int = 0
    share: Optional[PriShare] = None             # reshare: our old share
    public_coeffs: Optional[List[bytes]] = None  # reshare: old PubPoly bytes
    device: object = None   # dkg_device calls: CUDA unless "cpu" (resolved
    # only when a seam reaches dkg_device.MIN_N lanes)


# ---------------------------------------------------------------------------
# Bundles (wire forms mirror protobuf/crypto/dkg/dkg.proto's Packet surface)
# ---------------------------------------------------------------------------

@dataclass
class Deal:
    share_index: int      # recipient's NEW-group index
    encrypted: bytes      # ciphertext || 32-byte HMAC


@dataclass
class DealBundle:
    dealer_index: int
    commits: List[bytes]  # commitments of the dealt polynomial (key_group)
    deals: List[Deal]
    session_id: bytes = b""
    signature: bytes = b""

    def hash(self, nonce: bytes) -> bytes:
        h = hashlib.sha256(_TAG_DEAL)
        h.update(nonce)
        h.update(struct.pack(">I", self.dealer_index))
        for c in self.commits:
            h.update(c)
        for d in sorted(self.deals, key=lambda d: d.share_index):
            h.update(struct.pack(">I", d.share_index))
            h.update(d.encrypted)
        return h.digest()


@dataclass
class Response:
    dealer_index: int
    status: int           # STATUS_SUCCESS | STATUS_COMPLAINT


@dataclass
class ResponseBundle:
    share_index: int      # responder's NEW-group index
    responses: List[Response]
    session_id: bytes = b""
    signature: bytes = b""

    def hash(self, nonce: bytes) -> bytes:
        h = hashlib.sha256(_TAG_RESP)
        h.update(nonce)
        h.update(struct.pack(">I", self.share_index))
        for r in sorted(self.responses, key=lambda r: r.dealer_index):
            h.update(struct.pack(">IB", r.dealer_index, r.status))
        return h.digest()


@dataclass
class Justification:
    share_index: int
    share: int            # the revealed plaintext share scalar


@dataclass
class JustificationBundle:
    dealer_index: int
    justifications: List[Justification]
    session_id: bytes = b""
    signature: bytes = b""

    def hash(self, nonce: bytes) -> bytes:
        h = hashlib.sha256(_TAG_JUST)
        h.update(nonce)
        h.update(struct.pack(">I", self.dealer_index))
        for j in sorted(self.justifications, key=lambda j: j.share_index):
            h.update(struct.pack(">I", j.share_index))
            h.update(j.share.to_bytes(32, "big"))
        return h.digest()


@dataclass
class DkgOutput:
    """Protocol result (kyber dkg.Result analogue, WaitDKG drand_beacon.go:182)."""
    qual: List[int]                 # qualified DEALER indices
    commits: List[bytes]            # final public polynomial (key_group points)
    share: Optional[PriShare]       # None for old nodes leaving at reshare

    def public_key(self) -> bytes:
        return self.commits[0]


# ---------------------------------------------------------------------------
# Deal-share encryption: static-DH stream cipher + HMAC
# ---------------------------------------------------------------------------

def _dh_key(scheme: Scheme, my_secret: int, their_pub: bytes,
            dealer_idx: int, holder_idx: int, nonce: bytes) -> bytes:
    g = scheme.key_group
    shared = g.curve.mul(g.from_bytes(their_pub), my_secret)
    h = hashlib.sha256(_TAG_ENC)
    h.update(g.to_bytes(shared))
    h.update(struct.pack(">II", dealer_idx, holder_idx))
    h.update(nonce)
    return h.digest()


def _stream_xor(key: bytes, data: bytes) -> bytes:
    out = bytearray()
    counter = 0
    while len(out) < len(data):
        out += hashlib.sha256(key + struct.pack(">I", counter)).digest()
        counter += 1
    return bytes(a ^ b for a, b in zip(data, out))


def _encrypt_share(scheme, dealer_secret, holder_pub, dealer_idx, holder_idx,
                   nonce, share: int) -> bytes:
    key = _dh_key(scheme, dealer_secret, holder_pub, dealer_idx, holder_idx, nonce)
    ct = _stream_xor(key, share.to_bytes(32, "big"))
    return ct + _hmac.new(key, ct, hashlib.sha256).digest()


def _decrypt_share(scheme, holder_secret, dealer_pub, dealer_idx, holder_idx,
                   nonce, blob: bytes) -> Optional[int]:
    if len(blob) != 64:
        return None
    ct, mac = blob[:32], blob[32:]
    key = _dh_key(scheme, holder_secret, dealer_pub, dealer_idx, holder_idx, nonce)
    if not _hmac.compare_digest(mac, _hmac.new(key, ct, hashlib.sha256).digest()):
        return None
    return int.from_bytes(_stream_xor(key, ct), "big") % R


# ---------------------------------------------------------------------------
# The state machine
# ---------------------------------------------------------------------------

class DkgError(Exception):
    pass


class DistKeyGenerator:
    """One node's view of a DKG/reshare session.

    Drive it: generate_deals() → (exchange) → process_deal_bundles() →
    (exchange) → process_response_bundles() → finished, or → (exchange
    justifications) → process_justification_bundles().
    """

    def __init__(self, cfg: DkgConfig):
        self.cfg = cfg
        self.scheme = cfg.scheme
        self.is_resharing = cfg.old_nodes is not None
        self.dealers = cfg.old_nodes if self.is_resharing else cfg.new_nodes
        self.holders = cfg.new_nodes
        g = self.scheme.key_group
        my_pub = g.to_bytes(g.curve.mul(g.curve.gen, cfg.longterm))
        self.dealer_index = next(
            (n.index for n in self.dealers if n.public == my_pub), None)
        self.holder_index = next(
            (n.index for n in self.holders if n.public == my_pub), None)
        if self.dealer_index is None and self.holder_index is None:
            raise DkgError("our key is in neither the dealer nor holder set")
        if self.is_resharing:
            if not cfg.public_coeffs:
                raise DkgError("resharing requires the old public polynomial")
            self.old_pub = PubPoly.from_bytes(g, b"".join(cfg.public_coeffs))
            if self.dealer_index is not None and cfg.share is None:
                raise DkgError("resharing dealer requires its old share")
        else:
            self.old_pub = None
        # dealer state
        self._poly: Optional[PriPoly] = None
        self._my_bundle: Optional[DealBundle] = None
        # received state
        self._deal_bundles: Dict[int, DealBundle] = {}
        self._my_shares: Dict[int, int] = {}      # dealer idx -> plaintext share
        self._valid_dealers: set = set()           # produced a verifiable bundle
        self._complaints: Dict[int, set] = {}      # dealer idx -> {holder idx}
        self._responses_seen: set = set()
        self.output: Optional[DkgOutput] = None

    # -- phase 1: deals ------------------------------------------------------

    def generate_deals(self) -> Optional[DealBundle]:
        """Deal our polynomial to every share holder (None if not a dealer)."""
        if self.dealer_index is None:
            return None
        if self.is_resharing:
            # constant term = our old share ⇒ public key is preserved
            self._poly = PriPoly.random(self.cfg.threshold,
                                        secret=self.cfg.share.value)
        else:
            self._poly = PriPoly.random(self.cfg.threshold)
        pub = self._poly.commit(self.scheme.key_group)
        commits = [self.scheme.key_group.to_bytes(c) for c in pub.commits]
        deals = []
        for n in self.holders:
            share = self._poly.eval(n.index).value
            deals.append(Deal(n.index, _encrypt_share(
                self.scheme, self.cfg.longterm, n.public,
                self.dealer_index, n.index, self.cfg.nonce, share)))
        bundle = DealBundle(self.dealer_index, commits, deals,
                            session_id=self.cfg.nonce)
        bundle.signature = schnorr.sign(self.scheme.key_group,
                                        self.cfg.longterm,
                                        bundle.hash(self.cfg.nonce))
        self._my_bundle = bundle
        return bundle

    def _dealer(self, idx: int) -> Optional[DkgNode]:
        return next((n for n in self.dealers if n.index == idx), None)

    def _check_bundle_sig(self, bundle, sender: DkgNode) -> bool:
        return schnorr.verify(self.scheme.key_group, sender.public,
                              bundle.hash(self.cfg.nonce), bundle.signature)

    def process_deal_bundles(self, bundles: Sequence[DealBundle]
                             ) -> Optional[ResponseBundle]:
        """Verify every dealer's bundle; produce our FastSync response bundle
        (a status per dealer).  Returns None if we hold no share.

        Committee scale: the two O(n·t) scalar-mul loops — the reshare
        constant-term pin and the share-vs-commitment check — run as ONE
        batched device dispatch each once the session crosses
        `dkg_device.MIN_N` lanes (verdicts bit-identical to the host
        loops, which run below it)."""
        staged = []     # (bundle, dealer, pub) past the cheap checks
        staged_dealers = set()      # in-batch dedup: the FIRST bundle per
        # dealer wins, exactly as when insertion happened inside the loop
        # (an equivocating dealer must not get bundle B stored while the
        # share was decrypted from bundle A)
        for b in bundles:
            dealer = self._dealer(b.dealer_index)
            if dealer is None or b.dealer_index in self._deal_bundles \
                    or b.dealer_index in staged_dealers:
                continue
            if len(b.commits) != self.cfg.threshold:
                continue
            if not self._check_bundle_sig(b, dealer):
                continue
            try:
                pub = PubPoly.from_bytes(self.scheme.key_group,
                                         b"".join(b.commits))
            except (ValueError, AssertionError):
                continue
            staged.append((b, dealer, pub))
            staged_dealers.add(b.dealer_index)
        if self.is_resharing and staged:
            # dealer's constant-term commitment must equal its public old
            # share g^{s_d} = oldPubPoly.eval(d) — otherwise it is trying
            # to change the collective key
            ok = self._constant_terms_ok(staged)
            staged = [entry for entry, good in zip(staged, ok) if good]
        candidates = []     # (bundle, pub, decrypted share)
        for b, dealer, pub in staged:
            self._deal_bundles[b.dealer_index] = b
            self._valid_dealers.add(b.dealer_index)
            if self.holder_index is not None:
                share = self._decrypt_own(b, dealer)
                if share is not None:
                    candidates.append((b, pub, share))
        self._adopt_matching_shares(candidates)
        if self.holder_index is None:
            return None
        responses = []
        for d in self.dealers:
            ok = d.index in self._my_shares
            responses.append(Response(
                d.index, STATUS_SUCCESS if ok else STATUS_COMPLAINT))
        rb = ResponseBundle(self.holder_index, responses,
                            session_id=self.cfg.nonce)
        rb.signature = schnorr.sign(self.scheme.key_group, self.cfg.longterm,
                                    rb.hash(self.cfg.nonce))
        return rb

    def _constant_terms_ok(self, staged) -> list:
        """Per-bundle reshare pin verdicts; one device dispatch above the
        lane threshold, else the host loop."""
        from . import dkg_device
        g = self.scheme.key_group
        if dkg_device.use_device(len(staged)):
            claimed = [g.from_bytes(b.commits[0]) for b, _, _ in staged]
            return dkg_device.constant_terms_match(
                g, list(self.old_pub.commits),
                [b.dealer_index for b, _, _ in staged], claimed,
                device=self.cfg.device)
        return [g.to_bytes(self.old_pub.eval(b.dealer_index)) == b.commits[0]
                for b, _, _ in staged]

    def _decrypt_own(self, b: DealBundle, dealer: DkgNode) -> Optional[int]:
        deal = next((d for d in b.deals if d.share_index == self.holder_index),
                    None)
        if deal is None:
            return None
        return _decrypt_share(self.scheme, self.cfg.longterm, dealer.public,
                              b.dealer_index, self.holder_index,
                              self.cfg.nonce, deal.encrypted)

    def _adopt_matching_shares(self, candidates) -> None:
        """Adopt every decrypted share that matches its dealer's
        commitments — the O(n·t) hot loop of a large DKG, batched to one
        dispatch for all n dealers' bundles on the device path."""
        if not candidates:
            return
        from . import dkg_device
        if dkg_device.use_device(len(candidates)):
            ok = dkg_device.verify_shares(
                self.scheme.key_group,
                [list(pub.commits) for _, pub, _ in candidates],
                self.holder_index, [s for _, _, s in candidates],
                device=self.cfg.device)
        else:
            ok = [self._share_matches(pub, self.holder_index, s)
                  for _, pub, s in candidates]
        for (b, _, share), good in zip(candidates, ok):
            if good:
                self._my_shares[b.dealer_index] = share

    def _share_matches(self, pub: PubPoly, holder_idx: int, share: int) -> bool:
        g = self.scheme.key_group.curve
        return g.mul(g.gen, share) == pub.eval(holder_idx)

    # -- phase 2: responses --------------------------------------------------

    def process_response_bundles(self, bundles: Sequence[ResponseBundle]
                                 ) -> Tuple[Optional[DkgOutput],
                                            Optional[JustificationBundle]]:
        """Tally complaints.  If none (and enough dealers) the DKG finishes
        here (FastSync happy path); otherwise dealers under complaint emit a
        justification bundle revealing the disputed plaintext shares."""
        holder_ids = {n.index for n in self.holders}
        for rb in bundles:
            if rb.share_index not in holder_ids:
                continue
            if rb.share_index in self._responses_seen:
                continue
            holder = next(n for n in self.holders
                          if n.index == rb.share_index)
            if not self._check_bundle_sig(rb, holder):
                continue
            self._responses_seen.add(rb.share_index)
            for r in rb.responses:
                if r.status == STATUS_COMPLAINT:
                    self._complaints.setdefault(r.dealer_index,
                                                set()).add(rb.share_index)
        # dealers that never produced a valid bundle can't be justified; only
        # complaints against valid dealers keep the justification phase alive
        pending = {d: hs for d, hs in self._complaints.items()
                   if d in self._valid_dealers and hs}
        if not pending:
            self.output = self._finalize()
            return self.output, None
        just = None
        if self.dealer_index is not None and self.dealer_index in pending:
            justs = [Justification(h, self._poly.eval(h).value)
                     for h in sorted(pending[self.dealer_index])]
            just = JustificationBundle(self.dealer_index, justs,
                                       session_id=self.cfg.nonce)
            just.signature = schnorr.sign(self.scheme.key_group,
                                          self.cfg.longterm,
                                          just.hash(self.cfg.nonce))
        return None, just

    # -- phase 3: justifications --------------------------------------------

    def process_justification_bundles(self, bundles: Sequence[JustificationBundle]
                                      ) -> DkgOutput:
        """Resolve complaints: a revealed share that matches the dealer's
        commitments dismisses the complaint (and the complainer adopts it);
        anything else disqualifies the dealer."""
        for jb in bundles:
            dealer = self._dealer(jb.dealer_index)
            if dealer is None or jb.dealer_index not in self._valid_dealers:
                continue
            if not self._check_bundle_sig(jb, dealer):
                continue
            b = self._deal_bundles[jb.dealer_index]
            pub = PubPoly.from_bytes(self.scheme.key_group, b"".join(b.commits))
            open_complaints = self._complaints.get(jb.dealer_index, set())
            for j in jb.justifications:
                if j.share_index not in open_complaints:
                    continue
                if self._share_matches(pub, j.share_index, j.share % R):
                    open_complaints.discard(j.share_index)
                    if j.share_index == self.holder_index:
                        self._my_shares[jb.dealer_index] = j.share % R
        self.output = self._finalize()
        return self.output

    # -- finalization --------------------------------------------------------

    def _qual(self) -> List[int]:
        return sorted(d for d in self._valid_dealers
                      if not self._complaints.get(d))

    def _finalize(self) -> DkgOutput:
        qual = self._qual()
        need = self.cfg.old_threshold if self.is_resharing else self.cfg.threshold
        if len(qual) < need:
            raise DkgError(f"too few qualified dealers: {len(qual)} < {need}")
        g = self.scheme.key_group
        curve = g.curve
        from . import dkg_device
        if self.is_resharing:
            # Lagrange-combine the dealt polynomials at the OLD indices so
            # the constant term interpolates back to the collective secret;
            # every node truncates the sorted QUAL the same way, so all
            # nodes combine the same dealer subset.
            qual = qual[:need]
            lams = {d: _lagrange_coeff(qual, d) for d in qual}
            if dkg_device.use_device(len(qual)):
                # batched Lagrange recovery of the public polynomial:
                # ONE dispatch over |qual| x t lanes instead of the
                # host's |qual|·t sequential scalar muls
                matrix = [[g.from_bytes(c)
                           for c in self._deal_bundles[d].commits]
                          for d in qual]
                combined = dkg_device.combine_commits(
                    g, matrix, [lams[d] for d in qual],
                    device=self.cfg.device)
                commits = [g.to_bytes(c) for c in combined]
            else:
                commits = []
                for j in range(self.cfg.threshold):
                    acc = None
                    for d in qual:
                        c = g.from_bytes(self._deal_bundles[d].commits[j])
                        acc = curve.add(acc, curve.mul(c, lams[d]))
                    commits.append(g.to_bytes(acc))
            share = None
            if self.holder_index is not None:
                missing = [d for d in qual if d not in self._my_shares]
                if missing:
                    raise DkgError(f"missing shares from dealers {missing}")
                val = sum(lams[d] * self._my_shares[d] for d in qual) % R
                share = PriShare(self.holder_index, val)
        else:
            if dkg_device.use_device(len(qual)):
                matrix = [[g.from_bytes(c)
                           for c in self._deal_bundles[d].commits]
                          for d in qual]
                commits_pts = dkg_device.combine_commits(
                    g, matrix, device=self.cfg.device)
            else:
                commits_pts = [None] * self.cfg.threshold
                for d in qual:
                    for j, c in enumerate(self._deal_bundles[d].commits):
                        commits_pts[j] = curve.add(commits_pts[j],
                                                   g.from_bytes(c))
            commits = [g.to_bytes(c) for c in commits_pts]
            share = None
            if self.holder_index is not None:
                missing = [d for d in qual if d not in self._my_shares]
                if missing:
                    raise DkgError(f"missing shares from dealers {missing}")
                val = sum(self._my_shares[d] for d in qual) % R
                share = PriShare(self.holder_index, val)
        return DkgOutput(qual=qual, commits=commits, share=share)
