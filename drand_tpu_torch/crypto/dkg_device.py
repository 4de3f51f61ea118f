"""Batched device DKG and reshare math.

Counterpart of drand_tpu/crypto/dkg_device.py.  The host DKG state machine
(crypto/dkg.py) is O(n·t) sequential scalar multiplications in three
places, all of them parallel across participants:

  * share verification: every holder checks each dealer's decrypted share
    against that dealer's polynomial commitments,
    ``g·s_d == Σ_j x^j C_{d,j}``.  One dispatch for all m dealers: a Horner
    ladder in the exponent lane-parallel over dealers (each step a 16-bit
    K6 ladder by the small evaluation point x = holder_index + 1, which a
    be16 share index bounds, then one complete add), one 256-bit K6
    ladder for ``g·s_d``, and a projective equality.
  * the reshare constant-term pin: each dealer's ``C_{d,0}`` must equal
    ``oldPubPoly.eval(dealer_index)``, one polynomial evaluated at m
    per-lane points by the same Horner with per-lane x bits.
  * finalization: ``commits[j] = Σ_d λ_d · C_{d,j}`` on a reshare (one
    256-bit K6 launch over t·m lanes, λ's bits repeated across a dealer's
    t coefficients) or the plain sum on a fresh DKG, then a halving tree of
    complete adds over the dealers, the odd leftover carried.

Verdicts and points equal the host loops' (deserialized commitments are
subgroup-checked, so the unreduced small-x Horner multiplier equals the
host's ``x^j mod r`` powers; the complete adds absorb infinity).

Which path runs when.  ``use_device(n)`` routes a call of n lanes: below
``MIN_N`` (``DRAND_DKG_DEVICE_MIN_N``, default 64) the state machine runs
its host loops, because there n·t host multiplications cost less than a
dispatch; ``DRAND_DKG_DEVICE=0`` keeps every session on the host.  At or
above it the functions below run on the resolved device: CUDA unless the
caller passes ``device="cpu"`` (the plain PyTorch versions of the kernels,
as the tests run them).  Without a card and without ``device="cpu"`` they
raise (``batch.resolve_device``); they never drop quietly to the host
loop.  ``dispatch_count()`` counts the calls that reached a device.
"""

import os
from typing import Dict, List, Optional, Sequence

import torch

from ..common import make_lock
from ..ops import curve as DC
from .batch import resolve_device
from .host.params import R

MIN_N = int(os.environ.get("DRAND_DKG_DEVICE_MIN_N", "64"))
_ENABLED = os.environ.get("DRAND_DKG_DEVICE", "1") != "0"

# the evaluation point rides a be16 share index (tbls wire format), so 16
# ladder bits cover x = index + 1
X_BITS = 16

_lock = make_lock()
_dispatches = 0


def _count_dispatch() -> None:
    global _dispatches
    with _lock:
        _dispatches += 1


def dispatch_count() -> int:
    """Device dispatches so far (test and smoke-run hook)."""
    with _lock:
        return _dispatches


def available() -> bool:
    """The env switch: False only under ``DRAND_DKG_DEVICE=0``.  Whether a
    card is there is not asked here: a device call without one raises."""
    return _ENABLED


def use_device(n_lanes: int, min_n: Optional[int] = None) -> bool:
    """Routing predicate: batch on the device once a call crosses the size
    threshold (below it, host scalar multiplications beat a dispatch)."""
    floor = MIN_N if min_n is None else min_n
    return floor > 0 and n_lanes >= floor and available()


# ---------------------------------------------------------------------------
# host <-> device plumbing
# ---------------------------------------------------------------------------

def _is_g2(group) -> bool:
    return group.point_len == 96


def _curve(group):
    return DC.G2 if _is_g2(group) else DC.G1


def _encode(group, pts, device):
    return (DC.encode_g2_points if _is_g2(group)
            else DC.encode_g1_points)(pts, device)


def _decode(group, dev_pts):
    return (DC.decode_g2_points if _is_g2(group)
            else DC.decode_g1_points)(dev_pts)


def _bits(ks: Sequence[int], nbits: int, device):
    return torch.from_numpy(DC.scalars_to_bits(list(ks), nbits)).to(device)


def _matrix(group, commits_matrix, device):
    """m dealers' t commitments each -> one point of batch (t, m), lane
    (j, d) holding C_{d,j} (coefficient-major)."""
    m, t = len(commits_matrix), len(commits_matrix[0])
    if any(len(c) != t for c in commits_matrix):
        raise ValueError("ragged commit lists")
    flat = [commits_matrix[d][j] for j in range(t) for d in range(m)]
    return DC._tmap(lambda l: l.reshape(t, m, l.shape[-1]),
                    _encode(group, flat, device))


def _horner(curve, pts, xbits):
    """Σ_j x^j C_j lane by lane: pts of batch (t, m), xbits (X_BITS, m).
    Per step one K6 launch at X_BITS and one complete add."""
    coeff = lambda j: DC._tmap(lambda l: l[j], pts)   # noqa: E731
    t = DC._leaf(pts[0]).shape[0]
    acc = coeff(t - 1)
    for j in range(t - 2, -1, -1):
        acc = curve.add(curve.scalar_mul_bits(acc, xbits), coeff(j))
    return acc


# ---------------------------------------------------------------------------
# public surface (host types in, host types out)
# ---------------------------------------------------------------------------

def verify_shares(group, commits_list: List[List[object]],
                  holder_index: int, shares: Sequence[int],
                  device=None) -> List[bool]:
    """One dispatch: for each dealer d, does ``gen·shares[d]`` equal the
    dealer's public polynomial evaluated at this holder?  `commits_list`
    holds each dealer's commitments as host points (uniform length t);
    verdicts equal `dkg.DistKeyGenerator._share_matches`."""
    m = len(commits_list)
    if m == 0:
        return []
    device = resolve_device(device)
    curve = _curve(group)
    pts = _matrix(group, commits_list, device)
    xbits = _bits([holder_index + 1] * m, X_BITS, device)
    gen = _encode(group, [group.curve.gen] * m, device)
    share_bits = _bits([s % R for s in shares], 256, device)
    _count_dispatch()
    rhs = _horner(curve, pts, xbits)
    lhs = curve.scalar_mul_bits(gen, share_bits)
    return [bool(v) for v in curve.eq_points(lhs, rhs).cpu().tolist()]


def eval_all(group, commits: List[object], indices: Sequence[int],
             device=None) -> List[object]:
    """One dispatch: one public polynomial evaluated at every index in
    `indices` (x = index + 1).  Returns host affine points (None =
    infinity): e.g. all n public shares of a committee, where the host
    loop was n·t scalar multiplications (`PubPoly.eval` per signer)."""
    indices = list(indices)
    if not indices:
        return []
    device = resolve_device(device)
    m = len(indices)
    # the t commitments broadcast to m lanes each
    pts = DC._tmap(lambda l: l[:, None].expand(-1, m, -1),
                   _encode(group, list(commits), device))
    xbits = _bits([i + 1 for i in indices], X_BITS, device)
    _count_dispatch()
    return _decode(group, _horner(_curve(group), pts, xbits))


def constant_terms_match(group, old_commits: List[object],
                         dealer_indices: Sequence[int],
                         claimed: Sequence[object], device=None
                         ) -> List[bool]:
    """One dispatch (plus host compares): the reshare pin, dealer d's
    constant-term commitment must equal ``oldPubPoly.eval(d)``.  `claimed`
    holds each dealer's C_{d,0} as a host point."""
    evals = eval_all(group, old_commits, dealer_indices, device)
    return [e == c for e, c in zip(evals, claimed)]


def combine_commits(group, commits_matrix: List[List[object]],
                    lams: Optional[Sequence[int]] = None,
                    device=None) -> List[object]:
    """One dispatch: the finalization combine.  With `lams`,
    ``commits[j] = Σ_d λ_d·C_{d,j}`` (reshare: Lagrange recovery of the
    public polynomial); without, the plain per-coefficient sum (fresh
    DKG).  Returns t host affine points."""
    m = len(commits_matrix)
    if m == 0:
        return []
    device = resolve_device(device)
    curve = _curve(group)
    t = len(commits_matrix[0])
    pts = _matrix(group, commits_matrix, device)
    _count_dispatch()
    if lams is not None:
        bits = _bits([l % R for l in lams], 256, device).repeat(1, t)
        flat = DC._tmap(lambda l: l.reshape(t * m, l.shape[-1]), pts)
        pts = DC._tmap(lambda l: l.reshape(t, m, l.shape[-1]),
                       curve.scalar_mul_bits(flat, bits))
    # dealers on the leading axis: DevCurve.sum_points runs the halving
    # tree of complete adds over it, the odd leftover carried
    # (dkg_device._reduce_dealers of the JAX package)
    by_dealer = DC._tmap(lambda l: l.transpose(0, 1), pts)
    return _decode(group, curve.sum_points(by_dealer))


def prime_public_shares(pub_poly, n_nodes: int,
                        device=None) -> Dict[int, object]:
    """Every signer's public share in one dispatch, prefilled into the
    PubPoly eval memo (`PubPoly.prime`), so the host partial verifier and
    `crypto/partials.BatchPartialVerifier` setup stop being n·t host
    scalar multiplications at committee scale.  Returns index -> point."""
    pts = eval_all(pub_poly.group, list(pub_poly.commits), range(n_nodes),
                   device)
    mapping = dict(enumerate(pts))
    pub_poly.prime(mapping)
    return mapping
