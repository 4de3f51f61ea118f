"""Carry state between the JAX package and the port.

The JAX engine holds Fp elements as ``(..., 24)`` uint32 numpy/JAX arrays of
16-bit limbs in Montgomery form (R = 2^384); the port holds the same limbs
as int64 tensors.  These helpers move a verifier's state, a batch encoding
and the kernels' constant bundle across, so both engines run on identical
inputs, and bring port results back as numpy or canonical integers.

Only numpy crosses the boundary: this module imports neither package's
device code, so either side can hand it arrays.
"""

import numpy as np
import torch

from .crypto.host.params import P
from .ops import limbs as L


def limbs_from_numpy(arr, device="cpu") -> torch.Tensor:
    """(..., 24) uint32 limb array (numpy or JAX) -> int64 limb tensor."""
    a = np.asarray(arr)
    assert a.shape[-1] == L.NLIMB, a.shape
    return torch.from_numpy(a.astype(np.int64)).to(device)


def limbs_to_numpy(t) -> np.ndarray:
    """int64 limb tensor -> (..., 24) uint32 numpy array (the JAX layout)."""
    return t.detach().cpu().numpy().astype(np.uint32)


def tree_from_numpy(tree, device="cpu"):
    """Nested tuples of limb arrays -> the same nesting of tensors: an Fp2
    element (c0, c1), a G2 affine point ((x0, x1), (y0, y1)) or Jacobian
    point ((X0, X1), (Y0, Y1), (Z0, Z1)), a G1 point (X, Y, Z)."""
    if isinstance(tree, (tuple, list)):
        return tuple(tree_from_numpy(t, device) for t in tree)
    return limbs_from_numpy(tree, device)


def tree_to_numpy(tree):
    if isinstance(tree, (tuple, list)):
        return tuple(tree_to_numpy(t) for t in tree)
    return limbs_to_numpy(tree)


def canonical_ints(t) -> list:
    """Montgomery limb tensor or array -> flat list of canonical ints."""
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)
    return [x * L.R_INV % P for x in L.limbs_to_ints(a.astype(np.int64))]


def verifier_state(jax_verifier, device="cpu") -> dict:
    """A JAX BatchBeaconVerifier's key state as port tensors: the public
    key's and the fixed generator's (-g2 for G1 signatures, -g1 for G2
    signatures) affine Montgomery coordinates."""
    return {"pk_aff": tree_from_numpy(jax_verifier.pk_aff, device),
            "fixed_aff": tree_from_numpy(jax_verifier.fixed_aff, device)}


def encoding(enc, device="cpu"):
    """The JAX ``BatchBeaconVerifier._encode`` batch encoding
    (sig_x, sign, u0, u1) -> port tensors (sign flags as int64).  For G2
    signatures sig_x is the (x0, x1) pair and u0, u1 are Fp2 pairs."""
    sig_x, sign, u0, u1 = enc
    return (tree_from_numpy(sig_x, device),
            torch.from_numpy(np.asarray(sign).astype(np.int64)).to(device),
            tree_from_numpy(u0, device), tree_from_numpy(u1, device))


def rlc_bits(planes, device="cpu"):
    """The JAX package's RLC bit planes in split form (``_rlc_scalars(n,
    pad, split)``: split=2 gives two (64, pad) uint32 arrays, split=4 four
    (32, pad), MSB first) -> the int32 planes the port's
    ``_rlc_run_g1sig`` / ``_rlc_run_g2sig(..., bits=)`` take."""
    return tuple(torch.from_numpy(np.asarray(b).astype(np.int32)).to(device)
                 for b in planes)


def const_bundle(entries, device="cpu") -> torch.Tensor:
    """The JAX kernels' field-constant bundle (pallas_field._const_entries:
    a list of (name, (24,) limbs)) -> a (K, 24) int64 tensor in the row
    order the port's pairing kernels read (kernels.CONST_NAMES)."""
    from .ops.kernels import CONST_NAMES
    names = [name for name, _ in entries]
    if names != CONST_NAMES:
        raise ValueError(f"constant bundle rows differ: {names}")
    return torch.from_numpy(
        np.stack([np.asarray(v) for _, v in entries]).astype(np.int64)
    ).to(device)


def partials_state(jax_partial_verifier, device="cpu") -> dict:
    """A JAX BatchPartialVerifier's state as port tensors: the n public
    shares' affine Montgomery coordinates (pk_x, pk_y: (n, 24) on G1, Fp2
    pairs of them on G2) and the fixed generator's (-g1 or -g2)."""
    v = jax_partial_verifier
    return {"pk_x": tree_from_numpy(v.pk_x, device),
            "pk_y": tree_from_numpy(v.pk_y, device),
            "fixed_aff": tree_from_numpy(v.fixed_aff, device)}


def pub_poly(jax_pub_poly, group):
    """A JAX host PubPoly -> the port's PubPoly over `group` (the port's
    GroupG1 or GroupG2) with the same commitments (host affine points)."""
    from .crypto.host.tbls import PubPoly
    return PubPoly(group, list(jax_pub_poly.commits))


def glv_digits(bits, neg, device="cpu"):
    """The JAX package's signed GLV digits (``glv_decompose_g1/g2``: bits
    (nbits, lanes, n) and neg (lanes, n), uint32) -> int32 tensors."""
    to = lambda a: torch.from_numpy(np.asarray(a).astype(np.int32)).to(device)
    return to(bits), to(neg)
