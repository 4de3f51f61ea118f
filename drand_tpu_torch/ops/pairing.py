"""Optimal-ate pairing for BLS12-381 on tensors, batched.

Counterpart of drand_tpu/ops/pairing.py.  The Miller loop runs projective G2
steps with line coefficients (no inversions inside the loop) over the 63 bits
of |x| and conjugates at the end (x < 0); the final exponentiation uses the
BLS12 hard-part decomposition times 3.  Both dispatch to their kernels
(K3 ``kernels.miller_loop``, K4 ``kernels.final_exponentiation``); the
doubling/addition steps and the line product live beside the plain Miller
loop in kernels.py.
"""

import torch

from . import kernels
from . import tower as T


miller_loop = kernels.miller_loop
final_exponentiation = kernels.final_exponentiation


def fp12_prod_leading_axis(f):
    """Multiply an Fp12 batch down its leading axis (tree reduction)."""
    leaves = T.fp12_leaves(f)
    n = leaves[0].shape[0]
    while n > 1:
        half = n // 2
        a = T.fp12_pack([t[:half] for t in leaves])
        b = T.fp12_pack([t[half:2 * half] for t in leaves])
        s = T.fp12_leaves(T.fp12_mul(a, b))
        if n % 2:
            s = [torch.cat([x, t[2 * half:]], 0) for x, t in zip(s, leaves)]
        leaves = s
        n = half + (n % 2)
    return T.fp12_pack([t[0] for t in leaves])


def paired_product_is_one(px, py, q2, pair_axis_len: int):
    """prod over the leading axis of e(P_i, Q_i) == 1, in ONE Miller call.

    px, py: (k, ...) Fp limbs; q2 likewise.  The product collapses axis 0
    (the k pairs of one verification equation); the other axes stay
    batched."""
    f = miller_loop(px, py, q2)
    assert T.fp12_leaves(f)[0].shape[0] == pair_axis_len
    return T.fp12_is_one(final_exponentiation(fp12_prod_leading_axis(f)))
