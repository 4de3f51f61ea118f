"""The port's G2 point sum (drand_tpu_torch/ops/kernels.py sum_points,
K7-G2's plain version) vs the JAX package.

Per tile the port must give the TPU kernel's Jacobian point limb for limb:
it is held against pallas_field._sum_tile_math("G2", ...) (the kernel's
math, lane 0 of its rotate-and-add), jitted at a width of 8 lanes.  A
256-lane tile whose lanes 8-255 are infinity sums to exactly that point:
an add with an infinite operand returns the other operand, so the levels
128 ... 8 leave lanes 0-7 as they are.  Two tiles fold with the JAX
complete add.  The XLA halving tree (JAX DevCurve.sum_points) associates
differently; it agrees as an affine point, and so does the host sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from drand_tpu.crypto.host import curve as JHC
from drand_tpu.crypto.host import field as JHF
from drand_tpu.ops import curve as JC
from drand_tpu.ops import pallas_field as PF

from drand_tpu_torch.ops import curve as DC
from drand_tpu_torch.ops import kernels as K

from test_torch_g2_curve import (MEMBERS, OUTSIDERS, jacobian_np, jx, port,
                                 same)

RNG = np.random.default_rng(20240617)
W = 8


def batch():
    """W lanes from members, outsiders and infinity, with a repeat (the
    doubling branch) and a member beside its negation (P == -Q)."""
    pool = MEMBERS + OUTSIDERS + [None]
    pts = [pool[i] for i in RNG.integers(0, len(pool), W)]
    pts[0], pts[1] = MEMBERS[0], (MEMBERS[0][0], JHF.fp2_neg(MEMBERS[0][1]))
    pts[2], pts[3] = MEMBERS[1], MEMBERS[1]
    return pts, jacobian_np(pts)


PTS0, JAC0 = batch()
PTS1, JAC1 = batch()


@pytest.fixture(scope="module")
def tile_math():
    """Lane 0 of the JAX kernel math over each W-lane batch."""
    run = jax.jit(lambda t: PF._sum_tile_math("G2", t))
    lanes = lambda jac: jax.tree.map(lambda c: jnp.asarray(c.T), jac)
    return [jax.tree.map(lambda x: x[:, 0], run(lanes(j)))
            for j in (JAC0, JAC1)]


def test_one_tile_matches_tile_math(tile_math):
    got = K.sum_points(port(JAC0))             # padded to one 256-lane tile
    same(tile_math[0], got)


def test_two_tiles_fold_matches_tile_math_and_jax_add(tile_math):
    pad = lambda jac: jax.tree.map(
        lambda c: np.concatenate([c, np.zeros((K.TILE - W, 24), c.dtype)]),
        jac)
    two = jax.tree.map(lambda a, b: np.concatenate([a, b]), pad(JAC0),
                       pad(JAC1))
    K.reset_launches()
    got = K.sum_points(port(two))
    assert all(c == 0 for c in K.LAUNCHES.values())   # plain versions only
    same(jax.jit(JC.G2_DEV.add)(*tile_math), got)


def test_matches_xla_tree_and_host_as_affine_points():
    got = K.sum_points(port(JAC0))
    xla = jax.jit(JC.G2_DEV.sum_points)(jx(JAC0))
    acc = None
    for p in PTS0:
        acc = JHC.G2.add(acc, p)
    one = lambda pt: DC._tmap(lambda t: t[None], pt)
    assert DC.decode_g2_points(one(got)) == JC.decode_g2_points(xla) == [acc]
