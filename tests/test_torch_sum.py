"""Port point sum (drand_tpu_torch/ops/kernels.py sum_points, K7's plain
version) vs the JAX package.

Per tile the port must give the TPU kernel's Jacobian point limb for limb:
it is held against pallas_field._sum_tile_math (the kernel's math, lane 0
of its rotate-and-add) driven tile by tile, with 2-4 partials folded by
the JAX complete add.  On the CPU the JAX DevCurve.sum_points is the XLA
halving tree over the whole batch (the Pallas sum returns None off the
TPU), another association of the same adds: above four tiles the two
agree as affine points, and both agree with the host sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from drand_tpu.crypto.host import curve as JHC
from drand_tpu.crypto.host.params import P
from drand_tpu.ops import curve as JC
from drand_tpu.ops import pallas_field as PF

from drand_tpu_torch import convert as CV
from drand_tpu_torch.ops import curve as DC
from drand_tpu_torch.ops import kernels as K

from test_torch_curve import MEMBERS, OUTSIDERS, jacobian_np

RNG = np.random.default_rng(20240612)


def batch(n):
    """n lanes drawn from members, outsiders and infinity (repeats reach
    the doubling branch of the add), with a member and its negation."""
    pool = MEMBERS + OUTSIDERS + [None]
    pts = [pool[i] for i in RNG.integers(0, len(pool), n)]
    if n > 1:
        pts[0], pts[1] = MEMBERS[0], (MEMBERS[0][0], -MEMBERS[0][1] % P)
    return pts, jacobian_np(pts)


def jax_tile_sums(jac):
    """pallas_field._sum_tile_math over each 256-lane tile (eager: its
    jit compile on the CPU takes longer than the eager run), lane 0."""
    lanes = [np.asarray(c).T for c in jac]                  # (24, B)
    sums = []
    for i in range(0, lanes[0].shape[1], K.TILE):
        tile = tuple(jnp.asarray(c[:, i:i + K.TILE]) for c in lanes)
        sums.append(tuple(x[:, 0] for x in PF._sum_tile_math("G1", tile)))
    return sums


def same(jax_pt, port_pt):
    for w, g in zip(jax_pt, port_pt):
        np.testing.assert_array_equal(CV.limbs_to_numpy(g), np.asarray(w))


def test_one_tile_matches_tile_math():
    _, jac = batch(K.TILE)
    (want,) = jax_tile_sums(jac)
    port = CV.tree_from_numpy(jac)
    same(want, tuple(c[0] for c in K.sum_tiles(port)))
    same(want, K.sum_points(port))


def test_two_tiles_fold_matches_tile_math_and_jax_add():
    _, jac = batch(2 * K.TILE)
    t0, t1 = jax_tile_sums(jac)
    want = jax.jit(JC.G1_DEV.add)(t0, t1)
    same(want, K.sum_points(CV.tree_from_numpy(jac)))


def test_many_tiles_match_xla_tree_as_affine_points():
    pts, jac = batch(5 * K.TILE)
    got = K.sum_points(CV.tree_from_numpy(jac))
    want = jax.jit(JC.G1_DEV.sum_points)(tuple(jnp.asarray(c) for c in jac))
    host = None
    for pt in pts:
        host = JHC.G1.add(host, pt)
    (got_aff,) = DC.decode_g1_points(tuple(c[None] for c in got))
    (want_aff,) = JC.decode_g1_points(tuple(w[None] for w in want))
    assert got_aff == want_aff == host


@pytest.mark.parametrize("n", [1, 3])
def test_narrow_batches_pad_with_infinity(n):
    pts, jac = batch(n)
    host = None
    for pt in pts:
        host = JHC.G1.add(host, pt)
    got = K.sum_points(CV.tree_from_numpy(jac))
    assert DC.decode_g1_points(tuple(c[None] for c in got)) == [host]


def test_sum_tiles_rejects_a_ragged_width():
    """The kernel reads whole tiles: a width that is not a multiple of the
    tile raises before any launch (sum_points pads with infinity)."""
    _, jac = batch(100)
    with pytest.raises(ValueError, match="multiple of 256"):
        K.sum_tiles(CV.tree_from_numpy(jac))
