"""Port G2 group law, endomorphisms, subgroup check, cofactor clearing and
K2's G2 plain version (drand_tpu_torch/ops/curve.py, kernels.py) vs the
JAX package.

Jacobian G2 points (random multiples of the generator, on-curve points
outside G2 and infinity, each scaled by a random z) are made from a numpy
seed and fed to both engines; coordinates must be equal limb for limb.
The fixed-scalar ladder goes through the JAX Pallas dispatch
(DRAND_TPU_PALLAS=1: on the CPU the plain lowering _ladder_fixed_direct of
the kernel's math), which is the route the port follows.  The GLV terms
(K8) and point sums (K7) are in test_torch_g2_glv.py and
test_torch_g2_sum.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from drand_tpu.crypto.host import curve as JHC
from drand_tpu.crypto.host import field as JHF
from drand_tpu.crypto.host.params import P, R, X
from drand_tpu.ops import curve as JC
from drand_tpu.ops import limbs as JL
from drand_tpu.ops import pallas_field as PF

from drand_tpu_torch import convert as CV
from drand_tpu_torch.crypto.host import curve as HC
from drand_tpu_torch.ops import curve as DC
from drand_tpu_torch.ops import kernels as K

RNG = np.random.default_rng(20240615)


def rand_int(mod):
    return int.from_bytes(RNG.bytes(48), "big") % mod


def off_subgroup_points(k):
    """On E2 (y^2 = x^3 + 4(1 + u)), outside G2."""
    out, a = [], 1
    while len(out) < k:
        x = (a, 1)
        y = JHF.fp2_sqrt(JHF.fp2_add(JHF.fp2_mul(JHF.fp2_sqr(x), x), (4, 4)))
        if y is not None and not JHC.G2.in_subgroup((x, y)):
            out.append((x, y))
        a += 1
    return out


MEMBERS = [JHC.G2.mul(JHC.G2.gen, rand_int(R - 1) + 1) for _ in range(5)]
OUTSIDERS = off_subgroup_points(2)
AFFINE = MEMBERS + OUTSIDERS + [None]          # 8 lanes


def _mont(v):
    return np.asarray(JL.int_to_limbs(v * JL.R_MONT % P))


def jacobian_np(pts):
    """Affine G2 points -> ((X0, X1), (Y0, Y1), (Z0, Z1)) Montgomery limb
    arrays with a random z per lane (infinity = (1, 1, 0))."""
    cols = [[] for _ in range(6)]
    for pt in pts:
        if pt is None:
            x, y, z = (1, 0), (1, 0), (0, 0)
        else:
            z = (rand_int(P), rand_int(P))
            z2 = JHF.fp2_sqr(z)
            x = JHF.fp2_mul(pt[0], z2)
            y = JHF.fp2_mul(pt[1], JHF.fp2_mul(z2, z))
        for c, v in zip(cols, (*x, *y, *z)):
            c.append(_mont(v))
    c = [np.stack(col) for col in cols]
    return ((c[0], c[1]), (c[2], c[3]), (c[4], c[5]))


def affine_np(pts):
    """Affine G2 points (never None) -> ((x0, x1), (y0, y1)) limb arrays."""
    c = [np.stack([_mont(v) for v in col]) for col in
         zip(*[(p[0][0], p[0][1], p[1][0], p[1][1]) for p in pts])]
    return ((c[0], c[1]), (c[2], c[3]))


PA = jacobian_np(AFFINE)
PB = jacobian_np(MEMBERS[::-1] + [MEMBERS[0], None, OUTSIDERS[0]])


def jx(tree):
    return jax.tree.map(jnp.asarray, tree)


def flat(tree):
    return jax.tree.leaves(tree)


def same(jax_pt, port_pt):
    want, got = flat(jax_pt), flat(port_pt)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(CV.limbs_to_numpy(g), np.asarray(w))


def port(tree):
    return CV.tree_from_numpy(tree)


def test_double_matches_jax():
    same(jax.jit(JC.G2_DEV.double)(jx(PA)), DC.G2.double(port(PA)))


def _others(pts, fn):
    return [fn(p) if p is not None else MEMBERS[0] for p in pts]


@pytest.mark.parametrize("other", ["distinct", "equal", "negated"])
def test_complete_add_matches_jax(other):
    """PA holds infinity in lane 7; PB has infinity in lane 6; the 'equal'
    partners (other representatives) reach the doubling branch and the
    'negated' ones P == -Q."""
    q = {"distinct": PB,
         "equal": jacobian_np(_others(AFFINE, lambda p: p)),
         "negated": jacobian_np(_others(
             AFFINE, lambda p: (p[0], JHF.fp2_neg(p[1]))))}[other]
    got = DC.G2.add(port(PA), port(q))
    same(jax.jit(JC.G2_DEV.add)(jx(PA), jx(q)), got)
    if other == "negated":
        assert DC.G2.is_infinity(got)[:7].all()


@pytest.mark.parametrize("other", ["distinct", "equal", "negated"])
def test_add_mixed_matches_jax(other):
    q = {"distinct": MEMBERS[1:] + MEMBERS[:1] + OUTSIDERS[::-1]
         + [MEMBERS[3]],
         "equal": _others(AFFINE, lambda p: p),
         "negated": _others(AFFINE, lambda p: (p[0], JHF.fp2_neg(p[1])))
         }[other]
    q_aff = affine_np(q)
    got = DC.G2.add_mixed(port(PA), port(q_aff))
    same(jax.jit(JC.G2_DEV.add_mixed)(jx(PA), jx(q_aff)), got)


def test_to_affine_batch_matches_jax_and_host():
    got = DC.G2.to_affine_batch(port(PA))
    want = jax.jit(JC.G2_DEV.to_affine_batch)(jx(PA))
    same(want[:2], got[:2])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    ints = [CV.canonical_ints(c) for c in flat(got[:2])]
    for i, pt in enumerate(AFFINE):
        want_pt = pt if pt is not None else ((0, 0), (0, 0))
        assert ((ints[0][i], ints[1][i]), (ints[2][i], ints[3][i])) == want_pt


def test_psi_and_psi2_match_jax_and_host():
    same(jax.jit(JC.g2_psi)(jx(PA)), DC.g2_psi(port(PA)))
    same(jax.jit(JC.g2_psi2)(jx(PA)), DC.g2_psi2(port(PA)))
    lanes = DC.decode_g2_points(DC.g2_psi_lanes(port(PA)))
    n = len(AFFINE)
    psi = lambda p: HC.g2_psi(p)
    assert lanes[n:2 * n] == [psi(p) for p in AFFINE]
    assert lanes[3 * n:] == [psi(psi(psi(p))) for p in AFFINE]


def test_scalar_mul_fixed_matches_jax_pallas_dispatch(monkeypatch):
    """K2-G2's plain version (|x| ladder from infinity, then -) against
    the JAX Pallas route on the CPU."""
    monkeypatch.setenv("DRAND_TPU_PALLAS", "1")
    want = PF.scalar_mul_fixed("G2", jx(PA), X)
    same(want, DC.G2.scalar_mul_fixed(port(PA), X))


def test_subgroup_check_members_and_outsiders():
    got = DC.g2_in_subgroup(port(PA))
    assert got.tolist() == [True] * 5 + [False, False, True]


def test_clear_cofactor_matches_host():
    pts = MEMBERS[:2] + OUTSIDERS + [None]
    got = DC.decode_g2_points(DC.g2_clear_cofactor(port(jacobian_np(pts))))
    assert got == [HC.g2_clear_cofactor(p) for p in pts]
    assert all(JHC.G2.in_subgroup(p) for p in got if p is not None)


def test_g2_wrappers_count_only_kernel_launches():
    K.reset_launches()
    DC.G2.scalar_mul_fixed(port(PA), X)
    assert all(c == 0 for c in K.LAUNCHES.values())
