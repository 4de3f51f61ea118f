"""Port G1 group law (drand_tpu_torch/ops/curve.py) vs the JAX DevCurve.

Jacobian points (random multiples of the generator, on-curve points
outside G1 and infinity, each scaled by a random z) are made from a numpy
seed and fed to both.  Jacobian coordinates must be equal limb for limb:
the port has to produce the same representative, not just the same point.
Fixed-scalar ladders go through the JAX Pallas dispatch
(DRAND_TPU_PALLAS=1, on the CPU its plain lowering _ladder_fixed_direct)
and, in the port, through the K2 wrapper's plain version.
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

from drand_tpu_torch import convert as CV
from drand_tpu_torch.ops import curve as DC
from drand_tpu_torch.ops import kernels as K

RNG = np.random.default_rng(20240603)


def rand_int(mod):
    return int.from_bytes(RNG.bytes(48), "big") % mod


def off_subgroup_points(k):
    out, x = [], 1
    while len(out) < k:
        y = JHF.fp_sqrt((x ** 3 + 4) % P)
        if y is not None and not JHC.G1.in_subgroup((x, y)):
            out.append((x, y))
        x += 1
    return out


MEMBERS = [JHC.G1.mul(JHC.G1.gen, rand_int(R - 1) + 1) for _ in range(5)]
OUTSIDERS = off_subgroup_points(2)
AFFINE = MEMBERS + OUTSIDERS + [None]          # 8 lanes


def jacobian_np(pts):
    """Affine points -> Jacobian (X, Y, Z) Montgomery limb arrays with a
    random z per lane (infinity = (1, 1, 0))."""
    cols = ([], [], [])
    for pt in pts:
        if pt is None:
            vals = (1, 1, 0)
        else:
            z = rand_int(P - 1) + 1
            vals = (pt[0] * z * z % P, pt[1] * z * z * z % P, z)
        for c, v in zip(cols, vals):
            c.append(np.asarray(JL.int_to_limbs(v * JL.R_MONT % P)))
    return tuple(np.stack(c) for c in cols)


PA = jacobian_np(AFFINE)
PB = jacobian_np(MEMBERS[::-1] + [MEMBERS[0], None, OUTSIDERS[0]])
PA_AGAIN = jacobian_np(AFFINE)        # same points, other representatives


def jx(tree):
    return jax.tree.map(jnp.asarray, tree)


def same_point(jax_pt, port_pt):
    for w, g in zip(jax_pt, port_pt):
        np.testing.assert_array_equal(CV.limbs_to_numpy(g), np.asarray(w))


def test_double_matches_jax():
    same_point(jax.jit(JC.G1_DEV.double)(jx(PA)),
               DC.G1.double(CV.tree_from_numpy(PA)))


@pytest.mark.parametrize("other", ["distinct", "equal", "negated"])
def test_complete_add_matches_jax(other):
    q = {"distinct": PB, "equal": PA_AGAIN,
         "negated": None}[other]
    if q is None:
        q_port = DC.G1.neg(CV.tree_from_numpy(PA_AGAIN))
        q = CV.tree_to_numpy(q_port)
    same_point(jax.jit(JC.G1_DEV.add)(jx(PA), jx(q)),
               DC.G1.add(CV.tree_from_numpy(PA), CV.tree_from_numpy(q)))


def test_to_affine_matches_jax_and_host():
    jx_out = jax.jit(JC.G1_DEV.to_affine)(jx(PA))
    got = DC.G1.to_affine(CV.tree_from_numpy(PA))
    for w, g in zip(jx_out[:2], got[:2]):
        np.testing.assert_array_equal(CV.limbs_to_numpy(g), np.asarray(w))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jx_out[2]))
    xs, ys = CV.canonical_ints(got[0]), CV.canonical_ints(got[1])
    for pt, x, y in zip(AFFINE, xs, ys):
        assert (x, y) == (pt if pt is not None else (0, 0))


def test_eq_points_across_representatives():
    a, b = CV.tree_from_numpy(PA), CV.tree_from_numpy(PA_AGAIN)
    assert DC.G1.eq_points(a, b).all()
    got = DC.G1.eq_points(a, CV.tree_from_numpy(PB)).numpy()
    want = np.asarray(jax.jit(JC.G1_DEV.eq_points)(jx(PA), jx(PB)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("label,k", [("|x|", -X), ("1-x", 1 - X)])
def test_scalar_mul_fixed_matches_jax_pallas_dispatch(monkeypatch, label, k):
    monkeypatch.setenv("DRAND_TPU_PALLAS", "1")
    same_point(JC.G1_DEV.scalar_mul_fixed(jx(PA), k),
               DC.G1.scalar_mul_fixed(CV.tree_from_numpy(PA), k))


def test_negative_scalar_and_host_values():
    got = DC.G1.scalar_mul_fixed(CV.tree_from_numpy(PA), X)   # x < 0
    for pt, out in zip(AFFINE, DC.decode_g1_points(got)):
        assert out == JHC.G1.mul(pt, X) if pt is not None else out is None


def test_subgroup_check_members_and_outsiders(monkeypatch):
    monkeypatch.setenv("DRAND_TPU_PALLAS", "1")
    got = DC.g1_in_subgroup(CV.tree_from_numpy(PA)).numpy()
    assert got.tolist() == [True] * len(MEMBERS) + [False] * 2 + [True]
    want = np.asarray(JC.g1_in_subgroup(jx(PA)))
    np.testing.assert_array_equal(got, want)


def test_clear_cofactor_lands_in_g1(monkeypatch):
    monkeypatch.setenv("DRAND_TPU_PALLAS", "1")
    got = DC.g1_clear_cofactor(CV.tree_from_numpy(PA))
    same_point(JC.g1_clear_cofactor(jx(PA)), got)
    assert DC.g1_in_subgroup(got).all()


def test_ladder_wrapper_counts_only_kernel_launches():
    K.reset_launches()
    DC.G1.scalar_mul_fixed(CV.tree_from_numpy(PA), 3)
    assert K.LAUNCHES["scalar_mul_fixed"] == 0
