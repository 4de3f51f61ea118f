"""Port mixed add, batch inversion and the GLV-split RLC multiplication
(drand_tpu_torch/ops/curve.py, K8's plain version) vs the JAX package.

Inputs are made from a numpy seed and fed to both engines; Jacobian
coordinates must be equal limb for limb.  The JAX GLV terms run through
its Pallas dispatch (DRAND_TPU_PALLAS=1: on the CPU the plain lowering
_ladder_glv_mixed_direct of the kernel's math), which is the route the
port follows: affine tables, complete mixed adds, start at infinity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from drand_tpu.crypto.host import curve as JHC
from drand_tpu.crypto.host.params import P, R, X
from drand_tpu.ops import curve as JC
from drand_tpu.ops import limbs as JL
from drand_tpu.ops import pallas_field as PF

from drand_tpu_torch import convert as CV
from drand_tpu_torch.ops import curve as DC
from drand_tpu_torch.ops import kernels as K

from test_torch_curve import AFFINE, MEMBERS, OUTSIDERS, PA, jacobian_np, jx
from test_torch_kernels_host import glv_tables

RNG = np.random.default_rng(20240611)
LAMBDA = (-X * X) % R                     # phi's eigenvalue on G1


def same(jax_pt, port_pt):
    for w, g in zip(jax_pt, port_pt):
        np.testing.assert_array_equal(CV.limbs_to_numpy(g), np.asarray(w))


def affine_np(pts):
    """Affine points (never None) -> (x, y) Montgomery limb arrays."""
    jac = jacobian_np(pts)
    pa = DC.G1.to_affine(CV.tree_from_numpy(jac))
    return CV.tree_to_numpy(pa[:2])


def _others(pt, fn):
    """A lane-wise partner for PA's lanes (infinity lanes get MEMBERS[0])."""
    return [fn(p) if p is not None else MEMBERS[0] for p in pt]


@pytest.mark.parametrize("other", ["distinct", "equal", "negated"])
def test_add_mixed_matches_jax(other):
    """PA holds infinity in lane 7 (the infinite accumulator case); the
    'equal' and 'negated' partners reach the doubling and P == -Q
    selections on every other lane."""
    q = {"distinct": (MEMBERS[1:] + MEMBERS[:1] + OUTSIDERS[::-1]
                      + [MEMBERS[3]]),
         "equal": _others(AFFINE, lambda p: p),
         "negated": _others(AFFINE, lambda p: (p[0], (-p[1]) % P))}[other]
    q_aff = affine_np(q)
    got = DC.G1.add_mixed(CV.tree_from_numpy(PA), CV.tree_from_numpy(q_aff))
    same(jax.jit(JC.G1_DEV.add_mixed)(jx(PA), jx(q_aff)), got)
    if other == "negated":
        assert DC.G1.is_infinity(got)[:7].all()


@pytest.mark.parametrize("n", [7, 8])
def test_batch_inverse_matches_jax(n):
    vals = [int.from_bytes(RNG.bytes(48), "big") % P for _ in range(n)]
    vals[2] = 0
    z = CV.limbs_from_numpy(np.stack([
        np.asarray(JL.int_to_limbs(v * JL.R_MONT % P)) for v in vals]))
    got = DC.G1.batch_inverse(z)
    want = jax.jit(JC.G1_DEV.batch_inverse)(jnp.asarray(CV.limbs_to_numpy(z)))
    np.testing.assert_array_equal(CV.limbs_to_numpy(got), np.asarray(want))
    assert CV.canonical_ints(got) == [pow(v, -1, P) if v else 0 for v in vals]


def test_to_affine_batch_matches_jax_and_host():
    got = DC.G1.to_affine_batch(CV.tree_from_numpy(PA))
    want = jax.jit(JC.G1_DEV.to_affine_batch)(jx(PA))
    same(want[:2], got[:2])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for pt, x, y in zip(AFFINE, CV.canonical_ints(got[0]),
                        CV.canonical_ints(got[1])):
        assert (x, y) == (pt if pt is not None else (0, 0))


def test_phi_lanes_match_jax():
    same(JC.g1_phi_lanes(jx(PA)), DC.g1_phi_lanes(CV.tree_from_numpy(PA)))


def rlc_planes(lanes, zero_lanes=()):
    """Two (64, lanes) MSB-first bit planes from the numpy seed."""
    b = RNG.integers(0, 2, (2, 64, lanes), dtype=np.uint32)
    b[:, :, list(zero_lanes)] = 0
    return b[0], b[1]


def test_ladder_plain_matches_jax_kernel_math():
    """K8's plain version against the JAX kernel math on tables that reach
    every branch of the mixed add (tests/test_torch_kernels_host.py)."""
    pt, phi, p3, b0, b1 = glv_tables()
    got = K.scalar_mul_glv_mixed_plain(pt, phi, p3, b0, b1)
    t = lambda a: tuple(jnp.asarray(CV.limbs_to_numpy(c)) for c in a)
    want = PF.scalar_mul_glv_mixed("G1", t(pt), t(phi), t(p3),
                                   jnp.asarray(b0.numpy().astype(np.uint32)),
                                   jnp.asarray(b1.numpy().astype(np.uint32)))
    same(want, got)


@pytest.fixture(scope="module")
def glv_inputs():
    b0, b1 = rlc_planes(8, zero_lanes=(6,))
    port = DC.g1_glv_msm_terms(CV.tree_from_numpy(PA), CV.rlc_bits([b0])[0],
                               CV.rlc_bits([b1])[0])
    return b0, b1, port


def test_glv_msm_terms_match_jax_pallas_route(monkeypatch, glv_inputs):
    """Lane 7 of PA is infinity (tables (0, 0), restored after the
    ladder), lane 6 has zero bits (a pad lane)."""
    b0, b1, port = glv_inputs
    monkeypatch.setenv("DRAND_TPU_PALLAS", "1")
    want = JC.g1_glv_msm_terms(jx(PA), jnp.asarray(b0), jnp.asarray(b1))
    same(want, port)
    assert DC.G1.is_infinity(port).tolist() == [False] * 6 + [True, True]


def test_glv_msm_terms_match_host(glv_inputs):
    """[k0 + lambda k1]P on the subgroup members, lambda = -x^2 mod r."""
    b0, b1, port = glv_inputs
    k = lambda b, i: int("".join(str(int(v)) for v in b[:, i]), 2)
    got = DC.decode_g1_points(port)
    for i, pt in enumerate(AFFINE[:len(MEMBERS)]):
        want = JHC.G1.mul(pt, (k(b0, i) + LAMBDA * k(b1, i)) % R)
        assert got[i] == want
