"""K6's plain version (drand_tpu_torch/ops/kernels.py scalar_mul_bits_plain,
the per-lane-scalar ladder behind DevCurve.scalar_mul_bits) vs the JAX
package and the host golden code.

Jacobian points and MSB-first bit planes are made from a numpy seed.  On
G1 the JAX side runs its Pallas dispatch's CPU lowering
(pallas_field.scalar_mul_bits -> _ladder_var_direct, the kernel's math in
XLA) and its DevCurve.scalar_mul_bits scan; coordinates must be equal limb
for limb.  On both curves the affine results must equal the host's
k*P.  The kernel's own arithmetic (csrc/ladder_var.cu) is held against
this plain version in test_torch_kernels_host.py and on the card by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from drand_tpu.crypto.host import curve as JHC
from drand_tpu.ops import curve as JC
from drand_tpu.ops import pallas_field as PF

from drand_tpu_torch import convert as CV
from drand_tpu_torch.ops import curve as DC
from drand_tpu_torch.ops import kernels as K

import test_torch_curve as T1
import test_torch_g2_curve as T2

RNG = np.random.default_rng(20240620)


def bit_planes(nbits, lanes, zero_lane):
    """Random MSB-first bits (nbits, lanes), uint32 as the JAX package
    takes them; `zero_lane` carries the all-zero scalar."""
    b = RNG.integers(0, 2, (nbits, lanes), dtype=np.uint32)
    b[:, zero_lane] = 0
    return b


def scalar(b, lane):
    return int("".join(str(int(v)) for v in b[:, lane]), 2)


def port_ladder(curve, pts, b):
    """The port's DevCurve.scalar_mul_bits on CPU tensors: the plain
    version only, no kernel launch."""
    K.reset_launches()
    got = curve.scalar_mul_bits(CV.tree_from_numpy(pts), CV.rlc_bits([b])[0])
    assert all(c == 0 for c in K.LAUNCHES.values())
    return got


@pytest.fixture(scope="module")
def g1_case():
    """32 bits over T1.PA's 8 lanes (members, outsiders of G1, infinity);
    lane 0 an all-zero scalar."""
    b = bit_planes(32, 8, zero_lane=0)
    return b, port_ladder(DC.G1, T1.PA, b)


@pytest.mark.parametrize("route", ["pallas_direct", "devcurve_scan"])
def test_ladder_var_matches_jax_g1(g1_case, route):
    b, got = g1_case
    if route == "pallas_direct":
        want = PF.scalar_mul_bits("G1", T1.jx(T1.PA), jnp.asarray(b))
    else:
        want = jax.jit(JC.G1_DEV.scalar_mul_bits)(T1.jx(T1.PA),
                                                  jnp.asarray(b))
    T1.same_point(want, got)


def test_ladder_var_matches_host_g1(g1_case):
    b, got = g1_case
    x, y, inf = DC.G1.to_affine(got)
    xs, ys = CV.canonical_ints(x), CV.canonical_ints(y)
    assert inf.tolist()[0] and inf.tolist()[7]
    for i, pt in enumerate(T1.MEMBERS):
        want = JHC.G1.mul(pt, scalar(b, i))
        assert want is None if i == 0 else (xs[i], ys[i]) == want


def test_ladder_var_matches_host_g2():
    """16 bits over T2.PA's 8 lanes; lane 1 an all-zero scalar, lane 7
    infinity."""
    b = bit_planes(16, 8, zero_lane=1)
    got = port_ladder(DC.G2, T2.PA, b)
    pts = DC.decode_g2_points(got)
    assert pts[1] is None and pts[7] is None
    for i, pt in enumerate(T2.MEMBERS):
        if i != 1:
            assert pts[i] == JHC.G2.mul(pt, scalar(b, i))


def test_scalar_mul_bits_batch_shape():
    """A (2, 4) batch with (nbits, 2, 4) bits equals the flat 8-lane
    ladder reshaped (the wrapper flattens any batch shape to lanes)."""
    b = bit_planes(8, 8, zero_lane=3)
    flat = port_ladder(DC.G1, T1.PA, b)
    pts = CV.tree_from_numpy(T1.PA)
    got = DC.G1.scalar_mul_bits(tuple(c.reshape(2, 4, 24) for c in pts),
                                CV.rlc_bits([b])[0].reshape(8, 2, 4))
    for g, f in zip(got, flat):
        assert g.shape == (2, 4, 24)
        assert (g.reshape(8, 24) == f).all()
