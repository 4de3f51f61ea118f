"""Port hash-to-G2 + G2 signature decompression (drand_tpu_torch/ops/h2c.py)
vs the JAX package's ``g2_decompress_and_hash`` and the host golden code.

Inputs: wire x coordinates and sign flags of real G2 signatures (one with
x.c1 = 0, which takes the sign from c0), an x with no point on the curve,
and host hash_to_field_fp2 outputs, all made from a seed.  The JAX side
runs with the Pallas dispatch on (its plain CPU lowering of the Fp2 power
_pow2_direct); the port runs its plain versions on the CPU.  Jacobian
outputs and the parse mask must be equal limb for limb, and the points
must equal the host's decompression and hash_to_curve_g2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drand_tpu.crypto.host import field as JHF
from drand_tpu.crypto.host import h2c as JH2C
from drand_tpu.crypto.host.curve import G2 as JG2
from drand_tpu.crypto.host.params import P, R, DST_G2
from drand_tpu.crypto.host.serialize import _y_is_larger_fp2
from drand_tpu.ops import h2c as JH
from drand_tpu.ops import limbs as JL

from drand_tpu_torch import convert as CV
from drand_tpu_torch.crypto.host import h2c as H2C
from drand_tpu_torch.ops import curve as DC
from drand_tpu_torch.ops import h2c as DH
from drand_tpu_torch.ops import kernels as K

RNG = np.random.default_rng(20240618)
N = 4


def _not_on_curve_x():
    a = 5
    while True:
        x = (a, 3)
        rhs = JHF.fp2_add(JHF.fp2_mul(JHF.fp2_sqr(x), x), (4, 4))
        if JHF.fp2_sqrt(rhs) is None:
            return x
        a += 1


def _point_with_real_x():
    """A point of E2 with x in Fp (x.c1 = 0): its sign rule reads c0."""
    a = 1
    while True:
        y = JHF.fp2_sqrt(((a ** 3 + 4) % P, 4))
        if y is not None:
            return ((a, 0), y)
        a += 1


PTS = [JG2.mul(JG2.gen, int.from_bytes(RNG.bytes(32), "big") % R)
       for _ in range(N - 2)] + [_point_with_real_x()]
XS = [pt[0] for pt in PTS] + [_not_on_curve_x()]
SIGNS = [int(_y_is_larger_fp2(pt[1])) for pt in PTS] + [1]
MSGS = [RNG.bytes(32) for _ in range(N)]
U = [H2C.hash_to_field_fp2(m, DST_G2, 2) for m in MSGS]


def _limbs(xs, mont):
    return np.stack([np.asarray(JL.int_to_limbs(x * JL.R_MONT % P if mont
                                                else x)) for x in xs])


X0_NP = _limbs([x[0] for x in XS], mont=False)
X1_NP = _limbs([x[1] for x in XS], mont=False)
SIGN_NP = np.asarray(SIGNS, np.uint32)
U0_NP = tuple(_limbs([u[0][c] for u in U], mont=True) for c in (0, 1))
U1_NP = tuple(_limbs([u[1][c] for u in U], mont=True) for c in (0, 1))


@pytest.fixture(scope="module")
def port_out():
    K.reset_launches()
    got = DH.g2_decompress_and_hash(
        CV.limbs_from_numpy(X0_NP), CV.limbs_from_numpy(X1_NP),
        torch.from_numpy(SIGN_NP.astype(np.int64)),
        CV.tree_from_numpy(U0_NP), CV.tree_from_numpy(U1_NP))
    assert all(c == 0 for c in K.LAUNCHES.values())   # plain versions only
    return got


def test_host_hash_to_field_copy_matches_jax_package():
    for m, u in zip(MSGS, U):
        assert u == JH2C.hash_to_field_fp2(m, DST_G2, 2)


def test_values_match_host(port_out):
    sig_jac, ok, hm = port_out
    assert ok.tolist() == [True] * (N - 1) + [False]
    assert DC.decode_g2_points(sig_jac)[:N - 1] == PTS
    assert DC.decode_g2_points(hm) == [JH2C.hash_to_curve_g2(m, DST_G2)
                                       for m in MSGS]


def test_hash_to_g2_jac_matches_host():
    u0 = CV.tree_from_numpy(tuple(c[:2] for c in U0_NP))
    u1 = CV.tree_from_numpy(tuple(c[:2] for c in U1_NP))
    got = DC.decode_g2_points(DH.hash_to_g2_jac(u0, u1))
    assert got == [H2C.hash_to_curve_g2(m, DST_G2) for m in MSGS[:2]]


def test_recover_y_sign_rule():
    """Flipping the sign flag gives -y; with x.c1 = 0 as well."""
    x0 = CV.limbs_from_numpy(X0_NP[:N - 1])
    x1 = CV.limbs_from_numpy(X1_NP[:N - 1])
    flipped = torch.from_numpy(1 - SIGN_NP[:N - 1].astype(np.int64))
    pt, ok = DH.g2_recover_y(x0, x1, flipped)
    assert ok.all()
    assert DC.decode_g2_points(pt) == [(p[0], JHF.fp2_neg(p[1]))
                                       for p in PTS]


@pytest.mark.slow
@pytest.mark.heavy_compile
@pytest.mark.parametrize("part", ["sig_jac", "parse_ok", "hm_jac"])
def test_decompress_and_hash_matches_jax(port_out, part):
    """The JAX side's cold compile of the fused front (the 758-step Fp2
    scan, the 3-isogeny and two G2 ladders) takes minutes on the CPU."""
    mp = pytest.MonkeyPatch()
    mp.setenv("DRAND_TPU_PALLAS", "1")
    try:
        want = jax.jit(JH.g2_decompress_and_hash)(
            jnp.asarray(X0_NP), jnp.asarray(X1_NP), jnp.asarray(SIGN_NP),
            jax.tree.map(jnp.asarray, U0_NP), jax.tree.map(jnp.asarray, U1_NP))
    finally:
        mp.undo()
    i = ["sig_jac", "parse_ok", "hm_jac"].index(part)
    if part == "parse_ok":
        np.testing.assert_array_equal(port_out[i].numpy(), np.asarray(want[i]))
        return
    for w, g in zip(jax.tree.leaves(want[i]), jax.tree.leaves(port_out[i])):
        np.testing.assert_array_equal(CV.limbs_to_numpy(g), np.asarray(w))
