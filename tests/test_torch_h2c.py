"""Port hash-to-G1 + signature decompression (drand_tpu_torch/ops/h2c.py)
vs the JAX package's ``g1_decompress_and_hash``.

Inputs: wire x coordinates and sign flags of real short signatures, an x
with no point on the curve, and host hash_to_field outputs, all made from a
seed.  The JAX side runs with the Pallas dispatch on (its plain CPU
lowering); the port runs its plain versions on the CPU.  Jacobian outputs
and the parse mask must be equal limb for limb.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drand_tpu.crypto.host import field as JHF
from drand_tpu.crypto.host import h2c as JH2C
from drand_tpu.crypto.host.curve import G1 as JG1
from drand_tpu.crypto.host.params import P, R, DST_G2
from drand_tpu.ops import h2c as JH
from drand_tpu.ops import limbs as JL

from drand_tpu_torch import convert as CV
from drand_tpu_torch.crypto.host import h2c as H2C
from drand_tpu_torch.ops import curve as DC
from drand_tpu_torch.ops import h2c as DH

RNG = np.random.default_rng(20240604)
N = 6


def _not_on_curve_x():
    x = 5
    while JHF.fp_sqrt((x ** 3 + 4) % P) is not None:
        x += 1
    return x


PTS = [JG1.mul(JG1.gen, int.from_bytes(RNG.bytes(32), "big") % R)
       for _ in range(N - 1)]
XS = [pt[0] for pt in PTS] + [_not_on_curve_x()]
SIGNS = [int(pt[1] > (P - 1) // 2) for pt in PTS] + [1]
MSGS = [RNG.bytes(32) for _ in range(N)]
U = [H2C.hash_to_field_fp(m, DST_G2, 2) for m in MSGS]


def _limbs(xs, mont):
    return np.stack([np.asarray(JL.int_to_limbs(x * JL.R_MONT % P if mont
                                                else x)) for x in xs])


X_NP = _limbs(XS, mont=False)
SIGN_NP = np.asarray(SIGNS, np.uint32)
U0_NP = _limbs([u[0] for u in U], mont=True)
U1_NP = _limbs([u[1] for u in U], mont=True)


@pytest.fixture(scope="module")
def both():
    mp = pytest.MonkeyPatch()
    mp.setenv("DRAND_TPU_PALLAS", "1")
    try:
        want = jax.jit(JH.g1_decompress_and_hash)(
            jnp.asarray(X_NP), jnp.asarray(SIGN_NP), jnp.asarray(U0_NP),
            jnp.asarray(U1_NP))
    finally:
        mp.undo()
    got = DH.g1_decompress_and_hash(
        CV.limbs_from_numpy(X_NP),
        torch.from_numpy(SIGN_NP.astype(np.int64)),
        CV.limbs_from_numpy(U0_NP), CV.limbs_from_numpy(U1_NP))
    return want, got


def test_host_hash_to_field_copy_matches_jax_package():
    for m, u in zip(MSGS, U):
        assert u == JH2C.hash_to_field_fp(m, DST_G2, 2)


@pytest.mark.parametrize("part", ["sig_jac", "parse_ok", "hm_jac"])
def test_decompress_and_hash_matches_jax(both, part):
    want, got = both
    i = ["sig_jac", "parse_ok", "hm_jac"].index(part)
    if part == "parse_ok":
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
        assert got[i].tolist() == [True] * (N - 1) + [False]
        return
    for w, g in zip(want[i], got[i]):
        np.testing.assert_array_equal(CV.limbs_to_numpy(g), np.asarray(w))


def test_values_match_host(both):
    _, (sig_jac, ok, hm) = both
    for pt, got in zip(PTS, DC.decode_g1_points(sig_jac)[:N - 1]):
        assert got == pt
    for m, got in zip(MSGS, DC.decode_g1_points(hm)):
        assert got == JH2C.hash_to_curve_g1(m, DST_G2)
