"""The port's GLV-split RLC multiplication on G2 (drand_tpu_torch/ops/
curve.py g2_glv_msm_terms, K8-G2's plain version) vs the JAX package.

The JAX side runs its Pallas route (DRAND_TPU_PALLAS=1: the affine tables
{Q, psi^2 Q, Q + psi^2 Q} by one shared inversion, then on the CPU the
plain lowering _ladder_glv_mixed_direct of the kernel's math), jitted as
one program; Jacobian outputs must be equal limb for limb.  The weights
are checked on the host: [k0 + x^2 k1]Q, x^2 being psi^2's eigenvalue.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from drand_tpu.crypto.host import curve as JHC
from drand_tpu.crypto.host.params import R, X
from drand_tpu.ops import curve as JC

from drand_tpu_torch import convert as CV
from drand_tpu_torch.ops import curve as DC
from drand_tpu_torch.ops import kernels as K

from test_torch_g2_curve import MEMBERS, PA, jx, port, same

RNG = np.random.default_rng(20240616)


@pytest.fixture(scope="module")
def glv_inputs():
    """(32, 8) planes; lane 6 has zero bits (a pad lane), lane 7 of PA is
    infinity (tables (0, 0), restored after the ladder)."""
    b = RNG.integers(0, 2, (2, 32, 8), dtype=np.uint32)
    b[:, :, 6] = 0
    K.reset_launches()
    got = DC.g2_glv_msm_terms(port(PA), *CV.rlc_bits(b))
    assert all(c == 0 for c in K.LAUNCHES.values())   # plain versions only
    return b[0], b[1], got


def test_glv_msm_terms_match_jax_pallas_route(monkeypatch, glv_inputs):
    b0, b1, got = glv_inputs
    monkeypatch.setenv("DRAND_TPU_PALLAS", "1")
    want = jax.jit(JC.g2_glv_msm_terms)(jx(PA), jnp.asarray(b0),
                                        jnp.asarray(b1))
    same(want, got)
    assert DC.G2.is_infinity(got).tolist() == [False] * 6 + [True, True]


def test_glv_msm_terms_match_host(glv_inputs):
    b0, b1, got = glv_inputs
    k = lambda b, i: int("".join(str(int(v)) for v in b[:, i]), 2)
    pts = DC.decode_g2_points(got)
    for i, pt in enumerate(MEMBERS):
        assert pts[i] == JHC.G2.mul(pt, (k(b0, i) + X * X * k(b1, i)) % R)
