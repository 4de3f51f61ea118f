"""Port pairing (drand_tpu_torch/ops/pairing.py: Miller loop K3 and final
exponentiation K4, plain versions on the CPU) vs the JAX package.

Tier-1: the port's e(P, Q) against the JAX package's host golden pairing
(drand_tpu/crypto/host/pairing.py), value for value, and the paired-product
check.  Marked slow + heavy_compile: the Miller-loop output and the final
exponentiation bit for bit against the JAX Pallas dispatch's plain CPU
lowering (_miller_direct / _finalexp_direct), whose cold CPU compile takes
minutes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from drand_tpu.crypto.host import pairing as JHP
from drand_tpu.crypto.host.curve import G1 as JG1, G2 as JG2
from drand_tpu.crypto.host.params import R
from drand_tpu.ops import limbs as JL
from drand_tpu.ops import pallas_field as PF

from drand_tpu_torch import convert as CV
from drand_tpu_torch.ops import pairing as DP
from drand_tpu_torch.ops import tower as T

RNG = np.random.default_rng(20240605)
N = 3

P1 = [JG1.mul(JG1.gen, int.from_bytes(RNG.bytes(32), "big") % R)
      for _ in range(N)]
Q2 = [JG2.mul(JG2.gen, int.from_bytes(RNG.bytes(32), "big") % R)
      for _ in range(N)]


def mont_np(xs):
    return np.stack([np.asarray(JL.int_to_limbs(x * JL.R_MONT % JL.P))
                     for x in xs])


PX, PY = mont_np([p[0] for p in P1]), mont_np([p[1] for p in P1])
QX = (mont_np([q[0][0] for q in Q2]), mont_np([q[0][1] for q in Q2]))
QY = (mont_np([q[1][0] for q in Q2]), mont_np([q[1][1] for q in Q2]))


def host_fp12(f, i):
    """Lane i of a port Fp12 -> the host golden nesting of ints."""
    vals = [CV.canonical_ints(x[i:i + 1])[0] for x in T.fp12_leaves(f)]
    fp2 = [(vals[2 * k], vals[2 * k + 1]) for k in range(6)]
    return (tuple(fp2[:3]), tuple(fp2[3:]))


@pytest.fixture(scope="module")
def port_pairing():
    f = DP.miller_loop(CV.limbs_from_numpy(PX), CV.limbs_from_numpy(PY),
                       CV.tree_from_numpy((QX, QY)))
    return f, DP.final_exponentiation(f)


def test_final_exponentiation_matches_host_golden(port_pairing):
    """Same Fp12 input (the port's projective Miller output, which differs
    from the host's affine loop by line factors the exponent kills)."""
    f, e = port_pairing
    for i in range(N):
        assert host_fp12(e, i) == JHP.final_exponentiation(host_fp12(f, i))


def test_pairing_matches_host_golden(port_pairing):
    _, e = port_pairing
    for i in range(N):
        assert host_fp12(e, i) == JHP.pairing(P1[i], Q2[i])


def test_paired_product_is_one():
    """e(P, Q) * e(-P, Q) == 1 on two lanes; e(P, Q)^2 != 1 on the third."""
    neg = [JG1.neg(p) for p in P1]
    second = neg[:2] + [P1[2]]
    px = np.stack([PX, mont_np([p[0] for p in second])])
    py = np.stack([PY, mont_np([p[1] for p in second])])
    q = ((np.stack([QX[0]] * 2), np.stack([QX[1]] * 2)),
         (np.stack([QY[0]] * 2), np.stack([QY[1]] * 2)))
    ok = DP.paired_product_is_one(CV.limbs_from_numpy(px),
                                  CV.limbs_from_numpy(py),
                                  CV.tree_from_numpy(q), 2)
    assert ok.tolist() == [True, True, False]


@pytest.mark.slow
@pytest.mark.heavy_compile
def test_pairing_bit_exact_vs_jax_pallas_lowering(monkeypatch, port_pairing):
    monkeypatch.setenv("DRAND_TPU_PALLAS", "1")
    f, e = port_pairing
    jf = PF.miller_loop(jnp.asarray(PX), jnp.asarray(PY),
                        jax.tree.map(jnp.asarray, (QX, QY)))
    for w, g in zip(jax.tree.leaves(jf), T.fp12_leaves(f)):
        np.testing.assert_array_equal(CV.limbs_to_numpy(g), np.asarray(w))
    je = PF.final_exponentiation(jf)
    for w, g in zip(jax.tree.leaves(je), T.fp12_leaves(e)):
        np.testing.assert_array_equal(CV.limbs_to_numpy(g), np.asarray(w))
