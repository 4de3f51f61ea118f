"""Port field tower (drand_tpu_torch/ops/tower.py) vs the JAX tower.

Fp2/Fp6/Fp12 elements made from a numpy seed go through the jitted JAX
function and the port's plain tensor version; every Fp leaf must be equal
limb for limb (integer arithmetic: no tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from drand_tpu.crypto.host import field as JHF
from drand_tpu.crypto.host.params import P
from drand_tpu.ops import limbs as JL
from drand_tpu.ops import tower as JT

from drand_tpu_torch import convert as CV
from drand_tpu_torch.ops import tower as T

RNG = np.random.default_rng(20240602)
N = 6


def rand_leaf():
    xs = [int.from_bytes(RNG.bytes(48), "big") % P for _ in range(N)]
    return np.stack([np.asarray(JL.int_to_limbs(x * JL.R_MONT % P))
                     for x in xs])


def fp2():
    return (rand_leaf(), rand_leaf())


def fp6():
    return (fp2(), fp2(), fp2())


def fp12():
    return (fp6(), fp6())


A2, B2 = fp2(), fp2()
A6, B6 = fp6(), fp6()
A12, B12 = fp12(), fp12()


def jx(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def port_np(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in port_np(t)]
    return [CV.limbs_to_numpy(tree)]


def same(jax_out, port_out):
    want, got = to_np(jax_out), port_np(port_out)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


CASES = {
    "fp2_mul": (JT.fp2_mul, T.fp2_mul, (A2, B2)),
    "fp2_sqr": (JT.fp2_sqr, T.fp2_sqr, (A2,)),
    "fp2_mul_xi": (JT.fp2_mul_xi, T.fp2_mul_xi, (A2,)),
    "fp2_conj": (JT.fp2_conj, T.fp2_conj, (A2,)),
    "fp2_inv": (JT.fp2_inv, T.fp2_inv, (A2,)),
    "fp6_mul": (JT.fp6_mul, T.fp6_mul, (A6, B6)),
    "fp6_mul_by_v": (JT.fp6_mul_by_v, T.fp6_mul_by_v, (A6,)),
    "fp6_inv": (JT.fp6_inv, T.fp6_inv, (A6,)),
    "fp12_mul": (JT.fp12_mul, T.fp12_mul, (A12, B12)),
    "fp12_sqr": (JT.fp12_sqr, T.fp12_sqr, (A12,)),
    "fp12_conj": (JT.fp12_conj, T.fp12_conj, (A12,)),
    "fp12_inv": (JT.fp12_inv, T.fp12_inv, (A12,)),
    "fp12_frobenius_1": (lambda a: JT.fp12_frobenius(a, 1),
                         lambda a: T.fp12_frobenius(a, 1), (A12,)),
    "fp12_frobenius_2": (lambda a: JT.fp12_frobenius(a, 2),
                         lambda a: T.fp12_frobenius(a, 2), (A12,)),
    "fp12_frobenius_3": (lambda a: JT.fp12_frobenius(a, 3),
                         lambda a: T.fp12_frobenius(a, 3), (A12,)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_tower_op_matches_jax(name):
    jfn, tfn, args = CASES[name]
    want = jax.jit(jfn)(*[jx(a) for a in args])
    got = tfn(*[CV.tree_from_numpy(a) for a in args])
    same(want, got)


def test_fp12_mul_matches_host_golden():
    """Decoded values against the JAX package's pure-Python tower."""
    got = T.fp12_mul(CV.tree_from_numpy(A12), CV.tree_from_numpy(B12))

    def lane(tree, i):
        (a0, a1, a2), (b0, b1, b2) = tree
        dec = lambda c: tuple(CV.canonical_ints(x[i:i + 1])[0] for x in c)
        return ((dec(a0), dec(a1), dec(a2)), (dec(b0), dec(b1), dec(b2)))

    for i in range(N):
        assert lane(got, i) == JHF.fp12_mul(lane(CV.tree_from_numpy(A12), i),
                                            lane(CV.tree_from_numpy(B12), i))


def test_fp12_is_one_and_ones():
    one = T.fp12_ones_like(CV.tree_from_numpy(A12)[0][0][0])
    assert T.fp12_is_one(one).all()
    assert not T.fp12_is_one(CV.tree_from_numpy(A12)).any()
    inv = T.fp12_inv(CV.tree_from_numpy(A12))
    assert T.fp12_is_one(T.fp12_mul(inv, CV.tree_from_numpy(A12))).all()
