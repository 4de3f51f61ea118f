"""Port Fp engine (drand_tpu_torch/ops/limbs.py) vs the JAX limb engine.

The same numpy-made Montgomery limb arrays go through the JAX function and
through the port (CPU: the plain versions; the K1 wrapper runs its plain
loop for a CPU tensor) via drand_tpu_torch.convert.  Outputs must be equal
limb for limb (integer arithmetic: no tolerance).  The fixed-exponent
chains go through the JAX Pallas dispatch (DRAND_TPU_PALLAS=1, on the CPU
its plain lowering _pow_direct) and through Python's pow().
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drand_tpu.crypto.host.params import P
from drand_tpu.ops import limbs as JL
from drand_tpu.ops import pallas_field as PF

from drand_tpu_torch import convert as CV
from drand_tpu_torch.ops import kernels as K
from drand_tpu_torch.ops import limbs as L

RNG = np.random.default_rng(20240601)
EDGES = [0, 1, 2, P - 1, P - 2, (P - 1) // 2, (P + 1) // 2, (1 << 384) % P,
         (1 << 256), (1 << 16) - 1]


def rand_ints(n):
    return [int.from_bytes(RNG.bytes(48), "big") % P for _ in range(n)]


def mont_np(xs):
    """ints -> (n, 24) uint32 Montgomery limbs (the JAX layout)."""
    return np.stack([np.asarray(JL.int_to_limbs(x * JL.R_MONT % P))
                     for x in xs])


A_INTS = EDGES + rand_ints(246)
B_INTS = rand_ints(246) + EDGES[::-1]
A_NP, B_NP = mont_np(A_INTS), mont_np(B_INTS)


def port(x):
    return CV.limbs_from_numpy(x)


BINARY = {
    "mont_mul": (JL.mont_mul, L.mont_mul),
    "add_mod": (JL.add_mod, L.add_mod),
    "sub_mod": (JL.sub_mod, L.sub_mod),
}
UNARY = {
    "mont_sqr": (JL.mont_sqr, L.mont_sqr),
    "neg_mod": (JL.neg_mod, L.neg_mod),
    "to_mont": (JL.to_mont, L.to_mont),
    "from_mont": (JL.from_mont, L.from_mont),
}


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_op_matches_jax(name):
    jfn, tfn = BINARY[name]
    want = np.asarray(jax.jit(jfn)(jnp.asarray(A_NP), jnp.asarray(B_NP)))
    got = CV.limbs_to_numpy(tfn(port(A_NP), port(B_NP)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_op_matches_jax(name):
    jfn, tfn = UNARY[name]
    want = np.asarray(jax.jit(jfn)(jnp.asarray(A_NP)))
    got = CV.limbs_to_numpy(tfn(port(A_NP)))
    np.testing.assert_array_equal(got, want)


def test_values_match_python_ints():
    a, b = port(A_NP), port(B_NP)
    prod = CV.canonical_ints(L.mont_mul(a, b))
    assert prod == [x * y % P for x, y in zip(A_INTS, B_INTS)]
    assert CV.canonical_ints(L.sub_mod(a, b)) == \
        [(x - y) % P for x, y in zip(A_INTS, B_INTS)]


def test_predicates_and_select():
    a, b = port(A_NP), port(B_NP)
    ja, jb = jnp.asarray(A_NP), jnp.asarray(B_NP)
    assert L.eq(a, a).all()
    np.testing.assert_array_equal(L.eq(a, b).numpy(), np.asarray(JL.eq(ja, jb)))
    np.testing.assert_array_equal(L.is_zero(a).numpy(),
                                  np.asarray(JL.is_zero(ja)))
    np.testing.assert_array_equal(L.ge(a, b).numpy(),
                                  np.asarray(jax.jit(JL.ge)(ja, jb)))
    cond = torch.from_numpy(RNG.integers(0, 2, len(A_INTS)).astype(bool))
    np.testing.assert_array_equal(
        CV.limbs_to_numpy(L.select(cond, a, b)),
        np.asarray(JL.select(jnp.asarray(cond.numpy()), ja, jb)))


def test_mul_many_is_elementwise():
    a, b = port(A_NP[:16]), port(B_NP[:16])
    outs = L.mul_many([(a, b), (b, b), (a, L.mont_const(7, "cpu"))])
    assert torch.equal(outs[0], L.mont_mul(a, b))
    assert torch.equal(outs[1], L.mont_sqr(b))
    assert torch.equal(outs[2], L.mont_mul(a, L.encode_mont([7] * 16)))


@pytest.mark.parametrize("label,e", [("(p-3)/4", (P - 3) // 4),
                                     ("p-2", P - 2)])
def test_pow_fixed_matches_jax_pallas_dispatch(monkeypatch, label, e):
    monkeypatch.setenv("DRAND_TPU_PALLAS", "1")
    x_np = A_NP[:48]
    want = np.asarray(PF.pow_fixed(jnp.asarray(x_np), e))
    got = L.pow_fixed(port(x_np), e)
    np.testing.assert_array_equal(CV.limbs_to_numpy(got), want)
    assert CV.canonical_ints(got) == [pow(x, e, P) for x in A_INTS[:48]]


def test_inv_mod_matches_jax_and_fermat(monkeypatch):
    monkeypatch.setenv("DRAND_TPU_PALLAS", "1")
    x_np = B_NP[:32]
    want = np.asarray(JL.inv_mod(jnp.asarray(x_np)))
    got = L.inv_mod(port(x_np))
    np.testing.assert_array_equal(CV.limbs_to_numpy(got), want)
    assert CV.canonical_ints(got) == \
        [pow(x, P - 2, P) for x in B_INTS[:32]]


def test_pow_wrapper_counts_only_kernel_launches():
    K.reset_launches()
    L.pow_fixed(port(A_NP[:4]), 5)
    assert K.LAUNCHES["pow_fixed"] == 0      # a CPU tensor runs the plain loop


def test_host_limb_helpers_roundtrip():
    xs = A_INTS[:20]
    arr = L.ints_to_limbs(xs)
    assert L.limbs_to_ints(arr) == xs
    np.testing.assert_array_equal(arr, np.stack([L.int_to_limbs(x)
                                                 for x in xs]))
    assert L.decode_mont(L.encode_mont(xs)) == xs
