"""The kernels' CUDA sources, compiled as host C++, against their plain
PyTorch versions.

drand_tpu_torch/ops/csrc/*.cu compile as plain C++ when __CUDACC__ is not
defined: each C entry point then runs the same lane code in a host loop
over the lanes.  With that library standing in for the card's, the
wrappers in drand_tpu_torch/ops/kernels.py run their whole kernel path
(word layout, bit arrays, constant bundle, launch counts) on CPU tensors,
and every output must equal the plain version's exactly (integer
arithmetic: no tolerance).  The card's own build and launch are held
against the same plain versions by chip_smoke.py.
"""

import ctypes
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from drand_tpu_torch.crypto.host.curve import G1 as HG1
from drand_tpu_torch.crypto.host import field as HF
from drand_tpu_torch.crypto.host.params import P, R, X
from drand_tpu_torch.ops import curve as DC
from drand_tpu_torch.ops import kernels as K
from drand_tpu_torch.ops import limbs as L
from drand_tpu_torch.ops import tower as T

RNG = random.Random(20240608)


def _rand_fp(n):
    return L.encode_mont([RNG.randrange(P) for _ in range(n)])


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the kernels' host lane code")
    out = tmp_path_factory.mktemp("kernels") / "libdrand_kernels_host.so"
    srcs = [str(p) for p in sorted(K.CSRC.glob("*.cu"))]
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-x", "c++",
                    *srcs, "-o", str(out)], check=True, capture_output=True,
                   timeout=600)
    return K.bind(ctypes.CDLL(str(out)))


@pytest.fixture
def kernel_path(monkeypatch, host_lib):
    """Route the wrappers' CPU tensors through the host-built kernels."""
    monkeypatch.setattr(K, "_lib", lambda: host_lib)
    monkeypatch.setattr(K, "_on_card", lambda t: True)
    monkeypatch.setattr(K, "_stream", lambda device: None)
    K.reset_launches()
    return K.LAUNCHES


def _same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("e", [(P - 3) // 4, P - 2, 5, 1],
                         ids=["(p-3)/4", "p-2", "5", "1"])
def test_pow_kernel_matches_plain(kernel_path, e):
    x = torch.cat([L.encode_mont([0, 1, P - 1, (P + 1) // 2]), _rand_fp(5)])
    got = K.pow_fixed(x, e)
    assert kernel_path["pow_fixed"] == 1
    assert K.SHAPES == {("pow_fixed", e, 9): 1}
    _same([got], [K.pow_fixed_plain(x, e)])
    assert L.decode_mont(got) == [pow(v, e, P) for v in L.decode_mont(x)]


def _points():
    members = [HG1.mul(HG1.gen, RNG.randrange(1, R)) for _ in range(3)]
    x = 1
    while True:                       # on the curve, outside G1
        y = HF.fp_sqrt((x ** 3 + 4) % P)
        if y is not None and not HG1.in_subgroup((x, y)):
            break
        x += 1
    return DC.encode_g1_points(members + [(x, y), None, HG1.gen])


@pytest.mark.parametrize("k", [-X, 1 - X, 2, 1], ids=["|x|", "1-x", "2", "1"])
def test_ladder_kernel_matches_plain(kernel_path, k):
    pts = _points()
    got = K.scalar_mul_fixed(pts, k)
    assert kernel_path["scalar_mul_fixed"] == 1
    assert K.SHAPES == {("scalar_mul_fixed", k, 6): 1}
    _same(got, K.scalar_mul_fixed_plain(pts, k))


def test_ladder_kernel_broadcasts_coordinates(kernel_path):
    """A Z coordinate shared by every lane (shape (24,)) broadcasts."""
    x, y, _ = _points()
    pts = (x[:3], y[:3], L.mont_const(1, "cpu"))
    got = K.scalar_mul_fixed(pts, -X)
    _same(got, K.scalar_mul_fixed_plain(
        (x[:3], y[:3], L.encode_mont([1, 1, 1])), -X))


@pytest.fixture(scope="module")
def fp12_inputs():
    px, py = _rand_fp(3), _rand_fp(3)
    q2 = ((_rand_fp(3), _rand_fp(3)), (_rand_fp(3), _rand_fp(3)))
    return px, py, q2, K.miller_loop_plain(px, py, q2)


def test_miller_kernel_matches_plain(kernel_path, fp12_inputs):
    px, py, q2, want = fp12_inputs
    got = K.miller_loop(px, py, q2)
    assert kernel_path["miller_loop"] == 1
    assert K.SHAPES == {("miller_loop", None, 3): 1}
    _same(T.fp12_leaves(got), T.fp12_leaves(want))


def test_final_exponentiation_kernel_matches_plain(kernel_path, fp12_inputs):
    f = fp12_inputs[3]
    got = K.final_exponentiation(f)
    assert kernel_path["final_exponentiation"] == 1
    _same(T.fp12_leaves(got),
          T.fp12_leaves(K.final_exponentiation_plain(f)))


def test_word_layout_round_trip():
    x = _rand_fp(7).reshape(7, 1, 24)
    w = K.to_words([x, x.flip(0)])
    assert w.dtype == torch.int32 and w.shape == (2, 12, 7)
    back = K.from_words(w, (7, 1))
    _same(back, [x, x.flip(0)])
    assert np.array_equal(K.const_rows()[0].numpy(), L.int_to_limbs(P))
