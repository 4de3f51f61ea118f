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

from drand_tpu_torch.crypto.host.curve import G1 as HG1, G2 as HG2
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


def _sum_input(n):
    """n Jacobian lanes: members, an outsider, infinity, and a member
    twice and negated (the doubling and P == -Q branches of the add)."""
    x, y, z = _points()
    idx = [RNG.randrange(6) for _ in range(n)]
    pts = tuple(c[idx] for c in (x, y, z))
    neg = DC.G1.neg(pts)
    pts = tuple(c.clone() for c in pts)
    for c, d in zip(pts, neg):                 # lane 1 = -lane 0
        c[1] = d[0]
    return pts


@pytest.mark.parametrize("n", [256, 512])
def test_sum_kernel_matches_plain(kernel_path, n):
    pts = _sum_input(n)
    got = K.sum_tiles(pts)
    assert kernel_path["sum_tiles"] == 1
    assert K.SHAPES == {("sum_tiles", None, n): 1}
    _same(got, K.sum_tiles_plain(pts))
    assert got[0].shape == (n // K.TILE, 24)


def test_sum_points_kernel_path_matches_plain(kernel_path, monkeypatch):
    """1280 lanes: one launch over 5 tiles, one over the 5 partials padded
    to a tile; 3 lanes: padded to one tile."""
    for n, shapes in ((1280, {("sum_tiles", None, 1280): 1,
                              ("sum_tiles", None, 256): 1}),
                      (3, {("sum_tiles", None, 256): 1})):
        pts = _sum_input(n)
        K.reset_launches()
        got = K.sum_points(pts)
        assert dict(K.SHAPES) == shapes
        monkeypatch.setattr(K, "_on_card", lambda t: False)
        _same(got, K.sum_points(pts))
        monkeypatch.setattr(K, "_on_card", lambda t: True)


def glv_tables():
    """Affine tables of 4 lanes and bits that reach every branch of the
    mixed add: lane 0 random; lane 1 P3 = 2P, so the step that doubles P
    and adds P3 meets P == Q; lane 2 P3 = -2P (P == -Q); lane 3 no bits."""
    members = [HG1.mul(HG1.gen, RNG.randrange(1, R)) for _ in range(4)]
    pt = members
    beta = pow(2, (P - 1) // 3, P)
    phi = [(beta * p[0] % P, p[1]) for p in pt]
    two1, two2 = HG1.mul(pt[1], 2), HG1.mul(pt[2], 2)
    p3 = [HG1.add(pt[0], phi[0]), two1, (two2[0], P - two2[1]),
          HG1.add(pt[3], phi[3])]
    enc = lambda pts: (L.encode_mont([p[0] for p in pts]),
                       L.encode_mont([p[1] for p in pts]))
    nbits = 64
    b0 = torch.tensor([[RNG.randrange(2) for _ in range(4)]
                       for _ in range(nbits)], dtype=torch.int32)
    b1 = torch.tensor([[RNG.randrange(2) for _ in range(4)]
                       for _ in range(nbits)], dtype=torch.int32)
    for lane in (1, 2):                         # (1, 0) then (1, 1)
        b0[:2, lane] = 1
        b1[:2, lane] = torch.tensor([0, 1])
    b0[2:, 2] = 0                               # lane 2 stays at infinity
    b1[2:, 2] = 0
    b0[:, 3] = 0
    b1[:, 3] = 0
    return enc(pt), enc(phi), enc(p3), b0, b1


def test_glv_kernel_matches_plain(kernel_path):
    pt, phi, p3, b0, b1 = glv_tables()
    got = K.scalar_mul_glv_mixed(pt, phi, p3, b0, b1)
    assert kernel_path["scalar_mul_glv_mixed"] == 1
    assert K.SHAPES == {("scalar_mul_glv_mixed", 64, 4): 1}
    _same(got, K.scalar_mul_glv_mixed_plain(pt, phi, p3, b0, b1))
    assert DC.G1.is_infinity(got).tolist() == [False, False, True, True]


def test_word_layout_round_trip():
    x = _rand_fp(7).reshape(7, 1, 24)
    w = K.to_words([x, x.flip(0)])
    assert w.dtype == torch.int32 and w.shape == (2, 12, 7)
    back = K.from_words(w, (7, 1))
    _same(back, [x, x.flip(0)])
    assert np.array_equal(K.const_rows()[0].numpy(), L.int_to_limbs(P))


# ---------------------------------------------------------------------------
# G2 instances: K5 (Fp2 pow), K2, K7 and K8 on G2
# ---------------------------------------------------------------------------

E2 = (P * P - 9) // 16


def _rand_fp2(n):
    return (_rand_fp(n), _rand_fp(n))


@pytest.mark.parametrize("e", [E2, 5, 1], ids=["E2", "5", "1"])
def test_pow2_kernel_matches_plain(kernel_path, e):
    x = _rand_fp2(5)
    x = tuple(torch.cat([L.encode_mont([0, 1, 0]), c]) for c in x)
    x[1][2] = L.encode_mont(1)                         # lane 2 = u
    got = K.pow_fixed_fp2(x, e)
    assert kernel_path["pow_fixed_fp2"] == 1
    assert K.SHAPES == {("pow_fixed_fp2", e, 8): 1}
    _same(got, K.pow_fixed_fp2_plain(x, e))
    vals = list(zip(*[L.decode_mont(c) for c in x]))
    assert list(zip(*[L.decode_mont(c) for c in got])) == \
        [HF.fp2_pow(v, e) for v in vals]


def _g2_points():
    """Members, an on-curve point outside G2, infinity and the generator."""
    members = [HG2.mul(HG2.gen, RNG.randrange(1, R)) for _ in range(2)]
    a = 1
    while True:
        xq = (a, 1)
        yq = HF.fp2_sqrt(HF.fp2_add(HF.fp2_mul(HF.fp2_sqr(xq), xq), (4, 4)))
        if yq is not None:
            break
        a += 1
    return members + [(xq, yq), None, HG2.gen]


@pytest.mark.parametrize("k", [-X, 2, 1], ids=["|x|", "2", "1"])
def test_ladder_g2_kernel_matches_plain(kernel_path, k):
    pts = DC.encode_g2_points(_g2_points())
    got = K.scalar_mul_fixed(pts, k)
    assert kernel_path["scalar_mul_fixed_g2"] == 1
    assert kernel_path["scalar_mul_fixed"] == 0
    assert K.SHAPES == {("scalar_mul_fixed_g2", k, 5): 1}
    _same(K._flat(got), K._flat(K.scalar_mul_fixed_plain(pts, k)))


def _g2_sum_input(n):
    """n Jacobian G2 lanes with repeats (doubling) and, in lane 1, the
    negation of lane 0 (P == -Q)."""
    pts = DC.encode_g2_points(_g2_points())
    idx = [RNG.randrange(5) for _ in range(n)]
    pts = DC._tmap(lambda c: c[idx].clone(), pts)
    neg = DC.G2.neg(pts)
    for c, d in zip(K._flat(pts), K._flat(neg)):
        c[1] = d[0]
    return pts


def test_sum_g2_kernel_matches_plain(kernel_path):
    n = K.TILE
    pts = _g2_sum_input(n)
    got = K.sum_tiles(pts)
    assert kernel_path["sum_tiles_g2"] == 1
    assert K.SHAPES == {("sum_tiles_g2", None, n): 1}
    _same(K._flat(got), K._flat(K.sum_tiles_plain(pts)))
    assert got[0][0].shape == (n // K.TILE, 24)


def test_sum_points_g2_kernel_path_matches_plain(kernel_path, monkeypatch):
    pts = _g2_sum_input(5)
    got = K.sum_points(pts)
    assert dict(K.SHAPES) == {("sum_tiles_g2", None, 256): 1}
    monkeypatch.setattr(K, "_on_card", lambda t: False)
    _same(K._flat(got), K._flat(K.sum_points(pts)))


def test_glv_g2_kernel_matches_plain(kernel_path):
    """Lane 0 random; lane 1 P3 = 2Q (the step that doubles Q and adds P3
    meets P == Q); lane 2 P3 = -2Q (P == -Q); lane 3 no bits."""
    q = [HG2.mul(HG2.gen, RNG.randrange(1, R)) for _ in range(4)]
    psi2 = [HG2.mul(p, X * X) for p in q]
    two1, two2 = HG2.mul(q[1], 2), HG2.mul(q[2], 2)
    p3 = [HG2.add(q[0], psi2[0]), two1, HG2.neg(two2), HG2.add(q[3], psi2[3])]
    aff = lambda pts: DC.encode_g2_points(pts)[:2]
    b0 = torch.tensor([[RNG.randrange(2) for _ in range(4)]
                       for _ in range(32)], dtype=torch.int32)
    b1 = torch.tensor([[RNG.randrange(2) for _ in range(4)]
                       for _ in range(32)], dtype=torch.int32)
    for lane in (1, 2):
        b0[:2, lane] = 1
        b1[:2, lane] = torch.tensor([0, 1])
    b0[2:, 2] = 0
    b1[2:, 2] = 0
    b0[:, 3] = 0
    b1[:, 3] = 0
    tabs = (aff(q), aff(psi2), aff(p3), b0, b1)
    got = K.scalar_mul_glv_mixed(*tabs)
    assert kernel_path["scalar_mul_glv_mixed_g2"] == 1
    assert K.SHAPES == {("scalar_mul_glv_mixed_g2", 32, 4): 1}
    _same(K._flat(got), K._flat(K.scalar_mul_glv_mixed_plain(*tabs)))
    assert DC.G2.is_infinity(got).tolist() == [False, False, True, True]


# ---------------------------------------------------------------------------
# K6: one scalar per lane, G1 and G2
# ---------------------------------------------------------------------------

# Lane 0 of the G1 input below is the order-3 point (0, 2) (x = 0 makes
# y^2 = b, an inflection point).  Its bits 1, 1, 1, 0, 1, 1 walk the
# complete add through every case: T (infinite accumulator), 2T + T =
# infinity (P == -Q), inf + T (infinite accumulator), 2T kept (zero bit),
# then T + T twice (P == Q, the doubling).
ORDER3_BITS = [1, 1, 1, 0, 1, 1]


def _ladder_var_bits(nbits, lanes, zero_lane):
    """Random MSB-first bits (lanes mix 0 and 1 on every row), lane 0 with
    ORDER3_BITS in front (it is the order-3 point on G1), `zero_lane` an
    all-zero scalar."""
    b = torch.tensor([[RNG.randrange(2) for _ in range(lanes)]
                      for _ in range(nbits)], dtype=torch.int32)
    b[:len(ORDER3_BITS), 0] = torch.tensor(ORDER3_BITS)
    b[:, zero_lane] = 0
    return b


def test_ladder_var_kernel_matches_plain(kernel_path):
    """G1 at 130 bits (the GLV recovery width) over a (2, 4) batch: the
    order-3 point, members, an outsider of G1, infinity, the generator and
    an all-zero scalar; the wrapper flattens the batch to 8 lanes."""
    x, y, z = _points()                  # 3 members, outsider, inf, gen
    t3 = DC.encode_g1_points([(0, 2)])
    pts = tuple(torch.cat([a, b, b[:1]]).reshape(2, 4, 24)
                for a, b in zip(t3, (x, y, z)))
    bits = _ladder_var_bits(130, 8, zero_lane=7).reshape(130, 2, 4)
    got = K.scalar_mul_bits(pts, bits)
    assert kernel_path["scalar_mul_bits"] == 1
    assert K.SHAPES == {("scalar_mul_bits", 130, 8): 1}
    _same(got, K.scalar_mul_bits_plain(pts, bits))
    assert got[0].shape == (2, 4, 24)
    inf = DC.G1.is_infinity(got).reshape(-1).tolist()
    assert inf[5] and inf[7] and not any(inf[i] for i in (1, 2, 3, 6))


def test_ladder_var_g2_kernel_matches_plain(kernel_path):
    """G2 at 66 bits (the GLV recovery width): members, an outsider of G2,
    infinity, the generator and an all-zero scalar.  (E2 has no rational
    3-torsion, so no short scalar reaches the add's P == +-Q cases here;
    chip_smoke.py reaches them with the scalars r and r + 2.)"""
    pts = DC.encode_g2_points(_g2_points() + [HG2.gen])
    bits = _ladder_var_bits(66, 6, zero_lane=5)
    got = K.scalar_mul_bits(pts, bits)
    assert kernel_path["scalar_mul_bits_g2"] == 1
    assert kernel_path["scalar_mul_bits"] == 0
    assert K.SHAPES == {("scalar_mul_bits_g2", 66, 6): 1}
    _same(K._flat(got), K._flat(K.scalar_mul_bits_plain(pts, bits)))
    inf = DC.G2.is_infinity(got).tolist()
    assert inf[3] and inf[5] and not any(inf[i] for i in (1, 4))
