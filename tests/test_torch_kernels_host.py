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

K7's `sum_rows` cases against their plain twin are the slowest on the CPU;
they run from tests/test_torch_kernels_host_k7_*.py, so that under
``--dist loadfile`` they spread over workers.  The host build, the
`kernel_path` fixture and the shared inputs are in
tests/torch_kernels_host_lib.py.
"""

import hashlib

import numpy as np
import pytest
import torch

from drand_tpu_torch.crypto.host.curve import G1 as HG1, G2 as HG2
from drand_tpu_torch.crypto.host import field as HF
from drand_tpu_torch.crypto import schemes as S
from drand_tpu_torch.crypto.host import h2c as H2C
from drand_tpu_torch.crypto.host.params import DST_G1, DST_G2, P, R, X
from drand_tpu_torch.ops import curve as DC
from drand_tpu_torch.ops import fp12prog as FP
from drand_tpu_torch.ops import h2c as DH
from drand_tpu_torch.ops import kernels as K
from drand_tpu_torch.ops import limbs as L
from drand_tpu_torch.ops import sha256 as SHA
from drand_tpu_torch.ops import tower as T

from torch_kernels_host_lib import (RNG, _g2_points, _points, _rand_fp,
                                    _same, _sum_rows_input, build_host_lib,
                                    kernel_path)  # noqa: F401  (a fixture)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_lib(tmp_path_factory)


@pytest.mark.parametrize("e", [(P - 3) // 4, P - 2, 5, 1],
                         ids=["(p-3)/4", "p-2", "5", "1"])
def test_pow_kernel_matches_plain(kernel_path, e):
    x = torch.cat([L.encode_mont([0, 1, P - 1, (P + 1) // 2]), _rand_fp(5)])
    got = K.pow_fixed(x, e)
    assert kernel_path["pow_fixed"] == 1
    assert K.SHAPES == {("pow_fixed", e, 9): 1}
    _same([got], [K.pow_fixed_plain(x, e)])
    assert L.decode_mont(got) == [pow(v, e, P) for v in L.decode_mont(x)]


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


def _fp12_lanes(kinds):
    """Fp12 lanes: "zero", "one" or "random" each."""
    def leaf(kind, i):
        if kind == "random":
            return RNG.randrange(P)
        return int(kind == "one" and i == 0)
    return T.fp12_pack([L.encode_mont([leaf(k, i) for k in kinds])
                        for i in range(12)])


SHORT_BITS = [1, 0, 1, 1]           # a short |x|: each chain reaches its adds


@pytest.mark.parametrize("kinds", [["one"], ["zero", "random"],
                                   ["random", "zero", "one", "random",
                                    "random"]],
                         ids=["1 lane", "2 lanes", "5 lanes"])
def test_final_exponentiation_kernel_edge_lanes(kernel_path, monkeypatch,
                                                kinds):
    """Zero and one through K4 beside random lanes (outside the cyclotomic
    subgroup until the easy part maps them in), at 1, 2 and 5 lanes (5 is
    no multiple of the card's 3 lanes a block), over a short |x| so that
    the plain chain stays cheap; the full |x| is the test above."""
    monkeypatch.setattr(K, "XLOOP_BITS", SHORT_BITS)
    f = _fp12_lanes(kinds)
    got = K.final_exponentiation(f)
    assert K.SHAPES == {("final_exponentiation", None, len(kinds)): 1}
    _same(T.fp12_leaves(got), T.fp12_leaves(K.final_exponentiation_plain(f)))
    vals = [L.decode_mont(c) for c in T.fp12_leaves(got)]
    for lane, kind in enumerate(kinds):
        want = {"zero": [0] * 12, "one": [1] + [0] * 11}.get(kind)
        if want is not None:
            assert [v[lane] for v in vals] == want


def test_final_exponentiation_kernel_zero_one_full_chain(kernel_path):
    f = _fp12_lanes(["zero", "one", "random"])
    _same(T.fp12_leaves(K.final_exponentiation(f)),
          T.fp12_leaves(K.final_exponentiation_plain(f)))


def _miller_inputs(n):
    px, py = _rand_fp(n), _rand_fp(n)
    return px, py, ((_rand_fp(n), _rand_fp(n)), (_rand_fp(n), _rand_fp(n)))


@pytest.mark.parametrize("n", [1, 2, 7])
def test_miller_kernel_add_steps(kernel_path, monkeypatch, n):
    """1, 2 and 7 pairs (7: no multiple of the card's 4 lanes a block)
    over short loops: with add steps (the first bit, the last, two in a
    row) the kernel equals the plain loop, and without them the result
    differs, so the add-line path ran and counted."""
    ins = _miller_inputs(n)
    outs = {}
    for bits in ([0, 0, 0, 0], [1, 0, 1, 1]):
        monkeypatch.setattr(K, "XLOOP_BITS", bits)
        got = K.miller_loop(*ins)
        _same(T.fp12_leaves(got), T.fp12_leaves(K.miller_loop_plain(*ins)))
        outs[sum(bits)] = T.fp12_leaves(got)
    assert K.SHAPES == {("miller_loop", None, n): 2}
    assert all(not torch.equal(a, b) for a, b in zip(outs[0], outs[3]))


@pytest.mark.parametrize("kind,tail,width", [
    ("miller", 7, None), ("finalexp", 5, None), ("ladder_g1", 5, None),
    ("ladder_g2", 5, None), ("fixed_g1", 7, None), ("fixed_g1", 7, 2),
    ("fixed_g2", 7, None), ("pow2", 9, None)])
def test_group_layout(kernel_path, kind, tail, width):
    """The layout csrc/group.cuh gives a K2 / K3 / K4 / K5 / K6 launch: at
    least one lane a block, whole warps of lanes, the lanes' slots and the
    constants under 48 KB (no opt-in), and the tail widths the tests run
    are no multiple of it."""
    width = width or FP.WIDTH[kind]
    lanes, smem = K.group_layout(kind, width)
    slots = FP.compiled(kind)[1]
    assert lanes >= 1 and tail % lanes
    assert lanes * width % 32 == 0
    assert lanes * slots * 48 < smem <= 48 * 1024


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
    """sum_tiles on the kernel path: sum_rows over rows of one tile."""
    pts = _sum_input(n)
    got = K.sum_tiles(pts)
    assert kernel_path["sum_rows"] == 1
    assert K.SHAPES == {("sum_rows", n // K.TILE, K.TILE): 1}
    _same(got, K.sum_tiles_plain(pts))
    assert got[0].shape == (n // K.TILE, 24)


def test_sum_points_kernel_path_matches_plain(kernel_path, monkeypatch):
    """1280 lanes: one launch, its 5 tiles and the 5 partials padded to a
    tile; 3 lanes: one launch, a tile of 3 live lanes."""
    for n, shapes in ((1280, {("sum_rows", 1, 1280): 1}),
                      (3, {("sum_rows", 1, 3): 1})):
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
    assert kernel_path["sum_rows_g2"] == 1
    assert K.SHAPES == {("sum_rows_g2", 1, n): 1}
    _same(K._flat(got), K._flat(K.sum_tiles_plain(pts)))
    assert got[0][0].shape == (n // K.TILE, 24)


def test_sum_points_g2_kernel_path_matches_plain(kernel_path, monkeypatch):
    pts = _g2_sum_input(5)
    got = K.sum_points(pts)
    assert dict(K.SHAPES) == {("sum_rows_g2", 1, 5): 1}
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
    an all-zero scalar; the wrapper flattens the batch to 8 lanes, which
    the group kernel runs as 8 thread groups."""
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


def _scalar_bits(ks, nbits):
    return torch.from_numpy(DC.msb_bits(ks, nbits))


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_ladder_var_kernel_16_bits_5_lanes(kernel_path, g2):
    """The DKG's Horner width, 16 bits, over 5 lanes (no multiple of a
    block's lanes): infinity, the generator, an outsider, two members;
    scalars random, 0, 2^16 - 1."""
    if g2:
        g = _g2_points()
        pts = DC.encode_g2_points([g[i] for i in (3, 4, 2, 0, 1)])
    else:
        pts = tuple(c[[4, 5, 3, 0, 1]] for c in _points())
    bits = _scalar_bits([RNG.getrandbits(16), 0, (1 << 16) - 1,
                         RNG.getrandbits(16), 1], 16)
    got = K.scalar_mul_bits(pts, bits)
    name = "scalar_mul_bits_g2" if g2 else "scalar_mul_bits"
    assert K.SHAPES == {(name, 16, 5): 1}
    _same(K._flat(got), K._flat(K.scalar_mul_bits_plain(pts, bits)))


def test_ladder_var_kernel_256_bits(kernel_path):
    """G1 at signing's 256 bits: members with the scalars r (the last
    step's add meets P == -Q: infinity) and r + 2 (P == Q: the doubling),
    a random scalar, the generator with 0, and an infinite point."""
    x, y, z = _points()                  # 3 members, outsider, inf, gen
    pts = tuple(c[[0, 1, 2, 5, 4]] for c in (x, y, z))
    bits = _scalar_bits([R, R + 2, RNG.getrandbits(256), 0,
                         RNG.getrandbits(256)], 256)
    got = K.scalar_mul_bits(pts, bits)
    assert K.SHAPES == {("scalar_mul_bits", 256, 5): 1}
    _same(got, K.scalar_mul_bits_plain(pts, bits))
    inf = DC.G1.is_infinity(got).tolist()
    assert inf == [True, False, False, True, True]


def test_ladder_var_g2_kernel_256_bits(kernel_path):
    """G2 at signing's 256 bits: members with the scalars r (P == -Q in the
    last step: infinity) and r + 2 (P == Q), and the generator with 0."""
    g = _g2_points()
    pts = DC.encode_g2_points([g[0], g[1], g[4]])
    bits = _scalar_bits([R, R + 2, 0], 256)
    got = K.scalar_mul_bits(pts, bits)
    assert K.SHAPES == {("scalar_mul_bits_g2", 256, 3): 1}
    _same(K._flat(got), K._flat(K.scalar_mul_bits_plain(pts, bits)))
    assert DC.G2.is_infinity(got).tolist() == [True, False, True]


# ---------------------------------------------------------------------------
# K2 on the group programs: each compiled width, edge lanes
# ---------------------------------------------------------------------------

K2_CASES = [(False, False), (False, True), (True, False)]
K2_IDS = ["g1-8", "g1-2", "g2-8"]


def _k2_width(monkeypatch, g2, fill):
    """Run K2 at fp12prog.WIDTH, or at G1's FILL_WIDTH (the lane threshold
    set to one lane); -> the width the wrapper will pass."""
    kind = "fixed_g2" if g2 else "fixed_g1"
    if fill:
        monkeypatch.setattr(K, "K2_FILL_LANES", 1)
        return FP.FILL_WIDTH[kind]
    return FP.WIDTH[kind]


def _k2_lanes(g2):
    """7 lanes (no multiple of a block's lanes at any width): infinity, the
    generator, a member, an on-curve point outside the group, two points
    of small order outside the group (G1: orders 3 and 11; G2: 13 and 23),
    which take the add through P == +-Q and an infinite accumulator, and
    infinity again (test_torch_k2prog._lanes)."""
    from test_torch_k2prog import _lanes
    enc = DC.encode_g2_points if g2 else DC.encode_g1_points
    return enc(_lanes(g2) + [None])


@pytest.mark.parametrize("g2,fill", K2_CASES, ids=K2_IDS)
@pytest.mark.parametrize("k", [-X, 1 - X, 3], ids=["|x|", "1-x", "3"])
def test_ladder_group_kernel_edge_lanes(kernel_path, monkeypatch, g2, fill,
                                        k):
    """K2's C++ interpreter at each compiled width against the plain
    ladder: infinity lanes, points of small order, 7 lanes."""
    _k2_width(monkeypatch, g2, fill)
    pts = _k2_lanes(g2)
    got = K.scalar_mul_fixed(pts, k)
    name = "scalar_mul_fixed_g2" if g2 else "scalar_mul_fixed"
    assert K.SHAPES == {(name, k, 7): 1}
    _same(K._flat(got), K._flat(K.scalar_mul_fixed_plain(pts, k)))
    curve = DC.G2 if g2 else DC.G1
    inf = curve.is_infinity(got).tolist()
    assert inf[0] and inf[6] and not inf[1]


@pytest.mark.parametrize("g2,fill", K2_CASES, ids=K2_IDS)
def test_ladder_group_kernel_broadcasts_and_key(kernel_path, monkeypatch,
                                                g2, fill):
    """A Z coordinate shared by every lane (shape (24,)) broadcasts, and a
    255-bit scalar (chip_smoke.py signs its test chain through K2 with
    one) runs its 255 doubles and adds, at each compiled width."""
    _k2_width(monkeypatch, g2, fill)
    pts = _k2_lanes(g2)
    key = RNG.getrandbits(255) | 1 << 254
    one = L.mont_const(1, "cpu")
    if g2:
        bz = (pts[0], pts[1], (one, torch.zeros_like(one)))
        full = (pts[0], pts[1], tuple(L.encode_mont([v] * 7) for v in (1, 0)))
    else:
        bz = (pts[0], pts[1], one)
        full = (pts[0], pts[1], L.encode_mont([1] * 7))
    _same(K._flat(K.scalar_mul_fixed(bz, -X)),
          K._flat(K.scalar_mul_fixed_plain(full, -X)))
    sub = DC._tmap(lambda c: c[3:], pts)
    _same(K._flat(K.scalar_mul_fixed(sub, key)),
          K._flat(K.scalar_mul_fixed_plain(sub, key)))


def test_ladder_group_kernel_refuses_an_uncompiled_width(kernel_path,
                                                         monkeypatch):
    """A width csrc/ladder.cu does not compile is refused at the launch
    (the entry returns 1 and the wrapper raises): no other width runs."""
    monkeypatch.setitem(FP.WIDTH, "fixed_g2", 16)
    with pytest.raises(RuntimeError, match="scalar_mul_fixed_g2"):
        K.scalar_mul_fixed(DC.encode_g2_points(_g2_points()), -X)
    assert kernel_path["scalar_mul_fixed_g2"] == 0


# ---------------------------------------------------------------------------
# K1: the windowed chain (any e) and the constant-time inversion (e = p - 2)
# ---------------------------------------------------------------------------

R_MOD_P = (1 << 384) % P
K1_EXPS = {"(p-3)/4": (P - 3) // 4, "p-2": P - 2, "5": 5, "1": 1, "2": 2,
           "2^64-1": (1 << 64) - 1}
K1_EXPS.update({f"random {b} bits": RNG.getrandbits(b) | 1 << (b - 1)
                for b in (2, 17, 200, 381)})


@pytest.fixture(scope="module")
def k1_lanes():
    """0, 1, p - 1, R mod p (1 in Montgomery form is R^2 mod p as limbs)
    and random values; the plain chain's output for each exponent."""
    vals = [0, 1, P - 1, R_MOD_P] + [RNG.randrange(P) for _ in range(4)]
    x = L.encode_mont(vals)
    return vals, x, {e: K.pow_fixed_plain(x, e) for e in K1_EXPS.values()}


@pytest.mark.parametrize("e", list(K1_EXPS.values()), ids=list(K1_EXPS))
def test_pow_window_kernel_matches_plain_and_pow(kernel_path, k1_lanes, e):
    """Both K1 entries (the windowed chain, the inversion for p - 2) equal
    the plain square-and-multiply and Python's pow on edge and random
    values."""
    vals, x, plain = k1_lanes
    got = K.pow_fixed(x, e)
    assert K.SHAPES == {("pow_fixed", e, len(vals)): 1}
    _same([got], [plain[e]])
    assert L.decode_mont(got) == [pow(v, e, P) for v in vals]


def test_inverse_kernel_matches_python_pow(kernel_path):
    """The constant-time inversion on 1,000 seeded random values and the
    edge values, against pow(x, p - 2, p): 0 -> 0."""
    vals = [0, 1, 2, P - 1, P - 2, R_MOD_P, (P + 1) // 2, (1 << 380) % P,
            (1 << 32) - 1]
    vals += [RNG.randrange(P) for _ in range(1000)]
    got = L.decode_mont(K.pow_fixed(L.encode_mont(vals), P - 2))
    assert got == [pow(v, P - 2, P) for v in vals]
    assert kernel_path["pow_fixed"] == 1


def test_pow_fixed_sends_p_minus_2_to_the_inversion(kernel_path, monkeypatch,
                                                    host_lib):
    """e = p - 2 launches drand_inv and nothing else; other exponents the
    chain, with the table size the schedule asks for; the chain's entry
    refuses a table larger than it compiles."""
    calls = []
    for name in ("drand_pow", "drand_inv"):
        fn = getattr(host_lib, name)
        monkeypatch.setattr(host_lib, name,
                            lambda *a, _f=fn, _n=name: calls.append(
                                (_n, a[4] if _n == "drand_pow" else None))
                            or _f(*a))
    x = _rand_fp(3)
    K.pow_fixed(x, P - 2)
    K.pow_fixed(x, (P - 3) // 4)
    K.pow_fixed(x, 5)
    assert calls == [("drand_inv", None), ("drand_pow", 16), ("drand_pow", 3)]
    out = torch.empty_like(x)
    sched = torch.zeros(1, dtype=torch.int32)
    assert host_lib.drand_pow(x.data_ptr(), out.data_ptr(), sched.data_ptr(),
                              1, 2 ** (K.K1_WINDOW - 1) + 1, 3, None) == 1


# ---------------------------------------------------------------------------
# K5 on the group programs: the Frobenius split, each compiled width
# ---------------------------------------------------------------------------

K5_EXPS = {"E2": E2, "5": 5, "1": 1, "p": P, "p+1": P + 1,
           "random > p": RNG.randrange(P + 2, P * P)}


@pytest.fixture(scope="module")
def k5_lanes():
    """0, 1, u, two values with c1 = 0 and random values; the plain
    chain's output for each exponent."""
    vals = [(0, 0), (1, 0), (0, 1), (P - 1, 0), (RNG.randrange(P), 0)]
    vals += [(RNG.randrange(P), RNG.randrange(P)) for _ in range(4)]
    x = tuple(L.encode_mont([v[c] for v in vals]) for c in (0, 1))
    return vals, x, {e: K.pow_fixed_fp2_plain(x, e)
                     for e in K5_EXPS.values()}


@pytest.mark.parametrize("e", list(K5_EXPS.values()), ids=list(K5_EXPS))
def test_pow2_group_kernel_matches_plain_and_host(kernel_path, k5_lanes, e):
    """K5's C++ interpreter, 9 lanes (no multiple of a block's lanes),
    equals the plain square-and-multiply and host fp2_pow: e < p (no
    conjugate digits), e = p (one), p + 1 (the norm) and a random e > p."""
    vals, x, plain = k5_lanes
    got = K.pow_fixed_fp2(x, e)
    assert K.SHAPES == {("pow_fixed_fp2", e, len(vals)): 1}
    _same(got, plain[e])
    assert list(zip(*[L.decode_mont(c) for c in got])) == \
        [HF.fp2_pow(v, e) for v in vals]


def test_pow2_group_kernel_refuses_an_uncompiled_width(kernel_path,
                                                       monkeypatch):
    """A width csrc/pow2.cu does not compile (4, measured slower) is
    refused at the launch."""
    monkeypatch.setitem(FP.WIDTH, "pow2", 4)
    with pytest.raises(RuntimeError, match="pow_fixed_fp2"):
        K.pow_fixed_fp2(_rand_fp2(3), E2)
    assert kernel_path["pow_fixed_fp2"] == 0


# ---------------------------------------------------------------------------
# K7: a batch of sums in one launch; K8 on a thread group a lane
# ---------------------------------------------------------------------------

def test_sum_rows_refuses_an_uncompiled_width(kernel_path, monkeypatch):
    monkeypatch.setitem(FP.WIDTH, "sum_g1", 3)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        K.sum_rows(_sum_rows_input(False, 1, 5))


def _glv_case(g2, endo_of):
    """Affine tables of 3 lanes and their bits: step 1 (b0 only) sets acc
    = P, step 2 (b1 only) adds the endo entry to 2P; endo_of(P) gives that
    entry (2P: add_mixed's doubling branch, -2P: its infinity branch);
    lane 2 then takes random b0 bits, over 8 steps."""
    H = HG2 if g2 else HG1
    p = [H.mul(H.gen, RNG.randrange(1, R)) for _ in range(3)]
    ends = [endo_of(H, x) for x in p]
    enc = DC.encode_g2_points if g2 else DC.encode_g1_points
    aff = lambda pts: enc(pts)[:2]
    nbits = 8
    b0 = torch.zeros((nbits, 3), dtype=torch.int32)
    b1 = torch.zeros((nbits, 3), dtype=torch.int32)
    b0[0], b1[1] = 1, 1
    b0[2:, 2] = torch.tensor([RNG.randrange(2) for _ in range(nbits - 2)])
    return (aff(p), aff(ends), aff(p), b0, b1)


GLV_ENDOS = {"2P": lambda H, x: H.mul(x, 2),
             "-2P": lambda H, x: H.neg(H.mul(x, 2))}


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
@pytest.mark.parametrize("endo", list(GLV_ENDOS), ids=list(GLV_ENDOS))
def test_glv_kernel_reaches_add_mixed_branches(kernel_path, g2, endo):
    args = _glv_case(g2, GLV_ENDOS[endo])
    got = K.scalar_mul_glv_mixed(*args)
    _same(K._flat(got), K._flat(K.scalar_mul_glv_mixed_plain(*args)))
    inf = K._curve(args[0]).is_infinity(got).tolist()
    assert inf[:2] == [endo == "-2P"] * 2


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_glv_kernel_bit_patterns(kernel_path, g2):
    """Bits all zero, all one, b0 only, b1 only, alternating and seeded
    random, a lane each, 16 steps, over real tables (P, endo(P), P +
    endo(P))."""
    H = HG2 if g2 else HG1
    nbits = 16
    pts = [H.mul(H.gen, RNG.randrange(1, R)) for _ in range(6)]
    if g2:
        ends = [H.mul(x, X * X) for x in pts]
    else:
        beta = pow(2, (P - 1) // 3, P)
        ends = [(beta * x[0] % P, x[1]) for x in pts]
    p3s = [H.add(a, b) for a, b in zip(pts, ends)]
    enc = DC.encode_g2_points if g2 else DC.encode_g1_points
    alt = [i % 2 for i in range(nbits)]
    rnd = lambda: [RNG.randrange(2) for _ in range(nbits)]
    cols = [([0] * nbits, [0] * nbits), ([1] * nbits, [1] * nbits),
            ([1] * nbits, [0] * nbits), ([0] * nbits, [1] * nbits),
            (alt, [1 - a for a in alt]), (rnd(), rnd())]
    b0 = torch.tensor([c[0] for c in cols], dtype=torch.int32).T.contiguous()
    b1 = torch.tensor([c[1] for c in cols], dtype=torch.int32).T.contiguous()
    args = (enc(pts)[:2], enc(ends)[:2], enc(p3s)[:2], b0, b1)
    got = K.scalar_mul_glv_mixed(*args)
    name = "scalar_mul_glv_mixed_g2" if g2 else "scalar_mul_glv_mixed"
    assert dict(K.SHAPES) == {(name, nbits, 6): 1}
    _same(K._flat(got), K._flat(K.scalar_mul_glv_mixed_plain(*args)))
    assert K._curve(args[0]).is_infinity(got).tolist() == \
        [True] + [False] * 5


def test_glv_kernel_refuses_an_uncompiled_width(kernel_path, monkeypatch):
    monkeypatch.setitem(FP.WIDTH, "glv_g1", 3)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        K.scalar_mul_glv_mixed(*glv_tables())


# ---------------------------------------------------------------------------
# H1 (csrc/h2f.cu): SHA-256, expand_message_xmd and hash_to_field
# ---------------------------------------------------------------------------

H1_DST = b"QUUX-V01-CS02-with-expander-SHA256-128"


def _h1_words(msgs, n=None):
    return torch.from_numpy(SHA.pack_msgs_to_words(msgs, n))


@pytest.mark.parametrize("size", [0, 3, 8, 17, 31, 32, 56, 64, 104, 200])
def test_h1_sha256_kernel_matches_plain_and_hashlib(kernel_path, size):
    msgs = [bytes(RNG.randrange(256) for _ in range(size)) for _ in range(5)]
    w = _h1_words(msgs, size)
    got = K.sha256_words(w, size)
    assert K.SHAPES == {("sha256_words", size, 5): 1}
    _same([got], [SHA.sha256_words(w, size)])
    assert SHA.digest_bytes(got) == [hashlib.sha256(m).digest()
                                     for m in msgs]


@pytest.mark.parametrize("msg", [b"", b"abc", b"x" * 17,
                                 b"a512_" + b"a" * 507],
                         ids=["empty", "abc", "17B", "512B"])
@pytest.mark.parametrize("n", [32, 128, 256])
def test_h1_xmd_kernel_matches_plain_and_host(kernel_path, msg, n):
    w = _h1_words([msg] * 3, len(msg))
    got = K.expand_msg_xmd(w, len(msg), H1_DST, n)
    assert K.LAUNCHES["expand_msg_xmd"] == 1
    _same([got], [K.expand_msg_xmd_plain(w, len(msg), H1_DST, n)])
    for row in got.numpy():
        assert row.astype(">u4").tobytes() == \
            H2C.expand_message_xmd(msg, H1_DST, n)


def _h1_messages(kind, lanes=11):
    """(msg, host messages) of a message kind: random rounds, lane 9 a pad
    lane (round 0, no previous signature), chained lanes 2, 5 and 9 with
    has_prev = 0 (the genesis slot)."""
    sch = S.scheme_from_name(S.DEFAULT_SCHEME_ID)
    rounds = [RNG.randrange(1 << 64) for _ in range(lanes)]
    rounds[9] = 0
    rw = _h1_words([r.to_bytes(8, "big") for r in rounds])
    if kind == "raw_unchained":
        return (rw,), [sch.digest_beacon(r, None) for r in rounds]
    prevs = [bytes(RNG.randrange(256) for _ in range(96)) for _ in rounds]
    for i in (2, 5, 9):
        prevs[i] = None
    msgs = [sch.digest_beacon(r, p) for r, p in zip(rounds, prevs)]
    if kind == "msg":
        return (_h1_words(msgs, 32),), msgs
    pw = _h1_words([p or b"\x00" * 96 for p in prevs])
    return (pw, rw, torch.tensor([int(p is not None) for p in prevs])), msgs


@pytest.mark.parametrize("kind", ["msg", "raw_unchained", "raw_chained"])
@pytest.mark.parametrize("fp2", [False, True], ids=["fp", "fp2"])
def test_h1_hash_to_field_kernel_matches_plain_and_host(kernel_path, kind,
                                                        fp2):
    """H1's message front, limb for limb against the plain version and as
    integers against hashlib + the host hash_to_field, pad lanes and
    has_prev = 0 lanes included; one launch, counted by field."""
    msg, msgs = _h1_messages(kind)
    dst = DST_G2 if fp2 else DST_G1
    count = 4 if fp2 else 2
    got = K.hash_to_field(kind, msg, dst, count)
    name = "hash_to_field_fp2" if fp2 else "hash_to_field"
    assert K.SHAPES == {(name, kind, 11): 1}
    _same(got, K.hash_to_field_plain(kind, msg, dst, count))
    ints = [L.decode_mont(u) for u in got]
    for i, m in enumerate(msgs):
        if fp2:
            want = [c for u in H2C.hash_to_field_fp2(m, dst, 2) for c in u]
        else:
            want = H2C.hash_to_field_fp(m, dst, 2)
        assert [col[i] for col in ints] == list(want)


def test_h1_odd_message_lengths_through_the_front(kernel_path):
    """hash_to_field_fp_dev on messages whose last word is partial (the
    fill merged in the kernel) and on an empty message."""
    for msg in (b"", b"abc", b"y" * 31, b"z" * 65):
        u0, u1 = DH.hash_to_field_fp_dev(_h1_words([msg] * 2, len(msg)),
                                         len(msg), DST_G1)
        assert [L.decode_mont(u0)[1], L.decode_mont(u1)[1]] == \
            H2C.hash_to_field_fp(msg, DST_G1, 2)


def test_h1_refuses_a_bad_kind(kernel_path):
    w = _h1_words([b"\x00" * 32])
    with pytest.raises(ValueError, match="message kind"):
        K.hash_to_field("fields", (w,), DST_G1, 2)
    lib = K._lib()
    fr = K._frame_tensor(K.h1_frame(128, DST_G1), "cpu")
    out = torch.empty((1, 24), dtype=torch.int64)
    assert lib.drand_h2f(3, w.data_ptr(), 8, w.data_ptr(), w.data_ptr(),
                         fr.data_ptr(), K._ptrs([out]), 1, 1, None) == 1
