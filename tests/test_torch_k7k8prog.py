"""K7's and K8's point programs (ops/fp12prog.py "sum_g1" / "sum_g2",
"glv_g1" / "glv_g2").

The programs that csrc/sum.cu (a thread group per complete add) and
csrc/glv.cu (a thread group per ladder lane) interpret are run here on
Python integers with csrc/group.cuh's phase semantics
(test_torch_fp12prog.run_phases): one K7 add must equal
curve.DevCurve.add limb for limb, one K8 step DevCurve.double followed by
the ladder's select of add_mixed, and K8's whole schedule the plain ladder
(kernels.scalar_mul_glv_mixed_plain, which equals the JAX package's
_ladder_glv_mixed_math), on the adds' edge cases; the tables must be free
of races, the widths the CUDA sources compile must be fp12prog's, and the
bounds chip_smoke.py states must not exceed what the programs do.
tests/test_torch_kernels_host.py runs the same tables through the C++
interpreter.
"""

import re
import random

import pytest
import torch

from drand_tpu_torch.crypto.host.curve import G1 as HG1, G2 as HG2
from drand_tpu_torch.crypto.host.params import P, R, X
from drand_tpu_torch.ops import curve as DC
from drand_tpu_torch.ops import fp12prog as FP
from drand_tpu_torch.ops import kernels as K

from test_torch_fp12prog import MASK, _chip_smoke, run_phases
from test_torch_k6prog import _jacobian, _values

RNG = random.Random(20261020)
KINDS = ["sum_g1", "sum_g2", "glv_g1", "glv_g2"]
BETA = pow(2, (P - 1) // 3, P)


def _host(g2):
    return HG2 if g2 else HG1


def _curve(g2):
    return DC.G2 if g2 else DC.G1


def _rand_point(g2):
    H = _host(g2)
    return H.mul(H.gen, RNG.randrange(1, R))


@pytest.mark.parametrize("kind", KINDS)
def test_tables_race_free_and_in_range(kind):
    frags, nslots = FP.compiled(kind)
    assert len(frags) == (1 if kind.startswith("sum") else 2)
    assert nslots >= FP.KINDS[kind][0]
    for phases in frags:
        FP._check_phases(phases)
        for is_prod, ops in phases:
            for k, d, a, b in ops:
                assert 0 <= d < nslots
                assert all(0 <= s < nslots + 30 for s in (a, b))
                assert (k == FP.PROD) == is_prod
                if k & FP.SEL:
                    assert 0 <= k >> FP.FLAG_SHIFT < nslots
    tab = FP.program(kind)
    assert len(tab) == 6 + 2 * tab[1] + 3 * tab[2] + 4 * tab[3]


def test_layouts_and_compiled_widths():
    """The slots csrc/sum.cu and csrc/glv.cu rely on, and the widths they
    compile (K7_G*_WIDTH, K8_G*_WIDTH) equal fp12prog.WIDTH."""
    for n in (1, 2):
        assert FP.SUM[n] == dict(ACC=0, PT=3 * n, N=6 * n)
        lay = FP.GLV[n]
        assert (lay["ACC"], lay["PT"], lay["PHI"], lay["P3"]) == \
            (0, 3 * n, 5 * n, 7 * n)
        assert (lay["B0"], lay["B1"], lay["N"]) == (9 * n, 9 * n + 1,
                                                   9 * n + 2)
    assert (FP.GLV_INIT, FP.GLV_STEP) == (0, 1)
    for src, names in (("sum.cu", ("K7_G1_WIDTH", "K7_G2_WIDTH")),
                       ("glv.cu", ("K8_G1_WIDTH", "K8_G2_WIDTH"))):
        text = (K.CSRC / src).read_text()
        kinds = ("sum_g1", "sum_g2") if src == "sum.cu" else ("glv_g1",
                                                              "glv_g2")
        for name, kind in zip(names, kinds):
            (w,) = re.findall(rf"\b{name} = (\d+)", text)
            assert int(w) == FP.WIDTH[kind]


def _sum_add(g2, acc_vals, q_vals):
    frags, nslots = FP.compiled("sum_g2" if g2 else "sum_g1")
    n = len(acc_vals)
    s = list(acc_vals) + list(q_vals) + [0] * (nslots - 2 * n)
    run_phases(frags[0], s, nslots)
    return s[:n]


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_sum_add_matches_curve_add(g2):
    """One K7 add against DevCurve.add: a generic pair, acc == Q (the
    doubling), acc == -Q (infinity), acc infinite, Q infinite, both
    infinite, Q a zero-padding lane (every limb 0: the add returns acc limb
    for limb), both padding, and padding on the left.  Jacobian lanes with
    Z != 1, so the equality flags compare representatives; on G2 one Z is
    (0, z), finite with a zero component."""
    H = _host(g2)
    p, q = _rand_point(g2), _rand_point(g2)
    acc = _jacobian(g2, [p, p, p, None, p, None, p, None, None],
                    [None] * 8 + [None])
    rhs = _jacobian(g2, [q, p, H.neg(p), q, None, None, q, q, q],
                    [None] * 8 + [(0, RNG.randrange(1, P)) if g2 else None])
    zero = lambda t: torch.zeros_like(t)
    pad = lambda pt, lanes: DC._tmap(
        lambda t: torch.where(torch.tensor([i in lanes for i in range(9)]
                                           )[:, None], zero(t), t), pt)
    rhs = pad(rhs, (6, 7))
    acc = pad(acc, (7, 8))
    want = _curve(g2).add(acc, rhs)
    got = [_sum_add(g2, a, b) for a, b in zip(_values(acc), _values(rhs))]
    assert got == _values(want)
    assert got[6] == _values(acc)[6]          # + padding: acc itself
    assert got[7] == [0] * len(got[7])        # padding + padding
    inf = _curve(g2).is_infinity(want).tolist()
    assert inf[:6] == [False, False, True, False, False, True]


def _endo(g2, pt):
    """phi on G1 ((x, y) -> (beta x, y)), psi^2 on G2 ([x^2] on G2)."""
    if pt is None:
        return None
    if g2:
        return HG2.mul(pt, X * X)
    return (BETA * pt[0] % P, pt[1])


def _affine(g2, pts):
    return (DC.encode_g2_points if g2 else DC.encode_g1_points)(pts)[:2]


def _glv_lanes(g2, bases, ends, p3s, b0, b1):
    """K8's schedule on each lane: the table in its slots, per step the
    two bits' flags and the step."""
    kind = "glv_g2" if g2 else "glv_g1"
    frags, nslots = FP.compiled(kind)
    lay = FP.GLV[2 if g2 else 1]
    tab = _values(tuple(_affine(g2, bases)) + tuple(_affine(g2, ends))
                  + tuple(_affine(g2, p3s)))
    outs = []
    for lane, vals in enumerate(tab):
        s = [0] * nslots
        s[lay["PT"]:lay["PT"] + len(vals)] = vals
        steps = iter(range(b0.shape[0]))
        for f in FP.schedule(kind, b0[:, lane].tolist()):
            if f == FP.BIT_FLAG:
                i = next(steps)
                s[lay["B0"]] = MASK * int(b0[i, lane])
                s[lay["B1"]] = MASK * int(b1[i, lane])
                continue
            run_phases(frags[f], s, nslots)
        outs.append(s[:lay["PT"]])
    return outs


def _bit_cases(nbits):
    """(b0, b1) columns: all zero, all one, b0 only, b1 only, alternating,
    random."""
    alt = [i % 2 for i in range(nbits)]
    rnd = lambda: [RNG.randrange(2) for _ in range(nbits)]
    cols = [([0] * nbits, [0] * nbits), ([1] * nbits, [1] * nbits),
            ([1] * nbits, [0] * nbits), ([0] * nbits, [1] * nbits),
            (alt, [1 - a for a in alt]), (rnd(), rnd())]
    b0 = torch.tensor([c[0] for c in cols], dtype=torch.int32).T
    b1 = torch.tensor([c[1] for c in cols], dtype=torch.int32).T
    return b0.contiguous(), b1.contiguous()


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_glv_program_matches_plain_ladder(g2):
    """The whole schedule against the plain ladder, with the bits all
    zero, all one, b0 only, b1 only, alternating and random, over real
    tables (P, endo(P), P + endo(P))."""
    nbits = 16
    b0, b1 = _bit_cases(nbits)
    H = _host(g2)
    bases = [_rand_point(g2) for _ in range(b0.shape[1])]
    ends = [_endo(g2, p) for p in bases]
    p3s = [H.add(p, e) for p, e in zip(bases, ends)]
    got = _glv_lanes(g2, bases, ends, p3s, b0, b1)
    tabs = (_affine(g2, bases), _affine(g2, ends), _affine(g2, p3s))
    want = K.scalar_mul_glv_mixed_plain(*tabs, b0, b1)
    assert got == _values(want)
    inf = _curve(g2).is_infinity(want).tolist()
    assert inf == [True] + [False] * 5


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_glv_program_reaches_the_mixed_adds_branches(g2):
    """Crafted tables whose endo entry is 2P or -2P: step 1 (b0 only) sets
    acc = P, step 2 doubles it to 2P and adds the endo entry (b1 only):
    add_mixed's doubling branch, then its infinity branch; a third lane
    adds P3 = 2P by the pair (1, 1)."""
    H = _host(g2)
    p = [_rand_point(g2) for _ in range(3)]
    two = [H.mul(x, 2) for x in p]
    ends = [two[0], H.neg(two[1]), _endo(g2, p[2])]
    p3s = [H.add(p[0], ends[0]), H.add(p[1], _endo(g2, p[1])), two[2]]
    b0 = torch.tensor([[1, 1, 1], [0, 0, 1], [0, 0, 0]], dtype=torch.int32)
    b1 = torch.tensor([[0, 0, 0], [1, 1, 1], [0, 0, 0]], dtype=torch.int32)
    got = _glv_lanes(g2, p, ends, p3s, b0, b1)
    tabs = (_affine(g2, p), _affine(g2, ends), _affine(g2, p3s))
    want = K.scalar_mul_glv_mixed_plain(*tabs, b0, b1)
    assert got == _values(want)
    assert _curve(g2).is_infinity(want).tolist() == [False, True, False]
    dec = DC.decode_g2_points if g2 else DC.decode_g1_points
    assert dec(want) == [H.mul(p[0], 8), None, H.mul(p[2], 8)]


def test_lane_counts():
    """One K7 add is the one fragment; a K8 lane runs the init, then per
    step a flag phase and a step, whatever its bits: its counts follow the
    bit count alone."""
    for kind in ("sum_g1", "sum_g2"):
        st = FP.frag_stats(kind)[0]
        c = FP.lane_counts(kind)
        assert c["products"] == st["products"]
        assert c["critical_products"] == st["critical_products"]
        for w in (2, 4, 8, 16):
            assert FP.lane_counts(kind, None, w)["critical_products"] == \
                FP.frag_stats(kind, w)[0]["critical_products"]
    for kind, step_products in (("glv_g1", 25), ("glv_g2", 64)):
        st = FP.frag_stats(kind)
        assert st[FP.GLV_INIT]["products"] == 0
        assert st[FP.GLV_STEP]["products"] == step_products
        nbits = 32
        counts = [FP.lane_counts(kind, bits) for bits in
                  ([0] * nbits, [1] * nbits,
                   [RNG.randrange(2) for _ in range(nbits)])]
        assert all(c == counts[0] for c in counts)
        assert counts[0]["products"] == nbits * step_products
        assert counts[0]["linear_phases"] == (
            st[FP.GLV_INIT]["linear_phases"]
            + nbits * (st[FP.GLV_STEP]["linear_phases"] + 1))


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_need_bounds_within_the_programs(g2):
    """chip_smoke.py's operations bounds of K7 (a complete add per finite
    point after the first) and K8 (a ladder from its first nonzero step,
    the cheapest formulas) count no more multiply-adds than the code does
    (K7: an add for every lane after the first of a row; K8: an add at
    every step)."""
    cs = _chip_smoke()
    lanes = 512
    z = torch.zeros(lanes, dtype=torch.bool)
    kind = "sum_g2" if g2 else "sum_g1"
    add_need = cs._imad(cs.G2_ADD_NEED) if g2 else cs._imad(11, 5)
    assert cs.need_sum(z.reshape(2, -1), add_need) <= cs.code_sum(
        2, lanes // 2, FP.lane_counts(kind)["products"])
    nbits = 32 if g2 else 64
    b0, b1 = torch.randint(0, 2, (2, nbits, lanes), dtype=torch.int32)
    need = (cs.need_glv_g2 if g2 else cs.need_glv)(b0, b1)
    code = cs.code_group(FP.lane_counts("glv_g2" if g2 else "glv_g1",
                                        [0] * nbits)) * lanes
    assert need <= code
