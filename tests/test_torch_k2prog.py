"""K2's point programs (ops/fp12prog.py "fixed_g1" / "fixed_g2").

The programs that csrc/ladder.cu interprets, a thread group per lane, are
run here on Python integers with csrc/group.cuh's phase semantics
(test_torch_fp12prog.run_phases) along the schedule that the scalar's
bits give: the init fragment, then a double a bit and an add after each
one bit.  They must equal the plain ladder (kernels.scalar_mul_fixed_plain,
which equals the JAX package's _ladder_fixed_math) limb for limb, for the
library's scalars |x| and 1 - x, a 255-bit key and k = 1, on lanes that
take the add through all its cases (points of small order outside the
group); the tables must be free of races; and the bound chip_smoke.py
states must not exceed what the program does.
tests/test_torch_kernels_host.py runs the same tables through the C++
interpreter.
"""

import random

import pytest
import torch

from drand_tpu_torch.crypto.host import field as HF
from drand_tpu_torch.crypto.host.curve import G1 as HG1, G2 as HG2
from drand_tpu_torch.crypto.host.params import H1, P, R, X
from drand_tpu_torch.ops import curve as DC
from drand_tpu_torch.ops import fp12prog as FP
from drand_tpu_torch.ops import kernels as K
from drand_tpu_torch.ops import limbs as L

from test_torch_fp12prog import MASK, _chip_smoke, run_phases
from test_torch_k6prog import _jacobian, _values

RNG = random.Random(20261019)
KINDS = {False: "fixed_g1", True: "fixed_g2"}
H2 = (X ** 8 - 4 * X ** 7 + 5 * X ** 6 - 4 * X ** 4 + 6 * X ** 3
      - 4 * X ** 2 - 4 * X + 13) // 9            # the G2 cofactor
KEY = RNG.getrandbits(255) | 1 << 254             # a 255-bit scalar
SCALARS = {"|x|": -X, "1-x": 1 - X, "255 bits": KEY, "1": 1}


def small_order_point(g2, ell):
    """A point of prime order ell | h outside the group: [r h / ell^j] Q
    for an on-curve Q, j the least that leaves a point of order ell."""
    H, h = (HG2, H2) if g2 else (HG1, H1)
    for a in range(1, 200):
        if g2:
            x = (a, 1)
            y = HF.fp2_sqrt(HF.fp2_add(HF.fp2_mul(HF.fp2_sqr(x), x), (4, 4)))
        else:
            x = a
            y = HF.fp_sqrt((a ** 3 + 4) % P)
        if y is None:
            continue
        for j in (1, 2):
            if h % ell ** j == 0:
                t = H.mul((x, y), R * h // ell ** j)
                if t is not None and H.mul(t, ell) is None:
                    return t
    raise AssertionError(f"no point of order {ell}")


# primes that divide the cofactor: h1 = 3 * 11^2 * ..., h2 = 13^2 * 23^2 * ...
SMALL_ORDERS = {False: (3, 11), True: (13, 23)}


def _lanes(g2):
    """Host points: infinity, the generator, a member, an on-curve point
    outside the group, and the points of small order."""
    H = HG2 if g2 else HG1
    a = 1
    while True:
        if g2:
            x = (a, 1)
            y = HF.fp2_sqrt(HF.fp2_add(HF.fp2_mul(HF.fp2_sqr(x), x), (4, 4)))
        else:
            x = a
            y = HF.fp_sqrt((a ** 3 + 4) % P)
        if y is not None and not H.in_subgroup((x, y)):
            break
        a += 1
    return ([None, H.gen, H.mul(H.gen, RNG.randrange(1, R)), (x, y)]
            + [small_order_point(g2, ell) for ell in SMALL_ORDERS[g2]])


def simulate(g2, pt, k):
    """K2's schedule for k over a batch of Jacobian points -> per lane the
    accumulator's values (csrc/ladder.cu loads P at slot 3n, stores the
    accumulator from slot 0)."""
    kind = KINDS[g2]
    frags, nslots = FP.compiled(kind)
    lay = FP.K2[2 if g2 else 1]
    outs = []
    for vals in _values(pt):
        s = [0] * nslots
        s[lay["PT"]:lay["PT"] + len(vals)] = vals
        for f in FP.schedule(kind, L.exp_bits(k)):
            run_phases(frags[f], s, nslots)
        outs.append(s[:len(vals)])
    return outs


@pytest.mark.parametrize("k", list(SCALARS.values()), ids=list(SCALARS))
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_k2_program_matches_plain(g2, k):
    """Affine lanes (Z = 1) and the same points with another Z."""
    pts = _lanes(g2)
    enc = (DC.encode_g2_points if g2 else DC.encode_g1_points)(pts)
    jac = _jacobian(g2, pts)
    for pt in (enc, jac):
        assert simulate(g2, pt, k) == _values(K.scalar_mul_fixed_plain(pt, k))


def _add_cases(k, ell, start):
    """The cases K2's adds meet on a point T of order ell, its ladder for k
    followed modulo ell: acc infinite, acc == T, acc == -T, or another
    multiple (start: the running multiple before the first bit)."""
    cases, m = set(), start
    for b in L.exp_bits(k):
        m = 2 * m % ell
        if b:
            cases.add("inf" if m == 0 else "P" if m == 1 else
                      "-P" if m == ell - 1 else "generic")
            m = (m + 1) % ell
    return cases


def test_k2_small_order_lanes_reach_every_add_case():
    """The lanes of test_k2_program_matches_plain take the add through the
    plain version's picks on each curve: an infinite accumulator, acc == P
    (the embedded doubling), acc == -P (infinity), and the generic sum;
    the infinite P lane takes the remaining one."""
    for g2 in (False, True):
        got = set()
        for ell in SMALL_ORDERS[g2]:
            for k in SCALARS.values():
                got |= _add_cases(k, ell, 0)
        assert got == {"inf", "P", "-P", "generic"}, (g2, got)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_k2_add_edge_cases(g2):
    """The add fragment driven directly from a chosen accumulator: acc ==
    P, acc == -P, acc infinite, P infinite, both infinite, a generic lane
    and, on G2, a P whose Z is (0, z).  Jacobian points with Z != 1, so
    U1 == U2 compares representatives, not coordinates."""
    H = HG2 if g2 else HG1
    frags, nslots = FP.compiled(KINDS[g2])
    lay = FP.K2[2 if g2 else 1]
    p = H.mul(H.gen, RNG.randrange(1, R))
    q = H.mul(H.gen, RNG.randrange(1, R))
    acc_t = _jacobian(g2, [p, H.neg(p), None, q, None, q, q])
    pt_t = _jacobian(g2, [p, p, p, None, None, p, p],
                     [None] * 6 + [(0, RNG.randrange(1, P)) if g2 else None])
    curve = DC.G2 if g2 else DC.G1
    want = _values(curve.add(acc_t, pt_t))
    got = []
    for a, v in zip(_values(acc_t), _values(pt_t)):
        s = [0] * nslots
        s[lay["PT"]:lay["PT"] + len(v)] = v
        run_phases(frags[FP.K2_INIT], s, nslots)
        assert s[lay["FIN2"]] in (0, MASK)
        s[:len(a)] = a
        run_phases(frags[FP.K2_ADD], s, nslots)
        got.append(s[:len(a)])
    assert got == want
    inf = curve.is_infinity(curve.add(acc_t, pt_t)).tolist()
    assert inf == [False, True, False, False, True, False, False]


@pytest.mark.parametrize("kind", ["fixed_g1", "fixed_g2"])
def test_k2_tables_race_free_and_in_range(kind):
    frags, nslots = FP.compiled(kind)
    assert len(frags) == 3 and nslots >= FP.KINDS[kind][0]
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
    assert tab[0] == nslots and tab[1] == len(frags)
    assert len(tab) == 6 + 2 * tab[1] + 3 * tab[2] + 4 * tab[3]


@pytest.mark.parametrize("label,k,adds", [("|x|", -X, 6), ("1-x", 1 - X, 7),
                                          ("1", 1, 1), ("2", 2, 1)])
def test_k2_schedule(label, k, adds):
    """One init, a double a bit of k (64 for |x| and 1 - x) and an add a
    one bit; the lane's counts are the fragments' sums, at either width."""
    for kind in ("fixed_g1", "fixed_g2"):
        sched = FP.schedule(kind, L.exp_bits(k))
        assert sched[0] == FP.K2_INIT and sched.count(FP.K2_INIT) == 1
        assert sched.count(FP.K2_DBL) == k.bit_length()
        assert sched.count(FP.K2_ADD) == adds
        assert all(a == FP.K2_DBL for a, b in zip(sched, sched[1:])
                   if b == FP.K2_ADD)
        for w in {FP.WIDTH[kind], FP.FILL_WIDTH.get(kind, FP.WIDTH[kind])}:
            st = FP.frag_stats(kind, w)
            c = FP.lane_counts(kind, L.exp_bits(k), w)
            for key in c:
                assert c[key] == (st[0][key] + k.bit_length() * st[1][key]
                                  + adds * st[2][key])
    assert (-X).bit_length() == 64 and (1 - X).bit_length() == 64


def test_k2_layout_and_widths():
    """The slots csrc/ladder.cu relies on: the accumulator at 0, P at NC
    (NC coordinates), init, double and add fragments 0, 1, 2; a double's
    product phases fit one round of the group (8 threads); G1's second
    width is the narrower, and kernels.fixed_width takes it from
    K2_FILL_LANES lanes on."""
    for n, kind in ((1, "fixed_g1"), (2, "fixed_g2")):
        lay = FP.K2[n]
        assert (lay["ACC"], lay["PT"]) == (0, 3 * n)
        assert lay["N"] == FP.KINDS[kind][0] == lay["FIN2"] + 1
        dbl = FP.compiled(kind)[0][FP.K2_DBL]
        assert max(len(ops) for p, ops in dbl if p) <= FP.WIDTH[kind] == 8
    assert (FP.K2_INIT, FP.K2_DBL, FP.K2_ADD) == (0, 1, 2)
    assert {k for k in FP.FILL_WIDTH if k.startswith("fixed")} == \
        {"fixed_g1"}
    assert FP.FILL_WIDTH["fixed_g1"] < FP.WIDTH["fixed_g1"]
    edge = K.K2_FILL_LANES
    assert K.fixed_width("fixed_g1", edge - 1) == FP.WIDTH["fixed_g1"]
    assert K.fixed_width("fixed_g1", edge) == FP.FILL_WIDTH["fixed_g1"]
    assert K.fixed_width("fixed_g2", 14336) == FP.WIDTH["fixed_g2"]
    assert 2048 < edge <= 8192


def test_k2_need_bound_within_the_program():
    """chip_smoke.py's operations bound of K2 (a ladder from P at its
    first 1 bit, the cheapest formulas) counts no more multiply-adds than
    the program does for a lane, for each of the scalars above."""
    cs = _chip_smoke()
    for k in SCALARS.values():
        bits = L.exp_bits(k)
        assert cs.need_ladder(k) <= cs.code_group(
            FP.lane_counts("fixed_g1", bits))
        assert cs.need_ladder_g2(k) <= cs.code_group(
            FP.lane_counts("fixed_g2", bits))
