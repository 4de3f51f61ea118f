"""K6's point programs (ops/fp12prog.py "ladder_g1" / "ladder_g2").

The programs that csrc/ladder_var.cu interprets, a thread group per lane,
are run here on Python integers with csrc/group.cuh's phase semantics
(test_torch_fp12prog.run_phases) along the kernel's loop: the init
fragment, then for every bit the bit's flag and one step.  They must equal
the plain ladder (kernels.scalar_mul_bits_plain, which equals the JAX
package's _ladder_var_math) limb for limb, at the ladder's widths and at
the add's edge cases; the tables must be free of races; and a lane must run
the same phases whatever its scalar (signing's scalar is a secret share).
tests/test_torch_kernels_host.py runs the same tables through the C++
interpreter.
"""

import random

import pytest
import torch

from drand_tpu_torch.crypto.host.curve import G1 as HG1, G2 as HG2
from drand_tpu_torch.crypto.host.params import P, R
from drand_tpu_torch.ops import curve as DC
from drand_tpu_torch.ops import fp12prog as FP
from drand_tpu_torch.ops import kernels as K
from drand_tpu_torch.ops import limbs as L

from test_torch_fp12prog import MASK, _chip_smoke, run_phases

RNG = random.Random(20261018)
KINDS = {False: "ladder_g1", True: "ladder_g2"}
ORDER3 = (0, 2)          # a G1 point of order 3 (x = 0: y^2 = b)


def _encode(g2, pts):
    return (DC.encode_g2_points if g2 else DC.encode_g1_points)(pts)


def _values(pt):
    """A batch of Jacobian points -> per lane, its 3n field values in slot
    order (X, Y, Z; an Fp2 as c0, c1)."""
    cols = [L.decode_mont(c.reshape(-1, L.NLIMB)) for c in K._flat(pt)]
    return [list(v) for v in zip(*cols)]


def _lane_state(g2, pt_vals):
    kind = KINDS[g2]
    _, nslots = FP.compiled(kind)
    lay = FP.K6[2 if g2 else 1]
    s = [0] * nslots
    s[lay["PT"]:lay["PT"] + len(pt_vals)] = pt_vals
    return s, lay


def simulate(g2, pt, bits):
    """The kernel's loop over a batch: -> (per lane the accumulator's
    values, per lane the phases it ran as (is_product, op count))."""
    kind = KINDS[g2]
    frags, nslots = FP.compiled(kind)
    outs, traces = [], []
    for lane, vals in enumerate(_values(pt)):
        s, lay = _lane_state(g2, vals)
        row = bits[:, lane].tolist()
        trace, steps = [], iter(row)
        for f in FP.schedule(kind, row):
            if f == FP.BIT_FLAG:
                s[lay["BIT"]] = MASK if next(steps) == 1 else 0
                trace.append((False, 1))
                continue
            run_phases(frags[f], s, nslots)
            trace += [(p, len(ops)) for p, ops in frags[f]]
        outs.append(s[:len(vals)])
        traces.append(trace)
    return outs, traces


def _points(g2, n):
    """n lanes: infinity, the generator, members, and on G1 the order-3
    point in lane 3."""
    H = HG2 if g2 else HG1
    pts = [None, H.gen] + [H.mul(H.gen, RNG.randrange(1, R))
                           for _ in range(n - 2)]
    if not g2:
        pts[3] = ORDER3
    return _encode(g2, pts)


def _bits(nbits, lanes):
    """Random MSB-first bits; lane 0 (infinity) random, lane 1 the scalar
    0, lane 2 all ones, lane 3 on G1 walks the order-3 point through the
    add's cases (inf + T, T + T = -T..., P == Q and P == -Q)."""
    b = torch.tensor([[RNG.randrange(2) for _ in range(lanes)]
                      for _ in range(nbits)], dtype=torch.int32)
    b[:, 1] = 0
    b[:, 2] = 1
    b[:6, 3] = torch.tensor([1, 1, 1, 0, 1, 1])
    return b


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
@pytest.mark.parametrize("nbits", [16, 66])
def test_k6_program_matches_plain(g2, nbits):
    pt = _points(g2, 6)
    bits = _bits(nbits, 6)
    got, _ = simulate(g2, pt, bits)
    assert got == _values(K.scalar_mul_bits_plain(pt, bits))
    curve = DC.G2 if g2 else DC.G1
    inf = curve.is_infinity(K.scalar_mul_bits_plain(pt, bits)).tolist()
    assert inf[0] and inf[1] and not inf[2]


def _jacobian(g2, pts, zs=None):
    """Host points (None: infinity) -> a Jacobian batch (x z^2, y z^3, z),
    z from zs or random per finite lane: other representatives than the
    encoder's Z = 1."""
    from drand_tpu_torch.crypto.host import field as HF
    if g2:
        one, mul = (1, 0), HF.fp2_mul
        rand = lambda: (RNG.randrange(1, P), RNG.randrange(P))
    else:
        one, mul = 1, lambda a, b: a * b % P
        rand = lambda: RNG.randrange(1, P)
    lanes = []
    for pt, z in zip(pts, zs or [None] * len(pts)):
        if pt is None:
            lanes.append((one, one, (0, 0) if g2 else 0))
            continue
        z = z or rand()
        z2 = mul(z, z)
        lanes.append((mul(pt[0], z2), mul(pt[1], mul(z2, z)), z))
    cols = list(zip(*lanes))
    if not g2:
        return tuple(L.encode_mont(list(c)) for c in cols)
    return tuple((L.encode_mont([v[0] for v in c]),
                  L.encode_mont([v[1] for v in c])) for c in cols)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_k6_step_edge_cases(g2):
    """One step driven directly, from a chosen accumulator: 2 acc == P (the
    add's doubling), 2 acc == -P (infinity), acc infinite, P infinite, both
    infinite, and two generic lanes; the bit set on every lane, then
    clear.  The points are Jacobian with Z != 1, so U1 == U2 compares
    representatives, not coordinates; on G2 the last P's Z is (0, z), a
    finite point whose Z has one zero component."""
    H = HG2 if g2 else HG1
    frags, nslots = FP.compiled(KINDS[g2])
    p = H.mul(H.gen, RNG.randrange(1, R))
    half = H.mul(p, (R + 1) // 2)                   # 2 half == P
    q = H.mul(H.gen, RNG.randrange(1, R))
    acc_t = _jacobian(g2, [half, H.neg(half), None, q, None, q, q])
    pt_t = _jacobian(g2, [p, p, p, None, None, p, p],
                     [None] * 6 + [(0, RNG.randrange(1, P)) if g2 else None])
    curve = DC.G2 if g2 else DC.G1
    for bit in (1, 0):
        acc2 = curve.double(acc_t)
        sel = torch.full((7,), bit == 1)
        want = _values(curve.select(sel, curve.add(acc2, pt_t), acc2))
        got = []
        for a, v in zip(_values(acc_t), _values(pt_t)):
            s, lay = _lane_state(g2, v)
            run_phases(frags[FP.K6_INIT], s, nslots)
            s[:len(a)] = a
            s[lay["BIT"]] = MASK * bit
            run_phases(frags[FP.K6_STEP], s, nslots)
            got.append(s[:len(a)])
        assert got == want
    inf = curve.is_infinity(curve.add(curve.double(acc_t), pt_t)).tolist()
    assert inf == [False, True, False, False, True, False, False]


@pytest.mark.parametrize("kind", ["ladder_g1", "ladder_g2"])
def test_k6_tables_race_free_and_in_range(kind):
    frags, nslots = FP.compiled(kind)
    assert len(frags) == 2 and nslots >= FP.KINDS[kind][0]
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


def test_k6_layout_and_width():
    """The slots csrc/ladder_var.cu relies on: the accumulator at 0, P at
    NC, the bit's flag at 2 NC (NC coordinates); init and step fragments
    0 and 1; no step phase wider than G1's group (8 threads)."""
    for n, kind in ((1, "ladder_g1"), (2, "ladder_g2")):
        lay = FP.K6[n]
        assert (lay["ACC"], lay["PT"], lay["BIT"]) == (0, 3 * n, 6 * n)
        assert (FP.K6_INIT, FP.K6_STEP) == (0, 1)
        assert lay["N"] == FP.KINDS[kind][0]
    step = FP.compiled("ladder_g1")[0][FP.K6_STEP]
    assert max(len(ops) for p, ops in step if p) <= FP.WIDTH["ladder_g1"]
    assert FP.WIDTH["ladder_g2"] == 16


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_k6_phases_independent_of_the_scalar(g2):
    """A lane runs the same phases, in the same order, for the scalars 0,
    2^nbits - 1 and random ones, and for an infinite point: the kernel's
    work does not depend on a secret scalar's bits."""
    nbits = 16
    pt = _points(g2, 4)
    bits = torch.tensor([[0, 1, RNG.randrange(2), RNG.randrange(2)]
                         for _ in range(nbits)], dtype=torch.int32)
    _, traces = simulate(g2, pt, bits)
    assert all(t == traces[0] for t in traces)
    counts = [FP.lane_counts(KINDS[g2], bits[:, j].tolist())
              for j in range(4)]
    assert all(c == counts[0] for c in counts)
    st = FP.frag_stats(KINDS[g2])[FP.K6_STEP]
    assert counts[0]["products"] == (FP.frag_stats(KINDS[g2])[FP.K6_INIT]
                                     ["products"] + nbits * st["products"])


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_k6_need_bound_within_the_program(g2):
    """chip_smoke.py's operations bound of K6 (a ladder from P at its first
    1 bit, one double a step and one add a further 1 bit, the cheapest
    formulas) counts no more multiply-adds than the program does."""
    cs = _chip_smoke()
    if g2:
        dbl, add = cs._imad(cs.G2_DBL_NEED), cs._imad(cs.G2_ADD_NEED)
    else:
        dbl, add = cs._imad(2, 5), cs._imad(11, 5)
    for nbits in (256, 130, 66, 16):
        bits = torch.tensor([[RNG.randrange(2) for _ in range(8)]
                             for _ in range(nbits)], dtype=torch.int32)
        bits[:, 0] = 1
        need = cs.need_ladder_var(bits, dbl, add)
        code = cs.code_group(FP.lane_counts(KINDS[g2], [0] * nbits)) * 8
        assert need <= code
