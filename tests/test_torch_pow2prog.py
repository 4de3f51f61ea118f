"""K5's "pow2" program and schedules (ops/fp12prog.py) and K1's digit
schedule (ops/kernels.py), in pure Python.

K5 computes x^e in Fp2 through the Frobenius split e = a p + b, x^e =
conj(x)^a x^b: the program is run here on Python integers along its
schedule (test_torch_fp12prog.run_phases, csrc/group.cuh's phase
semantics) and held against the host fp2_pow; each schedule's exponent
bookkeeping must recombine to e.  K1's window schedule must give back e.
tests/test_torch_kernels_host runs the same tables and schedules through
the C++ kernels.
"""

import random

import pytest

from drand_tpu_torch.crypto.host import field as HF
from drand_tpu_torch.crypto.host.params import P
from drand_tpu_torch.ops import fp12prog as FP
from drand_tpu_torch.ops import kernels as K

from test_torch_fp12prog import _chip_smoke, run_phases

RNG = random.Random(20261018)
E2 = (P * P - 9) // 16
EXPS = {"E2": E2, "5": 5, "1": 1, "2": 2, "p": P, "p+1": P + 1,
        "p-1": P - 1, "2p": 2 * P, "random > p": RNG.randrange(P + 2, P * P),
        "random < p": RNG.randrange(3, P)}


def _lanes():
    """0, 1, u, values with c1 = 0, random values."""
    return ([(0, 0), (1, 0), (0, 1), (P - 1, 0), (RNG.randrange(P), 0)]
            + [(RNG.randrange(P), RNG.randrange(P)) for _ in range(3)])


def pow2_exponents(sched, w=FP.POW2_WINDOW):
    """The exponents (of conj(x), of x) of K5's accumulator after a
    schedule: the bookkeeping that must recombine to e = a p + b."""
    h, ea, eb = 1 << (w - 1), 0, 0
    for f in sched:
        if f == FP.POW2_INIT:
            ea, eb = 0, 0
        elif f == FP.POW2_SQR:
            ea, eb = 2 * ea, 2 * eb
        elif f < FP.pow2_frag(0, True, w):
            eb += 2 * (f - FP.pow2_frag(0, False, w)) + 1
        else:
            ea += 2 * (f - FP.pow2_frag(0, True, w)) + 1
    assert h == FP.pow2_frag(0, True, w) - FP.pow2_frag(0, False, w)
    return ea, eb


def k1_exponent(sched):
    """The exponent a K1 schedule computes: the bookkeeping that must give
    back e."""
    e = 2 * sched[0] + 1
    for op in sched[1:]:
        e = 2 * e if op == K.K1_SQR else e + 2 * op + 1
    return e


def simulate(kind, x, e):
    """One lane of a pow2 program along its schedule: x in at slots 2-3,
    x^e out of slots 0-1."""
    frags, nslots = FP.compiled(kind)
    s = [0, 0, x[0], x[1]] + [0] * (nslots - 4)
    for f in FP.schedule("pow2", e):
        run_phases(frags[f], s, nslots)
    return (s[0], s[1])


@pytest.mark.parametrize("e", list(EXPS.values()), ids=list(EXPS))
def test_pow2_program_matches_fp2_pow(e):
    for x in _lanes():
        assert simulate("pow2", x, e) == HF.fp2_pow(x, e)


@pytest.mark.parametrize("w", [1, 4, 5])
def test_pow2_program_windows(monkeypatch, w):
    """The program at every window the writer offers (window 5 is one of
    the variants tools/torch_group_variants.py times) computes x^e."""
    kind = f"pow2_test_w{w}"
    monkeypatch.setitem(FP.KINDS, kind, FP.pow2_kind(w))
    monkeypatch.setattr(FP, "POW2_WINDOW", w)
    monkeypatch.setattr(FP, "schedule", lambda k, e: FP.pow2_schedule(e, w))
    frags, nslots = FP.compiled(kind)
    assert len(frags) == 2 + 2 * (1 << (w - 1))
    for e in (E2, P + 1, 5):
        for x in _lanes()[2:5]:
            assert simulate(kind, x, e) == HF.fp2_pow(x, e)


@pytest.mark.parametrize("w", [4, 5])
def test_pow2_tables_race_free_and_in_range(w):
    kind = "pow2" if w == FP.POW2_WINDOW else None
    if kind is None:
        kind = f"pow2_race_w{w}"
        FP.KINDS[kind] = FP.pow2_kind(w)
    try:
        frags, nslots = FP.compiled(kind)
        for phases in frags:
            FP._check_phases(phases)
            for is_prod, ops in phases:
                for k, d, a, b in ops:
                    assert 0 <= d < nslots
                    assert 0 <= a < nslots + 30 and 0 <= b < nslots + 30
    finally:
        if kind != "pow2":
            del FP.KINDS[kind]


def test_pow2_layout_and_fragments():
    """The slots csrc/pow2.cu relies on (the accumulator at 0-1, x at 2-3:
    group.cuh's sched_lane<W, 2>), the fragment numbering, and SQR and
    MUL each one product phase and one linear phase: an SQR's products
    one round of the group's 2 threads, a MUL's two."""
    frags, nslots = FP.compiled("pow2")
    h = 1 << (FP.POW2_WINDOW - 1)
    assert FP.KINDS["pow2"][0] == 2 + 2 * h <= nslots
    assert len(frags) == 2 + 2 * h
    assert (FP.POW2_INIT, FP.POW2_SQR) == (0, 1)
    assert FP.pow2_frag(0, False) == 2 and FP.pow2_frag(h - 1, True) == 1 + 2 * h
    w = FP.WIDTH["pow2"]
    for f in [FP.POW2_SQR] + [FP.pow2_frag(k, c) for k in range(h)
                              for c in (False, True)]:
        kinds = [p for p, _ in frags[f]]
        assert sorted(kinds) == [False, True]
        prods = max(len(ops) for p, ops in frags[f] if p)
        assert prods == (w if f == FP.POW2_SQR else 2 * w)
    assert w == 2 and "pow2" not in FP.FILL_WIDTH


@pytest.mark.parametrize("e", [E2, P, P + 1, 1, RNG.randrange(P * P)
                               | 1 << 700], ids=["E2", "p", "p+1", "1", "big"])
def test_pow2_schedule_recombines_to_e(e):
    sched = FP.schedule("pow2", e)
    ea, eb = pow2_exponents(sched)
    assert (ea, eb) == divmod(e, P) and ea * P + eb == e
    assert sched[0] == FP.POW2_INIT and FP.POW2_INIT not in sched[1:]


def test_pow2_schedule_counts_for_e2():
    """E2's split: a of 377 bits, b of 381; one squaring a bit below the
    top digit (b's: its top window is a lone one, at bit 380), and a
    product per window of a and of b."""
    a, b = divmod(E2, P)
    assert (a.bit_length(), b.bit_length()) == (377, 381)
    sched = FP.schedule("pow2", E2)
    w = FP.POW2_WINDOW
    nd = len(FP.window_digits(a, w)) + len(FP.window_digits(b, w))
    assert sched.count(FP.POW2_SQR) == FP.window_digits(b, w)[0][0] == 380
    assert len(sched) - 1 - sched.count(FP.POW2_SQR) == nd == 157


def test_pow2_lane_counts():
    """lane_counts adds up the fragments along the schedule: products,
    and at 4 threads one dependent product a phase; at 2 a MUL's four
    products take two rounds."""
    st = FP.frag_stats("pow2")
    sched = FP.schedule("pow2", E2)
    nsq = sched.count(FP.POW2_SQR)
    nmul = len(sched) - 1 - nsq
    c4 = FP.lane_counts("pow2", E2, 4)
    c2 = FP.lane_counts("pow2", E2, 2)
    assert c4["products"] == st[0]["products"] + 2 * nsq + 4 * nmul
    assert c4["product_phases"] == st[0]["product_phases"] + nsq + nmul
    assert c4["critical_products"] == c4["product_phases"]
    assert c2["critical_products"] == (FP.frag_stats("pow2", 2)[0]
                                       ["critical_products"] + nsq + 2 * nmul)
    assert c4["linear_phases"] == st[0]["linear_phases"] + nsq + nmul


@pytest.mark.parametrize("w", [1, 2, 4, 5])
def test_window_digits(w):
    for e in [1, 2, 3, 5, 1 << 200, (P - 3) // 4, P - 2, E2,
              RNG.getrandbits(381)]:
        digits = FP.window_digits(e, w)
        assert sum(d << pos for pos, d in digits) == e
        assert all(d % 2 == 1 and d < 1 << w for _, d in digits)
        tops = [pos + d.bit_length() for pos, d in digits]
        assert all(pos >= top for (pos, _), top in zip(digits, tops[1:]))
    assert FP.window_digits(0, w) == []


@pytest.mark.parametrize("e", [(P - 3) // 4, P - 2, 5, 1, 2, (1 << 64) - 1,
                               RNG.getrandbits(2) | 2,
                               RNG.getrandbits(381) | 1 << 380],
                         ids=["(p-3)/4", "p-2", "5", "1", "2", "2^64-1",
                              "2 bits", "381 bits"])
def test_k1_schedule_recombines_to_e(e):
    """K1's digit schedule gives back e, its table holds the digits it
    uses and fits csrc/pow.cu's K1_TABLE."""
    sched, ntab = K.pow_schedule(e)
    assert k1_exponent(sched) == e
    assert ntab == max(op for op in sched if op >= 0) + 1
    assert ntab <= 1 << (K.K1_WINDOW - 1)


def test_k1_sqrt_chain_counts():
    """(p-3)/4 at window 5: 457 products where square-and-multiply takes
    607, 376 of them squarings (the table's x^2 included)."""
    e = (P - 3) // 4
    sched, ntab = K.pow_schedule(e)
    sqrs = sched.count(K.K1_SQR) + 1
    prods = len(sched) - 1 - sched.count(K.K1_SQR) + ntab - 1 + sqrs
    assert (prods, sqrs) == (457, 376)
    assert e.bit_length() + bin(e).count("1") == 607   # from acc = 1


def test_k1_k5_need_bound_within_the_code():
    """chip_smoke.py's operations bound of K1 and K5 (the cheapest chain,
    or for p - 2 the cheaper of the window chain and the inversion)
    counts no more than the kernels do, and the split beats E2's plain
    window chain."""
    cs = _chip_smoke()
    assert cs.need_pow2(E2, P) <= cs.code_group(FP.lane_counts("pow2", E2))
    plain = cs._sliding_window(E2)
    assert cs.need_pow2(E2, P) < cs._imad(cs.FP2_M * plain[0]
                                          + cs.FP2_S * plain[1])
    for e in ((P - 3) // 4, 5, (1 << 64) - 1):
        assert cs.need_pow(e) <= cs.code_pow(*K.pow_schedule(e))
    assert cs.need_inv(P) == cs.INV_OPS < cs.need_pow(P - 2)
