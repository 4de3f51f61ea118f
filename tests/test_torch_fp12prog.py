"""The Fp programs of the group-per-lane K3 / K4 kernels (ops/fp12prog.py).

The programs are run here on Python integers (simulate below, the phase
semantics of csrc/group.cuh) and held against the plain Miller loop
and final exponentiation limb for limb; the tables are checked for the
property the kernels' group synchronisation relies on (no op of a phase
writes a slot another op of that phase reads).  tests/test_torch_kernels_host
runs the same tables through the C++ interpreter.
"""

import importlib.util
import pathlib
import random

import pytest

from drand_tpu_torch.crypto.host.field import fp_inv
from drand_tpu_torch.crypto.host.params import P
from drand_tpu_torch.ops import fp12prog as FP
from drand_tpu_torch.ops import kernels as K
from drand_tpu_torch.ops import limbs as L
from drand_tpu_torch.ops import tower as T

RNG = random.Random(20261017)
SHORT_BITS = [1, 0, 1, 1]
CONSTS = [FP.CONST_VALUES.get(r, 0) for r in range(30)]
MASK = (1 << 384) - 1          # a flag's 12 words all ones


def run_phases(phases, s, nslots):
    """One fragment on the slot values s (field values, not Montgomery), in
    place, with csrc/group.cuh's semantics: every op of a phase reads its
    operands (a select its flag too) before any op writes."""
    rd = lambda i: s[i] if i < nslots else CONSTS[i - nslots]
    for is_prod, ops in phases:
        new = []
        for k, d, a, b in ops:
            x, y = rd(a), rd(b)
            if is_prod:
                r = x * y % P
            elif k & FP.SEL:
                f = s[k >> FP.FLAG_SHIFT]
                r = (x & f) | (y & (MASK ^ f))
            elif k & FP.EQ:
                r = MASK if x == y else 0
            else:
                r = (x + y if k & 3 == FP.ADD else x - y) % P
                if k & FP.HALVE:
                    r = r * FP.CONST_VALUES[FP.HALF_ROW] % P
            new.append((d, r))
        for d, r in new:
            s[d] = r


def simulate(kind, lanes_in, xbits=None):
    """Run a program along its schedule on Python ints: one list of input
    values per lane (inputs at slot 0) -> the 12 output leaves per lane."""
    frags, nslots = FP.compiled(kind)
    inv_in, inv_out = FP.KINDS[kind][2]
    outs = []
    for vals in lanes_in:
        s = list(vals) + [0] * (nslots - len(vals))
        for f in FP.schedule(kind, xbits):
            if f == FP.INVERT:
                s[inv_out] = fp_inv(s[inv_in]) if s[inv_in] else 0
            else:
                run_phases(frags[f], s, nslots)
        outs.append(s[:12])
    return outs


@pytest.mark.parametrize("kind", ["miller", "finalexp"])
def test_tables_race_free_and_in_range(kind):
    frags, nslots = FP.compiled(kind)
    for phases in frags:
        FP._check_phases(phases)
        for is_prod, ops in phases:
            for k, d, a, b in ops:
                assert 0 <= d < nslots
                assert 0 <= a < nslots + 30 and 0 <= b < nslots + 30
                assert (k == FP.PROD) == is_prod
    tab = FP.program(kind)
    assert tab[0] == nslots and tab[1] == len(frags)
    assert len(tab) == 6 + 2 * tab[1] + 3 * tab[2] + 4 * tab[3]


def test_check_phases_rejects_a_race():
    FP._check_phases([(False, [(FP.ADD, 5, 1, 2), (FP.ADD, 6, 1, 3)])])
    FP._check_phases([(False, [(FP.ADD, 5, 5, 2)])])   # an op's own slot
    with pytest.raises(AssertionError):
        FP._check_phases([(False, [(FP.ADD, 5, 1, 2), (FP.SUB, 6, 5, 3)])])
    with pytest.raises(AssertionError):
        FP._check_phases([(True, [(FP.PROD, 5, 1, 2), (FP.PROD, 5, 3, 4)])])
    with pytest.raises(AssertionError):            # a select's flag slot
        FP._check_phases([(False, [(FP.EQ, 5, 1, 2),
                                   (FP.SEL | 5 << FP.FLAG_SHIFT, 6, 3, 4)])])


def test_fragment_shapes():
    """The design's counts: a cyclotomic squaring is one product phase of
    18, a dense product one of 54, a doubling step with its sparse line 100
    products in three phases."""
    fe = FP.frag_stats("finalexp")
    assert fe[FP.FE_CYC]["products"] == 18
    assert fe[FP.FE_CYC]["product_phases"] == 1
    assert fe[FP.FE_MULG]["products"] == 54
    assert fe[FP.FE_MULG]["product_phases"] == 1
    ml = FP.frag_stats("miller")
    assert ml[FP.ML_DBL]["products"] == 100
    assert ml[FP.ML_DBL]["product_phases"] == 3
    lane = FP.lane_counts("miller")
    assert lane["products"] == 63 * 100 + 5 * ml[FP.ML_ADD]["products"]
    assert FP.lane_counts("miller", [0, 0])["products"] == 200


def _dec(fp12):
    return [L.decode_mont(c) for c in T.fp12_leaves(fp12)]


@pytest.mark.parametrize("bits", [SHORT_BITS, None], ids=["short", "|x|"])
def test_miller_program_matches_plain(monkeypatch, bits):
    n = 2
    vals = [[RNG.randrange(P) for _ in range(6)] for _ in range(n)]
    if bits is not None:
        monkeypatch.setattr(K, "XLOOP_BITS", bits)
    got = simulate("miller", vals, bits)
    cols = [L.encode_mont(list(c)) for c in zip(*vals)]
    want = _dec(K.miller_loop_plain(cols[0], cols[1],
                                    ((cols[2], cols[3]), (cols[4], cols[5]))))
    assert got == [[w[i] for w in want] for i in range(n)]


def test_finalexp_program_matches_plain(monkeypatch):
    """Zero, one and random lanes over a short |x|."""
    monkeypatch.setattr(K, "XLOOP_BITS", SHORT_BITS)
    vals = [[0] * 12, [1] + [0] * 11, [RNG.randrange(P) for _ in range(12)]]
    got = simulate("finalexp", vals, SHORT_BITS)
    f = T.fp12_pack([L.encode_mont([v[i] for v in vals]) for i in range(12)])
    want = _dec(K.final_exponentiation_plain(f))
    assert got == [[w[i] for w in want] for i in range(3)]
    assert got[0] == [0] * 12 and got[1] == [1] + [0] * 11


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_need_bound_within_the_programs():
    """chip_smoke.py's operations bound of K3 and K4 (what the function
    needs) counts no more multiply-adds than the programs do for a lane."""
    from drand_tpu_torch.crypto.host import field as HF
    cs = _chip_smoke()
    need = {"miller": cs.need_miller(K.XLOOP_BITS),
            "finalexp": cs.need_finalexp(K.XLOOP_BITS, HF.FROB, P)}
    for kind, n in need.items():
        assert 0.9 * cs.code_group(FP.lane_counts(kind)) < n
        assert n <= cs.code_group(FP.lane_counts(kind))
