"""Fp programs of the group-per-lane kernels: K3 and K4 (Fp12), K6, K2, K7
and K8 (points), K5 (an Fp2 power chain).

K3 (``csrc/miller.cu``) and K4 (``csrc/finalexp.cu``) run one warp,
``GROUP`` = 32 threads, per pairing lane; K6 (``csrc/ladder_var.cu``) and
K2 (``csrc/ladder.cu``) run ``WIDTH[kind]`` threads per ladder lane, K8
(``csrc/glv.cu``) per GLV ladder lane and K7 (``csrc/sum.cu``) per
complete add of a point sum.  A
lane's field values live in shared memory, one Fp (12 words) per slot, and
its work is straight-line Fp code cut into phases: in a product phase
every op is a Montgomery product, in a linear phase every op is a +- b,
optionally halved mod p, or one of the two flag ops the complete add needs:
an equality flag (every word all ones or all zeros) and a word-wise select
by such a flag, branchless.  The ops of one phase are independent; the
group's threads take them round robin and synchronise before the next
phase (``csrc/group.cuh``).  A lane's chain of dependent products is then
one product per product phase of at most its width of ops, where the
one-thread-a-lane kernels ran every product in a row.

This module writes those programs.  The formulas are traced over symbolic
Fp values: Karatsuba over the tower for dense products, Granger-Scott
squaring in the cyclotomic subgroup (K4's pow_x chains: the easy part has
already mapped every nonzero input into it), the sparse line product (K3),
the tower inverse down to one Fp inverse (which K4 computes on one thread
by the binary extended gcd), the Miller steps with the field values of
``kernels.dbl_step`` / ``kernels.add_step``, K6's ladder step (the
Jacobian double and complete add of ``curve.DevCurve`` over Fp (G1) or Fp2
(G2) and the selects that pick the step's result), K2's double and
complete add, which the bits of its public scalar schedule, K7's one
complete add of two points of a sum, K8's step (a double, the table
entry its two bits pick, and ``curve.add_mixed``), and K5's Fp2
squaring and products by a table of odd powers or their conjugates, which
the window digits of its public exponent schedule.  Sums are kept
as linear forms over computed values and built as balanced add trees only
where a product or an output needs them.  Each fragment is then cut into
phases (products as early as they can run, each linear op between two
product phases where it adds no depth) and given slots: the named slots
carry the state the kernel's loops keep, temporaries share the rest, and
no op of a phase writes a slot another op of that phase reads.

Field values are unique, so these programs give the plain versions'
results (``kernels.miller_loop_plain``, ``final_exponentiation_plain``,
``scalar_mul_bits_plain``, ``scalar_mul_fixed_plain``,
``sum_rows_plain``, ``scalar_mul_glv_mixed_plain``) limb for limb.  What
fixes a representative is kept: the Miller steps' line coefficients, the
order of updates to f, the hard part's chain, and the group law's field
values (the one point double, K6's and K2's, reaches DevCurve.double's
X3, Y3, Z3 by other products).

``program(kind)`` returns one int32 table per kernel and ``schedule(kind)``
the list of fragments a lane runs (the loops over the bits of |x| or of
K2's scalar), both passed with the launch:

  header  [nslots, nfrags, nphases, nops, inv_in, inv_out]
  frags   2 per fragment: first phase, phase count
  phases  3 per phase: first op, op count, 1 for products / 0 for linear
  ops     4 per op: kind, d, a, b.  kind 0 product; 1 add, 2 sub, | 4
          halve; 8 d = (a == b) as a flag; 16 | f << 8 d = a where the
          flag in slot f is set, else b

Slots below nslots are the lane's; slot nslots + row is row ``row`` of the
constant bundle (``kernels.CONST_NAMES``), row 0 read as zero.
"""

import heapq
from functools import lru_cache

import numpy as np

from ..crypto.host import field as HF
from ..crypto.host.params import P, X as BLS_X

GROUP = 32                     # threads per pairing lane (one warp)
PROD, ADD, SUB, HALVE, EQ, SEL = 0, 1, 2, 4, 8, 16
FLAG_SHIFT = 8                 # a select's flag slot: kind >> FLAG_SHIFT
XBITS = [int(c) for c in bin(-BLS_X)[3:]]   # |x| after the leading 1

# constant bundle rows (kernels.CONST_NAMES) and their values (not Montgomery)
ZERO_ROW, ONE_ROW, HALF_ROW, FROB_ROW = 0, 1, 2, {1: 6, 2: 18}
CONST_VALUES = {ZERO_ROW: 0, ONE_ROW: 1, HALF_ROW: (P + 1) // 2}
for _j in (1, 2):
    for _i, _c in enumerate(HF.FROB[_j]):
        CONST_VALUES[FROB_ROW[_j] + 2 * _i] = _c[0]
        CONST_VALUES[FROB_ROW[_j] + 2 * _i + 1] = _c[1]

_MUL_EST, _LIN_EST = 10, 1     # relative latencies for balancing add trees


_OPS = ("mul", "add", "sub", "eq", "sel")


class _Node:
    """A computed Fp value: an input slot, a constant row, or an op (a
    select's flag in f)."""
    __slots__ = ("id", "kind", "a", "b", "f", "half", "loc", "est")

    def __init__(self, nid, kind, a=None, b=None, f=None, half=False,
                 loc=None, est=0):
        self.id, self.kind, self.a, self.b, self.f = nid, kind, a, b, f
        self.half, self.loc, self.est = half, loc, est

    def operands(self):
        return (self.a, self.b) + ((self.f,) if self.f is not None else ())


class _F:
    """A linear form sum(c * node), halved when `half`: a symbolic Fp."""
    __slots__ = ("g", "terms", "half")

    def __init__(self, g, terms, half=False):
        self.g, self.terms, self.half = g, terms, half

    def _lin(self, o, sign):
        if isinstance(o, int) and o == 0:
            return self
        assert not (self.half or o.half), "halved forms are not summed"
        t = dict(self.terms)
        for n, c in o.terms.items():
            v = t.get(n, 0) + sign * c
            if v:
                t[n] = v
            else:
                t.pop(n, None)
        return _F(self.g, t)

    def __add__(self, o):
        return self._lin(o, 1)

    __radd__ = __add__

    def __sub__(self, o):
        return self._lin(o, -1)

    def __neg__(self):
        assert not self.half
        return _F(self.g, {n: -c for n, c in self.terms.items()})

    def __mul__(self, o):
        if isinstance(o, int):
            assert not self.half
            return _F(self.g, {n: c * o for n, c in self.terms.items()
                               if c * o}) if o else _F(self.g, {})
        return self.g.mul(self, o)

    __rmul__ = __mul__

    def halve(self):
        assert not self.half
        return _F(self.g, dict(self.terms), True)

    def const_value(self):
        """The value of a constant form (None if it depends on slots)."""
        if self.half or any(n.kind != "const" for n in self.terms):
            return None
        return sum(c * CONST_VALUES[n.loc] for n, c in self.terms.items()) % P


class _Frag:
    """One fragment: its graph, then its phases and slots."""

    def __init__(self):
        self.nodes = []
        self.memo = {}
        self.inputs = {}          # slot -> node
        self.consts = {}          # row -> node
        self.outputs = []         # (slot, node)

    def _new(self, kind, **kw):
        n = _Node(len(self.nodes), kind, **kw)
        self.nodes.append(n)
        return n

    def inp(self, slot):
        if slot not in self.inputs:
            self.inputs[slot] = self._new("in", loc=slot)
        return _F(self, {self.inputs[slot]: 1})

    def const(self, row):
        if row not in self.consts:
            self.consts[row] = self._new("const", loc=row)
        return _F(self, {self.consts[row]: 1})

    def zero(self):
        return _F(self, {})

    def _op(self, kind, a, b, half=False, f=None):
        est = max(a.est, b.est, f.est if f is not None else 0)
        return self._new(kind, a=a, b=b, f=f, half=half, est=est + _LIN_EST)

    def _scaled(self, n, j):
        """The node 2^j * n (doublings, shared)."""
        if j == 0:
            return n
        key = ("dbl", n.id, j)
        if key not in self.memo:
            h = self._scaled(n, j - 1)
            self.memo[key] = self._op("add", h, h)
        return self.memo[key]

    def node(self, f):
        """Materialize a form: a balanced tree of adds and subs."""
        if not f.terms:
            self.const(ZERO_ROW)
            return self.consts[ZERO_ROW]
        if not f.half and len(f.terms) == 1:
            (n, c), = f.terms.items()
            if c == 1:
                return n
        key = (tuple(sorted((n.id, c) for n, c in f.terms.items())), f.half)
        if key in self.memo:
            return self.memo[key]
        heap, seq = [], 0
        for n, c in sorted(f.terms.items(), key=lambda nc: nc[0].id):
            for j in range(abs(c).bit_length()):
                if abs(c) >> j & 1:
                    s = self._scaled(n, j)
                    heap.append((s.est, seq, s, c > 0))
                    seq += 1
        heapq.heapify(heap)
        fresh = set()
        while len(heap) > 1:
            _, _, x, px = heapq.heappop(heap)
            _, _, y, py = heapq.heappop(heap)
            if px and py:
                r, pos = self._op("add", x, y), True
            elif px:
                r, pos = self._op("sub", x, y), True
            elif py:
                r, pos = self._op("sub", y, x), True
            else:
                r, pos = self._op("add", x, y), False
            fresh.add(r.id)
            heapq.heappush(heap, (r.est, seq, r, pos))
            seq += 1
        _, _, root, pos = heap[0]
        zero = self.node(self.zero())
        if not pos:
            root = self._op("sub", zero, root, half=f.half)
        elif f.half and root.id in fresh:
            root.half = True
        elif f.half:
            root = self._op("add", root, zero, half=True)
        self.memo[key] = root
        return root

    def mul(self, x, y):
        for a, b in ((x, y), (y, x)):
            v = a.const_value()
            if v == 0:
                return self.zero()
            if v == 1:
                return b
        nx, ny = self.node(x), self.node(y)
        key = ("mul",) + tuple(sorted((nx.id, ny.id)))
        if key not in self.memo:
            self.memo[key] = self._new("mul", a=nx, b=ny,
                                       est=max(nx.est, ny.est) + _MUL_EST)
        return _F(self, {self.memo[key]: 1})

    def eq(self, x, y):
        """The flag x == y: every word of the value all ones, or all zeros
        (a flag is no field value: it only feeds eq's and sel's)."""
        nx, ny = sorted((self.node(x), self.node(y)), key=lambda n: n.id)
        key = ("eq", nx.id, ny.id)
        if key not in self.memo:
            self.memo[key] = self._op("eq", nx, ny)
        return _F(self, {self.memo[key]: 1})

    def sel(self, f, x, y):
        """x where the flag f is set, else y: word by word, no branch.
        With flags for x and y it is a logic op: sel(f, g, 0) = f & g,
        sel(f, 0, g) = g & ~f."""
        nf, nx, ny = self.node(f), self.node(x), self.node(y)
        if nx is ny:
            return _F(self, {nx: 1})
        key = ("sel", nf.id, nx.id, ny.id)
        if key not in self.memo:
            self.memo[key] = self._op("sel", nx, ny, f=nf)
        return _F(self, {self.memo[key]: 1})

    def out(self, slot, f):
        self.outputs.append((slot, self.node(f)))

    # -- phases and slots ----------------------------------------------------

    def _cut(self, ops, outs):
        """Phases: every product as early as it can run, each product phase
        all the products that are ready; a linear op in the gap between two
        product phases where it deepens no chain of linear phases.  Gap g
        (after product phase g) runs the linear ops that a product of phase
        g + 1 or a later gap needs by then, and with them every other
        linear op that fits within their depth; what only the outputs read
        waits for the last gap.  (Running every ready linear op before the
        next products, K6's flag and select chains cost a step 9 linear
        phases more on G1.)"""
        gap, readers = {}, {}
        for n in ops:                     # node ids are topological
            g = max((gap.get(c.id, 0) for c in n.operands()), default=0)
            gap[n.id] = g + 1 if n.kind == "mul" else g
            for c in n.operands():
                readers.setdefault(c.id, []).append(n)
        nprod = max((gap[n.id] for n in ops if n.kind == "mul"), default=0)
        due = {}
        for n in reversed(ops):
            if n.kind == "mul":
                continue
            d = [gap[r.id] - 1 if r.kind == "mul" else due[r.id]
                 for r in readers.get(n.id, [])]
            due[n.id] = min(d + ([nprod] if n.id in outs else []))
        phases, pending = [], [n for n in ops if n.kind != "mul"]
        for g in range(nprod + 1):
            level = {}
            for n in pending:
                if gap[n.id] <= g:
                    level[n.id] = 1 + max((level[c.id] for c in n.operands()
                                           if c.id in level), default=0)
            need = [level[n.id] for n in pending
                    if n.id in level and (due[n.id] == g or g == nprod)]
            depth = max(need, default=0)
            for k in range(1, depth + 1):
                phases.append((False, [n for n in pending
                                       if level.get(n.id) == k]))
            pending = [n for n in pending if level.get(n.id, depth + 1)
                       > depth]
            if g < nprod:
                phases.append((True, [n for n in ops if n.kind == "mul"
                                      and gap[n.id] == g + 1]))
        assert not pending
        return phases

    def compile(self, temp_base):
        """-> (phases [(is_product, [(kind, d, a, b)])], temps used).  Slot
        refs are ints (lane slots) or ("c", row) (constant rows)."""
        live, stack = set(), [n for _, n in self.outputs]
        while stack:
            n = stack.pop()
            if n.id in live:
                continue
            live.add(n.id)
            if n.kind in _OPS:
                stack += n.operands()
        ops = [n for n in self.nodes if n.id in live and n.kind in _OPS]
        phases = self._cut(ops, {n.id for _, n in self.outputs})
        phase_of = {n.id: i for i, (_, batch) in enumerate(phases)
                    for n in batch}
        copy_phase = len(phases)

        reads = {}                        # node id -> [(phase, reader id)]
        for n in ops:
            for c in n.operands():
                reads.setdefault(c.id, []).append((phase_of[n.id], n.id))
        placed, copies, slot_taken = {}, [], set()
        for slot, n in self.outputs:
            assert slot not in slot_taken, f"slot {slot} written twice"
            slot_taken.add(slot)
            if n.kind == "in" and n.loc == slot:
                continue                  # unchanged
            if n.kind in ("in", "const") or n.id in placed:
                copies.append((slot, n))
                reads.setdefault(n.id, []).append((copy_phase, None))
            else:
                placed[n.id] = slot
        # an op placed in its output slot must not overwrite an input that
        # another op still reads in that phase or later
        for nid, slot in list(placed.items()):
            src = self.inputs.get(slot)
            if src is None:
                continue
            p = phase_of[nid]
            if any(q > p or (q == p and r != nid)
                   for q, r in reads.get(src.id, [])):
                del placed[nid]
                n = self.nodes[nid]
                copies.append((slot, n))
                reads.setdefault(nid, []).append((copy_phase, None))
        written = set(placed.values()) | {s for s, _ in copies}
        for slot, n in copies:
            assert n.kind != "in" or n.loc not in written, \
                f"output slot {slot} copies slot {n.loc}, which is rewritten"

        last = {nid: max(q for q, _ in rs) for nid, rs in reads.items()}
        loc = {}
        for n in self.nodes:
            if n.kind == "in":
                loc[n.id] = n.loc
            elif n.kind == "const":
                loc[n.id] = ("c", n.loc)
        loc.update(placed)
        temps = []                        # last read phase of each temp slot

        def own_slot(n, p):
            """A temp operand that n alone reads last, in n's phase: n may
            overwrite it (an op reads its operands before it writes)."""
            for c in n.operands():
                at = loc.get(c.id)
                i = at - temp_base if isinstance(at, int) else -1
                if (i >= 0 and c.id not in placed and last[c.id] == p
                        and all(r == n.id for q, r in reads[c.id]
                                if q == p)):
                    return i
            return None

        for n in sorted(ops, key=lambda n: (phase_of[n.id], n.id)):
            if n.id in placed:
                continue
            assert n.id in last, "an op nobody reads"
            p = phase_of[n.id]
            i = own_slot(n, p)
            if i is None:
                for i, busy in enumerate(temps):
                    if busy < p:
                        break
                else:
                    i = len(temps)
                    temps.append(None)
            temps[i] = last[n.id]
            loc[n.id] = temp_base + i

        def kind(n):
            if n.kind == "sel":
                f = loc[n.f.id]
                assert isinstance(f, int), "a constant flag"
                return SEL | f << FLAG_SHIFT
            return {"mul": PROD, "add": ADD, "sub": SUB, "eq": EQ}[n.kind] \
                | (HALVE if n.half else 0)

        out = [(is_prod, [(kind(n), loc[n.id], loc[n.a.id], loc[n.b.id])
                          for n in sorted(batch, key=lambda n: n.id)])
               for is_prod, batch in phases]
        if copies:
            z = ("c", ZERO_ROW)
            out.append((False, [(ADD, slot, loc[n.id], z)
                                for slot, n in copies]))
        _check_phases(out)
        return out, len(temps)


def _op_reads(k, a, b):
    """The slots an op (kind k, operands a and b) reads."""
    return (a, b, k >> FLAG_SHIFT) if k & SEL else (a, b)


def _check_phases(phases):
    """No op writes a slot that another op of its phase reads, and no two
    ops of a phase write the same slot."""
    for _, ops in phases:
        writes = [d for _, d, _, _ in ops]
        assert len(set(writes)) == len(writes), "two writes to one slot"
        for i, (_, d, a, b) in enumerate(ops):
            assert not isinstance(d, tuple), "write to a constant"
            for j, (k2, _, a2, b2) in enumerate(ops):
                assert i == j or d not in _op_reads(k2, a2, b2), \
                    "read/write race"


# ---------------------------------------------------------------------------
# The tower over symbolic Fp (same layout as tower.py)
# ---------------------------------------------------------------------------

def _fp2_add(a, b):
    return (a[0] + b[0], a[1] + b[1])


def _fp2_sub(a, b):
    return (a[0] - b[0], a[1] - b[1])


def _fp2_neg(a):
    return (-a[0], -a[1])


def _fp2_conj(a):
    return (a[0], -a[1])


def _fp2_xi(a):
    """a * (1 + u)."""
    return (a[0] - a[1], a[0] + a[1])


def _fp2_mul(a, b):
    if b[1].const_value() == 0:          # b in Fp: two products
        return (a[0] * b[0], a[1] * b[0])
    t0, t1 = a[0] * b[0], a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return (t0 - t1, t2 - t0 - t1)


def _fp2_sqr(a):
    m = a[0] * a[1]
    return ((a[0] + a[1]) * (a[0] - a[1]), 2 * m)


def _fp2_mul_fp(a, k):
    return (a[0] * k, a[1] * k)


def _fp6_add(a, b):
    return tuple(_fp2_add(x, y) for x, y in zip(a, b))


def _fp6_sub(a, b):
    return tuple(_fp2_sub(x, y) for x, y in zip(a, b))


def _fp6_neg(a):
    return tuple(_fp2_neg(x) for x in a)


def _fp6_v(a):
    """a * v."""
    return (_fp2_xi(a[2]), a[0], a[1])


def _fp6_mul(a, b=None):
    """Karatsuba over Fp2 (6 Fp2 products); b None squares a."""
    if b is None:
        m = lambda x, _y: _fp2_sqr(x)
        b = a
    else:
        m = _fp2_mul
    t0, t1, t2 = m(a[0], b[0]), m(a[1], b[1]), m(a[2], b[2])
    add = lambda x, y: _mat(x[0].g, _fp2_add(x, y))
    s12 = m(add(a[1], a[2]), add(b[1], b[2]))
    s01 = m(add(a[0], a[1]), add(b[0], b[1]))
    s02 = m(add(a[0], a[2]), add(b[0], b[2]))
    c0 = _fp2_add(t0, _fp2_xi(_fp2_sub(_fp2_sub(s12, t1), t2)))
    c1 = _fp2_add(_fp2_sub(_fp2_sub(s01, t0), t1), _fp2_xi(t2))
    c2 = _fp2_add(_fp2_sub(_fp2_sub(s02, t0), t2), t1)
    return (c0, c1, c2)


def _fp12_mul(a, b):
    """Karatsuba over Fp6: 18 Fp2 products, 54 Fp products."""
    g = a[0][0][0].g
    t0, t1 = _fp6_mul(a[0], b[0]), _fp6_mul(a[1], b[1])
    t2 = _fp6_mul(_mat(g, _fp6_add(a[0], a[1])),
                  _mat(g, _fp6_add(b[0], b[1])))
    return (_fp6_add(t0, _fp6_v(t1)), _fp6_sub(_fp6_sub(t2, t0), t1))


def _fp12_sqr(a):
    """Dense squaring: three Fp6 squarings, 36 Fp products."""
    t0, t1 = _fp6_mul(a[0]), _fp6_mul(a[1])
    t2 = _fp6_mul(_mat(a[0][0][0].g, _fp6_add(a[0], a[1])))
    return (_fp6_add(t0, _fp6_v(t1)), _fp6_sub(_fp6_sub(t2, t0), t1))


def _fp12_conj(a):
    return (a[0], _fp6_neg(a[1]))


def _fp4_sqr(a, b):
    t0, t1 = _fp2_sqr(a), _fp2_sqr(b)
    c1 = _fp2_sub(_fp2_sub(_fp2_sqr(_fp2_add(a, b)), t0), t1)
    return _fp2_add(_fp2_xi(t1), t0), c1


def _fp12_cyclo_sqr(f):
    """Granger-Scott squaring in the cyclotomic subgroup: 9 Fp2 squarings,
    18 Fp products.  Equal to the dense square there."""
    (z0, z4, z3), (z2, z1, z5) = f
    three = lambda t, z, s: tuple(3 * ti + s * 2 * zi for ti, zi in zip(t, z))
    t0, t1 = _fp4_sqr(z0, z1)
    n0, n1 = three(t0, z0, -1), three(t1, z1, 1)
    t0, t1 = _fp4_sqr(z2, z3)
    t2, t3 = _fp4_sqr(z4, z5)
    n4, n5 = three(t0, z4, -1), three(t1, z5, 1)
    n2, n3 = three(_fp2_xi(t3), z2, 1), three(t2, z3, -1)
    return ((n0, n4, n3), (n2, n1, n5))


def _frob_const(g, j, i):
    r = FROB_ROW[j] + 2 * i
    return (g.const(r), g.const(r + 1))


def _fp12_frob(g, f, j):
    """f^(p^j): coefficient i of w^i conjugated for odd j, times gamma_j,i."""
    (c0, c2, c4), (c1, c3, c5) = f
    out = [_fp2_mul(_fp2_conj(c) if j & 1 else c, _frob_const(g, j, i))
           for i, c in enumerate((c0, c1, c2, c3, c4, c5))]
    return ((out[0], out[2], out[4]), (out[1], out[3], out[5]))


def _fp6_mul_01(x, A, B):
    """x * (A + B v): 5 Fp2 products."""
    g = A[0].g
    t0, t1 = _fp2_mul(x[0], A), _fp2_mul(x[1], B)
    c1 = _fp2_sub(_fp2_sub(_fp2_mul(_mat(g, _fp2_add(x[0], x[1])),
                                    _mat(g, _fp2_add(A, B))), t0), t1)
    return (_fp2_add(t0, _fp2_xi(_fp2_mul(x[2], B))), c1,
            _fp2_add(t1, _fp2_mul(x[2], A)))


def _fp6_mul_1(x, C):
    """x * (C v): 3 Fp2 products."""
    return (_fp2_xi(_fp2_mul(x[2], C)), _fp2_mul(x[0], C), _fp2_mul(x[1], C))


def _fp12_mul_line(f, A, B, C):
    """f * ((A, B, 0), (0, C, 0)): the sparse line product, 13 Fp2
    products (39 Fp) in place of a dense product's 54."""
    g = A[0].g
    t0, t1 = _fp6_mul_01(f[0], A, B), _fp6_mul_1(f[1], C)
    t2 = _fp6_mul_01(_mat(g, _fp6_add(f[0], f[1])), A,
                     _mat(g, _fp2_add(B, C)))
    return (_fp6_add(t0, _fp6_v(t1)), _fp6_sub(_fp6_sub(t2, t0), t1))


# ---------------------------------------------------------------------------
# Layouts and fragments
# ---------------------------------------------------------------------------

def _load(g, base, n):
    return [g.inp(base + i) for i in range(n)]


def _fp12_in(g, base):
    v = _load(g, base, 12)
    fp2 = lambda k: (v[2 * k], v[2 * k + 1])
    return ((fp2(0), fp2(1), fp2(2)), (fp2(3), fp2(4), fp2(5)))


def _fp12_leaves(f):
    return [x for c6 in f for c2 in c6 for x in c2]


def _fp12_out(g, base, f):
    for i, x in enumerate(_fp12_leaves(f)):
        g.out(base + i, x)


def _mat(g, f):
    """Materialize every leaf of a nested tuple (a new named value)."""
    if isinstance(f, tuple):
        return tuple(_mat(g, x) for x in f)
    return _F(g, {g.node(f): 1})


# K3: P, Q (affine), R (projective G2), f.  Input and output at slot 0.
ML = dict(PX=0, PY=1, QX=2, QY=4, RX=6, RY=8, RZ=10, F=12, N=24)
ML_INIT, ML_DBL, ML_ADD, ML_FIN = range(4)


def _ml_state(g):
    fp2 = lambda s: (g.inp(s), g.inp(s + 1))
    R = (fp2(ML["RX"]), fp2(ML["RY"]), fp2(ML["RZ"]))
    return R, _fp12_in(g, ML["F"])


def _ml_out(g, R, f):
    for name, c in zip(("RX", "RY", "RZ"), R):
        g.out(ML[name], c[0])
        g.out(ML[name] + 1, c[1])
    _fp12_out(g, ML["F"], f)


def _line(g, f, ell):
    px, py = g.inp(ML["PX"]), g.inp(ML["PY"])
    return _fp12_mul_line(f, ell[0], _fp2_mul_fp(ell[1], px),
                          _fp2_mul_fp(ell[2], py))


def _ml_init(g):
    one, z = g.const(ONE_ROW), g.zero()
    f = (((one, z), (z, z), (z, z)), ((z, z), (z, z), (z, z)))
    q = [g.inp(ML["QX"] + i) for i in range(4)]
    R = ((q[0], q[1]), (q[2], q[3]), (one, z))
    _ml_out(g, R, f)


def _ml_dbl(g):
    """f <- f^2 * line; R <- 2R (kernels.dbl_step's field values)."""
    (Rx, Ry, Rz), f = _ml_state(g)
    f = _mat(g, _fp12_sqr(f))
    t0, t1 = _fp2_sqr(Ry), _fp2_sqr(Rz)
    u, v, m = _fp2_sqr(_fp2_add(Ry, Rz)), _fp2_sqr(Rx), _fp2_mul(Rx, Ry)
    t2 = _mat(g, tuple(3 * 4 * c for c in _fp2_xi(t1)))   # 3 (t1 * b2)
    t3 = tuple(3 * c for c in t2)
    t4 = _fp2_sub(_fp2_sub(u, t1), t0)
    ell = (_fp2_sub(t2, t0), tuple(3 * c for c in v), _fp2_neg(t4))
    hh = _mat(g, tuple(c.halve() for c in _fp2_add(t0, t3)))
    gg = _mat(g, tuple(c.halve() for c in _fp2_sub(t0, t3)))
    R = (_fp2_mul(gg, m), _fp2_sub(_fp2_sqr(hh), tuple(3 * c for c in
                                                        _fp2_sqr(t2))),
         _fp2_mul(t0, t4))
    _ml_out(g, R, _line(g, f, ell))


def _ml_add(g):
    """f <- f * line; R <- R + Q (kernels.add_step's field values)."""
    (Rx, Ry, Rz), f = _ml_state(g)
    Qx = (g.inp(ML["QX"]), g.inp(ML["QX"] + 1))
    Qy = (g.inp(ML["QY"]), g.inp(ML["QY"] + 1))
    t0 = _fp2_sub(Ry, _fp2_mul(Qy, Rz))
    t1 = _fp2_sub(Rx, _fp2_mul(Qx, Rz))
    ell = (_fp2_sub(_fp2_mul(t0, Qx), _fp2_mul(t1, Qy)), _fp2_neg(t0), t1)
    t2 = _fp2_sqr(t1)
    t3, t4 = _fp2_mul(t2, t1), _fp2_mul(t2, Rx)
    t5 = _fp2_add(_fp2_sub(t3, _fp2_add(t4, t4)), _fp2_mul(_fp2_sqr(t0), Rz))
    R = (_fp2_mul(t1, t5),
         _fp2_sub(_fp2_mul(_fp2_sub(t4, t5), t0), _fp2_mul(t3, Ry)),
         _fp2_mul(Rz, t3))
    _ml_out(g, R, _line(g, f, ell))


def _ml_fin(g):
    _, f = _ml_state(g)
    _fp12_out(g, 0, _fp12_conj(f))


# K4: input and output at slot 0; F the easy part's result, G the base and
# ACC the accumulator of a pow_x chain, E1 / E2 the hard part's e1 / e2; C,
# TT, NRM, NINV the tower inverse's pieces around the Fp inverse (in E1's
# slots, which the easy part does not use).
FE = dict(IN=0, F=12, G=24, ACC=36, E1=48, E2=60, C=48, TT=54, NRM=56,
          NINV=57, N=72)
(FE_PRE, FE_POST, FE_CYC, FE_MULG, FE_H1, FE_H2, FE_H3, FE_H4, FE_H5A,
 FE_H5B, FE_H5C, FE_H5D) = range(12)


def _fe_pre(g):
    """The Fp12 inverse down to one Fp norm."""
    a0, a1 = _fp12_in(g, FE["IN"])
    t = _mat(g, _fp6_sub(_fp6_mul(a0), _fp6_v(_fp6_mul(a1))))
    c0 = _mat(g, _fp2_sub(_fp2_sqr(t[0]), _fp2_xi(_fp2_mul(t[1], t[2]))))
    c1 = _mat(g, _fp2_sub(_fp2_xi(_fp2_sqr(t[2])), _fp2_mul(t[0], t[1])))
    c2 = _mat(g, _fp2_sub(_fp2_sqr(t[1]), _fp2_mul(t[0], t[2])))
    tt = _mat(g, _fp2_add(_fp2_xi(_fp2_add(_fp2_mul(t[1], c2),
                                           _fp2_mul(t[2], c1))),
                          _fp2_mul(t[0], c0)))
    for i, x in enumerate([y for c in (c0, c1, c2) for y in c]):
        g.out(FE["C"] + i, x)
    g.out(FE["TT"], tt[0])
    g.out(FE["TT"] + 1, tt[1])
    g.out(FE["NRM"], tt[0] * tt[0] + tt[1] * tt[1])


def _fe_set_base(g, f):
    """f -> G (the next chain's base) and ACC (its accumulator)."""
    _fp12_out(g, FE["G"], f)
    _fp12_out(g, FE["ACC"], f)


def _fe_post(g):
    """Back up the tower: u = 1/in; then the easy part f = conj(in) u,
    f = frob2(f) f."""
    a0, a1 = _fp12_in(g, FE["IN"])
    ld = lambda s, n: _load(g, s, n)
    c = ld(FE["C"], 6)
    tt = ld(FE["TT"], 2)
    ninv = g.inp(FE["NINV"])
    ti = (tt[0] * ninv, -(tt[1] * ninv))
    ti = _mat(g, ti)
    tinv = _mat(g, tuple(_fp2_mul((c[2 * k], c[2 * k + 1]), ti)
                         for k in range(3)))
    u = _mat(g, (_fp6_mul(a0, tinv), _fp6_neg(_fp6_mul(a1, tinv))))
    f = _mat(g, _fp12_mul(_fp12_conj((a0, a1)), u))
    f = _fp12_mul(_mat(g, _fp12_frob(g, f, 2)), f)
    _fp12_out(g, FE["F"], f)
    _fe_set_base(g, f)


def _fe_cyc(g):
    _fp12_out(g, FE["ACC"], _fp12_cyclo_sqr(_fp12_in(g, FE["ACC"])))


def _fe_mulg(g):
    _fp12_out(g, FE["ACC"], _fp12_mul(_fp12_in(g, FE["ACC"]),
                                      _fp12_in(g, FE["G"])))


def _fe_t(g):
    """pow_x's result: conj of the accumulator."""
    return _fp12_conj(_fp12_in(g, FE["ACC"]))


def _fe_h1(g):
    e1 = _fp12_mul(_fe_t(g), _fp12_conj(_fp12_in(g, FE["F"])))
    _fp12_out(g, FE["E1"], e1)
    _fe_set_base(g, e1)


def _fe_h2(g):
    e1 = _fp12_mul(_fe_t(g), _fp12_conj(_fp12_in(g, FE["E1"])))
    _fp12_out(g, FE["E1"], e1)
    _fe_set_base(g, e1)


def _fe_h3(g):
    e2 = _fp12_mul(_fe_t(g), _mat(g, _fp12_frob(g, _fp12_in(g, FE["E1"]),
                                                 1)))
    _fp12_out(g, FE["E2"], e2)
    _fe_set_base(g, e2)


def _fe_h4(g):
    _fe_set_base(g, _fe_t(g))


def _fe_h5a(g):
    """The last chain's end, cut in four fragments to bound the temps:
    G = conj(acc) frob2(e2); E1 = G conj(e2); E2 = f^2 f; out = E1 E2."""
    e2 = _fp12_in(g, FE["E2"])
    _fp12_out(g, FE["G"], _fp12_mul(_fe_t(g), _mat(g, _fp12_frob(g, e2, 2))))


def _fe_h5b(g):
    _fp12_out(g, FE["E1"], _fp12_mul(_fp12_in(g, FE["G"]),
                                     _fp12_conj(_fp12_in(g, FE["E2"]))))


def _fe_h5c(g):
    f = _fp12_in(g, FE["F"])
    _fp12_out(g, FE["E2"], _fp12_mul(_mat(g, _fp12_cyclo_sqr(f)), f))


def _fe_h5d(g):
    _fp12_out(g, 0, _fp12_mul(_fp12_in(g, FE["E1"]), _fp12_in(g, FE["E2"])))


# K6: a point's coordinates are field elements, an Fp as a 1-tuple of forms
# (G1), an Fp2 as a pair (G2), so one set of formulas serves both curves.

def _e_add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _e_sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def _e_scale(a, k):
    return tuple(k * x for x in a)


def _e_mul(a, b):
    return (a[0] * b[0],) if len(a) == 1 else _fp2_mul(a, b)


def _e_sqr(a):
    return (a[0] * a[0],) if len(a) == 1 else _fp2_sqr(a)


def _e_eq(g, a, b):
    """The flag a == b (every component)."""
    f = g.eq(a[0], b[0])
    for x, y in zip(a[1:], b[1:]):
        f = g.sel(f, g.eq(x, y), g.zero())
    return f


def _e_sel(g, f, a, b):
    return tuple(g.sel(f, x, y) for x, y in zip(a, b))


def _e_const(g, v, n):
    """The element v (0 or 1) of a field of n components."""
    return (g.const(ONE_ROW) if v else g.zero(),) + (g.zero(),) * (n - 1)


def _pt_double(g, p):
    """curve.DevCurve.double's field values, so its representative: A =
    X^2, B = Y^2, C = B^2, D = 2((X + B)^2 - A - C), E = 3A; X3 = E^2 - 2D,
    Y3 = E (D - X3) - 8C, Z3 = 2YZ.  D is computed as X * 4B, a product in
    place of a squaring and three linear steps, and E, 4B, D, E^2 and X3
    are materialized once each: G1 6 linear phases and 12 ops, G2 12 and
    51 (one more Fp product)."""
    m = lambda v: tuple(_mat(g, c) for c in v)
    X1, Y1, Z1 = p
    A, B, t = _e_sqr(X1), _e_sqr(Y1), _e_mul(Y1, Z1)
    E = m(_e_scale(A, 3))
    D = m(_e_mul(X1, m(_e_scale(B, 4))))
    C = _e_sqr(B)
    E2 = m(_e_sqr(E))
    X3 = m(_e_sub(E2, _e_scale(D, 2)))
    Y3 = _e_sub(_e_mul(E, _e_sub(D, X3)), _e_scale(C, 8))
    return X3, Y3, _e_scale(t, 2)


# K6 and K2 share their slots and formulas.  Slots: the accumulator at 0
# (the output), P, K6's step bit as a flag (csrc/ladder_var.cu writes it
# before each step), then what depends on P alone: Z2^2, Z2^3 and a flag,
# made once by the first fragment: Z2 == 0 for K6, Z2 != 0 (the add's
# condition) for K2.
def _pt_layout(n, bit):
    """The named slots of K6 (bit: the step's bit flag) or K2 over a field
    of n components."""
    c = 3 * n
    b = 2 * c + int(bit)
    lay = dict(ACC=0, PT=c, ZZ=b, ZZZ=b + n, N=b + 2 * n + 1)
    if bit:
        lay.update(BIT=2 * c, INF2=b + 2 * n)
    else:
        lay.update(FIN2=b + 2 * n)
    return lay


K6 = {1: _pt_layout(1, True), 2: _pt_layout(2, True)}
K6_INIT, K6_STEP = range(2)
K2 = {1: _pt_layout(1, False), 2: _pt_layout(2, False)}
K2_INIT, K2_DBL, K2_ADD = range(3)


def _k6_elem(g, base, n):
    return tuple(g.inp(base + i) for i in range(n))


def _k6_point(g, base, n):
    return tuple(_k6_elem(g, base + n * i, n) for i in range(3))


def _k6_out(g, base, pt):
    for i, x in enumerate(x for c in pt for x in c):
        g.out(base + i, x)


def _pt_init(g, n, lay):
    """acc = infinity (1, 1, 0); P's Z2^2, Z2^3 and its flag."""
    one, zero = _e_const(g, 1, n), _e_const(g, 0, n)
    _k6_out(g, lay["ACC"], (one, one, zero))
    z2 = _k6_elem(g, lay["PT"] + 2 * n, n)
    zz = _e_sqr(z2)
    for i, x in enumerate(zz + _e_mul(z2, zz)):
        g.out(lay["ZZ"] + i, x)
    inf2 = _e_eq(g, z2, zero)
    if "INF2" in lay:
        g.out(lay["INF2"], inf2)
    else:                         # ~inf2: all ones where Z2 == 0 is clear
        g.out(lay["FIN2"], g.sel(inf2, g.zero(), g.eq(g.zero(), g.zero())))


def _pt_operand(g, n, lay):
    """K6's and K2's right operand P and its Z2^2, Z2^3 (made by init)."""
    return (_k6_point(g, lay["PT"], n),
            (_k6_elem(g, lay["ZZ"], n), _k6_elem(g, lay["ZZZ"], n)))


def _pt_add(g, n, acc, q, zz, cond):
    """DevCurve.add(acc, q) with its field values (the embedded doubling
    for acc == q included) where the flag cond() is set, else acc (cond
    builds the flag after the add's flags, which fixes the op order); zz
    holds q's Z2^2 and Z2^3.

    The plain version's selects (curve.py add) give: acc where cond is
    clear; else q where inf1; else the embedded double where U1 == U2 and
    S1 == S2, infinity where U1 == U2 alone, the generic sum where U1 !=
    U2 (in add, same_x carries ~inf1 & ~inf2, which these branches
    already have; cond carries ~inf2)."""
    X2, Y2, Z2 = q
    Z2Z2, t1 = zz
    X1, Y1, Z1 = acc
    # DevCurve.add(acc, q), its products group by group
    Z1Z1, ZS = _e_sqr(Z1), _e_sqr(_e_add(Z1, Z2))
    U1, U2 = _e_mul(X1, Z2Z2), _e_mul(X2, Z1Z1)
    S1, S2 = _e_mul(Y1, t1), _e_mul(Y2, _e_mul(Z1, Z1Z1))
    H = _e_sub(U2, U1)
    rr = _e_scale(_e_sub(S2, S1), 2)
    I = _e_sqr(_e_scale(H, 2))
    J, V, RR = _e_mul(H, I), _e_mul(U1, I), _e_sqr(rr)
    Z3 = _e_mul(_e_sub(_e_sub(ZS, Z1Z1), Z2Z2), H)
    X3 = _e_sub(_e_sub(RR, J), _e_scale(V, 2))
    Y3 = _e_sub(_e_mul(rr, _e_sub(V, X3)), _e_scale(_e_mul(S1, J), 2))
    dbl = _pt_double(g, acc)
    zero = _e_const(g, 0, n)
    inf1 = _e_eq(g, Z1, zero)
    eq_u, eq_s = _e_eq(g, U1, U2), _e_eq(g, S1, S2)
    return _pt_picks(g, acc, q, dbl, (X3, Y3, Z3), inf1, eq_u, eq_s, cond())


def _pt_add_mixed(g, n, acc, t, cond):
    """curve.add_mixed(acc, t) with its field values, t = (X2, Y2) affine
    and never infinity (Z2 = 1 drops five of the complete add's products),
    where the flag cond() is set, else acc.  Its selects give, in the
    plain version's precedence: (X2, Y2, 1) where acc is infinite; else
    the embedded double where U2 == X1 and S2 == Y1, infinity where U2 ==
    X1 alone, the generic sum where U2 != X1."""
    X2, Y2 = t
    X1, Y1, Z1 = acc
    Z1Z1 = _e_sqr(Z1)
    U2, S2 = _e_mul(X2, Z1Z1), _e_mul(Y2, _e_mul(Z1, Z1Z1))
    H = _e_sub(U2, X1)
    HH = _e_scale(H, 2)
    rr = _e_scale(_e_sub(S2, Y1), 2)
    I = _e_sqr(HH)
    J, V, RR = _e_mul(H, I), _e_mul(X1, I), _e_sqr(rr)
    Z3 = _e_mul(Z1, HH)
    X3 = _e_sub(_e_sub(RR, J), _e_scale(V, 2))
    Y3 = _e_sub(_e_mul(rr, _e_sub(V, X3)), _e_scale(_e_mul(Y1, J), 2))
    dbl = _pt_double(g, acc)
    zero, one = _e_const(g, 0, n), _e_const(g, 1, n)
    inf1 = _e_eq(g, Z1, zero)
    eq_u, eq_s = _e_eq(g, U2, X1), _e_eq(g, S2, Y1)
    return _pt_picks(g, acc, (X2, Y2, one), dbl, (X3, Y3, Z3), inf1, eq_u,
                     eq_s, cond())


def _pt_picks(g, acc, at_inf1, dbl, gen, inf1, eq_u, eq_s, cond):
    """The result of an add as one chain of selects under disjoint flags,
    ordered so that the generic sum, which is ready last, is picked last:
    acc where cond is clear; else at_inf1 where inf1; else dbl where eq_u
    and eq_s, infinity where eq_u alone, gen where eq_u is clear."""
    n = len(acc[0])
    f0 = g.zero()
    c_pt = g.sel(cond, inf1, f0)
    c_add = g.sel(inf1, f0, cond)
    c_u = g.sel(c_add, eq_u, f0)
    c_dbl, c_inf = g.sel(c_u, eq_s, f0), g.sel(eq_s, f0, c_u)
    c_gen = g.sel(eq_u, f0, c_add)
    one, zero = _e_const(g, 1, n), _e_const(g, 0, n)
    out = []
    for a, p, inf, d, r in zip(acc, at_inf1, (one, one, zero), dbl, gen):
        v = _e_sel(g, c_pt, p, a)
        v = _e_sel(g, c_inf, inf, v)
        v = _e_sel(g, c_dbl, d, v)
        out.append(_e_sel(g, c_gen, r, v))
    return out


def _k6_init(g, n):
    _pt_init(g, n, K6[n])


def _k6_step(g, n):
    """acc <- 2 acc, then 2 acc + P where the bit is set: DevCurve.double,
    then DevCurve.add(2 acc, P), every step and every lane alike (the
    bit's select folded into the add's: cond = bit & ~inf2)."""
    lay = K6[n]
    acc = _k6_point(g, lay["ACC"], n)
    acc2 = tuple(_mat(g, c) for c in _pt_double(g, acc))
    cond = lambda: g.sel(g.inp(lay["INF2"]), g.zero(), g.inp(lay["BIT"]))
    _k6_out(g, lay["ACC"], _pt_add(g, n, acc2, *_pt_operand(g, n, lay),
                                   cond))


def _k2_init(g, n):
    _pt_init(g, n, K2[n])


def _k2_dbl(g, n):
    """acc <- 2 acc (DevCurve.double): a zero bit of k."""
    lay = K2[n]
    _k6_out(g, lay["ACC"], _pt_double(g, _k6_point(g, lay["ACC"], n)))


def _k2_add(g, n):
    """acc <- DevCurve.add(acc, P): after the double of a one bit of k."""
    lay = K2[n]
    acc = _k6_point(g, lay["ACC"], n)
    _k6_out(g, lay["ACC"], _pt_add(g, n, acc, *_pt_operand(g, n, lay),
                                   lambda: g.inp(lay["FIN2"])))


# K7: one complete add of a point sum (csrc/sum.cu), acc <- DevCurve.add(acc,
# Q), where Q changes at every add: its Z2^2, Z2^3 and its flag Z2 != 0 are
# made inside the fragment.  Slots: acc at 0 (the output), Q at 3n.
SUM = {n: dict(ACC=0, PT=3 * n, N=6 * n) for n in (1, 2)}


def _sum_add(g, n):
    lay = SUM[n]
    acc = _k6_point(g, lay["ACC"], n)
    q = _k6_point(g, lay["PT"], n)
    zz = _e_sqr(q[2])
    inf2 = _e_eq(g, q[2], _e_const(g, 0, n))
    fin2 = lambda: g.sel(inf2, g.zero(), g.eq(g.zero(), g.zero()))
    _k6_out(g, lay["ACC"], _pt_add(g, n, acc, q, (zz, _e_mul(q[2], zz)),
                                   fin2))


# K8: the GLV joint ladder of the RLC (csrc/glv.cu).  Slots: acc at 0 (the
# output), the affine table P, endo(P), P + endo(P) from 3n (inputs), the
# step's two bits as flags (the kernel writes them before each step).
GLV = {n: dict(ACC=0, PT=3 * n, PHI=5 * n, P3=7 * n, B0=9 * n, B1=9 * n + 1,
               N=9 * n + 2) for n in (1, 2)}
GLV_INIT, GLV_STEP = range(2)


def _glv_init(g, n):
    """acc = infinity (1, 1, 0)."""
    one, zero = _e_const(g, 1, n), _e_const(g, 0, n)
    _k6_out(g, GLV[n]["ACC"], (one, one, zero))


def _glv_step(g, n):
    """acc <- 2 acc (DevCurve.double), then add_mixed(2 acc, T) where b0 |
    b1, T = sel(b0, sel(b1, P3, P), sel(b1, endo, P)): the plain ladder's
    selects, word by word on the bit flags, so every lane runs the same
    operations whatever its bits."""
    lay = GLV[n]
    acc = _k6_point(g, lay["ACC"], n)
    acc2 = tuple(_mat(g, c) for c in _pt_double(g, acc))
    b0, b1 = g.inp(lay["B0"]), g.inp(lay["B1"])
    entry = lambda k: (_k6_elem(g, lay[k], n), _k6_elem(g, lay[k] + n, n))
    t = tuple(_e_sel(g, b0, _e_sel(g, b1, c3, c0), _e_sel(g, b1, ce, c0))
              for c0, ce, c3 in zip(entry("PT"), entry("PHI"), entry("P3")))
    _k6_out(g, lay["ACC"], _pt_add_mixed(g, n, acc2, t,
                                         lambda: g.sel(b0, b0, b1)))


# K5: Fp2 x^e for a static public e (csrc/pow2.cu).  x^p = conj(x) in Fp2
# (p = 3 mod 4), so with e = a p + b, x^e = conj(x)^a x^b: one accumulator
# squared once a bit of max(a, b), and multiplied at the sliding-window
# digits of b by a table entry x^d, at those of a by its conjugate, with
# one table of the odd powers x, x^3, ..., x^(2^w - 1).  For the G2 sqrt
# exponent E2 = (p^2 - 9)/16, a has 377 bits and b 381: 380 squarings and
# 157 products where square-and-multiply over E2's 758 bits ran 758 and
# 366.  Slots: the accumulator at 0 (the output), the table from 2 on
# (entry 0 is x, the input), a pair each.
POW2_WINDOW = 4                   # odd powers up to x^15 (PERF.md)
POW2_INIT, POW2_SQR = 0, 1


def _pow2_entries(w):
    return 1 << (w - 1)


def pow2_frag(k, conj, w=POW2_WINDOW):
    """The fragment that multiplies the accumulator by table entry k, or
    by its conjugate."""
    return 2 + k + (_pow2_entries(w) if conj else 0)


def _pow2_entry(g, k):
    return (g.inp(2 + 2 * k), g.inp(3 + 2 * k))


def _pow2_init(g, w):
    """acc = 1; the table x^(2k+1) = x^(2k-1) x^2 from x (entry 0)."""
    g.out(0, g.const(ONE_ROW))
    g.out(1, g.zero())
    t = _pow2_entry(g, 0)
    if w > 1:
        x2 = _mat(g, _fp2_sqr(t))
        for k in range(1, _pow2_entries(w)):
            t = _mat(g, _fp2_mul(t, x2))
            g.out(2 + 2 * k, t[0])
            g.out(3 + 2 * k, t[1])


def _pow2_acc(g):
    return (g.inp(0), g.inp(1))


def _pow2_sqr(g):
    """acc^2 = ((a0 + a1)(a0 - a1), (2 a0) a1): one linear phase, one
    product phase whose two products write the accumulator's slots."""
    a = _pow2_acc(g)
    g.out(0, (a[0] + a[1]) * (a[0] - a[1]))
    g.out(1, (a[0] + a[0]) * a[1])


def _pow2_mul(g, k, conj):
    """acc * T[k], or acc * conj(T[k]) with the conjugate's sign folded
    into the sums: four products, then one linear phase, c0 = a0 b0 -+ a1
    b1, c1 = a0 b1 +- a1 b0 (the lower signs for conj).  Karatsuba's three
    products need a linear phase before them and two after, and ran 4-7 %
    slower (PERF.md)."""
    a, b = _pow2_acc(g), _pow2_entry(g, k)
    s = -1 if conj else 1
    g.out(0, a[0] * b[0] - s * (a[1] * b[1]))
    g.out(1, s * (a[0] * b[1]) + a[1] * b[0])


def pow2_kind(w):
    """KINDS entry of the K5 program at window w."""
    h = _pow2_entries(w)
    frags = [lambda g: _pow2_init(g, w), _pow2_sqr]
    frags += [lambda g, k=k, c=c: _pow2_mul(g, k, c)
              for c in (False, True) for k in range(h)]
    return (2 + 2 * h, frags, (0, 0))


KINDS = {
    "miller": (ML["N"], [_ml_init, _ml_dbl, _ml_add, _ml_fin], (0, 0)),
    "finalexp": (FE["N"], [_fe_pre, _fe_post, _fe_cyc, _fe_mulg, _fe_h1,
                           _fe_h2, _fe_h3, _fe_h4, _fe_h5a, _fe_h5b, _fe_h5c,
                           _fe_h5d],
                 (FE["NRM"], FE["NINV"])),
    "ladder_g1": (K6[1]["N"], [lambda g: _k6_init(g, 1),
                               lambda g: _k6_step(g, 1)], (0, 0)),
    "ladder_g2": (K6[2]["N"], [lambda g: _k6_init(g, 2),
                               lambda g: _k6_step(g, 2)], (0, 0)),
    "fixed_g1": (K2[1]["N"], [lambda g: _k2_init(g, 1),
                              lambda g: _k2_dbl(g, 1),
                              lambda g: _k2_add(g, 1)], (0, 0)),
    "fixed_g2": (K2[2]["N"], [lambda g: _k2_init(g, 2),
                              lambda g: _k2_dbl(g, 2),
                              lambda g: _k2_add(g, 2)], (0, 0)),
    "pow2": pow2_kind(POW2_WINDOW),
    "sum_g1": (SUM[1]["N"], [lambda g: _sum_add(g, 1)], (0, 0)),
    "sum_g2": (SUM[2]["N"], [lambda g: _sum_add(g, 2)], (0, 0)),
    "glv_g1": (GLV[1]["N"], [lambda g: _glv_init(g, 1),
                             lambda g: _glv_step(g, 1)], (0, 0)),
    "glv_g2": (GLV[2]["N"], [lambda g: _glv_init(g, 2),
                             lambda g: _glv_step(g, 2)], (0, 0)),
}
# threads a lane: K3 / K4 a warp; K6 on G1 a quarter warp (no step phase
# holds more than 8 products), on G2 half a warp (up to 18 Fp products a
# phase; a whole warp ran slower, PERF.md); K2 a quarter warp (a double's
# product phases hold at most 3 products on G1, 7 on G2; on G2 8 threads
# were fastest, or within 2 %, at every K2 shape of the main paths:
# tools/torch_group_variants.py, PERF.md); K5 2 threads (its squaring's
# two products; 1 and 4 threads were slower at every K5 shape of the main
# paths, the same tool); K7 (threads an add) 8 on G1 and 16 on G2, where a
# launch leaves the card idle and a sum's chain of adds sets its time; K8
# 4 threads on G1 and 8 on G2, fastest at every K8 shape of the main paths
# (shared memory holds 132 and 56 of its lanes an SM, so a wider group
# idles more issue slots than it saves in chain, PERF.md).
# csrc/ladder_var.cu, csrc/ladder.cu, csrc/pow2.cu, csrc/sum.cu and
# csrc/glv.cu compile the same widths and check them at launch.
WIDTH = {"miller": GROUP, "finalexp": GROUP, "ladder_g1": 8,
         "ladder_g2": 16, "fixed_g1": 8, "fixed_g2": 8, "pow2": 2,
         "sum_g1": 8, "sum_g2": 16, "glv_g1": 4, "glv_g2": 8}
# The second width of K2-G1 (kernels.fixed_width) and of K7
# (kernels.sum_width), for launches that fill the card, where idle threads
# cost issue slots (csrc/ladder.cu, csrc/sum.cu)
FILL_WIDTH = {"fixed_g1": 2, "sum_g1": 4, "sum_g2": 8}


@lru_cache(maxsize=None)
def compiled(kind):
    """-> (fragments [phases], nslots): each phase (is_product, ops) with
    constant refs resolved to slot numbers."""
    named, fns, _ = KINDS[kind]
    frags, ntemp = [], 0
    for fn in fns:
        g = _Frag()
        fn(g)
        phases, nt = g.compile(named)
        frags.append(phases)
        ntemp = max(ntemp, nt)
    nslots = named + ntemp
    res = lambda s: nslots + s[1] if isinstance(s, tuple) else s
    frags = [[(p, [(k, res(d), res(a), res(b)) for k, d, a, b in ops])
              for p, ops in ph] for ph in frags]
    return frags, nslots


@lru_cache(maxsize=None)
def program(kind):
    """The int32 table the kernel reads (layout in the module docstring)."""
    frags, nslots = compiled(kind)
    inv_in, inv_out = KINDS[kind][2]
    ftab, ptab, otab = [], [], []
    for ph in frags:
        ftab += [len(ptab) // 3, len(ph)]
        for is_prod, ops in ph:
            ptab += [len(otab) // 4, len(ops), int(is_prod)]
            for op in ops:
                otab += list(op)
    head = [nslots, len(frags), len(ptab) // 3, len(otab) // 4, inv_in,
            inv_out]
    return np.array(head + ftab + ptab + otab, dtype=np.int32)


def frag_stats(kind, width=None):
    """Per fragment: products, linear ops, product phases, linear phases,
    and the products on one lane's critical path (ceil(n / width) per
    product phase) at `width` threads a lane (default WIDTH[kind])."""
    w, out = width or WIDTH[kind], []
    for ph in compiled(kind)[0]:
        prods = [len(ops) for p, ops in ph if p]
        lins = [len(ops) for p, ops in ph if not p]
        out.append({"products": sum(prods), "linear_ops": sum(lins),
                    "product_phases": len(prods), "linear_phases": len(lins),
                    "critical_products": sum(-(-n // w) for n in prods),
                    "critical_linear": sum(-(-n // w) for n in lins)})
    return out


INVERT = -1       # schedule entry: K4's Fp inverse, slot inv_in -> inv_out
BIT_FLAG = -2     # schedule entry: K6 writes the step's bit as a flag


def window_digits(e, w):
    """Left-to-right sliding windows of e >= 0 at width w: [(position,
    digit)] from the top, each digit odd and below 2^w, e = sum digit *
    2^position, and a window's low bit above the next window's top."""
    bits, out, i = bin(e)[2:], [], 0
    if e == 0:
        return out
    while i < len(bits):
        if bits[i] == "0":
            i += 1
            continue
        j = min(i + w, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        out.append((len(bits) - j, int(bits[i:j], 2)))
        i = j
    return out


def pow2_schedule(e, w=POW2_WINDOW):
    """K5's fragments for x^e, e >= 1: split e = a p + b; the digits of b
    multiply by table entries, those of a by their conjugates, merged by
    position; the accumulator starts at 1 and is squared from the top
    digit's position down to 0."""
    a, b = divmod(e, P)
    digits = sorted([(pos, d, False) for pos, d in window_digits(b, w)]
                    + [(pos, d, True) for pos, d in window_digits(a, w)],
                    key=lambda t: -t[0])
    out, at = [POW2_INIT], None
    for pos, d, conj in digits:
        if at is not None:
            out += [POW2_SQR] * (at - pos)
        out.append(pow2_frag(d >> 1, conj, w))
        at = pos
    return out + [POW2_SQR] * at


def schedule(kind, xbits=None):
    """The fragments one lane runs, in order, for loop bits xbits (|x|
    after its leading one): the kernel walks this list, so the loops over
    the bits of |x| live here and not in the kernels.  K6's xbits are a
    lane's scalar bits: its init, then for each bit, whatever it is, the
    bit's flag and a step (csrc/ladder_var.cu loops so itself).  K2's
    xbits are its public scalar's bits, the leading one included: its
    init, then a double a bit and an add after each one bit.  K5 ("pow2")
    takes its exponent e in place of bits (pow2_schedule)."""
    if kind == "pow2":
        return pow2_schedule(xbits)
    if kind.startswith("ladder"):
        return [K6_INIT] + [BIT_FLAG, K6_STEP] * len(xbits)
    if kind.startswith("glv"):
        return [GLV_INIT] + [BIT_FLAG, GLV_STEP] * len(xbits)
    if kind.startswith("sum"):
        return [0]
    xbits = XBITS if xbits is None else xbits
    loop = lambda step, add: [f for b in xbits
                              for f in ((step, add) if b else (step,))]
    if kind.startswith("fixed"):
        return [K2_INIT] + loop(K2_DBL, K2_ADD)
    if kind == "miller":
        return [ML_INIT] + loop(ML_DBL, ML_ADD) + [ML_FIN]
    out = [FE_PRE, INVERT, FE_POST]
    for end in (FE_H1, FE_H2, FE_H3, FE_H4, FE_H5A):   # the five pow_x
        out += loop(FE_CYC, FE_MULG) + [end]
    return out + [FE_H5B, FE_H5C, FE_H5D]


def lane_counts(kind, xbits=None, width=None):
    """One lane's totals over its schedule: products (code), linear ops,
    and the dependent products and linear steps of its critical path at
    `width` threads a lane.  K4's Fp inverse (binary extended gcd on one
    thread, then one product by R^3) counts as one product, K6's bit flag
    as one linear phase."""
    st = frag_stats(kind, width)
    tot = dict.fromkeys(st[0], 0)
    for f in schedule(kind, xbits):
        if f == INVERT:
            tot["products"] += 1
            tot["critical_products"] += 1
            continue
        if f == BIT_FLAG:
            tot["linear_phases"] += 1
            tot["critical_linear"] += 1
            continue
        for k in tot:
            tot[k] += st[f][k]
    return tot
