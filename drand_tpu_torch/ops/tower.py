"""BLS12-381 field tower on tensors: Fp2, Fp6, Fp12 over the limb engine.

Counterpart of drand_tpu/ops/tower.py, same layout:

  Fp2  : (c0, c1)            c0 + c1*u,          u^2 = -1
  Fp6  : (a, b, c) of Fp2    a + b*v + c*v^2,    v^3 = xi = 1 + u
  Fp12 : (a, b)   of Fp6     a + b*w,            w^2 = v

Every Fp leaf is a ``(..., 24)`` Montgomery limb tensor (limbs.py); elements
are nested tuples.  The multiply formulas are staged: each group of
independent limb products runs as one stacked ``mont_mul`` (``mul_many``),
which keeps the plain engine's op count low on both devices.
"""

from functools import lru_cache

from . import limbs as L
from ..crypto.host import field as HF

# ---------------------------------------------------------------------------
# Fp2
# ---------------------------------------------------------------------------


def fp2_add(a, b):
    r = L.add_many([(a[0], b[0]), (a[1], b[1])])
    return (r[0], r[1])


def fp2_sub(a, b):
    r = L.sub_many([(a[0], b[0]), (a[1], b[1])])
    return (r[0], r[1])


def fp2_neg(a):
    return (L.neg_mod(a[0]), L.neg_mod(a[1]))


def fp2_mul_many(pairs):
    """k independent Fp2 products in 4 staged wide ops (3k limb muls in one)."""
    k = len(pairs)
    sums = L.add_many([(a[0], a[1]) for a, _ in pairs]
                      + [(b[0], b[1]) for _, b in pairs])
    t = L.mul_many(
        [(a[0], b[0]) for a, b in pairs]
        + [(a[1], b[1]) for a, b in pairs]
        + [(sums[i], sums[k + i]) for i in range(k)])
    t0, t1, t2 = t[:k], t[k:2 * k], t[2 * k:]
    s = L.sub_many([(t0[i], t1[i]) for i in range(k)]
                   + [(t2[i], t0[i]) for i in range(k)])
    c0, u = s[:k], s[k:]
    c1 = L.sub_many([(u[i], t1[i]) for i in range(k)])
    return [(c0[i], c1[i]) for i in range(k)]


def fp2_mul(a, b):
    return fp2_mul_many([(a, b)])[0]


def fp2_sqr_many(xs):
    """(a0+a1)(a0-a1), 2*a0*a1 — 2k limb muls in one stage."""
    k = len(xs)
    sums = L.add_many([(a[0], a[1]) for a in xs])
    difs = L.sub_many([(a[0], a[1]) for a in xs])
    t = L.mul_many([(sums[i], difs[i]) for i in range(k)]
                   + [(a[0], a[1]) for a in xs])
    c1 = L.add_many([(t[k + i], t[k + i]) for i in range(k)])
    return [(t[i], c1[i]) for i in range(k)]


def fp2_sqr(a):
    return fp2_sqr_many([a])[0]


def fp2_mul_fp(a, k):
    r = L.mul_many([(a[0], k), (a[1], k)])
    return (r[0], r[1])


def fp2_conj(a):
    return (a[0], L.neg_mod(a[1]))


def fp2_mul_xi(a):
    """Multiply by xi = 1 + u:  (c0 - c1) + (c0 + c1) u."""
    return (L.sub_mod(a[0], a[1]), L.add_mod(a[0], a[1]))


def fp2_inv(a, inv=L.inv_mod):
    """1/a via one Fp inversion of the norm (`inv`: the Fp inverse, K1 by
    default)."""
    t = L.mul_many([(a[0], a[0]), (a[1], a[1])])
    ninv = inv(L.add_mod(t[0], t[1]))
    r = L.mul_many([(a[0], ninv), (a[1], ninv)])
    return (r[0], L.neg_mod(r[1]))


def fp2_pow_fixed(a, e: int):
    """a^e in Fp2 for a static exponent: square-and-multiply MSB-first.
    Chains of 64 bits or more (the G2 sqrt_ratio exponent (p^2-9)/16) are
    kernel K5 (``kernels.pow_fixed_fp2``); shorter ones the plain loop."""
    from . import kernels
    if e.bit_length() >= 64:
        return kernels.pow_fixed_fp2(a, e)
    return kernels.pow_fixed_fp2_plain(a, e)


def fp2_is_zero(a):
    return L.is_zero(a[0]) & L.is_zero(a[1])


def fp2_eq(a, b):
    return L.eq(a[0], b[0]) & L.eq(a[1], b[1])


def fp2_select(cond, a, b):
    return (L.select(cond, a[0], b[0]), L.select(cond, a[1], b[1]))


def fp2_zeros_like(x):
    z = x.new_zeros(x.shape)
    return (z, z)


def fp2_ones_like(x):
    return (L.ones_like(x), x.new_zeros(x.shape))


# ---------------------------------------------------------------------------
# Fp6 = Fp2[v]/(v^3 - xi), xi = 1 + u
# ---------------------------------------------------------------------------


def fp6_add(a, b):
    r = L.add_many([(x[0], y[0]) for x, y in zip(a, b)]
                   + [(x[1], y[1]) for x, y in zip(a, b)])
    return tuple((r[i], r[3 + i]) for i in range(3))


def fp6_sub(a, b):
    r = L.sub_many([(x[0], y[0]) for x, y in zip(a, b)]
                   + [(x[1], y[1]) for x, y in zip(a, b)])
    return tuple((r[i], r[3 + i]) for i in range(3))


def fp6_neg(a):
    return tuple(fp2_neg(x) for x in a)


def fp6_mul_many(pairs):
    """k Fp6 products, Karatsuba-3: 6k Fp2 products in one fp2_mul_many."""
    k = len(pairs)
    pre = L.add_many(
        [p for a, b in pairs for p in (
            (a[1][0], a[2][0]), (a[1][1], a[2][1]),
            (b[1][0], b[2][0]), (b[1][1], b[2][1]),
            (a[0][0], a[1][0]), (a[0][1], a[1][1]),
            (b[0][0], b[1][0]), (b[0][1], b[1][1]),
            (a[0][0], a[2][0]), (a[0][1], a[2][1]),
            (b[0][0], b[2][0]), (b[0][1], b[2][1]),
        )])
    prods = []
    for i, (a, b) in enumerate(pairs):
        o = i * 12
        prods += [(a[0], b[0]), (a[1], b[1]), (a[2], b[2]),
                  ((pre[o + 0], pre[o + 1]), (pre[o + 2], pre[o + 3])),
                  ((pre[o + 4], pre[o + 5]), (pre[o + 6], pre[o + 7])),
                  ((pre[o + 8], pre[o + 9]), (pre[o + 10], pre[o + 11]))]
    t = fp2_mul_many(prods)
    out = []
    for i in range(k):
        t0, t1, t2, tc12, tc01, tc02 = t[6 * i:6 * i + 6]
        c0 = fp2_add(t0, fp2_mul_xi(fp2_sub(fp2_sub(tc12, t1), t2)))
        c1 = fp2_add(fp2_sub(fp2_sub(tc01, t0), t1), fp2_mul_xi(t2))
        c2 = fp2_add(fp2_sub(fp2_sub(tc02, t0), t2), t1)
        out.append((c0, c1, c2))
    return out


def fp6_mul(a, b):
    return fp6_mul_many([(a, b)])[0]


def fp6_mul_by_v(a):
    return (fp2_mul_xi(a[2]), a[0], a[1])


def fp6_inv(a, inv=L.inv_mod):
    a0, a1, a2 = a
    t = fp2_mul_many([(a0, a0), (a1, a2), (a2, a2), (a0, a1), (a1, a1),
                      (a0, a2)])
    sq0, m12, sq2, m01, sq1, m02 = t
    c0 = fp2_sub(sq0, fp2_mul_xi(m12))
    c1 = fp2_sub(fp2_mul_xi(sq2), m01)
    c2 = fp2_sub(sq1, m02)
    u = fp2_mul_many([(a1, c2), (a2, c1), (a0, c0)])
    tt = fp2_add(fp2_mul_xi(fp2_add(u[0], u[1])), u[2])
    tinv = fp2_inv(tt, inv)
    r = fp2_mul_many([(c0, tinv), (c1, tinv), (c2, tinv)])
    return (r[0], r[1], r[2])


# ---------------------------------------------------------------------------
# Fp12 = Fp6[w]/(w^2 - v)
# ---------------------------------------------------------------------------


def fp12_ones_like(x):
    one = fp2_ones_like(x)
    z = fp2_zeros_like(x)
    return ((one, z, z), (z, z, z))


def fp12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0, t1, t2 = fp6_mul_many([(a0, b0), (a1, b1),
                               (fp6_add(a0, a1), fp6_add(b0, b1))])
    c0 = fp6_add(t0, fp6_mul_by_v(t1))
    c1 = fp6_sub(fp6_sub(t2, t0), t1)
    return (c0, c1)


def fp12_sqr(a):
    a0, a1 = a
    tt, c0 = fp6_mul_many([(a0, a1),
                           (fp6_add(a0, a1), fp6_add(a0, fp6_mul_by_v(a1)))])
    c0 = fp6_sub(fp6_sub(c0, tt), fp6_mul_by_v(tt))
    return (c0, fp6_add(tt, tt))


def fp12_conj(a):
    return (a[0], fp6_neg(a[1]))


def fp12_inv(a, inv=L.inv_mod):
    a0, a1 = a
    t = fp6_mul_many([(a0, a0), (a1, a1)])
    tinv = fp6_inv(fp6_sub(t[0], fp6_mul_by_v(t[1])), inv)
    r = fp6_mul_many([(a0, tinv), (a1, tinv)])
    return (r[0], fp6_neg(r[1]))


def fp12_leaves(a):
    """The 12 Fp leaves in (c6, c2, c) nesting order."""
    return [x for c6 in a for c2 in c6 for x in c2]


def fp12_pack(leaves):
    it = iter(leaves)
    fp2 = lambda: (next(it), next(it))
    fp6 = lambda: (fp2(), fp2(), fp2())
    return (fp6(), fp6())


def fp12_is_one(a):
    leaves = fp12_leaves(a)
    one = L.ones_like(leaves[0])
    ok = L.eq(leaves[0], one)
    for x in leaves[1:]:
        ok = ok & L.is_zero(x)
    return ok


# ---------------------------------------------------------------------------
# Frobenius (constants from the host field code, encoded per device)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def frob_consts(j: int, device: str):
    return [(L.mont_const(c[0], device), L.mont_const(c[1], device))
            for c in HF.FROB[j]]


def fp12_frobenius(a, j=1):
    """a^(p^j), j in {1, 2, 3}."""
    g = frob_consts(j, str(a[0][0][0].device))
    (c0, c2, c4), (c1, c3, c5) = a
    cs = [c0, c1, c2, c3, c4, c5]
    if j & 1:
        cs = [fp2_conj(c) for c in cs]
    out = fp2_mul_many([(c, g[i]) for i, c in enumerate(cs)])
    return ((out[0], out[2], out[4]), (out[1], out[3], out[5]))
