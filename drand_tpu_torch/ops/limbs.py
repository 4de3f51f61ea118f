"""384-bit modular arithmetic on tensors: the port's Fp engine.

Counterpart of drand_tpu/ops/limbs.py.  An Fp element is a ``(..., 24)``
int64 tensor of base-2^16 limbs, little-endian, in Montgomery form with
R = 2^384 — so every Montgomery value equals the JAX engine's limb for limb.

int64, not uint32: PyTorch on the CPU has no add, shift or compare on
uint32.  A 16x16-bit limb product is < 2^32 and a CIOS column collects at
most 48 of them plus carries, so every column stays below 2^38; the
arithmetic right shift and ``&`` act as floor division and mod on int64.

Every function maps over arbitrary leading dims; values are canonical
(< p, limbs < 2^16) at every function boundary.  ``mul_many`` stacks k
independent products into ONE ``mont_mul`` (vertical batching, as in the
JAX engine): the tower and curve formulas are written as stages of
independent products so the plain engine issues few, wide tensor ops.

The long fixed-exponent chains (``pow_fixed``, ``inv_mod``) dispatch to the
K1 kernel wrapper in ``kernels.py``: on a CUDA tensor it launches the
Hopper kernel, on a CPU tensor it runs the plain loop below.
"""

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..crypto.host.params import P

NLIMB = 24
LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1
DTYPE = torch.int64

R_MONT = (1 << (NLIMB * LIMB_BITS)) % P          # R = 2^384 mod p
R2_MONT = (R_MONT * R_MONT) % P                  # R^2 mod p (to-Mont factor)
R_INV = pow(R_MONT, -1, P)
N0 = (-pow(P, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)  # -p^-1 mod 2^16


def int_to_limbs(x: int, n: int = NLIMB) -> np.ndarray:
    """Host: python int -> (n,) int64 limb array (little-endian, base 2^16)."""
    assert 0 <= x < (1 << (n * LIMB_BITS))
    return np.array([(x >> (LIMB_BITS * i)) & MASK for i in range(n)],
                    dtype=np.int64)


def ints_to_limbs(xs) -> np.ndarray:
    """Host: list of ints < 2^384 -> (n, 24) int64 limbs (bulk, via bytes)."""
    buf = b"".join(int(x).to_bytes(2 * NLIMB, "little") for x in xs)
    return np.frombuffer(buf, dtype="<u2").reshape(len(xs), NLIMB) \
        .astype(np.int64)


def limbs_to_ints(a) -> list:
    """Host: (..., 24) limb array -> flat list of python ints (bulk)."""
    arr = np.ascontiguousarray(np.asarray(a).reshape(-1, NLIMB),
                               dtype="<u2")
    raw = arr.tobytes()
    w = 2 * NLIMB
    return [int.from_bytes(raw[i * w:(i + 1) * w], "little")
            for i in range(arr.shape[0])]


@lru_cache(maxsize=None)
def const(x: int, device: str, n: int = NLIMB) -> torch.Tensor:
    """A canonical limb constant (not Montgomery) on `device`, cached."""
    return torch.tensor(int_to_limbs(x, n), dtype=DTYPE, device=device)


def mont_const(x: int, device) -> torch.Tensor:
    """x in Montgomery form as a (24,) limb tensor on `device`."""
    return const(x * R_MONT % P, str(device))


def _dev(t) -> str:
    return str(t.device)


def _shift_up(x, k: int = 1):
    """Move limb i to limb i+k (multiply by 2^(16k)); zeros shift in."""
    return F.pad(x[..., :-k], (k, 0))


def normalize(cols, nout: int):
    """Exact base-2^16 limbs of sum(cols_i * 2^16i) mod 2^(16*nout).

    cols: (..., m) int64 columns, each in [0, 2^62).  Carry passes repeat
    until no column exceeds 16 bits: a pass cuts every column to at most
    2^16 plus the carry of its neighbour, so a few passes suffice except
    where a carry ripples through a run of 0xffff limbs, which is rare and
    still exact (the loop just runs longer)."""
    m = cols.shape[-1]
    c = F.pad(cols, (0, nout - m)) if m < nout else cols[..., :nout]
    while True:
        hi = c >> LIMB_BITS
        if not bool(hi.any()):
            return c
        c = (c & MASK) + _shift_up(hi)


def _p(device):
    return const(P, device)


def add_mod(a, b):
    """(a + b) mod p: one normalize over [a+b, a+b+2^384-p] stacked."""
    s = a + b
    both = normalize(torch.stack([s, s + const((1 << 384) - P, _dev(s))]),
                     NLIMB + 1)
    ge = both[1][..., NLIMB] == 1            # a + b >= p
    return torch.where(ge[..., None], both[1][..., :NLIMB],
                       both[0][..., :NLIMB])


def sub_mod(a, b):
    """(a - b) mod p: v = a - b + 2^384, w = v + p, both as columns."""
    v = a + (MASK - b)
    one = const(1, _dev(v))
    v = v + one
    w = v + _p(_dev(v))
    both = normalize(torch.stack(torch.broadcast_tensors(v, w)), NLIMB + 1)
    nonneg = both[0][..., NLIMB] == 1        # a >= b
    return torch.where(nonneg[..., None], both[0][..., :NLIMB],
                       both[1][..., :NLIMB])


def neg_mod(a):
    """p - a, with 0 -> 0."""
    w = _p(_dev(a)) + (MASK - a) + const(1, _dev(a))
    d = normalize(w, NLIMB + 1)[..., :NLIMB]
    return torch.where(is_zero(a)[..., None], a, d)


def ge(a, b):
    """a >= b over canonical limbs (...,) bool."""
    v = a + (MASK - b) + const(1, _dev(a))
    return normalize(v, NLIMB + 1)[..., NLIMB] == 1


def eq(a, b):
    return torch.all(a == b, dim=-1)


def is_zero(a):
    return torch.all(a == 0, dim=-1)


def select(cond, a, b):
    """cond (...,) bool -> a else b, limb-wise."""
    return torch.where(cond[..., None], a, b)


def _cond_sub_p(x):
    """x: (..., 25) canonical limbs of a value < 2p -> x mod p (24 limbs)."""
    c = const((1 << 400) - P, _dev(x), NLIMB + 1)
    d = normalize(x + c, NLIMB + 2)
    take = d[..., NLIMB + 1] == 1            # x >= p
    return torch.where(take[..., None], d[..., :NLIMB], x[..., :NLIMB])


def mont_mul(a, b):
    """Montgomery product a*b*R^-1 mod p (CIOS over 16-bit limbs).

    Each of the 24 rounds adds a_i*b and m_i*p into the column array as
    whole products (no lo/hi split) and pushes column i's high part into
    column i+1; columns stay below 2^38, exact in int64."""
    a, b = torch.broadcast_tensors(a, b)
    t = a.new_zeros(a.shape[:-1] + (2 * NLIMB,))
    p = _p(_dev(a))
    for i in range(NLIMB):
        t[..., i:i + NLIMB] += a[..., i:i + 1] * b
        m = (t[..., i] * N0) & MASK
        t[..., i:i + NLIMB] += m[..., None] * p
        t[..., i + 1] += t[..., i] >> LIMB_BITS
    return _cond_sub_p(normalize(t[..., NLIMB:], NLIMB + 1))


def mont_sqr(a):
    return mont_mul(a, a)


def to_mont(a):
    """Canonical residue limbs -> Montgomery form."""
    return mont_mul(a, const(R2_MONT, _dev(a)))


def from_mont(a):
    """Montgomery form -> canonical residue limbs (mont-mul by 1)."""
    return mont_mul(a, const(1, _dev(a)))


def exp_bits(e: int) -> list:
    """Fixed exponent -> MSB-first bit list."""
    return [int(c) for c in bin(e)[2:]]


def pow_fixed(a, e: int):
    """a^e (Montgomery domain) for a static exponent: kernel K1 on a CUDA
    tensor, the plain square-and-multiply loop on a CPU tensor."""
    from . import kernels
    return kernels.pow_fixed(a, e)


def inv_mod(a):
    """a^-1 in Montgomery domain (Fermat); 0 -> 0."""
    return pow_fixed(a, P - 2)


# R^3 mod p: the to-Montgomery factor for the HIGH 2^384-scaled half of a
# 512-bit OS2IP chunk (mont_mul(hi, R^3) = hi R^2 = mont(hi 2^384)).
R3_MONT = R2_MONT * R_MONT % P
R3_LIMBS = int_to_limbs(R3_MONT)


def be_words_to_mont(w):
    """(..., 16) int64 BIG-ENDIAN 32-bit words -- one 64-byte RFC 9380
    OS2IP chunk per lane -> Montgomery limbs of the value mod p.

    v = hi 2^384 + lo with hi < 2^128, lo < 2^384; both halves stay raw
    (lo possibly >= p) and one stacked mont_mul against R^2 / R^3 lands
    each in canonical Montgomery form: a b < R p keeps REDC's result below
    2p, so its single conditional subtract still canonicalizes."""
    rev = w.flip(-1)                              # LE word order
    limbs32 = torch.stack([rev & MASK, rev >> LIMB_BITS], -1) \
        .reshape(w.shape[:-1] + (NLIMB + 8,))
    lo = limbs32[..., :NLIMB]
    hi = F.pad(limbs32[..., NLIMB:], (0, NLIMB - 8))
    mlo, mhi = mul_many([(lo, const(R2_MONT, _dev(w)).expand(lo.shape)),
                         (hi, const(R3_MONT, _dev(w)).expand(hi.shape))])
    return add_mod(mlo, mhi)


def ones_like(a):
    """1 (Montgomery) with a's shape."""
    return mont_const(1, a.device).expand(a.shape)


def encode_mont(xs, device="cpu") -> torch.Tensor:
    """Host: int or list of ints -> Montgomery limb tensor on `device`."""
    if isinstance(xs, int):
        return torch.tensor(int_to_limbs(xs * R_MONT % P), dtype=DTYPE,
                            device=device)
    arr = ints_to_limbs([x * R_MONT % P for x in xs])
    return torch.from_numpy(arr).to(device)


def decode_mont(a) -> list:
    """Montgomery limb tensor -> canonical python ints (host math)."""
    t = a.detach().cpu().numpy()
    out = [x * R_INV % P for x in limbs_to_ints(t)]
    return out[0] if t.ndim == 1 else out


# ---------------------------------------------------------------------------
# Vertical batching: k independent ops as ONE wide op (stacked on a new
# leading axis).
# ---------------------------------------------------------------------------

def _many(fn, pairs):
    if len(pairs) == 1:
        return (fn(pairs[0][0], pairs[0][1]),)
    shape = torch.broadcast_shapes(*(x.shape for p in pairs for x in p))
    stack = lambda xs: torch.stack([x.expand(shape) for x in xs])
    out = fn(stack([p[0] for p in pairs]), stack([p[1] for p in pairs]))
    return tuple(out.unbind(0))


def mul_many(pairs):
    """[(a, b), ...] -> tuple of a_i*b_i*R^-1, via one stacked mont_mul."""
    return _many(mont_mul, pairs)


def add_many(pairs):
    return _many(add_mod, pairs)


def sub_many(pairs):
    return _many(sub_mod, pairs)
