"""The port's Hopper kernels: build, binding, wrappers and plain versions.

Counterpart of drand_tpu/ops/pallas_field.py.  Every TPU kernel of the
repository (beacon verification, batched signing, partial verification and
recovery, both signature groups) has a hand-written CUDA C++ kernel
(sources in ``csrc/``, target ``sm_90a``):

  K1 pow_fixed         <- pallas_field._pow_call          (csrc/pow.cu)
  K2 scalar_mul_fixed  <- pallas_field._ladder_fixed_call (csrc/ladder.cu,
                                                           G1 and G2)
  K3 miller_loop       <- pallas_field._miller_call       (csrc/miller.cu)
  K4 final_exponentiation <- pallas_field._finalexp_call  (csrc/finalexp.cu)
  K5 pow_fixed_fp2     <- pallas_field._pow2_call         (csrc/pow2.cu)
  K6 scalar_mul_bits   <- pallas_field._ladder_var_call   (csrc/ladder_var.cu,
                                                           G1 and G2)
  K7 sum_tiles         <- pallas_field._sum_call          (csrc/sum.cu,
                                                           G1 and G2)
  K8 scalar_mul_glv_mixed <- pallas_field._ladder_glv_mixed_call
                                                   (csrc/glv.cu, G1 and G2)

Each wrapper takes the plain engine's ``(..., 24)`` int64 Montgomery limbs
(a G2 point: Fp2 pairs of them, and the wrapper dispatches on that arity).
On a CPU tensor it runs the plain PyTorch version beside it (the loops of
limbs.py, tower.py, curve.py and pairing.py); on a CUDA tensor it launches
the kernel and raises if the launch fails.  There is no fallback from one
to the other.  ``LAUNCHES`` counts kernel launches per wrapper and curve
(the G2 instances under their own ``_g2`` names), ``SHAPES`` the same
launches per (name, static exponent, scalar or ladder bit count, lanes);
plain runs count in neither.

Build: every ``csrc/*.cu`` compiles with its own ``nvcc -c`` (all started
together), then one ``nvcc -shared`` links a plain-C shared library, loaded
with ctypes.  It is built at first use into ``build/kernels/<hash>/`` at the
repository root (git-ignored), keyed on a hash of the sources and flags.
"""

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from . import limbs as L
from . import tower as T
from .curve import G1, G2, _leaf, _tmap
from ..crypto.host.params import P, B2, X as BLS_X

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

LAUNCHES = {"pow_fixed": 0, "scalar_mul_fixed": 0, "miller_loop": 0,
            "final_exponentiation": 0, "sum_tiles": 0,
            "scalar_mul_glv_mixed": 0, "pow_fixed_fp2": 0,
            "scalar_mul_fixed_g2": 0, "sum_tiles_g2": 0,
            "scalar_mul_glv_mixed_g2": 0, "scalar_mul_bits": 0,
            "scalar_mul_bits_g2": 0}
# (wrapper, exponent / scalar / ladder bits / None, lanes)
SHAPES = collections.Counter()

TILE = 256          # lanes one K7 block reduces (pallas_field.TILE)

XLOOP_BITS = [int(c) for c in bin(-BLS_X)[3:]]     # |x| after the leading 1
INV_EXP = P - 2

# The constant bundle the pairing kernels read, row order of the JAX
# package's pallas_field._const_entries (p raw, the rest Montgomery).
CONST_NAMES = (["p", "one", "half", "beta", "b2_0", "b2_1"]
               + [f"frob{j}_{i}_{c}" for j in (1, 2) for i in range(6)
                  for c in (0, 1)])


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    SHAPES.clear()


def _count(name: str, key, lanes: int):
    LAUNCHES[name] += 1
    SHAPES[(name, key, lanes)] += 1


# ---------------------------------------------------------------------------
# Build and binding
# ---------------------------------------------------------------------------

BUILD_INFO = {}          # seconds, directory, ptxas log of the loaded build
_LIB = None
_LIB_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def build_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    srcs, hdrs = _sources()
    for f in srcs + hdrs:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu into the shared library (cached by source hash).

    Each source compiles in its own nvcc process, all started together,
    with ptxas statistics (-Xptxas -v) kept in build.log beside the
    library."""
    out_dir = BUILD_ROOT / build_hash()
    lib = out_dir / "libdrand_kernels.so"
    if lib.exists():
        BUILD_INFO.update(seconds=0.0, directory=str(out_dir), cached=True,
                          log=(out_dir / "build.log").read_text()
                          if (out_dir / "build.log").exists() else "")
        return lib
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tmp = out_dir.with_name(out_dir.name + f".tmp{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    srcs, _ = _sources()
    procs = []
    for src in srcs:
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-c",
               str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, objs = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        objs.append(str(obj))
    link = subprocess.run(
        [nvcc, "-shared", *NVCC_FLAGS, *objs, "-o", str(tmp / lib.name)],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    (tmp / "build.log").write_text("\n".join(log))
    shutil.rmtree(out_dir, ignore_errors=True)
    os.replace(tmp, out_dir)
    BUILD_INFO.update(seconds=time.perf_counter() - t0,
                      directory=str(out_dir), cached=False,
                      log="\n".join(log))
    return lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' signatures (every pointer and the stream
    as c_void_p); each returns its cudaGetLastError()."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.drand_pow.argtypes = [vp, vp, vp, i32, i64, vp]
    lib.drand_ladder_g1.argtypes = [vp, vp, vp, i32, i64, vp]
    lib.drand_miller.argtypes = [vp, vp, vp, vp, i32, i64, vp]
    lib.drand_finalexp.argtypes = [vp, vp, vp, vp, i32, vp, i32, i64, vp]
    lib.drand_sum_g1.argtypes = [vp, vp, i64, vp]
    lib.drand_glv_g1.argtypes = [vp, vp, vp, i32, i64, vp]
    lib.drand_pow2.argtypes = [vp, vp, vp, i32, i64, vp]
    lib.drand_ladder_g2.argtypes = [vp, vp, vp, i32, i64, vp]
    lib.drand_sum_g2.argtypes = [vp, vp, i64, vp]
    lib.drand_glv_g2.argtypes = [vp, vp, vp, i32, i64, vp]
    lib.drand_ladder_var_g1.argtypes = [vp, vp, vp, i32, i64, vp]
    lib.drand_ladder_var_g2.argtypes = [vp, vp, vp, i32, i64, vp]
    for fn in (lib.drand_pow, lib.drand_ladder_g1, lib.drand_miller,
               lib.drand_finalexp, lib.drand_sum_g1, lib.drand_glv_g1,
               lib.drand_pow2, lib.drand_ladder_g2, lib.drand_sum_g2,
               lib.drand_glv_g2, lib.drand_ladder_var_g1,
               lib.drand_ladder_var_g2):
        fn.restype = ctypes.c_int
    return lib


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = bind(ctypes.CDLL(str(build())))
        return _LIB


def _check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


def _on_card(t) -> bool:
    """True for a CUDA tensor, False for a CPU tensor, raise otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# ---------------------------------------------------------------------------
# Layout: (..., 24) int64 16-bit limbs <-> (coords, 12, B) int32 words
# ---------------------------------------------------------------------------

def to_words(xs):
    """Same-shape limb tensors -> one contiguous (len(xs), 12, B) int32
    tensor of 32-bit words (bit patterns), lane-minor."""
    x = torch.stack([t.reshape(-1, L.NLIMB) for t in xs])    # (nc, B, 24)
    w = x[..., 0::2] | (x[..., 1::2] << 16)                   # < 2^32
    w = torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)
    return w.transpose(1, 2).contiguous()


def from_words(w, shape):
    """(nc, 12, B) int32 words -> list of nc limb tensors of `shape`+(24,)."""
    v = (w.to(torch.int64) & 0xFFFFFFFF).transpose(1, 2)       # (nc, B, 12)
    limbs = torch.stack([v & L.MASK, v >> 16], dim=-1)
    limbs = limbs.reshape(v.shape[0], v.shape[1], L.NLIMB)
    return [limbs[i].reshape(tuple(shape) + (L.NLIMB,))
            for i in range(v.shape[0])]


@lru_cache(maxsize=None)
def bits_tensor(bits: tuple, device: str) -> torch.Tensor:
    return torch.tensor(list(bits), dtype=torch.int32, device=device)


def const_rows():
    """(30, 24) int64 limbs of the constant bundle, CONST_NAMES order."""
    from ..crypto.host import field as HF
    mont = lambda x: L.int_to_limbs(x * L.R_MONT % P)
    rows = [L.int_to_limbs(P), mont(1), mont((P + 1) // 2),
            mont(pow(2, (P - 1) // 3, P)), mont(B2[0]), mont(B2[1])]
    for j in (1, 2):
        for c in HF.FROB[j]:
            rows += [mont(c[0]), mont(c[1])]
    return torch.from_numpy(np.stack(rows))


@lru_cache(maxsize=None)
def const_bundle(device: str) -> torch.Tensor:
    return to_words([const_rows().to(device)])[0].T.contiguous()  # (30, 12)


# ---------------------------------------------------------------------------
# K1: Fp pow by a fixed exponent
# ---------------------------------------------------------------------------

def pow_fixed_plain(a, e: int):
    """Square-and-multiply MSB-first from 1; zero bits skip the multiply
    (limbs.pow_fixed's loop, pallas_field._pow_math)."""
    acc = L.ones_like(a)
    for bit in L.exp_bits(e):
        acc = L.mont_sqr(acc)
        if bit:
            acc = L.mont_mul(acc, a)
    return acc


def pow_fixed(a, e: int):
    """a^e for a static exponent e >= 1 (Montgomery limbs in and out)."""
    if not _on_card(a):
        return pow_fixed_plain(a, e)
    shape = a.shape[:-1]
    x = to_words([a])
    out = torch.empty_like(x)
    bits = bits_tensor(tuple(L.exp_bits(e)), str(a.device))
    _check(_lib().drand_pow(x.data_ptr(), out.data_ptr(), bits.data_ptr(),
                            bits.numel(), x.shape[-1], _stream(a.device)),
           "pow_fixed")
    _count("pow_fixed", e, x.shape[-1])
    return from_words(out, shape)[0]


# ---------------------------------------------------------------------------
# Points of either curve: G1 has 3 Fp coordinates, G2 3 Fp2 coordinates
# ---------------------------------------------------------------------------

def _is_g2(p) -> bool:
    return isinstance(p[0], tuple)


def _curve(p):
    return G2 if _is_g2(p) else G1


def _flat(p):
    """A point (or affine table) -> its list of Fp leaf tensors."""
    return [x for c in p for x in (c if isinstance(c, tuple) else (c,))]


def _unflat(leaves, g2: bool):
    if not g2:
        return tuple(leaves)
    return tuple((leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2))


# ---------------------------------------------------------------------------
# K2: scalar multiplication by a fixed scalar, G1 and G2
# ---------------------------------------------------------------------------

def scalar_mul_fixed_plain(p, k: int):
    """Double-and-add MSB-first from infinity; zero bits skip the add
    (pallas_field._ladder_fixed_math over curve.DevCurve, either curve)."""
    curve = _curve(p)
    acc = curve.infinity_like(_leaf(p[0]))
    for bit in L.exp_bits(k):
        acc = curve.double(acc)
        if bit:
            acc = curve.add(acc, p)
    return acc


def scalar_mul_fixed(p, k: int):
    """k*P for a static k >= 1 (Jacobian Montgomery limbs; a G1 or a G2
    point, told apart by the arity of its coordinates)."""
    assert k >= 1
    leaves = _flat(p)
    if not _on_card(leaves[0]):
        return scalar_mul_fixed_plain(p, k)
    g2 = _is_g2(p)
    shape = torch.broadcast_shapes(*(c.shape for c in leaves))[:-1]
    x = to_words([c.expand(shape + (L.NLIMB,)) for c in leaves])
    out = torch.empty_like(x)
    bits = bits_tensor(tuple(L.exp_bits(k)), str(x.device))
    fn = _lib().drand_ladder_g2 if g2 else _lib().drand_ladder_g1
    name = "scalar_mul_fixed_g2" if g2 else "scalar_mul_fixed"
    _check(fn(x.data_ptr(), out.data_ptr(), bits.data_ptr(), bits.numel(),
              x.shape[-1], _stream(x.device)), name)
    _count(name, k, x.shape[-1])
    return _unflat(from_words(out, shape), g2)


# ---------------------------------------------------------------------------
# K6: scalar multiplication by one scalar per lane, G1 and G2
# ---------------------------------------------------------------------------

def scalar_mul_bits_plain(p, bits):
    """Double-and-add MSB-first from infinity; every step computes the
    complete add and selects it where the lane's bit is 1
    (pallas_field._ladder_var_math over curve.DevCurve, either curve)."""
    curve = _curve(p)
    acc = curve.infinity_like(_leaf(p[0]))
    for i in range(bits.shape[0]):
        acc = curve.double(acc)
        acc = curve.select(bits[i] == 1, curve.add(acc, p), acc)
    return acc


def scalar_mul_bits(p, bits):
    """k_i * P_i for per-lane scalars: a Jacobian point of either curve
    with batch shape S and MSB-first bits of shape (nbits,) + S.  Any batch
    shape is flattened to lanes (pallas_field.scalar_mul_bits)."""
    leaves = _flat(p)
    if not _on_card(leaves[0]):
        return scalar_mul_bits_plain(p, bits)
    g2 = _is_g2(p)
    shape = torch.broadcast_shapes(*(c.shape for c in leaves))[:-1]
    x = to_words([c.expand(shape + (L.NLIMB,)) for c in leaves])
    n = x.shape[-1]
    nbits = bits.shape[0]
    bt = bits.reshape(nbits, n).to(device=x.device,
                                   dtype=torch.int32).contiguous()
    out = torch.empty_like(x)
    fn = _lib().drand_ladder_var_g2 if g2 else _lib().drand_ladder_var_g1
    name = "scalar_mul_bits_g2" if g2 else "scalar_mul_bits"
    _check(fn(x.data_ptr(), out.data_ptr(), bt.data_ptr(), nbits, n,
              _stream(x.device)), name)
    _count(name, nbits, n)
    return _unflat(from_words(out, shape), g2)


# ---------------------------------------------------------------------------
# K3: Miller loop
# ---------------------------------------------------------------------------

def _fp2_triple(a):
    return T.fp2_add(T.fp2_add(a, a), a)


def dbl_step(Rp):
    """Doubling step: new R and line coefficients (ell0, ell_px, ell_py)."""
    Rx, Ry, Rz = Rp
    dev = Rx[0].device
    b2 = (L.mont_const(B2[0], dev), L.mont_const(B2[1], dev))
    s1 = T.fp2_mul_many([(Ry, Ry), (Rz, Rz), (T.fp2_add(Ry, Rz),
                                              T.fp2_add(Ry, Rz)),
                         (Rx, Rx), (Rx, Ry)])
    t0, t1, u, v, m = s1
    t2 = _fp2_triple(T.fp2_mul(t1, b2))
    t3 = _fp2_triple(t2)
    t4 = T.fp2_sub(T.fp2_sub(u, t1), t0)            # 2 Ry Rz
    ell = (T.fp2_sub(t2, t0), _fp2_triple(v), T.fp2_neg(t4))
    half = L.mont_const((P + 1) // 2, dev)
    s, d = T.fp2_add(t0, t3), T.fp2_sub(t0, t3)
    hs = L.mul_many([(s[0], half), (s[1], half), (d[0], half), (d[1], half)])
    hh, g = (hs[0], hs[1]), (hs[2], hs[3])
    s3 = T.fp2_mul_many([(hh, hh), (t2, t2), (g, m), (t0, t4)])
    return (s3[2], T.fp2_sub(s3[0], _fp2_triple(s3[1])), s3[3]), ell


def add_step(Rp, Q):
    """Mixed addition step with affine Q; returns new R and line coeffs."""
    Rx, Ry, Rz = Rp
    Qx, Qy = Q
    s1 = T.fp2_mul_many([(Qy, Rz), (Qx, Rz)])
    t0 = T.fp2_sub(Ry, s1[0])
    t1 = T.fp2_sub(Rx, s1[1])
    s2 = T.fp2_mul_many([(t0, Qx), (t1, Qy), (t1, t1), (t0, t0)])
    ell = (T.fp2_sub(s2[0], s2[1]), T.fp2_neg(t0), t1)
    t2 = s2[2]
    t3, t4, t0sqRz = T.fp2_mul_many([(t2, t1), (t2, Rx), (s2[3], Rz)])
    t5 = T.fp2_add(T.fp2_sub(t3, T.fp2_add(t4, t4)), t0sqRz)
    s4 = T.fp2_mul_many([(t1, t5), (T.fp2_sub(t4, t5), t0), (t3, Ry),
                         (Rz, t3)])
    return (s4[0], T.fp2_sub(s4[1], s4[2]), s4[3]), ell


def apply_line(f, ell, px, py):
    """f *= line, the line's x/y coefficients scaled by P's affine coords."""
    o1 = T.fp2_mul_fp(ell[1], px)
    o4 = T.fp2_mul_fp(ell[2], py)
    z = T.fp2_zeros_like(px)
    return T.fp12_mul(f, ((ell[0], o1, z), (z, o4, z)))


def miller_loop_plain(px, py, q2):
    """f_{|x|,Q}(P), conjugated (pairing._miller_math's loop)."""
    f = T.fp12_ones_like(px)
    Rp = (q2[0], q2[1], T.fp2_ones_like(px))
    for bit in XLOOP_BITS:
        f = T.fp12_sqr(f)
        Rp, ell = dbl_step(Rp)
        f = apply_line(f, ell, px, py)
        if bit:
            Rp, ell = add_step(Rp, q2)
            f = apply_line(f, ell, px, py)
    return T.fp12_conj(f)


def miller_loop(px, py, q2):
    """Optimal-ate Miller loop on affine P (Fp) and Q (Fp2), batched."""
    if not _on_card(px):
        return miller_loop_plain(px, py, q2)
    ins = [px, py, q2[0][0], q2[0][1], q2[1][0], q2[1][1]]
    shape = torch.broadcast_shapes(*(c.shape for c in ins))[:-1]
    x = to_words([c.expand(shape + (L.NLIMB,)) for c in ins])
    n = x.shape[-1]
    out = torch.empty((12, 12, n), dtype=torch.int32, device=px.device)
    dev = str(px.device)
    xbits = bits_tensor(tuple(XLOOP_BITS), dev)
    _check(_lib().drand_miller(x.data_ptr(), out.data_ptr(),
                               const_bundle(dev).data_ptr(), xbits.data_ptr(),
                               xbits.numel(), n, _stream(px.device)),
           "miller_loop")
    _count("miller_loop", None, n)
    return T.fp12_pack(from_words(out, shape))


# ---------------------------------------------------------------------------
# K4: final exponentiation
# ---------------------------------------------------------------------------

def _pow_x_plain(g):
    acc = g
    for bit in XLOOP_BITS:
        acc = T.fp12_sqr(acc)
        if bit:
            acc = T.fp12_mul(acc, g)
    return T.fp12_conj(acc)


def final_exponentiation_plain(f):
    """pallas_field._finalexp_math, step for step; its Fp inverse is the
    plain p-2 chain."""
    inv = lambda x: pow_fixed_plain(x, INV_EXP)
    f = T.fp12_mul(T.fp12_conj(f), T.fp12_inv(f, inv=inv))
    f = T.fp12_mul(T.fp12_frobenius(f, 2), f)
    e1 = T.fp12_mul(_pow_x_plain(f), T.fp12_conj(f))
    e1 = T.fp12_mul(_pow_x_plain(e1), T.fp12_conj(e1))
    e2 = T.fp12_mul(_pow_x_plain(e1), T.fp12_frobenius(e1, 1))
    e3 = T.fp12_mul(T.fp12_mul(_pow_x_plain(_pow_x_plain(e2)),
                               T.fp12_frobenius(e2, 2)), T.fp12_conj(e2))
    f3 = T.fp12_mul(T.fp12_sqr(f), f)
    return T.fp12_mul(e3, f3)


def final_exponentiation(f):
    """f^((p^12-1)/r) (times 3 in the hard part), batched."""
    leaves = T.fp12_leaves(f)
    if not _on_card(leaves[0]):
        return final_exponentiation_plain(f)
    shape = torch.broadcast_shapes(*(c.shape for c in leaves))[:-1]
    x = to_words([c.expand(shape + (L.NLIMB,)) for c in leaves])
    n = x.shape[-1]
    out = torch.empty_like(x)
    dev = str(leaves[0].device)
    xbits = bits_tensor(tuple(XLOOP_BITS), dev)
    invbits = bits_tensor(tuple(L.exp_bits(INV_EXP)), dev)
    _check(_lib().drand_finalexp(x.data_ptr(), out.data_ptr(),
                                 const_bundle(dev).data_ptr(),
                                 xbits.data_ptr(), xbits.numel(),
                                 invbits.data_ptr(), invbits.numel(), n,
                                 _stream(leaves[0].device)),
           "final_exponentiation")
    _count("final_exponentiation", None, n)
    return T.fp12_pack(from_words(out, shape))


# ---------------------------------------------------------------------------
# K5: Fp2 pow by a fixed exponent
# ---------------------------------------------------------------------------

def pow_fixed_fp2_plain(a, e: int):
    """Square-and-multiply MSB-first from 1 in Fp2; zero bits skip the
    multiply (pallas_field._pow2_math)."""
    acc = T.fp2_ones_like(a[0])
    for bit in L.exp_bits(e):
        acc = T.fp2_sqr(acc)
        if bit:
            acc = T.fp2_mul(acc, a)
    return acc


def pow_fixed_fp2(a, e: int):
    """a^e in Fp2 for a static exponent e >= 1 (an Fp2 pair of Montgomery
    limb tensors in and out)."""
    if not _on_card(a[0]):
        return pow_fixed_fp2_plain(a, e)
    shape = torch.broadcast_shapes(a[0].shape, a[1].shape)[:-1]
    x = to_words([c.expand(shape + (L.NLIMB,)) for c in a])
    out = torch.empty_like(x)
    bits = bits_tensor(tuple(L.exp_bits(e)), str(x.device))
    _check(_lib().drand_pow2(x.data_ptr(), out.data_ptr(), bits.data_ptr(),
                             bits.numel(), x.shape[-1], _stream(x.device)),
           "pow_fixed_fp2")
    _count("pow_fixed_fp2", e, x.shape[-1])
    return tuple(from_words(out, shape))


# ---------------------------------------------------------------------------
# K7: per-tile point sum
# ---------------------------------------------------------------------------

def sum_tiles_plain(p):
    """Each TILE-lane tile reduced to one point by halving levels
    sh = TILE/2, ..., 1 (lane i of the tile += lane i + sh).  Lane 0 of
    pallas_field._sum_tile_math's rotate-and-add reads only lanes i + sh
    < 2 sh, so it is this same association of complete adds."""
    curve = _curve(p)
    pts = _tmap(lambda c: c.reshape(-1, TILE, L.NLIMB), p)
    sh = TILE // 2
    while sh >= 1:
        pts = curve.add(_tmap(lambda c: c[:, :sh], pts),
                        _tmap(lambda c: c[:, sh:2 * sh], pts))
        sh //= 2
    return _tmap(lambda c: c[:, 0], pts)


def sum_tiles(p):
    """Jacobian points of either curve, (B, 24) limbs per Fp coordinate, B
    a multiple of TILE -> the sum of each tile, (B / TILE, 24) each."""
    leaves = _flat(p)
    if leaves[0].shape[0] % TILE:
        raise ValueError(f"sum_tiles needs a multiple of {TILE} lanes, "
                         f"got {leaves[0].shape[0]}")
    if not _on_card(leaves[0]):
        return sum_tiles_plain(p)
    g2 = _is_g2(p)
    x = to_words(leaves)
    n = x.shape[-1]
    out = torch.empty((len(leaves), 12, n // TILE), dtype=torch.int32,
                      device=x.device)
    fn = _lib().drand_sum_g2 if g2 else _lib().drand_sum_g1
    name = "sum_tiles_g2" if g2 else "sum_tiles"
    _check(fn(x.data_ptr(), out.data_ptr(), n, _stream(x.device)), name)
    _count(name, None, n)
    return _unflat(from_words(out, (n // TILE,)), g2)


def _pad_lanes(p, lanes: int):
    """Zero-pad a point batch to `lanes` lanes; an all-zero lane has Z = 0
    and reads as infinity."""
    n = _leaf(p[0]).shape[0]
    if n == lanes:
        return p
    return _tmap(lambda c: torch.cat([c, c.new_zeros((lanes - n, L.NLIMB))],
                                     0), p)


def sum_points(p):
    """Sum a G1 or G2 point batch over its leading axis
    (pallas_field.sum_points).

    Each K7 launch reduces every TILE-lane tile to one point; the per-tile
    partials, zero-padded, are the lanes of the next launch until one tile
    remains.  Two to four partials are folded in order with complete adds,
    as the JAX package folds them in XLA.  8192 lanes: two launches."""
    curve = _curve(p)
    n = _leaf(p[0]).shape[0]
    pts = _pad_lanes(p, max(TILE, -(-n // TILE) * TILE))
    while True:
        part = sum_tiles(pts)
        ntiles = _leaf(part[0]).shape[0]
        if ntiles == 1:
            return _tmap(lambda c: c[0], part)
        if ntiles <= 4:
            acc = _tmap(lambda c: c[0], part)
            for i in range(1, ntiles):
                acc = curve.add(acc, _tmap(lambda c: c[i], part))
            return acc
        pts = _pad_lanes(part, -(-ntiles // TILE) * TILE)


# ---------------------------------------------------------------------------
# K8: GLV joint ladder over affine tables
# ---------------------------------------------------------------------------

def scalar_mul_glv_mixed_plain(pt, phi, p3, bits0, bits1):
    """[k0]P + [k1]endo(P) from the affine tables {P, endo(P), P + endo(P)}
    (endo = phi on G1, psi^2 on G2): from infinity, double every step, then
    mixed-add the entry the bit pair selects where b0 | b1
    (pallas_field._ladder_glv_mixed_math)."""
    curve = _curve(pt)
    acc = curve.infinity_like(_leaf(pt[0]))
    for i in range(bits0.shape[0]):
        acc = curve.double(acc)
        b0, b1 = bits0[i] == 1, bits1[i] == 1
        t = curve.select(b0, curve.select(b1, p3, pt),
                         curve.select(b1, phi, pt))
        acc = curve.select(b0 | b1, curve.add_mixed(acc, t), acc)
    return acc


def scalar_mul_glv_mixed(pt, phi, p3, bits0, bits1):
    """Joint GLV ladder: affine tables (x, y) of (B, 24) limbs per Fp
    coordinate (Fp2 pairs on G2) and MSB-first bit planes (nbits, B) -> a
    Jacobian point per lane."""
    leaves = _flat(pt) + _flat(phi) + _flat(p3)
    if not _on_card(leaves[0]):
        return scalar_mul_glv_mixed_plain(pt, phi, p3, bits0, bits1)
    g2 = _is_g2(pt)
    shape = leaves[0].shape[:-1]
    x = to_words(leaves)
    n = x.shape[-1]
    nbits = bits0.shape[0]
    bits = torch.stack([bits0.reshape(nbits, n), bits1.reshape(nbits, n)]
                       ).to(device=x.device, dtype=torch.int32).contiguous()
    out = torch.empty((6 if g2 else 3, 12, n), dtype=torch.int32,
                      device=x.device)
    fn = _lib().drand_glv_g2 if g2 else _lib().drand_glv_g1
    name = "scalar_mul_glv_mixed_g2" if g2 else "scalar_mul_glv_mixed"
    _check(fn(x.data_ptr(), bits.data_ptr(), out.data_ptr(), nbits, n,
              _stream(x.device)), name)
    _count(name, nbits, n)
    return _unflat(from_words(out, shape), g2)
