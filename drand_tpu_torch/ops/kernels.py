"""The port's Hopper kernels: build, binding, wrappers and plain versions.

Counterpart of drand_tpu/ops/pallas_field.py.  Every TPU kernel of the
repository (beacon verification, batched signing, partial verification and
recovery, both signature groups) has a hand-written CUDA C++ kernel
(sources in ``csrc/``, target ``sm_90a``):

  K1 pow_fixed         <- pallas_field._pow_call          (csrc/pow.cu)
     (a windowed chain from e's digits, one thread a lane; e = p - 2 runs
      a constant-time safegcd inversion, csrc/field.cuh fp_inv)
  K2 scalar_mul_fixed  <- pallas_field._ladder_fixed_call (csrc/ladder.cu,
                                                           G1 and G2)
     (K2 runs a thread group per lane over fp12prog.py's point programs,
      scheduled by the public scalar's bits; csrc/group.cuh)
  K3 miller_loop       <- pallas_field._miller_call       (csrc/miller.cu)
  K4 final_exponentiation <- pallas_field._finalexp_call  (csrc/finalexp.cu)
     (K3 and K4 run a warp per pairing lane over shared-memory Fp programs
      that fp12prog.py writes and passes with the launch; csrc/group.cuh)
  K5 pow_fixed_fp2     <- pallas_field._pow2_call         (csrc/pow2.cu)
     (a thread group per lane over fp12prog.py's "pow2" program: the
      Frobenius split e = a p + b, scheduled by the window digits of a, b)
  K6 scalar_mul_bits   <- pallas_field._ladder_var_call   (csrc/ladder_var.cu,
                                                           G1 and G2)
     (K6 runs a thread group per lane over fp12prog.py's point programs,
      one operation sequence for every scalar; csrc/group.cuh)
  K7 sum_rows          <- pallas_field._sum_call          (csrc/sum.cu,
                                                           G1 and G2)
     (a batch of whole sums in one launch, pallas_field.sum_points' tiles,
      padded partials and fold; a thread group per complete add)
  K8 scalar_mul_glv_mixed <- pallas_field._ladder_glv_mixed_call
                                                   (csrc/glv.cu, G1 and G2)
     (a thread group per lane over fp12prog.py's point programs)
  H1 hash_to_field     <- (no Pallas counterpart: XLA lax.scan,
                           drand_tpu/ops/sha256.py:109)    (csrc/h2f.cu)
     (the beacon digest, expand_message_xmd and hash_to_field, Fp or Fp2,
      one thread a lane; also SHA-256 of word rows (sha256_words) and the
      xmd bytes (expand_msg_xmd))

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
import contextlib
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

from . import fp12prog as FP
from . import limbs as L
from . import sha256 as SHA
from . import tower as T
from .curve import G1, G2, _leaf, _tmap
from ..crypto.host.params import P, B2

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

LAUNCHES = {"pow_fixed": 0, "scalar_mul_fixed": 0, "miller_loop": 0,
            "final_exponentiation": 0, "sum_rows": 0,
            "scalar_mul_glv_mixed": 0, "pow_fixed_fp2": 0,
            "scalar_mul_fixed_g2": 0, "sum_rows_g2": 0,
            "scalar_mul_glv_mixed_g2": 0, "scalar_mul_bits": 0,
            "scalar_mul_bits_g2": 0, "hash_to_field": 0,
            "hash_to_field_fp2": 0, "sha256_words": 0, "expand_msg_xmd": 0}
# (wrapper, exponent / scalar / ladder bits / rows / None, lanes)
SHAPES = collections.Counter()

TILE = 256          # lanes one K7 block reduces (pallas_field.TILE)

XLOOP_BITS = FP.XBITS                               # |x| after the leading 1
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
    lib.drand_pow.argtypes = [vp, vp, vp, i32, i32, i64, vp]
    lib.drand_inv.argtypes = [vp, vp, i64, vp]
    lib.drand_ladder_g1.argtypes = [vp, vp, vp, vp, i32, i32, vp, i32, i64,
                                    vp]
    lib.drand_miller.argtypes = [vp, vp, vp, vp, i32, vp, i32, i64, vp]
    lib.drand_finalexp.argtypes = [vp, vp, vp, vp, i32, vp, i32, i64, vp]
    lib.drand_sum_g1.argtypes = [vp, vp, vp, vp, i32, i32, vp, vp, vp, i32,
                                 i64, vp]
    lib.drand_glv_g1.argtypes = [vp, vp, vp, vp, i32, i32, vp, i32, i64, vp]
    lib.drand_pow2.argtypes = [vp, vp, vp, vp, i32, i32, vp, i32, i64, vp]
    lib.drand_ladder_g2.argtypes = [vp, vp, vp, vp, i32, i32, vp, i32, i64,
                                    vp]
    lib.drand_sum_g2.argtypes = lib.drand_sum_g1.argtypes
    lib.drand_glv_g2.argtypes = lib.drand_glv_g1.argtypes
    lib.drand_ladder_var_g1.argtypes = [vp, vp, vp, vp, i32, i32, vp, i32,
                                        i64, vp]
    lib.drand_ladder_var_g2.argtypes = [vp, vp, vp, vp, i32, i32, vp, i32,
                                        i64, vp]
    lib.drand_group_layout.argtypes = [i32, i32, vp]
    lib.drand_sum_layout.argtypes = [i32, i32, vp]
    lib.drand_sha256.argtypes = [vp, i32, vp, vp, i64, vp]
    lib.drand_xmd.argtypes = [vp, i32, vp, vp, i32, i64, vp]
    lib.drand_h2f.argtypes = [i32, vp, i32, vp, vp, vp, vp, i32, i64, vp]
    for fn in (lib.drand_pow, lib.drand_inv, lib.drand_ladder_g1,
               lib.drand_miller, lib.drand_finalexp, lib.drand_sum_g1,
               lib.drand_glv_g1, lib.drand_pow2, lib.drand_ladder_g2,
               lib.drand_sum_g2, lib.drand_glv_g2, lib.drand_ladder_var_g1,
               lib.drand_ladder_var_g2, lib.drand_group_layout,
               lib.drand_sum_layout, lib.drand_sha256, lib.drand_xmd,
               lib.drand_h2f):
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


def _launch(device, name: str, fn, *args):
    """Launch a kernel on `device`: a ctypes launch runs on the runtime's
    current device (device 0 in a fresh thread), so enter the tensors'
    device for the call, and pass its current stream last.  (A CPU device
    reaches here only through the host build of the sources, which tests
    load in place of the card's library.)"""
    device = torch.device(device)
    enter = torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()
    with enter:
        _check(fn(*args, _stream(device)), name)


def _ptrs(ts):
    """A host array of the tensors' data pointers (csrc/group.cuh Limbs):
    the kernels that read and write limb tensors themselves take one
    pointer a coordinate."""
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


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


@lru_cache(maxsize=None)
def program_tensor(kind: str, device: str) -> torch.Tensor:
    """fp12prog's int32 program table for K3 ("miller"), K4 ("finalexp"),
    K6 ("ladder_g1", "ladder_g2"), K2 ("fixed_g1", "fixed_g2"), K5
    ("pow2"), K7 ("sum_g1", "sum_g2") or K8 ("glv_g1", "glv_g2") on
    `device`."""
    return torch.from_numpy(FP.program(kind)).to(device)


@lru_cache(maxsize=None)
def schedule_tensor(kind: str, xbits, device: str) -> torch.Tensor:
    """The fragments a K3 / K4 lane runs for loop bits xbits (a tuple), a
    K2 lane for the bits of its scalar, a K5 lane for its exponent (an
    int)."""
    return torch.tensor(FP.schedule(kind, xbits), dtype=torch.int32,
                        device=device)


def _group_launch(fn, kind, x, out, dev, name):
    """Launch K3 or K4: words in and out, the constant bundle, the program
    and its slot count, the schedule for the loop bits of |x|."""
    sched = schedule_tensor(kind, tuple(XLOOP_BITS), dev)
    _launch(x.device, name, fn, x.data_ptr(), out.data_ptr(),
            const_bundle(dev).data_ptr(), program_tensor(kind, dev).data_ptr(),
            FP.compiled(kind)[1], sched.data_ptr(), sched.numel(), x.shape[-1])


def group_layout(kind, width=None):
    """(lanes a block, dynamic shared-memory bytes a block) of a K2, K3,
    K4, K5, K6 or K8 launch, as csrc/group.cuh computes them for the
    program's slots and a width (default fp12prog.WIDTH); for K7 ("sum_g1"
    / "sum_g2") adds a block, as csrc/sum.cu computes them."""
    out = (ctypes.c_int32 * 2)()
    fn = (_lib().drand_sum_layout if kind.startswith("sum")
          else _lib().drand_group_layout)
    fn(FP.compiled(kind)[1], width or FP.WIDTH[kind], out)
    return out[0], out[1]


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


# K1's window: odd powers x .. x^(2^w - 1) in a table of at most 2^(w-1)
# entries (csrc/pow.cu K1_TABLE); windows 4, 5 and 6 ran within 1-3 % of
# each other at every main-path width, 3 5-8 % slower (PERF.md)
K1_WINDOW = 5
K1_SQR = -1             # a squaring in the digit schedule


def pow_schedule(e: int, w: int = K1_WINDOW):
    """K1's chain for x^e, e >= 1, from e's sliding-window digits
    (fp12prog.window_digits): -> (schedule, table entries).  schedule[0]
    is the first digit's entry (acc = x^digit); then K1_SQR for a squaring
    and k >= 0 for a product by entry k (x^(2k+1)); the table holds the
    entries up to the largest digit."""
    digits = FP.window_digits(e, w)
    sched, at = [digits[0][1] >> 1], digits[0][0]
    for pos, d in digits[1:]:
        sched += [K1_SQR] * (at - pos) + [d >> 1]
        at = pos
    sched += [K1_SQR] * at
    return sched, max(d for _, d in digits) // 2 + 1


@lru_cache(maxsize=None)
def pow_schedule_tensor(e: int, device: str):
    sched, ntab = pow_schedule(e)
    return torch.tensor(sched, dtype=torch.int32, device=device), ntab


def pow_fixed(a, e: int):
    """a^e for a static exponent e >= 1 (Montgomery limbs in and out; the
    kernel reads and writes the limb tensor itself).  On the card e = p -
    2, the inverse (0 -> 0), runs the constant-time inversion; every other
    e the windowed chain.  Both count as pow_fixed."""
    assert e >= 1
    if not _on_card(a):
        return pow_fixed_plain(a, e)
    if a.dtype != L.DTYPE:
        raise TypeError(f"pow_fixed: limbs must be {L.DTYPE}, got {a.dtype}")
    x = a.reshape(-1, L.NLIMB).contiguous()   # the limbs, no word layout
    out = torch.empty_like(x)
    n = x.shape[0]
    if e == INV_EXP:
        _launch(a.device, "pow_fixed", _lib().drand_inv, x.data_ptr(),
                out.data_ptr(), n)
    else:
        sched, ntab = pow_schedule_tensor(e, str(a.device))
        _launch(a.device, "pow_fixed", _lib().drand_pow, x.data_ptr(),
                out.data_ptr(), sched.data_ptr(), sched.numel(), ntab, n)
    _count("pow_fixed", e, n)
    return out.reshape(a.shape)


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


# K2's width (threads a lane): fp12prog.WIDTH while a launch leaves the
# card idle and a lane's chain sets its time; on G1 fp12prog.FILL_WIDTH
# from this many lanes on, where the lanes fill the card and idle threads
# cost issue slots (the two cross between 2048 and 8192 lanes, PERF.md).
K2_FILL_LANES = 4096


def fixed_width(kind: str, lanes: int) -> int:
    """The width K2 ("fixed_g1" / "fixed_g2") runs `lanes` lanes at."""
    if lanes >= K2_FILL_LANES and kind in FP.FILL_WIDTH:
        return FP.FILL_WIDTH[kind]
    return FP.WIDTH[kind]


def scalar_mul_fixed(p, k: int):
    """k*P for a static public k >= 1 (Jacobian Montgomery limbs; a G1 or
    a G2 point, told apart by the arity of its coordinates).  The kernel's
    schedule follows k's bits: a secret scalar goes to scalar_mul_bits."""
    assert k >= 1
    leaves = _flat(p)
    if not _on_card(leaves[0]):
        return scalar_mul_fixed_plain(p, k)
    g2 = _is_g2(p)
    shape = torch.broadcast_shapes(*(c.shape for c in leaves))[:-1]
    x = to_words([c.expand(shape + (L.NLIMB,)) for c in leaves])
    n = x.shape[-1]
    out = torch.empty_like(x)
    kind = "fixed_g2" if g2 else "fixed_g1"
    dev = str(x.device)
    sched = schedule_tensor(kind, tuple(L.exp_bits(k)), dev)
    fn = _lib().drand_ladder_g2 if g2 else _lib().drand_ladder_g1
    name = "scalar_mul_fixed_g2" if g2 else "scalar_mul_fixed"
    _launch(x.device, name, fn, x.data_ptr(), out.data_ptr(),
            const_bundle(dev).data_ptr(), program_tensor(kind, dev).data_ptr(),
            FP.compiled(kind)[1], fixed_width(kind, n), sched.data_ptr(),
            sched.numel(), n)
    _count(name, k, n)
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
    with batch shape S and MSB-first bits of shape (nbits,) + S, nbits >=
    1.  Any batch shape is flattened to lanes
    (pallas_field.scalar_mul_bits).  The kernel runs the same operations
    whatever the bits."""
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
    kind = "ladder_g2" if g2 else "ladder_g1"
    fn = _lib().drand_ladder_var_g2 if g2 else _lib().drand_ladder_var_g1
    name = "scalar_mul_bits_g2" if g2 else "scalar_mul_bits"
    dev = str(x.device)
    _launch(x.device, name, fn, x.data_ptr(), out.data_ptr(),
            const_bundle(dev).data_ptr(), program_tensor(kind, dev).data_ptr(),
            FP.compiled(kind)[1], FP.WIDTH[kind], bt.data_ptr(), nbits, n)
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
    _group_launch(_lib().drand_miller, "miller", x, out, str(px.device),
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
    _group_launch(_lib().drand_finalexp, "finalexp", x, out,
                  str(leaves[0].device), "final_exponentiation")
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
    """a^e in Fp2 for a static public exponent e >= 1 (an Fp2 pair of
    Montgomery limb tensors in and out).  The kernel's schedule follows
    e's window digits (fp12prog.pow2_schedule)."""
    assert e >= 1
    if not _on_card(a[0]):
        return pow_fixed_fp2_plain(a, e)
    shape = torch.broadcast_shapes(a[0].shape, a[1].shape)[:-1]
    x = to_words([c.expand(shape + (L.NLIMB,)) for c in a])
    out = torch.empty_like(x)
    n = x.shape[-1]
    dev = str(x.device)
    sched = schedule_tensor("pow2", e, dev)
    _launch(x.device, "pow_fixed_fp2", _lib().drand_pow2, x.data_ptr(),
            out.data_ptr(), const_bundle(dev).data_ptr(),
            program_tensor("pow2", dev).data_ptr(), FP.compiled("pow2")[1],
            FP.WIDTH["pow2"], sched.data_ptr(), sched.numel(), n)
    _count("pow_fixed_fp2", e, n)
    return tuple(from_words(out, shape))


# ---------------------------------------------------------------------------
# K7: point sums, a batch of them in one launch
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
    a multiple of TILE -> the sum of each tile, (B / TILE, 24) each: on
    the card sum_rows over rows of one tile (one tile is one stage)."""
    leaves = _flat(p)
    n = leaves[0].shape[0]
    if n % TILE:
        raise ValueError(f"sum_tiles needs a multiple of {TILE} lanes, "
                         f"got {n}")
    if not _on_card(leaves[0]):
        return sum_tiles_plain(p)
    return sum_rows(_tmap(lambda c: c.reshape(n // TILE, TILE, L.NLIMB), p))


def _pad_lanes(p, lanes: int):
    """Zero-pad a point batch to `lanes` lanes on its lane axis (the one
    before the limbs); an all-zero lane has Z = 0 and reads as infinity."""
    n = _leaf(p[0]).shape[-2]
    if n == lanes:
        return p
    return _tmap(lambda c: torch.cat(
        [c, c.new_zeros(c.shape[:-2] + (lanes - n, L.NLIMB))], -2), p)


def sum_points_plain(p):
    """pallas_field.sum_points' association: every TILE-lane tile reduced
    to one point (sum_tiles_plain); the per-tile partials, zero-padded,
    reduced again until one tile remains; two to four partials folded in
    order with complete adds, as the JAX package folds them in XLA.  The
    one-row case of sum_rows_plain."""
    return _tmap(lambda c: c[0], sum_rows_plain(_tmap(lambda c: c[None], p)))


# K7's width (threads an add): fp12prog.WIDTH while a launch leaves the card
# idle and a sum's chain of adds sets its time; fp12prog.FILL_WIDTH from
# this many tiles (rows x tiles of the first stage, a block each) on, where
# idle threads cost issue slots (2 x 8192 lanes, 64 tiles, ran fastest at
# the first, 8 x 14,336, 448 tiles, at the second; PERF.md).
K7_FILL_TILES = 256


def sum_width(kind: str, tiles: int) -> int:
    """The width K7 ("sum_g1" / "sum_g2") runs a launch of `tiles` tiles
    at."""
    return FP.FILL_WIDTH[kind] if tiles >= K7_FILL_TILES else FP.WIDTH[kind]


def sum_rows_plain(p):
    """sum_points_plain of each row of (R, B, 24) limbs: every row has B
    lanes, so one batch of complete adds runs the same association on all
    rows at once."""
    curve = _curve(p)
    rows, n = _leaf(p[0]).shape[:2]
    pts = _pad_lanes(p, max(TILE, -(-n // TILE) * TILE))
    while True:
        part = _tmap(lambda c: c.reshape(rows, -1, L.NLIMB),
                     sum_tiles_plain(pts))
        ntiles = _leaf(part[0]).shape[1]
        if ntiles == 1:
            return _tmap(lambda c: c[:, 0], part)
        if ntiles <= 4:
            acc = _tmap(lambda c: c[:, 0], part)
            for i in range(1, ntiles):
                acc = curve.add(acc, _tmap(lambda c: c[:, i], part))
            return acc
        pts = _pad_lanes(part, -(-ntiles // TILE) * TILE)


def sum_rows(p):
    """R sums of B points each: Jacobian points of either curve, (R, B, 24)
    limbs per Fp coordinate -> (R, 24) each, every row in
    pallas_field.sum_points' association (sum_points_plain).  One launch
    runs every stage of every row and reads and writes the limb tensors
    itself; its scratch (the tiles' running lanes, the rows' partials and
    tickets) is allocated here."""
    leaves = _flat(p)
    if not _on_card(leaves[0]):
        return sum_rows_plain(p)
    if leaves[0].dtype != L.DTYPE:
        raise TypeError(f"sum_rows: limbs must be {L.DTYPE}, "
                        f"got {leaves[0].dtype}")
    g2 = _is_g2(p)
    shape = torch.broadcast_shapes(*(c.shape for c in leaves))
    rows, lanes = shape[0], shape[1]
    ins = [c.expand(shape).contiguous() for c in leaves]
    dev = ins[0].device
    alloc = torch.empty if lanes else torch.zeros   # no lanes: zero sums
    outs = [alloc((rows, L.NLIMB), dtype=L.DTYPE, device=dev) for _ in ins]
    kind = "sum_g2" if g2 else "sum_g1"
    name = "sum_rows_g2" if g2 else "sum_rows"
    tiles = -(-lanes // TILE)
    nw = len(ins) * 12                     # words a point
    work = torch.empty(rows * tiles * (TILE // 2) * nw, dtype=torch.int32,
                       device=dev)
    part = torch.empty(rows * tiles * nw, dtype=torch.int32, device=dev)
    tickets = torch.zeros(rows, dtype=torch.int32, device=dev)
    fn = _lib().drand_sum_g2 if g2 else _lib().drand_sum_g1
    sdev = str(dev)
    _launch(dev, name, fn, _ptrs(ins), _ptrs(outs),
            const_bundle(sdev).data_ptr(),
            program_tensor(kind, sdev).data_ptr(), FP.compiled(kind)[1],
            sum_width(kind, rows * tiles), work.data_ptr(), part.data_ptr(),
            tickets.data_ptr(), rows, lanes)
    _count(name, rows, lanes)
    return _unflat(outs, g2)


def sum_points(p):
    """Sum a G1 or G2 point batch over its leading axis
    (pallas_field.sum_points): sum_rows of one row."""
    return _tmap(lambda c: c[0], sum_rows(_tmap(lambda c: c[None], p)))


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
    Jacobian point per lane.  The kernel reads and writes the limb tensors
    itself and runs the same operations whatever the bits."""
    leaves = _flat(pt) + _flat(phi) + _flat(p3)
    if not _on_card(leaves[0]):
        return scalar_mul_glv_mixed_plain(pt, phi, p3, bits0, bits1)
    if leaves[0].dtype != L.DTYPE:
        raise TypeError(f"scalar_mul_glv_mixed: limbs must be {L.DTYPE}, "
                        f"got {leaves[0].dtype}")
    g2 = _is_g2(pt)
    shape = torch.broadcast_shapes(*(c.shape for c in leaves))
    tab = [c.expand(shape).reshape(-1, L.NLIMB).contiguous() for c in leaves]
    n = tab[0].shape[0]
    dev = tab[0].device
    nbits = bits0.shape[0]
    bits = torch.stack([bits0.reshape(nbits, n), bits1.reshape(nbits, n)]
                       ).to(device=dev, dtype=torch.int32).contiguous()
    outs = [torch.empty((n, L.NLIMB), dtype=L.DTYPE, device=dev)
            for _ in range(6 if g2 else 3)]
    kind = "glv_g2" if g2 else "glv_g1"
    fn = _lib().drand_glv_g2 if g2 else _lib().drand_glv_g1
    name = "scalar_mul_glv_mixed_g2" if g2 else "scalar_mul_glv_mixed"
    sdev = str(dev)
    _launch(dev, name, fn, _ptrs(tab), _ptrs(outs),
            const_bundle(sdev).data_ptr(),
            program_tensor(kind, sdev).data_ptr(), FP.compiled(kind)[1],
            FP.WIDTH[kind], bits.data_ptr(), nbits, n)
    _count(name, nbits, n)
    return _unflat([o.reshape(shape) for o in outs], g2)


# ---------------------------------------------------------------------------
# H1: SHA-256, expand_message_xmd and hash_to_field (no Pallas counterpart:
# the JAX package runs these stages as XLA code)
# ---------------------------------------------------------------------------

HTF_L = 64                  # bytes an RFC 9380 field element takes (L)
# the message a lane hands hash_to_field: "msg" a row of words of msg_len
# bytes is the xmd message itself; "raw_unchained" the 2 round words,
# digested as H(round8); "raw_chained" (prev words, round words, has_prev),
# digested as H(prev || round8), or H(round8) where has_prev is 0
H1_KINDS = {"msg": 0, "raw_unchained": 1, "raw_chained": 2}
# csrc/h2f.cu's frame header
_F_ELL, _F_NSWI, _F_B0, _F_BI, _F_D1, _F_D2, _F_HEADER = 0, 1, 2, 3, 4, 5, 8


def _sha_frame_words(fr):
    mid, fill, sw = fr
    return [*mid.tolist(), fill, len(sw), *sw.tolist()]


def _int32(words) -> tuple:
    """32-bit words -> their int32 bit patterns (the frame's dtype)."""
    return tuple(np.array(words, np.int64).astype(np.uint32).view(np.int32)
                 .tolist())


@lru_cache(maxsize=None)
def h1_frame(len_in_bytes: int, dst: bytes, msg_len: int = 32,
             digest_k: int = 0) -> tuple:
    """The static framing H1 reads, as int32 bit patterns:
    csrc/h2f.cu's header, then b_0's SHA frame (the Z_pad midstate,
    l_i_b || 0 || DST' and the padding after msg_len message bytes), the
    suffix rows of b_1 .. b_ell (i || DST' and the padding) and, for the
    raw kinds (digest_k, the words a digest hashes: 2 unchained, the prev
    words + 2 chained), the digests' SHA frames.  Every piece comes from
    ops/sha256.py frame."""
    ell = (len_in_bytes + 31) // 32
    assert 0 < ell <= 255 and len(dst) <= 255 and len_in_bytes % 4 == 0
    dst_prime = dst + bytes([len(dst)])
    words = [0] * _F_HEADER
    words[_F_ELL] = ell
    words[_F_B0] = len(words)
    words += _sha_frame_words(SHA.frame(
        (msg_len + 3) // 4, msg_len,
        len_in_bytes.to_bytes(2, "big") + b"\x00" + dst_prime, b"\x00" * 64))
    rows = [SHA.frame(8, 32, bytes([i]) + dst_prime)
            for i in range(1, ell + 1)]
    assert all(r[1] == 0 and (r[0] == SHA._H0).all() for r in rows)
    words[_F_NSWI] = len(rows[0][2])
    words[_F_BI] = len(words)
    for r in rows:
        words += r[2].tolist()
    if digest_k:
        words[_F_D1] = len(words)
        words += _sha_frame_words(SHA.frame(digest_k))
        words[_F_D2] = len(words)
        words += _sha_frame_words(SHA.frame(2))
    return _int32(words)


@lru_cache(maxsize=None)
def _frame_tensor(words: tuple, device: str) -> torch.Tensor:
    return torch.tensor(words, dtype=torch.int32, device=device)


def _word_rows(x, k: int):
    """(..., k) word tensor -> contiguous (lanes, k) int64 rows."""
    if x.dtype != torch.int64:
        raise TypeError(f"H1: words must be int64, got {x.dtype}")
    n = int(np.prod(x.shape[:-1], dtype=np.int64))
    return x.reshape(n, k).contiguous(), n


def sha256_words(words, dyn_len=None, tail: bytes = b"", prefix: bytes = b""):
    """SHA-256(prefix || dyn || tail) of each row of (..., k) BE words ->
    (..., 8) digest words (ops/sha256.py sha256_words' contract): H1's
    drand_sha256 on a CUDA tensor, the plain version on a CPU tensor."""
    if not _on_card(words):
        return SHA.sha256_words(words, dyn_len, tail, prefix)
    k = words.shape[-1]
    x, n = _word_rows(words, k)
    fr = _frame_tensor(_int32(_sha_frame_words(
        SHA.frame(k, dyn_len, tail, prefix))), str(words.device))
    out = torch.empty((n, 8), dtype=torch.int64, device=words.device)
    _launch(words.device, "sha256_words", _lib().drand_sha256, x.data_ptr(), k,
            fr.data_ptr(), out.data_ptr(), n)
    _count("sha256_words", 4 * k if dyn_len is None else dyn_len, n)
    return out.reshape(words.shape[:-1] + (8,))


def expand_msg_xmd_plain(msg_words, msg_len: int, dst: bytes,
                         len_in_bytes: int):
    """RFC 9380 expand_message_xmd over SHA-256 (plain): b_0 from the Z_pad
    midstate, then the chain b_i = H((b_0 ^ b_{i-1}) || i || DST')."""
    ell = (len_in_bytes + 31) // 32
    assert 0 < ell <= 255 and len(dst) <= 255 and len_in_bytes % 4 == 0
    dst_prime = dst + bytes([len(dst)])
    b0 = SHA.sha256_words(msg_words, msg_len,
                          tail=len_in_bytes.to_bytes(2, "big") + b"\x00"
                          + dst_prime, prefix=b"\x00" * 64)
    bi = SHA.sha256_words(b0, tail=b"\x01" + dst_prime)
    out = [bi]
    for i in range(2, ell + 1):
        bi = SHA.sha256_words(b0 ^ bi, tail=bytes([i]) + dst_prime)
        out.append(bi)
    return torch.cat(out, -1)[..., :len_in_bytes // 4]


def expand_msg_xmd(msg_words, msg_len: int, dst: bytes, len_in_bytes: int):
    """(..., k) BE message words of msg_len bytes a lane -> (...,
    len_in_bytes / 4) uniform words: H1's drand_xmd on a CUDA tensor, the
    plain version on a CPU tensor."""
    if not _on_card(msg_words):
        return expand_msg_xmd_plain(msg_words, msg_len, dst, len_in_bytes)
    k = msg_words.shape[-1]
    x, n = _word_rows(msg_words, k)
    fr = _frame_tensor(h1_frame(len_in_bytes, dst, msg_len),
                       str(msg_words.device))
    nw = len_in_bytes // 4
    out = torch.empty((n, nw), dtype=torch.int64, device=msg_words.device)
    _launch(msg_words.device, "expand_msg_xmd", _lib().drand_xmd, x.data_ptr(),
            k, fr.data_ptr(), out.data_ptr(), nw, n)
    _count("expand_msg_xmd", len_in_bytes, n)
    return out.reshape(msg_words.shape[:-1] + (nw,))


def hash_to_field_plain(kind: str, msg, dst: bytes, count: int,
                        msg_len: int = 32):
    """The message front (plain): the raw kinds' digests
    (ops/sha256.py beacon_digests), expand_message_xmd to count * 64
    bytes, each 64-byte chunk OS2IP mod p in Montgomery form
    (limbs.be_words_to_mont).  -> count limb tensors."""
    if kind == "msg":
        words = msg[0]
    else:
        words, msg_len = SHA.beacon_digests(msg), 32
    ub = expand_msg_xmd_plain(words, msg_len, dst, count * HTF_L)
    return [L.be_words_to_mont(ub[..., 16 * i:16 * (i + 1)])
            for i in range(count)]


def hash_to_field(kind: str, msg, dst: bytes, count: int,
                  msg_len: int = 32):
    """Messages -> count field elements a lane ((lanes, 24) Montgomery
    limbs each; 2 for Fp, 4 for two Fp2 elements, c0 before c1).  kind
    and msg as in H1_KINDS, words int64.  One launch of H1's drand_h2f on
    a CUDA tensor, which writes the limb tensors itself; the plain
    version on a CPU tensor.  Counted as hash_to_field (count 2) or
    hash_to_field_fp2 (count 4), keyed by kind."""
    if kind not in H1_KINDS:
        raise ValueError(f"hash_to_field: unknown message kind {kind!r}")
    if not _on_card(msg[0]):
        return hash_to_field_plain(kind, msg, dst, count, msg_len)
    dev = msg[0].device
    a, n = _word_rows(msg[0], msg[0].shape[-1])
    if kind == "msg":
        digest_k, rnd, has = 0, a, a
    elif kind == "raw_unchained":
        digest_k, rnd, has, msg_len = 2, a, a, 32
    else:
        rnd, _ = _word_rows(msg[1], 2)
        has = msg[2].reshape(n).to(torch.int64).contiguous()
        digest_k, msg_len = a.shape[1] + 2, 32
    fr = _frame_tensor(h1_frame(count * HTF_L, dst, msg_len, digest_k),
                       str(dev))
    outs = [torch.empty((n, L.NLIMB), dtype=L.DTYPE, device=dev)
            for _ in range(count)]
    name = "hash_to_field_fp2" if count == 4 else "hash_to_field"
    _launch(dev, name, _lib().drand_h2f, H1_KINDS[kind], a.data_ptr(),
            a.shape[1], rnd.data_ptr(), has.data_ptr(), fr.data_ptr(),
            _ptrs(outs), count, n)
    _count(name, kind, n)
    return outs
