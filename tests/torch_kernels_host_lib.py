"""Shared by tests/test_torch_kernels_host*.py: the kernels' CUDA sources
built once as host C++ (each file's module-scoped `host_lib` calls
`build_host_lib`, which builds once a process), the `kernel_path` fixture
that routes the wrappers' CPU tensors through that build, and the inputs
the files share (points on both curves, K7's rows x lanes batches), and
the bodies of K7's sum_rows cases, which tests/test_torch_kernels_host_k7_*.py
spread over several files by their time on the CPU.
"""

import ctypes
import random
import shutil
import subprocess

import pytest
import torch

from drand_tpu_torch.ops import fp12prog as FP
from drand_tpu_torch.crypto.host.curve import G1 as HG1, G2 as HG2
from drand_tpu_torch.crypto.host import field as HF
from drand_tpu_torch.crypto.host.params import P, R
from drand_tpu_torch.ops import curve as DC
from drand_tpu_torch.ops import kernels as K
from drand_tpu_torch.ops import limbs as L

RNG = random.Random(20240608)
_BUILT = {}


def _rand_fp(n):
    return L.encode_mont([RNG.randrange(P) for _ in range(n)])


def build_host_lib(tmp_path_factory):
    """The bound host build of drand_tpu_torch/ops/csrc/*.cu (g++ as C++17),
    compiled on the first call in a process and reused after it."""
    if "lib" not in _BUILT:
        cxx = shutil.which("c++") or shutil.which("g++")
        if cxx is None:
            pytest.skip("no C++ compiler to build the kernels' host lane "
                        "code")
        out = tmp_path_factory.mktemp("kernels") / "libdrand_kernels_host.so"
        srcs = [str(p) for p in sorted(K.CSRC.glob("*.cu"))]
        subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-x",
                        "c++", *srcs, "-o", str(out)], check=True,
                       capture_output=True, timeout=600)
        _BUILT["lib"] = K.bind(ctypes.CDLL(str(out)))
    return _BUILT["lib"]


@pytest.fixture
def kernel_path(monkeypatch, host_lib):
    """Route the wrappers' CPU tensors through the host-built kernels."""
    monkeypatch.setattr(K, "_lib", lambda: host_lib)
    monkeypatch.setattr(K, "_on_card", lambda t: True)
    monkeypatch.setattr(K, "_stream", lambda device: None)
    K.reset_launches()
    return K.LAUNCHES


def _same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _points():
    members = [HG1.mul(HG1.gen, RNG.randrange(1, R)) for _ in range(3)]
    x = 1
    while True:                       # on the curve, outside G1
        y = HF.fp_sqrt((x ** 3 + 4) % P)
        if y is not None and not HG1.in_subgroup((x, y)):
            break
        x += 1
    return DC.encode_g1_points(members + [(x, y), None, HG1.gen])


def _g2_points():
    """Members, an on-curve point outside G2, infinity and the generator."""
    members = [HG2.mul(HG2.gen, RNG.randrange(1, R)) for _ in range(2)]
    a = 1
    while True:
        xq = (a, 1)
        yq = HF.fp2_sqrt(HF.fp2_add(HF.fp2_mul(HF.fp2_sqr(xq), xq), (4, 4)))
        if yq is not None:
            break
        a += 1
    return members + [(xq, yq), None, HG2.gen]


def _sum_rows_input(g2, rows, lanes):
    """rows x lanes Jacobian points from a few members, an outsider and
    infinity (repeats meet at level 128: the doubling); in row 0 lane 1 =
    -lane 0 and, past 130 lanes, lane 128 = -lane 0 and lane 130 = lane 2
    (P == -Q and P == Q at level 128); row 1, where there is one, all
    infinity."""
    if g2:
        base = DC.encode_g2_points(_g2_points())
    else:
        base = tuple(c[:6] for c in _points())
    nb = K._flat(base)[0].shape[0]
    idx = [RNG.randrange(nb) for _ in range(rows * lanes)]
    pts = DC._tmap(lambda c: c[idx].reshape(rows, lanes, 24).clone(), base)
    curve = K._curve(base)
    neg = curve.neg(DC._tmap(lambda c: c[0, :1], pts))
    inf = curve.infinity_like(K._flat(pts)[0][0])
    for c, d, i in zip(K._flat(pts), K._flat(neg), K._flat(inf)):
        if lanes > 1:
            c[0, 1] = d[0]
        if lanes > 130:
            c[0, 128], c[0, 130] = d[0], c[0, 2]
        if rows > 1:
            c[1] = i
    return pts


K7_CASES = [(False, 1, 1), (False, 2, 255), (False, 8, 256),
            (False, 2, 257), (False, 1, 1024), (False, 1, 8192),
            (True, 1, 1), (True, 2, 257), (True, 1, 1024)]
K7_IDS = [f"{'g2' if g else 'g1'}-{r}x{n}" for g, r, n in K7_CASES]


def k7_cases(*ids):
    """The K7_CASES named by `ids`, and their ids, in K7_CASES' order."""
    pick = [(c, i) for c, i in zip(K7_CASES, K7_IDS) if i in ids]
    assert len(pick) == len(ids), ids
    return [c for c, _ in pick], [i for _, i in pick]


def check_sum_rows(kernel_path, g2, rows, lanes):
    """One launch a batch: every row equals sum_rows' plain twin (each row
    in pallas_field.sum_points' association: 1,024 lanes fold 4 partials,
    8,192 take a second stage) and the kernel's sum_points of that row
    alone; an all-infinity row sums to infinity."""
    pts = _sum_rows_input(g2, rows, lanes)
    got = K.sum_rows(pts)
    name = "sum_rows_g2" if g2 else "sum_rows"
    assert dict(K.SHAPES) == {(name, rows, lanes): 1}
    assert K._flat(got)[0].shape == (rows, 24)
    K.reset_launches()
    _same(K._flat(got), K._flat(K.sum_rows_plain(pts)))
    assert sum(kernel_path.values()) == 0      # the plain twin launches none
    for r in range(rows):
        one = K.sum_points(DC._tmap(lambda c: c[r], pts))
        _same(K._flat(one), [c[r] for c in K._flat(got)])
    if rows > 1:
        assert K._curve(pts).is_infinity(got)[1]


def check_sum_rows_width(monkeypatch, g2, fill):
    """K7 at fp12prog.WIDTH and at FILL_WIDTH (kernels.sum_width picks the
    second from K7_FILL_TILES tiles on): the same limbs."""
    monkeypatch.setattr(K, "K7_FILL_TILES", 1 if fill else 1 << 30)
    kind = "sum_g2" if g2 else "sum_g1"
    assert K.sum_width(kind, 1) == (FP.FILL_WIDTH if fill
                                    else FP.WIDTH)[kind]
    pts = _sum_rows_input(g2, 2 if g2 else 3, 257 if g2 else 300)
    _same(K._flat(K.sum_rows(pts)), K._flat(K.sum_rows_plain(pts)))


def check_sum_rows_padding(g2):
    """A tile of 200 live lanes (the kernel runs no add on its 56 padding
    lanes) gives the limbs of the full halving over the tile zero-padded
    to 256; and an add of a zero-padding lane returns its left operand
    limb for limb, infinity lanes included."""
    pts = _sum_rows_input(g2, 1, 200)
    got = K.sum_rows(pts)
    left = DC._tmap(lambda c: c[0], pts)
    padded = K._pad_lanes(left, K.TILE)
    _same(K._flat(got), K._flat(K.sum_tiles_plain(padded)))
    zero = DC._tmap(torch.zeros_like, left)
    _same(K._flat(K._curve(left).add(left, zero)), K._flat(left))
    _same(K._flat(K._curve(left).add(zero, zero)), K._flat(zero))
