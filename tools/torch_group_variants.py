"""Time the group-per-lane kernels and K1 in the forms and at the widths
the H100 port (drand_tpu_torch) does not ship, beside the ones it ships.

What it measures, on one CUDA card:

  k2: K2 with k = |x| at the lane counts the main paths launch it at
    (2048 for signing and partials, 8192 and 14,336 in the verify
    passes): G1 at 2, 4, 8 and 16 threads a lane, G2 at 4, 8, 16 and 32
    ("fixed": the shipped fragments); one fused double-and-add fragment
    on a one bit ("fused"); and K2 and K6 with DevCurve.double's textbook
    form, D = 2((X + B)^2 - A - C) ("textbook"), where fp12prog._pt_double
    computes D = X * 4B; K6 at its main-path shapes (256 bits at 2048
    lanes; 130 bits at 28,672 on G1, 66 bits at 57,344 on G2) through the
    shipped kernel, whose program table is passed with the launch.
  k5: K5 with e = (p^2 - 9)/16 at its main-path lane counts (4096 for
    signing, 14,336 for recovery, 18,432 for partials, 24,576 in the
    verify passes), at 1, 2 and 4 threads a lane (entries compiled from
    csrc/pow2.cu's lane code), with the shipped program (window 4, the
    schoolbook Fp2 product), window 5, and the Karatsuba product.
  k1: K1 with e = (p-3)/4 at 1, 4096, 18,432 and 24,576 lanes: windows 3,
    4, 5 and 6 (a table of 4, 8, 16, 32 odd powers), blocks of 32, 64 and
    128 threads at window 5, and field.cuh's squaring against fp_mul(a,
    a) (the same source built with -DDRAND_SQR_AS_MUL); and e = p - 2 at
    1, 8192 and 24,576 lanes: the Fermat window chain against the shipped
    constant-time inversion.
  k7: K7 (kernels.sum_rows) at the rows x lanes of the main paths (G1: 2
    x 8192 for the RLC pass, 8 x 14,336 for partials; G2: 2 x 16,384, 8 x
    28,672) at 2, 4, 8 and 16 threads an add on G1 and 4, 8 and 16 on G2
    (2 threads: a warp's 16 adds do not fit 48 KB), entries compiled from
    csrc/sum.cu's own code: the block-per-tile form ("block", the last
    block of a row running the later stages) and the grid form ("grid":
    a cooperative persistent grid over all of a level's adds, a grid
    barrier between levels).
  k8: K8 (kernels.scalar_mul_glv_mixed) at its main-path shapes (G1 64
    bits at 16,384 and 28,672 lanes, G2 32 bits at 32,768 and 57,344) at
    2, 4 and 8 threads a lane on G1 and 4, 8 and 16 on G2 (1 thread on G1
    and 2 on G2: a warp's lanes do not fit 48 KB), entries compiled from
    csrc/glv.cu's own lane code; and with the table outside the slots
    ("copied": before each step the group selects the entry from the limb
    tensors, word by word on the bits' masks, into the add's input slots,
    a program "glv_copied_g1" / "_g2" whose step takes it there).

Every K2 variant's output is compared limb for limb with
kernels.scalar_mul_fixed_plain at 2048 lanes and with the shipped wrapper
at every lane count; every K6, K5 and K1 variant's with the shipped
kernel's (which chip_smoke.py holds against its plain version), and K5's
and K1's shipped output with the plain version at the narrowest count.
Every K7 and K8 variant's with the shipped kernel's, and the shipped
output with the plain version at each shape.
Times are CUDA events, the median of --reps launches after one warm-up.
The extra entries compile from csrc/ladder.cu, csrc/pow2.cu, csrc/pow.cu,
csrc/sum.cu and csrc/glv.cu into build/variants/<hash>/.

  python3 tools/torch_group_variants.py [--reps 5] [--what k2,k5,k1,k7,k8]
                                        [--out FILE]

Prints one JSON object a line; the last is {"ok": true} or {"ok": false}
(exit 1 on a mismatch, and without a CUDA card).
"""

import argparse
import ctypes
import hashlib
import itertools
import json
import random
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

WIDTHS = {1: (2, 4, 8, 16), 2: (4, 8, 16, 32)}   # threads a lane, by curve
K2_LANES = (2048, 8192, 14336)
K6_SHAPES = {1: ((256, 2048), (130, 28672)), 2: ((256, 2048), (66, 57344))}
K5_LANES = (4096, 14336, 18432, 24576)
K1_LANES = (1, 4096, 18432, 24576)
K1_INV_LANES = (1, 8192, 24576)
K1_WINDOWS = (3, 4, 5, 6)
K1_THREADS = (32, 64, 128)
K7_WIDTHS = {1: (2, 4, 8, 16), 2: (4, 8, 16)}
K7_SHAPES = {1: ((2, 8192), (8, 14336)), 2: ((2, 16384), (8, 28672))}
K8_WIDTHS = {1: (2, 4, 8), 2: (4, 8, 16)}
K8_SHAPES = {1: (16384, 28672), 2: (32768, 57344)}
K8_BITS = {1: 64, 2: 32}


def extra_source():
    """A K2 entry for every width in WIDTHS, from csrc/ladder.cu's own lane
    code, and one C entry that launches the one asked for."""
    lines, calls = ['#include "ladder.cu"', "#ifdef __CUDACC__"], []
    for n, ws in WIDTHS.items():
        for w in ws:
            name = f"kv_g{n}_{w}"
            lines.append(f"K2_KERNEL({name}, {w}, {3 * n})")
            calls.append(f"  if (g2 == {n - 1} && width == {w})\n"
                         f"    DRAND_GROUP_LAUNCH({name}, {w}, B, nslots, "
                         f"stream, K2_ARGS);")
    lines.append(
        'extern "C" int drand_variant_ladder(int g2, const void* in, '
        "void* out, const void* consts, const void* prog, int nslots, "
        "int width, const void* sched, int nsched, int64_t B, "
        "void* stream) {")
    return "\n".join(lines + calls + ["  return 1;", "}", "#endif", ""])


def k1_source():
    """A K1 chain entry for every window in K1_WINDOWS (128 threads a
    block) and every block size in K1_THREADS (window 5), from
    csrc/pow.cu's own lane code, and one C entry that launches the one
    asked for."""
    lines, calls = ['#include "pow.cu"', "#ifdef __CUDACC__"], []
    shapes = {(w, 128) for w in K1_WINDOWS} | {(5, t) for t in K1_THREADS}
    for w, t in sorted(shapes):
        name = f"kv_pow_w{w}_t{t}"
        lines.append(f"K1_KERNEL({name}, {1 << (w - 1)}, {t})")
        calls.append(f"  if (window == {w} && threads == {t})\n"
                     f"    DRAND_LAUNCH({name}, B, {t}, stream, "
                     "(const int64_t*)x, (int64_t*)out, "
                     "(const int32_t*)sched, nsched, ntab, B);")
    lines.append(
        'extern "C" int drand_variant_pow(int window, int threads, '
        "const void* x, void* out, const void* sched, int nsched, int ntab, "
        "int64_t B, void* stream) {")
    return "\n".join(lines + calls + ["  return 1;", "}", "#endif", ""])


K5_WIDTHS = (1, 2, 4)


def k5_source():
    """A K5 entry for every width in K5_WIDTHS, from csrc/pow2.cu's own
    lane code, and one C entry that launches the one asked for."""
    lines, calls = ['#include "pow2.cu"', "#ifdef __CUDACC__"], []
    for w in K5_WIDTHS:
        lines.append(f"K5_KERNEL(kv_pow2_w{w}, {w})")
        calls.append(f"  if (width == {w})\n"
                     f"    DRAND_GROUP_LAUNCH(kv_pow2_w{w}, {w}, B, nslots, "
                     "stream, K5_ARGS);")
    lines.append(
        'extern "C" int drand_variant_pow2(int width, const void* in, '
        "void* out, const void* consts, const void* prog, int nslots, "
        "const void* sched, int nsched, int64_t B, void* stream) {")
    return "\n".join(lines + calls + ["  return 1;", "}", "#endif", ""])


def k7k8_source():
    """A K7 entry for every width in K7_WIDTHS and a K8 entry for every
    width in K8_WIDTHS, from csrc/sum.cu's and csrc/glv.cu's own code, and
    one C entry each that launches the one asked for."""
    lines = ['#include "sum.cu"', '#include "glv.cu"', "#ifdef __CUDACC__",
             SUM_GRID]
    k7, k8 = [], []
    for n, ws in K7_WIDTHS.items():
        for w in ws:
            lines.append(f"K7_KERNEL(kv_sum_g{n}_{w}, {w}, {3 * n})")
            lines.append(f"K7_GRID_KERNEL(kv_sumgrid_g{n}_{w}, {w}, {3 * n})")
            k7.append(f"  if (g2 == {n - 1} && width == {w} && !grid)\n"
                      f"    K7_LAUNCH(kv_sum_g{n}_{w}, {w}, {3 * n});")
            k7.append(f"  if (g2 == {n - 1} && width == {w} && grid)\n"
                      f"    return sum_grid_launch(kv_sumgrid_g{n}_{w}, {w}, "
                      "nslots, consts, prog, a, rows, part, tickets, "
                      "stream);")
    lines.append(GLV_COPIED)
    for n, ws in K8_WIDTHS.items():
        for w in ws:
            lines.append(f"K8_KERNEL(kv_glv_g{n}_{w}, {w}, {n})")
            lines.append(f"KC_KERNEL(kv_glvc_g{n}_{w}, {w}, {n})")
            k8.append(f"  if (g2 == {n - 1} && width == {w} && !copied)\n"
                      f"    K8_LAUNCH(kv_glv_g{n}_{w}, {w}, {n});")
            k8.append(f"  if (g2 == {n - 1} && width == {w} && copied)\n"
                      f"    K8_LAUNCH(kv_glvc_g{n}_{w}, {w}, {n});")
    lines.append(
        'extern "C" int drand_variant_sum(int g2, int width, int grid, '
        "const void* const* in, const void* const* out, const void* consts, "
        "const void* prog, int nslots, void* work, void* part, "
        "void* tickets, int rows, int64_t B, void* stream) {\n"
        "  const SumArgs a = sum_args(in, out, g2 ? 6 : 3, work, part, "
        "tickets, B);")
    lines += k7 + ["  return 1;", "}"]
    lines.append(
        'extern "C" int drand_variant_glv(int g2, int width, int copied, '
        "const void* const* tab, const void* const* out, const void* consts, "
        "const void* prog, int nslots, const void* bits, int nbits, "
        "int64_t B, void* stream) {")
    return "\n".join(lines + k8 + ["  return 1;", "}", "#endif", ""])


# K7's grid form, measured against the block-per-tile form that
# csrc/sum.cu ships (it reuses that file's add, sum_add, and its layout).
SUM_GRID = r"""
// ---------------------------------------------------------------------------
// The grid form: the same adds, level by level over the whole batch.  A
// persistent grid (a cooperative launch, every block resident) spreads all
// the adds of a level, across tiles and rows, over all its groups, with a
// grid barrier between levels; stage s + 1 takes the tiles' sums of stage
// s as its lanes (two work buffers in turn), and the fold runs a group a
// row.  Its rounds a level are the level's adds over the grid's groups,
// where a block per tile runs its tile's adds over its own A groups.
// ---------------------------------------------------------------------------

// Lanes of tile t of a stage of n lanes, and level sh's adds in it.
DI int tile_lanes(int64_t n, int64_t t) {
  const int64_t m = n - t * SUM_TILE;
  return m < SUM_TILE ? (int)m : SUM_TILE;
}

DI int level_adds(int m, int sh) {
  const int live = m < 2 * sh ? m : 2 * sh;
  return live > sh ? live - sh : 0;
}

// A group whose item is dead repeats a live item of its warp and stores
// nothing (every __syncwarp then meets the warp); -1 where the warp has no
// live item.
DI int64_t pick_live(bool live, int64_t q) {
#ifdef __CUDACC__
  const unsigned m = __ballot_sync(0xffffffffu, live);
  if (m == 0) return -1;
  const int64_t other = __shfl_sync(0xffffffffu, q, __ffs(m) - 1);
  return live ? q : other;
#else
  return live ? q : -1;
#endif
}

// Every block of the grid waits here until all have arrived (bar counts
// arrivals, zero at the launch).
DI void grid_sync(unsigned* bar, unsigned nblocks) {
#ifdef __CUDACC__
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned target = (atomicAdd(bar, 1u) / nblocks + 1) * nblocks;
    while (*(volatile unsigned*)bar < target) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
#else
  (void)bar;
  (void)nblocks;
#endif
}

// The grid's blocks: this one, of nblocks; work2 the second stage's work
// buffer (rows x ceil(T0 / 256) x 128 points).
template <int W, int NC>
DI void sum_grid(const SumBlock& k, const SumArgs& a, int rows, Fp* work2,
                 unsigned* bar, int block, int nblocks) {
  const int64_t groups = (int64_t)nblocks * k.A;
  const int64_t gid = (int64_t)block * k.A + k.gi;
  const int64_t threads = (int64_t)nblocks * k.nt;
  const int64_t tid = (int64_t)block * k.nt + k.tid;
  // the stage's lanes: the input limbs, then the tiles' sums of the stage
  // before, lane u of row r at src + r src_row + u stride
  const Fp* src = nullptr;
  int64_t src_row = 0, stride = NC, n = a.B, tiles = a.T0;
  Fp* dst = a.work;
  for (;;) {
    const Fp* row_src;
    // level 128's lanes whose partner is padding: copied
    for (int64_t i = tid; i < rows * tiles * SUM_HALF * NC; i += threads) {
      const int c = (int)(i % NC), j = (int)(i / NC % SUM_HALF);
      const int64_t rt = i / NC / SUM_HALF, t = rt % tiles;
      const int r = (int)(rt / tiles), m = tile_lanes(n, t);
      row_src = src ? src + r * src_row : nullptr;
      if (j >= level_adds(m, SUM_HALF) && j < (m < SUM_HALF ? m : SUM_HALF))
        word_store(dst + (rt * SUM_HALF + j) * NC + c,
                   tile_load<NC>(a, r, t * SUM_TILE, row_src, stride, j, c));
    }
    for (int sh = SUM_HALF; sh >= 1; sh >>= 1) {
      const int64_t items = rows * tiles * sh;
      for (int64_t q0 = 0; q0 < items; q0 += groups) {
        int64_t q = q0 + gid;
        const bool live = q < items &&
            q % sh < level_adds(tile_lanes(n, q / sh % tiles), sh);
        q = pick_live(live, q);
        if (q < 0) continue;
        const int j = (int)(q % sh);
        const int64_t rt = q / sh, t = rt % tiles;
        const int r = (int)(rt / tiles);
        Fp* wk = dst + rt * SUM_HALF * NC;
        row_src = src ? src + r * src_row : nullptr;
        if (sh == SUM_HALF)
          sum_add<W, NC>(*k.g, k.slots, k.cs, a, r, t * SUM_TILE, row_src,
                         stride, j, sh, live, wk + j * NC);
        else
          sum_add<W, NC>(*k.g, k.slots, k.cs, a, r, 0, wk, NC, j, sh, live,
                         wk + j * NC);
      }
      grid_sync(bar, nblocks);
    }
    src = dst;
    src_row = tiles * SUM_HALF * NC;
    stride = SUM_HALF * NC;
    n = tiles;
    if (n <= 4) break;
    dst = dst == a.work ? work2 : a.work;
    tiles = (n + SUM_TILE - 1) / SUM_TILE;
  }
  // the fold, lane 0 += lane i in order, and the row's sum out: a group a
  // row
  for (int64_t q0 = 0; q0 < rows; q0 += groups) {
    const bool live = q0 + gid < rows;
    const int64_t r = pick_live(live, q0 + gid);
    if (r < 0) continue;
    Fp* row = (Fp*)src + r * src_row;
    for (int i = 1; i < n; i++)
      sum_add<W, NC>(*k.g, k.slots, k.cs, a, (int)r, 0, row, stride, 0, i,
                     live, row);
    group_phase<W>([&](int th) {
      for (int c = th; c < NC && live; c += W)
        store_fp_limbs(a.out.c[c], word_load(row + c), r);
    });
  }
}


template <int W, int NC>
DI void sum_grid_kernel(const uint32_t* consts, const int32_t* prog,
                        const SumArgs& a, int rows, Fp* work2,
                        unsigned* bar) {
  extern __shared__ __align__(16) Fp smem[];
  const GroupProg g = group_prog(prog);
  load_group_consts(smem, consts, threadIdx.x, blockDim.x);
  __syncthreads();
  const int gi = threadIdx.x / W;
  const SumBlock k{&g, smem + N_CONST + gi * g.nslots, smem,
                   (int)threadIdx.x, (int)blockDim.x, gi,
                   (int)blockDim.x / W};
  sum_grid<W, NC>(k, a, rows, work2, bar, blockIdx.x, gridDim.x);
}

#define K7_GRID_KERNEL(name, W, NC)                                          \
  __global__ void __launch_bounds__(K7_THREADS)                             \
      name(const uint32_t* consts, const int32_t* prog, SumArgs a, int rows, \
           Fp* work2, unsigned* bar) {                                       \
    sum_grid_kernel<W, NC>(consts, prog, a, rows, work2, bar);               \
  }

// A cooperative launch of the grid form: as many blocks as the first
// level's adds need, at most as many as the card holds at once.
template <class Kernel>
static int sum_grid_launch(Kernel kernel, int width, int nslots,
                           const void* consts, const void* prog, SumArgs a,
                           int rows, void* work2, void* bar, void* stream) {
  const int adds = sum_adds_per_block(nslots, width);
  if (adds < 1 || rows < 1) return 1;
  if (a.B < 1) return (int)cudaGetLastError();
  const int threads = adds * width;
  const size_t smem = sizeof(Fp) * (N_CONST + adds * nslots);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  const int64_t need = ((int64_t)rows * a.T0 * SUM_HALF + adds - 1) / adds;
  int blocks = per_sm * sms;
  if (need < blocks) blocks = (int)need;
  if (blocks < 1) return 1;
  void* args[] = {(void*)&consts, (void*)&prog, (void*)&a, (void*)&rows,
                  (void*)&work2, (void*)&bar};
  cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                              dim3(threads), args, smem,
                              (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

"""


# K8 with the table outside the slots: before each step the group picks
# the entry sel(b0, sel(b1, P3, P), sel(b1, endo, P)) word by word from the
# limb tensors into slots 3 N .. 5 N - 1 and the flag b0 | b1 into 5 N; the
# program ("glv_copied_g*", glv_copied_kind) adds it there.
GLV_COPIED = r"""
template <int W, int N>
DI void glv_lane_copied(const GroupProg& g, Fp* lane, const Fp* cs,
                        const Limbs& tab, const Limbs& out,
                        const int32_t* bits, int nbits, int64_t B,
                        int64_t idx) {
  const int64_t src = idx < B ? idx : B - 1;
  for (int i = -1; i < nbits; i++) {
    if (i >= 0) {
      const uint32_t m0 = 0u - (uint32_t)(bits[(int64_t)i * B + src] == 1);
      const uint32_t m1 =
          0u - (uint32_t)(bits[((int64_t)nbits + i) * B + src] == 1);
      group_phase<W>([&](int t) {
        for (int c = t; c <= 2 * N; c += W) {
          Fp x;
          if (c == 2 * N) {
            for (int w = 0; w < 12; w++) x.v[w] = m0 | m1;
          } else {
            Fp p, e, q;
            load_fp_limbs(p, tab.c[c], src);
            load_fp_limbs(e, tab.c[2 * N + c], src);
            load_fp_limbs(q, tab.c[4 * N + c], src);
            for (int w = 0; w < 12; w++) {
              const uint32_t a = (q.v[w] & m1) | (p.v[w] & ~m1);
              const uint32_t b = (e.v[w] & m1) | (p.v[w] & ~m1);
              x.v[w] = (a & m0) | (b & ~m0);
            }
          }
          slot_store(lane + 3 * N + c, x);
        }
      });
    }
    run_frag<W>(g, lane, cs, i < 0 ? K8_INIT : K8_STEP);
  }
  store_lane_limbs<W>(out, lane, 3 * N, B, idx);
}

template <int W, int N>
DI void glvc_block(const Limbs& tab, const Limbs& out, const uint32_t* consts,
                   const int32_t* prog, const int32_t* bits, int nbits,
                   int64_t B) {
  extern __shared__ __align__(16) Fp smem[];
  const GroupProg g = group_prog(prog);
  int64_t idx;
  Fp* lane = group_enter<W>(smem, consts, g.nslots, B, &idx);
  if (lane) glv_lane_copied<W, N>(g, lane, smem, tab, out, bits, nbits, B,
                                  idx);
}

#define KC_KERNEL(name, W, N)                                                \
  __global__ void __launch_bounds__(GROUP_THREADS)                          \
      name(Limbs tab, Limbs out, const uint32_t* consts,                     \
           const int32_t* prog, const int32_t* bits, int nbits, int64_t B) { \
    glvc_block<W, N>(tab, out, consts, prog, bits, nbits, B);                \
  }
"""


def glv_copied_kind(FP, n):
    """The KINDS entry of K8's program with the table outside the slots:
    acc at 0, the selected entry at 3 n (2 n), the flag b0 | b1 at 5 n."""
    def step(g):
        acc = FP._k6_point(g, 0, n)
        acc2 = tuple(FP._mat(g, c) for c in FP._pt_double(g, acc))
        t = (FP._k6_elem(g, 3 * n, n), FP._k6_elem(g, 4 * n, n))
        cond = g.inp(5 * n)
        FP._k6_out(g, 0, FP._pt_add_mixed(g, n, acc2, t, lambda: cond))
    return (5 * n + 1, [lambda g: FP._glv_init(g, n), step], (0, 0))


def build_lib(K, src, tag, flags=()):
    """Compile src into build/variants/<hash>/ (cached by its text, the
    flags and the kernels' hash); -> (ctypes library, ptxas statistics
    per kv_ entry)."""
    h = hashlib.sha256((src + " ".join(flags) + K.build_hash()).encode()
                       ).hexdigest()[:16]
    d = K.BUILD_ROOT.parent / "variants" / h
    lib = d / f"libdrand_{tag}.so"
    if not lib.exists():
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{tag}.cu").write_text(src)
        r = subprocess.run([K._nvcc(), *K.NVCC_FLAGS, *flags, "-Xptxas",
                            "-v", "-shared", "-I", str(K.CSRC),
                            str(d / f"{tag}.cu"), "-o", str(lib)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
        (d / "build.log").write_text(r.stdout + r.stderr)
    stats, entry = {}, None
    for ln in (d / "build.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry = m.group(1) if "kv_" in m.group(1) else None
        elif entry and "stack frame" in ln:
            stats[entry] = dict(zip(("stack", "spill_stores", "spill_loads"),
                                    map(int, re.findall(r"(\d+) bytes", ln))))
        elif entry and "Used" in ln:
            stats[entry]["registers"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
    return ctypes.CDLL(str(lib)), stats


def build_variants(K):
    """The K2 widths' library: -> (library, ptxas statistics per entry)."""
    cdll, stats = build_lib(K, extra_source(), "variants")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    cdll.drand_variant_ladder.argtypes = [i32, vp, vp, vp, vp, i32, i32, vp,
                                          i32, i64, vp]
    cdll.drand_variant_ladder.restype = ctypes.c_int
    return cdll, stats


def build_k5(K):
    """The K5 widths' library."""
    cdll, stats = build_lib(K, k5_source(), "k5")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    cdll.drand_variant_pow2.argtypes = [i32, vp, vp, vp, vp, i32, vp, i32,
                                        i64, vp]
    cdll.drand_variant_pow2.restype = ctypes.c_int
    return cdll, stats


def build_k1(K, sqr_as_mul):
    """The K1 windows' and block sizes' library, with field.cuh's squaring
    or (sqr_as_mul) fp_mul(a, a)."""
    flags = ("-DDRAND_SQR_AS_MUL",) if sqr_as_mul else ()
    cdll, stats = build_lib(K, k1_source(),
                            "k1_mulsqr" if sqr_as_mul else "k1", flags)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    cdll.drand_variant_pow.argtypes = [i32, i32, vp, vp, vp, i32, i32, i64,
                                       vp]
    cdll.drand_variant_pow.restype = ctypes.c_int
    cdll.drand_inv.argtypes = [vp, vp, i64, vp]
    cdll.drand_inv.restype = ctypes.c_int
    return cdll, stats


def build_k7k8(K):
    """The K7 and K8 widths' library."""
    cdll, stats = build_lib(K, k7k8_source(), "k7k8")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    cdll.drand_variant_sum.argtypes = [i32, i32, i32, vp, vp, vp, vp, i32,
                                       vp, vp, vp, i32, i64, vp]
    cdll.drand_variant_glv.argtypes = [i32, i32, i32, vp, vp, vp, vp, i32,
                                       vp, i32, i64, vp]
    cdll.drand_variant_sum.restype = ctypes.c_int
    cdll.drand_variant_glv.restype = ctypes.c_int
    return cdll, stats


def variant_programs(FP):
    """Register the variant kinds with fp12prog and compile them:
    fused_g1/_g2 (init, double, a fused double-and-add), textbook_g1/_g2
    (K2's fragments) and textbook_ladder_g1/_g2 (K6's), the last two traced
    with the textbook double in place of _pt_double."""
    def textbook_double(g, p):
        X1, Y1, Z1 = p
        A, B, t = FP._e_sqr(X1), FP._e_sqr(Y1), FP._e_mul(Y1, Z1)
        C, U = FP._e_sqr(B), FP._e_sqr(FP._e_add(X1, B))
        D = FP._e_scale(FP._e_sub(FP._e_sub(U, A), C), 2)
        E = FP._e_scale(A, 3)
        X3 = FP._e_sub(FP._e_sqr(E), FP._e_scale(D, 2))
        Y3 = FP._e_sub(FP._e_mul(E, FP._e_sub(D, X3)), FP._e_scale(C, 8))
        return X3, Y3, FP._e_scale(t, 2)

    def fused(n):
        def frag(g):
            lay = FP.K2[n]
            acc = FP._k6_point(g, lay["ACC"], n)
            acc2 = tuple(FP._mat(g, c) for c in FP._pt_double(g, acc))
            FP._k6_out(g, lay["ACC"], FP._pt_add(
                g, n, acc2, *FP._pt_operand(g, n, lay),
                lambda: g.inp(lay["FIN2"])))
        return frag

    for n in (1, 2):
        init, dbl, _ = FP.KINDS[f"fixed_g{n}"][1]
        FP.KINDS[f"fused_g{n}"] = (FP.K2[n]["N"], [init, dbl, fused(n)],
                                   (0, 0))
        FP.KINDS[f"textbook_g{n}"] = FP.KINDS[f"fixed_g{n}"]
        FP.KINDS[f"textbook_ladder_g{n}"] = FP.KINDS[f"ladder_g{n}"]
        FP.program(f"fused_g{n}")
    shipped = FP._pt_double
    FP._pt_double = textbook_double
    try:
        for n in (1, 2):
            FP.program(f"textbook_g{n}")
            FP.program(f"textbook_ladder_g{n}")
    finally:
        FP._pt_double = shipped


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--what", default="k2,k5,k1",
                    help="which kernels' variants, comma-separated")
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()
    what = set(args.what.split(","))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_group_variants: no CUDA card", file=sys.stderr)
        return 1
    from drand_tpu_torch.crypto.host import curve as HC
    from drand_tpu_torch.crypto.host.params import R, X
    from drand_tpu_torch.ops import curve as DC
    from drand_tpu_torch.ops import fp12prog as FP
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops import limbs as L

    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    sink = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    emit({"device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi[0] if smi else None})
    dev = "cuda"
    K._lib()

    def timed(fn):
        fn()
        times = []
        for _ in range(args.reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    def words(p):
        leaves = K._flat(p)
        shape = torch.broadcast_shapes(*(c.shape for c in leaves))[:-1]
        return K.to_words([c.expand(shape + (L.NLIMB,)) for c in leaves])

    def layout(nslots, width):
        out = (ctypes.c_int32 * 2)()
        K._lib().drand_group_layout(nslots, width, out)
        return {"lanes_per_block": out[0], "smem_bytes": out[1]}

    random.seed(20261017)
    consts = K.const_bundle(dev)
    ok = True
    if "k2" in what:
        ok &= run_k2(K, FP, L, DC, HC, R, X, dev, consts, emit, timed, words,
                     layout)
    if "k5" in what:
        ok &= run_k5(K, FP, dev, consts, emit, timed, layout)
    if "k1" in what:
        ok &= run_k1(K, dev, emit, timed)
    if "k7" in what or "k8" in what:
        ok &= run_k7k8(K, FP, DC, HC, R, dev, consts, emit, timed, what)
    emit({"ok": bool(ok)})
    return 0 if ok else 1


def run_k2(K, FP, L, DC, HC, R, X, dev, consts, emit, timed, words, layout):
    """K2's widths, fragments and double; K6's double."""
    import torch
    vlib, ptxas = build_variants(K)
    emit({"ptxas": ptxas})
    variant_programs(FP)
    ok = True
    k = -X
    xbits = L.exp_bits(k)
    for n in (1, 2):
        g2 = n == 2
        H = HC.G2 if g2 else HC.G1
        enc = DC.encode_g2_points if g2 else DC.encode_g1_points
        base = [H.mul(H.gen, random.randrange(1, R)) for _ in range(16)]
        progs = {}
        for form in ("fixed", "fused", "textbook"):
            kind = f"{form}_g{n}"
            tab = FP.program(kind)
            sched = ([0] + [2 if b else 1 for b in xbits] if form == "fused"
                     else FP.schedule(f"fixed_g{n}", xbits))
            progs[form] = (torch.from_numpy(tab).to(dev), int(tab[0]),
                           torch.tensor(sched, dtype=torch.int32, device=dev))
            emit({"kind": kind, "slots": int(tab[0]), "schedule": len(sched),
                  "layout": {w: layout(int(tab[0]), w) for w in WIDTHS[n]}})
        emit({"kind": f"fixed_g{n}", "lane_counts_at_width": {
            w: FP.lane_counts(f"fixed_g{n}", xbits, w) for w in WIDTHS[n]}})
        for lanes in K2_LANES:
            pts = enc((base * (lanes // 16 + 1))[:lanes - 1] + [None], dev)
            x = words(pts)
            ref = words(K.scalar_mul_fixed(pts, k))
            if lanes == K2_LANES[0]:
                plain = words(K.scalar_mul_fixed_plain(pts, k))
                err = int((ref - plain).abs().max())
                emit({"check": f"K2-G{n} shipped vs plain at {lanes}",
                      "max_abs_err": err})
                ok &= err == 0
            row = {"shipped_wrapper": timed(
                lambda: K.scalar_mul_fixed(pts, k))}
            for form, (prog, nslots, sched) in progs.items():
                for w in WIDTHS[n]:
                    def run():
                        out = torch.empty_like(x)
                        K._check(vlib.drand_variant_ladder(
                            int(g2), x.data_ptr(), out.data_ptr(),
                            consts.data_ptr(), prog.data_ptr(), nslots, w,
                            sched.data_ptr(), sched.numel(), lanes,
                            K._stream(x.device)), f"{form} at {w}")
                        return out
                    err = int((run() - ref).abs().max())
                    ok &= err == 0
                    row[f"{form} w{w}"] = timed(run)
                    row[f"{form} w{w} max_abs_err"] = err
            emit({"k2": f"G{n}", "scalar": "|x|", "lanes": lanes,
                  "ms": row})
        # K6: the shipped program against the textbook double's, through
        # the shipped kernel at its width
        kind = f"ladder_g{n}"
        fn = K._lib().drand_ladder_var_g2 if g2 else K._lib().drand_ladder_var_g1
        for nbits, lanes in K6_SHAPES[n]:
            pts = enc((base * (lanes // 16 + 1))[:lanes - 1] + [None], dev)
            x = words(pts)
            bits = torch.randint(0, 2, (nbits, lanes), dtype=torch.int32,
                                 device=dev)
            ref = words(K.scalar_mul_bits(pts, bits))
            row = {}
            for form, name in (("shipped", kind),
                               ("textbook", f"textbook_{kind}")):
                tab = FP.program(name)
                prog = torch.from_numpy(tab).to(dev)

                def run():
                    out = torch.empty_like(x)
                    K._check(fn(x.data_ptr(), out.data_ptr(),
                                consts.data_ptr(), prog.data_ptr(),
                                int(tab[0]), FP.WIDTH[kind], bits.data_ptr(),
                                nbits, lanes, K._stream(x.device)), name)
                    return out
                err = int((run() - ref).abs().max())
                ok &= err == 0
                row[form] = timed(run)
                row[f"{form} max_abs_err"] = err
                row[f"{form} slots"] = int(tab[0])
                row[f"{form} layout"] = layout(int(tab[0]), FP.WIDTH[kind])
            emit({"k6": f"G{n}", "bits": nbits, "lanes": lanes,
                  "threads_per_lane": FP.WIDTH[kind], "ms": row})
    return ok


def karatsuba_mul(g, k, conj):
    """K5's product by table entry k (or its conjugate) as Karatsuba over
    Fp2: t0 = a0 b0, t1 = a1 b1, t2 = (a0 + a1)(b0 -+ b1); c0 = t0 -+ t1,
    c1 = t2 - t0 -+ t1 (the lower signs for conj): three products, a
    linear phase before them and two after, where fp12prog._pow2_mul's
    schoolbook form runs four products and one linear phase."""
    from drand_tpu_torch.ops import fp12prog as FP
    a, b = FP._pow2_acc(g), FP._pow2_entry(g, k)
    s = -1 if conj else 1
    t0, t1 = a[0] * b[0], a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + s * b[1])
    g.out(0, t0 - s * t1)
    g.out(1, t2 - t0 - s * t1)


def run_k5(K, FP, dev, consts, emit, timed, layout):
    """K5 at E2 at each width in K5_WIDTHS, with the shipped program
    (window 4, the schoolbook product), window 5 and the Karatsuba
    product."""
    import torch
    from drand_tpu_torch.crypto.host.params import P
    e = (P * P - 9) // 16
    vlib, ptxas = build_k5(K)
    emit({"k5_ptxas": ptxas})
    forms = {"shipped": ("pow2", FP.POW2_WINDOW),
             "w5": ("pow2_w5", 5), "karatsuba": ("pow2_karatsuba", 4)}
    FP.KINDS["pow2_w5"] = FP.pow2_kind(5)
    FP.KINDS["pow2_karatsuba"] = FP.pow2_kind(4)
    shipped = FP._pow2_mul
    FP._pow2_mul = karatsuba_mul
    try:
        FP.program("pow2_karatsuba")
    finally:
        FP._pow2_mul = shipped
    progs = {}
    for form, (kind, w) in forms.items():
        tab = FP.program(kind)
        sched = FP.pow2_schedule(e, w)
        progs[form] = (torch.from_numpy(tab).to(dev), int(tab[0]),
                       torch.tensor(sched, dtype=torch.int32, device=dev))
        emit({"k5_program": form, "window": w, "slots": int(tab[0]),
              "schedule": len(sched),
              "lane_counts_at_width": {
                  wd: FP.lane_counts("pow2", e, wd) if kind == "pow2"
                  else None for wd in K5_WIDTHS},
              "layout": {wd: layout(int(tab[0]), wd) for wd in K5_WIDTHS}})
    ok = True
    for lanes in K5_LANES:
        x = (rand_fp(lanes, dev), rand_fp(lanes, dev))
        words = K.to_words(list(x))
        ref = K.to_words(list(K.pow_fixed_fp2(x, e)))
        if lanes == K5_LANES[0]:
            plain = K.to_words(list(K.pow_fixed_fp2_plain(x, e)))
            err = int((ref - plain).abs().max())
            emit({"check": f"K5 shipped vs plain at {lanes}",
                  "max_abs_err": err})
            ok &= err == 0
        row = {"shipped_wrapper": timed(lambda: K.pow_fixed_fp2(x, e))}
        for form, (prog, nslots, sched) in progs.items():
            for wd in K5_WIDTHS:
                if layout(nslots, wd)["lanes_per_block"] < 1:
                    continue          # a whole warp of lanes over 48 KB
                def run():
                    out = torch.empty_like(words)
                    K._check(vlib.drand_variant_pow2(
                        wd, words.data_ptr(), out.data_ptr(),
                        consts.data_ptr(), prog.data_ptr(), nslots,
                        sched.data_ptr(), sched.numel(), lanes,
                        K._stream(words.device)), f"{form} at {wd}")
                    return out
                err = int((run() - ref).abs().max())
                ok &= err == 0
                row[f"{form} w{wd}"] = timed(run)
                row[f"{form} w{wd} max_abs_err"] = err
        emit({"k5": "(p^2-9)/16", "lanes": lanes, "ms": row})
    return ok


def rand_fp(m, dev):
    """m random Montgomery Fp elements on the card (16-bit limbs, the top
    one below p's)."""
    import torch
    from drand_tpu_torch.crypto.host.params import P
    from drand_tpu_torch.ops import limbs as L
    x = torch.randint(0, 1 << 16, (m, L.NLIMB), device=dev)
    x[:, -1] %= P >> (16 * (L.NLIMB - 1))
    return x


def run_k1(K, dev, emit, timed):
    """K1: the sqrt chain at each window, block size and squaring; p - 2
    by the Fermat chain against the shipped inversion."""
    import torch
    from drand_tpu_torch.crypto.host.params import P
    libs = {}
    for mul in (False, True):
        libs[mul], st = build_k1(K, mul)
        emit({"k1_ptxas": "fp_mul(a, a)" if mul else "fp_sqr", "entries": st})
    ok = True

    def chain(lib, e, w, t, x, out):
        """K1's entries take the limb tensors, (B, 24) int64."""
        sched, ntab = K.pow_schedule(e, w)
        sd = torch.tensor(sched, dtype=torch.int32, device=dev)
        return lambda: K._check(lib.drand_variant_pow(
            w, t, x.data_ptr(), out.data_ptr(), sd.data_ptr(), sd.numel(),
            ntab, x.shape[0], K._stream(x.device)), f"K1 w{w} t{t}")

    e = (P - 3) // 4
    for lanes in K1_LANES:
        x = rand_fp(lanes, dev)
        ref = K.pow_fixed(x, e)
        if lanes == K1_LANES[0]:
            err = int((ref - K.pow_fixed_plain(x, e)).abs().max())
            emit({"check": f"K1 shipped vs plain at {lanes}",
                  "max_abs_err": err})
            ok &= err == 0
        row = {"shipped_wrapper": timed(lambda: K.pow_fixed(x, e))}
        variants = [(f"w{w} t128", False, w, 128) for w in K1_WINDOWS]
        variants += [(f"w5 t{t}", False, 5, t) for t in K1_THREADS
                     if t != 128]
        variants += [("w5 t128 fp_mul(a, a)", True, 5, 128)]
        for label, mul, w, t in variants:
            out = torch.empty_like(x)
            fn = chain(libs[mul], e, w, t, x, out)
            fn()
            err = int((out - ref).abs().max())
            ok &= err == 0
            row[label] = timed(fn)
            row[f"{label} max_abs_err"] = err
        emit({"k1": "(p-3)/4", "lanes": lanes, "ms": row})
    for lanes in K1_INV_LANES:
        x = rand_fp(lanes, dev)
        ref = K.pow_fixed(x, P - 2)
        out = torch.empty_like(x)
        fermat = chain(libs[False], P - 2, 5, 128, x, out)
        fermat()
        err = int((out - ref).abs().max())
        ok &= err == 0
        inv = lambda: K._check(K._lib().drand_inv(
            x.data_ptr(), out.data_ptr(), lanes, K._stream(x.device)), "inv")
        emit({"k1": "p-2", "lanes": lanes, "ms": {
            "inversion (shipped)": timed(inv),
            "shipped_wrapper": timed(lambda: K.pow_fixed(x, P - 2)),
            "fermat w5 chain": timed(fermat),
            "fermat max_abs_err": err}})
    return ok


def run_k7k8(K, FP, DC, HC, R, dev, consts, emit, timed, what):
    """K7 and K8 at each compiled width, at their main-path shapes; each
    variant's output against the shipped kernel's, the shipped one's
    against the plain version."""
    import torch
    vlib, ptxas = build_k7k8(K)
    emit({"k7k8_ptxas": ptxas})
    ok = True

    def points(n, lanes):
        H = HC.G2 if n == 2 else HC.G1
        base = [H.mul(H.gen, random.randrange(1, R)) for _ in range(16)]
        enc = DC.encode_g2_points if n == 2 else DC.encode_g1_points
        p = enc(base + [None], dev)
        idx = torch.randint(0, len(base) + 1, (lanes,), device=dev)
        return DC._tmap(lambda c: c[idx], p)

    def flat_err(a, b):
        return max(int((x - y).abs().max())
                   for x, y in zip(K._flat(a), K._flat(b)))

    for n in (1, 2):
        kind = f"sum_g{n}"
        if "k7" not in what:
            break
        tab = FP.program(kind)
        prog = torch.from_numpy(tab).to(dev)
        emit({"kind": kind, "slots": int(tab[0]), "layout": {
            w: K.group_layout(kind, w) for w in K7_WIDTHS[n]},
            "lane_counts_at_width": {w: FP.lane_counts(kind, None, w)
                                     for w in K7_WIDTHS[n]}})
        for rows, lanes in K7_SHAPES[n]:
            p = DC._tmap(lambda c: c.reshape(rows, lanes, 24),
                         points(n, rows * lanes))
            ref = K.sum_rows(p)
            err = flat_err(ref, K.sum_rows_plain(p))
            emit({"check": f"K7-G{n} shipped vs plain at {rows} x {lanes}",
                  "max_abs_err": err})
            ok &= err == 0
            ins = K._flat(p)
            row = {"shipped_wrapper": timed(lambda: K.sum_rows(p))}
            tiles = -(-lanes // K.TILE)
            nw = len(ins) * 12
            for grid, w in itertools.product((False, True), K7_WIDTHS[n]):
                outs = [torch.empty((rows, 24), dtype=torch.int64,
                                    device=dev) for _ in ins]
                work = torch.empty(rows * tiles * 128 * nw,
                                   dtype=torch.int32, device=dev)
                # the block form's partials, or the grid form's second
                # stage work buffer
                part = torch.empty(rows * 128 * -(-tiles // 256) * nw
                                   if grid else rows * tiles * nw,
                                   dtype=torch.int32, device=dev)
                tickets = torch.zeros(rows, dtype=torch.int32, device=dev)

                def run():
                    tickets.zero_()
                    K._check(vlib.drand_variant_sum(
                        n - 1, w, int(grid), K._ptrs(ins), K._ptrs(outs),
                        consts.data_ptr(), prog.data_ptr(), int(tab[0]),
                        work.data_ptr(), part.data_ptr(),
                        tickets.data_ptr(), rows, lanes,
                        K._stream(torch.device(dev))), f"K7 w{w}")
                    return K._unflat(outs, n == 2)
                err = flat_err(run(), ref)
                ok &= err == 0
                label = f"{'grid' if grid else 'block'} w{w}"
                row[label] = timed(run)
                row[f"{label} max_abs_err"] = err
            emit({"k7": f"G{n}", "rows": rows, "lanes": lanes, "ms": row})
    for n in (1, 2):
        kind = f"glv_g{n}"
        if "k8" not in what:
            break
        FP.KINDS[f"glv_copied_g{n}"] = glv_copied_kind(FP, n)
        progs = {}
        nbits = K8_BITS[n]
        for form, name in (("slots", kind), ("copied", f"glv_copied_g{n}")):
            tab = FP.program(name)
            progs[form] = (torch.from_numpy(tab).to(dev), int(tab[0]))
            emit({"kind": name, "slots": int(tab[0]), "layout": {
                w: K.group_layout(name, w) for w in K8_WIDTHS[n]},
                "lane_counts_at_width": {
                    w: FP.lane_counts(name, [0] * nbits, w)
                    for w in K8_WIDTHS[n]}})
        curve = DC.G2 if n == 2 else DC.G1
        for lanes in K8_SHAPES[n]:
            x, y, _ = curve.to_affine_batch(points(n, lanes))
            aff = (x, y)
            b0, b1 = torch.randint(0, 2, (2, nbits, lanes), device=dev,
                                   dtype=torch.int32)
            args = (aff, aff, aff, b0, b1)
            ref = K.scalar_mul_glv_mixed(*args)
            err = flat_err(ref, K.scalar_mul_glv_mixed_plain(*args))
            emit({"check": f"K8-G{n} shipped vs plain at {lanes}",
                  "max_abs_err": err})
            ok &= err == 0
            leaves = K._flat(aff) * 3
            bits = torch.stack([b0, b1]).contiguous()
            row = {"shipped_wrapper": timed(
                lambda: K.scalar_mul_glv_mixed(*args))}
            for (form, (prog, nslots)), w in itertools.product(
                    progs.items(), K8_WIDTHS[n]):
                outs = [torch.empty((lanes, 24), dtype=torch.int64,
                                    device=dev) for _ in range(3 * n)]

                def run():
                    K._check(vlib.drand_variant_glv(
                        n - 1, w, int(form == "copied"), K._ptrs(leaves),
                        K._ptrs(outs), consts.data_ptr(), prog.data_ptr(),
                        nslots, bits.data_ptr(), nbits, lanes,
                        K._stream(torch.device(dev))), f"K8 {form} w{w}")
                    return K._unflat(outs, n == 2)
                err = flat_err(run(), ref)
                ok &= err == 0
                label = f"w{w}" if form == "slots" else f"copied w{w}"
                row[label] = timed(run)
                row[f"{label} max_abs_err"] = err
            emit({"k8": f"G{n}", "bits": nbits, "lanes": lanes, "ms": row})
    return ok


if __name__ == "__main__":
    sys.exit(main())
