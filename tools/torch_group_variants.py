"""Time K2's and K6's point programs in the forms and at the widths the
H100 port (drand_tpu_torch) does not ship, beside the ones it ships.

What it measures, on one CUDA card (K2 with k = |x| at the lane counts the
main paths launch it at: 2048 for signing and partials, 8192 and 14,336 in
the verify passes):

  * K2 at every width a lane could run: G1 at 2, 4, 8 and 16 threads a
    lane, G2 at 4, 8, 16 and 32 ("fixed": the shipped fragments);
  * K2 with one fused double-and-add fragment on a one bit ("fused");
  * K2 and K6 with DevCurve.double's textbook form, D = 2((X + B)^2 - A -
    C) ("textbook"), where fp12prog._pt_double computes D = X * 4B; K6 at
    its main-path shapes (256 bits at 2048 lanes; 130 bits at 28,672 on
    G1, 66 bits at 57,344 on G2) through the shipped kernel, whose
    program table is passed with the launch.

Every K2 variant's output is compared limb for limb with
kernels.scalar_mul_fixed_plain at 2048 lanes and with the shipped wrapper
at every lane count; every K6 variant's with the shipped K6 kernel (which
chip_smoke.py holds against its plain version).  Times are CUDA events,
the median of --reps launches after one warm-up.  The extra K2 widths
compile from csrc/ladder.cu into build/variants/<hash>/.

  python3 tools/torch_group_variants.py [--reps 5] [--out FILE]

Prints one JSON object a line; the last is {"ok": true} or {"ok": false}
(exit 1 on a mismatch, and without a CUDA card).
"""

import argparse
import ctypes
import hashlib
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


def build_variants(K):
    """Compile extra_source() (cached by its text and the kernels' hash);
    -> (library, ptxas statistics per entry)."""
    src = extra_source()
    h = hashlib.sha256((src + K.build_hash()).encode()).hexdigest()[:16]
    d = K.BUILD_ROOT.parent / "variants" / h
    lib = d / "libdrand_variants.so"
    if not lib.exists():
        d.mkdir(parents=True, exist_ok=True)
        (d / "variants.cu").write_text(src)
        r = subprocess.run([K._nvcc(), *K.NVCC_FLAGS, "-Xptxas", "-v",
                            "-shared", "-I", str(K.CSRC),
                            str(d / "variants.cu"), "-o", str(lib)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
        (d / "build.log").write_text(r.stdout + r.stderr)
    stats, entry = {}, None
    for ln in (d / "build.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry = m.group(1) if "kv_g" in m.group(1) else None
        elif entry and "stack frame" in ln:
            stats[entry] = dict(zip(("stack", "spill_stores", "spill_loads"),
                                    map(int, re.findall(r"(\d+) bytes", ln))))
        elif entry and "Used" in ln:
            stats[entry]["registers"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    cdll = ctypes.CDLL(str(lib))
    cdll.drand_variant_ladder.argtypes = [i32, vp, vp, vp, vp, i32, i32, vp,
                                          i32, i64, vp]
    cdll.drand_variant_ladder.restype = ctypes.c_int
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
                g, n, lay, acc2, lambda: g.inp(lay["FIN2"])))
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
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()
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
    vlib, ptxas = build_variants(K)
    emit({"ptxas": ptxas})
    variant_programs(FP)

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
    emit({"ok": bool(ok)})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
