#!/usr/bin/env python3
"""Smoke run of drand_tpu_torch on one NVIDIA GPU (run from the repo root).

    python3 chip_smoke.py [--rounds 8192] [--reps 5] [--log-dir DIR]

Builds the Hopper kernels from drand_tpu_torch/ops/csrc, verifies the League
of Entropy mainnet short-signature beacon, then drives the port's main paths
over 8192 rounds of the ``bls-unchained-on-g1`` scheme, each with every
kernel's launch count set to 0 just before and read just after:

  verify_batch_rlc     ``BatchBeaconVerifier.verify_batch`` on all-valid
                       rounds: one RLC pass, no exact pass;
  verify_batch_bisect  the same with five known bad slots: RLC bisection
                       down to 64 rounds, exact passes on the failing ranges;
  exact_pass           the exact per-round pass over the whole batch, split
                       into host packing and device pass.

Then each kernel is held against its plain PyTorch version on the card at
every shape the RLC run and the exact pass gave it (exact: integer
arithmetic) and timed.  Each phase prints one JSON line; the line before the
last is the per-kernel table ({"kernels": [...]}), preceded by the card's
name and power limit; the last is {"ok": true, "device": ...}.  Any failure
exits non-zero before the last line.  Without a CUDA device, or without the
rest of the repository beside it, it exits non-zero and prints no result.

Never imports jax or drand_tpu: only the port.
"""

import argparse
import json
import os
import random
import re
import subprocess
import sys
import time

import numpy as np

ROUNDS = 8192            # the canonical verify batch width of the repository
SEED = 20240101

# League of Entropy mainnet, bls-unchained-on-g1, round 3
LOE_PK = ("876f6fa8073736e22f6ff4badaab35c637503718f7a452d178ce69c45d2d8129"
          "a54ad2f988ab10c9666f87ab603c59bf013409a5b500555da31720f8eec294d9"
          "809b8796f40d5372c71a44ca61226f1eb978310392f98074a608747f77e66c5a")
LOE_SIG = ("ac7c3ca14bc88bd014260f22dc016b4fe586f9313c3a549c83d195811a99a5d2"
           "d4999d4df6daec73ff51fafadd6d5bb5")
LOE_ROUND = 3

# The operations bound.  A 12-word CIOS Montgomery product takes per outer
# round 12 lo + 12 hi halves of a_j*b_i, one m = t0*n0 and 12 lo + 12 hi
# halves of m*p_j: 588 32-bit integer multiply-adds.  A squaring needs only
# the 78 distinct a_i*a_j (doubling is an add): 156 + 12 + 288 = 456.  The
# card issues 64 multiply-adds per SM per clock (compute capability 9.0);
# the rate is SMs x 64 x the maximum SM clock that nvidia-smi reports.  The
# bytes bound reads each input and writes each output once, as 32-bit
# words, at the H100 SXM's 3.35 TB/s.
IMAD_MUL = 12 * (24 + 1 + 24)
IMAD_SQR = 2 * 78 + 12 + 24 * 12
IMAD_PER_SM_CLOCK = 64
HBM_BYTES_PER_S = 3.35e12
WORD_BYTES = 12 * 4      # one Fp element


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi(query):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Multiply-adds per lane.  need_*: what the function needs, each step at the
# cheapest standard formula for its operands (sliding-window powers, a
# ladder that starts at P, Granger-Scott squaring in the cyclotomic
# subgroup, the sparse line product, Frobenius by Fp or Fp2 constants);
# canonical outputs are unique, so any such chain gives the same result.
# code_*: what the kernels' code (csrc/*.cu) does, every product at 588.
# In the tower an Fp2 product is 3 Fp products and an Fp2 squaring 2.
# ---------------------------------------------------------------------------

def _hw(e):
    return bin(e).count("1")


def _sliding_window(e):
    """(products, squarings) of left-to-right sliding-window e-th power at
    its best width: the odd powers up to a^(2^w-1), one squaring per bit
    below the top, one product per window after the first."""
    bits = bin(e)[2:]
    best = None
    for w in range(1, 8):
        i, windows = 0, 0
        while i < len(bits):
            if bits[i] == "0":
                i += 1
                continue
            j = min(i + w, len(bits))
            while bits[j - 1] == "0":
                j -= 1
            windows, i = windows + 1, j
        cost = (2 ** (w - 1) - 1 + windows - 1, len(bits) - 1 + (w > 1))
        if best is None or _imad(*cost) < _imad(*best):
            best = cost
    return best


def _imad(muls, sqrs=0):
    return muls * IMAD_MUL + sqrs * IMAD_SQR


def need_pow(e):
    return _imad(*_sliding_window(e))


def code_pow(e):
    return _imad(e.bit_length() + _hw(e))   # a product per bit, one per 1


def need_ladder(k):
    # dbl-2009-l 2M+5S from P, add-2007-bl 11M+5S (no doubling case here)
    return ((k.bit_length() - 1) * _imad(2, 5)
            + (_hw(k) - 1) * _imad(11, 5))


def code_ladder(k):
    # from infinity; g1_double 7 products, g1_add 23 (its doubling included)
    return _imad(7 * k.bit_length() + 23 * _hw(k))


FP12_MUL, FP12_SQR, CYCLO_SQR, FP6_SQR = 54, 36, 18, 12
DBL_STEP = 4 * 2 + 3 + 3 + 2 * 2 + 2 * 2 + 3 + 3
ADD_STEP = 2 * 3 + 2 * 3 + 2 * 2 + 3 * 3 + 4 * 3
SPARSE_LINE = 2 * 2 + 13 * 3            # ell scaled by P, then mul_by_014


def need_miller(xbits):
    # f starts at 1: its first squaring and first line product are free
    lines = len(xbits) + sum(xbits)
    return _imad((len(xbits) - 1) * FP12_SQR + len(xbits) * DBL_STEP
                 + sum(xbits) * ADD_STEP + lines * SPARSE_LINE
                 - (SPARSE_LINE - 2 * 2))


def code_miller(xbits):
    line = 2 * 2 + FP12_MUL
    return _imad(len(xbits) * (FP12_SQR + DBL_STEP + line)
                 + sum(xbits) * (ADD_STEP + line))


def _finalexp(xbits, fp2_inv, fp6_sqr, sqr_in_g, frob):
    """Multiply-adds of pallas_field._finalexp_math's chain, given the
    cost of its Fp2 inverse, the Fp products of an Fp6 squaring and of an
    Fp12 squaring in the cyclotomic subgroup, and of the Frobenius maps."""
    fp6_inv = _imad(3 * 2 + 3 * 3 + 3 * 3 + 3 * 3) + fp2_inv
    fp12_inv = _imad(2 * fp6_sqr + 2 * 18) + fp6_inv
    pow_x = _imad(len(xbits) * sqr_in_g + sum(xbits) * FP12_MUL)
    return (fp12_inv + 5 * pow_x
            + _imad(FP12_MUL + frob[2] + FP12_MUL       # easy part
                    + 2 * FP12_MUL + (frob[1] + FP12_MUL)
                    + (frob[2] + 2 * FP12_MUL)
                    + (sqr_in_g + FP12_MUL) + FP12_MUL))


def need_finalexp(xbits, inv_exp, frob_consts):
    frob = {j: sum(0 if c == (1, 0) else 2 if c[1] == 0 else 3
                   for c in frob_consts[j]) for j in (1, 2)}
    fp2_inv = _imad(2, 2) + need_pow(inv_exp)   # norm, inverse, 2 products
    return _finalexp(xbits, fp2_inv, FP6_SQR, CYCLO_SQR, frob)


def code_finalexp(xbits, inv_exp):
    return _finalexp(xbits, _imad(4) + code_pow(inv_exp), 18, FP12_SQR,
                     {1: 18, 2: 18})


def need_glv(b0, b1):
    """K8 multiply-adds over all lanes for these bit planes: a ladder that
    starts at the first nonzero step's table entry, then per step one
    dbl-2009-l (2M+5S) and, where b0 | b1, one madd-2007-bl (7M+4S)."""
    nz = (b0 | b1).bool()                          # (nbits, lanes)
    nbits = nz.shape[0]
    steps = nz.sum(0)
    first = nz.int().argmax(0)
    first[steps == 0] = nbits - 1
    dbl = (nbits - 1 - first).sum().item()
    adds = (steps - 1).clamp(min=0).sum().item()
    return dbl * _imad(2, 5) + adds * _imad(7, 4)


def code_glv(b0, b1):
    # from infinity: every step g1_double (7 products), g1_add_mixed (18)
    # where b0 | b1
    nz = (b0 | b1).bool()
    return _imad(7 * nz.numel() + 18 * int(nz.sum()))


def need_sum(z_is_zero, tile):
    """K7 multiply-adds: per tile, one complete add (add-2007-bl, 11M+5S)
    for each finite point after the first; infinite inputs add nothing."""
    finite = (~z_is_zero).reshape(-1, tile).sum(1)
    return int((finite - 1).clamp(min=0).sum()) * _imad(11, 5)


def code_sum(lanes, tile):
    return (lanes // tile) * (tile - 1) * _imad(23)   # g1_add: 23 products


def ptxas_summary(log):
    """Per source file: registers, stack bytes and spill bytes of its entry
    kernel (from nvcc -Xptxas -v)."""
    out, cur, entry = {}, None, False
    for ln in log.splitlines():
        if ln.startswith("== "):
            cur, entry = ln[3:].strip(), False
        elif "Compiling entry function" in ln:
            entry = True
        elif entry and "spill stores" in ln:
            nums = [int(v) for v in re.findall(r"(\d+) bytes", ln)]
            out[cur] = {"stack_bytes": nums[0], "spill_store_bytes": nums[1],
                        "spill_load_bytes": nums[2]}
        elif entry and "Used" in ln and "registers" in ln:
            out[cur]["registers"] = int(re.search(r"Used (\d+) registers",
                                                  ln).group(1))
            entry = False
    return out


# ---------------------------------------------------------------------------


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--reps", type=int, default=5,
                    help="timed runs per kernel shape (median kept)")
    ap.add_argument("--log-dir", default=None,
                    help="write the kernels' ptxas log here")
    args = ap.parse_args()

    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    try:
        from drand_tpu_torch.ops import kernels as K
        from drand_tpu_torch.ops import limbs as L
        from drand_tpu_torch.ops import tower as T
        from drand_tpu_torch.ops import curve as DC
        from drand_tpu_torch.ops import h2c as DH
        from drand_tpu_torch.ops import pairing as DP
        from drand_tpu_torch.crypto import batch as B
        from drand_tpu_torch.crypto import schemes
        from drand_tpu_torch.crypto.host import curve as HC
        from drand_tpu_torch.crypto.host import field as HF
        from drand_tpu_torch.crypto.host import serialize as HS
        from drand_tpu_torch.crypto.host.params import P, R, X
    except ImportError as e:
        fail(f"the drand_tpu_torch package is not beside this script ({e})")
    assert "jax" not in sys.modules and "drand_tpu" not in sys.modules

    dev = torch.device("cuda:0")
    torch.manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    random.seed(SEED)
    n = args.rounds

    # -- phase 1: environment and build -------------------------------------
    name = torch.cuda.get_device_name(0)
    smi_line = smi("name,power.limit")
    max_sm_clock_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t0 = time.perf_counter()
    K._lib()
    build_s = time.perf_counter() - t0
    log = K.BUILD_INFO.get("log", "")
    regs = ptxas_summary(log)
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
        with open(os.path.join(args.log_dir, "kernels_ptxas.log"), "w") as f:
            f.write(log)
    emit({"phase": "env", "device": name, "nvidia_smi": smi_line,
          "torch": torch.__version__, "cuda": torch.version.cuda, "sms": sms,
          "max_sm_clock_mhz": max_sm_clock_mhz, "build_seconds": build_s,
          "build_cached": K.BUILD_INFO.get("cached"), "ptxas": regs})

    def rand_fp(m):
        return L.encode_mont([int.from_bytes(rng.bytes(48), "big") % P
                              for _ in range(m)], dev)

    # -- phase 2: ground truth ----------------------------------------------
    sch = schemes.scheme_from_name(schemes.SHORT_SIG_SCHEME_ID)
    loe = B.BatchBeaconVerifier(sch, bytes.fromhex(LOE_PK))
    sig = bytes.fromhex(LOE_SIG)
    tampered = bytearray(sig)
    tampered[-1] ^= 0x01
    got = loe.verify_batch([LOE_ROUND, LOE_ROUND], [sig, bytes(tampered)])
    emit({"phase": "mainnet_vector", "round": LOE_ROUND,
          "verdicts": got.tolist(), "expected": [True, False]})
    if got.tolist() != [True, False]:
        fail(f"LoE mainnet vector: got {got.tolist()}, want [True, False]")

    # -- phase 3: the main path at full width -------------------------------
    # Signatures with one secret key, made on the card: the port's own
    # hash-to-G1, one K2 launch with k = sk, one to_affine.
    sk = int.from_bytes(rng.bytes(32), "big") % (R - 1) + 1
    pk = HC.G2.mul(HC.G2.gen, sk)
    rounds = list(range(1, n + 1))
    msgs = [sch.digest_beacon(r) for r in rounds]
    t0 = time.perf_counter()
    u0, u1 = B.hash_msgs_to_field_g1(msgs, sch.dst, dev)
    hm = DH.hash_to_g1_jac(u0, u1)
    sx, sy, _ = DC.G1.to_affine(DC.G1.scalar_mul_fixed(hm, sk))
    x_can = L.from_mont(sx).cpu().numpy()
    larger = DH._fp_ge_half1(sy).cpu().numpy()
    raw = np.ascontiguousarray(x_can[:, ::-1]).astype(">u2").view(np.uint8)
    raw = raw.reshape(n, 48).copy()
    raw[:, 0] |= 0x80 | (larger.astype(np.uint8) << 5)
    sigs = [bytes(r) for r in raw]
    torch.cuda.synchronize()
    sign_s = time.perf_counter() - t0
    for i in sorted({0, 1, n // 2, n - 1}):          # host cross-check
        if sigs[i] != sch.sign(sk, msgs[i]):
            fail(f"device signing disagrees with the host at round {i + 1}")
    good_sigs = list(sigs)
    verifier = B.BatchBeaconVerifier(sch, HS.g2_to_bytes(pk))
    pad = B._pad_len(n)

    def drive(fn):
        """Run one main path with the launch and pass counts set to 0 just
        before it and read just after; returns (out, wall s, launches,
        shapes, passes)."""
        torch.cuda.synchronize()
        K.reset_launches()
        before = B.pass_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = B.pass_counts()
        return (out, wall, dict(K.LAUNCHES), dict(K.SHAPES),
                {k: after[k] - before[k] for k in after})

    def key_label(name, key):
        labels = {(P - 3) // 4: "(p-3)/4", P - 2: "p-2", -X: "|x|",
                  1 - X: "1-x"}
        if name == "scalar_mul_glv_mixed":
            return f"{key} bits"
        return labels.get(key, key)

    def shape_list(shapes):
        return [{"kernel": k, "key": key_label(k, key), "lanes": lanes,
                 "launches": c} for (k, key, lanes), c in sorted(
                     shapes.items(), key=lambda kv: (kv[0][0], kv[0][2]))]

    # -- phase 3a: verify_batch, all valid: one RLC pass ---------------------
    got, rlc_wall, rlc_launches, rlc_shapes, passes = drive(
        lambda: verifier.verify_batch(rounds, good_sigs))
    ok = bool(got.all()) and passes == {"rlc": 1, "exact": 0}
    # a second run, split into the host packing and the device pass
    t0 = time.perf_counter()
    rlc_enc, _ = verifier._encode(good_sigs, verifier._messages(rounds), pad)
    torch.cuda.synchronize()
    rlc_pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = verifier._rlc_ok(rlc_enc, n)
    torch.cuda.synchronize()
    rlc_pass_s = time.perf_counter() - t0
    emit({"phase": "verify_batch_rlc", "rounds": n,
          "all_valid": bool(got.all()), "passes": passes, "wall_s": rlc_wall,
          "rounds_per_s": n / rlc_wall,
          "second_run": {"host_pack_s": rlc_pack_s,
                         "device_pass_s": rlc_pass_s,
                         "rounds_per_s": n / (rlc_pack_s + rlc_pass_s)},
          "sign_setup_s": sign_s, "launches": rlc_launches,
          "shapes": shape_list(rlc_shapes), "device": name,
          "nvidia_smi": smi_line})
    if not ok or not again:
        fail(f"all-valid verify_batch: verdicts all true {bool(got.all())}, "
             f"passes {passes} (want one RLC pass), second pass {again}")
    if any(c == 0 for c in rlc_launches.values()):     # all six run here
        fail(f"a kernel of the RLC path was not launched: {rlc_launches}")

    # -- phase 3b: verify_batch with known bad slots: bisection --------------
    expected = np.ones(n, dtype=bool)
    bad = {}
    i = 5 % n
    s = bytearray(sigs[i]); s[20] ^= 0x55; sigs[i] = bytes(s)
    bad["flipped_byte"] = i
    i = 100 % n
    s = bytearray(sigs[i]); s[0] &= 0x7F; sigs[i] = bytes(s)
    bad["no_compression_flag"] = i
    i = 1000 % n
    sigs[i] = sigs[i][:47]
    bad["short_encoding"] = i
    i = 2000 % n
    xq = 1
    while True:
        yq = HF.fp_sqrt((xq ** 3 + 4) % P)
        if yq is not None and not HC.G1.in_subgroup((xq, yq)):
            break
        xq += 1
    sigs[i] = HS.g1_to_bytes((xq, yq))
    bad["on_curve_not_in_g1"] = i
    i = 3000 % n
    sigs[i] = sigs[(i + 1) % n]
    bad["other_rounds_signature"] = i
    for i in bad.values():
        expected[i] = False

    got, bis_wall, bis_launches, bis_shapes, bis_passes = drive(
        lambda: verifier.verify_batch(rounds, sigs))
    ok = bool((got == expected).all())
    emit({"phase": "verify_batch_bisect", "rounds": n, "bad_slots": bad,
          "verdicts_match": ok, "n_valid": int(got.sum()), "wall_s": bis_wall,
          "rounds_per_s": n / bis_wall, "passes": bis_passes,
          "launches": bis_launches, "shapes": shape_list(bis_shapes),
          "device": name, "nvidia_smi": smi_line})
    if not ok:
        wrong = np.nonzero(got != expected)[0][:20].tolist()
        fail(f"verify_batch verdicts differ from the expected ones at {wrong}")

    # -- phase 3c: the exact pass over the whole batch (slice 1's path) ------
    t0 = time.perf_counter()
    enc, wire_bad = verifier._encode(sigs, verifier._messages(rounds), pad)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    again, exact_s, ex_launches, ex_shapes, ex_passes = drive(
        lambda: verifier._exact(enc, n))
    ok = bool(((again & ~wire_bad) == expected).all())
    emit({"phase": "exact_pass", "rounds": n, "verdicts_match": ok,
          "host_pack_s": pack_s, "device_pass_s": exact_s,
          "rounds_per_s": n / (pack_s + exact_s), "launches": ex_launches,
          "shapes": shape_list(ex_shapes), "device": name,
          "nvidia_smi": smi_line})
    if not ok:
        fail("the exact pass disagrees with the expected verdicts")
    if any(ex_launches[k] == 0 for k in ("pow_fixed", "scalar_mul_fixed",
                                         "miller_loop",
                                         "final_exponentiation")):
        fail(f"a kernel of the exact pass was not launched: {ex_launches}")

    # -- phase 4: each kernel against its plain version at the path's shapes
    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    def plain_run(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def err(a, b):
        torch.cuda.synchronize()
        return max(int((x - y).abs().max()) for x, y in zip(a, b))

    imad_rate = sms * IMAD_PER_SM_CLOCK * max_sm_clock_mhz * 1e6

    def bound_ms(imads, lanes, words):
        """(operations ms, bytes ms) of one launch."""
        return (imads * lanes / imad_rate * 1e3,
                words * lanes * WORD_BYTES / HBM_BYTES_PER_S * 1e3)

    xbits = K.XLOOP_BITS
    # (kernel, source, TPU kernel, [(label, exponent/scalar/bits, lanes,
    #  kernel call, plain call, compare, (need, code) multiply-adds per lane,
    #  words per lane)]) at the shapes the paths give each kernel; the
    #  launches of each shape are those counted in the runs above
    x3n, xn, x1 = rand_fp(3 * pad), rand_fp(pad), rand_fp(1)
    pts = [HC.G1.mul(HC.G1.gen, random.randrange(1, R)) for _ in range(32)]
    pts = (pts * (pad // len(pts) + 1))[:pad - 3] + [None, HC.G1.gen,
                                                     (xq, yq)]
    pj = DC.encode_g1_points(pts, dev)
    mx, my = rand_fp(2 * pad), rand_fp(2 * pad)
    mq = ((rand_fp(2 * pad), rand_fp(2 * pad)),
          (rand_fp(2 * pad), rand_fp(2 * pad)))
    m2 = (mx[:2], my[:2], ((mq[0][0][:2], mq[0][1][:2]),
                           (mq[1][0][:2], mq[1][1][:2])))
    fe = T.fp12_pack([rand_fp(pad) for _ in range(12)])
    fe1 = T.fp12_pack([c[:1] for c in T.fp12_leaves(fe)])
    leaves = T.fp12_leaves
    e_sqrt, e_inv = (P - 3) // 4, P - 2
    # K8 at 2N: the tables of [S, H] lanes as g1_glv_msm_terms builds them,
    # bits from the device sampler (the same on the S and H halves)
    both = tuple(torch.cat([c, c.roll(1, 0)]) for c in pj)
    p3j = DC.G1.add(both, DC.g1_phi(both))
    ax, ay, _ = DC.G1.to_affine_batch(tuple(torch.cat([a, b]) for a, b in
                                            zip(both, p3j)))
    tab_pt, tab_p3 = (ax[:2 * pad], ay[:2 * pad]), (ax[2 * pad:], ay[2 * pad:])
    tab_phi = (L.mont_mul(L.mont_const(pow(2, (P - 1) // 3, P), dev),
                          tab_pt[0]), tab_pt[1])
    b0, b1 = B._device_rlc_bits(B._rlc_keys(), torch.arange(pad, device=dev)
                                < n)
    g0, g1 = torch.cat([b0, b0], 1), torch.cat([b1, b1], 1)
    glv_args = (tab_pt, tab_phi, tab_p3, g0, g1)
    # K7 at the lanes its launches had: the batch, then the zero-padded
    # per-tile partials
    def sum_input(lanes):
        real = pad if lanes == pad else -(-pad // K.TILE)
        return K._pad_lanes(tuple(c[:real] for c in pj), lanes)

    sum_lanes = sorted({lanes for (kname, _, lanes) in rlc_shapes
                        if kname == "sum_tiles"})
    sum_inputs = {lanes: sum_input(lanes) for lanes in sum_lanes}
    sum_shapes = [
        (f"{lanes} lanes", None, lanes,
         (lambda p=sum_inputs[lanes]: K.sum_tiles(p)),
         (lambda p=sum_inputs[lanes]: K.sum_tiles_plain(p)), err,
         (need_sum(L.is_zero(sum_inputs[lanes][2]), K.TILE) / lanes,
          code_sum(lanes, K.TILE) / lanes), 3 + 3 / K.TILE)
        for lanes in sum_lanes]
    specs = [
        ("pow_fixed", "pow.cu", 522, [
            ("(p-3)/4 at 3N", e_sqrt, 3 * pad,
             lambda: K.pow_fixed(x3n, e_sqrt),
             lambda: K.pow_fixed_plain(x3n, e_sqrt), lambda a, b: err([a], [b]),
             (need_pow(e_sqrt), code_pow(e_sqrt)), 2),
            ("p-2 at N", e_inv, pad, lambda: K.pow_fixed(xn, e_inv),
             lambda: K.pow_fixed_plain(xn, e_inv), lambda a, b: err([a], [b]),
             (need_pow(e_inv), code_pow(e_inv)), 2),
            ("p-2 at 1 lane", e_inv, 1, lambda: K.pow_fixed(x1, e_inv),
             lambda: K.pow_fixed_plain(x1, e_inv), lambda a, b: err([a], [b]),
             (need_pow(e_inv), code_pow(e_inv)), 2)]),
        ("scalar_mul_fixed", "ladder.cu", 635, [
            ("|x| at N", -X, pad, lambda: K.scalar_mul_fixed(pj, -X),
             lambda: K.scalar_mul_fixed_plain(pj, -X), err,
             (need_ladder(-X), code_ladder(-X)), 6),
            ("1-x at N", 1 - X, pad, lambda: K.scalar_mul_fixed(pj, 1 - X),
             lambda: K.scalar_mul_fixed_plain(pj, 1 - X), err,
             (need_ladder(1 - X), code_ladder(1 - X)), 6)]),
        ("miller_loop", "miller.cu", 1058, [
            ("2N pairs", None, 2 * pad, lambda: K.miller_loop(mx, my, mq),
             lambda: K.miller_loop_plain(mx, my, mq),
             lambda a, b: err(leaves(a), leaves(b)),
             (need_miller(xbits), code_miller(xbits)), 18),
            ("2 pairs", None, 2, lambda: K.miller_loop(*m2),
             lambda: K.miller_loop_plain(*m2),
             lambda a, b: err(leaves(a), leaves(b)),
             (need_miller(xbits), code_miller(xbits)), 18)]),
        ("final_exponentiation", "finalexp.cu", 1093, [
            ("N lanes", None, pad, lambda: K.final_exponentiation(fe),
             lambda: K.final_exponentiation_plain(fe),
             lambda a, b: err(leaves(a), leaves(b)),
             (need_finalexp(xbits, K.INV_EXP, HF.FROB),
              code_finalexp(xbits, K.INV_EXP)), 24),
            ("1 lane", None, 1, lambda: K.final_exponentiation(fe1),
             lambda: K.final_exponentiation_plain(fe1),
             lambda a, b: err(leaves(a), leaves(b)),
             (need_finalexp(xbits, K.INV_EXP, HF.FROB),
              code_finalexp(xbits, K.INV_EXP)), 24)]),
        ("sum_tiles", "sum.cu", 1187, sum_shapes),
        ("scalar_mul_glv_mixed", "glv.cu", 1298, [
            ("64 bits at 2N", 64, 2 * pad,
             lambda: K.scalar_mul_glv_mixed(*glv_args),
             lambda: K.scalar_mul_glv_mixed_plain(*glv_args), err,
             (need_glv(g0, g1) / (2 * pad), code_glv(g0, g1) / (2 * pad)),
             6 + 2 * 64 / 12 + 3)]),
    ]
    timed_shapes = {(kname, key, lanes) for kname, _, _, shapes in specs
                    for _, key, lanes, *_ in shapes}
    ran = {"verify_batch_rlc": (rlc_launches, rlc_shapes),
           "exact_pass": (ex_launches, ex_shapes)}
    untimed = {s: c for _, shapes in ran.values() for s, c in shapes.items()
               if s not in timed_shapes}
    if untimed:
        fail(f"launches at shapes the table does not time: {untimed}")
    table, checks, path_ms = [], {}, {p: 0.0 for p in ran}
    for kname, src, line, shapes in specs:
        ms = pms = ops_ms = bytes_ms = code_ms = 0.0
        max_err, detail = 0, []
        for label, key, lanes, kfn, pfn, cmp, imads, words in shapes:
            counts = {p: sh.get((kname, key, lanes), 0)
                      for p, (_, sh) in ran.items()}
            count = sum(counts.values())
            k_out = kfn()
            p_out, p_ms = plain_run(pfn)
            e = cmp(k_out, p_out)
            checks[f"{kname} {label}"] = e
            max_err = max(max_err, e)
            k_ms = timed(kfn, args.reps)
            o_ms, b_ms = bound_ms(imads[0], lanes, words)
            c_ms = bound_ms(imads[1], lanes, words)[0]
            ms += count * k_ms
            pms += count * p_ms
            ops_ms += count * o_ms
            bytes_ms += count * b_ms
            code_ms += count * c_ms
            for p, c in counts.items():
                path_ms[p] += c * k_ms
            detail.append({"shape": label, "lanes": lanes, "launches": counts,
                           "ms": k_ms, "plain_ms": p_ms,
                           "bound_ms": max(o_ms, b_ms), "code_ops_ms": c_ms,
                           "imads_per_lane": imads[0],
                           "code_imads_per_lane": imads[1]})
        launched = sum(lc[kname] for lc, _ in ran.values())
        if sum(sum(d["launches"].values()) for d in detail) != launched:
            fail(f"{kname}: per-shape launches {detail} do not add up to "
                 f"{launched}")
        table.append({
            "name": kname, "route": "cuda",
            "source": f"drand_tpu_torch/ops/csrc/{src}",
            "replaces": f"drand_tpu/ops/pallas_field.py:{line}",
            "launches": launched, "max_abs_err": max_err,
            "ms": ms, "plain_ms": pms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None, "code_ops_ms": code_ms,
            "times_are": f"sums over the launches of verify_batch_rlc({n}) "
                         f"and exact_pass({n})",
            "per_shape": detail, "ptxas": regs.get(src),
            "device": name, "nvidia_smi": smi_line})
    emit({"phase": "kernels_vs_plain", "tolerance": "exact (integer "
          "arithmetic): max |kernel - plain| over 16-bit limbs",
          "max_abs_err": checks})
    if any(v != 0 for v in checks.values()):
        fail(f"a kernel disagrees with its plain version: {checks}")
    # the RLC device pass stage by stage (each stage timed alone, host
    # clock between synchronizations): where the plain glue goes
    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    stages = {}
    (sj, _, hm), stages["decompress_and_hash"] = wall_ms(
        lambda: DH.g1_decompress_and_hash(*rlc_enc))
    _, stages["subgroup_check"] = wall_ms(lambda: DC.g1_in_subgroup(sj))
    both = tuple(torch.cat([a, b]) for a, b in zip(sj, hm))
    mult, stages["glv_msm_terms"] = wall_ms(
        lambda: DC.g1_glv_msm_terms(both, g0, g1))
    tabs = tuple(torch.cat([a, b]) for a, b in
                 zip(both, DC.G1.add(both, DC.g1_phi(both))))
    _, stages["of_which_to_affine_batch_4N"] = wall_ms(
        lambda: DC.G1.to_affine_batch(tabs))
    _, stages["of_which_batch_inverse_4N"] = wall_ms(
        lambda: DC.G1.batch_inverse(tabs[2]))
    sums, stages["two_sum_points"] = wall_ms(
        lambda: [K.sum_points(tuple(t[i:i + pad] for t in mult))
                 for i in (0, pad)])
    def pairing_check():
        (ax, ay, _), (bx, by, _) = (DC.G1.to_affine(pt) for pt in sums)
        q = tuple(tuple(torch.stack([x, y]) for x, y in zip(u, v))
                  for u, v in zip(verifier.fixed_aff, verifier.pk_aff))
        return DP.paired_product_is_one(torch.stack([ax, bx]),
                                        torch.stack([ay, by]), q, 2)

    ok_pair, stages["to_affine_and_pairing_check"] = wall_ms(pairing_check)
    if not bool(ok_pair):
        fail("the stage-split RLC pass does not verify the all-valid batch")
    emit({"phase": "where_the_time_goes", "rounds": n,
          "rlc_stages_ms": stages,
          "verify_batch_rlc": {
              "host_pack_ms": rlc_pack_s * 1e3,
              "device_pass_ms": rlc_pass_s * 1e3,
              "kernels_ms": path_ms["verify_batch_rlc"],
              "plain_glue_ms": rlc_pass_s * 1e3 - path_ms["verify_batch_rlc"]},
          "exact_pass": {
              "host_pack_ms": pack_s * 1e3, "device_pass_ms": exact_s * 1e3,
              "kernels_ms": path_ms["exact_pass"],
              "plain_glue_ms": exact_s * 1e3 - path_ms["exact_pass"]}})

    print(smi_line, flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
