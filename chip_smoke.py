#!/usr/bin/env python3
"""Smoke run of drand_tpu_torch on one NVIDIA GPU (run from the repo root).

    python3 chip_smoke.py [--rounds 8192] [--reps 5] [--log-dir DIR]

Builds the Hopper kernels from drand_tpu_torch/ops/csrc, verifies the League
of Entropy mainnet beacons of all three schemes, then drives the port's main
paths over 8192 rounds, each with every kernel's launch count set to 0 just
before and read just after.  ``bls-unchained-on-g1`` (signatures on G1):

  verify_batch_rlc     ``BatchBeaconVerifier.verify_batch`` on all-valid
                       rounds: one RLC pass, no exact pass;
  verify_batch_bisect  the same with five known bad slots: RLC bisection
                       down to 64 rounds, exact passes on the failing ranges;
  exact_pass           the exact per-round pass over the whole batch, split
                       into host packing and device pass.

``pedersen-bls-chained`` / ``-unchained`` (signatures on G2, signed on the
card in two batched waves):

  g2_verify_batch_rlc     chained, all valid: one RLC pass, no exact pass;
  g2_unchained_rlc        unchained over the same rounds: one RLC pass;
  g2_verify_batch_bisect  chained with six known bad slots;
  g2_exact_pass           the exact pass over the whole chained batch.

Threshold partials, t = 7 of n = 13 signers over 2048 rounds (the JAX
package's bench config 3), for ``bls-unchained-on-g1`` (``g1_*``) and
``pedersen-bls-chained`` (``g2_*``):

  *_sign               ``sign_batch`` with each of the 7 signers' shares and
                       with the collective secret (8 K6 ladders at 256 bits);
  *_partials_rlc       ``BatchPartialVerifier.verify_partials`` on the
                       2048 x 7 valid partials: one RLC pass, no exact pass;
  *_partials_fallback  the same rows with six kinds of bad slot: the RLC
                       pass fails, the exact pass localizes every bad slot;
  *_recover            ``recover_batch`` over the 2048 x 7 grid: each
                       recovered signature equals the collective-secret one
                       byte for byte and verifies against the group key.

Then each kernel is held against its plain PyTorch version on the card at
every shape the main paths gave it (exact: integer arithmetic) and
timed.  Each phase prints one JSON line; the line before the
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

# the kernels each main path must launch at least once
G1_RLC_KERNELS = ("pow_fixed", "scalar_mul_fixed", "miller_loop",
                  "final_exponentiation", "sum_tiles", "scalar_mul_glv_mixed")
G2_EXACT_KERNELS = ("pow_fixed", "pow_fixed_fp2", "scalar_mul_fixed_g2",
                    "miller_loop", "final_exponentiation")
G2_RLC_KERNELS = G2_EXACT_KERNELS + ("sum_tiles_g2", "scalar_mul_glv_mixed_g2")
# the threshold paths, per signature group
THRESHOLD_KERNELS = {
    "g1": {"sign": ("pow_fixed", "scalar_mul_fixed", "scalar_mul_bits"),
           "partials": G1_RLC_KERNELS,
           "recover": ("pow_fixed", "scalar_mul_bits")},
    "g2": {"sign": ("pow_fixed", "pow_fixed_fp2", "scalar_mul_fixed_g2",
                    "scalar_mul_bits_g2"),
           "partials": G2_RLC_KERNELS,
           "recover": ("pow_fixed", "pow_fixed_fp2", "scalar_mul_bits_g2")}}
THRESHOLD, N_NODES = 7, 13      # bench.py config 3: t = 7 of n = 13
PARTIALS_ROUNDS = 2048          # rounds a chunk in bench.py config 3

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


LOG = []                 # chip_smoke.jsonl under --log-dir: every line


def say(line):
    print(line, flush=True)
    for f in LOG:
        f.write(line + "\n")
        f.flush()


def emit(obj):
    say(json.dumps(obj))


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


# pedersen-bls-chained / -unchained on the League of Entropy mainnet
# (tests/test_host_crypto.py MAINNET_BEACONS): (scheme, round, pk, sig, prev)
G2_VECTORS = [
    ("pedersen-bls-chained", 2634945,
     "868f005eb8e6e4ca0a47c8a77ceaa5309a47978a7c71bc5cce96366b5d7a569937c529"
     "eeda66c7293784a9402801af31",
     "814778ed1e480406beb43b74af71ce2f0373e0ea1bfdfea8f9ed62c876c20fcbc7f016"
     "3860e3da42ed2148756015f4551451898ffe06d384b4d002245025571b6b7a752f7158"
     "b40ad92b13b6d703ad31922a617f2c7f6d960b84d56cf1d79eef",
     "8bd96294383b4d1e04e736360bd7a487f9f409f1e7bd800b720656a310d577b3bdb1e1"
     "631af6c5782a1d8979c502f395036181eff4058960fc40bb7034cdae1991d3eda518ab"
     "204a077d2f7e724974cf87b407e549bd815cf0b8e5a3832f675d"),
    ("pedersen-bls-chained", 3361396,
     "922a2e93828ff83345bae533f5172669a26c02dc76d6bf59c80892e12ab1455c229211"
     "886f35bb56af6d5bea981024df",
     "9904b4ec42e82cb42ad53f171cf0510a5eedff8b5e02e2db5a187489f7875307746998"
     "b9a6cf82130d291126d4b83cea1048c9b3f07a067e632c20391dc059d22d6a8e835f39"
     "80c8bd0183fb6df00a8fbbe6b8c9f61e888dfa76e12af4d4e355",
     "a2377f4e0403f0fd05f709a3292be1b2b59fe990a673ad7b7561b5bd5982b882a2378d"
     "36e39befb6ea3bb7aac113c50a18fb07aa4f9a59f95f1aaa7826dafbfcdbf22347c299"
     "96c294286fd11b402ad83edd83fa21fe6735fccb65785edbed47"),
    ("pedersen-bls-unchained", 7601003,
     "8200fc249deb0148eb918d6e213980c5d01acd7fc251900d9260136da3b54836ce1251"
     "72399ddc69c4e3e11429b62c11",
     "af7eac5897b72401c0f248a26b612c5ef68e0ff830b4d78927988c89b5db3e997bfcdb"
     "7c24cb19f549830cd02cb854a1143fd53a1d4e0713ded471260869439060d170a77187"
     "eb6371742840e43eccfa225657c4cc2d9619f7c3d680470c9743", None),
]

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


def need_sum(z_is_zero, tile, add=None):
    """K7 multiply-adds: per tile, one complete add (add-2007-bl, 11M+5S)
    for each finite point after the first; infinite inputs add nothing."""
    finite = (~z_is_zero).reshape(-1, tile).sum(1)
    return int((finite - 1).clamp(min=0).sum()) * (add or _imad(11, 5))


def code_sum(lanes, tile, add=None):
    return (lanes // tile) * (tile - 1) * (add or _imad(23))  # g1_add: 23


# G2: an Fp2 product is 3 Fp products, an Fp2 squaring 2 (complex
# squaring: two general Fp products), so the G2 counts are in Fp products
# of IMAD_MUL each.
FP2_M, FP2_S = 3, 2
G2_DBL_NEED = 2 * FP2_M + 5 * FP2_S        # dbl-2009-l
G2_ADD_NEED = 11 * FP2_M + 5 * FP2_S       # add-2007-bl
G2_MADD_NEED = 7 * FP2_M + 4 * FP2_S       # madd-2007-bl
# field.cuh: g2_double 2 products + 5 squarings, g2_add 13 + 10, and
# g2_add_mixed 10 + 8
G2_DBL_CODE = 2 * FP2_M + 5 * FP2_S
G2_ADD_CODE = 13 * FP2_M + 10 * FP2_S
G2_MADD_CODE = 10 * FP2_M + 8 * FP2_S


def need_pow2(e):
    muls, sqrs = _sliding_window(e)
    return _imad(FP2_M * muls + FP2_S * sqrs)


def code_pow2(e):
    return _imad(FP2_S * e.bit_length() + FP2_M * _hw(e))


def need_ladder_g2(k):
    return _imad((k.bit_length() - 1) * G2_DBL_NEED
                 + (_hw(k) - 1) * G2_ADD_NEED)


def code_ladder_g2(k):
    return _imad(k.bit_length() * G2_DBL_CODE + _hw(k) * G2_ADD_CODE)


def need_glv_g2(b0, b1):
    """K8-G2 multiply-adds over all lanes, counted as need_glv counts."""
    nz = (b0 | b1).bool()
    nbits = nz.shape[0]
    steps = nz.sum(0)
    first = nz.int().argmax(0)
    first[steps == 0] = nbits - 1
    dbl = (nbits - 1 - first).sum().item()
    adds = (steps - 1).clamp(min=0).sum().item()
    return _imad(dbl * G2_DBL_NEED + adds * G2_MADD_NEED)


def code_glv_g2(b0, b1):
    nz = (b0 | b1).bool()
    return _imad(G2_DBL_CODE * nz.numel() + G2_MADD_CODE * int(nz.sum()))


def need_ladder_var(bits, dbl, add):
    """K6 multiply-adds over all lanes for these bits (nbits, lanes): per
    lane a ladder that starts at P at its first 1 bit, then one doubling a
    step and one add per further 1 bit (dbl, add: the multiply-adds of the
    cheapest formulas)."""
    nz = bits.bool()
    nbits = nz.shape[0]
    ones = nz.sum(0)
    first = nz.int().argmax(0)
    first[ones == 0] = nbits - 1
    dbls = (nbits - 1 - first).sum().item()
    adds = (ones - 1).clamp(min=0).sum().item()
    return dbls * dbl + adds * add


def code_ladder_var(bits, dbl, add):
    # every step a double and a complete add (selected or not)
    return bits.numel() * (dbl + add)


def ptxas_summary(log):
    """Per source file and entry kernel (mangled name): registers, stack
    bytes and spill bytes (from nvcc -Xptxas -v)."""
    out, cur, entry = {}, None, None
    for ln in log.splitlines():
        if ln.startswith("== "):
            cur, entry = ln[3:].strip(), None
        elif "Compiling entry function" in ln:
            entry = re.search(r"entry function '([^']+)'", ln).group(1)
            out.setdefault(cur, {})[entry] = {}
        elif entry and "spill stores" in ln:
            nums = [int(v) for v in re.findall(r"(\d+) bytes", ln)]
            out[cur][entry].update(stack_bytes=nums[0],
                                   spill_store_bytes=nums[1],
                                   spill_load_bytes=nums[2])
        elif entry and "Used" in ln and "registers" in ln:
            out[cur][entry]["registers"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
            entry = None
    return out


def entry_stats(regs, src, *needles):
    """The ptxas statistics of the entry kernel of `src` whose mangled name
    holds every needle."""
    for name, st in regs.get(src, {}).items():
        if all(nd in name for nd in needles):
            return dict(st, entry=name)
    return None


# ---------------------------------------------------------------------------


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--partials-rounds", type=int, default=PARTIALS_ROUNDS)
    ap.add_argument("--reps", type=int, default=5,
                    help="timed runs per kernel shape (median kept)")
    ap.add_argument("--log-dir", default=None,
                    help="write the kernels' ptxas log and every printed "
                         "line (chip_smoke.jsonl) here")
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
        from drand_tpu_torch.crypto import partials as PP
        from drand_tpu_torch.crypto import schemes
        from drand_tpu_torch.crypto.host import tbls as HT
        from drand_tpu_torch.crypto.host import curve as HC
        from drand_tpu_torch.crypto.host import field as HF
        from drand_tpu_torch.crypto.host import serialize as HS
        from drand_tpu_torch.crypto.host.params import P, R, X
        E2 = (P * P - 9) // 16
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
        LOG.append(open(os.path.join(args.log_dir, "chip_smoke.jsonl"), "w"))
    emit({"phase": "env", "device": name, "nvidia_smi": smi_line,
          "torch": torch.__version__, "cuda": torch.version.cuda, "sms": sms,
          "max_sm_clock_mhz": max_sm_clock_mhz, "build_seconds": build_s,
          "build_cached": K.BUILD_INFO.get("cached"), "ptxas": regs})

    def rand_fp(m):
        return L.encode_mont([int.from_bytes(rng.bytes(48), "big") % P
                              for _ in range(m)], dev)

    # -- phase 2: ground truth: the LoE mainnet vectors, each genuine and
    # with its last byte flipped ---------------------------------------------
    sch = schemes.scheme_from_name(schemes.SHORT_SIG_SCHEME_ID)
    vectors = [(schemes.SHORT_SIG_SCHEME_ID, LOE_ROUND, LOE_PK, LOE_SIG,
                None)] + G2_VECTORS
    results = []
    for sid, rnd, vpk, vsig, vprev in vectors:
        sig = bytes.fromhex(vsig)
        tampered = sig[:-1] + bytes([sig[-1] ^ 0x01])
        prev = bytes.fromhex(vprev) if vprev else None
        v = B.BatchBeaconVerifier(schemes.scheme_from_name(sid),
                                  bytes.fromhex(vpk))
        got = v.verify_batch([rnd, rnd], [sig, tampered], [prev, prev])
        results.append({"scheme": sid, "round": rnd,
                        "verdicts": got.tolist()})
    emit({"phase": "mainnet_vectors", "vectors": results,
          "expected": [True, False]})
    for r in results:
        if r["verdicts"] != [True, False]:
            fail(f"LoE mainnet vector {r}: want [True, False]")

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
                  1 - X: "1-x", E2: "(p^2-9)/16"}
        if name.startswith(("scalar_mul_glv_mixed", "scalar_mul_bits")):
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
    if any(rlc_launches[k] == 0 for k in G1_RLC_KERNELS):
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

    # -- phase 3d: the G2-signature schemes at full width ---------------------
    # One secret key (public key on G1).  Signatures are made on the card in
    # two batched waves, the port's hash-to-G2 and one K2-G2 launch with
    # k = sk each: usigs[i] = sk*H(sha256(round_i)), the unchained signature
    # of round i, then sigs[i] = sk*H(sha256(prev_i || round_i)) with
    # prev_i = usigs[i] -- a valid (round, sig, prev) triple of the chained
    # scheme -- and, at slot 0, a 32-byte genesis seed as prev.  Linkage
    # (prev_i is the signature of round i - 1) is checked only on the host,
    # by verify_chain, which the CPU tests cover.
    chained = schemes.scheme_from_name(schemes.DEFAULT_SCHEME_ID)
    unchained = schemes.scheme_from_name(schemes.UNCHAINED_SCHEME_ID)
    sk2 = int.from_bytes(rng.bytes(32), "big") % (R - 1) + 1
    pk2 = HS.g1_to_bytes(HC.G1.mul(HC.G1.gen, sk2))
    genesis = rng.bytes(32)

    def sign_g2(msgs):
        u0, u1 = B.hash_msgs_to_field_g2(msgs, chained.dst, dev)
        hm2 = DH.hash_to_g2_jac(u0, u1)
        sx2, sy2, _ = DC.G2.to_affine(DC.G2.scalar_mul_fixed(hm2, sk2))
        be = lambda t: np.ascontiguousarray(
            L.from_mont(t).cpu().numpy()[:, ::-1]).astype(">u2").view(
                np.uint8).reshape(len(msgs), 48)
        c1_zero = L.is_zero(L.from_mont(sy2[1]))
        larger = torch.where(c1_zero, DH._fp_ge_half1(sy2[0]),
                             DH._fp_ge_half1(sy2[1])).cpu().numpy()
        raw = np.concatenate([be(sx2[1]), be(sx2[0])], axis=1)
        raw[:, 0] |= 0x80 | (larger.astype(np.uint8) << 5)
        return [bytes(r) for r in raw]

    t0 = time.perf_counter()
    usigs = sign_g2([unchained.digest_beacon(r) for r in rounds])
    cprevs = [genesis] + usigs[1:]
    csigs = sign_g2([chained.digest_beacon(r, p)
                     for r, p in zip(rounds, cprevs)])
    torch.cuda.synchronize()
    sign2_s = time.perf_counter() - t0
    for i in sorted({0, 1, n // 2, n - 1}):          # host cross-check
        if (usigs[i] != unchained.sign(sk2, unchained.digest_beacon(
                rounds[i])) or csigs[i] != chained.sign(
                    sk2, chained.digest_beacon(rounds[i], cprevs[i]))):
            fail(f"device G2 signing disagrees with the host at round "
                 f"{rounds[i]}")
    g2v = B.BatchBeaconVerifier(chained, pk2)
    g2u = B.BatchBeaconVerifier(unchained, pk2)

    got, g2_wall, g2_launches, g2_shapes, passes = drive(
        lambda: g2v.verify_batch(rounds, csigs, cprevs))
    ok = bool(got.all()) and passes == {"rlc": 1, "exact": 0}
    t0 = time.perf_counter()
    g2_enc, _ = g2v._encode(csigs, g2v._messages(rounds, cprevs), pad)
    torch.cuda.synchronize()
    g2_pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = g2v._rlc_ok(g2_enc, n)
    torch.cuda.synchronize()
    g2_pass_s = time.perf_counter() - t0
    emit({"phase": "g2_verify_batch_rlc", "scheme": chained.id, "rounds": n,
          "all_valid": bool(got.all()), "passes": passes, "wall_s": g2_wall,
          "rounds_per_s": n / g2_wall,
          "second_run": {"host_pack_s": g2_pack_s,
                         "device_pass_s": g2_pass_s,
                         "rounds_per_s": n / (g2_pack_s + g2_pass_s)},
          "sign_setup_s": sign2_s, "launches": g2_launches,
          "shapes": shape_list(g2_shapes), "device": name,
          "nvidia_smi": smi_line})
    if not ok or not again:
        fail(f"all-valid chained verify_batch: verdicts all true "
             f"{bool(got.all())}, passes {passes} (want one RLC pass), "
             f"second pass {again}")
    if any(g2_launches[k] == 0 for k in G2_RLC_KERNELS):
        fail(f"a kernel of the G2 RLC path was not launched: {g2_launches}")

    got, u_wall, u_launches, _, passes = drive(
        lambda: g2u.verify_batch(rounds, usigs))
    emit({"phase": "g2_unchained_rlc", "scheme": unchained.id, "rounds": n,
          "all_valid": bool(got.all()), "passes": passes, "wall_s": u_wall,
          "rounds_per_s": n / u_wall, "launches": u_launches,
          "device": name, "nvidia_smi": smi_line})
    if not got.all() or passes != {"rlc": 1, "exact": 0}:
        fail(f"all-valid unchained verify_batch: verdicts all true "
             f"{bool(got.all())}, passes {passes} (want one RLC pass)")

    g2_expected = np.ones(n, dtype=bool)
    g2_bad = {}
    bsigs = list(csigs)
    i = 5 % n
    s2 = bytearray(bsigs[i]); s2[20] ^= 0x55; bsigs[i] = bytes(s2)
    g2_bad["flipped_byte"] = i
    i = 100 % n
    s2 = bytearray(bsigs[i]); s2[0] &= 0x7F; bsigs[i] = bytes(s2)
    g2_bad["no_compression_flag"] = i
    i = 1000 % n
    bsigs[i] = bsigs[i][:95]
    g2_bad["short_encoding"] = i
    i = 2000 % n
    a = 1
    while True:
        xq2 = (a, 1)
        yq2 = HF.fp2_sqrt(HF.fp2_add(HF.fp2_mul(HF.fp2_sqr(xq2), xq2),
                                     (4, 4)))
        if yq2 is not None and not HC.G2.in_subgroup((xq2, yq2)):
            break
        a += 1
    bsigs[i] = HS.g2_to_bytes((xq2, yq2))
    g2_bad["on_curve_not_in_g2"] = i
    i = 3000 % n
    bsigs[i] = bsigs[(i + 1) % n]
    g2_bad["other_rounds_signature"] = i
    i = 4000 % n
    bsigs[i] = chained.sign(sk2, chained.digest_beacon(
        rounds[i], usigs[(i + 1) % n]))
    g2_bad["wrong_prev"] = i
    for i in g2_bad.values():
        g2_expected[i] = False
    got, g2b_wall, g2b_launches, g2b_shapes, g2b_passes = drive(
        lambda: g2v.verify_batch(rounds, bsigs, cprevs))
    ok = bool((got == g2_expected).all())
    emit({"phase": "g2_verify_batch_bisect", "scheme": chained.id,
          "rounds": n, "bad_slots": g2_bad, "verdicts_match": ok,
          "n_valid": int(got.sum()), "wall_s": g2b_wall,
          "rounds_per_s": n / g2b_wall, "passes": g2b_passes,
          "launches": g2b_launches, "shapes": shape_list(g2b_shapes),
          "device": name, "nvidia_smi": smi_line})
    if not ok:
        wrong = np.nonzero(got != g2_expected)[0][:20].tolist()
        fail(f"chained verify_batch verdicts differ from the expected ones "
             f"at {wrong}")

    t0 = time.perf_counter()
    g2x_enc, g2x_bad = g2v._encode(bsigs, g2v._messages(rounds, cprevs), pad)
    torch.cuda.synchronize()
    g2x_pack_s = time.perf_counter() - t0
    again, g2x_s, g2x_launches, g2x_shapes, _ = drive(
        lambda: g2v._exact(g2x_enc, n))
    ok = bool(((again & ~g2x_bad) == g2_expected).all())
    emit({"phase": "g2_exact_pass", "scheme": chained.id, "rounds": n,
          "verdicts_match": ok, "host_pack_s": g2x_pack_s,
          "device_pass_s": g2x_s, "rounds_per_s": n / (g2x_pack_s + g2x_s),
          "launches": g2x_launches, "shapes": shape_list(g2x_shapes),
          "device": name, "nvidia_smi": smi_line})
    if not ok:
        fail("the G2 exact pass disagrees with the expected verdicts")
    if any(g2x_launches[k] == 0 for k in G2_EXACT_KERNELS):
        fail(f"a kernel of the G2 exact pass was not launched: "
             f"{g2x_launches}")

    # -- phase 3e: threshold partials, signing and recovery ------------------
    # One random group of t = 7 of n = 13 per scheme (PriPoly from the seed,
    # public shares by PubPoly.eval on the host); the rounds are signed by
    # the same 7 signers, each round's slots in another rotation.  The
    # chained scheme's previous signatures are the collective signatures
    # of the unchained digests, made first (the two waves of phase 3d),
    # with a 32-byte genesis seed at slot 0.
    nrp = args.partials_rounds
    thr = {}

    def threshold_phases(sid, tag):
        sch_t = schemes.scheme_from_name(sid)
        g2 = sch_t.sig_group is schemes.GroupG2
        want_k = THRESHOLD_KERNELS[tag]
        k6 = "scalar_mul_bits_g2" if g2 else "scalar_mul_bits"
        poly = HT.PriPoly([int.from_bytes(rng.bytes(32), "big") % (R - 1) + 1
                           for _ in range(THRESHOLD)])
        shares = poly.shares(N_NODES)
        pp = poly.commit(sch_t.key_group)
        signers = sorted(rng.choice(N_NODES, THRESHOLD,
                                    replace=False).tolist())
        rnds = list(range(1, nrp + 1))
        prevs = None
        if sch_t.chained:
            prevs = [rng.bytes(32)] + B.sign_batch(
                sch_t, poly.secret(),
                [sch_t.digest_beacon(r) for r in rnds[1:]])
        msgs = [sch_t.digest_beacon(r, prevs[i] if prevs else None)
                for i, r in enumerate(rnds)]

        # *_sign: 7 share signatures and the collective one per round
        def sign_all():
            return ([B.sign_batch(sch_t, shares[i].value, msgs)
                     for i in signers],
                    B.sign_batch(sch_t, poly.secret(), msgs))

        (parts, full), wall, launches, shapes, _ = drive(sign_all)
        sample = sorted({int(v) for v in rng.choice(nrp, 16, replace=False)})
        bad_sign = [i for i in sample
                    if full[i] != sch_t.sign(poly.secret(), msgs[i])]
        bad_sign += [(j, i) for j, s in enumerate(signers)
                     for i in (sample[0], sample[-1])
                     if parts[j][i] != sch_t.sign(shares[s].value, msgs[i])]
        emit({"phase": f"{tag}_sign", "scheme": sid, "rounds": nrp,
              "calls": THRESHOLD + 1, "wall_s": wall,
              "signatures_per_s": (THRESHOLD + 1) * nrp / wall,
              "host_checked_rounds": sample, "launches": launches,
              "shapes": shape_list(shapes), "device": name,
              "nvidia_smi": smi_line})
        if bad_sign:
            fail(f"{tag} sign_batch disagrees with the host at {bad_sign}")
        if launches[k6] != THRESHOLD + 1 or any(
                launches[k] == 0 for k in want_k["sign"]):
            fail(f"{tag} signing launches: {launches}")
        paths = {f"{tag}_sign": (launches, shapes)}

        # the (rounds, 7) grid: round r's slots in rotation r % 7
        order = [signers[r % THRESHOLD:] + signers[:r % THRESHOLD]
                 for r in range(nrp)]
        col = {s: j for j, s in enumerate(signers)}
        grid = [[parts[col[s]][r] for s in order[r]] for r in range(nrp)]
        rows = [[s.to_bytes(2, "big") + g for s, g in zip(order[r], grid[r])]
                for r in range(nrp)]
        bv = PP.BatchPartialVerifier(sch_t, pp, N_NODES)

        # *_partials_rlc: all valid, one RLC pass
        got, wall, launches, shapes, passes = drive(
            lambda: bv.verify_partials(msgs, rows))
        ok = bool(got.all()) and got.shape == (nrp, THRESHOLD) \
            and passes == {"rlc": 1, "exact": 0}
        t0 = time.perf_counter()
        enc, idxs, valid = bv._encode(msgs, rows, THRESHOLD)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = bool(bv._rlc(enc, idxs, valid)[1])
        torch.cuda.synchronize()
        pass_s = time.perf_counter() - t0
        emit({"phase": f"{tag}_partials_rlc", "scheme": sid, "rounds": nrp,
              "partials": nrp * THRESHOLD, "all_valid": bool(got.all()),
              "passes": passes, "wall_s": wall, "rounds_per_s": nrp / wall,
              "partials_per_s": nrp * THRESHOLD / wall,
              "second_run": {"host_pack_s": pack_s, "device_pass_s": pass_s,
                             "rounds_per_s": nrp / (pack_s + pass_s)},
              "launches": launches, "shapes": shape_list(shapes),
              "device": name, "nvidia_smi": smi_line})
        if not ok or not again:
            fail(f"{tag} all-valid verify_partials: all true "
                 f"{bool(got.all())}, passes {passes} (want one RLC pass), "
                 f"second pass {again}")
        if any(launches[k] == 0 for k in want_k["partials"]):
            fail(f"{tag}: a kernel of the partials RLC pass was not "
                 f"launched: {launches}")
        paths[f"{tag}_partials_rlc"] = (launches, shapes)
        split_rlc = (pack_s, pass_s, f"{tag}_partials_rlc")

        # *_partials_fallback: the kinds of bad slot of tests/test_partials.py
        brows = [list(r) for r in rows]
        expect = np.ones((nrp, THRESHOLD), dtype=bool)
        kinds = {}

        def put(kind, r, j, val):
            brows[r][j] = val
            expect[r, j] = False
            kinds[kind] = [r, j]

        r = 5 % nrp
        b = bytearray(rows[r][1]); b[12] ^= 0x55
        put("flipped_signature_byte", r, 1, bytes(b))
        r = 100 % nrp
        put("index_out_of_range", r, 2, N_NODES.to_bytes(2, "big")
            + rows[r][2][2:])
        r = 1000 % nrp
        put("truncated", r, 3, rows[r][3][:-1])
        r = 1500 % nrp
        dec = HS.g2_from_bytes if g2 else HS.g1_from_bytes
        for tweak in range(1, 256):
            b = bytearray(rows[r][4])
            b[-1] ^= tweak
            try:
                dec(bytes(b[2:]), check_subgroup=False)
            except ValueError:
                break
        put("x_with_no_y", r, 4, bytes(b))
        r = 1700 % nrp
        put("other_rounds_partial", r, 5, rows[(r + 1) % nrp][
            order[(r + 1) % nrp].index(order[r][5])])
        r = 2000 % nrp
        brows[r] = brows[r][:THRESHOLD - 1]
        expect[r, THRESHOLD - 1] = False
        kinds["missing_slot"] = [r, THRESHOLD - 1]
        got, wall, launches, shapes, passes = drive(
            lambda: bv.verify_partials(msgs, brows))
        ok = got.shape == expect.shape and bool((got == expect).all()) \
            and passes == {"rlc": 1, "exact": 1}
        emit({"phase": f"{tag}_partials_fallback", "scheme": sid,
              "rounds": nrp, "bad_slots": kinds, "mask_matches": ok,
              "n_valid": int(got.sum()), "passes": passes, "wall_s": wall,
              "rounds_per_s": nrp / wall, "launches": launches,
              "shapes": shape_list(shapes), "device": name,
              "nvidia_smi": smi_line})
        if not ok:
            wrong = np.argwhere(got != expect)[:20].tolist() \
                if got.shape == expect.shape else got.shape
            fail(f"{tag} partials fallback mask differs at {wrong}, "
                 f"passes {passes}")
        if any(launches[k] == 0 for k in want_k["partials"]):
            fail(f"{tag}: a kernel of the partials fallback was not "
                 f"launched: {launches}")
        paths[f"{tag}_partials_fallback"] = (launches, shapes)

        # *_recover: the grid's partials -> the collective signature
        rec, wall, launches, shapes, _ = drive(
            lambda: B.recover_batch(sch_t, order, grid))
        same = [i for i in range(nrp) if rec[i] != full[i]]
        key = sch_t.key_group.to_bytes(pp.public_key())
        ver = B.BatchBeaconVerifier(sch_t, key).verify_batch(rnds, rec, prevs)
        emit({"phase": f"{tag}_recover", "scheme": sid, "rounds": nrp,
              "threshold": THRESHOLD, "nodes": N_NODES, "signers": signers,
              "equal_to_collective_signature": not same,
              "verify_batch_all_valid": bool(ver.all()), "wall_s": wall,
              "rounds_per_s": nrp / wall, "launches": launches,
              "shapes": shape_list(shapes), "device": name,
              "nvidia_smi": smi_line})
        if same or not ver.all():
            fail(f"{tag} recover_batch: {len(same)} rounds differ from the "
                 f"collective signature (first {same[:5]}), verify_batch "
                 f"all valid {bool(ver.all())}")
        if any(launches[k] == 0 for k in want_k["recover"]):
            fail(f"{tag}: a kernel of recover_batch was not launched: "
                 f"{launches}")
        paths[f"{tag}_recover"] = (launches, shapes)

        # stage split of recovery (host Lagrange + GLV digits + wire parse,
        # then the device run), each timed apart
        t0 = time.perf_counter()
        lams = [HT._lagrange_coeff(order[r], order[r][j])
                for j in range(THRESHOLD) for r in range(nrp)]
        dbits, dneg = (DC.glv_decompose_g2 if g2 else DC.glv_decompose_g1)(
            lams)
        xw, sgn, _ = B._parse_grid(grid, THRESHOLD, nrp, g2)
        host_s = time.perf_counter() - t0
        nl = dbits.shape[1]
        x = torch.from_numpy(xw).to(dev)
        args_ = ((x[:, 0], x[:, 1]) if g2 else x,
                 torch.from_numpy(sgn).to(dev),
                 torch.from_numpy(dbits.reshape(dbits.shape[0],
                                                nl * THRESHOLD, nrp)).to(dev),
                 torch.from_numpy(dneg.reshape(nl * THRESHOLD, nrp)).to(dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rx, ry, _ = B._recover_run(g2, *args_)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        B._to_wire(g2, rx, ry)
        wire_s = time.perf_counter() - t0
        thr[tag] = {"paths": paths, "partials_split": split_rlc,
                    "recover_stages_ms": {
                        "host_lagrange_glv_parse": host_s * 1e3,
                        "device_run": dev_s * 1e3,
                        "host_compress": wire_s * 1e3}}

    threshold_phases(schemes.SHORT_SIG_SCHEME_ID, "g1")
    threshold_phases(schemes.DEFAULT_SCHEME_ID, "g2")

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

    def err_flat(a, b):
        return err(K._flat(a), K._flat(b))

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
    def sum_input(pts, first, lanes):
        real = first if lanes == first else -(-first // K.TILE)
        return K._pad_lanes(DC._tmap(lambda c: c[:real], pts), lanes)

    def sum_specs(kname, shapes, pts, first, add_need, add_code, words):
        lanes_seen = sorted({lanes for (k, _, lanes) in shapes
                             if k == kname})
        ins = {lanes: sum_input(pts, first, lanes) for lanes in lanes_seen}
        return [(f"{lanes} lanes", None, lanes,
                 (lambda p=ins[lanes]: K.sum_tiles(p)),
                 (lambda p=ins[lanes]: K.sum_tiles_plain(p)), err_flat,
                 (need_sum(K._curve(ins[lanes]).is_infinity(ins[lanes]),
                           K.TILE, add_need) / lanes,
                  code_sum(lanes, K.TILE, add_code) / lanes),
                 words + words / K.TILE)
                for lanes in lanes_seen]

    sum_shapes = sum_specs("sum_tiles", rlc_shapes, pj, pad, None, None, 3)
    # the G2 instances: random G2 points (members, infinity, the generator
    # and a point outside G2) at the path's widths
    x3n2 = (rand_fp(3 * pad), rand_fp(3 * pad))
    pts2 = [HC.G2.mul(HC.G2.gen, random.randrange(1, R)) for _ in range(16)]
    pts2 = (pts2 * (pad // len(pts2) + 1))[:pad - 3] + [None, HC.G2.gen,
                                                       (xq2, yq2)]
    pj2 = DC.encode_g2_points(pts2, dev)
    pj2r = DC._tmap(lambda c: c.roll(1, 0), pj2)
    sum2_shapes = sum_specs("sum_tiles_g2", g2_shapes,
                            DC._cat_lanes(pj2, pj2r), 2 * pad,
                            _imad(G2_ADD_NEED), _imad(G2_ADD_CODE), 6)
    # K8-G2 at 4N: the tables of [S, psi S, H, psi H] lanes as
    # g2_glv_msm_terms builds them, bits from the device sampler split
    # four ways (the same quarters on the S and H halves)
    base2 = DC._cat_lanes(pj2, DC.g2_psi(pj2), pj2r, DC.g2_psi(pj2r))
    p3j2 = DC.G2.add(base2, DC.g2_psi2(base2))
    ax2, ay2, _ = DC.G2.to_affine_batch(DC._cat_lanes(base2, p3j2))
    lo = lambda c: DC._tmap(lambda t: t[:4 * pad], c)
    hi = lambda c: DC._tmap(lambda t: t[4 * pad:], c)
    tab2_pt, tab2_p3 = (lo(ax2), lo(ay2)), (hi(ax2), hi(ay2))
    tab2_psi2 = DC._psi2_affine_scale(*tab2_pt)
    q0, q1, q2, q3 = B._device_rlc_bits(
        B._rlc_keys(), torch.arange(pad, device=dev) < n, split=4)
    h0, h1 = torch.cat([q0, q1, q0, q1], 1), torch.cat([q2, q3, q2, q3], 1)
    glv2_args = (tab2_pt, tab2_psi2, tab2_p3, h0, h1)
    # (name, source, pallas_call line, TPU kernel and instance, entry
    #  kernel name parts, shapes)
    specs = [
        ("pow_fixed", "pow.cu", 522, "K1", ("k_pow",), [
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
        ("scalar_mul_fixed", "ladder.cu", 635, "K2 G1", ("k_ladder", "G1J"), [
            ("|x| at N", -X, pad, lambda: K.scalar_mul_fixed(pj, -X),
             lambda: K.scalar_mul_fixed_plain(pj, -X), err,
             (need_ladder(-X), code_ladder(-X)), 6),
            ("1-x at N", 1 - X, pad, lambda: K.scalar_mul_fixed(pj, 1 - X),
             lambda: K.scalar_mul_fixed_plain(pj, 1 - X), err,
             (need_ladder(1 - X), code_ladder(1 - X)), 6)]),
        ("miller_loop", "miller.cu", 1058, "K3", ("k_miller",), [
            ("2N pairs", None, 2 * pad, lambda: K.miller_loop(mx, my, mq),
             lambda: K.miller_loop_plain(mx, my, mq),
             lambda a, b: err(leaves(a), leaves(b)),
             (need_miller(xbits), code_miller(xbits)), 18),
            ("2 pairs", None, 2, lambda: K.miller_loop(*m2),
             lambda: K.miller_loop_plain(*m2),
             lambda a, b: err(leaves(a), leaves(b)),
             (need_miller(xbits), code_miller(xbits)), 18)]),
        ("final_exponentiation", "finalexp.cu", 1093, "K4", ("k_finalexp",), [
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
        ("sum_tiles", "sum.cu", 1187, "K7 G1", ("k_sum_g1",), sum_shapes),
        ("scalar_mul_glv_mixed", "glv.cu", 1298, "K8 G1", ("k_glv_g1",), [
            ("64 bits at 2N", 64, 2 * pad,
             lambda: K.scalar_mul_glv_mixed(*glv_args),
             lambda: K.scalar_mul_glv_mixed_plain(*glv_args), err,
             (need_glv(g0, g1) / (2 * pad), code_glv(g0, g1) / (2 * pad)),
             6 + 2 * 64 / 12 + 3)]),
        ("pow_fixed_fp2", "pow2.cu", 562, "K5", ("k_pow2",), [
            ("(p^2-9)/16 at 3N", E2, 3 * pad,
             lambda: K.pow_fixed_fp2(x3n2, E2),
             lambda: K.pow_fixed_fp2_plain(x3n2, E2), err_flat,
             (need_pow2(E2), code_pow2(E2)), 4)]),
        ("scalar_mul_fixed_g2", "ladder.cu", 635, "K2 G2",
         ("k_ladder", "G2J"), [
            ("|x| at N", -X, pad, lambda: K.scalar_mul_fixed(pj2, -X),
             lambda: K.scalar_mul_fixed_plain(pj2, -X), err_flat,
             (need_ladder_g2(-X), code_ladder_g2(-X)), 12)]),
        ("sum_tiles_g2", "sum.cu", 1187, "K7 G2", ("k_sum_g2",), sum2_shapes),
        ("scalar_mul_glv_mixed_g2", "glv.cu", 1298, "K8 G2", ("k_glv_g2",), [
            ("32 bits at 4N", 32, 4 * pad,
             lambda: K.scalar_mul_glv_mixed(*glv2_args),
             lambda: K.scalar_mul_glv_mixed_plain(*glv2_args), err_flat,
             (need_glv_g2(h0, h1) / (4 * pad),
              code_glv_g2(h0, h1) / (4 * pad)), 12 + 2 * 32 / 12 + 6)]),
        ("scalar_mul_bits", "ladder_var.cu", 595, "K6 G1",
         ("k_ladder_var", "G1J"), []),
        ("scalar_mul_bits_g2", "ladder_var.cu", 595, "K6 G2",
         ("k_ladder_var", "G2J"), []),
    ]
    ran = {"verify_batch_rlc": (rlc_launches, rlc_shapes),
           "exact_pass": (ex_launches, ex_shapes),
           "g2_verify_batch_rlc": (g2_launches, g2_shapes),
           "g2_exact_pass": (g2x_launches, g2x_shapes)}
    for tag in ("g1", "g2"):
        ran.update(thr[tag]["paths"])

    # Every other shape a path launched (the threshold paths' widths, and
    # all of K6) gets inputs made here: random field elements, the points
    # above spread over the lanes with infinity, the generator and a point
    # outside the group in lanes 0-2, random bit planes; K6 as its callers
    # build them (see k6_inputs).
    def rand_fp_dev(m):
        """m random Montgomery Fp elements made on the card: 16-bit limbs,
        the top one below p's, so every value is below p."""
        x = torch.randint(0, 1 << 16, (m, L.NLIMB), device=dev)
        x[:, -1] %= P >> (16 * (L.NLIMB - 1))
        return x

    def spread(pt, lanes):
        n0 = DC._leaf(pt[0]).shape[0]
        idx = torch.arange(lanes, device=dev) % n0
        return DC._tmap(lambda c: c[idx], pt)

    special = {False: DC._tmap(lambda c: c.roll(3, 0), pj),
               True: DC._tmap(lambda c: c.roll(3, 0), pj2)}

    def k6_inputs(g2, nbits, lanes):
        """K6's inputs as its callers build them.  256 bits (signing):
        one random 256-bit scalar a lane, lanes 3-5 members with the
        scalars r and r + 2 (the last step's add meets P == -Q and P == Q)
        and 0.  130 / 66 bits (recovery): random scalars' signed GLV
        digits, the points' phi / psi lanes negated where a digit is
        negative, one scalar 0.  Every warp mixes 0 and 1 bits, and
        infinite and finite points."""
        curve = DC.G2 if g2 else DC.G1
        if nbits == 256:
            ks = [random.getrandbits(256) for _ in range(lanes)]
            ks[3:6] = [R, R + 2, 0]
            return (spread(special[g2], lanes),
                    torch.from_numpy(DC.msb_bits(ks, 256)).to(dev))
        nl = DC.GLV_G2_LANES if g2 else DC.GLV_G1_LANES
        per = lanes // nl
        ks = [random.randrange(R) for _ in range(per)]
        ks[5] = 0
        bits, neg = (DC.glv_decompose_g2 if g2 else DC.glv_decompose_g1)(ks)
        if bits.shape[0] != nbits or per * nl != lanes:
            fail(f"K6 at {nbits} bits over {lanes} lanes: no GLV recipe")
        pts = (DC.g2_psi_lanes if g2 else DC.g1_phi_lanes)(
            spread(special[g2], per))
        negm = torch.from_numpy(neg.reshape(-1)).to(dev) == 1
        return (curve.select(negm, curve.neg(pts), pts),
                torch.from_numpy(bits.reshape(nbits, lanes)).to(dev))

    def generic_shape(kname, key, lanes):
        """(label, key, lanes, kernel call, plain call, compare, (need,
        code) multiply-adds per lane, words per lane) at a recorded shape."""
        g2k = kname.endswith("_g2")
        label = f"{key_label(kname, key)} at {lanes}" if key is not None \
            else f"{lanes} lanes"
        if kname == "pow_fixed":
            x = rand_fp_dev(lanes)
            return (label, key, lanes, lambda: K.pow_fixed(x, key),
                    lambda: K.pow_fixed_plain(x, key),
                    lambda a, b: err([a], [b]),
                    (need_pow(key), code_pow(key)), 2)
        if kname == "pow_fixed_fp2":
            x = (rand_fp_dev(lanes), rand_fp_dev(lanes))
            return (label, key, lanes, lambda: K.pow_fixed_fp2(x, key),
                    lambda: K.pow_fixed_fp2_plain(x, key), err_flat,
                    (need_pow2(key), code_pow2(key)), 4)
        if kname.startswith("scalar_mul_fixed"):
            pts = spread(special[g2k], lanes)
            im = ((need_ladder_g2(key), code_ladder_g2(key)) if g2k
                  else (need_ladder(key), code_ladder(key)))
            return (label, key, lanes, lambda: K.scalar_mul_fixed(pts, key),
                    lambda: K.scalar_mul_fixed_plain(pts, key), err_flat,
                    im, 12 if g2k else 6)
        if kname == "miller_loop":
            px, py = rand_fp_dev(lanes), rand_fp_dev(lanes)
            q = ((rand_fp_dev(lanes), rand_fp_dev(lanes)),
                 (rand_fp_dev(lanes), rand_fp_dev(lanes)))
            return (f"{lanes} pairs", key, lanes,
                    lambda: K.miller_loop(px, py, q),
                    lambda: K.miller_loop_plain(px, py, q),
                    lambda a, b: err(leaves(a), leaves(b)),
                    (need_miller(xbits), code_miller(xbits)), 18)
        if kname == "final_exponentiation":
            f = T.fp12_pack([rand_fp_dev(lanes) for _ in range(12)])
            return (label, key, lanes, lambda: K.final_exponentiation(f),
                    lambda: K.final_exponentiation_plain(f),
                    lambda a, b: err(leaves(a), leaves(b)),
                    (need_finalexp(xbits, K.INV_EXP, HF.FROB),
                     code_finalexp(xbits, K.INV_EXP)), 24)
        if kname.startswith("sum_tiles"):
            pts = spread(special[g2k], lanes)
            add_need = _imad(G2_ADD_NEED) if g2k else None
            add_code = _imad(G2_ADD_CODE) if g2k else None
            words = 6 if g2k else 3
            return (label, key, lanes, lambda: K.sum_tiles(pts),
                    lambda: K.sum_tiles_plain(pts), err_flat,
                    (need_sum(K._curve(pts).is_infinity(pts), K.TILE,
                              add_need) / lanes,
                     code_sum(lanes, K.TILE, add_code) / lanes),
                    words + words / K.TILE)
        if kname.startswith("scalar_mul_glv_mixed"):
            tabs = [spread(t, lanes) for t in
                    (glv2_args[:3] if g2k else glv_args[:3])]
            b0, b1 = torch.randint(0, 2, (2, key, lanes), device=dev,
                                   dtype=torch.int32)
            a = (*tabs, b0, b1)
            im = ((need_glv_g2(b0, b1), code_glv_g2(b0, b1)) if g2k
                  else (need_glv(b0, b1), code_glv(b0, b1)))
            return (label, key, lanes, lambda: K.scalar_mul_glv_mixed(*a),
                    lambda: K.scalar_mul_glv_mixed_plain(*a), err_flat,
                    (im[0] / lanes, im[1] / lanes),
                    (12 + 2 * key / 12 + 6) if g2k else
                    (6 + 2 * key / 12 + 3))
        if kname.startswith("scalar_mul_bits"):
            pts, bits = k6_inputs(g2k, key, lanes)
            if g2k:
                dbl, add = _imad(G2_DBL_NEED), _imad(G2_ADD_NEED)
                cdbl, cadd = _imad(G2_DBL_CODE), _imad(G2_ADD_CODE)
            else:
                dbl, add, cdbl, cadd = _imad(2, 5), _imad(11, 5), \
                    _imad(7), _imad(23)
            return (f"{key} bits at {lanes}", key, lanes,
                    lambda: K.scalar_mul_bits(pts, bits),
                    lambda: K.scalar_mul_bits_plain(pts, bits), err_flat,
                    (need_ladder_var(bits, dbl, add) / lanes,
                     code_ladder_var(bits, cdbl, cadd) / lanes),
                    (12 if g2k else 6) + key / 12)
        fail(f"no inputs for {kname} at {key}, {lanes} lanes")

    timed_shapes = {(kname, key, lanes) for kname, *_, shapes in specs
                    for _, key, lanes, *_ in shapes}
    recorded = sorted({sh for _, shapes in ran.values() for sh in shapes},
                      key=lambda sh: (sh[0], sh[2], str(sh[1])))
    by_name = {sp[0]: sp[5] for sp in specs}
    for kname, key, lanes in recorded:
        if (kname, key, lanes) not in timed_shapes:
            if kname not in by_name:
                fail(f"a launch of {kname}, a kernel the table does not hold")
            by_name[kname].append(generic_shape(kname, key, lanes))
    table, checks, path_ms = [], {}, {p: 0.0 for p in ran}
    for kname, src, line, tpu, needles, shapes in specs:
        ms = pms = ops_ms = bytes_ms = code_ms = 0.0
        max_err, detail = 0, []
        for label, key, lanes, kfn, pfn, cmp, imads, words in shapes:
            counts = {p: sh.get((kname, key, lanes), 0)
                      for p, (_, sh) in ran.items()}
            count = sum(counts.values())
            print(f"chip_smoke: {kname} {label}", file=sys.stderr, flush=True)
            try:
                k_out = kfn()
                torch.cuda.synchronize()
            except RuntimeError as e:
                fail(f"{kname} at {label}: {e}")
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
            "name": kname, "tpu_kernel": tpu, "route": "cuda",
            "source": f"drand_tpu_torch/ops/csrc/{src}",
            "replaces": f"drand_tpu/ops/pallas_field.py:{line}",
            "launches": launched, "max_abs_err": max_err,
            "ms": ms, "plain_ms": pms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None, "code_ops_ms": code_ms,
            "times_are": f"sums over the launches of the main paths: the "
                         f"RLC runs and exact passes at {n} rounds of both "
                         f"signature groups, the threshold phases at {nrp} "
                         f"rounds x {THRESHOLD} partials",
            "per_shape": detail, "ptxas": entry_stats(regs, src, *needles),
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

    # the G2 RLC pass stage by stage
    st2 = {}
    sx0, sgn, gu0, gu1 = g2_enc
    (sj2, _, hm2), st2["decompress_and_hash"] = wall_ms(
        lambda: DH.g2_decompress_and_hash(sx0[0], sx0[1], sgn, gu0, gu1))
    _, st2["subgroup_check"] = wall_ms(lambda: DC.g2_in_subgroup(sj2))
    b4 = DC._cat_lanes(sj2, DC.g2_psi(sj2), hm2, DC.g2_psi(hm2))
    mult2, st2["glv_msm_terms"] = wall_ms(
        lambda: DC.g2_glv_msm_terms(b4, h0, h1))
    tabs2 = DC._cat_lanes(b4, DC.G2.add(b4, DC.g2_psi2(b4)))
    _, st2["of_which_to_affine_batch_8N"] = wall_ms(
        lambda: DC.G2.to_affine_batch(tabs2))
    _, st2["of_which_batch_inverse_8N"] = wall_ms(
        lambda: DC.G2.batch_inverse(tabs2[2]))
    sums2, st2["two_sum_points"] = wall_ms(
        lambda: [K.sum_points(DC._tmap(lambda t: t[i:i + 2 * pad], mult2))
                 for i in (0, 2 * pad)])

    def pairing_check2():
        (ax, ay, _), (bx, by, _) = (DC.G2.to_affine(pt) for pt in sums2)
        px = torch.stack([g2v.fixed_aff[0], g2v.pk_aff[0]])
        py = torch.stack([g2v.fixed_aff[1], g2v.pk_aff[1]])
        return DP.paired_product_is_one(px, py, B._pair_g2((ax, ay),
                                                           (bx, by)), 2)

    ok_pair, st2["to_affine_and_pairing_check"] = wall_ms(pairing_check2)
    if not bool(ok_pair):
        fail("the stage-split G2 RLC pass does not verify the all-valid "
             "batch")

    def split(pack_s_, pass_s_, run):
        return {"host_pack_ms": pack_s_ * 1e3,
                "device_pass_ms": pass_s_ * 1e3,
                "kernels_ms": path_ms[run],
                "plain_glue_ms": pass_s_ * 1e3 - path_ms[run]}

    emit({"phase": "where_the_time_goes", "rounds": n,
          "rlc_stages_ms": stages, "g2_rlc_stages_ms": st2,
          "verify_batch_rlc": split(rlc_pack_s, rlc_pass_s,
                                    "verify_batch_rlc"),
          "exact_pass": split(pack_s, exact_s, "exact_pass"),
          "g2_verify_batch_rlc": split(g2_pack_s, g2_pass_s,
                                       "g2_verify_batch_rlc"),
          "g2_exact_pass": split(g2x_pack_s, g2x_s, "g2_exact_pass"),
          "threshold": {tag: {
              "partials_rlc": split(*thr[tag]["partials_split"]),
              "recover_stages_ms": thr[tag]["recover_stages_ms"],
              "path_kernels_ms": {p: path_ms[p] for p in thr[tag]["paths"]}}
              for tag in ("g1", "g2")}})

    say(smi_line)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
