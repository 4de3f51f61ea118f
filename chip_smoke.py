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

Threshold partials, t = 7 of n = 13 signers (the JAX package's bench config
3) over 512 rounds (config 3 runs 2048; cut to fit the beacon phases), for
``bls-unchained-on-g1`` (``g1_*``) and ``pedersen-bls-chained`` (``g2_*``):

  *_sign               ``sign_batch`` with each of the 7 signers' shares and
                       with the collective secret (8 K6 ladders at 256 bits);
  *_partials_rlc       ``BatchPartialVerifier.verify_partials`` on the
                       512 x 7 valid partials: one RLC pass, no exact pass;
  *_partials_fallback  the same rows with six kinds of bad slot: the RLC
                       pass fails, the exact pass localizes every bad slot;
  *_recover            ``recover_batch`` over the 512 x 7 grid: each
                       recovered signature equals the collective-secret one
                       byte for byte and verifies against the group key.

The verify service (``drand_tpu_torch/crypto/verify_service.py``), its pool
enumerating the card (one group), serving the first 2048 of the rounds above
(a quarter of the batch, cut to keep the script inside its limit) through
its entry points (``VerifyService.handle``, then ``submit`` /
``verify_batch``):

  verify_service       16 caller threads each submit a 128-round slice of
                       the G1 chain, then of the chained G2 chain, four
                       bad slots included, in the background lane: one
                       2048-lane dispatch a chain (fill 1.0), every
                       future's verdicts equal to that slice of the direct
                       ``verify_batch`` mask, every kernel of the chain's
                       RLC list launched; a catch-up of 4096 G1 rounds
                       (two 2048 dispatches) while 8 one-round live
                       submissions arrive (their latencies, the
                       preemptions); no failover, watchdog trip or host
                       fallback in either; then a failover drill on a
                       4-round handle whose backend raises twice: the walk
                       healthy -> suspect -> degraded -> probing -> healthy,
                       the host fallback's verdicts, the device again.

Above 64 rounds every verify path takes the device message front: the host
packs message words with numpy, and H1 (csrc/h2f.cu) hashes them to the
field at the start of the device pass (``bls-unchained-on-g1`` and
``pedersen-bls-unchained`` the raw unchained front, ``pedersen-bls-chained``
the raw chained one, slot 0 without a previous signature; the partials the
DIGEST front); ``verify_batch_rlc`` also runs the FIELDS front (the host
hash_to_field) on the same inputs, whose verdicts must be equal.

  h2f_front            H1 at every shape the paths launched it (and the
                       DIGEST front of a chained chunk with a 32-byte
                       genesis seed) against its plain version and the
                       host oracle (hashlib + the host hash_to_field), with
                       its SHA-256 and xmd entries.

The device DKG (``drand_tpu_torch/crypto/dkg_device.py`` and the state
machine ``crypto/dkg.py``), at bench config 8's committee scale, 1024
dealers of 32 coefficients, on G2 keys (``bls-unchained-on-g1``,
``dkg_g2keys_committee``) and G1 keys (``pedersen-bls-chained``,
``dkg_g1keys_committee``), from a host fixture:

  verify_shares + pin  one holder's check of all dealers (20 wrong-index
                       shares, 20 tampered coefficients) and the reshare
                       constant-term pin (10 wrong constant terms), at
                       most 4 dispatches, every verdict as constructed;
  prime, combine       ``prime_public_shares`` at 1024, the weighted
                       combine over 32 dealers and the plain one over all;
  partials             ``BatchPartialVerifier`` at 1024 signers of an
                       8-coefficient polynomial (primed in one dispatch),
                       one round's 1024 partials with one forged;

each against a host oracle on 64 dealers (host Horner, PubPoly.eval,
host combines);

  dkg_ceremony         an 8-node DKG at t = 5 through ``DistKeyGenerator``
                       with every seam on the card: a transit-corrupted
                       deal justified, a bundle changed after signing
                       excluded, one key; then a reshare whose key-change
                       attempt the pin rejects, the key kept byte for byte.

The beacon layer (``drand_tpu_torch/beacon/``, ``chain/``,
``net/resilience.py``): 13 nodes of a t = 7 group in this process, each
wired as a daemon (its own VerifyService on the card at pad 512, partials
checked through ``partials_factory(device_verifier_factory)`` with no host
fallback, a SyncChainServer, a SyncManager over the service's handle
streaming from a peer's server, a FakeClock):

  beacon_quicknet      ``bls-unchained-on-g1``: 12 nodes hold a 512-round
                       chain signed by one ``sign_batch``; node 13 catches
                       up from genesis into sqlite (a chunk of 512 on its
                       service's BACKGROUND lane) while the network makes
                       2 live rounds, the last with a forged partial that
                       every node's exact pass drops;
  beacon_default       ``pedersen-bls-chained``: 3 rounds from genesis, the
                       sqlite node down for round 2 and caught up through
                       sync before round 3 (which carries a forged
                       partial), then round 1 bit-flipped and round 2
                       deleted in its store: a full scan on the card finds
                       both, heal restores the peers' bytes, a second scan
                       is clean;

every node's chain byte-equal and verified (on the card and
``verify_beacon``), no failover, watchdog trip or host-served check, the
round walls, the catch-up and scan + heal walls, and one aggregation split
into the card's check and the host's recovery and ``verify_beacon``.

The public edge (``drand_tpu_torch/http_server.py``, ``client/``,
``relay.py``): a 1024-round ``pedersen-bls-chained`` chain (the League of
Entropy default chain's 30 s period: a client 8.5 h behind), signed one
round a call by the host or a 1-lane ``sign_batch`` (the faster on 4
rounds; the host signs it in a process of its own while the beacon phases
run), in a sqlite store behind the port's ``RestServer`` and an
``AdmissionController``; strict clients (``new_client(From(HttpTransport
(url)), with_chain_hash(...), with_full_chain_verification())``) walk it
from genesis, checking the linkage on the host and the whole span in ONE
submission to the process-default ``VerifyService`` on the card:

  edge_walk            one client's ``get(1024)``: 1024 HTTP gets, one RLC
                       pass, every verdict true, no host-served check;
  edge_four_walks      four clients at once (their dispatches coalesce);
  edge_forged          a copy of the chain with round 700's signature and
                       round 701's previous signature the same forged
                       bytes: the linkage holds, the sweep's bisection and
                       exact pass name exactly rounds 700 and 701;

then ``/health`` carries the service's summary, an ``HttpRelay`` over a
client of the edge serves ``/public/{r}`` and ``/public/latest`` with the
store's bytes, and an ``ObjectStoreRelay`` over a ``DirObjectStore``
uploads 16 rounds that read back equal.

The gRPC daemon (``drand_tpu_torch/core/``, ``net/``, ``cli.py``): four
daemons, each a process of its own started by ``python -m
drand_tpu_torch.cli start`` (its folder, the default sqlite store, its
ports reported through ``--ready-file``, its own VerifyService on the
card, the kernels loaded from the build above), keys made by ``cli
generate-keypair``:

  daemon_quicknet      ``bls-unchained-on-g1`` (the League of Entropy
                       quicknet, 3 s, t = 3 of n = 4): the DKG over the
                       Control plane (a leader, three joiners; one group
                       hash and one collective key on all four); 5 live
                       rounds, each read over gRPC ``PublicRand`` from
                       every daemon, byte-equal, and verified here on the
                       card against the collective key; one daemon shut
                       down over Control for 2 rounds, restarted from its
                       folder by the same CLI, caught up over
                       ``SyncChain`` (BACKGROUND-lane dispatches in its
                       metrics) until it stores a round by its own
                       partials check; a strict client
                       (``VerifyingClient`` over ``GrpcTransport``)
                       getting every round from 1, and its ``watch()``
                       yielding the next round: on this unchained chain
                       the strict client has no linkage to walk and no
                       card sweep, so it checks each get on the host, as
                       client/verify.py routes it; every daemon's metrics,
                       the group registry over ``ProtocolClient.metrics``
                       and the verify service's series from its own
                       ``MetricsServer`` (partial checks on the device,
                       none on the host, no check error, failover,
                       watchdog trip or host-served work); and the
                       daemons' ``(1, 4)`` partials check of
                       a stored round redone here from the shares in their
                       key folders, its recovered signature equal to the
                       stored one.  Every daemon exits 0 after its
                       shutdown over Control.

Then each kernel is held against its plain PyTorch version on the card at
every shape the main paths gave it (exact: integer arithmetic) and
timed; K3 and K4 (a warp a pairing lane) also at tail widths with a zero
and a one lane, K6 (a thread group a ladder lane) at 16 bits over 5 lanes
on both curves, K2 (a thread group a lane) and K7 (a batch of sums, a
thread group an add) at each width they compile, K7 also on three rows
of 1000 lanes with an all-infinity row, K1 (both entries: the window
chain and, for p - 2, the
inversion) and K5 also on edge values (0, 1, p - 1, R mod p, u), each
group kernel's shapes with their dependent chain
(ops/fp12prog.py), and the narrow K3 / K4 launches split into per-step
latencies by rerunning them with other loop bits.  Each phase prints one
JSON line; the line before the last is the per-kernel table ({"kernels":
[...]}), preceded by the card's name and power limit; the last is {"ok":
true, "device": ...}.  Any failure exits non-zero before the last line.
Without a CUDA device, or without the rest of the repository beside it, it
exits non-zero and prints no result.

Never imports jax or drand_tpu: only the port.
"""

import argparse
import hashlib
import json
import os
import random
import re
import subprocess
import sys
import threading
import time

import numpy as np

ROUNDS = 8192            # the canonical verify batch width of the repository
SEED = 20240101

# the kernels each main path must launch at least once
G1_RLC_KERNELS = ("pow_fixed", "scalar_mul_fixed", "miller_loop",
                  "final_exponentiation", "sum_rows", "scalar_mul_glv_mixed",
                  "hash_to_field")
G2_EXACT_KERNELS = ("pow_fixed", "pow_fixed_fp2", "scalar_mul_fixed_g2",
                    "miller_loop", "final_exponentiation", "hash_to_field_fp2")
G2_RLC_KERNELS = G2_EXACT_KERNELS + ("sum_rows_g2", "scalar_mul_glv_mixed_g2")
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
# the verify_service phase serves rounds[:n // SERVICE_SHARE], cut to keep
# the script well inside its time limit (its walls are its bad slots'
# bisections, four of them at 2048)
SERVICE_SHARE = 4
# bench.py config 3 verifies 2048 rounds a chunk; the threshold phases run
# 512 since the beacon phases came (their depth, cut to keep the script
# well inside its time limit)
PARTIALS_ROUNDS = 512

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
K1_LIMB_BYTES = 24 * 8   # K1 reads and writes the (B, 24) int64 limbs


LOG = []                 # chip_smoke.jsonl under --log-dir: every line


def say(line):
    print(line, flush=True)
    for f in LOG:
        f.write(line + "\n")
        f.flush()


T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line carries the script's elapsed seconds."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - T0)
    say(json.dumps(obj))


def digest(sigs):
    """sha256 of the signatures in order: equal runs sign equal bytes."""
    return hashlib.sha256(b"".join(sigs)).hexdigest()


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


def _windows(e, w):
    """(count, length of the first) of the left-to-right sliding windows
    of width w over e's bits."""
    bits, i, windows, first = bin(e)[2:] if e else "", 0, 0, 0
    while i < len(bits):
        if bits[i] == "0":
            i += 1
            continue
        j = min(i + w, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        windows, first, i = windows + 1, first or j - i, j
    return windows, first


def _sliding_window(e):
    """(products, squarings) of left-to-right sliding-window e-th power at
    its best width: the odd powers up to a^(2^w-1), one squaring per bit
    below the first window, one product per window after the first."""
    best = None
    for w in range(1, 8):
        count, first = _windows(e, w)
        cost = (2 ** (w - 1) - 1 + count - 1,
                e.bit_length() - first + (w > 1))
        if best is None or _imad(*cost) < _imad(*best):
            best = cost
    return best


def _imad(muls, sqrs=0):
    return muls * IMAD_MUL + sqrs * IMAD_SQR


def need_pow(e):
    return _imad(*_sliding_window(e))


# K1's inversion for e = p - 2 (csrc/field.cuh fp_inv, safegcd): 37
# batches of 30 divsteps, each divstep 28 word operations (masks, adds,
# shifts); after each batch the f, g update (13 limbs: four 32 x 32 -> 64
# products, two 64-bit shifts and two masks a limb, 16 word operations) and
# the d, e update (six products a limb, 20); then one Montgomery product.
# Counted at the multiply-add rate: the card issues its 32-bit integer
# operations at 64 a clock per SM too.
INV_BATCHES, INV_DIVSTEP_OPS = 37, 28
INV_UPDATE_OPS = 13 * (16 + 20)
INV_OPS = INV_BATCHES * (30 * INV_DIVSTEP_OPS + INV_UPDATE_OPS) + IMAD_MUL


def need_inv(p):
    """x^(p-2), the inverse: the cheaper of the Fermat window chain and
    the safegcd inversion's word operations."""
    return min(need_pow(p - 2), INV_OPS)


def code_pow(sched, ntab):
    """K1's windowed chain (csrc/pow.cu) for a kernels.pow_schedule
    schedule: the table (x^2, then ntab - 1 products), a squaring at each
    -1 and a product at each entry after the first, the squaring at 456."""
    sqrs = sched[1:].count(-1)
    return _imad(len(sched) - 1 - sqrs + ntab - 1, sqrs + (ntab > 1))


def need_ladder(k):
    # dbl-2009-l 2M+5S from P, add-2007-bl 11M+5S (no doubling case here)
    return ((k.bit_length() - 1) * _imad(2, 5)
            + (_hw(k) - 1) * _imad(11, 5))


FP12_MUL, FP12_SQR, CYCLO_SQR, FP6_SQR = 54, 36, 18, 12
# kernels.dbl_step: four Fp2 squarings and Rx Ry, then hh^2, t2^2, g m and
# t0 t4; its products by b2 = 4 (1 + u) and by 1/2 are adds and a halving
DBL_STEP = 4 * 2 + 3 + 2 * 2 + 3 + 3
ADD_STEP = 2 * 3 + 2 * 3 + 2 * 2 + 3 * 3 + 4 * 3
SPARSE_LINE = 2 * 2 + 13 * 3            # ell scaled by P, then mul_by_014


def need_miller(xbits):
    # f starts at 1: its first squaring and first line product are free
    lines = len(xbits) + sum(xbits)
    return _imad((len(xbits) - 1) * FP12_SQR + len(xbits) * DBL_STEP
                 + sum(xbits) * ADD_STEP + lines * SPARSE_LINE
                 - (SPARSE_LINE - 2 * 2))


def code_group(counts):
    """K2 / K3 / K4 / K6 (csrc/ladder.cu, miller.cu, finalexp.cu,
    ladder_var.cu): what fp12prog's program does for one lane
    (fp12prog.lane_counts), every product at 588; its linear and flag ops,
    and K4's binary-gcd Fp inverse, do no multiply-adds.  K6 runs every
    step's products whatever the bit; K2 an add only after a one bit, its
    embedded doubling included."""
    return _imad(counts["products"])


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


def _fp2_const_mul(c, p):
    """Fp products of a product by the Fp2 constant c mod p: none by 1, two
    when c0 or c1 is 0 or c0 = +-c1 (c0 (a0 -+ a1), c0 (a0 +- a1)), else 3."""
    if c == (1, 0):
        return 0
    return 2 if 0 in (c[0], c[1], (c[0] - c[1]) % p, (c[0] + c[1]) % p) else 3


def need_finalexp(xbits, frob_consts, p):
    frob = {j: sum(_fp2_const_mul(c, p) for c in frob_consts[j])
            for j in (1, 2)}
    # norm, inverse, 2 products; a binary extended gcd inverts with no
    # multiply-add, and one product takes its result into Montgomery form
    fp2_inv = _imad(2, 2) + _imad(1)
    return _finalexp(xbits, fp2_inv, FP6_SQR, CYCLO_SQR, frob)


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


def need_sum(z_is_zero, add):
    """K7 multiply-adds for rows of points, z_is_zero (rows, lanes): per
    row one complete add (add: the cheapest formula's multiply-adds,
    add-2007-bl) for each finite point after the first; infinite inputs
    add nothing."""
    finite = (~z_is_zero).sum(-1)
    return int((finite - 1).clamp(min=0).sum()) * add


def code_sum(rows, lanes, add_products):
    """What K7 does: a complete add for each lane of a row after the first
    (a halving tree over B lanes holds B - 1 adds; padding runs none), each
    of the program's products at 588 (fp12prog.lane_counts)."""
    return rows * max(lanes - 1, 0) * _imad(add_products)


def k7_levels(lanes, tile):
    """The dependent adds of a K7 row of `lanes` lanes: the halving levels
    that hold an add in its fullest tile at each stage, then the fold of
    the last 2-4 partials (kernels.sum_points_plain's association)."""
    levels, n = 0, max(lanes, 1)
    while True:
        levels += (min(n, tile) - 1).bit_length()
        n = -(-n // tile)
        if n <= 4:
            return levels + n - 1


# G2: an Fp2 product is 3 Fp products, an Fp2 squaring 2 (complex
# squaring: two general Fp products), so the G2 counts are in Fp products
# of IMAD_MUL each.
FP2_M, FP2_S = 3, 2
G2_DBL_NEED = 2 * FP2_M + 5 * FP2_S        # dbl-2009-l
G2_ADD_NEED = 11 * FP2_M + 5 * FP2_S       # add-2007-bl
G2_MADD_NEED = 7 * FP2_M + 4 * FP2_S       # madd-2007-bl


def need_pow2(e, p):
    """Fp2 x^e: the cheaper of the sliding-window chain over e and the
    Frobenius split (x^p = conj(x): e = a p + b, x^e = conj(x)^a x^b, one
    squaring a bit of max(a, b), the windows of a and b over one table of
    odd powers, conjugation free)."""
    a, b = divmod(e, p)
    muls, sqrs = _sliding_window(e)
    best = _imad(FP2_M * muls + FP2_S * sqrs)
    for w in range(1, 8):
        (na, fa), (nb, fb) = _windows(a, w), _windows(b, w)
        muls = 2 ** (w - 1) - 1 + na + nb - 1
        sqrs = max(a.bit_length() - fa, b.bit_length() - fb) + (w > 1)
        best = min(best, _imad(FP2_M * muls + FP2_S * sqrs))
    return best


def need_ladder_g2(k):
    return _imad((k.bit_length() - 1) * G2_DBL_NEED
                 + (_hw(k) - 1) * G2_ADD_NEED)


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


# H1's word operations a lane (bound like K1's inversion: 32-bit word
# operations at the multiply-add rate).  A SHA-256 compression at its
# cheapest standard form -- a rotation one funnel shift, a three-input
# logic function one LOP3, three-input adds -- takes 48 message-schedule
# steps of 10 operations, 64 rounds of 14 and the 8 final adds.  A lane:
# its digest's blocks (none for the DIGEST front; 1 for round8, 2 for
# prev || round8), b_0's 2 blocks after the Z_pad midstate, 2 blocks for
# each of the ell = 2 x chunks b_i and 8 XORs each, and per 64-byte chunk
# two Montgomery products (R^2 and R^3) and an add mod p.
SHA_OPS = 48 * 10 + 64 * 14 + 8


def need_h1(chunks, digest_blocks):
    ell = 2 * chunks
    return ((digest_blocks + 2 + 2 * ell) * SHA_OPS + 8 * ell
            + chunks * (2 * IMAD_MUL + 24))


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
    """The ptxas statistics of every entry kernel of `src` whose mangled
    name holds one of the needles (K1's chain and inversion, K2-G1's and
    K7's entry a width)."""
    return [dict(st, entry=name) for name, st in regs.get(src, {}).items()
            if any(nd in name for nd in needles)]


# ---------------------------------------------------------------------------


def service_phases(ctx):
    """The verify_service phase (see the module doc): coalescing at full
    width, a catch-up with live work, the failover drill, and the checks
    that nothing fell back to the host outside the drill.  Returns the
    numbers it printed."""
    torch, K, B = ctx["torch"], ctx["K"], ctx["B"]
    schemes, HS, n = ctx["schemes"], ctx["HS"], ctx["n"]
    from drand_tpu_torch import metrics
    from drand_tpu_torch.crypto import verify_service as VS
    from drand_tpu_torch.crypto.hostverify import HostBatchVerifier

    def counter_total(metric):
        return sum(v for suffix, _, v in metric.samples() if suffix == "")

    def service_health(svc):
        return {"backends": svc.stats()["backends"],
                "failovers": svc.stats()["failovers"],
                "watchdog_trips": svc.stats()["watchdog_trips"],
                "host_fallbacks_built": sum(
                    s.fallback is not None for s in svc._slots.values())}

    g1 = schemes.scheme_from_name(schemes.SHORT_SIG_SCHEME_ID)
    chained = schemes.scheme_from_name(schemes.DEFAULT_SCHEME_ID)
    failovers0 = counter_total(metrics.verify_failovers)
    trips0 = counter_total(metrics.verify_watchdog_trips)
    # a long coalescing window: the 16 callers' slices must meet in one
    # batch whatever the threads' start-up order; the pad flushes it.  At
    # the default --rounds the pad is the service's default (AUTO: 8192)
    svc = VS.VerifyService(pad=0 if n == VS.DEFAULT_PAD else n,
                           background_window=5.0)
    pool = svc._get_pool()
    if pool.n_groups != 1 or pool.n_devices != torch.cuda.device_count() \
            or pool.pool_sharding() is not None:
        fail(f"the service's pool: {pool.snapshot()}, placement "
             f"{pool.pool_sharding()}")
    h1 = svc.handle(g1, HS.g2_to_bytes(ctx["pk"]))
    h2 = svc.handle(chained, ctx["pk2"])
    if (h1.kind, h2.kind) != ("device", "device") \
            or h1.backend.pad_to != n or h2.backend.pad_to != n:
        fail(f"service handles: {h1.kind} {h2.kind}, pads "
             f"{h1.backend.pad_to} {h2.backend.pad_to}")
    # the scheduler and packer threads run on the default stream of the
    # card, as the caller does: a chunk's copy and its dispatch are ordered
    streams = []
    th = threading.Thread(target=lambda: streams.append(
        torch.cuda.current_stream(0) == torch.cuda.default_stream(0)))
    th.start()
    th.join()

    # -- 1. coalescing at full width: 16 caller threads, n / 16 rounds each -
    out = {}
    chains = (("g1", h1, ctx["sigs"], None, ctx["g1_mask"],
               G1_RLC_KERNELS),
              ("g2_chained", h2, ctx["bsigs"], ctx["cprevs"],
               ctx["g2_mask"], G2_RLC_KERNELS))
    for tag, h, csigs, cprevs, mask, kernels in chains:
        callers, width = 16, n // 16
        thread_wall = None
        if tag == "g1":
            # the same verify_batch, direct, from a fresh thread just
            # before the service's run: the service's situation without
            # the service (the direct wall above ran on the main thread,
            # several phases earlier)
            box = []

            def direct():
                t = time.perf_counter()
                box.append(h.backend.verify_batch(ctx["rounds"], csigs))
                torch.cuda.synchronize()
                box.append(time.perf_counter() - t)

            th = threading.Thread(target=direct)
            th.start()
            th.join()
            if len(box) != 2 or not (box[0] == mask).all():
                fail("the direct verify_batch from a thread disagrees with "
                     "the direct mask")
            thread_wall = box[1]
        before = svc.stats()
        futs = [None] * callers
        gate = threading.Barrier(callers)

        def caller(i):
            lo, hi = i * width, (i + 1) * width
            gate.wait()
            futs[i] = h.submit(ctx["rounds"][lo:hi], csigs[lo:hi],
                               cprevs[lo:hi] if cprevs else None)

        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=caller, args=(i,))
                   for i in range(callers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        got = [f.result(600) for f in futs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        after = svc.stats()
        d = {k: after[k] - before[k] for k in ("dispatches", "submitted",
                                                "dispatch_lanes",
                                                "dispatch_slots")}
        equal = all((g == mask[i * width:(i + 1) * width]).all()
                    for i, g in enumerate(got))
        out[tag] = {"callers": callers, "rounds_per_caller": width,
                    "verdicts_equal_direct_mask": bool(equal),
                    "bad_slots": int((~mask).sum()),
                    "dispatches": d["dispatches"],
                    "submitted": d["submitted"],
                    "dispatch_lanes": d["dispatch_lanes"],
                    "fill_ratio": d["dispatch_lanes"]
                    / max(1, d["dispatch_slots"]),
                    "wall_s": wall, "rounds_per_s": n / wall,
                    "direct_in_a_thread_wall_s": thread_wall,
                    "launches": launches}
        if not equal:
            fail(f"service {tag}: verdicts differ from the direct mask")
        if d["dispatches"] != 1 or d["dispatch_lanes"] != n \
                or d["dispatch_slots"] != n or d["submitted"] != callers:
            fail(f"service {tag}: want one {n}-lane dispatch of {callers} "
                 f"submissions, got {d}")
        if any(launches[k] == 0 for k in kernels):
            fail(f"service {tag}: a kernel of the path was not launched: "
                 f"{launches}")

    # -- 2. a catch-up of 2 x pad rounds with 8 one-round live submissions --
    before = svc.stats()
    big_rounds = ctx["rounds"] * 2
    big_sigs = ctx["good_sigs"] * 2
    live_lat, live_ok = [], []
    t0 = time.perf_counter()
    catchup = h1.submit(big_rounds, big_sigs)
    done_at = []
    catchup.add_done_callback(lambda f: done_at.append(time.perf_counter()))
    for i in range(8):
        time.sleep(0.1)
        ts = time.perf_counter()
        r = (i * 997) % n
        f = h1.submit([ctx["rounds"][r]], [ctx["good_sigs"][r]],
                      lane=VS.LANE_LIVE)
        f.add_done_callback(lambda f, ts=ts: live_lat.append(
            time.perf_counter() - ts))
        live_ok.append(f)
    cu = catchup.result(600)
    lives = [f.result(600) for f in live_ok]
    torch.cuda.synchronize()
    cu_wall = done_at[0] - t0 if done_at else time.perf_counter() - t0
    after = svc.stats()
    d = {k: after[k] - before[k] for k in ("dispatches", "preemptions",
                                            "sharded_dispatches")}
    out["catch_up"] = {
        "rounds": len(big_rounds), "all_valid": bool(cu.all()),
        "shard_threshold": svc._shard_threshold_for(svc._slots[h1.key]),
        "wall_s": cu_wall, "rounds_per_s": len(big_rounds) / cu_wall,
        "live_submissions": len(lives),
        "live_all_valid": all(bool(v.all()) for v in lives),
        "live_latency_s": sorted(live_lat),
        "live_latency_p50_s": float(np.median(live_lat)) if live_lat
        else None,
        "live_latency_max_s": max(live_lat) if live_lat else None,
        "dispatches": d["dispatches"], "preemptions": d["preemptions"],
        "sharded_dispatches": d["sharded_dispatches"]}
    if not cu.all() or len(cu) != 2 * n or not all(v.all() for v in lives):
        fail(f"service catch-up verdicts: {out['catch_up']}")
    if d["sharded_dispatches"] != 0 or len(live_lat) != 8:
        fail(f"service catch-up: {out['catch_up']}")

    # -- 4. no hidden fallback in 1 and 2 ------------------------------------
    health = service_health(svc)
    health["failovers_total_metric"] = counter_total(
        metrics.verify_failovers) - failovers0
    health["watchdog_trips_metric"] = counter_total(
        metrics.verify_watchdog_trips) - trips0
    health["default_stream_in_a_new_thread"] = streams == [True]
    out["health"] = health
    svc.stop()
    if any(v != "healthy" for v in health["backends"].values()) \
            or health["failovers"] or health["watchdog_trips"] \
            or health["host_fallbacks_built"] \
            or health["failovers_total_metric"] \
            or health["watchdog_trips_metric"] or streams != [True]:
        fail(f"the service fell back or tripped outside the drill: {health}")

    # -- 3. the failover drill: a backend that raises on its first two
    # dispatches degrades to the host fallback and is re-promoted ----------
    class Flaky:
        """The port's verifier, raising on its first two calls."""

        kind = "device"

        def __init__(self, inner):
            self.inner, self.calls = inner, 0

        def verify_batch(self, rounds_, sigs_, prevs_=None):
            self.calls += 1
            if self.calls <= 2:
                raise RuntimeError(f"injected device fault {self.calls}")
            return self.inner.verify_batch(rounds_, sigs_, prevs_)

    built = []

    def factory(group):
        built.append(Flaky(B.BatchBeaconVerifier(
            g1, HS.g2_to_bytes(ctx["pk"]), pad_to=8,
            sharding=group.sharding())))
        return built[-1]

    drill = VS.VerifyService(pad=8, background_window=0.0,
                             probe_interval=1.0)
    walk = []
    real_gauge = drill._set_state_gauge

    def gauge(slot, old_gid=None):
        walk.append(slot.state)
        real_gauge(slot, old_gid)

    drill._set_state_gauge = gauge
    pk_bytes = HS.g2_to_bytes(ctx["pk"])
    hd = drill.handle(g1, pk_bytes, backend_factory=factory,
                      fallback=HostBatchVerifier(g1, pk_bytes))
    d_rounds = ctx["rounds"][:4]
    d_sigs = list(ctx["good_sigs"][:4])
    d_sigs[2] = d_sigs[1]                   # one bad slot
    want = np.array([True, True, False, True])
    t0 = time.perf_counter()
    got = hd.verify_batch(d_rounds, d_sigs)
    degraded_s = time.perf_counter() - t0
    slot = drill._slots[hd.key]
    deadline = time.monotonic() + 120
    while slot.state != VS.STATE_HEALTHY and time.monotonic() < deadline:
        time.sleep(0.05)
    promoted_s = time.perf_counter() - t0
    calls_before = built[0].calls
    again = hd.verify_batch(d_rounds, d_sigs)
    dst = drill.stats()
    drill.stop()
    out["failover_drill"] = {
        "rounds": 4, "verdicts": got.tolist(), "after_promotion":
        again.tolist(), "state_walk": walk, "failovers": dst["failovers"],
        "promotions": dst["promotions"], "degraded_wall_s": degraded_s,
        "repromoted_after_s": promoted_s,
        "device_served_after": built[0].calls > calls_before}
    want_walk = [VS.STATE_HEALTHY, VS.STATE_SUSPECT, VS.STATE_DEGRADED,
                 VS.STATE_PROBING, VS.STATE_HEALTHY]
    if got.tolist() != want.tolist() or again.tolist() != want.tolist() \
            or walk[:5] != want_walk or dst["failovers"] != 1 \
            or dst["promotions"] != 1 or not built[0].calls > calls_before:
        fail(f"the failover drill: {out['failover_drill']}")

    emit({"phase": "verify_service", **out, "device": ctx["name"],
          "nvidia_smi": ctx["smi_line"],
          "tolerance": "exact: every future's verdicts equal the direct "
                       "mask's slice"})
    say(f"verify_service: coalesced g1 {out['g1']['rounds_per_s']:.0f} "
        f"rounds/s (direct from a thread "
        f"{n / out['g1']['direct_in_a_thread_wall_s']:.0f}), "
        f"g2 chained {out['g2_chained']['rounds_per_s']:.0f}; "
        f"catch-up {out['catch_up']['wall_s']:.3f} s, live p50 / max "
        f"{out['catch_up']['live_latency_p50_s']:.3f} / "
        f"{out['catch_up']['live_latency_max_s']:.3f} s, preemptions "
        f"{out['catch_up']['preemptions']}; {ctx['smi_line']}")
    return out


# ---------------------------------------------------------------------------
# The dkg phase: committee-scale fixtures on the host (independent of the
# port's device code) and the phase itself
# ---------------------------------------------------------------------------

DKG_N, DKG_T, DKG_QUAL = 1024, 32, 32   # bench.py:99-106 config 8
DKG_HOLDER = 17
PARTIALS_COEFFS = 8                     # bench.py:807, config 8's polynomial
# a League of Entropy group has 16 nodes at t = 9; the ceremony's wall is
# host Schnorr, DH and point decoding (n^2: 93 s at 16 on the H100's host),
# so the phase runs 8 nodes at drand's t = n/2 + 1
CEREMONY_N, CEREMONY_T = 8, 5


def _batch_inv(f, vals):
    """Montgomery's trick: the inverses of nonzero field elements with one
    field inversion (host field ops `f` of a host curve)."""
    pre, acc = [], f.one
    for v in vals:
        pre.append(acc)
        acc = f.mul(acc, v)
    ia = f.inv(acc)
    out = [None] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = f.mul(ia, pre[i])
        ia = f.mul(ia, vals[i])
    return out


def batch_add(hc, ps, qs):
    """ps[i] + qs[i] for finite affine host points with distinct x (the
    fixtures' sums never meet P == +-Q; an equal x raises): affine adds
    sharing one inversion."""
    f = hc.f
    dx = [f.sub(q[0], p[0]) for p, q in zip(ps, qs)]
    if any(f.is_zero(d) for d in dx):
        raise ValueError("batch_add met P == +-Q")
    out = []
    for p, q, i in zip(ps, qs, _batch_inv(f, dx)):
        lam = f.mul(f.sub(q[1], p[1]), i)
        x3 = f.sub(f.sub(f.sqr(lam), p[0]), q[0])
        out.append((x3, f.sub(f.mul(lam, f.sub(p[0], x3)), p[1])))
    return out


def batch_mul(hc, base, ks, R):
    """k_i * base for many scalars: one double-and-add over all lanes, the
    table 2^i * base by host doublings, each bit's adds one batch_add."""
    ks = [k % R for k in ks]
    table = [base]
    for _ in range(max(ks, default=0).bit_length()):
        table.append(hc.add(table[-1], table[-1]))
    acc = [None] * len(ks)
    for i, t in enumerate(table):
        idx = [l for l, k in enumerate(ks) if k >> i & 1]
        live = [l for l in idx if acc[l] is not None]
        for l in idx:
            if acc[l] is None:
                acc[l] = t
        for l, s in zip(live, batch_add(hc, [acc[l] for l in live],
                                        [t] * len(live))):
            acc[l] = s
    return acc


def host_horner(hc, commits, x):
    """sum_j x^j C_j by host Horner (host mul by the small x, host add):
    PubPoly.eval's value at index x - 1 without its full-width powers."""
    acc = commits[-1]
    for c in reversed(commits[:-1]):
        acc = hc.add(hc.mul(acc, x), c)
    return acc


def dkg_phases(ctx):
    """The dkg phase (module doc): (a) committee scale on both key groups,
    (b) a whole ceremony and a reshare through DistKeyGenerator.  Returns
    {"paths": {path: (launches, shapes)}, "walls": {...}}; the paths'
    shapes join phase 4."""
    torch, K, drive = ctx["torch"], ctx["K"], ctx["drive"]
    schemes, HT, HS, R = ctx["schemes"], ctx["HT"], ctx["HS"], ctx["R"]
    name, smi_line, rng = ctx["name"], ctx["smi_line"], ctx["rng"]
    n, t, nq = ctx.get("dkg_n", DKG_N), ctx.get("dkg_t", DKG_T), \
        ctx.get("dkg_qual", DKG_QUAL)
    from drand_tpu_torch.crypto import dkg as D
    from drand_tpu_torch.crypto import dkg_device as DD
    from drand_tpu_torch.crypto import partials as PP
    from drand_tpu_torch.crypto import schnorr

    def rnd():
        return int.from_bytes(rng.bytes(32), "big") % (R - 1) + 1

    def k6_launches(launches):
        return {k: v for k, v in launches.items()
                if k.startswith("scalar_mul_bits")}

    paths, walls = {}, {}

    def run(path, fn):
        """drive(fn) plus dkg_device's dispatch count; the path's launches
        and shapes kept for phase 4."""
        before = DD.dispatch_count()
        out, wall, launches, shapes, _ = drive(fn)
        paths[path] = (launches, shapes)
        walls[path] = wall
        return out, wall, DD.dispatch_count() - before, launches

    def committee(sid, tag):
        sch = schemes.scheme_from_name(sid)
        grp = sch.key_group
        hc = grp.curve
        x = DKG_HOLDER + 1
        t0 = time.perf_counter()
        # the dealers' polynomials: a reshare's, so c_{d,0} = old(d), the
        # old polynomial's value at x = d + 1; c_{d,j} random for the first
        # nq dealers, a_j + d b_j mod r after them (C_{d,j} = C_{d-1,j} +
        # B_j by batched host adds)
        old = [rnd() for _ in range(t)]
        old_at = [sum(c * pow(d + 1, j, R) for j, c in enumerate(old)) % R
                  for d in range(n)]
        a = [rnd() for _ in range(t)]
        b = [rnd() for _ in range(t)]
        coef = [[old_at[d]] + ([rnd() for _ in range(t - 1)] if d < nq else
                               [(a[j] + d * b[j]) % R for j in range(1, t)])
                for d in range(n)]
        first = [coef[d][j] for d in range(nq) for j in range(1, t)]
        lin0 = [coef[nq][j] for j in range(1, t)]
        pts = batch_mul(hc, hc.gen, old_at + first + lin0 + b[1:] + old, R)
        c0, pts = pts[:n], pts[n:]
        rand_c, pts = pts[:len(first)], pts[len(first):]
        row, pts = pts[:t - 1], pts[t - 1:]
        bj, old_c = pts[:t - 1], pts[t - 1:]
        commits = [[c0[d]] + rand_c[d * (t - 1):(d + 1) * (t - 1)]
                   for d in range(nq)]
        commits.append([c0[nq]] + row)
        for d in range(nq + 1, n):
            row = batch_add(hc, row, bj)
            commits.append([c0[d]] + row)
        shares = [sum(c * pow(x, j, R) for j, c in enumerate(coef[d])) % R
                  for d in range(n)]
        # 20 wrong-index shares, 20 dealers with a tampered non-constant
        # coefficient (tests/test_committee.py:115-157), 10 wrong claimed
        # constant terms for the pin
        picks = rng.permutation(n).tolist()
        wrong_idx, tampered = sorted(picks[:20]), sorted(picks[20:40])
        mismatched = sorted(picks[40:50])
        bad_commits = [list(c) for c in commits]
        for d in wrong_idx:
            shares[d] = sum(c * pow(x + 1, j, R)
                            for j, c in enumerate(coef[d])) % R
        for d in tampered:
            j = int(rng.integers(1, t))
            bad_commits[d][j] = hc.add(bad_commits[d][j], hc.gen)
        claimed = [c[0] for c in commits]
        for d in mismatched:
            claimed[d] = hc.add(claimed[d], hc.gen)
        fixture_s = time.perf_counter() - t0

        want_vs = [d not in wrong_idx and d not in tampered for d in range(n)]
        want_ct = [d not in mismatched for d in range(n)]

        def check_path():
            return (DD.verify_shares(grp, bad_commits, DKG_HOLDER, shares),
                    DD.constant_terms_match(grp, old_c, range(n), claimed))

        (vs, ct), wall, disp, launches = run(f"dkg_{tag}_verify", check_path)
        rec = {"verify_shares_and_pin_wall_s": wall, "dispatches": disp,
               "k6_launches": k6_launches(launches),
               "rejected": [d for d in range(n) if not vs[d]],
               "pinned": [d for d in range(n) if not ct[d]]}
        ok = vs == want_vs and ct == want_ct and disp <= 4

        pub_old = HT.PubPoly(grp, list(old_c))
        primed, wall, disp_p, launches = run(
            f"dkg_{tag}_prime", lambda: DD.prime_public_shares(pub_old, n))
        rec.update(prime_wall_s=wall, prime_dispatches=disp_p,
                   prime_k6_launches=k6_launches(launches))
        ok &= disp_p == 1 and len(primed) == n

        # the host oracle on 64 dealers, every tampered and pinned one
        rest = [d for d in picks[50:] if d not in wrong_idx + tampered]
        sample = sorted(set(wrong_idx + tampered + mismatched
                            + rest[:64 - 50]))
        t0 = time.perf_counter()
        bad_oracle = []
        for d in sample:
            host_vs = hc.mul(hc.gen, shares[d]) == host_horner(
                hc, bad_commits[d], x)
            old_d = host_horner(hc, old_c, d + 1)
            if host_vs != vs[d] or (old_d == claimed[d]) != ct[d] \
                    or primed[d] != old_d:
                bad_oracle.append(d)
        # host_horner against PubPoly.eval itself on two dealers
        for d in sample[:2]:
            if HT.PubPoly(grp, list(old_c)).eval(d) != \
                    host_horner(hc, old_c, d + 1):
                bad_oracle.append(("pubpoly_eval", d))
        oracle_s = time.perf_counter() - t0
        ok &= not bad_oracle

        # finalization: weighted over the first nq dealers (a reshare's
        # old threshold; every old(d) interpolates back to old[0]) and
        # plain over all n (a fresh DKG's sum)
        qual = list(range(nq))
        lams = [HT._lagrange_coeff(qual, d) for d in qual]
        (cw, cs), wall, disp_c, launches = run(
            f"dkg_{tag}_combine", lambda: (
                DD.combine_commits(grp, commits[:nq], lams),
                DD.combine_commits(grp, commits)))
        t0 = time.perf_counter()
        want_w = batch_mul(hc, hc.gen, [
            sum(lams[i] * coef[d][j] for i, d in enumerate(qual)) % R
            for j in range(t)], R)
        want_s = batch_mul(hc, hc.gen, [sum(coef[d][j] for d in range(n)) % R
                                        for j in range(t)], R)
        host_w = {}
        for j in (0, 1, t // 2, t - 1):
            acc = None
            for i, d in enumerate(qual):
                acc = hc.add(acc, hc.mul(commits[d][j], lams[i]))
            host_w[j] = acc
        host_s = {}
        for j in (0, t - 1):
            acc = None
            for d in range(n):
                acc = hc.add(acc, commits[d][j])
            host_s[j] = acc
        combine_oracle_s = time.perf_counter() - t0
        comb_ok = (cw == want_w and cs == want_s and cw[0] == old_c[0]
                   and all(cw[j] == v for j, v in host_w.items())
                   and all(cs[j] == v for j, v in host_s.items()))
        ok &= comb_ok and disp_c == 2
        rec.update(combine_wall_s=wall, combine_dispatches=disp_c,
                   combine_k6_launches=k6_launches(launches),
                   combine_equal_to_construction_and_host=comb_ok,
                   weighted_keeps_old_key=cw[0] == old_c[0])

        # the committee's partials check: config 8's polynomial, one
        # round's n partials, one forged
        t0 = time.perf_counter()
        sg = sch.sig_group
        poly = HT.PriPoly([rnd() for _ in range(PARTIALS_COEFFS)])
        pp = HT.PubPoly(grp, batch_mul(hc, hc.gen, poly.coeffs, R))
        sks = [poly.eval(i).value for i in range(n)]
        msg = sch.digest_beacon(1, rng.bytes(96) if sch.chained else None)
        hm = sg.hash_to_curve(msg, sch.dst)
        forged = int(rng.integers(n))
        sigs = batch_mul(sg.curve, hm, [s + (d == forged)
                                        for d, s in enumerate(sks)], R)
        prow = [d.to_bytes(2, "big") + sg.to_bytes(s)
                for d, s in enumerate(sigs)]
        fixture_s += time.perf_counter() - t0
        before = DD.dispatch_count()
        bv, setup_wall, launches, shapes, _ = drive(
            lambda: PP.BatchPartialVerifier(sch, pp, n))
        paths[f"dkg_{tag}_partials_setup"] = (launches, shapes)
        setup_disp = DD.dispatch_count() - before
        fresh = HT.PubPoly(grp, list(pp.commits))
        prime_ok = setup_disp == 1 and all(
            bv.pub_points[d] == fresh.eval(d) for d in sample[:8])
        mask, vwall, launches, shapes, passes = drive(
            lambda: bv.verify_partials([msg], [prow]))
        paths[f"dkg_{tag}_partials"] = (launches, shapes)
        want_mask = np.ones((1, n), dtype=bool)
        want_mask[0, forged] = False
        part_ok = mask.shape == want_mask.shape and bool(
            (mask == want_mask).all())
        ok &= prime_ok and part_ok
        rec.update(partials={
            "signers": n, "coefficients": PARTIALS_COEFFS,
            "forged_slot": forged, "setup_wall_s": setup_wall,
            "setup_dispatches": setup_disp, "primed_equal_host": prime_ok,
            "verify_wall_s": vwall, "passes": passes,
            "mask_as_constructed": part_ok})
        emit({"phase": f"dkg_{tag}_committee", "scheme": sid,
              "key_group": grp.name, "dealers": n, "coefficients": t,
              "holder": DKG_HOLDER, "qual_weighted": nq, **rec,
              "verdicts_as_constructed": vs == want_vs and ct == want_ct,
              "oracle_sample": len(sample), "oracle_disagrees": bad_oracle,
              "fixture_s": fixture_s, "oracle_s": oracle_s,
              "combine_oracle_s": combine_oracle_s, "device": name,
              "nvidia_smi": smi_line})
        if not ok:
            fail(f"dkg {tag} committee: verdicts {vs == want_vs} / "
                 f"{ct == want_ct}, dispatches {disp} / {disp_p} / "
                 f"{disp_c} / {setup_disp}, oracle {bad_oracle}, combine "
                 f"{comb_ok}, primed {prime_ok}, partials {part_ok}")

    committee(schemes.SHORT_SIG_SCHEME_ID, "g2keys")
    committee(schemes.DEFAULT_SCHEME_ID, "g1keys")

    # (b) one whole ceremony and a reshare on pedersen-bls-chained (G1
    # keys), every seam on the card: MIN_N at the smallest seam's lanes
    # (the reshare's weighted combine over old-threshold dealers)
    cn, ct_ = ctx.get("ceremony_n", CEREMONY_N), \
        ctx.get("ceremony_t", CEREMONY_T)
    sch = schemes.scheme_from_name(schemes.DEFAULT_SCHEME_ID)
    grp = sch.key_group
    hc = grp.curve
    secs = [rnd() for _ in range(cn)]
    nodes = [D.DkgNode(i, grp.to_bytes(hc.mul(hc.gen, s)))
             for i, s in enumerate(secs)]
    saved_min = DD.MIN_N
    DD.MIN_N = ct_
    try:
        def fresh():
            gens = [D.DistKeyGenerator(D.DkgConfig(
                scheme=sch, longterm=secs[i], nonce=b"f" * 32,
                new_nodes=nodes, threshold=ct_)) for i in range(cn)]
            deals = [g.generate_deals() for g in gens]
            # a transit-corrupted deal to holder 0 in dealer 3's (re-signed)
            # bundle: holder 0 complains, dealer 3 justifies; dealer 5's
            # commitment changed after signing: its signature fails
            deals[3].deals = [dl if dl.share_index != 0 else
                              D.Deal(0, bytes(64)) for dl in deals[3].deals]
            deals[3].signature = schnorr.sign(
                grp, secs[3], deals[3].hash(b"f" * 32))
            deals[5].commits[1] = deals[5].commits[0]
            resps = [g.process_deal_bundles(deals) for g in gens]
            got = [g.process_response_bundles(resps) for g in gens]
            justs = [j for _, j in got if j is not None]
            outs = [g.process_justification_bundles(justs) for g in gens]
            return resps, got, justs, outs

        (resps, got, justs, outs), wall_f, disp_f, launches_f = run(
            "dkg_ceremony", fresh)
        st = [{r.dealer_index: r.status for r in rb.responses}
              for rb in resps]
        complaints = {i: sorted(d for d, s in st[i].items() if s)
                      for i in range(cn)}
        want_c = {i: [3, 5] if i == 0 else [5] for i in range(cn)}
        pk = outs[0].commits[0]

        def recovers(outs_, k):
            """k shares interpolate to a secret whose public key is pk,
            twice (the first and the last k holders)."""
            ok_ = True
            for sub in (outs_[:k], outs_[-k:]):
                idx = [o.share.index for o in sub]
                s = sum(HT._lagrange_coeff(idx, o.share.index) * o.share.value
                        for o in sub) % R
                ok_ &= grp.to_bytes(hc.mul(hc.gen, s)) == pk
            return ok_

        fresh_ok = (complaints == want_c and all(o is None for o, _ in got)
                    and [j.dealer_index for j in justs] == [3]
                    and all(o.commits == outs[0].commits for o in outs)
                    and all(o.qual == [d for d in range(cn) if d != 5]
                            for o in outs)
                    and recovers(outs, ct_))

        def reshare():
            gens = [D.DistKeyGenerator(D.DkgConfig(
                scheme=sch, longterm=secs[i], nonce=b"r" * 32,
                new_nodes=nodes, threshold=ct_, old_nodes=nodes,
                old_threshold=ct_, share=outs[i].share,
                public_coeffs=list(outs[0].commits))) for i in range(cn)]
            deals = [g.generate_deals() for g in gens]
            # dealer 2 deals a polynomial whose constant term is not its
            # old share: an attempt to change the collective key
            evil = D.DistKeyGenerator(D.DkgConfig(
                scheme=sch, longterm=secs[2], nonce=b"r" * 32,
                new_nodes=nodes, threshold=ct_, old_nodes=nodes,
                old_threshold=ct_, share=HT.PriShare(2, 123456789),
                public_coeffs=list(outs[0].commits)))
            deals[2] = evil.generate_deals()
            resps = [g.process_deal_bundles(deals) for g in gens]
            routs = [g.process_response_bundles(resps)[0] for g in gens]
            return gens, routs

        (rgens, routs), wall_r, disp_r, launches_r = run("dkg_reshare",
                                                         reshare)
        reshare_ok = (all(2 not in g._valid_dealers for g in rgens)
                      and all(o is not None and o.commits[0] == pk
                              for o in routs)
                      and all(o.commits == routs[0].commits for o in routs)
                      and recovers(routs, ct_))
    finally:
        DD.MIN_N = saved_min
    # every seam on the card: fresh, a share check and a plain combine a
    # node; reshare, a pin, a share check and a weighted combine a node
    seams_ok = disp_f == 2 * cn and disp_r == 3 * cn
    emit({"phase": "dkg_ceremony", "scheme": sch.id, "nodes": cn,
          "threshold": ct_, "min_n": ct_, "fresh_wall_s": wall_f,
          "reshare_wall_s": wall_r, "fresh_dispatches": disp_f,
          "reshare_dispatches": disp_r, "complaints": complaints,
          "justified_dealers": [j.dealer_index for j in justs],
          "qual": outs[0].qual, "fresh_ok": fresh_ok,
          "key_change_rejected_and_key_kept": reshare_ok,
          "k6_launches": {"fresh": k6_launches(launches_f),
                          "reshare": k6_launches(launches_r)},
          "device": name, "nvidia_smi": smi_line})
    if not (fresh_ok and reshare_ok and seams_ok):
        fail(f"dkg ceremony: fresh {fresh_ok} (complaints {complaints}), "
             f"reshare {reshare_ok}, dispatches {disp_f} / {disp_r} (want "
             f"{2 * cn} / {3 * cn})")
    return {"paths": paths, "walls": walls}


# ---------------------------------------------------------------------------
# Phase 4's plain twins, run together where one call can run them
# ---------------------------------------------------------------------------

# the arguments of a plain twin whose lanes lie on axis 1 (bit planes)
_BIT_ARGS = {"scalar_mul_bits_plain": (1,),
             "scalar_mul_glv_mixed_plain": (3, 4)}
# lanes a joined plain call may hold.  A narrow plain twin is launch-bound
# (on the H100: K3 6.8 s at 2 pairs, 8.0 s at 2048; K4 7.6 s at 1 lane, 8.8
# s at 1024), a wide one adds its lanes' device time (K4 36.6 s at 8192), so
# a joined call costs the launches once and the lanes' time as before: every
# shape of one key joins (the widest key, K8-G2's, holds some 55,000 lanes)
PLAIN_JOIN_LANES = 65536


def _tree_map(f, x):
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(f, v) for v in x)
    return f(x)


def _tensor_leaves(x):
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensor_leaves(v)]
    return []


class Plain:
    """A kernel's plain twin on fixed inputs, ``kernels.<fn>(*args)``.

    Every plain twin is lane-wise (K7's: row-wise, a row's lanes summing),
    and at small widths its time is launch-bound Python (some 1-40 s a
    shape on the H100), so `run_plain` runs the twins of one kernel that
    share a function, its non-tensor arguments, the nesting and every
    shape off the lane axis as one call over their lanes joined, up to
    PLAIN_JOIN_LANES lanes, and hands each its own lanes of the output.
    A joined call's wall is the time of all its twins together: no twin's
    own time is taken from it."""

    def __init__(self, fn, *args):
        self.fn, self.args = fn, args

    def __call__(self):
        from drand_tpu_torch.ops import kernels as K
        return getattr(K, self.fn)(*self.args)

    def axis(self, i):
        return 1 if i in _BIT_ARGS.get(self.fn, ()) else 0

    def lanes(self):
        """The lane count of every argument, or None where they differ."""
        n = {t.shape[self.axis(i)] for i, a in enumerate(self.args)
             for t in _tensor_leaves(a)}
        return n.pop() if len(n) == 1 else None

    def key(self):
        def sig(x, ax):
            if isinstance(x, (tuple, list)):
                return (type(x).__name__,) + tuple(sig(v, ax) for v in x)
            if hasattr(x, "shape") and hasattr(x, "dtype"):
                return ("tensor", str(x.dtype),
                        tuple(d for k, d in enumerate(x.shape) if k != ax))
            return ("value", x)
        if self.lanes() is None:
            return ("alone", id(self))
        return (self.fn,) + tuple(sig(a, self.axis(i))
                                  for i, a in enumerate(self.args))


def run_plain(plains, sync, tags=None):
    """[Plain] -> ([(output, index of its call)], [{"ms", "lanes",
    "members"}] one a call): joinable twins with the same tag (Plain.key;
    a kernel's name) share a call up to PLAIN_JOIN_LANES lanes, each call
    timed once with `sync`; "members" are the indices of its twins."""
    import torch
    tags = tags or [None] * len(plains)
    groups = {}
    for j, p in enumerate(plains):
        groups.setdefault((tags[j], p.key()), []).append(j)
    calls = []
    for idx in groups.values():
        part, total = [], 0
        for j in sorted(idx, key=lambda j: plains[j].lanes() or 0):
            n = plains[j].lanes() or 0
            if part and total + n > PLAIN_JOIN_LANES:
                calls.append(part)
                part, total = [], 0
            part.append(j)
            total += n
        calls.append(part)
    out, walls = [None] * len(plains), []
    for c, idx in enumerate(calls):
        ps = [plains[j] for j in idx]
        args = [_join([p.args[i] for p in ps], ps[0].axis(i))
                for i in range(len(ps[0].args))]
        sync()
        t0 = time.perf_counter()
        with torch.inference_mode():    # no autograd bookkeeping an op
            res = Plain(ps[0].fn, *args)()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        sizes = [p.lanes() for p in ps]
        walls.append({"ms": ms, "lanes": sum(n or 0 for n in sizes),
                      "members": list(idx)})
        lo = 0
        for j, n in zip(idx, sizes):
            out[j] = (_tree_map(lambda t, lo=lo, n=n: t[lo:lo + n]
                                if isinstance(t, torch.Tensor) else t, res),
                      c)
            lo += n
    return out, walls


def _join(parts, ax):
    """Join the same argument of several twins along its lane axis."""
    import torch
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(parts, ax) if len(parts) > 1 else first
    if isinstance(first, (tuple, list)):
        return type(first)(_join([p[k] for p in parts], ax)
                           for k in range(len(first)))
    return first


# ---------------------------------------------------------------------------
# The beacon phases: the port's beacon layer (beacon/, chain/,
# net/resilience.py) as a network of 13 daemons in one process
# ---------------------------------------------------------------------------

# The beacon phases' depth is cut to keep the script well inside its time
# limit, every check kept: a live round of 13 nodes taking turns on the card
# costs some 12 s (quicknet) or 27 s (default) on the H100, and the catch-up
# shares the card with the live rounds (1024 rounds before the daemon phase
# came, 512 since).
BEACON_CHAIN = 512           # quicknet rounds the 12 running nodes hold
BEACON_LIVE = 3              # live rounds beacon_default produces
QUICKNET_LIVE = 2            # live rounds beacon_quicknet produces, the last
                             # with a forged partial (3 before the daemon
                             # phase came)
BEACON_CHUNK = 512           # sync and scan chunk (beacon/sync.py's default)
BEACON_DOWN = 1              # rounds a beacon_default node is down
BEACON_FORGE_AT = 3          # beacon_default's round with a forged partial
BEACON_FORGER = 4            # the signer index that forges it
BEACON_WAIT_S = 600          # real seconds a node may take to store a round
# 13 daemons share one interpreter and one card here.  A (1, 13) partials
# pass is thousands of short torch calls on the card's default stream, and
# twelve of them at once from twelve threads ran several times slower on
# the H100 than the same twelve in turns (PERF.md), so the nodes' checks,
# syncs and scans take turns on the card (BeaconNet.card), with the
# interpreter switching threads every BEACON_SWITCH_S.
BEACON_SWITCH_S = 1e-3
# League of Entropy: quicknet (bls-unchained-on-g1) a round every 3 s from
# 1692803367, the default chain (pedersen-bls-chained) every 30 s from
# 1595431050
QUICKNET_PERIOD, QUICKNET_GENESIS = 3, 1_692_803_367
DEFAULT_PERIOD, DEFAULT_GENESIS = 30, 1_595_431_050


def _beacon_harness():
    """tests/torch_beacon_harness.py, the port's in-process network
    (LocalNetwork, PeerStream), which the CPU tests drive too."""
    import importlib
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests")
    if tests not in sys.path:
        sys.path.append(tests)
    return importlib.import_module("torch_beacon_harness")


class _Timed:
    """A node's partial verifier run in turns on the card (`card`, one lock
    for the nodes of this process), each call's partials, verdicts, wait
    for the card and check wall recorded: the aggregation-time checks the
    phase reads back."""

    def __init__(self, inner, card, log, node, errors):
        self.inner, self.card, self.log = inner, card, log
        self.node, self.errors = node, errors
        self.kind = inner.kind

    def verify(self, msg, partials):
        t0 = time.perf_counter()
        with self.card:
            t1 = time.perf_counter()
            try:
                out = self.inner.verify(msg, partials)
            except Exception as e:  # noqa: BLE001 — reported, then raised
                self.errors.append((self.node, repr(e)))
                raise
            t2 = time.perf_counter()
        self.log.append((self.node, msg, list(partials), list(out),
                         t2 - t1, t1 - t0))
        return out


def _take_turns(backend, card):
    """A verify-service handle's device backend whose passes (its dispatch
    and resolve stages, which the service's threads call) take turns on
    the card with the nodes' partial checks."""
    if getattr(backend, "_takes_turns", False):
        return                      # a restarted node's cached handle
    backend._takes_turns = True
    for name in ("dispatch_packed", "resolve_packed"):
        fn = getattr(backend, name, None)
        if fn is None:
            continue

        def in_turn(*a, _fn=fn, **kw):
            with card:
                return _fn(*a, **kw)
        setattr(backend, name, in_turn)


class BeaconNet:
    """n nodes of one t-of-n group in one process, each wired as
    core/beacon_process.py:395-440 wires a daemon: its own VerifyService on
    the card (pad `chunk`), partials checked through
    ``partials_factory(device_verifier_factory)`` with no host fallback, a
    SyncChainServer, and a SyncManager over the service's handle whose
    fetch streams from a peer's server.  Partials travel by synchronous in-process delivery
    (tests/torch_beacon_harness.py's LocalNetwork, which can drop nodes);
    time is one FakeClock."""

    def __init__(self, scheme, poly, n, t, period, genesis, clock, chunk,
                 seed=b"beacon"):
        from drand_tpu_torch.key import DistPublic, Share, new_group, \
            new_keypair
        self.scheme, self.poly, self.n, self.t = scheme, poly, n, t
        self.period, self.clock, self.chunk = period, clock, chunk
        self.net = _beacon_harness().LocalNetwork()
        pairs = [new_keypair(f"node{i}", scheme, seed=seed + b"%d" % i)
                 for i in range(n)]
        self.group = new_group([p.public for p in pairs], t, genesis=genesis,
                               period=period,
                               catchup_period=max(1, period // 2),
                               scheme=scheme)
        pub = poly.commit(scheme.key_group)
        self.commits = [scheme.key_group.to_bytes(c) for c in pub.commits]
        self.group.public_key = DistPublic(self.commits)
        self.pk = self.commits[0]
        self.shares = {i: Share(scheme=scheme, private=poly.eval(i),
                                commits=self.commits) for i in range(n)}
        self.nodes, self.services = {}, {}
        self.log, self.errors = [], []
        self.card = threading.Lock()
        self._streams = 0           # a stream's remote address is unique,
        self._lock = threading.Lock()   # as a connection's port is

    def add(self, i, store):
        """Build node i over `store` (its service survives a restart)."""
        from types import SimpleNamespace
        from drand_tpu_torch.beacon import Handler, HandlerConfig
        from drand_tpu_torch.beacon.node import device_verifier_factory
        from drand_tpu_torch.beacon.sync import SyncChainServer, SyncManager
        from drand_tpu_torch.crypto.verify_service import VerifyService
        svc = self.services.get(i)
        if svc is None:
            svc = self.services[i] = VerifyService(pad=self.chunk)
        node = SimpleNamespace(index=i, svc=svc, store=store, syncm=None)

        def on_sync_needed(target, node=node):
            if node.syncm is not None:
                node.syncm.send_sync_request(target)

        timed = lambda s, p, k, i=i: _Timed(  # noqa: E731
            device_verifier_factory(s, p, k), self.card, self.log, i,
            self.errors)
        node.handler = Handler(HandlerConfig(
            group=self.group, share=self.shares[i], index=i, store=store,
            clock=self.clock, verifier_factory=svc.partials_factory(timed),
            broadcast=self.net.broadcaster(i),
            on_sync_needed=on_sync_needed))
        node.handle = svc.handle(self.scheme, self.pk)
        _take_turns(node.handle.backend, self.card)
        node.server = SyncChainServer(node.handler.chain)
        node.syncm = SyncManager(
            node.handler.chain, self.scheme, self.pk, self.period,
            self.clock, fetch=self.fetch_for(i),
            peers=[j for j in range(self.n) if j != i], chunk=self.chunk,
            verifier=node.handle)
        node.syncm.start()
        with self._lock:
            self.nodes[i] = node
        self.net.register(i, node.handler)
        return node

    def fetch_for(self, i):
        def fetch(peer, from_round):
            with self._lock:
                nd = self.nodes.get(peer)
                if nd is None or peer in self.net.down:
                    raise ConnectionError(f"node{peer} is down")
                self._streams += 1
                remote = f"node{i}:{self._streams}"
            return _beacon_harness().PeerStream(nd.server, remote, from_round)
        return fetch

    def forge(self, round_, prev):
        """Signer BEACON_FORGER's partial for `round_` carrying the next
        signer's signature (a valid index and point, the wrong share),
        delivered to every other node before the round's tick, so it is
        each cache's first partial of the round.  Returns its bytes."""
        from drand_tpu_torch.beacon.node import PartialBeaconPacket
        from drand_tpu_torch.crypto.host import tbls
        f = BEACON_FORGER
        msg = self.scheme.digest_beacon(round_, prev)
        other = tbls.sign_partial(self.scheme, self.poly.eval(f + 1), msg)
        forged = f.to_bytes(2, "big") + other[2:]
        self.net.broadcaster(f)(PartialBeaconPacket(
            round=round_, previous_signature=prev, partial_sig=forged))
        return forged

    def wait(self, i, round_):
        """Node i's beacon of `round_`; fails at a partial check that
        raised (no fallback: nothing retries it) or after BEACON_WAIT_S."""
        chain = self.nodes[i].handler.chain
        deadline = time.perf_counter() + BEACON_WAIT_S
        while True:
            b = chain.wait_for_round(round_, 1.0)
            if b is not None:
                return b
            if self.errors or time.perf_counter() > deadline:
                heads = {j: nd.handler.chain.last().round
                         for j, nd in self.nodes.items()
                         if j not in self.net.down}
                fail(f"beacon: node {i} did not store round {round_}: "
                     f"check errors {self.errors[:3]}, heads {heads}, "
                     f"services {self.stats()}, last checks "
                     f"{[(nd, len(p), v, round(w, 2)) for nd, _, p, v, w, _ in self.log[-5:]]}")

    def kill(self, i):
        self.net.kill(i)
        nd = self.nodes[i]
        nd.syncm.stop()
        nd.handler.stop()

    def chains(self, upto):
        """Every node's stored (round, signature) rows 0..upto."""
        out = {}
        for i, nd in sorted(self.nodes.items()):
            out[i] = [(b.round, bytes(b.signature))
                      for b in nd.handler.chain.backend.cursor()
                      if b.round <= upto]
        return out

    def stats(self):
        """The services' stats summed over the nodes."""
        keys = ("submitted", "dispatches", "preemptions", "failovers",
                "promotions", "watchdog_trips", "host_served")
        tot = {k: 0 for k in keys}
        states = []
        for svc in self.services.values():
            st = svc.stats()
            for k in keys:
                tot[k] += st[k]
            states += list(st["backends"].values())
        tot["backends_not_healthy"] = sum(s != "healthy" for s in states)
        return tot

    def stop(self):
        for i, nd in self.nodes.items():
            if i not in self.net.down:
                nd.syncm.stop()
                nd.handler.stop()
        for svc in self.services.values():
            svc.stop()


def beacon_phases(ctx):
    """The beacon phases (module doc): beacon_quicknet and beacon_default.
    Returns {"paths": {path: (launches, shapes)}, "walls": {...}}; the
    paths' shapes join phase 4."""
    import shutil
    import tempfile
    torch, K, B = ctx["torch"], ctx["K"], ctx["B"]
    schemes, HT, R, rng = ctx["schemes"], ctx["HT"], ctx["R"], ctx["rng"]
    name, smi_line = ctx["name"], ctx["smi_line"]
    n, t, head = N_NODES, THRESHOLD, BEACON_CHAIN
    live, chunk = BEACON_LIVE, BEACON_CHUNK
    from drand_tpu_torch.beacon.chainstore import HostPartialVerifier
    from drand_tpu_torch.beacon.clock import FakeClock
    from drand_tpu_torch.chain import (Beacon, MemDBStore, SqliteStore,
                                       genesis_beacon, time_of_round)
    from drand_tpu_torch.chain.integrity import (INVALID_SIG, MISSING,
                                                 UNLINKED)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_beacon_")
    paths, walls = {}, {}

    def rnd():
        return int.from_bytes(rng.bytes(32), "big") % (R - 1) + 1

    def snapshot(path, passes0):
        torch.cuda.synchronize()
        after = B.pass_counts()
        paths[path] = (dict(K.LAUNCHES), dict(K.SHAPES))
        return {k: after[k] - passes0[k] for k in after}

    def one_aggregation(net, round_, prev):
        """One aggregation of t partials on node 0, stage by stage: its
        device check (the node's verifier, through its service's LIVE
        lane), the host's Lagrange recovery and verify_beacon, and the
        reference's per-packet host check of the same partials."""
        sch = net.scheme
        msg = sch.digest_beacon(round_, prev)
        parts = [HT.sign_partial(sch, net.poly.eval(i), msg)
                 for i in range(t)]
        nd = net.nodes[0]
        pv = nd.handler.chain.partial_verifier
        pub = nd.handler.vault.get_pub()
        pv.verify(msg, parts)
        out = {}
        t0 = time.perf_counter()
        ok = pv.verify(msg, parts)
        out["device_check_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sig = HT.recover(sch, pub, msg, parts, t, n, verify_each=False)
        out["host_recover_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ok_b = sch.verify_beacon(net.pk, round_, prev, sig)
        out["host_verify_beacon_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ok_h = HostPartialVerifier(sch, pub).verify(msg, parts)
        out["host_per_packet_check_s"] = time.perf_counter() - t0
        out["host_s"] = out["host_recover_s"] + out["host_verify_beacon_s"]
        out["all_valid"] = bool(all(ok) and ok_b and all(ok_h))
        return out

    def forged_seen(log, forged):
        """{node: verdicts} of the checks that held the forged partial."""
        seen = {}
        for node, _, parts, verdicts, *_ in log:
            for p, v in zip(parts, verdicts):
                if p == forged:
                    seen.setdefault(node, []).append(bool(v))
        return seen

    def check_common(log, chains, upto, forged, passes, st):
        rows = list(range(upto + 1))
        agree = len({tuple(c) for c in chains.values()}) == 1 \
            and all([r for r, _ in c] == rows for c in chains.values())
        seen = forged_seen(log, forged)
        dropped = bool(seen) and all(v == [False] for v in seen.values())
        lat = sorted(w for *_, w, _ in log)
        waits = sorted(w for *_, w in log)
        health = {k: st[k] for k in ("failovers", "watchdog_trips",
                                     "host_served", "backends_not_healthy")}
        out = {"nodes_agree_byte_for_byte": agree,
               "forged_partial_checked_on_nodes": len(seen),
               "forged_partial_dropped": dropped,
               "partial_checks": len(log),
               "partial_check_s_p50": float(np.median(lat)) if lat else None,
               "partial_check_s_max": lat[-1] if lat else None,
               "card_wait_s_p50": float(np.median(waits)) if waits
               else None,
               "card_wait_s_max": waits[-1] if waits else None,
               "passes": passes, "service": st}
        bad = [] if agree else ["the nodes' chains differ"]
        if not dropped or len(seen) < n - 2:
            bad.append(f"forged partial: {seen}")
        if any(health.values()):
            bad.append(f"the services fell back or tripped: {health}")
        if passes["exact"] < 1:
            bad.append(f"no exact pass dropped the forgery: {passes}")
        return out, bad

    def quicknet():
        live = QUICKNET_LIVE
        sch = schemes.scheme_from_name(schemes.SHORT_SIG_SCHEME_ID)
        poly = HT.PriPoly([rnd() for _ in range(t)])
        clock = FakeClock(time_of_round(QUICKNET_PERIOD, QUICKNET_GENESIS,
                                        head + 1))
        net = BeaconNet(sch, poly, n, t, QUICKNET_PERIOD, QUICKNET_GENESIS,
                        clock, chunk, seed=b"quicknet")
        t0 = time.perf_counter()
        msgs = [sch.digest_beacon(r) for r in range(1, head + 1)]
        sigs = B.sign_batch(sch, poly.secret(), msgs)
        torch.cuda.synchronize()
        sign_s = time.perf_counter() - t0
        for i in sorted({0, head // 2, head - 1}):
            if sigs[i] != sch.sign(poly.secret(), msgs[i]):
                fail(f"beacon_quicknet: sign_batch disagrees with the host "
                     f"at round {i + 1}")
        seed = net.group.get_genesis_seed()
        late = n - 1
        stores = []
        for i in range(late):
            s = MemDBStore(buffer_size=head + live + 64)
            s.put(genesis_beacon(seed))
            s.put_many(Beacon(round=r, signature=g)
                       for r, g in zip(range(1, head + 1), sigs))
            stores.append(s)
        stores.append(SqliteStore(os.path.join(tmp, "quicknet.db")))
        torch.cuda.synchronize()
        K.reset_launches()
        passes0 = B.pass_counts()
        t0 = time.perf_counter()
        for i in range(n):
            net.add(i, stores[i])
        build_s = time.perf_counter() - t0
        caught = []
        watcher = threading.Thread(target=lambda: caught.append(
            (net.nodes[late].handler.chain.wait_for_round(head,
                                                          BEACON_WAIT_S),
             time.perf_counter())))
        t_start = time.perf_counter()
        net.nodes[late].handler.catchup()
        watcher.start()
        for i in range(late):
            net.nodes[i].handler.start()
        round_walls, forged = [], None
        for k in range(1, live + 1):
            r = head + k
            t_tick = t_start
            if k > 1:
                if k == live:
                    forged = net.forge(r, None)
                t_tick = time.perf_counter()
                clock.advance(QUICKNET_PERIOD)
            for i in range(late):
                net.wait(i, r)
            round_walls.append(time.perf_counter() - t_tick)
        watcher.join(BEACON_WAIT_S)
        if not caught or caught[0][0] is None:
            fail(f"beacon_quicknet: node {late} did not catch up to {head}")
        catchup_s = caught[0][1] - t_start
        net.wait(late, head + live)
        all_s = time.perf_counter() - t_start
        passes = snapshot("beacon_quicknet", passes0)
        st = net.stats()
        chains = net.chains(head + live)
        log = list(net.log)
        split = one_aggregation(net, head + live + 1, None)
        net.stop()
        out, bad = check_common(log, chains, head + live, forged, passes, st)
        got = [g for r, g in chains[0]]
        same = got[1:head + 1] == sigs
        v = B.BatchBeaconVerifier(sch, net.pk)
        rounds = list(range(1, head + live + 1))
        ok_dev = bool(v.verify_batch(rounds[:head], got[1:head + 1]).all()) \
            and bool(v.verify_batch(rounds[head:], got[head + 1:]).all())
        host_rounds = [1, head] + rounds[head:]
        ok_host = all(sch.verify_beacon(net.pk, r, None, got[r])
                      for r in host_rounds)
        if not same:
            bad.append("the stored chain differs from sign_batch's")
        if not (ok_dev and ok_host):
            bad.append(f"stored beacons fail to verify: device {ok_dev}, "
                       f"host {ok_host}")
        if split["all_valid"] is not True:
            bad.append(f"the one-aggregation split: {split}")
        launches = paths["beacon_quicknet"][0]
        if any(launches[k] == 0 for k in G1_RLC_KERNELS):
            bad.append(f"a kernel of the path was not launched: {launches}")
        walls["beacon_quicknet"] = all_s
        emit({"phase": "beacon_quicknet", "scheme": sch.id, "nodes": n,
              "threshold": t, "chain_rounds": head, "live_rounds": live,
              "sync_chunk": chunk, "late_node_store": "sqlite",
              "switch_interval_s": sys.getswitchinterval(),
              "forged_at_round": head + live,
              "sign_batch_s": sign_s, "nodes_build_s": build_s,
              "catch_up_s": catchup_s,
              "catch_up_rounds_per_s": head / catchup_s,
              "round_wall_s": round_walls,
              "round_wall_s_p50": float(np.median(round_walls)),
              "round_wall_s_max": max(round_walls), "wall_s": all_s,
              "one_aggregation": split, "chain_equals_sign_batch": same,
              "verify_batch_all_valid": ok_dev,
              "host_verify_beacon_rounds": host_rounds,
              "host_verify_beacon_all_valid": ok_host, **out,
              "launches": launches, "device": name, "nvidia_smi": smi_line})
        if bad:
            fail(f"beacon_quicknet: {bad}")

    def default():
        sch = schemes.scheme_from_name(schemes.DEFAULT_SCHEME_ID)
        poly = HT.PriPoly([rnd() for _ in range(t)])
        period = DEFAULT_PERIOD
        clock = FakeClock(DEFAULT_GENESIS - period)
        net = BeaconNet(sch, poly, n, t, period, DEFAULT_GENESIS, clock,
                        chunk, seed=b"default")
        late = n - 1
        db = os.path.join(tmp, "default.db")
        stores = [MemDBStore(buffer_size=100) for _ in range(late)] \
            + [SqliteStore(db)]
        torch.cuda.synchronize()
        K.reset_launches()
        passes0 = B.pass_counts()
        t_start = time.perf_counter()
        for i in range(n):
            net.add(i, stores[i])
        for nd in net.nodes.values():
            nd.handler.start()
        round_walls, forged = [], None

        def tick(r, nodes):
            nonlocal forged
            prev = net.nodes[0].handler.chain.last().signature
            if r == BEACON_FORGE_AT:
                forged = net.forge(r, prev)
            t_tick = time.perf_counter()
            clock.set_time(time_of_round(period, DEFAULT_GENESIS, r))
            for i in nodes:
                net.wait(i, r)
            round_walls.append(time.perf_counter() - t_tick)

        # `live` rounds from genesis: the sqlite node is down for
        # BEACON_DOWN of them, then revived, and the last runs with all
        everyone = list(range(n))
        down_from = live - BEACON_DOWN
        for r in range(1, down_from):
            tick(r, everyone)
        net.kill(late)
        for r in range(down_from, live):
            tick(r, everyone[:late])
        t0 = time.perf_counter()
        nd = net.add(late, SqliteStore(db))
        nd.handler.catchup()
        net.wait(late, live - 1)
        revive_s = time.perf_counter() - t0
        head_d = live
        tick(head_d, everyone)
        # at-rest faults on the revived node's sqlite store, then a full
        # scan on the card, heal from the peers, and a second scan
        raw = nd.handler.chain.backend
        flip_r, del_r = 1, head_d - 1
        peer_rows = {r: net.nodes[0].handler.chain.backend.get(r).signature
                     for r in (flip_r, del_r)}
        b = raw.get(flip_r)
        sig = bytearray(b.signature)
        sig[len(sig) // 3] ^= 0x01
        raw.delete(flip_r)
        raw.put(Beacon(round=flip_r, signature=bytes(sig)))
        raw.delete(del_r)
        t0 = time.perf_counter()
        report = nd.handler.chain.integrity_scan(
            verifier=nd.handle, mode="full", chunk=chunk, trigger="manual")
        left = nd.syncm.heal(raw, report, peers=everyone[:late])
        again = nd.handler.chain.integrity_scan(
            verifier=nd.handle, mode="full", chunk=chunk, trigger="manual")
        scan_heal_s = time.perf_counter() - t0
        all_s = time.perf_counter() - t_start
        passes = snapshot("beacon_default", passes0)
        st = net.stats()
        chains = net.chains(head_d)
        log = list(net.log)
        split = one_aggregation(net, head_d + 1, chains[0][-1][1])
        net.stop()
        found = [(f.round, f.kind) for f in report.findings]
        want = [(flip_r, INVALID_SIG)] + \
            [(flip_r + 1, UNLINKED)] * (flip_r + 1 < del_r) + \
            [(del_r, MISSING), (del_r + 1, UNLINKED)]
        restored = {r: dict(chains[late]).get(r) == peer_rows[r]
                    for r in peer_rows}
        out, bad = check_common(log, chains, head_d, forged, passes, st)
        got = [g for r, g in chains[0]]
        rounds = list(range(1, head_d + 1))
        prevs = [net.group.get_genesis_seed()] + got[1:-1]
        v = B.BatchBeaconVerifier(sch, net.pk)
        ok_dev = bool(v.verify_batch(rounds, got[1:], prevs).all())
        ok_host = all(sch.verify_beacon(net.pk, r, p, g)
                      for r, p, g in zip(rounds, prevs, got[1:]))
        if found != want or left or not again.clean \
                or not all(restored.values()):
            bad.append(f"scan and heal: found {found} (want {want}), left "
                       f"{left}, second scan clean {again.clean}, restored "
                       f"{restored}")
        if not (ok_dev and ok_host):
            bad.append(f"stored beacons fail to verify: device {ok_dev}, "
                       f"host {ok_host}")
        if split["all_valid"] is not True:
            bad.append(f"the one-aggregation split: {split}")
        launches = paths["beacon_default"][0]
        if any(launches[k] == 0 for k in G2_RLC_KERNELS):
            bad.append(f"a kernel of the path was not launched: {launches}")
        walls["beacon_default"] = all_s
        emit({"phase": "beacon_default", "scheme": sch.id, "nodes": n,
              "threshold": t, "rounds": head_d, "down_node_store": "sqlite",
              "down_rounds": [down_from, live - 1],
              "forged_at_round": BEACON_FORGE_AT,
              "round_wall_s": round_walls,
              "round_wall_s_p50": float(np.median(round_walls)),
              "round_wall_s_max": max(round_walls),
              "revive_catch_up_s": revive_s,
              "scan_heal_s": scan_heal_s, "scan_findings": found,
              "heal_left": left, "second_scan_clean": again.clean,
              "restored_peer_bytes": restored, "wall_s": all_s,
              "one_aggregation": split, "verify_batch_all_valid": ok_dev,
              "host_verify_beacon_all_valid": ok_host, **out,
              "launches": launches, "device": name, "nvidia_smi": smi_line})
        if bad:
            fail(f"beacon_default: {bad}")

    switch = sys.getswitchinterval()
    sys.setswitchinterval(BEACON_SWITCH_S)
    try:
        quicknet()
        default()
    finally:
        sys.setswitchinterval(switch)
        shutil.rmtree(tmp, ignore_errors=True)
    return {"paths": paths, "walls": walls}


# ---------------------------------------------------------------------------
# The edge phase: the port's public edge (http_server.py, client/, relay.py)
# serving a chained chain, and strict clients catching up through it
# ---------------------------------------------------------------------------

EDGE_ROUNDS = 1024           # 8.5 h of the League of Entropy default chain
EDGE_CLIENTS = 4             # strict clients walking the span at once
EDGE_FORGED = 700            # the forged pair: rounds 700 and 701
EDGE_RELAY_ROUNDS = 16       # rounds the object-store relay uploads (64
                             # before the daemon phase came)
EDGE_SIGN_PROBE = 4          # rounds signed both ways to pick the signer


def _edge_chain_on_host(n, genesis, period):
    """The edge chain's signatures by the host signer, in round order, and
    the seconds they took.  Runs in a process of its own (start_edge_chain),
    so the signing overlaps the beacon phases."""
    t0 = time.perf_counter()
    chain = _beacon_harness().MockChain(n=n, genesis=genesis, period=period)
    return ([chain.beacons[r].signature for r in range(1, n + 1)],
            time.perf_counter() - t0)


def start_edge_chain():
    """(executor, future of _edge_chain_on_host) in one spawned process;
    edge_phases takes the result and shuts the executor down."""
    import concurrent.futures
    import multiprocessing
    ex = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    return ex, ex.submit(_edge_chain_on_host, EDGE_ROUNDS, DEFAULT_GENESIS,
                         DEFAULT_PERIOD)


def edge_phases(ctx):
    """The edge phases (module doc): edge_walk, edge_four_walks and
    edge_forged, then /health and the relays.  Returns {"paths": {path:
    (launches, shapes)}, "walls": {...}}; the paths' shapes join phase 4."""
    import shutil
    import tempfile
    import urllib.error
    import urllib.request
    torch, K, B, schemes = ctx["torch"], ctx["K"], ctx["B"], ctx["schemes"]
    name, smi_line = ctx["name"], ctx["smi_line"]
    from drand_tpu_torch.beacon.clock import FakeClock
    from drand_tpu_torch.chain import (Beacon, SqliteStore, genesis_beacon,
                                       time_of_round)
    from drand_tpu_torch.client import (From, HttpTransport, insecurely,
                                        new_client, with_chain_hash,
                                        with_full_chain_verification)
    from drand_tpu_torch.crypto import verify_service as VS
    from drand_tpu_torch.http_server import RestServer, _beacon_json
    from drand_tpu_torch.net.admission import AdmissionController
    from drand_tpu_torch.relay import (DirObjectStore, HttpRelay,
                                       ObjectStoreRelay)
    H = _beacon_harness()
    sch = schemes.scheme_from_name(schemes.DEFAULT_SCHEME_ID)
    n, r_bad = EDGE_ROUNDS, EDGE_FORGED
    tmp = tempfile.mkdtemp(prefix="chip_smoke_edge_")
    paths, walls, out, bad = {}, {}, {}, []

    class TimedHttp(HttpTransport):
        """The HTTP transport with its gets' wall summed: the walk's fetch
        part."""
        fetch_s, gets = 0.0, 0

        def get(self, round_=0):
            t0 = time.perf_counter()
            try:
                return super().get(round_)
            finally:
                self.fetch_s += time.perf_counter() - t0
                self.gets += 1

    # -- the chain: signed one round a call (a chained round's message
    # holds the previous signature), by the host or by a 1-lane sign_batch,
    # whichever signed EDGE_SIGN_PROBE rounds faster; the host's signatures
    # come from the process start_edge_chain began before the beacon phases
    sk, _ = sch.keypair(seed=b"client-mock")   # MockChain's key
    probe = [sch.digest_beacon(r, b"\x07" * 32) for r in
             range(1, EDGE_SIGN_PROBE + 1)]
    t0 = time.perf_counter()
    host_sigs = [sch.sign(sk, m) for m in probe]
    host_s = (time.perf_counter() - t0) / len(probe)
    B.sign_batch(sch, sk, probe[:1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_sigs = [B.sign_batch(sch, sk, [m])[0] for m in probe]
    torch.cuda.synchronize()
    card_s = (time.perf_counter() - t0) / len(probe)
    if card_sigs != host_sigs:
        fail("edge: a 1-lane sign_batch disagrees with the host signer")
    ex, signed = ctx["edge_chain"]
    t0 = time.perf_counter()
    if card_s < host_s:
        signer, sign_s = "sign_batch, 1 lane", None
        signed.cancel()
        sign = lambda m: B.sign_batch(sch, sk, [m])[0]  # noqa: E731
    else:
        signer = "host Scheme.sign, in a process of its own"
        host_chain, sign_s = signed.result(BEACON_WAIT_S)
        sign = lambda m, it=iter(host_chain): next(it)  # noqa: E731
    ex.shutdown(wait=True)
    chain = H.MockChain(n=n, genesis=DEFAULT_GENESIS, period=DEFAULT_PERIOD,
                        sign=sign)
    torch.cuda.synchronize()
    chain_wait_s = time.perf_counter() - t0
    if sign_s is None:
        sign_s = chain_wait_s
    info, h = chain.info, chain.info.hash_string()

    def serve(beacons, db):
        """A sqlite store (trimmed rows: a round's previous signature is
        read from the row before) behind the port's RestServer, with an
        admission controller, on a clock at the head round's time."""
        store = SqliteStore(os.path.join(tmp, db), require_previous=True)
        store.put(genesis_beacon(info.genesis_seed))
        store.put_many(beacons[r] for r in sorted(beacons))
        bp = H.ShimProcess.of_store(info, store)
        server = RestServer(
            H.ShimDaemon(bp), "127.0.0.1:0",
            clock=FakeClock(time_of_round(info.period, info.genesis_time,
                                          n)),
            admission=AdmissionController())
        server.start()
        return server, bp, store, f"http://127.0.0.1:{server.port}"

    def strict_client(url):
        tr = TimedHttp(url)
        return tr, new_client(From(tr), with_chain_hash(h),
                              with_full_chain_verification())

    def fetch(url, path):
        try:
            with urllib.request.urlopen(url + path, timeout=60) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def begin():
        torch.cuda.synchronize()
        K.reset_launches()
        return B.pass_counts(), svc.stats()

    def end(path, before):
        torch.cuda.synchronize()
        passes0, st0 = before
        paths[path] = (dict(K.LAUNCHES), dict(K.SHAPES))
        after, st = B.pass_counts(), svc.stats()
        delta = {k: st[k] - st0[k] for k in ("submitted", "dispatches",
                                              "dispatch_lanes",
                                              "host_served", "preemptions",
                                              "failovers", "watchdog_trips")}
        delta["device_time_s"] = st["device_time_s"] - st0["device_time_s"]
        missing = [k for k in G2_RLC_KERNELS if paths[path][0][k] == 0]
        if missing:
            bad.append(f"{path}: kernels of the path not launched: "
                       f"{missing}")
        if delta["host_served"] or delta["failovers"] \
                or delta["watchdog_trips"]:
            bad.append(f"{path}: served on the host or failed over: "
                       f"{delta}")
        if delta["dispatches"] < 1:
            bad.append(f"{path}: no device dispatch: {delta}")
        return {k: after[k] - passes0[k] for k in after}, delta

    # the process-default verify service on the card, as a client makes it
    old_svc = VS.set_service(None)
    svc = VS.get_service()
    server, bp, store, url = serve(chain.beacons, "edge.db")
    fserver = fbp = None
    try:
        # -- edge_walk: one strict client, get(n) from no trust ------------
        before = begin()
        tr, client = strict_client(url)
        t0 = time.perf_counter()
        res = client.get(n)
        wall = time.perf_counter() - t0
        passes, st = end("edge_walk", before)
        ok = res.round == n and res.randomness == \
            chain.beacons[n].randomness()
        out["edge_walk"] = {
            "rounds": n, "all_valid": ok, "http_gets": tr.gets,
            "fetch_s": tr.fetch_s, "sweep_s": wall - tr.fetch_s,
            "wall_s": wall, "rounds_per_s": n / wall,
            "sweep_rounds_per_s": n / (wall - tr.fetch_s),
            "passes": passes, "service": st,
            "service_summary": svc.summary()}
        if not ok or passes != {"rlc": 1, "exact": 0} \
                or tr.gets != n:
            bad.append(f"edge_walk: result {res.round}, valid {ok}, "
                       f"passes {passes}, http gets {tr.gets}")
        walls["edge_walk"] = wall

        # -- edge_four_walks: EDGE_CLIENTS strict clients at once ----------
        before = begin()
        results, errors = [None] * EDGE_CLIENTS, []

        def walk(i):
            try:
                results[i] = strict_client(url)[1].get(n)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))

        threads = [threading.Thread(target=walk, args=(i,))
                   for i in range(EDGE_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        wall4 = time.perf_counter() - t0
        passes4, st4 = end("edge_four_walks", before)
        ok4 = not errors and all(
            r is not None and r.round == n and r.randomness ==
            chain.beacons[n].randomness() for r in results)
        out["edge_four_walks"] = {
            "clients": EDGE_CLIENTS, "all_valid": ok4, "errors": errors,
            "wall_s": wall4, "rounds_per_s": EDGE_CLIENTS * n / wall4,
            "dispatches": st4["dispatches"], "passes": passes4,
            "service": st4}
        if not ok4:
            bad.append(f"edge_four_walks: {errors or results}")
        walls["edge_four_walks"] = wall4

        # -- edge_forged: round r's signature and round r+1's previous
        # signature (the row before it, in the trimmed store) the same
        # forged bytes: linkage holds, the sweep must name the pair
        forged = chain.forged_pair(r_bad)
        fserver, fbp, fstore, furl = serve(forged, "forged.db")
        linked = fstore.get(r_bad + 1).previous_sig == \
            forged[r_bad].signature
        before = begin()
        ftr, fclient = strict_client(furl)
        t0 = time.perf_counter()
        try:
            fclient.get(n)
            named = None
        except ValueError as e:
            named = str(e)
        fwall = time.perf_counter() - t0
        fpasses, fst = end("edge_forged", before)
        want = f"invalid signatures at rounds {[r_bad, r_bad + 1]}"
        out["edge_forged"] = {
            "forged_rounds": [r_bad, r_bad + 1], "linked": linked,
            "error": named, "named_exactly": named == want,
            "fetch_s": ftr.fetch_s, "sweep_s": fwall - ftr.fetch_s,
            "wall_s": fwall, "passes": fpasses, "service": fst}
        if named != want or not linked or fpasses["exact"] < 1:
            bad.append(f"edge_forged: raised {named!r} (want {want!r}), "
                       f"linked {linked}, passes {fpasses}")
        walls["edge_forged"] = fwall

        # -- /health: the service's summary, its dispatches included -------
        code, body = fetch(url, "/health")
        health = json.loads(body)
        dispatches = svc.stats()["dispatches"]
        out["health"] = {"status": code, "verify": health.get("verify"),
                         "ready": health.get("ready")}
        if code != 200 or not str(health.get("verify", "")).startswith(
                f"dispatches={dispatches} "):
            bad.append(f"/health: {code} {health}")

        # -- the relays: an HttpRelay over a (verifying) client of the
        # edge, and an ObjectStoreRelay uploading EDGE_RELAY_ROUNDS rounds
        # (it verifies each round itself, so its client does not)
        t0 = time.perf_counter()
        relay = HttpRelay(new_client(From(HttpTransport(url)),
                                     with_chain_hash(h)))
        relay.start()
        rurl = f"http://127.0.0.1:{relay.port}"
        try:
            mid = n // 2
            relay_eq = {
                p: fetch(rurl, p) == (200, _beacon_json(store.get(r)))
                for p, r in ((f"/public/{mid}", mid),
                             ("/public/latest", n),
                             (f"/{h}/public/{r_bad}", r_bad))}
        finally:
            relay.stop()
        http_relay_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        objects = DirObjectStore(os.path.join(tmp, "bucket"))
        osr = ObjectStoreRelay(new_client(From(HttpTransport(url)),
                                          with_chain_hash(h), insecurely()),
                               objects)
        lo = n - EDGE_RELAY_ROUNDS + 1
        uploaded = osr.sync(lo, n)
        read_back = all(objects.get(f"{info.hash().hex()}/public/{r}")
                        == _beacon_json(store.get(r))
                        for r in range(lo, n + 1))
        object_relay_s = time.perf_counter() - t0
        out["relays"] = {"http_relay_bytes_equal": relay_eq,
                         "http_relay_s": http_relay_s,
                         "object_store_uploaded": uploaded,
                         "object_store_read_back_equal": read_back,
                         "object_store_s": object_relay_s}
        if not all(relay_eq.values()) or uploaded != EDGE_RELAY_ROUNDS \
                or not read_back:
            bad.append(f"relays: {out['relays']}")
    finally:
        server.stop()
        bp.handler.chain.stop()
        if fserver is not None:
            fserver.stop()
            fbp.handler.chain.stop()
        svc.stop()
        VS.set_service(old_svc)
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "edge", "scheme": sch.id, "chain_rounds": n,
          "period_s": DEFAULT_PERIOD, "store": "sqlite",
          "signer": signer, "sign_host_s_per_round": host_s,
          "sign_batch_1_lane_s_per_round": card_s, "chain_sign_s": sign_s,
          "chain_wait_s": chain_wait_s,
          **out, "launches": {p: v[0] for p, v in paths.items()},
          "device": name, "nvidia_smi": smi_line})
    if bad:
        fail(f"edge: {bad}")
    return {"paths": paths, "walls": walls}


# ---------------------------------------------------------------------------
# The daemon phase: four port daemons, each a process of its own started by
# the port's CLI, over real gRPC on localhost
# ---------------------------------------------------------------------------

DAEMON_N, DAEMON_T = 4, 3    # t = 3 of n = 4
DAEMON_PERIOD = 3            # the League of Entropy quicknet's period (s)
DAEMON_LIVE = 5              # live rounds every daemon stores from genesis
DAEMON_DOWN = 2              # rounds the network makes while one is down
DAEMON_AFTER = 2             # live rounds the restarted daemon stores
DAEMON_DKG_TIMEOUT = 5       # a DKG phase's timeout in seconds: the genesis
                             # is 3 of them and a second after the group, past
                             # the DKG's end (some 15 s of host crypto), so
                             # round 1 is on time
DAEMON_WAIT_S = 120          # real seconds any one wait of the phase may take
DAEMON_SECRET = b"chip-smoke-daemon-quicknet"
DAEMON_CHECK_ROUND = 2       # the stored round the in-process check redoes
# the kernels each in-process path of the phase must launch: a verify pass
# under 64 rounds hashes on the host (no H1)
_G1_PASS = tuple(k for k in G1_RLC_KERNELS if k != "hash_to_field")
DAEMON_KERNELS = {"daemon_rounds": _G1_PASS, "daemon_check": _G1_PASS}


def _prom(text):
    """{(name, ((label, value), ...)): value} of a Prometheus text scrape."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, _, val = line.rpartition(" ")
        name, _, rest = head.partition("{")
        labels = tuple(sorted(
            tuple(kv.split("=", 1)) for kv in
            re.findall(r'[a-zA-Z_]+="[^"]*"', rest)))
        labels = tuple((k, v.strip('"')) for k, v in labels)
        out[(name, labels)] = float(val)
    return out


def _series(scrape, name, **want):
    """The samples of `name` whose labels hold `want`."""
    return [v for (n, labels), v in scrape.items() if n == name
            and all((k, str(w)) in labels for k, w in want.items())]


def _hist_quantile(scrape, name, q):
    """The upper bound of the bucket holding quantile q of a histogram
    summed over its label sets (None when it has no samples)."""
    by_le = {}
    for (n, labels), v in scrape.items():
        if n == name + "_bucket":
            le = float(dict(labels)["le"])
            by_le[le] = by_le.get(le, 0.0) + v
    total = max(by_le.values(), default=0.0)
    if not total:
        return None
    for le in sorted(by_le):
        if by_le[le] >= q * total:
            return le
    return None


def daemon_phases(ctx):
    """The daemon_quicknet phase (module doc).  Returns {"paths": {path:
    (launches, shapes)}, "walls": {...}}; the in-process paths' shapes join
    phase 4.  Any failed check, or a daemon that exits non-zero, prints
    that daemon's log tail and fails the script."""
    import shutil
    import socket
    import tempfile
    import urllib.request
    torch, K, B, schemes, HT = (ctx["torch"], ctx["K"], ctx["B"],
                                ctx["schemes"], ctx["HT"])
    name, smi_line = ctx["name"], ctx["smi_line"]
    from drand_tpu_torch.beacon.chainstore import DevicePartialVerifier
    from drand_tpu_torch.client import GrpcTransport, VerifyingClient
    from drand_tpu_torch.crypto import verify_service as VS
    from drand_tpu_torch.key.store import FileStore
    from drand_tpu_torch.net import ControlClient, Peer, ProtocolClient
    from drand_tpu_torch.net import convert
    from drand_tpu_torch.protos import drand_pb2 as pb
    sch = schemes.scheme_from_name(schemes.SHORT_SIG_SCHEME_ID)
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_daemons_")
    # a peer's breaker on the stopped daemon probes it again after one
    # period (net/resilience.py's default cooldown is 30 s), so the
    # restarted daemon gets partials again within a round or two
    env = dict(os.environ, DRAND_BREAKER_COOLDOWN=str(DAEMON_PERIOD),
               PYTHONPATH=os.pathsep.join(
                   p for p in (root, os.environ.get("PYTHONPATH")) if p))
    cli = [sys.executable, "-m", "drand_tpu_torch.cli"]
    folders = [os.path.join(tmp, f"d{i}") for i in range(DAEMON_N)]
    ports = []
    for _ in range(DAEMON_N):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    addrs = [f"127.0.0.1:{p}" for p in ports]
    procs, ready, walls, out, paths = {}, {}, {}, {}, {}
    pc = ProtocolClient()
    t_phase = time.perf_counter()

    def log_tail(i, nbytes=6000):
        try:
            with open(os.path.join(tmp, f"d{i}.log"), "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - nbytes))
                return f.read().decode(errors="replace")
        except OSError:
            return ""

    def stop_all():
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)

    def die(msg, i=None):
        """Fail the script: the daemon's log tail first (or every
        daemon's), then every process stopped."""
        for j in ([i] if i is not None else sorted(procs)):
            sys.stderr.write(f"--- daemon {j} ({addrs[j]}) log tail ---\n"
                             + log_tail(j) + "\n")
        sys.stderr.flush()
        stop_all()
        pc.close()
        shutil.rmtree(tmp, ignore_errors=True)
        fail(f"daemon_quicknet: {msg}")

    def alive():
        for i, p in procs.items():
            if p.poll() is not None and i not in down:
                die(f"daemon {i} exited with {p.returncode}", i)

    def spawn(i):
        path = os.path.join(tmp, f"d{i}.ready.json")
        if os.path.exists(path):
            os.unlink(path)
        with open(os.path.join(tmp, f"d{i}.log"), "ab") as log:
            procs[i] = subprocess.Popen(
                cli + ["start", "--folder", folders[i], "--private-listen",
                       addrs[i], "--control", "0", "--metrics", "0",
                       "--dkg-timeout",
                       str(DAEMON_DKG_TIMEOUT), "--ready-file", path],
                cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)

    def wait_ready(i):
        path = os.path.join(tmp, f"d{i}.ready.json")
        deadline = time.monotonic() + DAEMON_WAIT_S
        while not os.path.exists(path):
            if procs[i].poll() is not None:
                die(f"daemon {i} exited with {procs[i].returncode} before "
                    "it was ready", i)
            if time.monotonic() > deadline:
                die(f"daemon {i} not ready in {DAEMON_WAIT_S} s", i)
            time.sleep(0.05)
        with open(path) as f:
            ready[i] = json.load(f)

    def latest(i):
        try:
            return pc.public_rand(Peer(addrs[i]), 0, "default").round
        except Exception:       # noqa: BLE001 — not serving yet
            return 0

    def wait_rounds(target, who):
        """Wait until every daemon in `who` serves round `target`;
        {daemon: time.time() it was first seen serving it}."""
        seen = {}
        deadline = time.monotonic() + DAEMON_WAIT_S
        while len(seen) < len(who):
            alive()
            for i in who:
                if i not in seen and latest(i) >= target:
                    seen[i] = time.time()
            if time.monotonic() > deadline:
                die(f"round {target} not served by "
                    f"{sorted(set(who) - set(seen))} in {DAEMON_WAIT_S} s")
            time.sleep(0.05)
        return seen

    def read_round(r, who):
        got = {i: pc.public_rand(Peer(addrs[i]), r, "default")
               for i in who}
        sigs = {g.signature for g in got.values()}
        if len(sigs) != 1 or any(g.round != r for g in got.values()):
            die(f"round {r} differs between daemons: "
                f"{ {i: g.signature.hex()[:16] for i, g in got.items()} }")
        return got[who[0]].signature

    def scrape(i, private=False, want=()):
        """Daemon i's group registry over the Protocol plane, or with
        `private` the verify service's registry from its own
        MetricsServer; each name in `want` must be registered there."""
        if private:
            url = f"http://127.0.0.1:{ready[i]['metrics']}/metrics/private"
            with urllib.request.urlopen(url, timeout=30) as r:
                text = r.read().decode()
        else:
            text = pc.metrics(Peer(addrs[i])).decode()
        absent = [n for n in want if f"# TYPE {n} " not in text]
        if absent:
            die(f"daemon {i}'s scrape lacks {absent}", i)
        return _prom(text)

    def drive(path, fn):
        """Run an in-process path with the launch counts set to 0 just
        before it and read just after; each kernel of DAEMON_KERNELS[path]
        must have launched."""
        torch.cuda.synchronize()
        K.reset_launches()
        res = fn()
        torch.cuda.synchronize()
        paths[path] = (dict(K.LAUNCHES), dict(K.SHAPES))
        missing = [k for k in DAEMON_KERNELS[path] if not K.LAUNCHES[k]]
        if missing:
            die(f"{path}: kernels of the path not launched: {missing}")
        return res

    down = set()
    try:
        # -- four keypairs of the quicknet scheme, each daemon's address
        t0 = time.perf_counter()
        gens = [subprocess.Popen(
            cli + ["generate-keypair", "--folder", folders[i], "--scheme",
                   sch.id, addrs[i]], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i in range(DAEMON_N)]
        for i, g in enumerate(gens):
            text, _ = g.communicate(timeout=DAEMON_WAIT_S)
            if g.returncode != 0:
                sys.stderr.write(text[-4000:])
                die(f"generate-keypair for daemon {i} exited with "
                    f"{g.returncode}")
        walls["keypairs_s"] = time.perf_counter() - t0
        # -- four daemons, each `python -m drand_tpu_torch.cli start`
        t0 = time.perf_counter()
        for i in range(DAEMON_N):
            spawn(i)
        for i in range(DAEMON_N):
            wait_ready(i)
        walls["start_s"] = time.perf_counter() - t0

        # -- the DKG over the Control plane: one leader, three joiners
        results, errors = [None] * DAEMON_N, []

        def init(i):
            cc = ControlClient(ready[i]["control"])
            info = pb.SetupInfo(leader=i == 0, nodes=DAEMON_N,
                                threshold=DAEMON_T, timeout_seconds=30,
                                secret=DAEMON_SECRET)
            if i:
                info.leader_address = addrs[0]
            req = pb.InitDKGPacket(info=info,
                                   beacon_period_seconds=DAEMON_PERIOD,
                                   schemeID=sch.id,
                                   metadata=convert.metadata("default"))
            deadline = time.monotonic() + 30
            try:
                while True:
                    try:
                        results[i] = cc.stub.init_dkg(req, timeout=120)
                        return
                    except Exception as e:     # noqa: BLE001
                        # a joiner retries until the leader's setup runs
                        if i == 0 or time.monotonic() > deadline:
                            errors.append((i, repr(e)))
                            return
                        time.sleep(0.2)
            finally:
                cc.close()

        t0 = time.perf_counter()
        threads = [threading.Thread(target=init, args=(i,))
                   for i in range(DAEMON_N)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=DAEMON_WAIT_S)
        walls["dkg_s"] = time.perf_counter() - t0
        if errors or any(r is None for r in results):
            die(f"the DKG failed: {errors}")
        groups = [convert.proto_to_group(r) for r in results]
        group_hashes = {g.hash().hex() for g in groups}
        keys = {g.public_key.key() for g in groups}
        out["dkg"] = {"group_hashes": len(group_hashes),
                      "collective_keys": len(keys),
                      "threshold": groups[0].threshold,
                      "nodes": len(groups[0]), "scheme": groups[0].scheme.id,
                      "period_s": groups[0].period}
        if len(group_hashes) != 1 or len(keys) != 1 \
                or groups[0].threshold != DAEMON_T \
                or len(groups[0]) != DAEMON_N \
                or groups[0].scheme.id != sch.id:
            die(f"the DKG did not agree: {out['dkg']}")
        group = groups[0]
        pk = group.public_key.key()
        genesis = group.genesis_time
        walls["genesis_wait_s"] = max(0.0, genesis - time.time())

        def scheduled(r):
            return genesis + (r - 1) * group.period

        # -- live rounds from genesis on all four
        everyone = list(range(DAEMON_N))
        beacons, round_walls = {}, {}
        for r in range(1, DAEMON_LIVE + 1):
            seen = wait_rounds(r, everyone)
            round_walls[r] = max(seen.values()) - scheduled(r)
            beacons[r] = read_round(r, everyone)

        # -- one daemon shut down over Control, then restarted by the CLI
        victim = DAEMON_N - 1
        others = [i for i in everyone if i != victim]
        cc = ControlClient(ready[victim]["control"])
        down.add(victim)
        cc.stub.shutdown(pb.ShutdownRequest(metadata=convert.metadata()),
                         timeout=30)
        cc.close()
        try:
            rc = procs[victim].wait(timeout=DAEMON_WAIT_S)
        except subprocess.TimeoutExpired:
            die("the daemon shut down over Control did not exit", victim)
        if rc != 0:
            die(f"the daemon shut down over Control exited with {rc}",
                victim)
        head = DAEMON_LIVE + DAEMON_DOWN
        for r in range(DAEMON_LIVE + 1, head + 1):
            seen = wait_rounds(r, others)
            round_walls[r] = max(seen.values()) - scheduled(r)
            beacons[r] = read_round(r, others)
        t0 = time.perf_counter()
        spawn(victim)
        wait_ready(victim)
        down.discard(victim)
        restart_ready_s = time.perf_counter() - t0
        behind = max(latest(i) for i in others)
        wait_rounds(behind, [victim])
        walls["restart_catch_up_s"] = time.perf_counter() - t0
        out["restart"] = {"down_rounds": list(range(DAEMON_LIVE + 1,
                                                    head + 1)),
                          "ready_s": restart_ready_s,
                          "caught_up_to": behind}
        # every round, the missed ones too, on the restarted daemon
        for r in range(1, behind + 1):
            sig = read_round(r, everyone)
            if beacons.setdefault(r, sig) != sig:
                die(f"round {r} changed after the restart", victim)
        # then live rounds, until the restarted daemon has stored one
        # through its own aggregation (a partials check of its own): a
        # round it still gets from a peer's SyncChain does not count
        r = behind
        while True:
            r += 1
            seen = wait_rounds(r, everyone)
            round_walls[r] = max(seen.values()) - scheduled(r)
            beacons[r] = read_round(r, everyone)
            own = sum(_series(scrape(victim), "beacon_partial_checks_total"))
            if r - behind >= DAEMON_AFTER and own:
                break
            if r - behind >= DAEMON_AFTER + 4:
                die(f"the restarted daemon checked no partials of its own "
                    f"in {r - behind} rounds after its catch-up", victim)
        last = r
        out["restart"]["rounds_to_own_check"] = r - behind

        # -- every round verified here, on the card, against the key
        rounds = sorted(beacons)
        verdicts = drive("daemon_rounds", lambda: B.BatchBeaconVerifier(
            sch, pk).verify_batch(rounds, [beacons[r] for r in rounds]))
        out["rounds_verified_on_card"] = {
            "rounds": len(rounds), "all_true": bool(verdicts.all())}
        if not verdicts.all():
            die(f"rounds not verified against the collective key: "
                f"{[r for r, v in zip(rounds, verdicts.tolist()) if not v]}")

        # -- a strict client over gRPC (client/verify.py over
        # GrpcTransport): get(r) for every round from 1.  Quicknet is
        # unchained, so the strict client has no linkage to walk and no
        # sweep: it checks each get on its own, on the service's host
        # handle (a card sweep is for chained spans of 64 rounds or more).
        # Then its watch() yields the next round.
        svc = VS.get_service()
        client = VerifyingClient(GrpcTransport(addrs[0]), strict=True)
        st0 = svc.stats()
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        got = [client.get(r) for r in range(1, last + 1)]
        walls["client_gets_s"] = time.perf_counter() - t0
        st = svc.stats()
        gets = {"rounds": len(got), "chained": sch.chained,
                "rounds_right": all(
                    g.round == r and g.randomness ==
                    hashlib.sha256(beacons[r]).digest()
                    for r, g in zip(range(1, last + 1), got)),
                "dispatches": st["dispatches"] - st0["dispatches"],
                "host_served": st["host_served"] - st0["host_served"],
                "launches": sum(K.LAUNCHES.values())}
        client.close()
        client = VerifyingClient(GrpcTransport(addrs[1]), strict=True)
        stop = threading.Event()
        t0 = time.perf_counter()
        nxt = next(client.watch(stop))
        stop.set()
        gets["watch"] = {"round": nxt.round,
                         "after_s": time.perf_counter() - t0}
        wait_rounds(nxt.round, everyone)
        gets["watch"]["randomness_equal"] = nxt.randomness == \
            hashlib.sha256(read_round(nxt.round, everyone)).digest()
        client.close()
        out["strict_client"] = gets
        if not gets["rounds_right"] or nxt.round <= last \
                or not gets["watch"]["randomness_equal"]:
            die(f"the strict client over gRPC: {gets}")

        # -- each daemon's metrics: the group registry over the Protocol
        # plane (what a federating peer sees), the verify service's own
        # series from the daemon's MetricsServer
        checks_ms, per = [], {}
        for i in everyone:
            m = scrape(i, want=("beacon_partial_checks_total",
                                "beacon_partial_check_errors_total",
                                "beacon_partial_check_seconds",
                                "beacon_partial_check_seconds_max"))
            m.update(scrape(i, private=True, want=(
                "verify_service_failovers_total",
                "verify_service_watchdog_trips_total",
                "verify_service_host_served_total",
                "verify_service_dispatches_total")))
            per[i] = {
                "partial_checks_device":
                    sum(_series(m, "beacon_partial_checks_total",
                                backend="device")),
                "partial_checks_host":
                    sum(_series(m, "beacon_partial_checks_total",
                                backend="host")),
                "partial_check_errors":
                    sum(_series(m, "beacon_partial_check_errors_total")),
                "failovers": sum(_series(m, "verify_service_failovers_total")),
                "watchdog_trips":
                    sum(_series(m, "verify_service_watchdog_trips_total")),
                "host_served":
                    sum(_series(m, "verify_service_host_served_total")),
                "background_dispatches":
                    sum(_series(m, "verify_service_dispatches_total",
                                lane="background")),
                "check_p50_le_s":
                    _hist_quantile(m, "beacon_partial_check_seconds", 0.5),
                "check_max_s":
                    max(_series(m, "beacon_partial_check_seconds_max"),
                        default=None)}
            n_checks = sum(_series(m, "beacon_partial_check_seconds_count"))
            mean = sum(_series(m, "beacon_partial_check_seconds_sum")) / \
                max(1.0, n_checks)
            per[i]["check_mean_s"] = mean
            checks_ms.append(per[i]["check_max_s"] or 0.0)
            if per[i]["partial_checks_device"] < 1 \
                    or per[i]["partial_checks_host"] \
                    or per[i]["partial_check_errors"] \
                    or per[i]["failovers"] or per[i]["watchdog_trips"] \
                    or per[i]["host_served"]:
                die(f"daemon {i}'s metrics: {per[i]}", i)
        if per[victim]["background_dispatches"] < 1:
            die(f"the restarted daemon verified no catch-up on its "
                f"BACKGROUND lane: {per[victim]}", victim)
        out["metrics"] = per

        # -- in this process: the daemons' (1, 4) partials check of one
        # stored round, from the shares in their key folders
        shares = [FileStore(f, "default").load_share() for f in folders]
        msg = sch.digest_beacon(DAEMON_CHECK_ROUND)
        parts = [HT.sign_partial(sch, s.private, msg) for s in shares]
        pub = group.public_key.pub_poly(sch)
        pv = DevicePartialVerifier(sch, pub, DAEMON_N)
        t0 = time.perf_counter()
        ok = drive("daemon_check", lambda: pv.verify(msg, parts))
        check_s = time.perf_counter() - t0
        sig = HT.recover(sch, pub, msg, parts[:DAEMON_T], DAEMON_T,
                         DAEMON_N, verify_each=False)
        out["check"] = {"round": DAEMON_CHECK_ROUND, "verdicts": list(ok),
                        "wall_s": check_s,
                        "recovered_equals_stored":
                            sig == beacons[DAEMON_CHECK_ROUND]}
        if not all(ok) or sig != beacons[DAEMON_CHECK_ROUND]:
            die(f"the in-process (1, {DAEMON_N}) check: {out['check']}")

        # -- every daemon shut down over Control, each exiting 0
        for i in everyone:
            cc = ControlClient(ready[i]["control"])
            down.add(i)
            cc.stub.shutdown(pb.ShutdownRequest(
                metadata=convert.metadata()), timeout=30)
            cc.close()
        for i in everyone:
            try:
                rc = procs[i].wait(timeout=DAEMON_WAIT_S)
            except subprocess.TimeoutExpired:
                die(f"daemon {i} did not exit after its shutdown", i)
            if rc != 0:
                die(f"daemon {i} exited with {rc}", i)
    except SystemExit:
        raise
    except BaseException as e:      # noqa: BLE001 — a check that raised
        import traceback
        traceback.print_exc()
        die(f"{type(e).__name__}: {e}")
    pc.close()
    shutil.rmtree(tmp, ignore_errors=True)
    rw = sorted(round_walls.values())
    p50 = [v for v in (per[i]["check_p50_le_s"] for i in everyone) if v]
    walls.update({"round_p50_s": rw[len(rw) // 2], "round_max_s": rw[-1],
                  "phase_s": time.perf_counter() - t_phase})
    emit({"phase": "daemon_quicknet", "scheme": sch.id, "daemons": DAEMON_N,
          "threshold": DAEMON_T, "period_s": DAEMON_PERIOD,
          "store": "sqlite", "transport": "gRPC on localhost",
          "walls": walls, "round_walls_s": round_walls,
          "partial_check_p50_le_s": max(p50) if p50 else None,
          "partial_check_max_s": max(checks_ms), **out,
          "launches": {p: v[0] for p, v in paths.items()},
          "device": name, "nvidia_smi": smi_line})
    return {"paths": paths, "walls": walls}


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
        from drand_tpu_torch.ops import fp12prog as FP
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
        from drand_tpu_torch.crypto.host import h2c as H2C
        from drand_tpu_torch.ops import sha256 as SHA
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
        if name.startswith("sum_rows"):
            return f"{key} rows"
        return labels.get(key, key)

    def shape_list(shapes):
        return [{"kernel": k, "key": key_label(k, key), "lanes": lanes,
                 "launches": c} for (k, key, lanes), c in sorted(
                     shapes.items(), key=lambda kv: (kv[0][0], kv[0][2]))]

    # -- phase 3a: verify_batch, all valid: one RLC pass ---------------------
    got, rlc_wall, rlc_launches, rlc_shapes, passes = drive(
        lambda: verifier.verify_batch(rounds, good_sigs))
    ok = bool(got.all()) and passes == {"rlc": 1, "exact": 0}
    # a second run, split into the host packing (the device front: numpy
    # round words) and the device pass (H1 at its start)
    t0 = time.perf_counter()
    rlc_enc3, _, rlc_front = verifier._pack_enc(rounds, good_sigs, None, pad)
    torch.cuda.synchronize()
    rlc_pack_s = time.perf_counter() - t0
    # the device pass three times (host clock, a sync each): its median and
    # spread, against the differences between runs of one call
    pass_runs, again = [], True
    for _ in range(3):
        t0 = time.perf_counter()
        again &= bool(verifier._rlc_ok(rlc_enc3, n, rlc_front))
        torch.cuda.synchronize()
        pass_runs.append(time.perf_counter() - t0)
    rlc_pass_s = float(np.median(pass_runs))
    rlc_enc = verifier._fields_enc(rlc_enc3, rlc_front)
    # the FIELDS front (host hash_to_field) on the same inputs: its packing
    # beside the device front's, and its verdicts equal to the device
    # front's
    fields_v = B.BatchBeaconVerifier(sch, HS.g2_to_bytes(pk),
                                     h2f_device=False)
    t0 = time.perf_counter()
    fields_v._pack_enc(rounds, good_sigs, None, pad)
    torch.cuda.synchronize()
    fields_pack_s = time.perf_counter() - t0
    got_fields, _, fields_launches, _, fields_passes = drive(
        lambda: fields_v.verify_batch(rounds, good_sigs))
    same_fronts = bool((got_fields == got).all())
    emit({"phase": "verify_batch_rlc", "rounds": n,
          "all_valid": bool(got.all()), "passes": passes, "wall_s": rlc_wall,
          "rounds_per_s": n / rlc_wall, "front": rlc_front,
          "second_run": {"host_pack_s": rlc_pack_s,
                         "device_pass_s": rlc_pass_s,
                         "device_pass_runs_s": pass_runs,
                         "device_pass_spread_s": max(pass_runs)
                         - min(pass_runs),
                         "rounds_per_s": n / (rlc_pack_s + rlc_pass_s)},
          "fields_front": {"host_pack_ms": fields_pack_s * 1e3,
                           "device_front_host_pack_ms": rlc_pack_s * 1e3,
                           "verdicts_equal_device_front": same_fronts,
                           "passes": fields_passes,
                           "h1_launches": fields_launches["hash_to_field"]},
          "sign_setup_s": sign_s, "launches": rlc_launches,
          "shapes": shape_list(rlc_shapes), "device": name,
          "nvidia_smi": smi_line})
    if not ok or not again:
        fail(f"all-valid verify_batch: verdicts all true {bool(got.all())}, "
             f"passes {passes} (want one RLC pass), second pass {again}")
    if rlc_front != B.FRONT_RAW_UNCHAINED or not same_fronts \
            or fields_launches["hash_to_field"]:
        fail(f"the fronts of verify_batch at {n} rounds: device front "
             f"{rlc_front}, FIELDS verdicts equal {same_fronts}, H1 "
             f"launches on the FIELDS front {fields_launches}")
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
    g1_mask = got.copy()        # the direct mask, for the service phase

    # -- phase 3c: the exact pass over the whole batch (slice 1's path) ------
    t0 = time.perf_counter()
    enc, wire_bad, ex_front = verifier._pack_enc(rounds, sigs, None, pad)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    again, exact_s, ex_launches, ex_shapes, ex_passes = drive(
        lambda: verifier._exact(enc, n, ex_front))
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
                                         "final_exponentiation",
                                         "hash_to_field")):
        fail(f"a kernel of the exact pass was not launched: {ex_launches}")

    # -- phase 3d: the G2-signature schemes at full width ---------------------
    # One secret key (public key on G1).  Signatures are made on the card in
    # two batched waves, the port's hash-to-G2 and one K2-G2 launch with
    # k = sk each: usigs[i] = sk*H(sha256(round_i)), the unchained signature
    # of round i, then sigs[i] = sk*H(sha256(prev_i || round_i)) with
    # prev_i = usigs[i] -- a valid (round, sig, prev) triple of the chained
    # scheme -- and, at slot 0, no prev.  Linkage
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
    # slot 0, the first round of the chain, has no previous signature (a
    # has_prev = 0 lane of the raw chained front); with the 32-byte
    # genesis seed there the chunk takes the DIGEST front (phase h2f_front)
    cprevs = [None] + usigs[1:]
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
    g2_enc3, _, g2_front = g2v._pack_enc(rounds, csigs, cprevs, pad)
    torch.cuda.synchronize()
    g2_pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = g2v._rlc_ok(g2_enc3, n, g2_front)
    torch.cuda.synchronize()
    g2_pass_s = time.perf_counter() - t0
    g2_enc = g2v._fields_enc(g2_enc3, g2_front)
    emit({"phase": "g2_verify_batch_rlc", "scheme": chained.id, "rounds": n,
          "all_valid": bool(got.all()), "passes": passes, "wall_s": g2_wall,
          "rounds_per_s": n / g2_wall, "front": g2_front,
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

    got, u_wall, u_launches, u_shapes, passes = drive(
        lambda: g2u.verify_batch(rounds, usigs))
    emit({"phase": "g2_unchained_rlc", "scheme": unchained.id, "rounds": n,
          "all_valid": bool(got.all()), "passes": passes, "wall_s": u_wall,
          "rounds_per_s": n / u_wall, "launches": u_launches,
          "device": name, "nvidia_smi": smi_line})
    if not got.all() or passes != {"rlc": 1, "exact": 0} \
            or u_launches["hash_to_field_fp2"] != 1:
        fail(f"all-valid unchained verify_batch: verdicts all true "
             f"{bool(got.all())}, passes {passes} (want one RLC pass), "
             f"launches {u_launches}")

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
    g2_mask = got.copy()

    t0 = time.perf_counter()
    g2x_enc, g2x_bad, g2x_front = g2v._pack_enc(rounds, bsigs, cprevs, pad)
    torch.cuda.synchronize()
    g2x_pack_s = time.perf_counter() - t0
    again, g2x_s, g2x_launches, g2x_shapes, _ = drive(
        lambda: g2v._exact(g2x_enc, n, g2x_front))
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
              "host_checked_rounds": sample,
              "sha256": digest([g for p_ in parts for g in p_] + full),
              "launches": launches,
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
              "verify_batch_all_valid": bool(ver.all()),
              "sha256": digest(rec), "wall_s": wall,
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

    # -- phase verify_service: the service's path, with the pool it owns ----
    # A VerifyService whose pool enumerates the card (one group, no
    # pool-wide placement) serves the rounds signed above through its
    # entry points: handles, submit from many caller threads, the lanes,
    # chunking, and its failure domain.
    # Its depth is a quarter of the batch (SERVICE_SHARE): the same code
    # paths, and time for them in the script's limit.
    ns = n // SERVICE_SHARE
    service_phases(
        dict(torch=torch, K=K, B=B, schemes=schemes, HS=HS, pk=pk, pk2=pk2,
             rounds=rounds[:ns], sigs=sigs[:ns], good_sigs=good_sigs[:ns],
             bsigs=bsigs[:ns], cprevs=cprevs[:ns], g1_mask=g1_mask[:ns],
             g2_mask=g2_mask[:ns], n=ns, name=name, smi_line=smi_line))
    assert "jax" not in sys.modules and "drand_tpu" not in sys.modules

    # -- phase dkg: the device DKG at committee scale, and a ceremony -------
    dkg = dkg_phases(dict(torch=torch, K=K, drive=drive, schemes=schemes,
                          HT=HT, HS=HS, R=R, name=name, smi_line=smi_line,
                          rng=rng))
    dkg_keys = {sh for _, shapes in dkg["paths"].values() for sh in shapes}
    assert "jax" not in sys.modules and "drand_tpu" not in sys.modules

    # the edge phase's chain, signed on the host meanwhile
    edge_chain = start_edge_chain()

    # -- phase beacon: the beacon layer as a network of 13 daemons ----------
    beacon = beacon_phases(dict(torch=torch, K=K, B=B, schemes=schemes,
                                HT=HT, R=R, rng=rng, name=name,
                                smi_line=smi_line))
    assert "jax" not in sys.modules and "drand_tpu" not in sys.modules

    # -- phase edge: the public edge and strict clients' catch-up ----------
    edge_run = edge_phases(dict(torch=torch, K=K, B=B, schemes=schemes,
                                name=name, smi_line=smi_line,
                                edge_chain=edge_chain))
    assert "jax" not in sys.modules and "drand_tpu" not in sys.modules

    # -- phase daemon: four daemons of the port over real gRPC -------------
    daemon = daemon_phases(dict(torch=torch, K=K, B=B, schemes=schemes,
                                HT=HT, name=name, smi_line=smi_line))
    assert "jax" not in sys.modules and "drand_tpu" not in sys.modules

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

    def at_width(kind, width, fn):
        """fn() with K2 or K7 launched at `width` threads a lane or an add,
        whatever its lane or tile count: kernels.K2_FILL_LANES or
        K7_FILL_TILES moved below or above it."""
        attr = "K7_FILL_TILES" if kind.startswith("sum") else "K2_FILL_LANES"
        saved = getattr(K, attr)
        setattr(K, attr, 1 if width == FP.FILL_WIDTH.get(kind) else 1 << 62)
        try:
            return fn()
        finally:
            setattr(K, attr, saved)

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

    # One group phase (csrc/group.cuh) on its own: K2-G1's kernel at 8
    # threads a lane runs a synthetic program of 512 phases of one add, or
    # of one product, on 1 and on 14,336 lanes; the time a phase.  Not
    # main-path launches.
    def phase_us():
        nph, nslots = 512, 16
        out_us = {}
        for name, is_prod, kind in (("linear", False, FP.ADD),
                                    ("product", True, FP.PROD)):
            tab = ([nslots, 1, nph, nph, 0, 0, 0, nph]
                   + [v for i in range(nph) for v in (i, 1, int(is_prod))]
                   + [kind, 3, 3, 4] * nph)
            prog = torch.tensor(tab, dtype=torch.int32, device=dev)
            sched = torch.zeros(1, dtype=torch.int32, device=dev)
            for lanes in (1, 14336):
                x = torch.zeros((3, 12, lanes), dtype=torch.int32, device=dev)
                o = torch.empty_like(x)
                fn = lambda: K._check(K._lib().drand_ladder_g1(
                    x.data_ptr(), o.data_ptr(),
                    K.const_bundle(str(dev)).data_ptr(), prog.data_ptr(),
                    nslots, FP.WIDTH["fixed_g1"], sched.data_ptr(), 1, lanes,
                    K._stream(dev)), "phase_us")
                out_us[f"{name} at {lanes} lanes"] = \
                    timed(fn, args.reps) / nph * 1e3
        return out_us

    phase = phase_us()
    xbits = K.XLOOP_BITS
    # K3 / K4 launch a warp a lane, K6, K2 and K5 a thread group a lane,
    # with the lane's slots in dynamic shared memory (csrc/group.cuh):
    # record that layout (K2 at each width it compiles)
    k2_kind = {"scalar_mul_fixed": "fixed_g1",
               "scalar_mul_fixed_g2": "fixed_g2"}
    k7_kind = {"sum_rows": "sum_g1", "sum_rows_g2": "sum_g2"}

    def k2_widths(kind):
        return sorted({FP.WIDTH[kind], FP.FILL_WIDTH.get(kind,
                                                         FP.WIDTH[kind])})

    def layout(kind, width):
        per_block, smem = K.group_layout(kind, width)
        unit = "adds" if kind.startswith("sum") else "lanes"
        return {f"threads_per_{unit[:-1]}": width,
                f"slots_per_{unit[:-1]}": FP.compiled(kind)[1],
                f"{unit}_per_block": per_block,
                "dynamic_smem_bytes_per_block": smem}
    group_layout = {kname: layout(kind, FP.WIDTH[kind]) for kname, kind in (
        ("miller_loop", "miller"), ("final_exponentiation", "finalexp"),
        ("scalar_mul_bits", "ladder_g1"), ("scalar_mul_bits_g2", "ladder_g2"),
        ("pow_fixed_fp2", "pow2"), ("scalar_mul_glv_mixed", "glv_g1"),
        ("scalar_mul_glv_mixed_g2", "glv_g2"))}
    for kname, kind in k2_kind.items():
        group_layout[kname] = {"widths": [layout(kind, w)
                                          for w in k2_widths(kind)],
                               "fill_width_from_lanes": K.K2_FILL_LANES}
    for kname, kind in k7_kind.items():
        group_layout[kname] = {"widths": [layout(kind, w)
                                          for w in k2_widths(kind)],
                               "fill_width_from_tiles": K.K7_FILL_TILES}
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
    # K4's wide input ends in a zero and a one lane; the 1-lane input is
    # random (outside the cyclotomic subgroup, as every lane here)
    zero_one = lambda i: L.encode_mont([0, int(i == 0)], dev)
    fe = T.fp12_pack([torch.cat([rand_fp(pad - 2), zero_one(i)])
                      for i in range(12)])
    fe1 = T.fp12_pack([c[:1] for c in T.fp12_leaves(fe)])
    # tails: 5 K4 lanes (no multiple of its 3 lanes a block) and 7 K3 pairs
    # (of 4), each with a zero and a one lane
    fe5 = T.fp12_pack([torch.cat([zero_one(i), rand_fp(3)])
                       for i in range(12)])
    m7 = [torch.cat([L.encode_mont([0, 1], dev), rand_fp(5)])
          for _ in range(6)]
    m7 = (m7[0], m7[1], ((m7[2], m7[3]), (m7[4], m7[5])))
    # the group kernels' own counts: one lane's products (code), and the
    # dependent products and linear steps of its chain
    group_counts = {k: FP.lane_counts(k, xbits)
                    for k in ("miller", "finalexp")}

    def chain(kind, c=None):
        c = c or group_counts[kind]
        return {"code_products_per_lane": c["products"],
                "critical_products": c["critical_products"],
                "critical_linear_steps": c["critical_linear"]}

    def k2_shape(kname, key, lanes, pts, label):
        """A K2 shape: need for k, code and chain from the program's own
        counts for k's bits at the width the wrapper picks for `lanes`
        (each compiled width is timed below)."""
        kind = k2_kind[kname]
        g2k = kind == "fixed_g2"
        w = K.fixed_width(kind, lanes)
        counts = FP.lane_counts(kind, L.exp_bits(key), w)
        return (label, key, lanes, lambda: K.scalar_mul_fixed(pts, key),
                Plain("scalar_mul_fixed_plain", pts, key), err_flat,
                (need_ladder_g2(key) if g2k else need_ladder(key),
                 code_group(counts)), 12 if g2k else 6,
                dict(chain(kind, counts), threads_per_lane=w))
    def k1_shape(label, e, x):
        """A K1 shape: the inversion for p - 2, else the windowed chain
        kernels.pow_schedule gives for e."""
        if e == P - 2:
            code, entry = INV_OPS, "k_inv"
        else:
            code, entry = code_pow(*K.pow_schedule(e)), "k_pow"
        return (label, e, x.shape[0], lambda: K.pow_fixed(x, e),
                Plain("pow_fixed_plain", x, e), lambda a, b: err([a], [b]),
                (need_inv(P) if e == P - 2 else need_pow(e), code),
                2 * K1_LIMB_BYTES / WORD_BYTES, {"entry": entry})

    def k5_shape(label, e, x):
        """A K5 shape: need for e, code and chain from the "pow2" program's
        counts for e."""
        lanes = x[0].shape[0]
        w = FP.WIDTH["pow2"]
        counts = FP.lane_counts("pow2", e, w)
        return (label, e, lanes, lambda: K.pow_fixed_fp2(x, e),
                Plain("pow_fixed_fp2_plain", x, e), err_flat,
                (need_pow2(e, P), code_group(counts)), 4,
                dict(chain("pow2", counts), threads_per_lane=w))
    leaves = T.fp12_leaves
    e_sqrt, e_inv = (P - 3) // 4, P - 2
    # K1 and K5 edge lanes, checked: 0, 1, p - 1, R mod p (and u, c1 = 0
    # in Fp2) beside random values
    edge = [0, 1, P - 1, (1 << 384) % P]
    x_edge = torch.cat([L.encode_mont(edge, dev), rand_fp(5)])
    x2_edge = (torch.cat([L.encode_mont(edge + [0, 7], dev), rand_fp(3)]),
               torch.cat([L.encode_mont([0, 0, 0, 0, 1, 0], dev),
                          rand_fp(3)]))
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
    limb_words = K1_LIMB_BYTES / WORD_BYTES   # an Fp as 24 int64 limbs

    def k8_shape(label, args):
        """A K8 shape: need from these bits, code and chain from the
        program's own counts for nbits steps (an add at every step)."""
        g2k = K._is_g2(args[0])
        kind = "glv_g2" if g2k else "glv_g1"
        b0, b1 = args[3], args[4]
        nbits, lanes = b0.shape
        counts = FP.lane_counts(kind, [0] * nbits)
        need = need_glv_g2(b0, b1) if g2k else need_glv(b0, b1)
        return (label, nbits, lanes, lambda: K.scalar_mul_glv_mixed(*args),
                Plain("scalar_mul_glv_mixed_plain", *args), err_flat,
                (need / lanes, code_group(counts)),
                (27 if g2k else 9) * limb_words + 2 * nbits / 12,
                dict(chain(kind, counts), threads_per_lane=FP.WIDTH[kind]))

    def k7_shape(label, pts):
        """A K7 shape, rows x lanes points: need from their finite points,
        code from the add program's products; its chain: the dependent
        adds of a row (k7_levels) and the add's counts at the width
        kernels.sum_width picks, and the floor they set at this run's
        one-lane phase latencies."""
        g2k = K._is_g2(pts)
        kind = "sum_g2" if g2k else "sum_g1"
        rows, lanes = K._flat(pts)[0].shape[:2]
        w = K.sum_width(kind, rows * -(-lanes // K.TILE))
        add = FP.lane_counts(kind, None, w)
        need = need_sum(K._curve(pts).is_infinity(pts),
                        _imad(G2_ADD_NEED) if g2k else _imad(11, 5))
        levels = k7_levels(lanes, K.TILE)
        nc = 6 if g2k else 3
        return (label, rows, lanes, lambda: K.sum_rows(pts),
                Plain("sum_rows_plain", pts), err_flat,
                (need / lanes, code_sum(rows, lanes, add["products"]) / lanes),
                rows * nc * limb_words * (1 + 1 / lanes),
                dict(chain(kind, add), threads_per_add=w,
                     dependent_adds=levels, chain_floor_ms=levels * (
                         add["product_phases"] * phase["product at 1 lanes"]
                         + add["linear_phases"] * phase["linear at 1 lanes"])
                     / 1e3))

    def sum_check(pts):
        """3 rows of 1000 lanes (a ragged last tile each), pts repeated
        over them; in row 0, lane 128 the negation of lane 0 and lane 130
        a copy of lane 2 (level 128 meets P == -Q and P == Q); row 1 all
        infinity."""
        curve = K._curve(pts)
        idx = torch.arange(3000, device=dev) % K._flat(pts)[0].shape[0]
        x = DC._tmap(lambda c: c[idx].reshape(3, 1000, L.NLIMB).clone(),
                     pts)
        neg = curve.neg(DC._tmap(lambda c: c[0, :1], x))
        inf = curve.infinity_like(K._flat(x)[0][1])
        for c, d, i in zip(K._flat(x), K._flat(neg), K._flat(inf)):
            c[0, 128], c[0, 130], c[1] = d[0], c[0, 2], i
        return x

    # the G2 instances: random G2 points (members, infinity, the generator
    # and a point outside G2) at the path's widths
    x3n2 = (rand_fp(3 * pad), rand_fp(3 * pad))
    pts2 = [HC.G2.mul(HC.G2.gen, random.randrange(1, R)) for _ in range(16)]
    pts2 = (pts2 * (pad // len(pts2) + 1))[:pad - 3] + [None, HC.G2.gen,
                                                       (xq2, yq2)]
    pj2 = DC.encode_g2_points(pts2, dev)
    pj2r = DC._tmap(lambda c: c.roll(1, 0), pj2)
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
        ("pow_fixed", "pow.cu", 522, "K1", ("k_pow", "k_inv"), [
            k1_shape("(p-3)/4 at 3N", e_sqrt, x3n),
            k1_shape("p-2 at N", e_inv, xn),
            k1_shape("p-2 at 1 lane", e_inv, x1),
            k1_shape("p-2, edge values (check)", e_inv, x_edge),
            k1_shape("(p-3)/4, edge values (check)", e_sqrt, x_edge)]),
        ("scalar_mul_fixed", "ladder.cu", 635, "K2 G1", ("k_ladder_g1",), [
            k2_shape("scalar_mul_fixed", -X, pad, pj, "|x| at N"),
            k2_shape("scalar_mul_fixed", 1 - X, pad, pj, "1-x at N")]),
        ("miller_loop", "miller.cu", 1058, "K3", ("k_miller",), [
            ("2N pairs", None, 2 * pad, lambda: K.miller_loop(mx, my, mq),
             Plain("miller_loop_plain", mx, my, mq),
             lambda a, b: err(leaves(a), leaves(b)),
             (need_miller(xbits), code_group(group_counts["miller"])), 18,
             chain("miller")),
            ("2 pairs", None, 2, lambda: K.miller_loop(*m2),
             Plain("miller_loop_plain", *m2),
             lambda a, b: err(leaves(a), leaves(b)),
             (need_miller(xbits), code_group(group_counts["miller"])), 18,
             chain("miller")),
            ("7 pairs, zero and one lanes (check)", None, 7,
             lambda: K.miller_loop(*m7), Plain("miller_loop_plain", *m7),
             lambda a, b: err(leaves(a), leaves(b)),
             (need_miller(xbits), code_group(group_counts["miller"])), 18,
             chain("miller"))]),
        ("final_exponentiation", "finalexp.cu", 1093, "K4", ("k_finalexp",), [
            ("N lanes, last two zero and one", None, pad,
             lambda: K.final_exponentiation(fe),
             Plain("final_exponentiation_plain", fe),
             lambda a, b: err(leaves(a), leaves(b)),
             (need_finalexp(xbits, HF.FROB, P),
              code_group(group_counts["finalexp"])), 24,
             chain("finalexp")),
            ("1 lane", None, 1, lambda: K.final_exponentiation(fe1),
             Plain("final_exponentiation_plain", fe1),
             lambda a, b: err(leaves(a), leaves(b)),
             (need_finalexp(xbits, HF.FROB, P),
              code_group(group_counts["finalexp"])), 24,
             chain("finalexp")),
            ("5 lanes, zero and one (check)", None, 5,
             lambda: K.final_exponentiation(fe5),
             Plain("final_exponentiation_plain", fe5),
             lambda a, b: err(leaves(a), leaves(b)),
             (need_finalexp(xbits, HF.FROB, P),
              code_group(group_counts["finalexp"])), 24,
             chain("finalexp"))]),
        ("sum_rows", "sum.cu", 1187, "K7 G1", ("k_sum_rows_g1",), [
            k7_shape("3 rows at 1000, row 1 all infinity (check)",
                     sum_check(pj))]),
        ("scalar_mul_glv_mixed", "glv.cu", 1298, "K8 G1", ("k_glv_g1",), [
            k8_shape("64 bits at 2N", glv_args)]),
        ("pow_fixed_fp2", "pow2.cu", 562, "K5", ("k_pow2",), [
            k5_shape("(p^2-9)/16 at 3N", E2, x3n2),
            k5_shape("(p^2-9)/16, edge values (check)", E2, x2_edge)]),
        ("scalar_mul_fixed_g2", "ladder.cu", 635, "K2 G2", ("k_ladder_g2",), [
            k2_shape("scalar_mul_fixed_g2", -X, pad, pj2, "|x| at N")]),
        ("sum_rows_g2", "sum.cu", 1187, "K7 G2", ("k_sum_rows_g2",), [
            k7_shape("3 rows at 1000, row 1 all infinity (check)",
                     sum_check(pj2))]),
        ("scalar_mul_glv_mixed_g2", "glv.cu", 1298, "K8 G2", ("k_glv_g2",), [
            k8_shape("32 bits at 4N", glv2_args)]),
        ("scalar_mul_bits", "ladder_var.cu", 595, "K6 G1",
         ("k_ladder_var_g1",), []),
        ("scalar_mul_bits_g2", "ladder_var.cu", 595, "K6 G2",
         ("k_ladder_var_g2",), []),
        # H1 has no Pallas counterpart: it replaces the JAX package's XLA
        # SHA-256 scan and the xmd / hash_to_field stages around it
        ("hash_to_field", "h2f.cu", "drand_tpu/ops/sha256.py:109", "H1 Fp",
         ("k_h2f",), []),
        ("hash_to_field_fp2", "h2f.cu", "drand_tpu/ops/sha256.py:109",
         "H1 Fp2", ("k_h2f",), []),
    ]
    ran = {"verify_batch_rlc": (rlc_launches, rlc_shapes),
           "exact_pass": (ex_launches, ex_shapes),
           "g2_verify_batch_rlc": (g2_launches, g2_shapes),
           "g2_unchained_rlc": (u_launches, u_shapes),
           "g2_exact_pass": (g2x_launches, g2x_shapes)}
    for tag in ("g1", "g2"):
        ran.update(thr[tag]["paths"])
    ran.update(dkg["paths"])
    ran.update(beacon["paths"])
    ran.update(edge_run["paths"])
    ran.update(daemon["paths"])
    groups = {"dkg": set(dkg["paths"]), "beacon": set(beacon["paths"]),
              "edge": set(edge_run["paths"]),
              "daemon": set(daemon["paths"])}

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

    def k6_inputs(g2, nbits, lanes, horner=False):
        """K6's inputs as its callers build them.  256 bits (signing):
        one random 256-bit scalar a lane, lanes 3-5 members with the
        scalars r and r + 2 (the last step's add meets P == -Q and P == Q)
        and 0.  16 bits (the DKG's Horner steps): random scalars, lane 3's
        0 and lane 4's 2^16 - 1.  130 / 66 bits (recovery): random
        scalars' signed GLV digits, the points' phi / psi lanes negated
        where a digit is negative, one scalar 0.  Every warp mixes 0 and 1
        bits, and infinite and finite points (lanes 0-2: infinity, the
        generator, a point outside the group).  horner (the dkg phase's
        shapes): from lane 6 on, each point the complete add of two of
        them, a Jacobian point with Z != 1 as a Horner accumulator is."""
        curve = DC.G2 if g2 else DC.G1
        if nbits in (256, 16):
            ks = [random.getrandbits(nbits) for _ in range(lanes)]
            edge = [R, R + 2, 0] if nbits == 256 else [0, (1 << 16) - 1]
            ks[3:3 + len(edge)] = edge
            pts = spread(special[g2], lanes)
            if horner:
                acc = curve.add(pts, DC._tmap(lambda c: c.roll(1, 0), pts))
                pts = curve.select(torch.arange(lanes, device=dev) >= 6,
                                   acc, pts)
            return (pts, torch.from_numpy(DC.msb_bits(ks, nbits)).to(dev))
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

    # H1's inputs at a shape: the paths' own messages (rounds 1..lanes;
    # chained, the unchained signatures as previous signatures with every
    # 1000th lane and lane 0 absent, has_prev = 0; the DIGEST front the
    # round digests), with the host messages for the oracle
    h1_cases = {}

    def h1_case(kname, kind, lanes, genesis_seed=False):
        fp2 = kname.endswith("_fp2")
        sch_h = chained if fp2 else sch
        rnd = list(range(1, lanes + 1))
        rw = torch.from_numpy(B.BatchBeaconVerifier._round_words(
            rnd, lanes)).to(dev)
        digests = 0.0
        if kind == "raw_unchained":
            msg = (rw,)
            msgs = [sch_h.digest_beacon(r) if not sch_h.chained
                    else unchained.digest_beacon(r) for r in rnd]
            digests = 1.0
        elif kind == "raw_chained":
            prv = [None if i % 1000 == 0 else usigs[i % n]
                   for i in range(lanes)]
            plen = len(usigs[0])
            pw = SHA.pack_msgs_to_words([p or b"\x00" * plen for p in prv])
            has = torch.tensor([int(p is not None) for p in prv],
                               device=dev)
            msg = (torch.from_numpy(pw).to(dev), rw, has)
            msgs = [chained.digest_beacon(r, p) for r, p in zip(rnd, prv)]
            digests = 1.0 + float(has.float().mean())
        else:
            if genesis_seed:      # a chained chunk with a 32-byte seed prev
                prv = [genesis] + usigs[1:lanes]
                msgs = [chained.digest_beacon(r, p) for r, p in zip(rnd, prv)]
            else:
                msgs = [sch_h.digest_beacon(r) for r in rnd]
            msg = (torch.from_numpy(SHA.pack_msgs_to_words(msgs, 32))
                   .to(dev),)
        words = sum(t.shape[-1] if t.dim() > 1 else 1 for t in msg) * 8 \
            / WORD_BYTES + (4 if fp2 else 2) * K1_LIMB_BYTES / WORD_BYTES
        return {"fp2": fp2, "dst": sch_h.dst, "msg": msg, "msgs": msgs,
                "digest_blocks": digests, "words": words}

    def h1_shape(kname, kind, lanes, label=None, genesis_seed=False):
        """An H1 shape: need and code from need_h1 (this run's has_prev
        lanes); the inputs kept for phase h2f_front's host oracle."""
        c = h1_case(kname, kind, lanes, genesis_seed)
        count = 4 if c["fp2"] else 2
        label = label or f"{kind} at {lanes}"
        h1_cases[(kname, label)] = (c, kind)
        ops = need_h1(count, c["digest_blocks"])
        return (label, kind, lanes,
                lambda: K.hash_to_field(kind, c["msg"], c["dst"], count),
                Plain("hash_to_field_plain", kind, c["msg"], c["dst"],
                                              count),
                lambda a, b: err(a, b), (ops, ops), c["words"],
                {"entry": "k_h2f", "compressions_per_lane":
                 c["digest_blocks"] + 2 + 4 * count})

    def generic_shape(kname, key, lanes):
        """(label, key, lanes, kernel call, plain call, compare, (need,
        code) multiply-adds per lane, words per lane) at a recorded shape."""
        g2k = kname.endswith("_g2")
        label = f"{key_label(kname, key)} at {lanes}" if key is not None \
            else f"{lanes} lanes"
        if kname == "pow_fixed":
            return k1_shape(label, key, rand_fp_dev(lanes))
        if kname == "pow_fixed_fp2":
            return k5_shape(label, key, (rand_fp_dev(lanes),
                                         rand_fp_dev(lanes)))
        if kname.startswith("scalar_mul_fixed"):
            return k2_shape(kname, key, lanes, spread(special[g2k], lanes),
                            label)
        if kname == "miller_loop":
            px, py = rand_fp_dev(lanes), rand_fp_dev(lanes)
            q = ((rand_fp_dev(lanes), rand_fp_dev(lanes)),
                 (rand_fp_dev(lanes), rand_fp_dev(lanes)))
            return (f"{lanes} pairs", key, lanes,
                    lambda: K.miller_loop(px, py, q),
                    Plain("miller_loop_plain", px, py, q),
                    lambda a, b: err(leaves(a), leaves(b)),
                    (need_miller(xbits), code_group(group_counts["miller"])),
                    18, chain("miller"))
        if kname == "final_exponentiation":
            f = T.fp12_pack([rand_fp_dev(lanes) for _ in range(12)])
            return (label, key, lanes, lambda: K.final_exponentiation(f),
                    Plain("final_exponentiation_plain", f),
                    lambda a, b: err(leaves(a), leaves(b)),
                    (need_finalexp(xbits, HF.FROB, P),
                     code_group(group_counts["finalexp"])), 24,
                    chain("finalexp"))
        if kname.startswith("sum_rows"):
            return k7_shape(label, DC._tmap(
                lambda c: c.reshape(key, lanes, L.NLIMB),
                spread(special[g2k], key * lanes)))
        if kname.startswith("scalar_mul_glv_mixed"):
            tabs = [spread(t, lanes) for t in
                    (glv2_args[:3] if g2k else glv_args[:3])]
            b0, b1 = torch.randint(0, 2, (2, key, lanes), device=dev,
                                   dtype=torch.int32)
            return k8_shape(label, (*tabs, b0, b1))
        if kname.startswith("scalar_mul_bits"):
            return k6_shape(g2k, key, lanes)
        if kname.startswith("hash_to_field"):
            return h1_shape(kname, key, lanes)
        fail(f"no inputs for {kname} at {key}, {lanes} lanes")

    def k6_shape(g2, nbits, lanes, label=None):
        """A K6 shape: need from these bits, code and chain from the
        program's own counts for nbits steps; a dkg phase's shape with
        Horner inputs."""
        horner = ("scalar_mul_bits_g2" if g2 else "scalar_mul_bits",
                  nbits, lanes) in dkg_keys
        pts, bits = k6_inputs(g2, nbits, lanes, horner)
        if horner and label is None:
            label = (f"{nbits} bits at {lanes} (dkg: Z != 1 lanes, "
                     f"infinity, zero scalar)")
        kind = "ladder_g2" if g2 else "ladder_g1"
        counts = FP.lane_counts(kind, [0] * nbits)
        if g2:
            dbl, add = _imad(G2_DBL_NEED), _imad(G2_ADD_NEED)
        else:
            dbl, add = _imad(2, 5), _imad(11, 5)
        return (label or f"{nbits} bits at {lanes}", nbits, lanes,
                lambda: K.scalar_mul_bits(pts, bits),
                Plain("scalar_mul_bits_plain", pts, bits), err_flat,
                (need_ladder_var(bits, dbl, add) / lanes,
                 code_group(counts)), (12 if g2 else 6) + nbits / 12,
                chain(kind, counts))

    # K6's tail check: 16 bits over 5 lanes, no multiple of a block's lanes;
    # H1's DIGEST front of a chained chunk whose first previous signature is
    # a 32-byte genesis seed, at N: the edge phase's strict walks launch
    # it (a shape is held once, so it goes in before the recorded ones)
    for sp in specs:
        if sp[0].startswith("scalar_mul_bits"):
            sp[5].append(k6_shape(sp[0].endswith("_g2"), 16, 5,
                                  "16 bits at 5 lanes (check)"))
        if sp[0] == "hash_to_field_fp2":
            sp[5].append(h1_shape("hash_to_field_fp2", "msg", pad,
                                  "digest at N, genesis-seed chunk",
                                  genesis_seed=True))
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

    # -- phase h2f_front: H1 at every shape the paths launched, against its
    # plain version (limbs) and the host oracle (hashlib + host
    # hash_to_field, canonical integers); SHA-256 and xmd entries beside
    front_checks = []
    for kname in ("hash_to_field", "hash_to_field_fp2"):
        for label, kind, lanes, kfn, pfn, *_ in by_name[kname]:
            c, _ = h1_cases[(kname, label)]
            got = kfn()
            torch.cuda.synchronize()
            e = err(got, pfn())
            ints = [L.decode_mont(u) for u in got]
            if c["fp2"]:
                host = [[x for u in H2C.hash_to_field_fp2(m, c["dst"], 2)
                         for x in u] for m in c["msgs"]]
            else:
                host = [H2C.hash_to_field_fp(m, c["dst"], 2)
                        for m in c["msgs"]]
            bad_lanes = [i for i, h in enumerate(host)
                         if [col[i] for col in ints] != list(h)]
            front_checks.append({"kernel": kname, "shape": label,
                                 "lanes": lanes, "max_abs_err_vs_plain": e,
                                 "lanes_unequal_to_host": len(bad_lanes),
                                 "launches_on_paths": sum(
                                     sh.get((kname, kind, lanes), 0)
                                     for _, sh in ran.values())})
    chain_msgs = [chained.digest_beacon(r, p) for r, p in
                  zip(rounds, [None] + usigs[1:])]
    sha_in = torch.from_numpy(SHA.pack_msgs_to_words(
        [p + r.to_bytes(8, "big") for r, p in zip(rounds[1:], usigs[1:])]
    )).to(dev)
    sha_got = K.sha256_words(sha_in)
    sha_ok = SHA.digest_bytes(sha_got) == chain_msgs[1:] and \
        torch.equal(sha_got, SHA.sha256_words(sha_in))
    dw = torch.from_numpy(SHA.pack_msgs_to_words(chain_msgs, 32)).to(dev)
    xmd_got = K.expand_msg_xmd(dw, 32, chained.dst, 256)
    xmd_ok = torch.equal(xmd_got, K.expand_msg_xmd_plain(
        dw, 32, chained.dst, 256)) and all(
            row.astype(">u4").tobytes() == H2C.expand_message_xmd(
                m, chained.dst, 256)
            for row, m in zip(xmd_got.cpu().numpy(), chain_msgs))
    emit({"phase": "h2f_front", "tolerance": "exact: H1 limbs equal the "
          "plain version's, canonical integers the host hash_to_field's",
          "shapes": front_checks,
          "sha256_words_104B_at_N_equal_hashlib_and_plain": sha_ok,
          "expand_msg_xmd_256B_at_N_equal_host_and_plain": xmd_ok,
          "device": name, "nvidia_smi": smi_line})
    if not sha_ok or not xmd_ok or any(
            c["max_abs_err_vs_plain"] or c["lanes_unequal_to_host"]
            for c in front_checks):
        fail(f"H1 disagrees: {front_checks}, sha256 {sha_ok}, xmd {xmd_ok}")
    if not any(c["launches_on_paths"] for c in front_checks
               if c["shape"].startswith("raw_chained")):
        fail("no path launched H1 on the raw chained front")

    # Every shape's plain twin, the narrow ones of a kernel that one call
    # can run together joined (Plain, run_plain): run apart they took some
    # 550 s of an 845 s run on the H100.  Each call's wall is reported once
    # (plain_calls); a shape has a plain_ms of its own only where its call
    # held it alone.
    jobs = [(kname, i) for kname, *_, shapes in specs
            for i in range(len(shapes))]
    # the twins are launch-bound Python: a thread the earlier phases left
    # running would take the interpreter from them
    threads_alive = sorted(th.name for th in threading.enumerate())
    t0 = time.perf_counter()
    plain_out, walls = run_plain(
        [by_name[kname][i][4] for kname, i in jobs], torch.cuda.synchronize,
        tags=[kname for kname, _ in jobs])
    plains = dict(zip(jobs, plain_out))
    plain_wall_s = time.perf_counter() - t0
    plain_calls = [{"kernel": jobs[w["members"][0]][0], "ms": w["ms"],
                    "lanes": w["lanes"],
                    "shapes": [by_name[jobs[j][0]][jobs[j][1]][0]
                               for j in w["members"]]} for w in walls]

    table, checks, path_ms = [], {}, {p: 0.0 for p in ran}
    for kname, src, line, tpu, needles, shapes in specs:
        ms = once_ms = ops_ms = bytes_ms = code_ms = 0.0
        max_err, detail, k_calls = 0, [], set()
        for i, (label, key, lanes, kfn, pfn, cmp, imads, words,
                *extra) in enumerate(shapes):
            counts = {p: sh.get((kname, key, lanes), 0)
                      for p, (_, sh) in ran.items()}
            count = sum(counts.values())
            print(f"chip_smoke: {kname} {label}", file=sys.stderr, flush=True)
            try:
                k_out = kfn()
                torch.cuda.synchronize()
            except RuntimeError as e:
                fail(f"{kname} at {label}: {e}")
            p_out, call = plains[(kname, i)]
            k_calls.add(call)
            p_ms = plain_calls[call]["ms"] \
                if len(plain_calls[call]["shapes"]) == 1 else None
            e = cmp(k_out, p_out)
            checks[f"{kname} {label}"] = e
            max_err = max(max_err, e)
            k_ms = timed(kfn, args.reps)
            if kname in k2_kind or kname in k7_kind:
                # K2 and K7: each compiled width, checked
                by_width = {}
                kind = {**k2_kind, **k7_kind}[kname]
                for w in k2_widths(kind):
                    e = cmp(at_width(kind, w, kfn), p_out)
                    checks[f"{kname} {label} at {w} threads"] = e
                    max_err = max(max_err, e)
                    by_width[w] = timed(lambda: at_width(kind, w, kfn),
                                        args.reps)
                unit = "add" if kname in k7_kind else "lane"
                extra = [dict(extra[0], **{f"ms_at_threads_per_{unit}":
                                           by_width})]
            o_ms, b_ms = bound_ms(imads[0], lanes, words)
            c_ms = bound_ms(imads[1], lanes, words)[0]
            ms += count * k_ms
            once_ms += k_ms
            ops_ms += count * o_ms
            bytes_ms += count * b_ms
            code_ms += count * c_ms
            for p, c in counts.items():
                path_ms[p] += c * k_ms
            detail.append({"shape": label, "lanes": lanes, "launches": counts,
                           "ms": k_ms, "plain_ms": p_ms, "plain_call": call,
                           "bound_ms": max(o_ms, b_ms), "code_ops_ms": c_ms,
                           "imads_per_lane": imads[0],
                           "code_imads_per_lane": imads[1],
                           **(extra[0] if extra else {})})
        launched = sum(lc[kname] for lc, _ in ran.values())
        if sum(sum(d["launches"].values()) for d in detail) != launched:
            fail(f"{kname}: per-shape launches {detail} do not add up to "
                 f"{launched}")
        of_which = {g: {"launches": sum(c for d in detail
                                        for p, c in d["launches"].items()
                                        if p in ps),
                        "ms": sum(c * d["ms"] for d in detail
                                  for p, c in d["launches"].items()
                                  if p in ps)}
                    for g, ps in groups.items()}
        table.append({
            "name": kname, "tpu_kernel": tpu, "route": "cuda",
            "source": f"drand_tpu_torch/ops/csrc/{src}",
            "replaces": line if isinstance(line, str)
            else f"drand_tpu/ops/pallas_field.py:{line}",
            "launches": launched, "of_which": of_which,
            "max_abs_err": max_err,
            "ms": ms, "plain_ms": sum(plain_calls[c]["ms"] for c in k_calls),
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None, "code_ops_ms": code_ms,
            "ms_every_shape_once": once_ms,
            "plain_calls": sorted(k_calls),
            "plain_ms_taken": "plain_ms is the wall of the plain twin's "
                              "calls over every shape in per_shape once, "
                              "each call counted once (plain_calls: the "
                              "kernels_vs_plain phase's list; narrow shapes "
                              "of the same arguments joined up to "
                              f"{PLAIN_JOIN_LANES} lanes); compare it with "
                              "ms_every_shape_once, the kernel on the same "
                              "shapes.  A shape's own plain_ms is null where "
                              "its call held other shapes",
            "times_are": f"ms, bound_ms and code_ops_ms are sums over the "
                         f"launches of the main paths: the "
                         f"RLC runs and exact passes at {n} rounds of both "
                         f"signature groups, the threshold phases at {nrp} "
                         f"rounds x {THRESHOLD} partials, the dkg phase's "
                         f"paths ({DKG_N} dealers x {DKG_T} on both key "
                         f"groups, the {CEREMONY_N}-node ceremony), the "
                         f"beacon phases' networks ({N_NODES} nodes, t = "
                         f"{THRESHOLD}: (1, {N_NODES}) partials checks, "
                         f"{BEACON_CHUNK}-round sync and scan chunks), the "
                         f"edge phase's strict walks ({EDGE_ROUNDS} chained "
                         f"rounds through the process-default service: "
                         f"one client, {EDGE_CLIENTS} at once, a forged "
                         f"pair), and the daemon phase's in-process paths "
                         f"(its rounds verified and the "
                         f"(1, {DAEMON_N}) partials check; the daemons' "
                         f"own launches are in their processes)",
            "per_shape": detail,
            "ptxas": entry_stats(regs, src, *needles),
            "group": group_layout.get(kname),
            "device": name, "nvidia_smi": smi_line})
    emit({"phase": "kernels_vs_plain", "tolerance": "exact (integer "
          "arithmetic): max |kernel - plain| over 16-bit limbs",
          "plain_twins_wall_s": plain_wall_s, "plain_calls": plain_calls,
          "threads_alive": threads_alive,
          "shapes": len(jobs),
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
    _, stages["h1_hash_to_field"] = wall_ms(
        lambda: verifier._fields_enc(rlc_enc3, rlc_front))
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
    sums, stages["sum_rows_two_sums"] = wall_ms(
        lambda: K.sum_rows(tuple(t.reshape(2, pad, L.NLIMB) for t in mult)))
    sums = [tuple(c[i] for c in sums) for i in (0, 1)]
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
    _, st2["h1_hash_to_field"] = wall_ms(
        lambda: g2v._fields_enc(g2_enc3, g2_front))
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
    sums2, st2["sum_rows_two_sums"] = wall_ms(
        lambda: K.sum_rows(DC._tmap(
            lambda t: t.reshape(2, 2 * pad, L.NLIMB), mult2)))
    sums2 = [DC._tmap(lambda c: c[i], sums2) for i in (0, 1)]

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

    # Inside the narrow K3 / K4 launches: the same calls with other loop
    # bits give each program fragment's latency on one lane (a loop of
    # zero bits runs the square step alone, of one bits the square and the
    # add step), and the fixed part (wrapper, set-up, K4's inverse and
    # the steps between its chains).  Not main-path launches.
    def chain_split():
        saved = K.XLOOP_BITS
        f1 = lambda: K.final_exponentiation(fe1)
        m_2 = lambda: K.miller_loop(*m2)
        t = {}
        try:
            for label, bits in (("none", []), ("zeros", [0] * 63),
                                ("ones", [1] * 63)):
                K.XLOOP_BITS = bits
                t[label] = (timed(f1, args.reps), timed(m_2, args.reps))
        finally:
            K.XLOOP_BITS = saved
        k4_sq = (t["zeros"][0] - t["none"][0]) / (5 * 63) * 1e3
        k3_sq = (t["zeros"][1] - t["none"][1]) / 63 * 1e3
        return {"k4_1_lane_fixed_ms": t["none"][0],
                "k4_cyclotomic_square_us": k4_sq,
                "k4_dense_product_us":
                    (t["ones"][0] - t["zeros"][0]) / (5 * 63) * 1e3,
                "k3_2_pairs_fixed_ms": t["none"][1],
                "k3_double_step_us": k3_sq,
                "k3_add_step_us": (t["ones"][1] - t["zeros"][1]) / 63 * 1e3,
                "fragments": {k: FP.frag_stats(k)
                              for k in ("miller", "finalexp")}}

    emit({"phase": "where_the_time_goes", "rounds": n,
          "group_phase_us": phase,
          "k3_k4_narrow_launches": chain_split(),
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
