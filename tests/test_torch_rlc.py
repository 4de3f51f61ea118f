"""The port's RLC pass and verifier API (drand_tpu_torch/crypto/batch.py,
plain versions on the CPU) vs the JAX package.

Tier-1: an all-valid batch passes with one RLC pass and no exact pass;
a device-bad slot fails the RLC check unless its lane is beyond n (zero
coefficient); the randomizer keys and device bit planes; the pack /
dispatch / resolve triple and verify_stream; the API the JAX verifier
exposes.  Marked slow + heavy_compile: the fused verdict and the per-lane
subgroup mask bit for bit against the JAX ``_rlc_run_g1sig`` fed the same
bit planes (jax's threefry stream cannot be reproduced, so the JAX
sampler is replaced inside the test), whose cold CPU compile takes
minutes.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drand_tpu.crypto import batch as JB

from drand_tpu_torch import convert as CV
from drand_tpu_torch.crypto import batch as B
from drand_tpu_torch.ops import kernels as K

from test_torch_batch import GOOD, JSCHEME, PK_BYTES, ROUNDS, SCHEME, SIGS


def verifier(**kw):
    return B.BatchBeaconVerifier(SCHEME, PK_BYTES, device="cpu", **kw)


def passes_of(fn):
    before = B.pass_counts()
    out = fn()
    after = B.pass_counts()
    return out, {k: after[k] - before[k] for k in after}


def test_all_valid_batch_takes_one_rlc_pass(monkeypatch):
    """pad_to=16: the 8 rounds run as one RLC pass at width 16, n = 8."""
    seen = []
    real = B._rlc_run_g1sig

    def spy(sig_x, sign, u0, u1, n, *rest, **kw):
        seen.append((sig_x.shape[0], n))
        return real(sig_x, sign, u0, u1, n, *rest, **kw)

    monkeypatch.setattr(B, "_rlc_run_g1sig", spy)
    v = verifier(pad_to=16)
    K.reset_launches()
    total = B.dispatch_count()
    got, passes = passes_of(lambda: v.verify_batch(ROUNDS, GOOD,
                                                   [None] * len(ROUNDS)))
    assert got.dtype == bool and got.tolist() == [True] * 8
    assert passes == {"rlc": 1, "exact": 0}
    assert B.dispatch_count() - total == 1
    assert seen == [(16, 8)]
    assert all(c == 0 for c in K.LAUNCHES.values())   # plain versions only


@pytest.fixture(scope="module")
def other_round_batch():
    """GOOD with slot 6 carrying round 108's signature: wire-valid, in G1,
    wrong for its message.  Encoded once at pad 8."""
    v = verifier()
    sigs = list(GOOD)
    sigs[6] = GOOD[7]
    enc, bad = v._encode(sigs, v._messages(ROUNDS), 8)
    assert not bad.any()
    return v, enc


@pytest.mark.parametrize("n,want", [(8, False), (6, True)])
def test_rlc_verdict_masks_lanes_beyond_n(other_round_batch, n, want):
    """With n = 6 the bad slot is a pad lane: zero coefficient, inert."""
    v, enc = other_round_batch
    b = np.random.default_rng(20240613).integers(0, 2, (2, 64, 8))
    b[:, :, n:] = 0
    sub_ok, ok = B._rlc_run_g1sig(*enc, n, v.pk_aff, v.fixed_aff,
                                  bits=CV.rlc_bits(b))
    assert sub_ok.tolist() == [True] * 8
    assert bool(ok) is want


def test_rlc_keys_resample_equal_halves(monkeypatch):
    draws = iter([b"\x07" * 16, b"\x01" * 8 + b"\x02" * 8])
    monkeypatch.setattr(B.secrets, "token_bytes", lambda k: next(draws))
    assert B._rlc_keys() == (int.from_bytes(b"\x01" * 8, "little"),
                             int.from_bytes(b"\x02" * 8, "little"))
    monkeypatch.undo()
    a, b = B._rlc_keys(), B._rlc_keys()          # fresh entropy per pass
    assert a != b and a[0] != a[1]


def test_device_bits_zero_on_pad_lanes():
    mask = torch.arange(16) < 5
    keys = B._rlc_keys()
    b0, b1 = B._device_rlc_bits(keys, mask)
    for b in (b0, b1):
        assert b.shape == (64, 16) and b.dtype == torch.int32
        assert set(b.unique().tolist()) <= {0, 1}
        assert not b[:, 5:].any() and b[:, :5].any()
    again = B._device_rlc_bits(keys, mask)
    assert all(torch.equal(x, y) for x, y in zip((b0, b1), again))
    other = B._device_rlc_bits(B._rlc_keys(), mask)
    assert not torch.equal(torch.cat(other), torch.cat((b0, b1)))
    # equal halves would cancel: the reason _rlc_keys resamples them
    same = B._device_rlc_bits((keys[0], keys[0]), mask)
    assert not torch.cat(same).any()


class Beacon:
    def __init__(self, round_, signature, previous_sig=None):
        self.round, self.signature = round_, signature
        self.previous_sig = previous_sig


def test_verify_stream_packs_dispatches_and_resolves():
    """Chunk 1 (8 valid) resolves from its RLC verdict; chunk 2 holds a
    47-byte signature, so dispatch returns None and resolve bisects to
    the exact pass."""
    v = verifier()
    beacons = [Beacon(r, s) for r, s in zip(ROUNDS, GOOD)]
    beacons += [Beacon(ROUNDS[i], SIGS[i] if i == 3 else GOOD[i])
                for i in (0, 1, 3, 7)]
    packed = v.pack_chunk(ROUNDS[:2], GOOD[:2])
    assert B.pack_seconds() > 0 and packed[0] == 2
    out, passes = passes_of(lambda: list(v.verify_stream(beacons,
                                                         chunk_size=8)))
    assert [r for r, _ in out] == [ROUNDS, [ROUNDS[i] for i in (0, 1, 3, 7)]]
    assert [ok.tolist() for _, ok in out] == [[True] * 8,
                                              [True, True, False, True]]
    assert passes == {"rlc": 1, "exact": 1}


def test_pipeline_depth_is_clamped_by_the_inflight_budget():
    v = verifier()
    assert v.pipeline_depth() == B.DEFAULT_PIPELINE_DEPTH
    assert v.pipeline_depth(10 ** 9) == B.max_pipeline_depth(8192)
    assert v.pipeline_depth(0) == 1


def test_verifier_api_matches_jax():
    jv = JB.BatchBeaconVerifier
    assert B.BatchBeaconVerifier.kind == jv.kind == "device"
    assert B.BatchBeaconVerifier._BISECT_MIN == jv._BISECT_MIN == 64
    for name in ("verify_batch", "verify_chain", "pack_chunk",
                 "dispatch_packed", "resolve_packed", "pipeline_depth",
                 "verify_stream"):
        want = list(inspect.signature(getattr(jv, name)).parameters)
        got = list(inspect.signature(
            getattr(B.BatchBeaconVerifier, name)).parameters)
        assert got == want, name
    params = inspect.signature(B.BatchBeaconVerifier).parameters
    assert list(params)[:3] == ["scheme", "public_key_bytes", "pad_to"]
    assert params["pad_to"].default is None
    assert verifier(pad_to=64)._pad_for(3) == 64
    assert verifier()._pad_for(3) == 8


def test_verify_chain_passes_previous_sig_through(monkeypatch):
    v = verifier()
    calls = []
    monkeypatch.setattr(v, "verify_batch", lambda *a: calls.append(a)
                        or np.array([True, False]))
    all_ok, valid = v.verify_chain([Beacon(5, b"s5", b"p4"),
                                    Beacon(6, b"s6", b"s5")])
    assert calls == [([5, 6], [b"s5", b"s6"], [b"p4", b"s5"])]
    assert all_ok is False and valid.tolist() == [True, False]


@pytest.mark.slow
@pytest.mark.heavy_compile
def test_rlc_pass_matches_jax_with_same_planes(monkeypatch):
    """The JAX sampler is replaced by one that returns its `keys` operand,
    so the planes ride in as a traced argument and one compile serves
    every case."""
    monkeypatch.setattr(JB, "_device_rlc_bits",
                        lambda keys, mask, split: (keys[0], keys[1]))
    jv = JB.BatchBeaconVerifier(JSCHEME, PK_BYTES)
    state = CV.verifier_state(jv)
    msgs = [JSCHEME.digest_beacon(r, None) for r in ROUNDS]
    run = jax.jit(JB._rlc_run_g1sig)
    for sigs, n, want in ((SIGS, 8, False), (GOOD, 8, True), (SIGS, 1, True)):
        planes = JB._rlc_scalars(n, 8, split=2)
        jenc, _ = jv._encode(sigs, msgs, 8)
        want_sub, want_ok = run(*jenc, jnp.stack(planes), jnp.uint32(n),
                                jv.pk_aff, jv.fixed_aff)
        got_sub, got_ok = B._rlc_run_g1sig(
            *CV.encoding(jenc), n, state["pk_aff"], state["fixed_aff"],
            bits=CV.rlc_bits(planes))
        np.testing.assert_array_equal(got_sub.numpy(), np.asarray(want_sub))
        assert bool(got_ok) is bool(want_ok) is want
