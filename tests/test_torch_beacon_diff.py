"""The port's beacon layer against the reference, byte for byte.

The same seeded network (n = 4, t = 3: the same node keys, group
polynomial, genesis and clock steps) runs through the reference
(tests/harness.py's BeaconScenario) and through the port
(tests/torch_beacon_harness.py, host partial checks) for 3 rounds on
`pedersen-bls-chained` and `bls-unchained-on-g1`: every node of both
stores the same beacons, byte for byte.  The port's host tbls
(`verify_partial`, `recover`, `verify_recovered`) are held against the
reference's on the same seeded partials: a forged one, duplicate indices,
fewer than t valid.
"""

import random

import pytest

import harness as ref_harness
import torch_beacon_harness as H

from drand_tpu.crypto import tbls as ref_tbls
from drand_tpu.crypto.schemes import scheme_from_name as ref_scheme
from drand_tpu_torch.crypto.host import tbls
from drand_tpu_torch.crypto.host.params import R
from drand_tpu_torch.crypto.schemes import scheme_from_name

N, T, ROUNDS = 4, 3, 3
SCHEMES = ("pedersen-bls-chained", "bls-unchained-on-g1")


def _coeffs(seed):
    rng = random.Random(seed)
    return [rng.randrange(1, R) for _ in range(T)]


def _run(scenario):
    try:
        scenario.start_all()
        scenario.advance_to_genesis()
        for r in range(1, ROUNDS + 1):
            scenario.wait_all(r)
            if r < ROUNDS:
                scenario.advance_round()
        return {i: [(b.round, b.signature, b.previous_sig)
                    for b in h.chain.store.cursor()]
                for i, h in scenario.handlers.items()}
    finally:
        scenario.stop_all()


@pytest.mark.parametrize("scheme_id", SCHEMES)
def test_stored_chains_are_byte_identical(scheme_id, monkeypatch):
    coeffs = _coeffs(scheme_id)
    monkeypatch.setattr(ref_tbls.PriPoly, "random", classmethod(
        lambda cls, threshold, secret=None: cls(list(coeffs))))
    ref_chains = _run(ref_harness.BeaconScenario(N, T, scheme_id=scheme_id))
    port_chains = _run(H.BeaconScenario(N, T, scheme_id=scheme_id,
                                        poly_coeffs=coeffs))
    assert sorted(ref_chains) == sorted(port_chains) == list(range(N))
    for i in range(N):
        assert [b[0] for b in port_chains[i]] == list(range(ROUNDS + 1))
        assert port_chains[i] == ref_chains[i], f"node {i}"
    assert len({tuple(c) for c in port_chains.values()}) == 1


def _partials(port_scheme, ref_sch, coeffs, msg):
    """Each signer's partial from both packages (equal bytes), plus a
    forged one: signer 1's index on signer 2's signature."""
    poly = tbls.PriPoly(list(coeffs))
    ref_poly = ref_tbls.PriPoly(list(coeffs))
    parts = [tbls.sign_partial(port_scheme, poly.eval(i), msg)
             for i in range(N)]
    assert parts == [ref_tbls.sign_partial(ref_sch, ref_poly.eval(i), msg)
                     for i in range(N)]
    forged = (1).to_bytes(2, "big") + parts[2][2:]
    return poly, ref_poly, parts, forged


@pytest.mark.parametrize("scheme_id", SCHEMES)
def test_host_tbls_agree_with_the_reference(scheme_id):
    sch, rsch = scheme_from_name(scheme_id), ref_scheme(scheme_id)
    coeffs = _coeffs("tbls" + scheme_id)
    msg = sch.digest_beacon(5, b"\x09" * 32)
    poly, ref_poly, parts, forged = _partials(sch, rsch, coeffs, msg)
    pub = poly.commit(sch.key_group)
    ref_pub = ref_poly.commit(rsch.key_group)
    # verify_partial: every honest partial, the forged one, a bad index
    cases = parts + [forged, (1 << 15).to_bytes(2, "big") + parts[0][2:]]
    got = [tbls.verify_partial(sch, pub, msg, p) for p in cases]
    want = [ref_tbls.verify_partial(rsch, ref_pub, msg, p) for p in cases]
    assert got == want == [True] * N + [False, False]
    # recover: the forged partial first and a duplicate index are skipped
    # (verify_each), the first t valid distinct signers interpolate
    rows = [forged, parts[3], parts[3], parts[0], parts[2], parts[1]]
    sig = tbls.recover(sch, pub, msg, rows, T, N)
    assert sig == ref_tbls.recover(rsch, ref_pub, msg, rows, T, N)
    assert sig == sch.sign(coeffs[0], msg)
    # without verify_each the forged partial is used: a wrong signature,
    # the same wrong bytes in both packages
    bad = tbls.recover(sch, pub, msg, rows, T, N, verify_each=False)
    assert bad == ref_tbls.recover(rsch, ref_pub, msg, rows, T, N,
                                   verify_each=False)
    assert bad != sig
    pk = pub.public_key()
    assert tbls.verify_recovered(sch, pk, msg, sig) is True
    assert tbls.verify_recovered(sch, pk, msg, bad) is False
    assert ref_tbls.verify_recovered(rsch, ref_pub.public_key(), msg,
                                     bad) is False
    # fewer than t valid distinct partials: ValueError in both
    short = [forged, parts[0], parts[0], parts[2]]
    for mod, s, p in ((tbls, sch, pub), (ref_tbls, rsch, ref_pub)):
        with pytest.raises(ValueError):
            mod.recover(s, p, msg, short, T, N)
