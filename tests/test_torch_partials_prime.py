"""BatchPartialVerifier primes its public shares through the device DKG
math (drand_tpu_torch/crypto/partials.py -> crypto/dkg_device.py
prime_public_shares), as the JAX package's does at committee scale.

With ``dkg_device.MIN_N`` lowered to the group's size, a CPU verifier
(``device="cpu"``) evaluates all n public shares in one dispatch and primes
the PubPoly memo; its shares equal the host's ``PubPoly.eval`` and its
state (the shares' Montgomery limbs) equals an unprimed verifier's bit for
bit, so its verdicts are the unprimed verifier's: a block of valid partials
verifies.  Below the threshold no dispatch is made.
"""

import pytest
import torch

from drand_tpu_torch.crypto import dkg_device as DD
from drand_tpu_torch.crypto import partials as PP
from drand_tpu_torch.crypto import schemes
from drand_tpu_torch.crypto.host import tbls as HT

SCHEME = "bls-unchained-on-g1"      # keys, and so the shares, on G2
N = 5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def group():
    sch = schemes.scheme_from_name(SCHEME)
    poly = HT.PriPoly([0x5EED, 0xC0FFEE, 0xBEEF])
    return sch, poly


def _verifier(sch, poly, min_n):
    pp = poly.commit(sch.key_group)
    mp = pytest.MonkeyPatch()
    mp.setattr(DD, "MIN_N", min_n)
    try:
        before = DD.dispatch_count()
        bv = PP.BatchPartialVerifier(sch, pp, N, device="cpu")
        return bv, pp, DD.dispatch_count() - before
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def primed(group):
    return _verifier(*group, N)


@pytest.fixture(scope="module")
def unprimed(group):
    return _verifier(*group, 64)


def test_primed_in_one_dispatch(group, primed):
    sch, poly = group
    bv, pp, dispatches = primed
    assert dispatches == 1
    assert sorted(pp._eval_cache) == list(range(N))
    oracle = poly.commit(sch.key_group)
    assert bv.pub_points == [oracle.eval(i) for i in range(N)]


def test_unprimed_below_threshold(unprimed):
    bv, pp, dispatches = unprimed
    assert dispatches == 0
    assert len(bv.pub_points) == N


def test_primed_state_and_verdicts_equal_unprimed(group, primed, unprimed):
    sch, poly = group
    (bv, _, _), (ref, _, _) = primed, unprimed
    assert bv.pub_points == ref.pub_points
    for a, b in ((bv.pk_x, ref.pk_x), (bv.pk_y, ref.pk_y)):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    msg = sch.digest_beacon(1)
    row = [HT.sign_partial(sch, poly.eval(i), msg) for i in (0, 2, 4)]
    assert bv.verify_partials([msg], [row]).tolist() == [[True] * 3]
