"""The port's device DKG math on the G2 key group (bls-unchained-on-g1,
keys on G2) against the port's host golden code (crypto/host/curve.py,
crypto/host/tbls.py).

The G1 key group's cases run against the JAX package
(tests/test_torch_dkg_device.py, tests/test_torch_dkg_combine.py); here
the same kinds of input go through the G2 instance of K6's plain version
(``device="cpu"``): share verification with a wrong-index share, a
tampered commitment, a zero share and an infinity commitment, the
constant-term pin, priming, and the plain combine.
"""

import random

import pytest
import torch

from drand_tpu_torch.crypto import dkg_device as DD
from drand_tpu_torch.crypto import schemes
from drand_tpu_torch.crypto.host import tbls as HT
from drand_tpu_torch.crypto.host.params import R

SCHEME = "bls-unchained-on-g1"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def g():
    grp = schemes.scheme_from_name(SCHEME).key_group
    assert grp.point_len == 96
    return grp


def _pubs(g, m, t, rng):
    polys = [HT.PriPoly([rng.randrange(R) for _ in range(t)])
             for _ in range(m)]
    return polys, [p.commit(g) for p in polys]


def test_verify_shares_g2_matches_host(g):
    rng = random.Random(29)
    m, t, holder = 5, 2, 2
    polys, pubs = _pubs(g, m, t, rng)
    shares = [p.eval(holder).value for p in polys]
    shares[1] = polys[1].eval(holder + 1).value          # wrong index
    pubs[2].commits[1] = g.curve.mul(g.curve.gen, rng.randrange(R))
    shares[3] = 0                                        # zero share
    pubs[4].commits[1] = None                            # infinity commit
    before = DD.dispatch_count()
    got = DD.verify_shares(g, [list(p.commits) for p in pubs], holder,
                           shares, device="cpu")
    assert DD.dispatch_count() - before == 1
    host = [g.curve.mul(g.curve.gen, s) == HT.PubPoly(
        g, list(pubs[d].commits)).eval(holder) for d, s in enumerate(shares)]
    assert got == host == [True, False, False, False, False]


def test_eval_pin_and_prime_g2_match_host(g):
    rng = random.Random(31)
    _, (old,) = _pubs(g, 1, 3, rng)
    m = 4
    oracle = HT.PubPoly(g, list(old.commits))
    want = [oracle.eval(d) for d in range(m)]
    assert DD.eval_all(g, list(old.commits), range(m), device="cpu") == want
    claimed = list(want)
    claimed[1] = g.curve.add(claimed[1], g.curve.gen)    # key-change attempt
    assert DD.constant_terms_match(g, list(old.commits), range(m), claimed,
                                   device="cpu") == [True, False, True, True]
    pub = HT.PubPoly(g, list(old.commits))
    before = DD.dispatch_count()
    mapping = DD.prime_public_shares(pub, m, device="cpu")
    assert DD.dispatch_count() - before == 1
    assert [mapping[i] for i in range(m)] == want
    assert [pub._eval_cache[i] for i in range(m)] == want


def test_combine_g2_matches_host(g):
    """The plain combine's halving tree on G2 points.  The weighted form's
    one 256-bit ladder is the G2 K6 path verify_shares takes above; its
    lane layout is curve-blind and held against the JAX package on G1
    (tests/test_torch_dkg_combine.py)."""
    rng = random.Random(37)
    m, t = 3, 2
    _, pubs = _pubs(g, m, t, rng)
    matrix = [list(p.commits) for p in pubs]
    matrix[1][0] = None
    c = g.curve
    plain = [None] * t
    for j in range(t):
        for d in range(m):
            plain[j] = c.add(plain[j], matrix[d][j])
    assert DD.combine_commits(g, matrix, device="cpu") == plain
