"""The port's device DKG math (drand_tpu_torch/crypto/dkg_device.py) against
the JAX package's (drand_tpu/crypto/dkg_device.py) on the G1 key group.

The cases of tests/test_dkg_device.py: the same host points (made from a
seed) go through the JAX pipelines (their CPU lowering, as that file runs
them) and through the port on CPU tensors (``device="cpu"``: K6's plain
version).  Verdicts must be equal exactly, points as affine integers, and
both equal the host loops'.  Shapes are those of tests/test_dkg_device.py,
so the JAX programs are the ones that file compiles.  The combine cases
are in tests/test_torch_dkg_combine.py, the G2 key group's in
tests/test_torch_dkg_device_g2.py.
"""

import random

import pytest
import torch

from drand_tpu.crypto import dkg_device as JDD
from drand_tpu.crypto import schemes as JS
from drand_tpu.crypto import tbls as JT
from drand_tpu.crypto.host.params import R

from drand_tpu_torch.crypto import dkg as D
from drand_tpu_torch.crypto import dkg_device as DD
from drand_tpu_torch.crypto import schemes
from drand_tpu_torch.crypto.host import tbls as HT

SCHEME = "pedersen-bls-chained"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run as thousands of small int64 ops; under
    several test workers torch's intra-op threads only contend."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def grp():
    return schemes.scheme_from_name(SCHEME).key_group


@pytest.fixture(scope="module")
def jgrp():
    return JS.scheme_from_name(SCHEME).key_group


def _polys(g, m, t, rng):
    polys = [HT.PriPoly([rng.randrange(R) for _ in range(t)])
             for _ in range(m)]
    return polys, [p.commit(g) for p in polys]


def _host_verdicts(g, pubs, holder, shares):
    c = g.curve
    return [c.mul(c.gen, s) == HT.PubPoly(g, list(pubs[d].commits)).eval(
        holder) for d, s in enumerate(shares)]


# ---------------------------------------------------------------------------
# routing: below MIN_N the host loops, at it the device, never a quiet host
# ---------------------------------------------------------------------------

def test_use_device_threshold(monkeypatch):
    monkeypatch.setattr(DD, "MIN_N", 64)
    assert not DD.use_device(63)
    assert DD.use_device(64)
    monkeypatch.setattr(DD, "MIN_N", 0)
    assert not DD.use_device(10 ** 6)       # 0 disables outright
    assert DD.use_device(8, min_n=4)
    monkeypatch.setattr(DD, "_ENABLED", False)   # DRAND_DKG_DEVICE=0
    assert not DD.use_device(8, min_n=4)


def test_small_sessions_stay_on_host(monkeypatch, grp):
    """Below the lane threshold the state machine never touches the device
    module's entry points."""
    monkeypatch.setattr(DD, "MIN_N", 64)
    for fn in ("verify_shares", "constant_terms_match", "combine_commits",
               "eval_all"):
        monkeypatch.setattr(DD, fn,
                            lambda *a, **k: pytest.fail("device path taken"))
    rng = random.Random(5)
    polys, pubs = _polys(grp, 3, 3, rng)
    gen = D.DistKeyGenerator.__new__(D.DistKeyGenerator)
    gen.scheme = schemes.scheme_from_name(SCHEME)
    gen.holder_index = 1
    gen._my_shares = {}
    gen.cfg = None          # no device is ever resolved below MIN_N
    cands = [(type("B", (), {"dealer_index": d})(), pubs[d],
              polys[d].eval(1).value) for d in range(3)]
    gen._adopt_matching_shares(cands)
    assert set(gen._my_shares) == {0, 1, 2}


def test_device_calls_raise_without_a_card(monkeypatch, grp):
    """At or above MIN_N with no card and no device="cpu", every device
    entry point and a routed state-machine seam raise; nothing drops to
    the host loop."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    rng = random.Random(3)
    polys, pubs = _polys(grp, 2, 2, rng)
    commits = [list(p.commits) for p in pubs]
    before = DD.dispatch_count()
    for call in (lambda: DD.verify_shares(grp, commits, 0, [1, 2]),
                 lambda: DD.eval_all(grp, commits[0], [0, 1]),
                 lambda: DD.constant_terms_match(grp, commits[0], [0, 1],
                                                 [None, None]),
                 lambda: DD.combine_commits(grp, commits),
                 lambda: DD.prime_public_shares(pubs[0], 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert DD.dispatch_count() == before
    monkeypatch.setattr(DD, "MIN_N", 2)
    sch = schemes.scheme_from_name(SCHEME)
    secs = [11, 12]
    nodes = [D.DkgNode(i, grp.to_bytes(grp.curve.mul(grp.curve.gen, s)))
             for i, s in enumerate(secs)]
    gens = [D.DistKeyGenerator(D.DkgConfig(
        scheme=sch, longterm=s, nonce=b"n", new_nodes=nodes, threshold=2))
        for s in secs]
    deals = [g.generate_deals() for g in gens]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gens[0].process_deal_bundles(deals)


# ---------------------------------------------------------------------------
# share verification: tampering, zero and infinity (one shared run)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def share_case(grp, jgrp):
    """m = 8 dealers, t = 4, holder 3 (the shape of tests/test_dkg_device.py
    's tampering case): a wrong-index share, a garbage share, a tampered
    non-constant and a tampered constant commitment, a forged zero share
    and an infinity commitment."""
    rng = random.Random(7)
    m, t, holder = 8, 4, 3
    polys, pubs = _polys(grp, m, t, rng)
    shares = [p.eval(holder).value for p in polys]
    shares[1] = polys[1].eval(holder + 1).value          # wrong index
    shares[2] = rng.randrange(R)                         # garbage
    pubs[4].commits[2] = grp.curve.mul(grp.curve.gen, rng.randrange(R))
    pubs[6].commits[0] = grp.curve.mul(grp.curve.gen, rng.randrange(R))
    shares[5] = 0                                        # forged zero share
    pubs[7].commits[1] = None                            # infinity commit
    commits = [list(p.commits) for p in pubs]
    before = DD.dispatch_count()
    port = DD.verify_shares(grp, commits, holder, shares, device="cpu")
    return {"port": port, "dispatches": DD.dispatch_count() - before,
            "jax": JDD.verify_shares(jgrp, commits, holder, shares),
            "host": _host_verdicts(grp, pubs, holder, shares)}


def test_verify_shares_parity_under_tampering(share_case):
    assert share_case["port"] == share_case["jax"] == share_case["host"]
    assert share_case["port"][0] and share_case["port"][3]
    assert not any(share_case["port"][d] for d in (1, 2, 4, 6))


def test_verify_shares_zero_and_infinity_edges(share_case):
    """share = 0 (infinity on the left) and an infinity commitment follow
    the host verdict exactly: both lanes reject, as the JAX lanes do."""
    for d in (5, 7):
        assert share_case["port"][d] == share_case["jax"][d] \
            == share_case["host"][d] is False


def test_verify_shares_one_dispatch(share_case):
    assert share_case["dispatches"] == 1


# ---------------------------------------------------------------------------
# one polynomial at many points: eval_all, the pin, priming
# ---------------------------------------------------------------------------

def test_eval_all_matches_jax_and_host(grp, jgrp):
    rng = random.Random(13)
    _, (pub,) = _polys(grp, 1, 5, rng)
    idxs = list(range(9))
    port = DD.eval_all(grp, list(pub.commits), idxs, device="cpu")
    fresh = HT.PubPoly(grp, list(pub.commits))
    assert port == JDD.eval_all(jgrp, list(pub.commits), idxs) \
        == [fresh.eval(i) for i in idxs]


def test_constant_terms_match_parity(grp, jgrp):
    rng = random.Random(17)
    _, (old,) = _polys(grp, 1, 4, rng)
    m = 6
    claimed = [old.eval(d) for d in range(m)]
    claimed[2] = grp.curve.mul(grp.curve.gen, 424242)    # key-change attempt
    claimed[5] = None
    port = DD.constant_terms_match(grp, list(old.commits), range(m),
                                   claimed, device="cpu")
    assert port == JDD.constant_terms_match(jgrp, list(old.commits),
                                            range(m), claimed) \
        == [True, True, False, True, True, False]


def test_prime_public_shares_one_dispatch(grp, jgrp):
    rng = random.Random(23)
    _, (pubp,) = _polys(grp, 1, 4, rng)
    pub = HT.PubPoly(grp, list(pubp.commits))
    before = DD.dispatch_count()
    mapping = DD.prime_public_shares(pub, 6, device="cpu")
    assert DD.dispatch_count() - before == 1
    assert set(mapping) == set(range(6))
    jpub = JT.PubPoly(jgrp, list(pubp.commits))
    jmap = JDD.prime_public_shares(jpub, 6)
    oracle = HT.PubPoly(grp, list(pubp.commits))
    for i in range(6):
        # the memo is primed: eval is a lookup equal to the device value
        assert pub._eval_cache[i] == mapping[i] == jmap[i] == oracle.eval(i)
        assert pub.eval(i) == mapping[i]
