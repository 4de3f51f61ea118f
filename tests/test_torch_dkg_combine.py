"""The finalization combine of the port's device DKG math
(drand_tpu_torch/crypto/dkg_device.py combine_commits) against the JAX
package's and the host loop, on the G1 key group.

m = 5 dealers of t = 3 commitments (the shape of tests/test_dkg_device.py's
combine case): the weighted form (a reshare's Lagrange recovery: one K6
ladder at 256 bits over t·m lanes, then the halving tree over dealers)
and the plain sum of a fresh DKG (the tree alone).  The port runs on CPU
tensors (``device="cpu"``); points are compared as affine integers.
"""

import random

import pytest
import torch

from drand_tpu.crypto import dkg_device as JDD
from drand_tpu.crypto import schemes as JS
from drand_tpu.crypto.host.params import R

from drand_tpu_torch.crypto import dkg_device as DD
from drand_tpu_torch.crypto import schemes
from drand_tpu_torch.crypto.host import tbls as HT
from drand_tpu_torch.ops import kernels as K

SCHEME = "pedersen-bls-chained"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def case():
    g = schemes.scheme_from_name(SCHEME).key_group
    jg = JS.scheme_from_name(SCHEME).key_group
    rng = random.Random(19)
    m, t = 5, 3
    matrix = [list(HT.PriPoly([rng.randrange(R) for _ in range(t)])
                   .commit(g).commits) for _ in range(m)]
    lams = [rng.randrange(R) for _ in range(m)]
    return g, jg, matrix, lams


def _host(g, matrix, lams):
    out = []
    for j in range(len(matrix[0])):
        acc = None
        for d, row in enumerate(matrix):
            acc = g.curve.add(acc, row[j] if lams is None
                              else g.curve.mul(row[j], lams[d]))
        out.append(acc)
    return out


def test_combine_weighted_parity(case, monkeypatch):
    g, jg, matrix, lams = case
    ladders = []
    plain = K.scalar_mul_bits_plain
    monkeypatch.setattr(K, "scalar_mul_bits_plain", lambda p, b: (
        ladders.append(tuple(b.shape)), plain(p, b))[1])
    before = DD.dispatch_count()
    port = DD.combine_commits(g, matrix, lams, device="cpu")
    assert DD.dispatch_count() - before == 1
    assert ladders == [(256, 15)]          # one ladder over t·m lanes
    assert port == JDD.combine_commits(jg, matrix, lams) \
        == _host(g, matrix, lams)


def test_combine_plain_parity(case):
    g, jg, matrix, _ = case
    port = DD.combine_commits(g, matrix, device="cpu")
    assert port == JDD.combine_commits(jg, matrix) == _host(g, matrix, None)


def test_combine_odd_dealers_and_infinity(case):
    """An odd dealer count at every halving level (5 -> 3 -> 2 -> 1, the
    leftover carried), an infinity commitment and a pair summing to
    infinity: the plain sum equals the host's."""
    g, _, matrix, _ = case
    rows = [list(r) for r in matrix]
    rows[1][0] = None
    rows[3][2] = g.curve.neg(rows[2][2])
    assert DD.combine_commits(g, rows, device="cpu") == _host(g, rows, None)
    assert DD.combine_commits(g, [], device="cpu") == []
