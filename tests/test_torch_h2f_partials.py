"""The DIGEST front's verdicts in ``BatchPartialVerifier.verify_partials``
equal the FIELDS front's (the host hash_to_field), on valid and corrupted
slots.

``bls-unchained-on-g1``, t = 2 of n = 3 over 4 rounds, the front forced by
DRAND_H2F_DEVICE (4 rounds are below the threshold); on CPU tensors H1
runs its plain version.  A flipped signature byte fails the RLC pass and
the exact pass localizes it; a truncated partial is invalid at parse.
Each front is checked against the mask known by construction, so the two
agree slot for slot.
"""

import numpy as np
import pytest

from drand_tpu_torch.crypto import batch as B
from drand_tpu_torch.crypto import partials as PP
from drand_tpu_torch.crypto.host import tbls as HT

from test_torch_h2f_verdicts import FRONTS, G1, _flip, _passes, _sk
from test_torch_h2f_verdicts import one_torch_thread  # noqa: F401

# slot (1, 0) a flipped signature byte, slot (2, 1) truncated
T, N = 2, 3
POLY = HT.PriPoly([_sk() for _ in range(T)])
SHARES = POLY.shares(N)
MSGS = [G1.digest_beacon(r) for r in range(1, 5)]
ROWS = [[HT.sign_partial(G1, SHARES[(r + j) % N], MSGS[r]) for j in range(T)]
        for r in range(4)]
ROWS[1][0] = ROWS[1][0][:2] + _flip(ROWS[1][0][2:])
ROWS[2][1] = ROWS[2][1][:-1]
PARTIALS_EXPECTED = np.ones((4, T), dtype=bool)
PARTIALS_EXPECTED[1, 0] = PARTIALS_EXPECTED[2, 1] = False


@pytest.mark.parametrize("front", list(FRONTS))
def test_partials_verdicts_equal_on_both_fronts(monkeypatch, front):
    monkeypatch.setenv("DRAND_H2F_DEVICE", "1" if FRONTS[front] else "0")
    bv = PP.BatchPartialVerifier(G1, POLY.commit(G1.key_group), N,
                                 device="cpu")
    assert bv._msg_enc(MSGS)[0] == (B.FRONT_DIGEST if FRONTS[front]
                                    else B.FRONT_FIELDS)
    got, passes = _passes(lambda: bv.verify_partials(MSGS, ROWS))
    np.testing.assert_array_equal(got, PARTIALS_EXPECTED)
    assert passes == {"rlc": 1, "exact": 1}
