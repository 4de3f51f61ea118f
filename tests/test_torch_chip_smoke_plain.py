"""chip_smoke.py's plain-twin runner (`Plain`, `run_plain`): twins of one
kernel with the same arguments off the lane axis share one timed call,
each twin gets its own lanes of the output, and every call's wall is
reported once with the twins it held.  Runs on the CPU with small
exponents of the plain K1 (`kernels.pow_fixed_plain`)."""

import numpy as np
import pytest
import torch

from test_torch_fp12prog import _chip_smoke

from drand_tpu_torch.ops import limbs as L


def _fp(rng, lanes):
    vals = [int(rng.integers(0, 2 ** 62)) for _ in range(lanes)]
    return L.encode_mont(vals, torch.device("cpu"))


@pytest.fixture(scope="module")
def cs():
    return _chip_smoke()


def _plains(cs, rng):
    return [cs.Plain("pow_fixed_plain", _fp(rng, 2), 5),
            cs.Plain("pow_fixed_plain", _fp(rng, 3), 5),
            cs.Plain("pow_fixed_plain", _fp(rng, 4), 7)]


@pytest.mark.parametrize("join_lanes, tags, want", [
    (4096, ["k1"] * 3, [[0, 1], [2]]),          # same exponent: joined
    (4, ["k1"] * 3, [[0], [1], [2]]),           # 2 + 3 lanes above the cap
    (4096, ["k1", "other", "k1"], [[0], [1], [2]]),     # another kernel
])
def test_run_plain_joins_and_reports_each_call_once(cs, monkeypatch,
                                                     join_lanes, tags, want):
    rng = np.random.default_rng(7)
    plains = _plains(cs, rng)
    monkeypatch.setattr(cs, "PLAIN_JOIN_LANES", join_lanes)
    out, calls = cs.run_plain(plains, lambda: None, tags=tags)
    assert sorted(c["members"] for c in calls) == want
    for c in calls:
        assert c["ms"] >= 0
        assert c["lanes"] == sum(plains[j].lanes() for j in c["members"])
    for j, (got, call) in enumerate(out):
        assert j in calls[call]["members"]
        assert torch.equal(got, plains[j]())
