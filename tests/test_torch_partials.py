"""The port's batched threshold-partial verification (drand_tpu_torch/
crypto/partials.py BatchPartialVerifier) vs the JAX package and its host
golden code.

A random t = 3 of n = 5 group per signature group, four rounds of three
partials each (every signer appears), signed by the JAX host tbls.  The
port runs on CPU tensors (device="cpu": every kernel wrapper runs its plain
version).  Its mask must equal the JAX host ``tbls.verify_partial`` verdict
at every slot, for all-valid rows (one RLC pass, no exact pass) and for
rows with the bad-slot kinds of tests/test_partials.py (the RLC pass fails
and the exact pass localizes them).  The host packing must equal the JAX
verifier's arrays exactly.  The slow + heavy_compile cases hold the RLC and
exact device passes against the JAX ones with the same RLC bit planes
(cold CPU compiles of many minutes).
"""

import numpy as np
import pytest
import torch

from drand_tpu.crypto import partials as JP
from drand_tpu.crypto import schemes as JS
from drand_tpu.crypto import tbls as JT
from drand_tpu.crypto.host import serialize as JHS
from drand_tpu.crypto.host.params import R

from drand_tpu_torch import convert as CV
from drand_tpu_torch.crypto import batch as B
from drand_tpu_torch.crypto import partials as PP
from drand_tpu_torch.crypto import schemes
from drand_tpu_torch.ops import kernels as K

RNG = np.random.default_rng(20240625)
T, N, ROUNDS = 3, 5, 4
G1_ID, CHAINED_ID = "bls-unchained-on-g1", "pedersen-bls-chained"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run as thousands of small int64 ops.  Under
    several test workers on one machine, torch's intra-op threads only
    contend with each other, so this module runs on one, restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


class Group:
    """A (T, N) group on one scheme, the round digests and the partial
    rows: round r is signed by signers (r + 2j) % N, j < T."""

    def __init__(self, scheme_id):
        self.sch = schemes.scheme_from_name(scheme_id)
        self.jsch = JS.scheme_from_name(scheme_id)
        self.jpoly = JT.PriPoly([int.from_bytes(RNG.bytes(32), "big") % R
                                 for _ in range(T)])
        self.shares = self.jpoly.shares(N)
        self.jpp = self.jpoly.commit(self.jsch.key_group)
        self.msgs = [self.sch.digest_beacon(r) for r in range(1, ROUNDS + 1)]
        self.signers = [[(r + 2 * j) % N for j in range(T)]
                        for r in range(ROUNDS)]
        self.rows = [[self.sign(i, r) for i in self.signers[r]]
                     for r in range(ROUNDS)]
        self.bad_rows = self._bad_rows()

    def sign(self, signer, r):
        return JT.sign_partial(self.jsch, self.shares[signer], self.msgs[r])

    def _bad_rows(self):
        """The kinds of bad slot of tests/test_partials.py: a flipped
        signature byte, a signer index >= n, a truncated partial, an x
        with no y on the curve, another round's partial of the same signer
        and a missing slot (a ragged row); half the slots stay valid."""
        rows = [list(r) for r in self.rows]
        b = bytearray(rows[0][1])
        b[10] ^= 1
        rows[0][1] = bytes(b)
        rows[1][0] = N.to_bytes(2, "big") + rows[1][0][2:]
        rows[1][2] = rows[1][2][:-1]
        dec = JHS.g2_from_bytes if self.sch.sig_group.point_len == 96 \
            else JHS.g1_from_bytes
        for tweak in range(1, 64):
            b = bytearray(rows[2][0])
            b[-1] ^= tweak
            try:
                dec(bytes(b[2:]), check_subgroup=False)
            except (ValueError, AssertionError):
                break
        else:
            raise AssertionError("no non-decompressable tweak in 64 tries")
        rows[2][0] = bytes(b)
        rows[2][2] = self.sign(self.signers[2][2], 3)
        rows[3] = rows[3][:T - 1]
        return rows

    def host_mask(self, rows):
        """The JAX host tbls.verify_partial verdict at every slot (False
        for a padded slot)."""
        k = max(len(row) for row in rows)
        return np.array([[j < len(row) and JT.verify_partial(
            self.jsch, self.jpp, m, row[j]) for j in range(k)]
            for m, row in zip(self.msgs, rows)])

    def port_verifier(self):
        return PP.BatchPartialVerifier(
            self.sch, CV.pub_poly(self.jpp, self.sch.key_group), N,
            device="cpu")

    def jax_verifier(self):
        return JP.BatchPartialVerifier(self.jsch, self.jpp, N)


@pytest.fixture(scope="module", params=[G1_ID, CHAINED_ID])
def grp(request):
    return Group(request.param)


def leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def run(verifier, msgs, rows):
    """verify_partials, with the passes it ran and no kernel launched."""
    before = B.pass_counts()
    K.reset_launches()
    got = verifier.verify_partials(msgs, rows)
    assert all(c == 0 for c in K.LAUNCHES.values())
    after = B.pass_counts()
    return got, {k: after[k] - before[k] for k in after}


def test_state_and_packing_match_jax(grp):
    """Public shares, the fixed generator and the host packing of the bad
    rows (x limbs, sign flags, signer indices, valid mask) equal the JAX
    verifier's exactly."""
    port, jv = grp.port_verifier(), grp.jax_verifier()
    want = CV.partials_state(jv)
    for key in ("pk_x", "pk_y", "fixed_aff"):
        w, g = leaves(want[key]), leaves(getattr(port, key))
        assert len(w) == len(g)
        assert all(torch.equal(a, b) for a, b in zip(w, g))
    for got, exp in zip(port._parse(grp.bad_rows, T),
                        jv._parse(grp.bad_rows, T)):
        np.testing.assert_array_equal(got, exp)


def test_verify_partials_all_valid(grp):
    got, passes = run(grp.port_verifier(), grp.msgs, grp.rows)
    assert passes == {"rlc": 1, "exact": 0}
    assert got.tolist() == grp.host_mask(grp.rows).tolist()
    assert got.all() and got.shape == (ROUNDS, T)


def test_verify_partials_bad_slots(grp):
    got, passes = run(grp.port_verifier(), grp.msgs, grp.bad_rows)
    assert passes == {"rlc": 1, "exact": 1}
    want = grp.host_mask(grp.bad_rows)
    assert got.tolist() == want.tolist()
    assert want.sum() == ROUNDS * T - 6


def test_verify_partials_without_device_work():
    """Empty blocks, and a block whose every slot fails the host parse,
    return their mask with no device pass."""
    sch = schemes.scheme_from_name(G1_ID)
    pp = CV.pub_poly(JT.PriPoly([7, 8]).commit(
        JS.scheme_from_name(G1_ID).key_group), sch.key_group)
    bv = PP.BatchPartialVerifier(sch, pp, 3, device="cpu")
    assert bv.verify_partials([], []).shape == (0, 0)
    assert bv.verify_partials([b"x"], [[]]).shape == (1, 0)
    got, passes = run(bv, [b"x" * 32], [[b"\x00\x01short", None]])
    assert got.tolist() == [[False, False]]
    assert passes == {"rlc": 0, "exact": 0}


def test_verifier_needs_a_gpu_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    sch = schemes.scheme_from_name(G1_ID)
    pp = CV.pub_poly(JT.PriPoly([3, 4]).commit(
        JS.scheme_from_name(G1_ID).key_group), sch.key_group)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PP.BatchPartialVerifier(sch, pp, 3)


# ---------------------------------------------------------------------------
# The device passes side by side with the JAX ones (same RLC planes)
# ---------------------------------------------------------------------------

def _jax_encoding(jv, grp, rows):
    xw, sign, idxs, valid = jv._parse(rows, T)
    import jax.numpy as jnp
    u0, u1 = (JP.DH.hash_msgs_to_field_g2 if jv.g2sig
              else JP.DH.hash_msgs_to_field_g1)(grp.msgs, grp.jsch.dst)
    return jv._sig_x(xw), jnp.asarray(sign), u0, u1, idxs, valid


@pytest.mark.slow
@pytest.mark.heavy_compile
@pytest.mark.parametrize("which", ["rows", "bad_rows"])
def test_rlc_pass_matches_jax(grp, which, monkeypatch):
    """The RLC verdict and the sub_ok mask equal the JAX partials RLC pass
    (FIELDS front) fed the same encoding and the same RLC bit planes."""
    import jax
    import jax.numpy as jnp
    rows = getattr(grp, which)
    jv, port = grp.jax_verifier(), grp.port_verifier()
    sig_x, sign, u0, u1, idxs, valid = _jax_encoding(jv, grp, rows)
    split = 4 if jv.g2sig else 2
    planes = RNG.integers(0, 2, (split, 128 // split, ROUNDS * T),
                          dtype=np.uint32)
    planes[:, :, ~valid.reshape(-1)] = 0
    monkeypatch.setattr(JP, "_device_rlc_bits",
                        lambda keys, v, split: tuple(jnp.asarray(p)
                                                     for p in planes))
    flat_valid = valid.reshape(-1)
    flat_idx = idxs.reshape(-1)
    signers = sorted(set(flat_idx[flat_valid].tolist()))
    onehot = np.stack([(flat_idx == s) & flat_valid
                       for s in signers]).astype(np.uint32)
    core = JP._rlc_partials_run_g2sig if jv.g2sig \
        else JP._rlc_partials_run_g1sig
    j_sub, j_ok = jax.jit(core)(sig_x, sign, u0, u1, None,
                                jnp.asarray(flat_valid.astype(np.uint32)),
                                jnp.asarray(onehot), jv._pk_sel(signers),
                                jv.fixed_aff)
    enc, p_idxs, p_valid = port._encode(grp.msgs, rows, T)
    p_sub, p_ok = port._rlc(enc, p_idxs, p_valid,
                            bits=CV.rlc_bits(planes))
    assert bool(p_ok) == bool(j_ok) == (which == "rows")
    np.testing.assert_array_equal(p_sub.numpy(), np.asarray(j_sub))


@pytest.mark.slow
@pytest.mark.heavy_compile
def test_exact_pass_matches_jax(grp):
    """The exact pass's per-slot verdicts over the bad rows equal the JAX
    partials exact pass fed the same encoding."""
    import jax
    jv, port = grp.jax_verifier(), grp.port_verifier()
    sig_x, sign, u0, u1, idxs, _ = _jax_encoding(jv, grp, grp.bad_rows)
    jcore = JP._exact_partials_run_g2sig if jv.g2sig \
        else JP._exact_partials_run_g1sig
    want = jax.jit(jcore)(sig_x, sign, u0, u1, jv._pk_sel(idxs.reshape(-1)),
                          jv.fixed_aff)
    enc, p_idxs, _ = port._encode(grp.msgs, grp.bad_rows, T)
    np.testing.assert_array_equal(port._exact(enc, p_idxs).numpy(),
                                  np.asarray(want))
