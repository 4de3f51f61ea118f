"""The verifier's split RLC pass over two CUDA devices.

A verifier placed on [cuda:0, cuda:1] at pad 512 runs each half of the
lanes' stages up to its partial point sums on its own card, brings the
partial sums to cuda:0 and adds them there (crypto/batch.py
`_sharded_sums`).  With the same coefficient planes its sums equal the
one-card pass's bit for bit, and its verdicts, a bad slot included, equal
the one-card verifier's.  The CPU tests hold the same split on [cpu, cpu]
(tests/test_torch_device_pool.py); this file holds the cross-device copies
and the launches on the second card.

Needs two cards and skips otherwise.  It imports no JAX, so on a machine
with the cards run it without the repo's conftest (which sets JAX up for
the CPU tests):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_placement.py
"""

import pytest
import torch

from drand_tpu_torch.crypto import batch as B
from drand_tpu_torch.crypto import schemes as S
from drand_tpu_torch.ops import curve as DC

N, PAD = 24, 512


def _leaves(t):
    """The tensors of nested coordinate tuples (Fp, or Fp2 pairs)."""
    if isinstance(t, torch.Tensor):
        return [t]
    return [x for u in t for x in _leaves(u)]


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the split RLC pass runs over "
                    "a group of cards")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bls-unchained-on-g1",
                                  "pedersen-bls-unchained"])
def test_split_rlc_pass_over_two_cards_equals_one_card(
        two_cards, monkeypatch, name):
    sch = S.scheme_from_name(name)
    sec, pub = sch.keypair(seed=b"two-cards")
    pk = sch.public_bytes(pub)
    rounds = list(range(1, N + 1))
    sigs = [sch.sign(sec, sch.digest_beacon(r)) for r in rounds]
    g2 = sch.sig_group is S.GroupG2
    sums = B._rlc_sums_g2sig if g2 else B._rlc_sums_g1sig
    check = "_rlc_check_g2sig" if g2 else "_rlc_check_g1sig"
    curve = DC.G2 if g2 else DC.G1
    one = B.BatchBeaconVerifier(sch, pk, pad_to=PAD, sharding=two_cards[0])
    two = B.BatchBeaconVerifier(sch, pk, pad_to=PAD, sharding=two_cards)
    assert two._split_devices(PAD) == two_cards

    packed = two.pack_chunk(rounds, sigs)
    enc = two._fields_enc(packed[1], packed[3])
    bits = B._device_rlc_bits(B._rlc_keys(), B._rlc_mask(enc[1], N),
                              4 if g2 else 2)
    affine = lambda pts: [curve.to_affine(p)[:2] for p in pts]  # noqa: E731
    sub_ok, A, Bp = sums(*enc, *bits)                   # one card
    want = affine((A, Bp))
    monkeypatch.setattr(B, "_device_rlc_bits", lambda *a, **k: bits)
    got, real = [], getattr(B, check)

    def spy(A, Bp, pk_aff, fixed_aff):
        got.append(affine((A, Bp)))
        return real(A, Bp, pk_aff, fixed_aff)

    monkeypatch.setattr(B, check, spy)
    assert two._rlc_ok(enc, N) is True
    assert len(got) == 1 and bool(sub_ok.all())
    for x, y in zip(_leaves(want), _leaves(got[0])):
        assert x.device == two_cards[0] and torch.equal(x, y)
    monkeypatch.undo()

    sigs[5] = sigs[4]                       # a bad slot: bisect, exact pass
    want_mask = [r != 6 for r in rounds]
    assert one.verify_batch(rounds, sigs).tolist() == want_mask
    assert two.verify_batch(rounds, sigs).tolist() == want_mask
    torch.cuda.synchronize(two_cards[1])
