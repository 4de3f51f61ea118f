"""The RLC key material on the CPU: all 128 bits of _rlc_keys() reach the
randomizer planes.

The CPU torch.Generator keeps only the low 32 bits of a seed, so the CPU
planes XOR four streams, one per 32-bit word of the two 64-bit keys, and
_rlc_keys resamples keys with two equal words (their streams would
cancel).  The card's Philox generator takes each whole 64-bit key, so its
two streams are what they were.
"""

import pytest
import torch

from drand_tpu_torch.crypto import batch as B

MASK = torch.arange(16) < 13
K0, K1 = 0x0123456789ABCDEF, 0x0FEDCBA987654321


def _planes(keys, split):
    return torch.cat(B._device_rlc_bits(keys, MASK, split=split))


def test_cpu_generator_keeps_only_low_32_seed_bits():
    """The premise: two seeds that agree in their low 32 bits give the same
    CPU stream."""
    a, b = torch.Generator(), torch.Generator()
    a.manual_seed(5)
    b.manual_seed(5 + (7 << 40))
    assert torch.equal(torch.randint(0, 1 << 32, (8,), generator=a),
                       torch.randint(0, 1 << 32, (8,), generator=b))


@pytest.mark.parametrize("split", [2, 4])
@pytest.mark.parametrize("flip", [(1 << 32, 0), (1 << 63, 0), (0, 1 << 40),
                                  (0, 1 << 32)],
                         ids=["k0 bit 32", "k0 bit 63", "k1 bit 40",
                              "k1 bit 32"])
def test_cpu_planes_depend_on_bits_above_32(split, flip):
    base = _planes((K0, K1), split)
    other = _planes((K0 ^ flip[0], K1 ^ flip[1]), split)
    assert base.any() and not torch.equal(base, other)


@pytest.mark.parametrize("split", [2, 4])
def test_same_keys_same_planes(split):
    planes = B._device_rlc_bits((K0, K1), MASK, split=split)
    assert len(planes) == split
    assert all(p.shape == (128 // split, 16) for p in planes)
    again = B._device_rlc_bits((K0, K1), MASK, split=split)
    assert all(torch.equal(x, y) for x, y in zip(planes, again))
    assert torch.equal(torch.cat(planes), _planes((K0, K1), 6 - split))
    assert not torch.cat(planes)[:, 13:].any()


def test_stream_seeds_per_device():
    """CPU: the four 32-bit words, low word first; CUDA: the two keys."""
    assert B._stream_seeds((K0, K1), torch.device("cpu")) == [
        0x89ABCDEF, 0x01234567, 0x87654321, 0x0FEDCBA9]
    assert B._stream_seeds((K0, K1), torch.device("cuda")) == [K0, K1]


def _raw(words):
    return b"".join(w.to_bytes(4, "little") for w in words)


def test_rlc_keys_resample_words_that_cancel(monkeypatch):
    """Keys whose halves differ but whose words pair up passed the old
    guard (equal 64-bit halves only) and cancel to all-zero CPU planes.
    _rlc_keys rejects every draw with two equal words and returns the
    first draw whose four words differ."""
    w, v, u = 0x11111111, 0x22222222, 0x33333333
    swapped = (w | v << 32, v | w << 32)          # words w, v, v, w
    assert swapped[0] != swapped[1]
    assert not _planes(swapped, 2).any()
    draws = iter([_raw([w, v, v, w]),              # everything cancels
                  _raw([w, v, w, u]),              # equal low words
                  _raw([w, v, u, v]),              # equal high words
                  _raw([w, w, v, u]),              # one key's two words
                  _raw([w, v, u, 0x44444444])])
    monkeypatch.setattr(B.secrets, "token_bytes", lambda k: next(draws))
    assert B._rlc_keys() == (w | v << 32, u | 0x44444444 << 32)
    with pytest.raises(StopIteration):
        next(draws)
