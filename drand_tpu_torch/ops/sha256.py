"""Batched SHA-256 over fixed-size messages: the plain version of H1's
hash stages, and the host framing that H1 reads.

Counterpart of drand_tpu/ops/sha256.py.  Beacon messages have a fixed size
(``H(prevSig || round)`` chained, ``H(round)`` unchained), so the block
count of every lane is static and the digest + RFC 9380
``expand_message_xmd`` chain runs over lanes with no data-dependent control
flow.

* A message is a ``(..., k)`` int64 tensor of BIG-ENDIAN 32-bit words (the
  order SHA-256 consumes them), one row per lane.  int64, not uint32:
  PyTorch on the CPU has no add, shift or compare on uint32, so every
  word stays in [0, 2^32) and is masked after each add and shift.
* Static framing -- a whole-block prefix (the xmd Z_pad), a static tail
  (l_i_b, DST') and the SHA padding -- is folded in on the host: whole
  static leading blocks collapse to a midstate (``_midstate``), and the
  static suffix becomes constant words (``frame`` packs both for H1).
* ``compress`` and ``sha256_words`` are the plain version; the kernel
  (csrc/h2f.cu) runs the same chain one thread a lane, and
  ``kernels.sha256_words`` picks between the two by the tensor's device.
"""

from functools import lru_cache

import numpy as np
import torch

_K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
], dtype=np.int64)

_H0 = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
], dtype=np.int64)

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Host mirror: pure-Python compression for STATIC data (midstates of
# whole-block static prefixes; also an oracle for the tests)
# ---------------------------------------------------------------------------

def _rotr_i(x: int, r: int) -> int:
    return ((x >> r) | (x << (32 - r))) & _M32


def _compress_host(state, block: bytes):
    """One SHA-256 compression over 64 static bytes (host ints)."""
    w = [int.from_bytes(block[4 * i:4 * i + 4], "big") for i in range(16)]
    for t in range(16, 64):
        s0 = _rotr_i(w[t - 15], 7) ^ _rotr_i(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr_i(w[t - 2], 17) ^ _rotr_i(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        s1 = _rotr_i(e, 6) ^ _rotr_i(e, 11) ^ _rotr_i(e, 25)
        ch = (e & f) ^ (~e & g & _M32)
        t1 = (h + s1 + ch + int(_K[t]) + w[t]) & _M32
        s0 = _rotr_i(a, 2) ^ _rotr_i(a, 13) ^ _rotr_i(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (s0 + maj) & _M32
        a, b, c, d, e, f, g, h = (
            (t1 + t2) & _M32, a, b, c, (d + t1) & _M32, e, f, g)
    return tuple((x + y) & _M32
                 for x, y in zip(state, (a, b, c, d, e, f, g, h)))


@lru_cache(maxsize=None)
def _midstate(prefix: bytes) -> np.ndarray:
    """State after compressing a static whole-block prefix from the IV."""
    assert len(prefix) % 64 == 0
    state = tuple(int(x) for x in _H0)
    for off in range(0, len(prefix), 64):
        state = _compress_host(state, prefix[off:off + 64])
    return np.array(state, dtype=np.int64)


def _suffix_bytes(total_len: int, tail: bytes) -> bytes:
    """`tail` + the SHA-256 padding for a `total_len`-byte message (the
    tail being its final len(tail) bytes) -- everything after the dynamic
    region, as static bytes."""
    pad = (56 - (total_len + 1)) % 64
    return tail + b"\x80" + b"\x00" * pad + (8 * total_len).to_bytes(8, "big")


@lru_cache(maxsize=None)
def frame(k: int, dyn_len: int | None = None, tail: bytes = b"",
          prefix: bytes = b"") -> tuple:
    """The static part of SHA-256(``prefix || dyn || tail``) for k dynamic
    words of dyn_len bytes (default 4k): (midstate, fill, suffix words).

    ``fill`` holds the first 4 - rem static bytes, ORed into the low byte
    positions of a partial last dynamic word (0 when the dynamic bytes
    fill their words); the suffix words follow the dynamic ones, and the
    two together are a whole number of blocks."""
    if dyn_len is None:
        dyn_len = 4 * k
    assert 4 * (k - 1) < dyn_len <= 4 * k if k else dyn_len == 0
    total_len = len(prefix) + dyn_len + len(tail)
    suffix = _suffix_bytes(total_len, tail)
    rem = dyn_len - 4 * (k - 1) if k else 0      # bytes in the last word
    fill = 0
    if k and rem < 4:
        fill = int.from_bytes(suffix[:4 - rem], "big")
        suffix = suffix[4 - rem:]
    assert len(suffix) % 4 == 0 and (k + len(suffix) // 4) % 16 == 0
    sw = np.frombuffer(suffix, dtype=">u4").astype(np.int64)
    return _midstate(prefix), fill, sw


# ---------------------------------------------------------------------------
# Plain version (PyTorch, int64 words)
# ---------------------------------------------------------------------------

def _rotr(x, r: int):
    return ((x >> r) | (x << (32 - r))) & _M32


def compress(state, block):
    """One compression: state (..., 8), block (..., 16), int64 words.

    The message schedule W[0..63] first, then the 64 rounds, each add
    masked to 32 bits."""
    w = list(block.unbind(-1))
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = state.unbind(-1)
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + s1 + ch + int(_K[t]) + w[t]) & _M32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = ((t1 + s0 + maj) & _M32, a, b, c,
                                  (d + t1) & _M32, e, f, g)
    return (state + torch.stack([a, b, c, d, e, f, g, h], -1)) & _M32


def sha256_words(dyn_words, dyn_len: int | None = None, tail: bytes = b"",
                 prefix: bytes = b""):
    """SHA-256 of ``prefix || dyn || tail`` per lane -> (..., 8) digest
    words (the plain version).

    ``dyn_words``: (..., k) int64 BE words, ``dyn_len`` bytes of dynamic
    per-lane data (default 4k; a partial final word carries its bytes in
    the HIGH positions, low bytes zero).  ``prefix`` is static and a
    whole-block multiple (folded to a host midstate -- the xmd Z_pad costs
    no block); ``tail`` is static of any length (merged into the partial
    word and broadcast).  The block count is static."""
    k = int(dyn_words.shape[-1])
    mid, fill, sw = frame(k, dyn_len, tail, prefix)
    dev = dyn_words.device
    if fill:
        dyn_words = torch.cat([dyn_words[..., :-1],
                               (dyn_words[..., -1:] | fill)], -1)
    shape = dyn_words.shape[:-1]
    stream = torch.cat([dyn_words, torch.from_numpy(sw).to(dev)
                        .expand(shape + (len(sw),))], -1)
    state = torch.from_numpy(mid).to(dev).expand(shape + (8,))
    for blk in range(stream.shape[-1] // 16):
        state = compress(state, stream[..., 16 * blk:16 * blk + 16])
    return state


def beacon_digests(msg, sha=sha256_words):
    """digest_beacon over a packed raw message (crypto/batch.py builds
    them with numpy):

      (round_words,)                       unchained: H(round8)
      (prev_words, round_words, has_prev)  chained: H(prevSig || round8),
                                           H(round8) where has_prev == 0
                                           (the genesis slot; both block
                                           counts are static, so the
                                           select has no branch)

    -> (..., 8) digest words, with `sha` for SHA-256 (the plain version
    by default)."""
    if len(msg) == 1:
        return sha(msg[0])
    prev_words, round_words, has_prev = msg
    d_chain = sha(torch.cat([prev_words, round_words], -1))
    d_bare = sha(round_words)
    return torch.where((has_prev != 0)[..., None], d_chain, d_bare)


# ---------------------------------------------------------------------------
# Host word packing (numpy; the pack path's only message work on the host)
# ---------------------------------------------------------------------------

def pack_msgs_to_words(msgs, msg_len: int | None = None) -> np.ndarray:
    """Equal-length byte strings -> (n, ceil(len/4)) int64 array of BE
    32-bit words (a partial final word zero-padded low).  Pure numpy."""
    if msg_len is None:
        msg_len = len(msgs[0]) if msgs else 0
    k = (msg_len + 3) // 4
    buf = np.zeros((len(msgs), 4 * k), np.uint8)
    if msg_len:
        flat = np.frombuffer(b"".join(bytes(m) for m in msgs), np.uint8)
        buf[:, :msg_len] = flat.reshape(len(msgs), msg_len)
    return np.ascontiguousarray(buf.reshape(len(msgs), k, 4).view(">u4")
                                .reshape(len(msgs), k).astype(np.int64))


def digest_bytes(digest_words) -> list:
    """(n, 8) digest words (a tensor on any device, or numpy) -> list of
    32-byte digests."""
    if isinstance(digest_words, torch.Tensor):
        digest_words = digest_words.cpu().numpy()
    be = np.asarray(digest_words).astype(">u4").tobytes()
    return [be[32 * i:32 * (i + 1)] for i in range(len(be) // 32)]
