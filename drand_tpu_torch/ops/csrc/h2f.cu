// H1: the message front of verification -- SHA-256 of the beacon message,
// RFC 9380 expand_message_xmd and hash_to_field -- one thread a lane.
//
// Replaces no Pallas kernel: in the JAX package these stages are XLA code,
// a lax.scan over the 64 rounds of a compression (drand_tpu/ops/sha256.py
// :109 compress, ops/h2c.py :413-470).  As plain PyTorch on the card they
// would be some 35 tensor operations a round, 64 rounds a compression and
// 11-21 compressions a lane: tens of thousands of launches a pass.  Here a
// lane's whole chain runs in one thread, in registers:
//
//   digest  (raw fronts) SHA-256(round8) unchained; chained SHA-256(prev ||
//           round8), or SHA-256(round8) where has_prev is 0 (the genesis
//           slot): 1 or 2 blocks;
//   b_0     SHA-256(Z_pad || msg || l_i_b || 0 || DST') from the Z_pad
//           midstate: 2 blocks for a 32-byte message;
//   b_i     SHA-256((b_0 ^ b_{i-1}) || i || DST'), i = 1..ell: 2 blocks
//           each, ell = 4 (Fp, 128 bytes) or 8 (Fp2, 256 bytes);
//   u       each 64-byte chunk (two b_i) OS2IP mod p into Montgomery form:
//           lo 384 bits times R^2, hi 128 bits times R^3, added mod p.
//
// So 11 compressions a lane for G1 unchained, 20 for G2 chained.  Bound on
// this card: 32-bit integer logic and adds (a compression is some 2,300
// word operations) against a few hundred bytes a lane, so operations; the
// launches hold 8,192-16,384 lanes, a few warps an SM, so a lane's chain of
// dependent operations sets the time.  Design: one thread a lane, the
// state, the 16-word schedule ring and the chunk in registers; the static
// framing (Z_pad midstate, l_i_b, DST', padding words, the digest
// paddings) comes from the host as one small array (ops/sha256.py frame,
// kernels.h1_frame) that every lane of a launch reads alike, so the DST is
// not compiled in and the RFC 9380 vectors run through the same code.
//
// Outputs in the plain engine's layout: (B, 24) int64 limbs a field element
// (field.cuh store_fp_limbs), no word layout around the launch; words (the
// SHA-256 and xmd entries) as (B, n) int64.
//
// Entries: drand_sha256 (SHA-256 of word rows), drand_xmd (the xmd bytes as
// words), drand_h2f (message -> u: 2 Fp elements, or 4 for 2 Fp2; the
// message a row of words of a given length, the raw unchained round, or
// the raw chained (prev, round, has_prev)).

#include "field.cuh"

using namespace drand;

constexpr int H1_THREADS = 64;     // threads a block: 8,192 lanes = 128 blocks

// The frame (int32 words, kernels.h1_frame): a header, then SHA frames.  A
// SHA frame: midstate (8 words), fill (ORed into the last dynamic word),
// nsw, then nsw static suffix words that follow the dynamic ones.
enum {
  F_ELL = 0,     // xmd: b_1 .. b_ell
  F_NSWI = 1,    // suffix words of each b_i (i || DST' || padding)
  F_B0 = 2,      // offset of b_0's SHA frame
  F_BI = 3,      // offset of the b_i suffix rows (ell rows of F_NSWI words)
  F_D1 = 4,      // offset of the digest frame (round8, or prev || round8)
  F_D2 = 5,      // offset of the genesis digest frame (round8)
  F_HEADER = 8
};

CMEM uint32_t kK[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
    0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
    0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
    0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
    0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
    0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
    0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
    0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
    0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};
CMEM uint32_t kH0[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                        0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
// R^2 mod p: the to-Montgomery factor of an OS2IP chunk's low 384 bits
// (R^3, for its high 128 bits, is field.cuh's kR3)
CMEM uint32_t kR2[12] = {
    0x1c341746u, 0xf4df1f34u, 0x09d104f1u, 0x0a76e6a6u, 0x4c95b6d5u,
    0x8de5476cu, 0x939d83c0u, 0x67eb88a9u, 0xb519952du, 0x9a793e85u,
    0x92cae3aau, 0x11988fe5u};

DI uint32_t rotr(uint32_t x, int r) { return (x >> r) | (x << (32 - r)); }

// One compression of the 16 words w into st (w is consumed as the
// schedule ring).
DI void sha_compress(uint32_t* st, uint32_t* w) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
  UNROLL for (int t = 0; t < 64; t++) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    const uint32_t t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) +
                        ((e & f) ^ (~e & g)) + kK[t] + wt;
    const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) +
                        ((a & b) ^ (a & c) ^ (b & c));
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// SHA-256 over k dynamic words (src(i), i < k) and the SHA frame at fr:
// st <- the frame's midstate, then every block of dyn || suffix.
template <class Src>
DI void sha_run(uint32_t* st, const uint32_t* fr, int k, Src src) {
  const uint32_t fill = fr[8];
  const int nw = k + (int)fr[9];
  UNROLL for (int j = 0; j < 8; j++) st[j] = fr[j];
  for (int blk = 0; blk < nw; blk += 16) {
    uint32_t w[16];
    UNROLL for (int j = 0; j < 16; j++) {
      const int i = blk + j;              // suffix word i - k at fr[10 + i - k]
      w[j] = i < k ? src(i) | (i == k - 1 ? fill : 0u) : fr[10 + i - k];
    }
    sha_compress(st, w);
  }
}

// expand_message_xmd over k message words: b_0, then b_1 .. b_ell, each
// handed to sink(i, b_i).
template <class Src, class Sink>
DI void xmd_lane(const uint32_t* fr, int k, Src msg, Sink sink) {
  const int ell = (int)fr[F_ELL], nswi = (int)fr[F_NSWI];
  uint32_t b0[8], bi[8], x[8];
  sha_run(b0, fr + fr[F_B0], k, msg);
  UNROLL for (int j = 0; j < 8; j++) x[j] = b0[j];
  for (int i = 1; i <= ell; i++) {
    // b_i: 8 dynamic words, suffix row i - 1, the IV, no fill
    const uint32_t* row = fr + fr[F_BI] + (i - 1) * nswi;
    UNROLL for (int j = 0; j < 8; j++) bi[j] = kH0[j];
    uint32_t w[16];
    UNROLL for (int j = 0; j < 8; j++) w[j] = x[j];
    UNROLL for (int j = 8; j < 16; j++) w[j] = row[j - 8];
    sha_compress(bi, w);
    for (int blk = 8; blk < nswi; blk += 16) {
      UNROLL for (int j = 0; j < 16; j++) w[j] = row[blk + j];
      sha_compress(bi, w);
    }
    sink(i, bi);
    UNROLL for (int j = 0; j < 8; j++) x[j] = b0[j] ^ bi[j];
  }
}

// One 64-byte OS2IP chunk (16 big-endian words) -> Montgomery form mod p.
DI void chunk_to_mont(Fp& r, const uint32_t* cw) {
  Fp lo, hi, k, a, b;
  UNROLL for (int j = 0; j < 12; j++) lo.v[j] = cw[15 - j];
  UNROLL for (int j = 0; j < 4; j++) hi.v[j] = cw[3 - j];
  UNROLL for (int j = 4; j < 12; j++) hi.v[j] = 0u;
  fp_load_const(k, kR2);
  fp_mul(a, lo, k);                      // lo < 2^384: lo R^2 < R p
  fp_load_const(k, kR3);
  fp_mul(b, hi, k);
  uint32_t s[12];                        // a + b < 2p < 2^384: no carry out
  uint64_t c = 0;
  UNROLL for (int j = 0; j < 12; j++) {
    c += (uint64_t)a.v[j] + b.v[j];
    s[j] = (uint32_t)c;
    c >>= 32;
  }
  fp_reduce_once(r, s);
}

struct Outs { int64_t* c[4]; };

// The message front of one lane: kind 0 the row of ka words is the xmd
// message; 1 the round words (raw unchained); 2 (prev, round, has_prev)
// (raw chained).  nout chunks of 64 bytes -> nout field elements.
DI void h2f_lane(int kind, const int64_t* a, int ka, const int64_t* rnd,
                 const int64_t* has, const uint32_t* fr, const Outs& out,
                 int64_t lane) {
  uint32_t cw[16];
  auto sink = [&](int i, const uint32_t* bi) {
    if (i & 1) {
      UNROLL for (int j = 0; j < 8; j++) cw[j] = bi[j];
    } else {
      UNROLL for (int j = 0; j < 8; j++) cw[8 + j] = bi[j];
      Fp u;
      chunk_to_mont(u, cw);
      store_fp_limbs(out.c[i / 2 - 1], u, lane);
    }
  };
  if (kind == 0) {
    const int64_t* m = a + lane * ka;
    xmd_lane(fr, ka, [&](int i) { return (uint32_t)m[i]; }, sink);
    return;
  }
  uint32_t d[8];
  const int64_t* r = (kind == 1 ? a : rnd) + lane * 2;
  if (kind == 2 && has[lane] != 0) {
    const int64_t* pv = a + lane * ka;
    sha_run(d, fr + fr[F_D1], ka + 2, [&](int i) {
      return (uint32_t)(i < ka ? pv[i] : r[i - ka]);
    });
  } else {
    sha_run(d, fr + fr[kind == 2 ? F_D2 : F_D1], 2,
            [&](int i) { return (uint32_t)r[i]; });
  }
  xmd_lane(fr, 8, [&](int i) { return d[i]; }, sink);
}

DI void sha_lane(const int64_t* words, int k, const uint32_t* fr,
                 int64_t* out, int64_t lane) {
  uint32_t st[8];
  const int64_t* m = words + lane * k;
  sha_run(st, fr, k, [&](int i) { return (uint32_t)m[i]; });
  UNROLL for (int j = 0; j < 8; j++) out[lane * 8 + j] = st[j];
}

DI void xmd_words_lane(const int64_t* words, int k, const uint32_t* fr,
                       int64_t* out, int nwords, int64_t lane) {
  int64_t* o = out + lane * nwords;
  const int64_t* m = words + lane * k;
  xmd_lane(fr, k, [&](int i) { return (uint32_t)m[i]; },
           [&](int i, const uint32_t* bi) {
    UNROLL for (int j = 0; j < 8; j++)
      if (8 * (i - 1) + j < nwords) o[8 * (i - 1) + j] = bi[j];
  });
}

static inline Outs outs_of(const void* const* ptrs, int n) {
  Outs o = {};
  for (int i = 0; i < n && i < 4; i++) o.c[i] = (int64_t*)ptrs[i];
  return o;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(H1_THREADS)
    k_sha256(const int64_t* words, int k, const uint32_t* fr, int64_t* out,
             int64_t B) {
  const int64_t lane = DRAND_LANE_INDEX();
  if (lane < B) sha_lane(words, k, fr, out, lane);
}

__global__ void __launch_bounds__(H1_THREADS)
    k_xmd(const int64_t* words, int k, const uint32_t* fr, int64_t* out,
          int nwords, int64_t B) {
  const int64_t lane = DRAND_LANE_INDEX();
  if (lane < B) xmd_words_lane(words, k, fr, out, nwords, lane);
}

__global__ void __launch_bounds__(H1_THREADS)
    k_h2f(int kind, const int64_t* a, int ka, const int64_t* rnd,
          const int64_t* has, const uint32_t* fr, Outs out, int64_t B) {
  const int64_t lane = DRAND_LANE_INDEX();
  if (lane < B) h2f_lane(kind, a, ka, rnd, has, fr, out, lane);
}

extern "C" int drand_sha256(const void* words, int k, const void* frame,
                            void* out, int64_t B, void* stream) {
  DRAND_LAUNCH(k_sha256, B, H1_THREADS, stream, (const int64_t*)words, k,
               (const uint32_t*)frame, (int64_t*)out, B);
}

extern "C" int drand_xmd(const void* words, int k, const void* frame,
                         void* out, int nwords, int64_t B, void* stream) {
  DRAND_LAUNCH(k_xmd, B, H1_THREADS, stream, (const int64_t*)words, k,
               (const uint32_t*)frame, (int64_t*)out, nwords, B);
}

extern "C" int drand_h2f(int kind, const void* a, int ka, const void* rnd,
                         const void* has, const void* frame,
                         const void* const* outs, int nout, int64_t B,
                         void* stream) {
  if (kind < 0 || kind > 2 || nout < 1 || nout > 4) return 1;
  DRAND_LAUNCH(k_h2f, B, H1_THREADS, stream, kind, (const int64_t*)a, ka,
               (const int64_t*)rnd, (const int64_t*)has,
               (const uint32_t*)frame, outs_of(outs, nout), B);
}
#else
extern "C" int drand_sha256(const void* words, int k, const void* frame,
                            void* out, int64_t B, void* stream) {
  (void)stream;
  for (int64_t lane = 0; lane < B; lane++)
    sha_lane((const int64_t*)words, k, (const uint32_t*)frame,
             (int64_t*)out, lane);
  return 0;
}

extern "C" int drand_xmd(const void* words, int k, const void* frame,
                         void* out, int nwords, int64_t B, void* stream) {
  (void)stream;
  for (int64_t lane = 0; lane < B; lane++)
    xmd_words_lane((const int64_t*)words, k, (const uint32_t*)frame,
                   (int64_t*)out, nwords, lane);
  return 0;
}

extern "C" int drand_h2f(int kind, const void* a, int ka, const void* rnd,
                         const void* has, const void* frame,
                         const void* const* outs, int nout, int64_t B,
                         void* stream) {
  (void)stream;
  if (kind < 0 || kind > 2 || nout < 1 || nout > 4) return 1;
  const Outs o = outs_of(outs, nout);
  for (int64_t lane = 0; lane < B; lane++)
    h2f_lane(kind, (const int64_t*)a, ka, (const int64_t*)rnd,
             (const int64_t*)has, (const uint32_t*)frame, o, lane);
  return 0;
}
#endif
