// A thread group per lane: the interpreter of the Fp programs that
// drand_tpu_torch/ops/fp12prog.py writes for K2 (ladder.cu), K3
// (miller.cu), K4 (finalexp.cu), K5 (pow2.cu), K6 (ladder_var.cu), K7
// (sum.cu, a group per complete add) and K8 (glv.cu).
//
// A group of W threads owns one lane: a warp (W = GROUP) for K3 and K4, a
// quarter (G1) or half (G2) a warp for K6, a quarter warp for K2 (2
// threads on G1 where the lanes fill the card), 2 threads for K5, and
// fp12prog.WIDTH's for K7 and K8.  The
// lane's field values sit in shared memory, one Fp per slot, and its work
// is a list of phases: in a product phase every op is a Montgomery
// product (fp_mul), in a linear phase every op is a +- b, halved mod p
// when asked, or one of the point programs' flag ops: an equality flag
// (every word all ones or all zeros) and a word-wise select by such a
// flag, both branchless.  The
// ops of a phase are independent; thread t of the group runs ops t, t + W,
// ... of it, each in registers, and the warp synchronises (__syncwarp)
// before the next phase.  So the lane's dependent chain is one product per
// product phase of at most W ops, and no Fp12 value or point lives in
// local memory.  Every branch is on the program (phase kind, op kind, the
// loop bits of |x|, of K2's public scalar or of K5's public exponent) and
// so uniform across the warp, whatever the lane's data: all groups of a
// warp run the same phases, so a sub-warp group may synchronise the whole
// warp.
//
// group_phase<W>(body) is the one place the group runs: on the card each
// thread calls body(its index in the group) and the warp synchronises; on
// the host (this header compiled as plain C++) the same body runs for
// t = 0 .. W-1 in turn.  A phase body touches only the lane's slots and
// temporaries that die with it, and the program writer guarantees that no
// op of a phase writes a slot that another op of the phase reads, so the
// host loop computes what the card computes.
//
// Program table (int32; fp12prog.program):
//   header [nslots, nfrags, nphases, nops, inv_in, inv_out]
//   frags  2 per fragment: first phase, phase count
//   phases 3 per phase: first op, op count, 1 = products / 0 = linear
//   ops    4 per op: kind, d, a, b.  kind 0 product; 1 add, 2 sub, | 4
//          halve; 8 d = (a == b) as a flag; 16 | f << 8 d = a where the
//          flag in slot f is set, else b
// Slot s < nslots is the lane's; s >= nslots is constant row s - nslots of
// the bundle (row 0, the raw p, read as zero).

#pragma once
#include "field.cuh"

namespace drand {

constexpr int GROUP = 32;              // threads per lane of K3 / K4: a warp
constexpr int GROUP_THREADS = 128;     // threads per block at most
constexpr int GROUP_SMEM = 48 * 1024;  // no opt-in to more shared memory
constexpr int OP_ADD = 1, OP_SUB = 2, OP_HALVE = 4, OP_EQ = 8, OP_SEL = 16;
constexpr int OP_FLAG_SHIFT = 8;       // a select's flag slot: kind >> 8

struct GroupProg {
  const int32_t* frags;
  const int32_t* phases;
  const int32_t* ops;
  int nslots, inv_in, inv_out;
};

DI GroupProg group_prog(const int32_t* p) {
  GroupProg g;
  g.nslots = p[0];
  g.inv_in = p[4];
  g.inv_out = p[5];
  g.frags = p + 6;
  g.phases = g.frags + 2 * p[1];
  g.ops = g.phases + 3 * p[2];
  return g;
}

template <int W, class Body>
DI void group_phase(Body body) {
  static_assert(W >= 1 && W <= 32 && 32 % W == 0, "a group within a warp");
#ifdef __CUDACC__
  body((int)(threadIdx.x % W));
  __syncwarp();
#else
  for (int t = 0; t < W; t++) body(t);
#endif
}

DI void words_shr1(uint32_t* x) {
  UNROLL for (int i = 0; i < 11; i++) x[i] = (x[i] >> 1) | (x[i + 1] << 31);
  x[11] >>= 1;
}

// x / 2 mod p for canonical x
DI void fp_half(Fp& x) {
  const uint32_t odd = 0u - (x.v[0] & 1u);
  uint64_t c = 0;
  UNROLL for (int i = 0; i < 12; i++) {
    c += (uint64_t)x.v[i] + (kP[i] & odd);
    x.v[i] = (uint32_t)c;
    c >>= 32;
  }
  words_shr1(x.v);  // x + p < 2^382: no carry out
}

// r = (a + b) or (a - b), canonical, halved mod p with OP_HALVE.  Add and
// sub share one instruction stream, so a linear phase mixing them does not
// diverge, and two chains of 12 carries: s = a + b, or a - b as a + ~b + 1
// (carry out: a >= b); then t = s - p for add (carry out: s >= p), s + p
// for sub; r = t where that carry says so.
DI void fp_lin(Fp& r, const Fp& a, const Fp& b, int kind) {
  const uint32_t m = 0u - (uint32_t)((kind & 3) == OP_SUB);
  uint32_t s[12], t[12];
  uint64_t c = m & 1u;
  UNROLL for (int i = 0; i < 12; i++) {
    c += (uint64_t)a.v[i] + (b.v[i] ^ m);
    s[i] = (uint32_t)c;
    c >>= 32;
  }
  uint64_t d = ~m & 1u;  // s + (~p + 1) = s - p for add; s + p for sub
  UNROLL for (int i = 0; i < 12; i++) {
    d += (uint64_t)s[i] + (kP[i] ^ ~m);
    t[i] = (uint32_t)d;
    d >>= 32;
  }
  const bool use_t = m ? c == 0 : d != 0;
  UNROLL for (int i = 0; i < 12; i++) r.v[i] = use_t ? t[i] : s[i];
  if (kind & OP_HALVE) fp_half(r);
}

// The flag a == b: every word all ones where equal, all zeros where not.
DI void flag_eq(Fp& r, const Fp& a, const Fp& b) {
  uint32_t acc = 0;
  UNROLL for (int i = 0; i < 12; i++) acc |= a.v[i] ^ b.v[i];
  const uint32_t m = 0u - (uint32_t)(acc == 0u);
  UNROLL for (int i = 0; i < 12; i++) r.v[i] = m;
}

// r = f ? a : b, word by word under the flag's mask: no branch on data.
DI void flag_sel(Fp& r, const Fp& f, const Fp& a, const Fp& b) {
  UNROLL for (int i = 0; i < 12; i++)
    r.v[i] = (a.v[i] & f.v[i]) | (b.v[i] & ~f.v[i]);
}

// A slot in shared memory: on the card three 16-byte accesses (slots are
// 48 bytes from a 16-byte aligned base, group_enter), where a struct copy
// took twelve 4-byte ones; a plain copy on the host.
DI Fp slot_load(const Fp* p) {
#ifdef __CUDACC__
  const uint4* q = reinterpret_cast<const uint4*>(p);
  Fp r;
  UNROLL for (int i = 0; i < 3; i++) {
    const uint4 x = q[i];
    r.v[4 * i] = x.x;
    r.v[4 * i + 1] = x.y;
    r.v[4 * i + 2] = x.z;
    r.v[4 * i + 3] = x.w;
  }
  return r;
#else
  return *p;
#endif
}

DI void slot_store(Fp* p, const Fp& a) {
#ifdef __CUDACC__
  uint4* q = reinterpret_cast<uint4*>(p);
  UNROLL for (int i = 0; i < 3; i++)
    q[i] = make_uint4(a.v[4 * i], a.v[4 * i + 1], a.v[4 * i + 2],
                      a.v[4 * i + 3]);
#else
  *p = a;
#endif
}

// Run fragment f of the program on one lane (slots `lane`, constants `cs`).
// An op reads all its operands before it writes; an operand is a lane
// slot or a constant row, picked by address so that one load serves both.
template <int W>
DI void run_frag(const GroupProg& g, Fp* lane, const Fp* cs, int f) {
  const int p0 = g.frags[2 * f], np = g.frags[2 * f + 1];
  for (int ph = p0; ph < p0 + np; ph++) {
    const int32_t* phase = g.phases + 3 * ph;
    const int o0 = phase[0], n = phase[1];
    const bool prod = phase[2] != 0;
    group_phase<W>([&](int t) {
      for (int k = t; k < n; k += W) {
        const int32_t* op = g.ops + 4 * (o0 + k);
        const int kind = op[0], sa = op[2], sb = op[3];
        const Fp a = slot_load(sa < g.nslots ? lane + sa
                                             : cs + (sa - g.nslots));
        const Fp b = slot_load(sb < g.nslots ? lane + sb
                                             : cs + (sb - g.nslots));
        Fp r;
        if (prod) fp_mul(r, a, b);
        else if (kind & OP_SEL)
          flag_sel(r, slot_load(lane + (kind >> OP_FLAG_SHIFT)), a, b);
        else if (kind & OP_EQ) flag_eq(r, a, b);
        else fp_lin(r, a, b, kind);
        slot_store(lane + op[1], r);
      }
    });
  }
}

// The constant slots: bundle rows, row 0 (the raw p) as zero.
DI void load_group_consts(Fp* cs, const uint32_t* consts, int t, int nt) {
  for (int i = t; i < N_CONST * 12; i += nt)
    cs[i / 12].v[i % 12] = i < 12 ? 0u : consts[i];
}

// Lane I/O of n Fp coordinates at slots 0 .. n-1 (structure of arrays).
// Every group of a warp calls these (they synchronise the warp); a group
// past the last lane reads lane B - 1 and stores nothing (group_enter).
template <int W>
DI void load_lane(Fp* lane, const uint32_t* in, int n, int64_t B,
                  int64_t idx) {
  const int64_t src = idx < B ? idx : B - 1;
  group_phase<W>([&](int t) {
    for (int c = t; c < n; c += W) load_fp(lane[c], in, c, B, src);
  });
}

template <int W>
DI void store_lane(uint32_t* out, const Fp* lane, int n, int64_t B,
                   int64_t idx) {
  group_phase<W>([&](int t) {
    for (int c = t; c < n && idx < B; c += W)
      store_fp(out, c, lane[c], B, idx);
  });
}

// The plain engine's limb tensors, one pointer a coordinate, which K7 and
// K8 read and write themselves (no word layout around their launches):
// coordinate c of lane b at c[c] + 24 b (field.cuh load_fp_limbs).
constexpr int MAX_COORDS = 12;
struct Limbs { int64_t* c[MAX_COORDS]; };

static inline Limbs limbs_of(const void* const* ptrs, int n) {
  Limbs l = {};
  for (int i = 0; i < n && i < MAX_COORDS; i++) l.c[i] = (int64_t*)ptrs[i];
  return l;
}

// Lane I/O of n coordinates at slots 0 .. n-1 from and to the limb
// tensors, as load_lane / store_lane do from the word layout.
template <int W>
DI void load_lane_limbs(Fp* lane, const Limbs& in, int n, int64_t B,
                        int64_t idx) {
  const int64_t src = idx < B ? idx : B - 1;
  group_phase<W>([&](int t) {
    for (int c = t; c < n; c += W) {
      Fp x;
      load_fp_limbs(x, in.c[c], src);
      slot_store(lane + c, x);
    }
  });
}

template <int W>
DI void store_lane_limbs(const Limbs& out, const Fp* lane, int n, int64_t B,
                         int64_t idx) {
  group_phase<W>([&](int t) {
    for (int c = t; c < n && idx < B; c += W)
      store_fp_limbs(out.c[c], slot_load(lane + c), idx);
  });
}

// One lane: nin Fp coordinates in at slots 0.., the fragments of `sched`
// in order (SCHED_INVERT: the Fp inverse of slot inv_in into inv_out, on
// one thread: field.cuh's constant-time fp_inv), 12 Fp leaves out from
// slots 0..11.  The loops over the bits of |x| are in the schedule
// (fp12prog.schedule), uniform across the group.
constexpr int SCHED_INVERT = -1;

DI void group_lane(const GroupProg& g, Fp* lane, const Fp* cs,
                   const uint32_t* in, int nin, uint32_t* out,
                   const int32_t* sched, int nsched, int64_t B,
                   int64_t idx) {
  load_lane<GROUP>(lane, in, nin, B, idx);
  for (int s = 0; s < nsched; s++) {
    const int f = sched[s];
    if (f == SCHED_INVERT) {
      group_phase<GROUP>([&](int t) {
        if (t == 0) fp_inv(lane[g.inv_out], lane[g.inv_in]);
      });
    } else {
      run_frag<GROUP>(g, lane, cs, f);
    }
  }
  store_lane<GROUP>(out, lane, 12, B, idx);
}

// One lane of a kernel whose public constant schedules its fragments (K2's
// scalar, K5's exponent): NC Fp coordinates in at slots NC .. 2 NC - 1,
// the fragments of `sched` in order, NC out from slots 0 .. NC - 1.
template <int W, int NC>
DI void sched_lane(const GroupProg& g, Fp* lane, const Fp* cs,
                   const uint32_t* in, uint32_t* out, const int32_t* sched,
                   int nsched, int64_t B, int64_t idx) {
  load_lane<W>(lane + NC, in, NC, B, idx);
  for (int s = 0; s < nsched; s++) run_frag<W>(g, lane, cs, sched[s]);
  store_lane<W>(out, lane, NC, B, idx);
}

}  // namespace drand

// Launch of a group kernel: `width` threads a lane, the lanes' slots and
// the constant slots in dynamic shared memory, at most 48 KB a block (no
// opt-in).  Lanes a block: whole warps of lanes, at most GROUP_THREADS
// threads, the count that keeps the most lanes resident on an SM (228 KB
// of shared memory, 1 KB of it reserved per block; 2048 threads, 32
// blocks).  Returns cudaGetLastError() (1, invalid value, if one lane's
// slots do not fit).
constexpr int SM_SMEM = 228 * 1024, BLOCK_SMEM_RESERVED = 1024;
constexpr int SM_THREADS = 2048, SM_BLOCKS = 32;

static inline int group_smem_bytes(int lanes, int nslots) {
  return (int)sizeof(drand::Fp) * (drand::N_CONST + lanes * nslots);
}

static inline int group_lanes_per_block(int nslots, int width) {
  int best = 0, best_res = 0;
  const int step = 32 / width;  // lanes a warp
  for (int l = step; l * width <= drand::GROUP_THREADS; l += step) {
    const int smem = group_smem_bytes(l, nslots);
    if (smem > drand::GROUP_SMEM) break;
    int blocks = SM_SMEM / (smem + BLOCK_SMEM_RESERVED);
    if (blocks * l * width > SM_THREADS) blocks = SM_THREADS / (l * width);
    if (blocks > SM_BLOCKS) blocks = SM_BLOCKS;
    if (blocks * l >= best_res) {
      best = l;
      best_res = blocks * l;
    }
  }
  return best;
}

// The layout of a group launch, for the records: out[0] lanes a block,
// out[1] dynamic shared-memory bytes a block.
extern "C" int drand_group_layout(int nslots, int width, int32_t* out);

#ifdef __CUDACC__
#define DRAND_GROUP_LAUNCH(kernel, W, B, nslots, stream, ...)                \
  do {                                                                       \
    const int lanes_ = group_lanes_per_block(nslots, W);                     \
    if (lanes_ < 1) return 1;                                                \
    if ((B) > 0) {                                                           \
      const int64_t blocks_ = ((B) + lanes_ - 1) / lanes_;                   \
      const size_t smem_ = (size_t)group_smem_bytes(lanes_, nslots);        \
      kernel<<<(unsigned)blocks_, lanes_ * (W), smem_,                       \
               (cudaStream_t)(stream)>>>(__VA_ARGS__);                       \
    }                                                                        \
    return (int)cudaGetLastError();                                          \
  } while (0)

// The block's constant slots at smem (16-byte aligned: the kernels declare
// it so, and every slot is 48 bytes), this group's lane slots after them;
// nullptr for a warp whose first lane is past the last (once the block has
// loaded the constants together).  The other groups of a live warp run:
// past the last lane, a group repeats lane B - 1 and stores nothing
// (load_lane, store_lane), so every phase's __syncwarp meets all 32
// threads.
template <int W>
DI drand::Fp* group_enter(drand::Fp* smem, const uint32_t* consts, int nslots,
                          int64_t B, int64_t* idx) {
  drand::load_group_consts(smem, consts, threadIdx.x, blockDim.x);
  __syncthreads();
  const int gi = threadIdx.x / W;
  *idx = (int64_t)blockIdx.x * (blockDim.x / W) + gi;
  const int64_t warp_first = *idx - (threadIdx.x % 32) / W;
  return warp_first < B ? smem + drand::N_CONST + gi * nslots : nullptr;
}
#else
#include <vector>
// The host rehearsal: the same lane code for every lane in turn.
template <class LaneFn>
static int group_host_run(const int32_t* prog, const uint32_t* consts,
                          int64_t B, LaneFn fn) {
  const drand::GroupProg g = drand::group_prog(prog);
  drand::Fp cs[drand::N_CONST];
  drand::load_group_consts(cs, consts, 0, 1);
  std::vector<drand::Fp> lane(g.nslots);
  for (int64_t idx = 0; idx < B; idx++) fn(g, lane.data(), cs, idx);
  return 0;
}
#endif
