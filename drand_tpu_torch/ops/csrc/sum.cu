// K7: a batch of point sums, G1 and G2, each in the JAX package's
// association, in one launch.
//
// Replaces drand_tpu/ops/pallas_field.py _sum_call (_sum_tile_math) with
// the loop of pallas_field.sum_points around it, both instances.  The TPU
// kernel rotates each 256-lane tile by sh = 128, 64, ..., 1 and adds, so
// lane 0 ends up holding add(pt[i], pt[i + sh]) at every level with i + sh
// < 2 sh; sum_points feeds the per-tile partials, zero-padded to a tile, to
// the next call until one tile is left and folds 2-4 partials in order.
// Here all of that runs in one launch for R rows of B lanes
// (kernels.sum_rows), the same adds in the same association, so each row's
// Jacobian sum equals the JAX package's limb for limb.
//
// Bound on this card: latency.  A sum is a chain of dependent complete adds,
// 8 levels a tile and 5-8 more over the partials, and a level is one add
// deep; only the widest batches (the partials pass, 8 rows) fill the card.
// Design: a block per (tile, row) of the first stage.  Its A groups of W
// threads each run one complete add at a time (group.cuh): fp12prog's
// "sum_g1" / "sum_g2" program, DevCurve.add with its flags and selects, on
// the add's shared-memory slots, so an add is a few product phases deep.
// Level sh's adds j < sh take lanes j and j + sh, A at a time; the tile's
// running points stay in device memory (L2) between levels, which leaves
// the 48 KB of a block (no opt-in) to the adds' slots.  An add whose right
// operand is zero padding (a lane the row does not have) returns its left
// operand limb for limb (curve.py selects p where Z2 == 0, last), so it is
// not run: at level 128 the left lane is copied, below it nothing moves.
// Which adds are padding follows the lane count alone, and a warp skips
// only where all its groups would; the others of a live warp repeat the
// level's last add and store nothing, so every __syncwarp meets the warp.
// The last block of a row to finish its tile (a __threadfence and an atomic
// ticket) runs the later stages over the row's partials, a tile at a time,
// and the in-order fold of the last 2-4, and writes the row's sum.
//
// Points in and out as the plain engine's limb tensors: coordinate c of
// lane b of row r at in.c[c] + 24 (r B + b), the sums at out.c[c] + 24 r.

#include "group.cuh"

using namespace drand;

// threads an add (fp12prog.WIDTH["sum_g1"] / ["sum_g2"], and FILL_WIDTH
// for launches that fill the card; the wrapper picks by the launch's tiles,
// kernels.sum_width, and passes its width, checked here)
constexpr int K7_G1_WIDTH = 8, K7_G1_FILL = 4, K7_G2_WIDTH = 16,
              K7_G2_FILL = 8;
constexpr int SUM_TILE = 256, SUM_HALF = SUM_TILE / 2;
// fp12prog.SUM slots for NC coordinates: the left operand and result at
// 0 .. NC-1, the right operand at NC .. 2 NC - 1; one fragment
constexpr int K7_ADD = 0;

struct SumArgs {
  Limbs in, out;       // (R, B, 24) limbs a coordinate; (R, 24)
  Fp* work;            // R x T0 x 128 points of NC Fp: a tile's running lanes
  Fp* part;            // R x T0 points: a row's partials
  int* tickets;        // R counters, zero at the launch
  int64_t B;           // lanes a row
  int T0;              // tiles a row in the first stage
};

// A point's Fp in device memory (the work and partial buffers): 16-byte
// accesses; the loads bypass L1, since the last block of a row reads what
// other blocks wrote.
DI Fp word_load(const Fp* p) {
#ifdef __CUDACC__
  const uint4* q = reinterpret_cast<const uint4*>(p);
  Fp r;
  UNROLL for (int i = 0; i < 3; i++) {
    const uint4 x = __ldcg(q + i);
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

DI void word_store(Fp* p, const Fp& a) { slot_store(p, a); }

#ifdef __CUDACC__
#define BLOCK_SYNC() __syncthreads()
#else
#define BLOCK_SYNC()
#endif

// Coordinate c of lane lane0 + k of row r: from the input limbs, or (src
// != nullptr, the row's words) from src + (lane0 + k) stride, stride the
// Fp a lane (NC here; the grid form that tools/torch_group_variants.py
// measures reads tiles' sums 128 points apart).
template <int NC>
DI Fp tile_load(const SumArgs& a, int r, int64_t lane0, const Fp* src,
                int64_t stride, int k, int c) {
  if (src) return word_load(src + (lane0 + k) * stride + c);
  Fp x;
  load_fp_limbs(x, a.in.c[c], (int64_t)r * a.B + lane0 + k);
  return x;
}

// One complete add on one group: left = lane lane0 + j, right = lane lane0
// + j + sh of tile_load's source, their sum to dst where `keep`.  Not
// inlined: the interpreter has one copy whatever calls it.
template <int W, int NC>
DNI void sum_add(const GroupProg& g, Fp* slots, const Fp* cs,
                 const SumArgs& a, int r, int64_t lane0, const Fp* src,
                 int64_t stride, int j, int sh, bool keep, Fp* dst) {
  group_phase<W>([&](int t) {
    for (int c = t; c < 2 * NC; c += W)
      slot_store(slots + c,
                 c < NC ? tile_load<NC>(a, r, lane0, src, stride, j, c)
                        : tile_load<NC>(a, r, lane0, src, stride, j + sh,
                                        c - NC));
  });
  run_frag<W>(g, slots, cs, K7_ADD);
  group_phase<W>([&](int t) {
    for (int c = t; c < NC && keep; c += W)
      word_store(dst + c, slot_load(slots + c));
  });
}

// The block's threads and groups: thread tid of nt, group gi of A.
struct SumBlock {
  const GroupProg* g;
  Fp* slots;
  const Fp* cs;
  int tid, nt, gi, A;
};

// Reduce one tile of n live lanes (1..256, the rest zero padding) by the
// halving levels: level 128 reads the tile, lanes lane0 .. of row r, from
// tile_load's source and writes the running lanes wk[0 .. 128), the levels
// below work in wk; the sum ends in wk[0].
template <int W, int NC>
DI void tile_reduce(const SumBlock& k, const SumArgs& a, int r,
                    int64_t lane0, const Fp* src, int n, Fp* wk) {
  constexpr int PER_WARP = 32 / W;
  const int warp_gi = k.gi / PER_WARP * PER_WARP;   // the warp's first group
  int live = n < SUM_HALF ? n : SUM_HALF;
  int nadd = n > SUM_HALF ? n - SUM_HALF : 0;
  // level 128's lanes whose partner is padding: copied
  for (int i = k.tid; i < (live - nadd) * NC; i += k.nt)
    word_store(wk + (nadd + i / NC) * NC + i % NC,
               tile_load<NC>(a, r, lane0, src, NC, nadd + i / NC, i % NC));
  for (int sh = SUM_HALF; sh >= 1; sh >>= 1) {
    if (sh < SUM_HALF) {
      nadd = live > sh ? live - sh : 0;
      live = live < sh ? live : sh;
    }
    for (int j0 = 0; j0 < nadd; j0 += k.A) {
      const int j = j0 + k.gi;
      if (j0 + warp_gi < nadd)
        sum_add<W, NC>(*k.g, k.slots, k.cs, a, r,
                       sh == SUM_HALF ? lane0 : 0, sh == SUM_HALF ? src : wk,
                       NC, j < nadd ? j : nadd - 1, sh, j < nadd,
                       wk + (j < nadd ? j : 0) * NC);
    }
    BLOCK_SYNC();
  }
}

DI void copy_point(const SumBlock& k, Fp* dst, const Fp* src, int nc) {
  for (int c = k.tid; c < nc; c += k.nt) word_store(dst + c, word_load(src + c));
}

// True in the last block of a row to finish its tile: its partial and
// every other block's are then in device memory.
DI bool last_of_row(int* ticket, int tiles) {
#ifdef __CUDACC__
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == tiles - 1;
  __syncthreads();
  return last;
#else
  return ++*ticket == tiles;
#endif
}

template <int W, int NC>
DI void sum_block(const SumBlock& k, const SumArgs& a, int r, int t) {
  Fp* wk = a.work + ((int64_t)r * a.T0 + t) * SUM_HALF * NC;
  Fp* pr = a.part + (int64_t)r * a.T0 * NC;
  const int64_t lane0 = (int64_t)t * SUM_TILE, left = a.B - lane0;
  tile_reduce<W, NC>(k, a, r, lane0, nullptr,
                     left < SUM_TILE ? (int)left : SUM_TILE, wk);
  copy_point(k, pr + t * NC, wk, NC);
  if (!last_of_row(a.tickets + r, a.T0)) return;
  // the row's later stages: its partials, a tile at a time, the partial of
  // tile u written over partial u (tile u has read it: u <= 256 u)
  int n = a.T0;
  while (n > 4) {
    const int tiles = (n + SUM_TILE - 1) / SUM_TILE;
    for (int u = 0; u < tiles; u++) {
      const int m = n - u * SUM_TILE;
      tile_reduce<W, NC>(k, a, r, (int64_t)u * SUM_TILE, pr,
                         m < SUM_TILE ? m : SUM_TILE, wk);
      copy_point(k, pr + u * NC, wk, NC);
      BLOCK_SYNC();
    }
    n = tiles;
  }
  // the fold, pr[0] += pr[i] in order, and the row's sum out: the first
  // warp (its other groups repeat group 0's adds and store nothing)
  if (k.gi >= 32 / W) return;
  for (int i = 1; i < n; i++)
    sum_add<W, NC>(*k.g, k.slots, k.cs, a, r, 0, pr, NC, 0, i, k.gi == 0,
                   pr);
  group_phase<W>([&](int th) {
    for (int c = th; c < NC && k.gi == 0; c += W)
      store_fp_limbs(a.out.c[c], word_load(pr + c), r);
  });
}

// Adds a block runs at once: whole warps of groups, their slots and the
// constants under 48 KB with the block's ticket flag (no opt-in), at most
// one level's 128 adds and K7_THREADS threads.
constexpr int K7_THREADS = 512;
static inline int sum_adds_per_block(int nslots, int width) {
  const int per_warp = 32 / width;
  int adds = ((GROUP_SMEM - 64) / (int)sizeof(Fp) - N_CONST) / nslots;
  if (adds > SUM_HALF) adds = SUM_HALF;
  if (adds * width > K7_THREADS) adds = K7_THREADS / width;
  return adds / per_warp * per_warp;
}

// The layout of a K7 launch, for the records: out[0] adds a block, out[1]
// dynamic shared-memory bytes a block.
extern "C" int drand_sum_layout(int nslots, int width, int32_t* out) {
  out[0] = sum_adds_per_block(nslots, width);
  out[1] = (int)sizeof(Fp) * (N_CONST + out[0] * nslots);
  return 0;
}

#ifdef __CUDACC__
template <int W, int NC>
DI void sum_kernel(const uint32_t* consts, const int32_t* prog,
                   const SumArgs& a) {
  extern __shared__ __align__(16) Fp smem[];
  const GroupProg g = group_prog(prog);
  load_group_consts(smem, consts, threadIdx.x, blockDim.x);
  __syncthreads();
  const int gi = threadIdx.x / W;
  const SumBlock k{&g, smem + N_CONST + gi * g.nslots, smem,
                   (int)threadIdx.x, (int)blockDim.x, gi,
                   (int)blockDim.x / W};
  sum_block<W, NC>(k, a, blockIdx.y, blockIdx.x);
}

#define K7_KERNEL(name, W, NC)                                               \
  __global__ void __launch_bounds__(K7_THREADS)                                   \
      name(const uint32_t* consts, const int32_t* prog, SumArgs a) {        \
    sum_kernel<W, NC>(consts, prog, a);                                      \
  }
K7_KERNEL(k_sum_rows_g1, K7_G1_WIDTH, 3)
K7_KERNEL(k_sum_rows_g1_fill, K7_G1_FILL, 3)
K7_KERNEL(k_sum_rows_g2, K7_G2_WIDTH, 6)
K7_KERNEL(k_sum_rows_g2_fill, K7_G2_FILL, 6)
#define K7_LAUNCH(kernel, W, NC)                                             \
  do {                                                                       \
    const int adds_ = sum_adds_per_block(nslots, W);                         \
    if (adds_ < 1 || rows < 1 || rows > 65535) return 1;                     \
    if (B > 0) {                                                             \
      kernel<<<dim3((unsigned)a.T0, (unsigned)rows), adds_ * (W),            \
               (size_t)sizeof(Fp) * (N_CONST + adds_ * nslots),              \
               (cudaStream_t)stream>>>((const uint32_t*)consts,              \
                                       (const int32_t*)prog, a);             \
    }                                                                        \
    return (int)cudaGetLastError();                                          \
  } while (0)
#else
template <int W, int NC>
static int sum_host(const uint32_t* consts, const int32_t* prog,
                    const SumArgs& a, int rows) {
  const GroupProg g = group_prog(prog);
  Fp cs[N_CONST];
  load_group_consts(cs, consts, 0, 1);
  std::vector<Fp> slots(g.nslots);
  const SumBlock k{&g, slots.data(), cs, 0, 1, 0, 1};
  for (int r = 0; r < rows; r++)
    for (int t = 0; t < a.T0; t++) sum_block<W, NC>(k, a, r, t);
  return 0;
}
#define K7_LAUNCH(kernel, W, NC)                                             \
  return B > 0 ? sum_host<W, NC>((const uint32_t*)consts,                    \
                                 (const int32_t*)prog, a, rows)              \
               : 0
#endif

// in, out: the coordinates' limb tensors (3 on G1, 6 on G2); work, part:
// kernels.sum_rows' scratch; tickets: rows zeros.  The first stage has
// ceil(B / 256) tiles a row.
static inline SumArgs sum_args(const void* const* in, const void* const* out,
                               int nc, void* work, void* part, void* tickets,
                               int64_t B) {
  SumArgs a;
  a.in = limbs_of(in, nc);
  a.out = limbs_of(out, nc);
  a.work = (Fp*)work;
  a.part = (Fp*)part;
  a.tickets = (int*)tickets;
  a.B = B;
  a.T0 = (int)((B + SUM_TILE - 1) / SUM_TILE);
  return a;
}

#define K7_ENTRY(fn, kernel, W, fill, FW, NC)                                \
  extern "C" int fn(const void* const* in, const void* const* out,          \
                    const void* consts, const void* prog, int nslots,        \
                    int width, void* work, void* part, void* tickets,        \
                    int rows, int64_t B, void* stream) {                     \
    (void)stream;                                                            \
    const SumArgs a = sum_args(in, out, NC, work, part, tickets, B);         \
    if (width == W) K7_LAUNCH(kernel, W, NC);                                \
    if (width == FW) K7_LAUNCH(fill, FW, NC);                                \
    return 1;                                                                \
  }
K7_ENTRY(drand_sum_g1, k_sum_rows_g1, K7_G1_WIDTH, k_sum_rows_g1_fill,
         K7_G1_FILL, 3)
K7_ENTRY(drand_sum_g2, k_sum_rows_g2, K7_G2_WIDTH, k_sum_rows_g2_fill,
         K7_G2_FILL, 6)
