// K7: the sum of each 256-lane tile of G1 Jacobian points.
//
// Replaces drand_tpu/ops/pallas_field.py _sum_call (_sum_tile_math), G1
// instance.  The TPU kernel rotates the whole tile by sh = 128, 64, ..., 1
// and adds, so lane 0 ends up holding add(pt[i], pt[i + sh]) at every level
// with i + sh < 2 sh; here the threads i < sh of a 256-thread block add
// exactly those pairs through shared memory, so lane 0's result is the TPU
// kernel's (and the JAX package's) Jacobian point limb for limb.  The caller
// (kernels.sum_points) feeds the per-tile partials to the next launch.
//
// Bound on this card: neither bytes nor operations -- 255 complete adds a
// tile, but eight dependent levels of one add each and two launches for
// 8192 lanes, so it is latency bound.  Design: one block per tile, 256
// points of 144 bytes (36 KB) in shared memory, one __syncthreads() a level.

#include "field.cuh"

using namespace drand;

#define SUM_TILE 256

#ifdef __CUDACC__
__global__ void __launch_bounds__(SUM_TILE) k_sum_g1(const uint32_t* in,
                                                     uint32_t* out,
                                                     int64_t B) {
  __shared__ G1J tile[SUM_TILE];
  const int t = threadIdx.x;
  const int64_t lane = (int64_t)blockIdx.x * SUM_TILE + t;
  load_fp(tile[t].X, in, 0, B, lane);
  load_fp(tile[t].Y, in, 1, B, lane);
  load_fp(tile[t].Z, in, 2, B, lane);
  __syncthreads();
  for (int sh = SUM_TILE / 2; sh >= 1; sh >>= 1) {
    // thread t writes only slot t < sh and reads slots t and t + sh, which
    // no thread writes at this level
    if (t < sh) {
      G1J a = tile[t];
      const G1J b = tile[t + sh];
      g1_add(a, a, b);
      tile[t] = a;
    }
    __syncthreads();
  }
  if (t == 0) {
    const int64_t tiles = B / SUM_TILE;
    store_fp(out, 0, tile[0].X, tiles, blockIdx.x);
    store_fp(out, 1, tile[0].Y, tiles, blockIdx.x);
    store_fp(out, 2, tile[0].Z, tiles, blockIdx.x);
  }
}

// B must be a multiple of SUM_TILE (the wrapper pads with infinity)
extern "C" int drand_sum_g1(const void* in, void* out, int64_t B,
                            void* stream) {
  DRAND_LAUNCH(k_sum_g1, B, SUM_TILE, stream, (const uint32_t*)in,
               (uint32_t*)out, B);
}
#else
extern "C" int drand_sum_g1(const void* in, void* out, int64_t B,
                            void* stream) {
  (void)stream;
  const int64_t tiles = B / SUM_TILE;
  G1J tile[SUM_TILE];
  for (int64_t blk = 0; blk < tiles; blk++) {
    for (int t = 0; t < SUM_TILE; t++) {
      const int64_t lane = blk * SUM_TILE + t;
      load_fp(tile[t].X, (const uint32_t*)in, 0, B, lane);
      load_fp(tile[t].Y, (const uint32_t*)in, 1, B, lane);
      load_fp(tile[t].Z, (const uint32_t*)in, 2, B, lane);
    }
    for (int sh = SUM_TILE / 2; sh >= 1; sh >>= 1)
      for (int t = 0; t < sh; t++) g1_add(tile[t], tile[t], tile[t + sh]);
    store_fp((uint32_t*)out, 0, tile[0].X, tiles, blk);
    store_fp((uint32_t*)out, 1, tile[0].Y, tiles, blk);
    store_fp((uint32_t*)out, 2, tile[0].Z, tiles, blk);
  }
  return 0;
}
#endif
