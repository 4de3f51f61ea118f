// K7: the sum of each 256-lane tile of Jacobian points, G1 and G2.
//
// Replaces drand_tpu/ops/pallas_field.py _sum_call (_sum_tile_math), both
// instances.  The TPU kernel rotates the whole tile by sh = 128, 64, ..., 1
// and adds, so lane 0 ends up holding add(pt[i], pt[i + sh]) at every level
// with i + sh < 2 sh; here the threads i < sh of a 256-thread block add
// exactly those pairs through shared memory, so lane 0's result is the TPU
// kernel's (and the JAX package's) Jacobian point limb for limb.  The caller
// (kernels.sum_points) feeds the per-tile partials to the next launch.
//
// Bound on this card: neither bytes nor operations -- 255 complete adds a
// tile, but eight dependent levels of one add each and two launches for
// 8192 lanes, so it is latency bound.  Design: one block per tile, one
// __syncthreads() a level, the tile in shared memory: 256 G1 points of 144
// bytes (36 KB, static), or 256 G2 points of 288 bytes (73,728 bytes: over
// the 48 KB of a static array, so dynamic shared memory, allowed once per
// process with cudaFuncAttributeMaxDynamicSharedMemorySize).  The tile is
// not shrunk for G2: the association must stay the TPU kernel's.

#include "field.cuh"

using namespace drand;

#define SUM_TILE 256

#ifdef __CUDACC__
template <class J>
DI void sum_tile(J* tile, const uint32_t* in, uint32_t* out, int64_t B) {
  const int t = threadIdx.x;
  const int64_t lane = (int64_t)blockIdx.x * SUM_TILE + t;
  load_point(tile[t], in, 0, B, lane);
  __syncthreads();
  for (int sh = SUM_TILE / 2; sh >= 1; sh >>= 1) {
    // thread t writes only slot t < sh and reads slots t and t + sh, which
    // no thread writes at this level
    if (t < sh) {
      J a = tile[t];
      const J b = tile[t + sh];
      point_add(a, a, b);
      tile[t] = a;
    }
    __syncthreads();
  }
  if (t == 0) store_point(out, 0, tile[0], B / SUM_TILE, blockIdx.x);
}

__global__ void __launch_bounds__(SUM_TILE) k_sum_g1(const uint32_t* in,
                                                     uint32_t* out,
                                                     int64_t B) {
  __shared__ G1J tile[SUM_TILE];
  sum_tile(tile, in, out, B);
}

__global__ void __launch_bounds__(SUM_TILE) k_sum_g2(const uint32_t* in,
                                                     uint32_t* out,
                                                     int64_t B) {
  extern __shared__ __align__(16) unsigned char smem[];
  sum_tile(reinterpret_cast<G2J*>(smem), in, out, B);
}

// B must be a multiple of SUM_TILE (the wrapper pads with infinity)
extern "C" int drand_sum_g1(const void* in, void* out, int64_t B,
                            void* stream) {
  DRAND_LAUNCH(k_sum_g1, B, SUM_TILE, stream, (const uint32_t*)in,
               (uint32_t*)out, B);
}

extern "C" int drand_sum_g2(const void* in, void* out, int64_t B,
                            void* stream) {
  const int smem = SUM_TILE * (int)sizeof(G2J);
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        k_sum_g2, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  if (B > 0)
    k_sum_g2<<<(unsigned)(B / SUM_TILE), SUM_TILE, smem,
               (cudaStream_t)stream>>>((const uint32_t*)in, (uint32_t*)out,
                                       B);
  return (int)cudaGetLastError();
}
#else
template <class J>
static int sum_host(const void* in, void* out, int64_t B) {
  const int64_t tiles = B / SUM_TILE;
  J* tile = new J[SUM_TILE];
  for (int64_t blk = 0; blk < tiles; blk++) {
    for (int t = 0; t < SUM_TILE; t++)
      load_point(tile[t], (const uint32_t*)in, 0, B, blk * SUM_TILE + t);
    for (int sh = SUM_TILE / 2; sh >= 1; sh >>= 1)
      for (int t = 0; t < sh; t++) point_add(tile[t], tile[t], tile[t + sh]);
    store_point((uint32_t*)out, 0, tile[0], tiles, blk);
  }
  delete[] tile;
  return 0;
}

extern "C" int drand_sum_g1(const void* in, void* out, int64_t B,
                            void* stream) {
  (void)stream;
  return sum_host<G1J>(in, out, B);
}

extern "C" int drand_sum_g2(const void* in, void* out, int64_t B,
                            void* stream) {
  (void)stream;
  return sum_host<G2J>(in, out, B);
}
#endif
