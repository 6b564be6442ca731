// Kernel 2: duplicate expansion with sort keys (duplicateWithKeys).
//
// Replaces the TPU kernel autovfx_tpu/ops/fill_pallas.py `_fill_kernel`
// (entry `monotone_fill`, used by autovfx_tpu/ops/binning.py).  On the
// TPU, binning expands each Gaussian's tile rect into per-duplicate
// slots with a monotone fill (out[j] = values[last start <= j]) built
// from windowed matmuls, then derives tile ids from each slot's rank.
// On a GPU the same map is a load-balanced expansion: every slot j
// below the budget gets, from the Gaussian i whose range [starts[i],
// starts[i] + tiles_touched[i]) holds it, one (key = tile << 32 | float
// bits of depth[i], gid = i) pair, the tile being the slot's rank in
// i's rect, row by row.  Depth is > NEAR_Z > 0 for every live Gaussian,
// so the key's low 32 bits order like the floats.  Slots from
// min(total, budget) to budget get the sentinel (n_tiles << 32, n),
// which sorts after every real key; slots >= budget are never written,
// so an over-budget view is truncated and flagged by the caller, never
// written out of bounds.
//
// What bounds it on this card: bytes.  Each slot of the budget is one
// 8-byte key and one 4-byte gid store, plus ~32 bytes read per
// Gaussian; there is no arithmetic to speak of.  So the design keeps
// the stores whole: a block takes 256 consecutive Gaussians, whose
// slots are one contiguous range, stages their starts, rects and depths
// in shared memory, and its threads walk that range slot by slot, each
// finding its slot's Gaussian by a binary search over the staged starts
// (the last start <= the slot, which is always a live Gaussian's: a
// culled one shares its start with the next).  Neighbouring threads
// store neighbouring slots, whole sectors, and the work is even however
// large one rect is.  A block issues all of its global reads at once,
// so none waits on another, and a block whose Gaussians are all culled
// stops after its share of the sentinel tail, which the blocks write
// grid-stride.  Its rects and depths are read all the same: reading the
// counts first, so that such a block skips them, made every live block
// wait on two round trips, and the kernel 7-12 % slower (on an NVIDIA
// H100 80GB HBM3 at 700 W).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // Gaussians and threads of a block
constexpr int kMinSentinelBlocks = 1024;  // the grid when n is small

__host__ __device__ inline int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__global__ void __launch_bounds__(kThreads) duplicate_kernel(
    int n, const int* __restrict__ tiles_touched,
    const int64_t* __restrict__ starts, const int* __restrict__ tile_min,
    const int* __restrict__ tile_max, const float* __restrict__ depth,
    int tiles_x, int n_tiles, int64_t budget, int64_t* __restrict__ keys,
    int* __restrict__ gids) {
  __shared__ int64_t s_start[kThreads];
  __shared__ int s_x0[kThreads];
  __shared__ int s_y0[kThreads];
  __shared__ int s_w[kThreads];
  __shared__ unsigned s_depth[kThreads];

  // every global read of the block at once, none waiting on another
  const int first = blockIdx.x * kThreads;
  const int m = first < n ? min(kThreads, n - first) : 0;  // its Gaussians
  int64_t start = 0;
  int x0 = 0, y0 = 0, w = 0;
  unsigned bits = 0u;
  if (threadIdx.x < m) {  // a culled Gaussian's rect is read, never used
    const int i = first + threadIdx.x;
    start = starts[i];
    x0 = tile_min[2 * i];
    y0 = tile_min[2 * i + 1];
    w = tile_max[2 * i] - x0;
    bits = __float_as_uint(depth[i]);
  }
  const int64_t total = n > 0 ? starts[n - 1] + tiles_touched[n - 1] : 0;
  const int64_t lo = m > 0 ? starts[first] : 0;
  const int64_t hi = m > 0 ? min64(starts[first + m - 1] +
                                       tiles_touched[first + m - 1], budget)
                           : 0;

  // the sentinel tail, [min(total, budget), budget)
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t kept = min64(total, budget);
  for (int64_t j = kept + blockIdx.x * kThreads + threadIdx.x; j < budget;
       j += stride) {
    keys[j] = (int64_t)n_tiles << 32;
    gids[j] = n;
  }
  if (lo >= hi) return;  // no Gaussians, all culled, or past the budget

  if (threadIdx.x < m) {
    s_start[threadIdx.x] = start;
    s_x0[threadIdx.x] = x0;
    s_y0[threadIdx.x] = y0;
    s_w[threadIdx.x] = w;
    s_depth[threadIdx.x] = bits;
  }
  __syncthreads();

  for (int64_t j = lo + threadIdx.x; j < hi; j += kThreads) {
    int a = 0, b = m;  // s_start[a] <= j < s_start[b] (s_start[m] = inf)
    while (b - a > 1) {
      const int mid = (a + b) >> 1;
      if (s_start[mid] <= j) {
        a = mid;
      } else {
        b = mid;
      }
    }
    const int rank = (int)(j - s_start[a]);
    const int dy = rank / s_w[a];
    const int tile =
        (s_y0[a] + dy) * tiles_x + s_x0[a] + (rank - dy * s_w[a]);
    keys[j] = ((int64_t)tile << 32) | (int64_t)s_depth[a];
    gids[j] = first + a;
  }
}

}  // namespace

extern "C" int duplicate_with_keys(
    int n, const int* tiles_touched, const int64_t* starts,
    const int* tile_min, const int* tile_max, const float* depth,
    int tiles_x, int n_tiles, int64_t budget, int64_t* keys, int* gids,
    void* stream) {
  const int sentinel_blocks =
      (int)min64((budget + kThreads - 1) / kThreads, kMinSentinelBlocks);
  const int gaussian_blocks = (n + kThreads - 1) / kThreads;
  const int blocks = gaussian_blocks > sentinel_blocks ? gaussian_blocks
                                                       : sentinel_blocks;
  if (blocks > 0) {
    duplicate_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        n, tiles_touched, starts, tile_min, tile_max, depth, tiles_x, n_tiles,
        budget, keys, gids);
  }
  return (int)cudaGetLastError();
}
