// Kernel 2: duplicate expansion with sort keys (duplicateWithKeys).
//
// Replaces the TPU kernel autovfx_tpu/ops/fill_pallas.py `_fill_kernel`
// (entry `monotone_fill`, used by autovfx_tpu/ops/binning.py).  On the
// TPU, binning expands each Gaussian's tile rect into per-duplicate
// slots with a monotone fill (out[j] = values[last start <= j]) built
// from windowed matmuls, then derives tile ids from each slot's rank.
// On a GPU the same map is written forward instead, as in the CUDA
// rasterizer's duplicateWithKeys: one thread per Gaussian walks its
// tile rect and writes, from its exclusive offset on, one
// (key = tile << 32 | float bits of depth, gid) pair per covered tile.
// Depth is > NEAR_Z > 0 for every live Gaussian, so the key's low 32
// bits order like the floats.  Slots >= budget are never written (the
// wrapper pre-fills them with a sentinel key that sorts last), so an
// over-budget view is truncated and flagged by the caller, never
// written out of bounds.
//
// What bounds it on this card: bytes.  Each duplicate is one 8-byte key
// and one 4-byte gid store, plus ~40 bytes read per Gaussian; there is
// no arithmetic to speak of.  The simple design writes each Gaussian's
// duplicates from one thread, so the stores of one thread are
// contiguous but a warp's stores are spread over 32 rects.  It also
// makes the TPU path's separate tile-count pass unnecessary: the
// per-tile counts fall out of the tile ranges after the sort.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256) duplicate_kernel(
    int n, const int* __restrict__ tiles_touched,
    const int64_t* __restrict__ starts, const int* __restrict__ tile_min,
    const int* __restrict__ tile_max, const float* __restrict__ depth,
    int tiles_x, int64_t budget, int64_t* __restrict__ keys,
    int* __restrict__ gids) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || tiles_touched[i] == 0) return;
  int64_t off = starts[i];
  const int64_t dbits = (int64_t)__float_as_uint(depth[i]);
  const int x0 = tile_min[2 * i], y0 = tile_min[2 * i + 1];
  const int x1 = tile_max[2 * i], y1 = tile_max[2 * i + 1];
  for (int ty = y0; ty < y1; ++ty) {
    for (int tx = x0; tx < x1; ++tx) {
      if (off >= budget) return;
      keys[off] = ((int64_t)(ty * tiles_x + tx) << 32) | dbits;
      gids[off] = i;
      ++off;
    }
  }
}

}  // namespace

extern "C" int duplicate_with_keys(
    int n, const int* tiles_touched, const int64_t* starts,
    const int* tile_min, const int* tile_max, const float* depth,
    int tiles_x, int64_t budget, int64_t* keys, int* gids, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    duplicate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        n, tiles_touched, starts, tile_min, tile_max, depth, tiles_x, budget,
        keys, gids);
  }
  return (int)cudaGetLastError();
}
