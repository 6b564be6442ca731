// Kernel 3: front-to-back alpha blend of the tile-sorted duplicates.
//
// Replaces the TPU kernel autovfx_tpu/ops/blend_pallas.py `_fwd_kernel`
// -> `_fwd_body` (and its alternative bodies `_fwd_kernel_compact` and
// `_fwd_kernel_v3`), entry `_blend_fwd_call`.  All three compute the
// contract of forward.cu renderCUDA: alpha = min(0.99, op * exp(power)),
// skip the duplicate when power > 0 or alpha < 1/255, stop a pixel for
// good at the first duplicate that would take T below 1e-4 (that one is
// not blended), and output color = sum(c * alpha * T), depth = sum(d *
// alpha * T), alpha = 1 - T.  Every pixel gets this exact freeze in
// f32; the TPU packed path's chunk-granular freeze and bf16 features do
// not carry over.  The background term is added by the caller.
//
// What bounds it on this card: the exp and the handful of FMAs per
// (duplicate, pixel) pair, and the gid-indexed feature reads (10 floats
// per duplicate, scattered over the per-Gaussian arrays).  The simple
// design is renderCUDA's: one block per tile, 256 threads, each thread
// owning tile^2 / 256 pixels (1 at tile 16, 4 at tile 32, so a block
// never needs more than 256 threads' registers); the block stages
// batches of 256 duplicates in shared memory, each thread loading one
// duplicate's features by its gid, so the TPU path's (16|8, K) per-
// duplicate feature gather disappears.  A block stops when all of its
// pixels are frozen.  Results go straight into the (H, W, ...) images.
//
// The training variant (template flag TRAIN, entry `blend_fwd_train`)
// also stores each pixel's final transmittance and n_contrib, the
// number of leading duplicates of its tile up to and including the last
// one it blended (CUDA's final_T and n_contrib), which kernel 4 starts
// its back-to-front replay from.  The novel-view entry `blend_fwd` does
// not pay for those writes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "blend_common.cuh"

namespace {

using blend::kAlphaMax;
using blend::kAlphaMin;
using blend::kThreads;
using blend::kTEps;

template <int PPT, bool TRAIN>
__global__ void __launch_bounds__(kThreads) blend_kernel(
    const int* __restrict__ tile_range, const int* __restrict__ gid,
    const float* __restrict__ mean2d, const float* __restrict__ conic,
    const float* __restrict__ opacity, const float* __restrict__ color,
    const float* __restrict__ depth, int tiles_x, int tile, int width,
    int height, float* __restrict__ out_color, float* __restrict__ out_depth,
    float* __restrict__ out_alpha, float* __restrict__ out_final_t,
    int* __restrict__ out_n_contrib) {
  __shared__ float2 s_xy[kThreads];
  __shared__ float4 s_conic_op[kThreads];
  __shared__ float4 s_rgbd[kThreads];

  const int t = blockIdx.x;
  const int ox = (t % tiles_x) * tile;
  const int oy = (t / tiles_x) * tile;
  const int start = tile_range[2 * t];
  const int end = tile_range[2 * t + 1];

  float px[PPT], py[PPT], T[PPT], C[PPT][3], D[PPT];
  int last[PPT];
  bool inside[PPT], done[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = threadIdx.x + j * kThreads;
    const int x = ox + p % tile, y = oy + p / tile;
    px[j] = (float)x;
    py[j] = (float)y;
    inside[j] = x < width && y < height;
    done[j] = !inside[j];
    T[j] = 1.0f;
    C[j][0] = C[j][1] = C[j][2] = 0.0f;
    D[j] = 0.0f;
    last[j] = 0;
  }

  for (int base = start; base < end; base += kThreads) {
    bool mine_done = true;
#pragma unroll
    for (int j = 0; j < PPT; ++j) mine_done = mine_done && done[j];
    // also the barrier that keeps last batch's readers ahead of the loads
    if (__syncthreads_count(mine_done) == kThreads) break;

    const int k = base + threadIdx.x;
    if (k < end) {
      const int g = gid[k];
      s_xy[threadIdx.x] = make_float2(mean2d[2 * g], mean2d[2 * g + 1]);
      s_conic_op[threadIdx.x] = make_float4(conic[3 * g], conic[3 * g + 1],
                                            conic[3 * g + 2], opacity[g]);
      s_rgbd[threadIdx.x] = make_float4(color[3 * g], color[3 * g + 1],
                                        color[3 * g + 2], depth[g]);
    }
    __syncthreads();

    const int count = min(kThreads, end - base);
    for (int m = 0; m < count; ++m) {
      const float2 xy = s_xy[m];
      const float4 co = s_conic_op[m];
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        if (done[j]) continue;
        const float dx = xy.x - px[j];
        const float dy = xy.y - py[j];
        const float power =  // as in blend_bwd.cu (blend_common.cuh)
            -0.5f * (co.x * dx * dx + co.z * dy * dy) - co.y * dx * dy;
        if (power > 0.0f) continue;
        const float alpha = fminf(kAlphaMax, co.w * expf(power));
        if (alpha < kAlphaMin) continue;
        const float test_T = T[j] * (1.0f - alpha);
        if (test_T < kTEps) {
          done[j] = true;
          continue;
        }
        const float4 rgbd = s_rgbd[m];
        const float w = alpha * T[j];
        C[j][0] += rgbd.x * w;
        C[j][1] += rgbd.y * w;
        C[j][2] += rgbd.z * w;
        D[j] += rgbd.w * w;
        T[j] = test_T;
        if (TRAIN) last[j] = base + m - start + 1;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    if (!inside[j]) continue;
    const int pix = (int)py[j] * width + (int)px[j];
    out_color[3 * pix] = C[j][0];
    out_color[3 * pix + 1] = C[j][1];
    out_color[3 * pix + 2] = C[j][2];
    out_depth[pix] = D[j];
    out_alpha[pix] = 1.0f - T[j];
    if (TRAIN) {
      out_final_t[pix] = T[j];
      out_n_contrib[pix] = last[j];
    }
  }
}

template <bool TRAIN>
int launch(const int* tile_range, const int* gid, const float* mean2d,
           const float* conic, const float* opacity, const float* color,
           const float* depth, int n_tiles, int tiles_x, int tile, int width,
           int height, float* out_color, float* out_depth, float* out_alpha,
           float* out_final_t, int* out_n_contrib, void* stream) {
  if (n_tiles > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (tile == 16) {
      blend_kernel<1, TRAIN><<<n_tiles, kThreads, 0, s>>>(
          tile_range, gid, mean2d, conic, opacity, color, depth, tiles_x,
          tile, width, height, out_color, out_depth, out_alpha, out_final_t,
          out_n_contrib);
    } else if (tile == 32) {
      blend_kernel<4, TRAIN><<<n_tiles, kThreads, 0, s>>>(
          tile_range, gid, mean2d, conic, opacity, color, depth, tiles_x,
          tile, width, height, out_color, out_depth, out_alpha, out_final_t,
          out_n_contrib);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int blend_fwd(const int* tile_range, const int* gid,
                         const float* mean2d, const float* conic,
                         const float* opacity, const float* color,
                         const float* depth, int n_tiles, int tiles_x,
                         int tile, int width, int height, float* out_color,
                         float* out_depth, float* out_alpha, void* stream) {
  return launch<false>(tile_range, gid, mean2d, conic, opacity, color, depth,
                       n_tiles, tiles_x, tile, width, height, out_color,
                       out_depth, out_alpha, nullptr, nullptr, stream);
}

extern "C" int blend_fwd_train(const int* tile_range, const int* gid,
                               const float* mean2d, const float* conic,
                               const float* opacity, const float* color,
                               const float* depth, int n_tiles, int tiles_x,
                               int tile, int width, int height,
                               float* out_color, float* out_depth,
                               float* out_alpha, float* out_final_t,
                               int* out_n_contrib, void* stream) {
  return launch<true>(tile_range, gid, mean2d, conic, opacity, color, depth,
                      n_tiles, tiles_x, tile, width, height, out_color,
                      out_depth, out_alpha, out_final_t, out_n_contrib,
                      stream);
}
