// Kernel 4: backward of the tile blend, per-Gaussian gradients.
//
// Replaces the TPU kernel autovfx_tpu/ops/blend_pallas_bwd.py
// `_bwd_kernel`, entry `blend_bwd_call` (the VJP of `_blend_core`).
// Same contract, that of backward.cu renderCUDA: with f = g_C.c + g_D.d
// at a pixel, T_k the transmittance before duplicate k, T_N the final
// one and S_k = sum_{j>k} alpha_j T_j f_j,
//
//   dL/dalpha_k = T_k f_k - (S_k - g_A T_N) / (1 - alpha_k)
//
// for every blended duplicate, and CUDA's straight-through 0.99 clamp:
// dL/dpower = op * exp(power) * dL/dalpha, dL/dop = exp(power) * dL/dalpha
// (the port's features carry opacity, not log-opacity).  dL/dpower then
// goes to mean2d and the conic through power = -0.5 (a dx^2 + c dy^2)
// - b dx dy, and w = alpha T weights the color and depth gradients.
//
// Design (renderCUDA's backward): one block per tile with the forward's
// 256 threads x tile^2/256 pixels.  Each pixel starts from the forward's
// final_T and n_contrib and walks its tile's duplicates back to front,
// rebuilding T_k = T_{k+1} / (1 - alpha_k) by division and carrying S as
// a running sum, so no prefix pass is needed (the TPU kernel's two
// forward passes with triangular-matmul prefix sums do not carry over).
// Duplicates are staged back to front in batches of 256 in shared
// memory, each thread loading one by its gid.  Per duplicate, every
// thread sums its pixels' 10 gradient terms, a warp reduces them with
// shuffles (skipped when no lane of the warp touched the duplicate), and
// lane 0 adds the warp's sum into the batch's shared accumulator; after
// the batch, one atomicAdd per duplicate and field goes into the (N, 10)
// per-Gaussian buffer [mean2d 2, conic 3, opacity 1, color 3, depth 1],
// which the caller zeroes.  So the TPU path's per-duplicate gradient
// rows and their segment-sum disappear.
//
// What bounds it: like the forward, the exp and the arithmetic per
// (duplicate, pixel) pair, plus the 50 shuffles per (duplicate, warp)
// of the reduction.  The atomics are one per (duplicate, field).
#include <cuda_runtime.h>
#include <stdint.h>

#include "blend_common.cuh"

namespace {

using blend::kAlphaMax;
using blend::kAlphaMin;
using blend::kThreads;

constexpr int kFields = 10;

template <int PPT>
__global__ void __launch_bounds__(kThreads) blend_bwd_kernel(
    const int* __restrict__ tile_range, const int* __restrict__ gid,
    const float* __restrict__ mean2d, const float* __restrict__ conic,
    const float* __restrict__ opacity, const float* __restrict__ color,
    const float* __restrict__ depth, const float* __restrict__ final_t,
    const int* __restrict__ n_contrib, const float* __restrict__ g_color,
    const float* __restrict__ g_depth, const float* __restrict__ g_alpha,
    int tiles_x, int tile, int width, int height, float* __restrict__ grad) {
  __shared__ float2 s_xy[kThreads];
  __shared__ float4 s_conic_op[kThreads];
  __shared__ float4 s_rgbd[kThreads];
  __shared__ int s_gid[kThreads];
  __shared__ float s_grad[kThreads][kFields];
  __shared__ int s_max_contrib;

  const int t = blockIdx.x;
  const int ox = (t % tiles_x) * tile;
  const int oy = (t / tiles_x) * tile;
  const int start = tile_range[2 * t];
  const int lane = threadIdx.x & 31;

  float px[PPT], py[PPT], T[PPT], S[PPT], gC[PPT][3], gD[PPT], gAT[PPT];
  int last[PPT];
  int my_max = 0;
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = threadIdx.x + j * kThreads;
    const int x = ox + p % tile, y = oy + p / tile;
    px[j] = (float)x;
    py[j] = (float)y;
    S[j] = 0.0f;
    if (x < width && y < height) {
      const int pix = y * width + x;
      T[j] = final_t[pix];
      last[j] = n_contrib[pix];
      gC[j][0] = g_color[3 * pix];
      gC[j][1] = g_color[3 * pix + 1];
      gC[j][2] = g_color[3 * pix + 2];
      gD[j] = g_depth[pix];
      gAT[j] = g_alpha[pix] * T[j];  // g_A * T_N
    } else {
      T[j] = 1.0f;
      last[j] = 0;
      gC[j][0] = gC[j][1] = gC[j][2] = gD[j] = gAT[j] = 0.0f;
    }
    my_max = max(my_max, last[j]);
  }
  if (threadIdx.x == 0) s_max_contrib = 0;
  __syncthreads();
  atomicMax(&s_max_contrib, my_max);
  __syncthreads();
  const int stop = start + s_max_contrib;  // past every pixel's last blend

  for (int hi = stop; hi > start; hi -= kThreads) {
    const int lo = max(start, hi - kThreads);
    const int count = hi - lo;
    __syncthreads();  // the previous batch's flush has read s_grad, s_gid
    if (threadIdx.x < count) {  // batch slot m holds duplicate hi - 1 - m
      const int g = gid[hi - 1 - threadIdx.x];
      s_gid[threadIdx.x] = g;
      s_xy[threadIdx.x] = make_float2(mean2d[2 * g], mean2d[2 * g + 1]);
      s_conic_op[threadIdx.x] = make_float4(conic[3 * g], conic[3 * g + 1],
                                            conic[3 * g + 2], opacity[g]);
      s_rgbd[threadIdx.x] = make_float4(color[3 * g], color[3 * g + 1],
                                        color[3 * g + 2], depth[g]);
#pragma unroll
      for (int f = 0; f < kFields; ++f) s_grad[threadIdx.x][f] = 0.0f;
    }
    __syncthreads();

    for (int m = 0; m < count; ++m) {
      const int k_rel = hi - 1 - m - start;  // index within the tile's range
      const float2 xy = s_xy[m];
      const float4 co = s_conic_op[m];
      const float4 rgbd = s_rgbd[m];
      float acc[kFields];
#pragma unroll
      for (int f = 0; f < kFields; ++f) acc[f] = 0.0f;
      bool touched = false;
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        if (k_rel >= last[j]) continue;  // after the pixel's last blend
        const float dx = xy.x - px[j];
        const float dy = xy.y - py[j];
        const float power =  // as in blend_fwd.cu (blend_common.cuh)
            -0.5f * (co.x * dx * dx + co.z * dy * dy) - co.y * dx * dy;
        if (power > 0.0f) continue;
        const float gauss = expf(power);
        const float alpha = fminf(kAlphaMax, co.w * gauss);
        if (alpha < kAlphaMin) continue;
        const float one_m = 1.0f - alpha;
        const float Tk = T[j] / one_m;
        const float f = gC[j][0] * rgbd.x + gC[j][1] * rgbd.y +
                        gC[j][2] * rgbd.z + gD[j] * rgbd.w;
        const float w = alpha * Tk;
        const float dl_da = Tk * f - (S[j] - gAT[j]) / one_m;
        S[j] += w * f;
        T[j] = Tk;
        const float dpow = co.w * gauss * dl_da;
        acc[0] -= dpow * (co.x * dx + co.y * dy);
        acc[1] -= dpow * (co.y * dx + co.z * dy);
        acc[2] -= 0.5f * dpow * dx * dx;
        acc[3] -= dpow * dx * dy;
        acc[4] -= 0.5f * dpow * dy * dy;
        acc[5] += gauss * dl_da;
        acc[6] += w * gC[j][0];
        acc[7] += w * gC[j][1];
        acc[8] += w * gC[j][2];
        acc[9] += w * gD[j];
        touched = true;
      }
      if (__any_sync(0xffffffffu, touched)) {
#pragma unroll
        for (int f = 0; f < kFields; ++f) {
          float v = acc[f];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_down_sync(0xffffffffu, v, off);
          if (lane == 0) atomicAdd(&s_grad[m][f], v);
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < count) {
      float* out = grad + (size_t)s_gid[threadIdx.x] * kFields;
#pragma unroll
      for (int f = 0; f < kFields; ++f) {
        const float v = s_grad[threadIdx.x][f];
        if (v != 0.0f) atomicAdd(out + f, v);
      }
    }
  }
}

}  // namespace

extern "C" int blend_bwd(const int* tile_range, const int* gid,
                         const float* mean2d, const float* conic,
                         const float* opacity, const float* color,
                         const float* depth, const float* final_t,
                         const int* n_contrib, const float* g_color,
                         const float* g_depth, const float* g_alpha,
                         int n_tiles, int tiles_x, int tile, int width,
                         int height, float* grad, void* stream) {
  if (n_tiles > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (tile == 16) {
      blend_bwd_kernel<1><<<n_tiles, kThreads, 0, s>>>(
          tile_range, gid, mean2d, conic, opacity, color, depth, final_t,
          n_contrib, g_color, g_depth, g_alpha, tiles_x, tile, width, height,
          grad);
    } else if (tile == 32) {
      blend_bwd_kernel<4><<<n_tiles, kThreads, 0, s>>>(
          tile_range, gid, mean2d, conic, opacity, color, depth, final_t,
          n_contrib, g_color, g_depth, g_alpha, tiles_x, tile, width, height,
          grad);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
