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
// Design: one block of 256 threads per tile.  Each pixel starts from the
// forward's final_T and n_contrib and walks its tile's duplicates back
// to front, rebuilding T_k = T_{k+1} / (1 - alpha_k) and carrying S as a
// running sum, so no prefix pass is needed (the TPU kernel's two
// forward passes with triangular-matmul prefix sums do not carry over).
// Duplicates are staged back to front in batches of 256 in shared
// memory, each thread loading one by its gid.  Per duplicate, every
// thread sums its pixels' 10 gradient terms and the warp sums them over
// its lanes; after the batch, one atomicAdd per duplicate and field goes
// into the (N, 10) per-Gaussian buffer [mean2d 2, conic 3, opacity 1,
// color 3, depth 1], which the caller zeroes.  So the TPU path's
// per-duplicate gradient rows and their segment-sum disappear.
//
// Its work: the exp and ~50 flops per blended (duplicate, pixel) pair,
// and the exp and power of each pair up to a pixel's last contributor
// that its warp does not skip; the per-(duplicate, warp) reduction is
// what the design keeps small:
// - a warp owns a compact patch, each lane a Q x Q quad (16 x 8 pixels
//   at tile 32, 8 x 4 at tile 16; 2 patches across the tile, 4 down; the
//   forward's map, blend_common.cuh), so a small splat meets few warps,
//   and a warp none of whose pixels blended the duplicate skips its
//   reduction;
// - a warp skips a duplicate that provably blends no pixel of its patch
//   (`patch_mask`, shared with the forward): no pair that the forward
//   blended is ever skipped;
// - the reduction is a transposing reduce-scatter: the 10 fields,
//   padded to 16, are halved across lanes in 4 rounds of 8, 4, 2 and 1
//   shuffles plus one, 16 in all (a shuffle tree per field takes 50),
//   and 10 lanes then hold one field's sum each for the shared atomics;
// - the power is spelled with intrinsics, as in kernel 3
//   (blend_common.cuh), so both round each pair's alpha alike;
// - one reciprocal of (1 - alpha) serves both divisions;
// - registers are capped so that 3 blocks fit on an SM (80 registers, a
//   few spilled): a thread holds 4 pixels' state and 10 sums, and at 2
//   blocks (95 registers) the kernel ran 15 % slower (on an NVIDIA H100
//   80GB HBM3 at 700 W).
#include <cuda_runtime.h>
#include <stdint.h>

#include "blend_common.cuh"

namespace {

using blend::kAlphaMax;
using blend::kAlphaMin;
using blend::kThreads;
using blend::patch_mask;

constexpr int kFields = 10;
constexpr int kSlots = 16;  // kFields padded to a power of two
constexpr int kMinBlocks = 3;  // blocks per SM the registers must allow

// Pixel j of a thread, from its first pixel: a Q x Q quad.
template <int Q>
__device__ constexpr int pixel_dx(int j) {
  return j % Q;
}
template <int Q>
__device__ constexpr int pixel_dy(int j) {
  return j / Q;
}

// One round of the reduce-scatter: lanes that differ in bit 2 * HALF of
// the lane id swap halves, so each keeps HALF slots summed over both.
template <int HALF>
__device__ __forceinline__ void scatter_round(float (&v)[kSlots], int lane) {
  const bool upper = (lane & (2 * HALF)) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * HALF);
  }
}

// The sum over the warp's lanes of slot (lane >> 1) of v.
__device__ __forceinline__ float reduce_scatter(float (&v)[kSlots],
                                                int lane) {
  scatter_round<8>(v, lane);
  scatter_round<4>(v, lane);
  scatter_round<2>(v, lane);
  scatter_round<1>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

template <int Q>  // a thread's pixels: Q x Q (1 at tile 16, 2 at tile 32)
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    blend_bwd_kernel(
    const int* __restrict__ tile_range, const int* __restrict__ gid,
    const float* __restrict__ mean2d, const float* __restrict__ conic,
    const float* __restrict__ opacity, const float* __restrict__ color,
    const float* __restrict__ depth, const float* __restrict__ final_t,
    const int* __restrict__ n_contrib, const float* __restrict__ g_color,
    const float* __restrict__ g_depth, const float* __restrict__ g_alpha,
    int tiles_x, int tile, int width, int height, float* __restrict__ grad) {
  constexpr int PPT = Q * Q;
  __shared__ float2 s_xy[kThreads];
  __shared__ float4 s_conic_op[kThreads];
  __shared__ float4 s_rgbd[kThreads];
  __shared__ int s_gid[kThreads];
  __shared__ unsigned s_mask[kThreads];  // patch_mask of each duplicate
  __shared__ float s_grad[kThreads][kFields];
  __shared__ int s_max_contrib;

  const int t = blockIdx.x;
  const int ox = (t % tiles_x) * tile;
  const int oy = (t / tiles_x) * tile;
  const int start = tile_range[2 * t];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // the thread's first pixel: its quad's corner in the warp's patch
  const int x0 = ox + (warp & 1) * 8 * Q + (lane & 7) * Q;
  const int y0 = oy + (warp >> 1) * 4 * Q + (lane >> 3) * Q;
  const float px0 = (float)x0, py0 = (float)y0;  // + small ints: exact
  float T[PPT], S[PPT], gC[PPT][3], gD[PPT], gAT[PPT];
  int last[PPT];
  int my_max = 0;
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int x = x0 + pixel_dx<Q>(j), y = y0 + pixel_dy<Q>(j);
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
      s_mask[threadIdx.x] = patch_mask<Q>(s_xy[threadIdx.x],
                                          s_conic_op[threadIdx.x], ox, oy);
#pragma unroll
      for (int f = 0; f < kFields; ++f) s_grad[threadIdx.x][f] = 0.0f;
    }
    __syncthreads();

    for (int m = 0; m < count; ++m) {
      if (((s_mask[m] >> warp) & 1u) == 0u) continue;  // blends none here
      const int k_rel = hi - 1 - m - start;  // index within the tile's range
      const float2 xy = s_xy[m];
      const float4 co = s_conic_op[m];
      const float4 rgbd = s_rgbd[m];
      float acc[kSlots];
#pragma unroll
      for (int f = 0; f < kSlots; ++f) acc[f] = 0.0f;
      bool touched = false;
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        if (k_rel >= last[j]) continue;  // after the pixel's last blend
        const float dx = xy.x - (px0 + (float)pixel_dx<Q>(j));
        const float dy = xy.y - (py0 + (float)pixel_dy<Q>(j));
        const float power = __fmaf_rn(  // as in blend_common.cuh
            -0.5f, __fmaf_rn(__fmul_rn(co.x, dx), dx,
                             __fmul_rn(__fmul_rn(co.z, dy), dy)),
            -__fmul_rn(__fmul_rn(co.y, dx), dy));
        if (power > 0.0f) continue;
        const float gauss = expf(power);
        const float alpha = fminf(kAlphaMax, co.w * gauss);
        if (alpha < kAlphaMin) continue;
        const float one_m = 1.0f - alpha;
        const float f = gC[j][0] * rgbd.x + gC[j][1] * rgbd.y +
                        gC[j][2] * rgbd.z + gD[j] * rgbd.w;
        const float inv = __frcp_rn(one_m);
        const float Tk = T[j] * inv;
        const float dl_da = Tk * f - (S[j] - gAT[j]) * inv;
        const float w = alpha * Tk;
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
        const float v = reduce_scatter(acc, lane);
        const int field = lane >> 1;
        if ((lane & 1) == 0 && field < kFields)
          atomicAdd(&s_grad[m][field], v);
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
      blend_bwd_kernel<2><<<n_tiles, kThreads, 0, s>>>(
          tile_range, gid, mean2d, conic, opacity, color, depth, final_t,
          n_contrib, g_color, g_depth, g_alpha, tiles_x, tile, width, height,
          grad);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
