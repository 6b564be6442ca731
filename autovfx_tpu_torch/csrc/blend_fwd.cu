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
// blended (duplicate, pixel) pair, and the gid-indexed feature reads
// (10 floats per duplicate, scattered over the per-Gaussian arrays).
// One block of 256 threads per tile stages batches of 256 duplicates in
// shared memory, each thread loading one duplicate's features by its
// gid, so the TPU path's (16|8, K) per-duplicate feature gather
// disappears.  What the design does about the work per pair, which
// holds the issue slots (a block alone takes ~1/3 of the kernel's time,
// so the tiles' uneven work does not):
// - each warp owns a compact patch of the tile and each lane a Q x Q
//   quad of it, kernel 4's map (blend_common.cuh), so a small splat
//   meets few warps;
// - each staged duplicate gets its `patch_mask`, and a warp walks only
//   the duplicates whose bit it holds (a ballot over 32 masks at a
//   time): a clear bit proves that the duplicate blends no pixel of the
//   patch, so every pixel sees the same blended duplicates in the same
//   order, and the images are bit for bit those of a walk over all;
// - a thread's pixels take each duplicate without a branch, so their
//   four chains overlap and share the products of a common dx or dy; the
//   power is spelled with intrinsics, as in kernel 4 (blend_common.cuh),
//   so that the sharing cannot change its rounding;
// - a warp whose pixels are all frozen does no more pair work, and the
//   block stops when every pixel is frozen;
// - registers are capped so that 3 blocks fit on an SM (uncapped, 88
//   make it 2; at 4, 64 spill; both ran no faster).
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
using blend::patch_mask;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMinBlocks = 3;  // blocks per SM the registers must allow

// a thread's pixels: Q x Q (1 at tile 16, 2 at tile 32)
template <int Q, bool TRAIN>
__global__ void __launch_bounds__(kThreads, kMinBlocks) blend_kernel(
    const int* __restrict__ tile_range, const int* __restrict__ gid,
    const float* __restrict__ mean2d, const float* __restrict__ conic,
    const float* __restrict__ opacity, const float* __restrict__ color,
    const float* __restrict__ depth, int tiles_x, int tile, int width,
    int height, float* __restrict__ out_color, float* __restrict__ out_depth,
    float* __restrict__ out_alpha, float* __restrict__ out_final_t,
    int* __restrict__ out_n_contrib) {
  constexpr int PPT = Q * Q;
  __shared__ float2 s_xy[kThreads];
  __shared__ float4 s_conic_op[kThreads];
  __shared__ float4 s_rgbd[kThreads];
  __shared__ unsigned s_mask[kThreads];  // patch_mask of each duplicate

  const int t = blockIdx.x;
  const int ox = (t % tiles_x) * tile;
  const int oy = (t / tiles_x) * tile;
  const int start = tile_range[2 * t];
  const int end = tile_range[2 * t + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // the thread's first pixel: its quad's corner in the warp's patch
  const int x0 = ox + (warp & 1) * 8 * Q + (lane & 7) * Q;
  const int y0 = oy + (warp >> 1) * 4 * Q + (lane >> 3) * Q;
  const float px0 = (float)x0, py0 = (float)y0;  // + small ints: exact
  float T[PPT], C[PPT][3], D[PPT];
  int last[PPT];
  bool done[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int x = x0 + j % Q, y = y0 + j / Q;
    done[j] = !(x < width && y < height);
    T[j] = 1.0f;
    C[j][0] = C[j][1] = C[j][2] = 0.0f;
    D[j] = 0.0f;
    last[j] = 0;
  }

  for (int base = start; base < end; base += kThreads) {
    bool mine_done = true;
#pragma unroll
    for (int j = 0; j < PPT; ++j) mine_done = mine_done && done[j];
    // also the barrier that keeps last batch's readers ahead of the stores
    if (__syncthreads_count(mine_done) == kThreads) break;

    const int count = min(kThreads, end - base);
    if (threadIdx.x < count) {
      const int g = gid[base + threadIdx.x];
      const float2 xy = make_float2(mean2d[2 * g], mean2d[2 * g + 1]);
      const float4 co = make_float4(conic[3 * g], conic[3 * g + 1],
                                    conic[3 * g + 2], opacity[g]);
      s_xy[threadIdx.x] = xy;
      s_conic_op[threadIdx.x] = co;
      s_rgbd[threadIdx.x] = make_float4(color[3 * g], color[3 * g + 1],
                                        color[3 * g + 2], depth[g]);
      s_mask[threadIdx.x] = patch_mask<Q>(xy, co, ox, oy);
    }
    __syncthreads();
    if (__all_sync(kFull, mine_done)) continue;  // the warp's pixels froze

    for (int c = 0; c < count; c += 32) {
      const int mc = c + lane;
      const bool hit = mc < count && ((s_mask[mc] >> warp) & 1u) != 0u;
      unsigned hits = __ballot_sync(kFull, hit);
      while (hits != 0u) {  // the warp's duplicates, in order
        const int m = c + __ffs(hits) - 1;
        hits &= hits - 1u;
        const float2 xy = s_xy[m];
        const float4 co = s_conic_op[m];
        const float4 rgbd = s_rgbd[m];
#pragma unroll
        for (int j = 0; j < PPT; ++j) {  // no branch: the pixels overlap
          const float dx = xy.x - (px0 + (float)(j % Q));
          const float dy = xy.y - (py0 + (float)(j / Q));
          const float power = __fmaf_rn(  // as in blend_common.cuh
              -0.5f, __fmaf_rn(__fmul_rn(co.x, dx), dx,
                               __fmul_rn(__fmul_rn(co.z, dy), dy)),
              -__fmul_rn(__fmul_rn(co.y, dx), dy));
          const float alpha = fminf(kAlphaMax, co.w * expf(power));
          const float test_T = T[j] * (1.0f - alpha);
          const bool blends =
              !done[j] && !(power > 0.0f) && !(alpha < kAlphaMin);
          const bool freezes = blends && test_T < kTEps;
          done[j] = done[j] || freezes;
          if (!blends || freezes) continue;
          const float w = alpha * T[j];
          C[j][0] += rgbd.x * w;
          C[j][1] += rgbd.y * w;
          C[j][2] += rgbd.z * w;
          D[j] += rgbd.w * w;
          T[j] = test_T;
          if (TRAIN) last[j] = base + m - start + 1;
        }
      }
      bool frozen = true;
#pragma unroll
      for (int j = 0; j < PPT; ++j) frozen = frozen && done[j];
      if (__all_sync(kFull, frozen)) break;
    }
  }

#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int x = x0 + j % Q, y = y0 + j / Q;
    if (!(x < width && y < height)) continue;
    const int pix = y * width + x;
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
      blend_kernel<2, TRAIN><<<n_tiles, kThreads, 0, s>>>(
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
