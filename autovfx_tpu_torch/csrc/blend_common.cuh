// What kernel 3 (blend_fwd.cu) and kernel 4 (blend_bwd.cu) share: the
// block shape, renderCUDA's constants, the warp patches and the proof
// that a duplicate blends no pixel of a patch (`patch_mask`).
//
// Both kernels compute renderCUDA's per-(duplicate, pixel) alpha with
// the same roundings, and must stay so, for the backward to skip
// exactly the duplicates the forward skipped:
//
//   power = -0.5f * (co.x * dx * dx + co.z * dy * dy) - co.y * dx * dy;
//   if (power > 0.0f) skip;
//   alpha = fminf(kAlphaMax, co.w * expf(power));
//   if (alpha < kAlphaMin) skip;
//
// with (dx, dy) = mean2d - pixel and co = (conic, opacity).  Both
// kernels spell the power with intrinsics, which nvcc neither contracts
// nor reorders:
//
//   __fmaf_rn(-0.5f, __fmaf_rn(__fmul_rn(co.x, dx), dx,
//                              __fmul_rn(__fmul_rn(co.z, dy), dy)),
//             -__fmul_rn(__fmul_rn(co.y, dx), dy))
//
// the contraction nvcc made of the plain spelling above while the
// kernels used it.  Left to nvcc, the rounding follows the loop around it: where
// kernel 3's pixels share products of a common dx or dy, nvcc fused
// another multiply, and the images differed in the last bits, and so
// did which pairs blend.
// Each kernel writes the alpha out rather than calling it from here:
// through a per-pair helper with reference outputs, nvcc scheduled
// kernel 3 ~9 % slower.  `patch_mask` runs once per staged duplicate.
//
// Both kernels give a block's 8 warps the same compact patches: at tile
// 16Q, warp w owns the 8Q x 4Q pixels at (w & 1) * 8Q, (w >> 1) * 4Q of
// the tile (2 patches across, 4 down), and lane l the Q x Q quad at
// (l & 7) * Q, (l >> 3) * Q of the patch; Q is 1 at tile 16, 2 at 32.
#pragma once

#include <cuda_runtime.h>

namespace blend {

constexpr int kThreads = 256;  // a block; tile^2 / 256 pixels per thread
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

// Bit w set for each warp patch w of the tile at (ox, oy) in which the
// duplicate (xy, conic and opacity co) may blend a pixel; a clear bit is
// a proof that it blends none there.  A blended pixel has op * exp(p) >=
// 1/255 for the float32 power p the kernels compute, and p differs from
// the exact -q/2 (q = a dx^2 + 2 b dx dy + c dy^2) by at most ~7 float32
// ulps of the terms' magnitudes, which is at most 0.5 G q with G = (1 +
// rho) / (1 - rho), rho = |b| / sqrt(ac).  With a 1e-5 margin for each
// (~25 times those roundings, and exp's and the product's), a blended
// pixel has q <= r2 = 2 (ln(255 op) + 1e-5) / (1 - 1e-5 G), and so lies
// in the bounding box of that ellipse, here computed in double.  Where
// an input is not finite or the bound does not hold, every bit is set.
template <int Q>
__device__ unsigned patch_mask(float2 xy, float4 co, int ox, int oy) {
  static_assert(kThreads / 32 == 8, "8 warp patches per tile");
  constexpr unsigned kAll = 0xffu;
  if (!(isfinite(xy.x) && isfinite(xy.y) && isfinite(co.x) &&
        isfinite(co.y) && isfinite(co.z) && isfinite(co.w)))
    return kAll;
  const double a = co.x, b = co.y, c = co.z, op = co.w;
  const double det = a * c - b * b;
  if (!(a > 0.0 && c > 0.0 && det > 0.0)) return kAll;
  const double rho = fabs(b) / sqrt(a * c);
  const double slack = 1e-5 * (1.0 + rho) / (1.0 - rho);
  if (!(slack < 0.5)) return kAll;
  if (!(255.0 * op > 0.0)) return 0u;  // op <= 0: alpha is never >= 1/255
  const double r2 = 2.0 * (log(255.0 * op) + 1e-5) / (1.0 - slack);
  if (r2 < 0.0) return 0u;
  const double hx = sqrt(r2 * c / det), hy = sqrt(r2 * a / det);
  unsigned mask = 0u;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const double x0 = ox + (w & 1) * 8 * Q, y0 = oy + (w >> 1) * 4 * Q;
    if (xy.x + hx >= x0 && xy.x - hx <= x0 + (8 * Q - 1) &&
        xy.y + hy >= y0 && xy.y - hy <= y0 + (4 * Q - 1))
      mask |= 1u << w;
  }
  return mask;
}

}  // namespace blend
