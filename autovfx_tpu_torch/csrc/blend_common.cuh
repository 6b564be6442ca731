// What kernel 3 (blend_fwd.cu) and kernel 4 (blend_bwd.cu) share: the
// block shape and renderCUDA's constants.
//
// Both kernels spell renderCUDA's per-(duplicate, pixel) alpha the same
// way, and must stay so, for the backward to skip exactly the
// duplicates the forward skipped:
//
//   power = -0.5f * (co.x * dx * dx + co.z * dy * dy) - co.y * dx * dy;
//   if (power > 0.0f) skip;
//   alpha = fminf(kAlphaMax, co.w * expf(power));
//   if (alpha < kAlphaMin) skip;
//
// with (dx, dy) = mean2d - pixel and co = (conic, opacity).  It is
// written out in each kernel rather than called from here: through a
// helper with reference outputs, nvcc scheduled kernel 3 ~9 % slower.
#pragma once

namespace blend {

constexpr int kThreads = 256;  // a block; tile^2 / 256 pixels per thread
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

}  // namespace blend
