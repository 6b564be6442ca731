// Kernel 1: per-splat screen-space preprocess, one thread per Gaussian.
//
// Replaces the TPU kernel autovfx_tpu/ops/preprocess_pallas.py `_kernel`
// (called from `preprocess_packed`).  Same arithmetic as the plain
// PyTorch version autovfx_tpu_torch/ops/projection.py `preprocess`:
// world -> view, near-z cull, quaternion + log-scale -> 3D covariance,
// EWA 2D covariance + 0.3 dilation -> conic, 3-sigma / alpha-support
// radius, truncated tile rect, tiles touched, SH degree <= 3 -> RGB.
// An optional mean2d_offset (the training path's zeros, whose gradient
// densification reads) is added to mean2d before the rect.
//
// What bounds it on this card: bytes.  A splat reads 62 floats (xyz,
// 48 SH, scales, quaternion, opacity, active) and writes 17 words, and
// does a few hundred flops with them, far below the H100's flop/byte
// balance.  The simple design reads the Gaussians tensors as they are
// (array-of-structs rows, so one thread reads a contiguous row and a
// warp reads a contiguous span) and writes every Splats2D field in f32
// and int32.  The TPU kernel's (60, M, 128) field-major scene rows and
// its bf16-pair feature packing were there for the TPU's vector layout
// and its gather rate; here the blend reads features by gid instead.
//
// This file is compiled with -fmad=false (ops/_build.py FILE_FLAGS):
// every product and sum rounds as in the unfused plain version, which
// the float32 parity tolerances assume (an FMA in det = a*c - b*b alone
// moves the conic of an elongated splat by far more than rel 1e-5).
//
// The camera arrives as one small device tensor (CAM_* in
// preprocess_common.cuh), so no per-frame host read is needed.  Float -> int rect conversion
// clamps to [0, tiles] first, then truncates, which gives the same ints
// as the reference's truncate-then-clip for every in-range value.
#include <cuda_runtime.h>
#include <stdint.h>

#include "preprocess_common.cuh"

namespace {

using namespace preprocess;

__device__ __forceinline__ int rect_int(float v, int hi) {
  return (int)fminf(fmaxf(v, 0.0f), (float)hi);
}

__global__ void __launch_bounds__(256) preprocess_kernel(
    int n, const float* __restrict__ xyz, const float* __restrict__ sh_dc,
    const float* __restrict__ sh_rest, int k_rest, int degree,
    const float* __restrict__ log_scales, const float* __restrict__ quats,
    const float* __restrict__ opacity_logit,
    const unsigned char* __restrict__ active,
    const float* __restrict__ override_color,
    const float* __restrict__ mean2d_offset, const float* __restrict__ cam,
    float smod, int tile, int tiles_x, int tiles_y,
    float* __restrict__ out_mean2d, float* __restrict__ out_conic,
    float* __restrict__ out_opacity, float* __restrict__ out_color,
    float* __restrict__ out_depth, int* __restrict__ out_radius,
    int* __restrict__ out_tile_min, int* __restrict__ out_tile_max,
    int* __restrict__ out_tiles_touched) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const float x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
  const float* R = cam + CAM_R;
  const float fx = cam[CAM_FX], fy = cam[CAM_FY];

  // view transform and projection
  const float pvx = x * R[0] + y * R[1] + z * R[2] + cam[CAM_T + 0];
  const float pvy = x * R[3] + y * R[4] + z * R[5] + cam[CAM_T + 1];
  const float pvz = x * R[6] + y * R[7] + z * R[8] + cam[CAM_T + 2];
  const bool in_front = pvz > kNearZ;
  const float safe_z = in_front ? pvz : 1.0f;
  float mx = fx * pvx / safe_z + cam[CAM_CX] - 0.5f;
  float my = fy * pvy / safe_z + cam[CAM_CY] - 0.5f;
  if (mean2d_offset != nullptr) {
    mx += mean2d_offset[2 * i];
    my += mean2d_offset[2 * i + 1];
  }

  // 3D covariance from the normalized quaternion and scales
  float qw = quats[4 * i], qx = quats[4 * i + 1], qy = quats[4 * i + 2],
        qz = quats[4 * i + 3];
  const float qn = fmaxf(sqrtf(qw * qw + qx * qx + qy * qy + qz * qz), 1e-12f);
  qw /= qn; qx /= qn; qy /= qn; qz /= qn;
  const float r00 = 1.0f - 2.0f * (qy * qy + qz * qz);
  const float r01 = 2.0f * (qx * qy - qw * qz);
  const float r02 = 2.0f * (qx * qz + qw * qy);
  const float r10 = 2.0f * (qx * qy + qw * qz);
  const float r11 = 1.0f - 2.0f * (qx * qx + qz * qz);
  const float r12 = 2.0f * (qy * qz - qw * qx);
  const float r20 = 2.0f * (qx * qz - qw * qy);
  const float r21 = 2.0f * (qy * qz + qw * qx);
  const float r22 = 1.0f - 2.0f * (qx * qx + qy * qy);
  const float e0 = expf(log_scales[3 * i]) * smod;
  const float e1 = expf(log_scales[3 * i + 1]) * smod;
  const float e2 = expf(log_scales[3 * i + 2]) * smod;
  const float s0 = e0 * e0, s1 = e1 * e1, s2 = e2 * e2;
  const float c_xx = s0 * r00 * r00 + s1 * r01 * r01 + s2 * r02 * r02;
  const float c_xy = s0 * r00 * r10 + s1 * r01 * r11 + s2 * r02 * r12;
  const float c_xz = s0 * r00 * r20 + s1 * r01 * r21 + s2 * r02 * r22;
  const float c_yy = s0 * r10 * r10 + s1 * r11 * r11 + s2 * r12 * r12;
  const float c_yz = s0 * r10 * r20 + s1 * r11 * r21 + s2 * r12 * r22;
  const float c_zz = s0 * r20 * r20 + s1 * r21 * r21 + s2 * r22 * r22;

  // EWA 2D covariance: M = J @ R, cov2d = M Σ M^T
  const float limx = cam[CAM_LIMX], limy = cam[CAM_LIMY];
  const float tx = fminf(fmaxf(pvx / safe_z, -limx), limx) * safe_z;
  const float ty = fminf(fmaxf(pvy / safe_z, -limy), limy) * safe_z;
  const float tz = safe_z;
  const float j00 = fx / tz;
  const float j02 = -(fx * tx) / (tz * tz);
  const float j11 = fy / tz;
  const float j12 = -(fy * ty) / (tz * tz);
  const float a0 = j00 * R[0] + j02 * R[6];
  const float a1 = j00 * R[1] + j02 * R[7];
  const float a2 = j00 * R[2] + j02 * R[8];
  const float b0 = j11 * R[3] + j12 * R[6];
  const float b1 = j11 * R[4] + j12 * R[7];
  const float b2 = j11 * R[5] + j12 * R[8];
  const float sa0 = c_xx * a0 + c_xy * a1 + c_xz * a2;
  const float sa1 = c_xy * a0 + c_yy * a1 + c_yz * a2;
  const float sa2 = c_xz * a0 + c_yz * a1 + c_zz * a2;
  const float sb0 = c_xx * b0 + c_xy * b1 + c_xz * b2;
  const float sb1 = c_xy * b0 + c_yy * b1 + c_yz * b2;
  const float sb2 = c_xz * b0 + c_yz * b1 + c_zz * b2;
  const float cov_a = a0 * sa0 + a1 * sa1 + a2 * sa2 + kDilation;
  const float cov_b = a0 * sb0 + a1 * sb1 + a2 * sb2;
  const float cov_c = b0 * sb0 + b1 * sb1 + b2 * sb2 + kDilation;
  const float det = cov_a * cov_c - cov_b * cov_b;
  const bool det_ok = det != 0.0f;
  const float safe_det = det_ok ? det : 1.0f;

  // opacity, support radius and tile rect
  const bool is_active = active[i] != 0;
  const float op =
      (1.0f / (1.0f + expf(-opacity_logit[i]))) * (is_active ? 1.0f : 0.0f);
  const float mid = 0.5f * (cov_a + cov_c);
  const float lambda1 = mid + sqrtf(fmaxf(mid * mid - det, 0.1f));
  const float nsigma = sqrtf(2.0f * logf(fmaxf(op * 255.0f, 1.000001f)));
  const float radius_f = ceilf(fminf(nsigma, 3.0f) * sqrtf(lambda1));
  const float rx = ceilf(fminf(nsigma * sqrtf(cov_a) + 1.0f, radius_f));
  const float ry = ceilf(fminf(nsigma * sqrtf(cov_c) + 1.0f, radius_f));
  const float tile_f = (float)tile;
  const int rmin_x = rect_int((mx - rx) / tile_f, tiles_x);
  const int rmin_y = rect_int((my - ry) / tile_f, tiles_y);
  const int rmax_x = rect_int((mx + rx + tile_f - 1.0f) / tile_f, tiles_x);
  const int rmax_y = rect_int((my + ry + tile_f - 1.0f) / tile_f, tiles_y);
  const int area = (rmax_x - rmin_x) * (rmax_y - rmin_y);
  const bool valid = in_front && det_ok && area > 0 && is_active;

  // color: the given override, or SH toward the camera
  float rgb[3];
  if (override_color != nullptr) {
    for (int c = 0; c < 3; ++c) rgb[c] = override_color[3 * i + c];
  } else {
    float dx = x - cam[CAM_POS], dy = y - cam[CAM_POS + 1],
          dz = z - cam[CAM_POS + 2];
    const float dn = fmaxf(sqrtf(dx * dx + dy * dy + dz * dz), 1e-12f);
    dx /= dn; dy /= dn; dz /= dn;
    const float xx = dx * dx, yy = dy * dy, zz = dz * dz;
    const float xy = dx * dy, yz = dy * dz, xz = dx * dz;
    const float* rest = sh_rest + (size_t)i * k_rest * 3;
    for (int c = 0; c < 3; ++c) {
      auto coef = [&](int k) { return rest[(k - 1) * 3 + c]; };
      float r = C0 * sh_dc[3 * i + c];
      if (degree >= 1) {
        r = r - C1 * dy * coef(1) + C1 * dz * coef(2) - C1 * dx * coef(3);
        if (degree >= 2) {
          r = r + C2_0 * xy * coef(4) + C2_1 * yz * coef(5) +
              C2_2 * (2.0f * zz - xx - yy) * coef(6) + C2_3 * xz * coef(7) +
              C2_4 * (xx - yy) * coef(8);
          if (degree >= 3) {
            r = r + C3_0 * dy * (3.0f * xx - yy) * coef(9) +
                C3_1 * xy * dz * coef(10) +
                C3_2 * dy * (4.0f * zz - xx - yy) * coef(11) +
                C3_3 * dz * (2.0f * zz - 3.0f * xx - 3.0f * yy) * coef(12) +
                C3_4 * dx * (4.0f * zz - xx - yy) * coef(13) +
                C3_5 * dz * (xx - yy) * coef(14) +
                C3_6 * dx * (xx - 3.0f * yy) * coef(15);
          }
        }
      }
      rgb[c] = fmaxf(r + 0.5f, 0.0f);
    }
  }

  out_mean2d[2 * i] = mx;
  out_mean2d[2 * i + 1] = my;
  out_conic[3 * i] = cov_c / safe_det;
  out_conic[3 * i + 1] = -cov_b / safe_det;
  out_conic[3 * i + 2] = cov_a / safe_det;
  out_opacity[i] = valid ? op : 0.0f;
  for (int c = 0; c < 3; ++c) out_color[3 * i + c] = rgb[c];
  out_depth[i] = pvz;
  out_radius[i] = valid ? (int)radius_f : 0;
  out_tile_min[2 * i] = rmin_x;
  out_tile_min[2 * i + 1] = rmin_y;
  out_tile_max[2 * i] = rmax_x;
  out_tile_max[2 * i + 1] = rmax_y;
  out_tiles_touched[i] = valid ? area : 0;
}

}  // namespace

extern "C" int preprocess_fwd(
    int n, const float* xyz, const float* sh_dc, const float* sh_rest,
    int k_rest, int degree, const float* log_scales, const float* quats,
    const float* opacity_logit, const unsigned char* active,
    const float* override_color, const float* mean2d_offset,
    const float* cam, float smod, int tile, int tiles_x, int tiles_y,
    float* mean2d, float* conic, float* opacity, float* color, float* depth, int* radius, int* tile_min, int* tile_max,
    int* tiles_touched, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    preprocess_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        n, xyz, sh_dc, sh_rest, k_rest, degree, log_scales, quats,
        opacity_logit, active, override_color, mean2d_offset, cam, smod,
        tile, tiles_x, tiles_y, mean2d, conic, opacity, color, depth, radius,
        tile_min, tile_max, tiles_touched);
  }
  return (int)cudaGetLastError();
}

// Message for a code returned by any entry of this library.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
