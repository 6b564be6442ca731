// Backward of the per-splat preprocess, one thread per Gaussian.
//
// No TPU kernel of its own: in the JAX package this gradient is XLA's
// autodiff of autovfx_tpu/ops/projection.py `preprocess`.  Its contract
// is the public CUDA rasterizer's backward.cu (preprocessCUDA,
// computeCov2DCUDA, computeCov3DCUDA, computeColorFromSH), restated
// exactly by autograd of the port's own ops/projection.py `preprocess`,
// which is what it is held against.  It maps dL/d{mean2d, conic,
// opacity, color, depth} to dL/d{xyz, sh_dc, sh_rest, log_scales, quats,
// opacity_logit}, term by term as autograd would:
//
// - mean2d = f * p_view / z + c - 0.5 and depth = p_view.z go to xyz;
//   z is the near-cull-safe depth (a constant 1 behind the near plane);
// - the conic is the inverse of cov2D = J W Sigma W^T J^T + 0.3 I (the
//   dilation is a constant); J's tx, ty are clamped to 1.3 tan(fov/2),
//   and the clamp stops their gradient as torch.clamp does;
// - Sigma = R diag(s^2) R^T goes to the log-scales and, through the
//   normalisation of the quaternion, to the raw quaternion;
// - the SH colour (max(rgb + 0.5, 0)) goes to the SH coefficients of the
//   evaluated bands and, through the unit view direction, to xyz;
// - opacity = sigmoid(logit) goes to the logit on valid slots only (the
//   forward wrote 0 elsewhere); `tiles_touched` > 0 marks them.
//
// With an override colour the SH part is skipped: the colour gradient
// is the override's own, which the wrapper returns.
//
// What bounds it: bytes, as the forward.  A splat reads its 59
// parameters, 10 output gradients and one int, recomputes the forward's
// intermediates in registers rather than storing them, and writes 59
// gradients.  Compiled with -fmad=false (ops/_build.py FILE_FLAGS), like
// kernel 1, so the recomputed determinant rounds as the plain forward's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "preprocess_common.cuh"

namespace {

using namespace preprocess;

__host__ __device__ __forceinline__ float clampf(float v, float lo,
                                                 float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__host__ __device__ __forceinline__ void preprocess_bwd_one(
    int i, const float* __restrict__ xyz, const float* __restrict__ sh_dc,
    const float* __restrict__ sh_rest, int k_rest, int degree,
    const float* __restrict__ log_scales, const float* __restrict__ quats,
    const float* __restrict__ opacity_logit,
    const int* __restrict__ tiles_touched, bool sh_color,
    const float* __restrict__ cam, float smod,
    const float* __restrict__ g_mean2d, const float* __restrict__ g_conic,
    const float* __restrict__ g_opacity, const float* __restrict__ g_color,
    const float* __restrict__ g_depth, float* __restrict__ d_xyz,
    float* __restrict__ d_sh_dc, float* __restrict__ d_sh_rest,
    float* __restrict__ d_log_scales, float* __restrict__ d_quats,
    float* __restrict__ d_opacity_logit) {
  const float x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
  const float* R = cam + CAM_R;
  const float fx = cam[CAM_FX], fy = cam[CAM_FY];

  // ---- the forward's intermediates (kernel 1's expressions) ------------
  const float pvx = x * R[0] + y * R[1] + z * R[2] + cam[CAM_T + 0];
  const float pvy = x * R[3] + y * R[4] + z * R[5] + cam[CAM_T + 1];
  const float pvz = x * R[6] + y * R[7] + z * R[8] + cam[CAM_T + 2];
  const bool in_front = pvz > kNearZ;
  const float sz = in_front ? pvz : 1.0f;

  const float qw0 = quats[4 * i], qx0 = quats[4 * i + 1],
              qy0 = quats[4 * i + 2], qz0 = quats[4 * i + 3];
  const float qn_raw = sqrtf(qw0 * qw0 + qx0 * qx0 + qy0 * qy0 + qz0 * qz0);
  const float qn = fmaxf(qn_raw, 1e-12f);
  const float qw = qw0 / qn, qx = qx0 / qn, qy = qy0 / qn, qz = qz0 / qn;
  float r[3][3];
  r[0][0] = 1.0f - 2.0f * (qy * qy + qz * qz);
  r[0][1] = 2.0f * (qx * qy - qw * qz);
  r[0][2] = 2.0f * (qx * qz + qw * qy);
  r[1][0] = 2.0f * (qx * qy + qw * qz);
  r[1][1] = 1.0f - 2.0f * (qx * qx + qz * qz);
  r[1][2] = 2.0f * (qy * qz - qw * qx);
  r[2][0] = 2.0f * (qx * qz - qw * qy);
  r[2][1] = 2.0f * (qy * qz + qw * qx);
  r[2][2] = 1.0f - 2.0f * (qx * qx + qy * qy);
  float S[3];  // squared scales
  for (int k = 0; k < 3; ++k) {
    const float e = expf(log_scales[3 * i + k]) * smod;
    S[k] = e * e;
  }
  // Sigma, full symmetric: sig[a][b] = sum_k S_k r[a][k] r[b][k]
  float sig[3][3];
  for (int a = 0; a < 3; ++a)
    for (int b = a; b < 3; ++b) {
      sig[a][b] = S[0] * r[a][0] * r[b][0] + S[1] * r[a][1] * r[b][1] +
                  S[2] * r[a][2] * r[b][2];
      sig[b][a] = sig[a][b];
    }

  const float limx = cam[CAM_LIMX], limy = cam[CAM_LIMY];
  const float ux = pvx / sz, uy = pvy / sz;
  const float cux = clampf(ux, -limx, limx), cuy = clampf(uy, -limy, limy);
  const float tx = cux * sz, ty = cuy * sz, tz = sz;
  const float j00 = fx / tz;
  const float j02 = -(fx * tx) / (tz * tz);
  const float j11 = fy / tz;
  const float j12 = -(fy * ty) / (tz * tz);
  float m0[3], m1[3], sm0[3], sm1[3];
  for (int c = 0; c < 3; ++c) {
    m0[c] = j00 * R[c] + j02 * R[6 + c];
    m1[c] = j11 * R[3 + c] + j12 * R[6 + c];
  }
  for (int a = 0; a < 3; ++a) {
    sm0[a] = sig[a][0] * m0[0] + sig[a][1] * m0[1] + sig[a][2] * m0[2];
    sm1[a] = sig[a][0] * m1[0] + sig[a][1] * m1[1] + sig[a][2] * m1[2];
  }
  const float cov_a = m0[0] * sm0[0] + m0[1] * sm0[1] + m0[2] * sm0[2] +
                      kDilation;
  const float cov_b = m0[0] * sm1[0] + m0[1] * sm1[1] + m0[2] * sm1[2];
  const float cov_c = m1[0] * sm1[0] + m1[1] * sm1[1] + m1[2] * sm1[2] +
                      kDilation;
  const float det = cov_a * cov_c - cov_b * cov_b;
  const bool det_ok = det != 0.0f;
  const float D = det_ok ? det : 1.0f;

  // ---- conic -> cov2D ----------------------------------------------------
  const float g0 = g_conic[3 * i], g1 = g_conic[3 * i + 1],
              g2 = g_conic[3 * i + 2];
  float d_ca = g2 / D, d_cb = -g1 / D, d_cc = g0 / D;
  if (det_ok) {
    const float dD = -(g0 * cov_c - g1 * cov_b + g2 * cov_a) / (D * D);
    d_ca += dD * cov_c;
    d_cc += dD * cov_a;
    d_cb -= 2.0f * dD * cov_b;
  }

  // ---- cov2D -> M = J W and Sigma ------------------------------------------
  float dm0[3], dm1[3], dsig[3][3];
  for (int c = 0; c < 3; ++c) {
    dm0[c] = 2.0f * d_ca * sm0[c] + d_cb * sm1[c];
    dm1[c] = d_cb * sm0[c] + 2.0f * d_cc * sm1[c];
  }
  // gradient of each packed entry (xx, xy, xz, yy, yz, zz): an off-
  // diagonal entry stands for both of its symmetric places
  for (int a = 0; a < 3; ++a)
    for (int b = a; b < 3; ++b) {
      const float sym = d_ca * m0[a] * m0[b] + d_cc * m1[a] * m1[b];
      if (a == b) {
        dsig[a][a] = sym + d_cb * m0[a] * m1[a];
      } else {
        dsig[a][b] = 2.0f * sym + d_cb * (m0[a] * m1[b] + m0[b] * m1[a]);
      }
    }

  // ---- M -> J -> (tx, ty, tz) -> view position --------------------------
  const float dj00 = dm0[0] * R[0] + dm0[1] * R[1] + dm0[2] * R[2];
  const float dj02 = dm0[0] * R[6] + dm0[1] * R[7] + dm0[2] * R[8];
  const float dj11 = dm1[0] * R[3] + dm1[1] * R[4] + dm1[2] * R[5];
  const float dj12 = dm1[0] * R[6] + dm1[1] * R[7] + dm1[2] * R[8];
  const float tz2 = tz * tz, tz3 = tz2 * tz;
  const float dtx = -dj02 * fx / tz2;
  const float dty = -dj12 * fy / tz2;
  float dsz = -dj00 * fx / tz2 + dj02 * 2.0f * fx * tx / tz3 -
              dj11 * fy / tz2 + dj12 * 2.0f * fy * ty / tz3;
  dsz += dtx * cux + dty * cuy;
  const float dux = (ux >= -limx && ux <= limx) ? dtx * sz : 0.0f;
  const float duy = (uy >= -limy && uy <= limy) ? dty * sz : 0.0f;
  const float gmx = g_mean2d[2 * i], gmy = g_mean2d[2 * i + 1];
  const float dpvx = (dux + gmx * fx) / sz;
  const float dpvy = (duy + gmy * fy) / sz;
  dsz -= ((dux + gmx * fx) * pvx + (duy + gmy * fy) * pvy) / (sz * sz);
  const float dpvz = g_depth[i] + (in_front ? dsz : 0.0f);
  float dxyz[3];
  for (int c = 0; c < 3; ++c)
    dxyz[c] = dpvx * R[c] + dpvy * R[3 + c] + dpvz * R[6 + c];

  // ---- Sigma -> squared scales and rotation ------------------------------
  float dr[3][3];
  for (int k = 0; k < 3; ++k) {
    const float a = r[0][k], b = r[1][k], c = r[2][k];
    const float dS = dsig[0][0] * a * a + dsig[0][1] * a * b +
                     dsig[0][2] * a * c + dsig[1][1] * b * b +
                     dsig[1][2] * b * c + dsig[2][2] * c * c;
    dr[0][k] = S[k] * (2.0f * dsig[0][0] * a + dsig[0][1] * b +
                       dsig[0][2] * c);
    dr[1][k] = S[k] * (dsig[0][1] * a + 2.0f * dsig[1][1] * b +
                       dsig[1][2] * c);
    dr[2][k] = S[k] * (dsig[0][2] * a + dsig[1][2] * b +
                       2.0f * dsig[2][2] * c);
    d_log_scales[3 * i + k] = 2.0f * S[k] * dS;  // s = exp(l) * smod
  }
  const float dqw = 2.0f * (-qz * dr[0][1] + qy * dr[0][2] + qz * dr[1][0] -
                            qx * dr[1][2] - qy * dr[2][0] + qx * dr[2][1]);
  const float dqx = 2.0f * (qy * dr[0][1] + qz * dr[0][2] + qy * dr[1][0] -
                            2.0f * qx * dr[1][1] - qw * dr[1][2] +
                            qz * dr[2][0] + qw * dr[2][1] -
                            2.0f * qx * dr[2][2]);
  const float dqy = 2.0f * (-2.0f * qy * dr[0][0] + qx * dr[0][1] +
                            qw * dr[0][2] + qx * dr[1][0] + qz * dr[1][2] -
                            qw * dr[2][0] + qz * dr[2][1] -
                            2.0f * qy * dr[2][2]);
  const float dqz = 2.0f * (-2.0f * qz * dr[0][0] - qw * dr[0][1] +
                            qx * dr[0][2] + qw * dr[1][0] -
                            2.0f * qz * dr[1][1] + qy * dr[1][2] +
                            qx * dr[2][0] + qy * dr[2][1]);
  // through q / max(|q|, 1e-12)
  if (qn_raw >= 1e-12f) {
    const float dot = qw * dqw + qx * dqx + qy * dqy + qz * dqz;
    d_quats[4 * i] = (dqw - qw * dot) / qn;
    d_quats[4 * i + 1] = (dqx - qx * dot) / qn;
    d_quats[4 * i + 2] = (dqy - qy * dot) / qn;
    d_quats[4 * i + 3] = (dqz - qz * dot) / qn;
  } else {
    d_quats[4 * i] = dqw / qn;
    d_quats[4 * i + 1] = dqx / qn;
    d_quats[4 * i + 2] = dqy / qn;
    d_quats[4 * i + 3] = dqz / qn;
  }

  // ---- opacity -----------------------------------------------------------
  const float sg = 1.0f / (1.0f + expf(-opacity_logit[i]));
  d_opacity_logit[i] =
      tiles_touched[i] > 0 ? g_opacity[i] * (1.0f - sg) * sg : 0.0f;

  // ---- SH colour -----------------------------------------------------------
  float* rest_out = d_sh_rest + (size_t)i * k_rest * 3;
  if (!sh_color) {
    for (int c = 0; c < 3; ++c) d_sh_dc[3 * i + c] = 0.0f;
    for (int k = 0; k < k_rest * 3; ++k) rest_out[k] = 0.0f;
  } else {
    const float vx = x - cam[CAM_POS], vy = y - cam[CAM_POS + 1],
                vz = z - cam[CAM_POS + 2];
    const float vn_raw = sqrtf(vx * vx + vy * vy + vz * vz);
    const float vn = fmaxf(vn_raw, 1e-12f);
    const float dx = vx / vn, dy = vy / vn, dz = vz / vn;
    const float xx = dx * dx, yy = dy * dy, zz = dz * dz;
    const float xy = dx * dy, yz = dy * dz, xz = dx * dz;
    const int n_coef = (degree + 1) * (degree + 1);
    // band values and their (x, y, z) derivatives, coefficient 1..15
    const float basis[16] = {
        C0, -C1 * dy, C1 * dz, -C1 * dx,
        C2_0 * xy, C2_1 * yz, C2_2 * (2.0f * zz - xx - yy), C2_3 * xz,
        C2_4 * (xx - yy),
        C3_0 * dy * (3.0f * xx - yy), C3_1 * xy * dz,
        C3_2 * dy * (4.0f * zz - xx - yy),
        C3_3 * dz * (2.0f * zz - 3.0f * xx - 3.0f * yy),
        C3_4 * dx * (4.0f * zz - xx - yy), C3_5 * dz * (xx - yy),
        C3_6 * dx * (xx - 3.0f * yy)};
    const float dbx[16] = {
        0.0f, 0.0f, 0.0f, -C1,
        C2_0 * dy, 0.0f, -2.0f * C2_2 * dx, C2_3 * dz, 2.0f * C2_4 * dx,
        6.0f * C3_0 * xy, C3_1 * yz, -2.0f * C3_2 * xy, -6.0f * C3_3 * xz,
        C3_4 * (4.0f * zz - 3.0f * xx - yy), 2.0f * C3_5 * xz,
        3.0f * C3_6 * (xx - yy)};
    const float dby[16] = {
        0.0f, -C1, 0.0f, 0.0f,
        C2_0 * dx, C2_1 * dz, -2.0f * C2_2 * dy, 0.0f, -2.0f * C2_4 * dy,
        3.0f * C3_0 * (xx - yy), C3_1 * xz,
        C3_2 * (4.0f * zz - xx - 3.0f * yy), -6.0f * C3_3 * yz,
        -2.0f * C3_4 * xy, -2.0f * C3_5 * yz, -6.0f * C3_6 * xy};
    const float dbz[16] = {
        0.0f, 0.0f, C1, 0.0f,
        0.0f, C2_1 * dy, 4.0f * C2_2 * dz, C2_3 * dx, 0.0f,
        0.0f, C3_1 * xy, 8.0f * C3_2 * yz,
        C3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy), 8.0f * C3_4 * xz,
        C3_5 * (xx - yy), 0.0f};
    // The loops over the 15 bands run unrolled, so the tables above are
    // indexed by constants and stay in registers.
    const float* rest = sh_rest + (size_t)i * k_rest * 3;
    float raw[3], dr[3];
    for (int c = 0; c < 3; ++c) raw[c] = basis[0] * sh_dc[3 * i + c];
#pragma unroll
    for (int k = 1; k < 16; ++k) {
      if (k < n_coef) {
        for (int c = 0; c < 3; ++c) raw[c] += basis[k] * rest[(k - 1) * 3 + c];
      }
    }
    for (int c = 0; c < 3; ++c) {
      dr[c] = raw[c] + 0.5f >= 0.0f ? g_color[3 * i + c] : 0.0f;
      d_sh_dc[3 * i + c] = C0 * dr[c];
    }
    float ddir[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 1; k < 16; ++k) {
      if (k > k_rest) break;
      for (int c = 0; c < 3; ++c) {
        if (k < n_coef) {
          const float coef = rest[(k - 1) * 3 + c];
          rest_out[(k - 1) * 3 + c] = basis[k] * dr[c];
          ddir[0] += dr[c] * coef * dbx[k];
          ddir[1] += dr[c] * coef * dby[k];
          ddir[2] += dr[c] * coef * dbz[k];
        } else {
          rest_out[(k - 1) * 3 + c] = 0.0f;
        }
      }
    }
    for (int k = 16; k <= k_rest; ++k)  // bands above 3 are not evaluated
      for (int c = 0; c < 3; ++c) rest_out[(k - 1) * 3 + c] = 0.0f;
    // through v / max(|v|, 1e-12), v = xyz - camera center
    if (vn_raw >= 1e-12f) {
      const float dot = dx * ddir[0] + dy * ddir[1] + dz * ddir[2];
      dxyz[0] += (ddir[0] - dx * dot) / vn;
      dxyz[1] += (ddir[1] - dy * dot) / vn;
      dxyz[2] += (ddir[2] - dz * dot) / vn;
    } else {
      for (int c = 0; c < 3; ++c) dxyz[c] += ddir[c] / vn;
    }
  }
  for (int c = 0; c < 3; ++c) d_xyz[3 * i + c] = dxyz[c];
}

__global__ void __launch_bounds__(256) preprocess_bwd_kernel(
    int n, const float* __restrict__ xyz, const float* __restrict__ sh_dc,
    const float* __restrict__ sh_rest, int k_rest, int degree,
    const float* __restrict__ log_scales, const float* __restrict__ quats,
    const float* __restrict__ opacity_logit,
    const int* __restrict__ tiles_touched, bool sh_color,
    const float* __restrict__ cam, float smod,
    const float* __restrict__ g_mean2d, const float* __restrict__ g_conic,
    const float* __restrict__ g_opacity, const float* __restrict__ g_color,
    const float* __restrict__ g_depth, float* __restrict__ d_xyz,
    float* __restrict__ d_sh_dc, float* __restrict__ d_sh_rest,
    float* __restrict__ d_log_scales, float* __restrict__ d_quats,
    float* __restrict__ d_opacity_logit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  preprocess_bwd_one(i, xyz, sh_dc, sh_rest, k_rest, degree, log_scales,
                     quats, opacity_logit, tiles_touched, sh_color, cam,
                     smod, g_mean2d, g_conic, g_opacity, g_color, g_depth,
                     d_xyz, d_sh_dc, d_sh_rest, d_log_scales, d_quats,
                     d_opacity_logit);
}

}  // namespace

extern "C" int preprocess_bwd(
    int n, const float* xyz, const float* sh_dc, const float* sh_rest,
    int k_rest, int degree, const float* log_scales, const float* quats,
    const float* opacity_logit, const int* tiles_touched, int sh_color,
    const float* cam, float smod, const float* g_mean2d,
    const float* g_conic, const float* g_opacity, const float* g_color,
    const float* g_depth, float* d_xyz, float* d_sh_dc, float* d_sh_rest,
    float* d_log_scales, float* d_quats, float* d_opacity_logit,
    void* stream) {
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    preprocess_bwd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        n, xyz, sh_dc, sh_rest, k_rest, degree, log_scales, quats,
        opacity_logit, tiles_touched, sh_color != 0, cam, smod, g_mean2d,
        g_conic, g_opacity, g_color, g_depth, d_xyz, d_sh_dc, d_sh_rest,
        d_log_scales, d_quats, d_opacity_logit);
  }
  return (int)cudaGetLastError();
}
