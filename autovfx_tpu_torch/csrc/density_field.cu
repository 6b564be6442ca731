// SuGaR's density field and its gradient, forward and backward.
//
// Replaces no TPU kernel: in the JAX package the field is XLA's fusion
// of autovfx_tpu/sugar/density.py `compute_density` and
// `density_gradient`, and in the port it was ~1,400 elementwise, gather
// and scatter launches a regularized coarse step over (chunk, k) planes
// (autovfx_tpu_torch/sugar/density.py `_field_pairs`, which stays as the
// plain twin these kernels are held to).  A sample x has neighbours j in
// its row of the neighbour lists; with d = x - mu_j, u = A_j d,
// q = d.u and w = sigma_j exp(-q/2):
//
//   forward:  density = sum_j w,  gradient = -sum_j w u;
//
//   backward, from the cotangents g_dens (P) and g_grad (P, 3), either
//   absent (a null pointer reads as zeros), with c = g_dens - g_grad.u:
//     dL/dx       = sum_j (-c w u - w A g_grad),  dL/dmu_j its negative,
//     dL/dsigma_j = c exp(-q/2),
//     dL/da_aa    = -c w d_a^2 / 2 - w g_a d_a,
//     dL/da_ab    = -c w d_a d_b - w (g_a d_b + g_b d_a)   (a != b),
//   each pair recomputed from the inputs: nothing per pair is stored
//   between the passes.
//
// What bounds it: bytes, and the field is a gather.  The caller packs
// the splats once as an array of 12-float records (48 B: mu, sigma, the
// six entries a00 a01 a02 a11 a12 a22 of the symmetric inverse
// covariance, two floats of padding), so a neighbour is three 16-byte
// loads; at a million splats the table is 48 MB, about the card's L2.
// Sixteen lanes serve a sample, one lane a neighbour (a lane takes every
// 16th where a row is longer): the index row is read coalesced, sixteen
// gathers are in flight a sample, and the sums are shuffle reductions
// within the 16 lanes.  The backward reduces dL/dx over the row and
// writes it once, and adds each pair's ten splat gradients into a
// 12-float record per splat (zeroed by the caller) with three vector
// atomics (float4, float4, float2; Hopper adds vectors in global
// memory).  The sums run in another order than the twin's, and the
// atomics in no fixed order: results match it to float32 rounding.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 16;     // lanes a sample
constexpr int kThreads = 256;  // 16 samples a block
constexpr unsigned kFull = 0xffffffffu;

struct Splat {
  float mx, my, mz, sigma;
  float a00, a01, a02, a11, a12, a22;
};

__device__ __forceinline__ Splat load_splat(const float4* __restrict__ table,
                                            int s) {
  const float4* r = table + 3 * (int64_t)s;
  const float4 r0 = __ldg(r), r1 = __ldg(r + 1), r2 = __ldg(r + 2);
  return {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w, r2.x, r2.y};
}

// sum over the 16 lanes of a sample; every lane of the warp takes part
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads) density_fwd_kernel(
    int64_t n_points, int k, const float* __restrict__ points,
    const int* __restrict__ nbrs, const float4* __restrict__ table,
    float* __restrict__ density, float* __restrict__ gradient) {
  const int64_t p = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / kLanes;
  const int lane = threadIdx.x % kLanes;
  const bool valid = p < n_points;  // the others only join the shuffles
  float dens = 0.0f, gx = 0.0f, gy = 0.0f, gz = 0.0f;
  if (valid) {
    const float x = points[3 * p], y = points[3 * p + 1],
                z = points[3 * p + 2];
    const int* row = nbrs + p * k;
    for (int j = lane; j < k; j += kLanes) {
      const Splat s = load_splat(table, __ldg(row + j));
      const float dx = x - s.mx, dy = y - s.my, dz = z - s.mz;
      const float ux = s.a00 * dx + s.a01 * dy + s.a02 * dz;
      const float uy = s.a01 * dx + s.a11 * dy + s.a12 * dz;
      const float uz = s.a02 * dx + s.a12 * dy + s.a22 * dz;
      const float w = s.sigma * expf(-0.5f * (dx * ux + dy * uy + dz * uz));
      dens += w;
      gx += w * ux;
      gy += w * uy;
      gz += w * uz;
    }
  }
  dens = lanes_sum(dens);
  gx = lanes_sum(gx);
  gy = lanes_sum(gy);
  gz = lanes_sum(gz);
  if (valid && lane == 0) {
    density[p] = dens;
    gradient[3 * p] = -gx;
    gradient[3 * p + 1] = -gy;
    gradient[3 * p + 2] = -gz;
  }
}

__global__ void __launch_bounds__(kThreads) density_bwd_kernel(
    int64_t n_points, int k, const float* __restrict__ points,
    const int* __restrict__ nbrs, const float4* __restrict__ table,
    const float* __restrict__ g_dens, const float* __restrict__ g_grad,
    float* __restrict__ d_points, float4* __restrict__ d_table) {
  const int64_t p = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / kLanes;
  const int lane = threadIdx.x % kLanes;
  const bool valid = p < n_points;
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (valid) {
    const float x = points[3 * p], y = points[3 * p + 1],
                z = points[3 * p + 2];
    const float gd = g_dens != nullptr ? g_dens[p] : 0.0f;
    float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
    if (g_grad != nullptr) {
      g0 = g_grad[3 * p];
      g1 = g_grad[3 * p + 1];
      g2 = g_grad[3 * p + 2];
    }
    const int* row = nbrs + p * k;
    for (int j = lane; j < k; j += kLanes) {
      const int si = __ldg(row + j);
      const Splat s = load_splat(table, si);
      const float dx = x - s.mx, dy = y - s.my, dz = z - s.mz;
      const float ux = s.a00 * dx + s.a01 * dy + s.a02 * dz;
      const float uy = s.a01 * dx + s.a11 * dy + s.a12 * dz;
      const float uz = s.a02 * dx + s.a12 * dy + s.a22 * dz;
      const float e = expf(-0.5f * (dx * ux + dy * uy + dz * uz));
      const float w = s.sigma * e;
      const float c = gd - (g0 * ux + g1 * uy + g2 * uz);
      const float cw = c * w;
      // dL/dx of this pair: -c w u - w A g
      const float ex = -cw * ux - w * (s.a00 * g0 + s.a01 * g1 + s.a02 * g2);
      const float ey = -cw * uy - w * (s.a01 * g0 + s.a11 * g1 + s.a12 * g2);
      const float ez = -cw * uz - w * (s.a02 * g0 + s.a12 * g1 + s.a22 * g2);
      px += ex;
      py += ey;
      pz += ez;
      const float hcw = 0.5f * cw;
      float4* rec = d_table + 3 * (int64_t)si;
      atomicAdd(rec, make_float4(-ex, -ey, -ez, c * e));
      atomicAdd(rec + 1,
                make_float4(-hcw * dx * dx - w * g0 * dx,
                            -cw * dx * dy - w * (g0 * dy + g1 * dx),
                            -cw * dx * dz - w * (g0 * dz + g2 * dx),
                            -hcw * dy * dy - w * g1 * dy));
      atomicAdd(reinterpret_cast<float2*>(rec + 2),
                make_float2(-cw * dy * dz - w * (g1 * dz + g2 * dy),
                            -hcw * dz * dz - w * g2 * dz));
    }
  }
  px = lanes_sum(px);
  py = lanes_sum(py);
  pz = lanes_sum(pz);
  if (valid && lane == 0 && d_points != nullptr) {
    d_points[3 * p] = px;
    d_points[3 * p + 1] = py;
    d_points[3 * p + 2] = pz;
  }
}

int blocks_for(int64_t n_points) {
  return (int)((n_points * kLanes + kThreads - 1) / kThreads);
}

}  // namespace

// density (P), gradient (P, 3) of P points with k neighbours each;
// table is (N, 12) float32 and 16-byte aligned
extern "C" int density_fwd(int64_t n_points, int k, const float* points,
                           const int* nbrs, const float* table,
                           float* density, float* gradient, void* stream) {
  if (n_points > 0)
    density_fwd_kernel<<<blocks_for(n_points), kThreads, 0,
                         (cudaStream_t)stream>>>(
        n_points, k, points, nbrs, reinterpret_cast<const float4*>(table),
        density, gradient);
  return (int)cudaGetLastError();
}

// dL/dpoints (P, 3; null to skip) and dL/dtable added into d_table
// (N, 12, zeroed by the caller) from g_dens (P) and g_grad (P, 3), each
// nullable
extern "C" int density_bwd(int64_t n_points, int k, const float* points,
                           const int* nbrs, const float* table,
                           const float* g_dens, const float* g_grad,
                           float* d_points, float* d_table, void* stream) {
  if (n_points > 0)
    density_bwd_kernel<<<blocks_for(n_points), kThreads, 0,
                         (cudaStream_t)stream>>>(
        n_points, k, points, nbrs, reinterpret_cast<const float4*>(table),
        g_dens, g_grad, d_points, reinterpret_cast<float4*>(d_table));
  return (int)cudaGetLastError();
}
