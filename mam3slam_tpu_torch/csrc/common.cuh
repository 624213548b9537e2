// Device helpers of the one-block solvers, csrc/pose.cu and csrc/sim3.cu:
// unit quaternions (w, x, y, z) as geometry/lie.py writes them, the
// KannalaBrandt8 projection and its derivative, the warp's fixed-order
// reduce-scatter of 32 sums, and an LDL^T solve of a small SPD system.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kPinhole = 0;  // cameras.PINHOLE: no distortion (ideal pixels)
constexpr int kKB8 = 1;      // cameras.KANNALA_BRANDT8

__device__ __forceinline__ void quat_to_matrix(const float* q, float* R) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = 1 - 2 * (y * y + z * z);
  R[1] = 2 * (x * y - w * z);
  R[2] = 2 * (x * z + w * y);
  R[3] = 2 * (x * y + w * z);
  R[4] = 1 - 2 * (x * x + z * z);
  R[5] = 2 * (y * z - w * x);
  R[6] = 2 * (x * z - w * y);
  R[7] = 2 * (y * z + w * x);
  R[8] = 1 - 2 * (x * x + y * y);
}

__device__ __forceinline__ void quat_mul(const float* a, const float* b,
                                         float* o) {
  o[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  o[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  o[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  o[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

__device__ __forceinline__ void quat_normalize(float* q) {
  const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] +
                        q[3] * q[3]);
  const float s = 1.f / fmaxf(n, 1e-8f);
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] *= s;
}

// v + 2 (w (u x v) + u x (u x v)), u = q.xyz
__device__ __forceinline__ void quat_rotate(const float* q, const float* v,
                                            float* o) {
  const float ux = q[1], uy = q[2], uz = q[3];
  const float cx = uy * v[2] - uz * v[1];
  const float cy = uz * v[0] - ux * v[2];
  const float cz = ux * v[1] - uy * v[0];
  o[0] = v[0] + 2.f * (q[0] * cx + (uy * cz - uz * cy));
  o[1] = v[1] + 2.f * (q[0] * cy + (uz * cx - ux * cz));
  o[2] = v[2] + 2.f * (q[0] * cz + (ux * cy - uy * cx));
}

// The KB8 pixel `px` of the camera-frame point (xc, yc, zc) and its
// derivative p = d px / d X; cam = [fx, fy, cx, cy, k1..k4]
// (geometry/cameras.py _project_kb8 and _project_jac_kb8, written in the
// same order): r = sqrt(max(x^2 + y^2, 1e-18)), theta = atan2(r, z),
// d = theta (1 + k1 t2 + .. + k4 t2^4), s = d / r, pixel = f s (x, y) + c.
__device__ __forceinline__ void kb8_project_jac(const float* cam, float xc,
                                                float yc, float zc,
                                                float (&px)[2],
                                                float (&p)[2][3]) {
  const float k1 = cam[4], k2 = cam[5], k3 = cam[6], k4 = cam[7];
  const float r2 = fmaxf(xc * xc + yc * yc, 1e-18f);
  const float r = sqrtf(r2);
  const float th = atan2f(r, zc);
  const float t2 = th * th;
  const float d = th * (1.f + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))));
  const float dd =
      1.f + t2 * (3.f * k1 + t2 * (5.f * k2 + t2 * (7.f * k3 +
                                                     9.f * k4 * t2)));
  const float rho2r = (r2 + zc * zc) * r;
  const float dth_dx = xc * zc / rho2r;
  const float dth_dy = yc * zc / rho2r;
  const float dth_dz = -r / (r2 + zc * zc);
  const float s = d / r;
  const float ds_dx = (dd * dth_dx * r - d * (xc / r)) / r2;
  const float ds_dy = (dd * dth_dy * r - d * (yc / r)) / r2;
  const float ds_dz = dd * dth_dz / r;
  const float fx = cam[0], fy = cam[1];
  px[0] = fx * s * xc + cam[2];
  px[1] = fy * s * yc + cam[3];
  p[0][0] = fx * (s + xc * ds_dx);
  p[0][1] = fx * xc * ds_dy;
  p[0][2] = fx * xc * ds_dz;
  p[1][0] = fy * yc * ds_dx;
  p[1][1] = fy * (s + yc * ds_dy);
  p[1][2] = fy * yc * ds_dz;
}

// One recursive-halving step over the first 2h slots: the lane keeps the
// upper or lower h (by bit h of its lane id) in a[0..h), adding its xor
// partner's copy of them.
template <int h>
__device__ __forceinline__ void halve(float (&a)[32], int lane) {
  const bool up = lane & h;
#pragma unroll
  for (int k = 0; k < h; ++k) {
    const float send = up ? a[k] : a[k + h];
    const float keep = up ? a[k + h] : a[k];
    a[k] = keep + __shfl_xor_sync(0xffffffffu, send, h);
  }
}

// Warp total of each of the 32 slots: lane l returns slot l's total.
__device__ __forceinline__ float warp_reduce_scatter(float (&a)[32],
                                                     int lane) {
  halve<16>(a, lane);
  halve<8>(a, lane);
  halve<4>(a, lane);
  halve<2>(a, lane);
  halve<1>(a, lane);
  return a[0];
}

// Solve H x = rhs for SPD N x N H (full, row-major) by LDL^T: the
// Cholesky factorisation without its square roots (D_j = L_jj^2, floored
// at 1e-20 as L_jj^2 is), and one reciprocal per column instead of a
// division per entry.
template <int N>
__device__ __forceinline__ void ldlt_solve(const float* H, const float* rhs,
                                           float* x) {
  float L[N * N], D[N], inv_d[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float d = H[(N + 1) * j];
#pragma unroll
    for (int k = 0; k < j; ++k) d -= L[N * j + k] * L[N * j + k] * D[k];
    D[j] = fmaxf(d, 1e-20f);
    inv_d[j] = 1.f / D[j];
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      float s = H[N * i + j];
#pragma unroll
      for (int k = 0; k < j; ++k) s -= L[N * i + k] * L[N * j + k] * D[k];
      L[N * i + j] = s * inv_d[j];
    }
  }
  float y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = rhs[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[N * i + k] * y[k];
    y[i] = s;
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float s = y[i] * inv_d[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) s -= L[N * k + i] * x[k];
    x[i] = s;
  }
}

}  // namespace
