// Sim3 kernel: OptimizeSim3's whole Gauss-Newton refinement in one
// launch, one block per problem.
//
// Replaces no Pallas kernel: the reference refines the Sim3 in XLA
// (mam3slam_tpu/solvers/sim3.py: optimize_sim3, forward-mode jacobians
// under jit).  Plain PyTorch version and semantics:
// mam3slam_tpu_torch/ops/cuda_sim3.py: optimize_sim3_plain, which builds
// the [4N, 7] jacobian with torch.func.jacfwd in each of its 20
// iterations: ~76k ATen ops, ~19k of them kernel launches, and ~0.5 s of
// host time a call.  The camera kinds are template arguments (camera 1
// and camera 2 may differ when two agents' maps merge): one kernel per
// pair of kinds, chosen at launch.
//
// The problem: S12 = (q, t, s) takes camera-2 points into camera 1.  Pair
// i holds pc1 (camera 1), pc2 (camera 2), their pixels and level sigmas:
//   r1 = (pi1(s R pc2 + t) - uv1) / sigma1,
//   r2 = (pi2(R^T (pc1 - t) / s) - uv2) / sigma2,
// each direction Huber-weighted on its chi2 = r.r at delta^2 = huber2,
// valid pairs only; H = J^T W J + 1e-6 I, g = J^T W r, dx = -H^-1 g in
// the tangent [rho, phi, sigma]: t += rho, q = normalize(exp(phi) q)
// (lie.so3_exp_quat), log s += sigma.  After `iters` iterations: inlier =
// valid & chi2_1 < 9.21 & chi2_2 < 9.21.  The jacobian rows are analytic;
// with P a row of d pi / d X / sigma:
//   direction 1, X = a + t, a = s R pc2:           [P, a x P, P . a];
//   direction 2, X = R^T v / s, v = pc1 - t, w = R P / s:
//                                                  [-w, w x v, -P . X].
//
// What bounds it on the H100: iters x n_valid x 2 directions of ~300
// flops (projection, its derivative, the 2 x 7 rows, 28 H and 7 g
// entries), plus a residual pass for the inliers: ~6 MFLOP at 500 valid
// pairs, 0.1 us at the f32 peak; 48 bytes a valid pair and 2 a pair
// (valid flag in, inlier flag out).  The pairs are the arena's map points
// (N = max_mp, 24576 at the defaults), of which the matched few hundred
// are valid.  The real floor is the chain of iters dependent 7x7 solves,
// each waiting for the pass and block reduction before it.
//
// Design: one block of 256 threads.
//   0. Compaction: warp w owns a contiguous run of the N flags; it counts
//      its valid pairs by ballots, the 8 counts give each warp its offset,
//      and a second pass writes the valid indices in index order to the
//      workspace `order` (so every later sum has one order); every
//      inlier flag is cleared.
//   1. Each thread loads the valid pairs at positions tid + k x 256,
//      k < 4, into registers once (1024 pairs, more than the features a
//      keyframe holds); later positions are strided over and re-read
//      through `order` in each pass.
//   2. Per iteration every thread linearises its pairs' two directions at
//      the pose in shared memory and accumulates the 28 upper-triangle H
//      entries and 7 g entries (slots 0-27, g0-g3 in 28-31, g4-g6 in
//      three more); each warp reduces the 32 slots by recursive halving
//      over xor shuffles and the three by an xor butterfly; warp 0 sums
//      the warps' columns in warp order, every lane solves H dx = -g by
//      an unrolled LDL^T and retracts, all in registers; lane 0 writes the
//      next pose, its rotation matrix and scale to shared memory.
//   3. A last residual pass writes each valid pair's inlier flag; the
//      count is summed over warps in order.
// No atomics anywhere: two launches on one input give the same bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRegPairs = 4;   // pairs a thread keeps in registers
constexpr int kExtra = 3;      // g4-g6, past the 32 slots
constexpr float kChi2Inlier = 9.21f;

struct Pair {
  float pc1[3], pc2[3], uv1[2], uv2[2], sig1, sig2;
};

// The pose a pass linearises at: q, its rotation matrix R (row-major), t,
// s and 1 / s.
struct State {
  float q[4], R[9], t[3], s, inv_s;
};

__device__ __forceinline__ void load_pair(int i, const float* pc1,
                                          const float* pc2, const float* uv1,
                                          const float* uv2,
                                          const float* sigma2_1,
                                          const float* sigma2_2, Pair& p) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    p.pc1[c] = pc1[3 * i + c];
    p.pc2[c] = pc2[3 * i + c];
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    p.uv1[c] = uv1[2 * i + c];
    p.uv2[c] = uv2[2 * i + c];
  }
  p.sig1 = sqrtf(sigma2_1[i]);
  p.sig2 = sqrtf(sigma2_2[i]);
}

// cameras.project_ideal and its derivative P = d px / d X.  The pinhole
// divides by z held off 0 (|z| >= 1e-6; there the pixel does not depend
// on z); KB8 projects in the full model.
template <int KIND>
__device__ __forceinline__ void project_jac(const float* cam, const float* X,
                                            float (&px)[2],
                                            float (&P)[2][3]) {
  if (KIND == kPinhole) {
    const bool held = fabsf(X[2]) < 1e-6f;
    const float z = held ? 1e-6f : X[2];
    const float iz = 1.f / z;
    px[0] = cam[0] * X[0] / z + cam[2];
    px[1] = cam[1] * X[1] / z + cam[3];
    const float a = cam[0] * iz, b = cam[1] * iz;
    P[0][0] = a;
    P[0][1] = 0.f;
    P[0][2] = held ? 0.f : -a * X[0] * iz;
    P[1][0] = 0.f;
    P[1][1] = b;
    P[1][2] = held ? 0.f : -b * X[1] * iz;
  } else {
    kb8_project_jac(cam, X[0], X[1], X[2], px, P);
  }
}

__device__ __forceinline__ float huber_weight(float chi2, float huber2) {
  return chi2 <= huber2 ? 1.f : sqrtf(huber2 / fmaxf(chi2, 1e-12f));
}

// Adds w J^T J (upper triangle) and w J^T r of one direction's two rows.
__device__ __forceinline__ void accumulate(const float (&J)[2][7],
                                           const float (&r)[2], float w,
                                           float (&acc)[32],
                                           float (&extra)[kExtra]) {
  int k = 0;
#pragma unroll
  for (int a = 0; a < 7; ++a) {
    const float w0 = w * J[0][a], w1 = w * J[1][a];
#pragma unroll
    for (int b = a; b < 7; ++b, ++k) acc[k] += w0 * J[0][b] + w1 * J[1][b];
    const float ga = w0 * r[0] + w1 * r[1];
    if (a < 4)
      acc[28 + a] += ga;
    else
      extra[a - 4] += ga;
  }
}

__device__ __forceinline__ void cross(const float* a, const float* b,
                                      float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// One pair at pose x: both directions' chi2, and with `linearise` their
// Huber-weighted H and g added to the accumulators.
template <int K1, int K2>
__device__ __forceinline__ void pair_pass(const State& x, const float* cam1,
                                          const float* cam2, const Pair& p,
                                          float huber2, bool linearise,
                                          float (&acc)[32],
                                          float (&extra)[kExtra],
                                          float& chi1, float& chi2) {
  float px[2], P[2][3], r[2], J[2][7];
  // direction 1: pc2 into camera 1, X = s R pc2 + t
  float a[3], X[3];
  quat_rotate(x.q, p.pc2, a);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a[c] = x.s * a[c];
    X[c] = a[c] + x.t[c];
  }
  project_jac<K1>(cam1, X, px, P);
  r[0] = (px[0] - p.uv1[0]) / p.sig1;
  r[1] = (px[1] - p.uv1[1]) / p.sig1;
  chi1 = r[0] * r[0] + r[1] * r[1];
  if (linearise) {
    const float is = 1.f / p.sig1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float row[3] = {P[i][0] * is, P[i][1] * is, P[i][2] * is};
      J[i][0] = row[0];
      J[i][1] = row[1];
      J[i][2] = row[2];
      cross(a, row, &J[i][3]);
      J[i][6] = row[0] * a[0] + row[1] * a[1] + row[2] * a[2];
    }
    accumulate(J, r, huber_weight(chi1, huber2), acc, extra);
  }
  // direction 2: pc1 into camera 2, X = R^T (pc1 - t) / s
  const float qc[4] = {x.q[0], -x.q[1], -x.q[2], -x.q[3]};
  float v[3], b[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = p.pc1[c] - x.t[c];
  quat_rotate(qc, v, b);
#pragma unroll
  for (int c = 0; c < 3; ++c) X[c] = x.inv_s * b[c];
  project_jac<K2>(cam2, X, px, P);
  r[0] = (px[0] - p.uv2[0]) / p.sig2;
  r[1] = (px[1] - p.uv2[1]) / p.sig2;
  chi2 = r[0] * r[0] + r[1] * r[1];
  if (linearise) {
    const float is = 1.f / p.sig2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float row[3] = {P[i][0] * is, P[i][1] * is, P[i][2] * is};
      float w[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        w[c] = (x.R[3 * c] * row[0] + x.R[3 * c + 1] * row[1] +
                x.R[3 * c + 2] * row[2]) * x.inv_s;
      J[i][0] = -w[0];
      J[i][1] = -w[1];
      J[i][2] = -w[2];
      cross(w, v, &J[i][3]);
      J[i][6] = -(row[0] * X[0] + row[1] * X[1] + row[2] * X[2]);
    }
    accumulate(J, r, huber_weight(chi2, huber2), acc, extra);
  }
}

template <int K1, int K2>
__global__ void __launch_bounds__(kThreads)
sim3_kernel(const float* __restrict__ q0, const float* __restrict__ t0,
            const float* __restrict__ s0, const float* __restrict__ cam1_g,
            const float* __restrict__ cam2_g, const float* __restrict__ pc1,
            const float* __restrict__ pc2, const float* __restrict__ uv1,
            const float* __restrict__ uv2,
            const float* __restrict__ sigma2_1,
            const float* __restrict__ sigma2_2,
            const uint8_t* __restrict__ valid, int N, int iters,
            float huber2, int* __restrict__ order, float* __restrict__ x_out,
            uint8_t* __restrict__ inlier, long long* __restrict__ n_inliers) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  __shared__ float s_part[kWarps][32 + kExtra];
  __shared__ State s_x;
  __shared__ int s_count[kWarps];

  float cam1[8], cam2[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    cam1[k] = cam1_g[k];
    cam2[k] = cam2_g[k];
  }

  // 0. the valid pairs' indices in index order; every inlier flag cleared
  const int run = (N + kWarps - 1) / kWarps;
  const int lo = min(warp * run, N), hi = min(lo + run, N);
  int cnt = 0;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const bool v = i < hi && valid[i];
    if (i < hi) inlier[i] = 0;
    cnt += __popc(__ballot_sync(0xffffffffu, v));
  }
  if (lane == 0) s_count[warp] = cnt;
  __syncthreads();
  int pos = 0, n_valid = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    pos += w < warp ? s_count[w] : 0;
    n_valid += s_count[w];
  }
  const unsigned below = (1u << lane) - 1u;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const bool v = i < hi && valid[i];
    const unsigned ballot = __ballot_sync(0xffffffffu, v);
    if (v) order[pos + __popc(ballot & below)] = i;
    pos += __popc(ballot);
  }

  // warp 0's solver state, the same in every lane
  float q[4], t[3], log_s = 0.f;
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = q0[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = t0[k];
    log_s = logf(fmaxf(s0[0], 1e-6f));
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) s_x.q[k] = q[k];
      quat_to_matrix(q, s_x.R);
#pragma unroll
      for (int k = 0; k < 3; ++k) s_x.t[k] = t[k];
      s_x.s = expf(log_s);
      s_x.inv_s = 1.f / s_x.s;
    }
  }
  __syncthreads();  // `order` and the first pose

  // 1. this thread's register pairs: positions tid + k * kThreads
  Pair reg[kRegPairs];
  int reg_i[kRegPairs];
#pragma unroll
  for (int k = 0; k < kRegPairs; ++k) {
    const int p = tid + k * kThreads;
    reg_i[k] = p < n_valid ? order[p] : -1;
    if (reg_i[k] >= 0)
      load_pair(reg_i[k], pc1, pc2, uv1, uv2, sigma2_1, sigma2_2, reg[k]);
  }

  // 2. iters Gauss-Newton steps, then 3. the inlier pass
  for (int it = 0;; ++it) {
    const bool final_pass = it >= iters;
    const State x = s_x;
    float acc[32], extra[kExtra];
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[k] = 0.f;
#pragma unroll
    for (int k = 0; k < kExtra; ++k) extra[k] = 0.f;
    int n_in = 0;
#pragma unroll
    for (int k = 0; k < kRegPairs; ++k) {
      if (reg_i[k] < 0) continue;
      float chi1, chi2;
      pair_pass<K1, K2>(x, cam1, cam2, reg[k], huber2, !final_pass, acc,
                        extra, chi1, chi2);
      if (final_pass) {
        const bool in = chi1 < kChi2Inlier && chi2 < kChi2Inlier;
        inlier[reg_i[k]] = in;
        n_in += in;
      }
    }
    for (int p = tid + kRegPairs * kThreads; p < n_valid; p += kThreads) {
      const int i = order[p];
      Pair pr;
      load_pair(i, pc1, pc2, uv1, uv2, sigma2_1, sigma2_2, pr);
      float chi1, chi2;
      pair_pass<K1, K2>(x, cam1, cam2, pr, huber2, !final_pass, acc, extra,
                        chi1, chi2);
      if (final_pass) {
        const bool in = chi1 < kChi2Inlier && chi2 < kChi2Inlier;
        inlier[i] = in;
        n_in += in;
      }
    }

    if (final_pass) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        n_in += __shfl_xor_sync(0xffffffffu, n_in, o);
      if (lane == 0) s_count[warp] = n_in;
      __syncthreads();
      if (tid == 0) {
        long long total = 0;
        for (int w = 0; w < kWarps; ++w) total += s_count[w];
        *n_inliers = total;
#pragma unroll
        for (int k = 0; k < 4; ++k) x_out[k] = q[k];
#pragma unroll
        for (int k = 0; k < 3; ++k) x_out[4 + k] = t[k];
        x_out[7] = expf(log_s);
      }
      break;
    }

    s_part[warp][lane] = warp_reduce_scatter(acc, lane);
#pragma unroll
    for (int k = 0; k < kExtra; ++k) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        extra[k] += __shfl_xor_sync(0xffffffffu, extra[k], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kExtra; ++k) s_part[warp][32 + k] = extra[k];
    }
    __syncthreads();
    if (warp == 0) {
      float col = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) col += s_part[w][lane];
      float tot[32 + kExtra];
#pragma unroll
      for (int k = 0; k < 32; ++k) tot[k] = __shfl_sync(0xffffffffu, col, k);
#pragma unroll
      for (int k = 0; k < kExtra; ++k) {
        float e = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) e += s_part[w][32 + k];
        tot[32 + k] = e;
      }
      float H[49], rhs[7], dx[7];
      int k = 0;
#pragma unroll
      for (int r = 0; r < 7; ++r)
#pragma unroll
        for (int c = r; c < 7; ++c, ++k) H[7 * r + c] = H[7 * c + r] = tot[k];
#pragma unroll
      for (int r = 0; r < 7; ++r) {
        H[8 * r] += 1e-6f;
        rhs[r] = -tot[28 + r];
      }
      ldlt_solve<7>(H, rhs, dx);
      // so3 exp of dx[3:6] as lie.so3_exp_quat (Taylor below th^2 1e-8),
      // applied on the left
      const float* phi = dx + 3;
      const float th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
      const bool small = th2 < 1e-8f;
      const float th = sqrtf(small ? 1.f : th2);
      float sh, ch;
      sincosf(0.5f * th, &sh, &ch);
      const float kq = small ? 0.5f - th2 / 48.f : sh / th;
      float dq[4] = {small ? 1.f - th2 / 8.f : ch, kq * phi[0], kq * phi[1],
                     kq * phi[2]};
      quat_normalize(dq);
      float nq[4];
      quat_mul(dq, q, nq);
      quat_normalize(nq);
#pragma unroll
      for (int c = 0; c < 4; ++c) q[c] = nq[c];
#pragma unroll
      for (int c = 0; c < 3; ++c) t[c] += dx[c];
      log_s += dx[6];
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s_x.q[c] = q[c];
        quat_to_matrix(q, s_x.R);
#pragma unroll
        for (int c = 0; c < 3; ++c) s_x.t[c] = t[c];
        s_x.s = expf(log_s);
        s_x.inv_s = 1.f / s_x.s;
      }
    }
    __syncthreads();
  }
}

template <int K1>
cudaError_t launch_k2(int kind2, const float* q0, const float* t0,
                      const float* s0, const float* cam1, const float* cam2,
                      const float* pc1, const float* pc2, const float* uv1,
                      const float* uv2, const float* sigma2_1,
                      const float* sigma2_2, const uint8_t* valid, int N,
                      int iters, float huber2, int* order, float* x_out,
                      uint8_t* inlier, long long* n_inliers,
                      cudaStream_t stream) {
  if (kind2 == kPinhole)
    sim3_kernel<K1, kPinhole><<<1, kThreads, 0, stream>>>(
        q0, t0, s0, cam1, cam2, pc1, pc2, uv1, uv2, sigma2_1, sigma2_2,
        valid, N, iters, huber2, order, x_out, inlier, n_inliers);
  else if (kind2 == kKB8)
    sim3_kernel<K1, kKB8><<<1, kThreads, 0, stream>>>(
        q0, t0, s0, cam1, cam2, pc1, pc2, uv1, uv2, sigma2_1, sigma2_2,
        valid, N, iters, huber2, order, x_out, inlier, n_inliers);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// One problem of N pairs: q0 [4], t0 [3], s0 [] f32, camera 1 and 2
// parameters [8] of kinds kind1 / kind2 (0 pinhole, 1 KB8), pc1 / pc2
// [N, 3], uv1 / uv2 [N, 2], sigma2_1 / sigma2_2 [N] f32, valid [N] u8;
// order [N] i32 is scratch -> x_out [8] = (q, t, s), inlier [N] u8,
// n_inliers [] i64.
extern "C" int mam3_sim3_opt(const float* q0, const float* t0,
                             const float* s0, const float* cam1, int kind1,
                             const float* cam2, int kind2, const float* pc1,
                             const float* pc2, const float* uv1,
                             const float* uv2, const float* sigma2_1,
                             const float* sigma2_2, const uint8_t* valid,
                             int N, int iters, float huber2, int* order,
                             float* x_out, uint8_t* inlier,
                             long long* n_inliers, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (kind1 == kPinhole)
    return (int)launch_k2<kPinhole>(kind2, q0, t0, s0, cam1, cam2, pc1, pc2,
                                    uv1, uv2, sigma2_1, sigma2_2, valid, N,
                                    iters, huber2, order, x_out, inlier,
                                    n_inliers, st);
  if (kind1 == kKB8)
    return (int)launch_k2<kKB8>(kind2, q0, t0, s0, cam1, cam2, pc1, pc2, uv1,
                                uv2, sigma2_1, sigma2_2, valid, N, iters,
                                huber2, order, x_out, inlier, n_inliers, st);
  return (int)cudaErrorInvalidValue;
}
