// Pose kernel: the whole motion-only pose optimisation in one launch,
// one block per problem.
//
// Replaces the Pallas TPU kernel mam3slam_tpu/ops/pallas_pose.py:
// pose_optimization_pinhole (body _pose_kernel), and the reference's XLA
// path for the KannalaBrandt8 camera, which the Pallas kernel does not
// cover.  Plain PyTorch version and semantics:
// mam3slam_tpu_torch/ops/cuda_pose.py: pose_optimization_plain (the
// reference's XLA path, mam3slam_tpu/solvers/ba.py:329-396).  The camera
// kind is a template argument: one kernel per kind, chosen at launch.
//
// What bounds it on the H100: 4 rounds x (iters + 1) = 24 evaluations,
// each a pass of ~150 flops an edge (pinhole; ~250 for KB8, whose
// projection adds an atan2f, a sqrtf, six divisions and two quartics,
// and whose jacobian has no zero entries) over the edges active in its
// round, plus the projection and chi2 (~35 flops; ~75 for KB8) of the
// valid edges that rounds 1-3 re-classify as outliers and of every valid
// edge in the final classification: 3.4 MFLOP at N = 1024 with ~930
// inliers (pinhole), 0.05 us at the f32 peak, and 26 KB of edges.  The
// real floor is the chain of dependent steps: every evaluation needs the pose that
// the previous one's 6x6 solve produced, so the time is the sum of the
// steps' critical paths (pass, block reduction, solve, retraction).
//
// Design: one block of 512 threads per problem (tracking passes B = 1, a
// batch of agents one block each).  Each thread holds two edges (point,
// pixel, weight, valid and active bit) in registers for the whole solve,
// loaded once; edges past 2 x 512 are strided over and re-read from
// memory, their active bits kept in the inlier output.  Per evaluation:
//   1. every thread linearises its edges at the current pose and
//      accumulates the 21 upper-triangle H entries, the 6 g entries and
//      the robust cost (32 slots with 4 spare);
//   2. each warp reduces the 32 slots by recursive halving over xor
//      shuffles (31 shuffles; lane l ends with slot l's warp total) into
//      s_part[16][32];  barrier;
//   3. warp 0: lane l sums column l over the 16 warps, the 28 totals are
//      broadcast to every lane by shuffles, and every lane of warp 0 makes
//      the LM decision (accept if the cost fell: lambda x0.5 clamped at
//      1e-7, else x4 clamped at 1e4), damps H + (lambda max(diag, 1e-6) +
//      1e-8) I, solves it by an unrolled LDL^T (one reciprocal a column)
//      and retracts with the SE3 exp (quaternion + left Jacobian; one
//      sincosf, no fast-math intrinsics), all in registers; lane 0 writes
//      the next pose and its rotation matrix to shared memory;  barrier.
// The re-classification between rounds (active = valid & depth > 1e-3 &
// chi2 <= 5.991) happens at the pose that the next round's first
// evaluation linearises, so the two share one pass: classify, then
// accumulate under the new round's robust flag.  The last evaluation of a
// round only updates the best pose (its step would be discarded), and
// only the final re-classification, which gives the returned inliers, is
// a pass of its own.  As in the reference's XLA path the pose is a
// quaternion, the trial pose is evaluated at the start of the next
// iteration, the step is always taken from the best pose, and rounds 0-1
// use the Huber weight (delta^2 = 5.991).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRegEdges = 2;   // edges a thread keeps in registers
constexpr int kSlots = 32;     // 21 H (upper triangle) + 6 g + cost + 4 spare
constexpr int kCost = 27;
constexpr float kDelta2 = 5.991f;

struct Pose {
  float q[4];
  float t[3];
};

// SE3 exp of [rho, phi] applied on the left of `base`.  One sincosf of
// th / 2 gives sin th and cos th by the double-angle identities, and the
// quotients multiply by 1 / th: the chain of dependent steps is short.
__device__ __forceinline__ void retract(const float* dx, const Pose& base,
                                        Pose& out) {
  const float* rho = dx;
  const float* phi = dx + 3;
  const float th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const bool small = th2 < 1e-8f;
  const float th = sqrtf(small ? 1.f : th2);
  const float ith = 1.f / th;
  float sh, ch;
  sincosf(0.5f * th, &sh, &ch);
  const float k = small ? 0.5f - th2 * (1.f / 48.f) : sh * ith;
  float dq[4] = {small ? 1.f - th2 * 0.125f : ch, k * phi[0], k * phi[1],
                 k * phi[2]};
  quat_normalize(dq);
  // left Jacobian V = I + b K + c K^2, K = hat(phi); 1 - cos th =
  // 2 sin^2(th / 2), sin th = 2 sin(th / 2) cos(th / 2)
  const float b =
      small ? 0.5f - th2 * (1.f / 24.f) : 2.f * sh * sh * ith * ith;
  const float c = small ? 1.f / 6.f - th2 * (1.f / 120.f)
                        : (th - 2.f * sh * ch) * ith * ith * ith;
  const float K[9] = {0.f, -phi[2], phi[1], phi[2], 0.f, -phi[0],
                      -phi[1], phi[0], 0.f};
  float dt[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float s = rho[i];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float k2 = 0.f;
#pragma unroll
      for (int m = 0; m < 3; ++m) k2 += K[3 * i + m] * K[3 * m + j];
      s += (b * K[3 * i + j] + c * k2) * rho[j];
    }
    dt[i] = s;
  }
  quat_mul(dq, base.q, out.q);
  quat_normalize(out.q);
  float rt[3];
  quat_rotate(dq, base.t, rt);
#pragma unroll
  for (int i = 0; i < 3; ++i) out.t[i] = rt[i] + dt[i];
}

struct Edge {
  float r[2];
  float J[2][6];
  float chi2;
  bool depth_ok;
};

// Residual and [dpi | -dpi hat(Xc)] rows for u and v at the camera-frame
// point Xc; cam = [fx, fy, cx, cy, k1..k4].  The pinhole rows have
// J[0][1] = J[1][0] = 0; KB8 takes common.cuh's kb8_project_jac.
template <int KIND>
__device__ __forceinline__ void linearize(const float* R, const float* t,
                                          const float* cam, const float* X,
                                          const float* uv, float w, Edge& e) {
  const float xc = R[0] * X[0] + R[1] * X[1] + R[2] * X[2] + t[0];
  const float yc = R[3] * X[0] + R[4] * X[1] + R[5] * X[2] + t[1];
  const float zc = R[6] * X[0] + R[7] * X[1] + R[8] * X[2] + t[2];
  if (KIND == kPinhole) {
    const float zs = fabsf(zc) < 1e-6f ? 1e-6f : zc;
    const float iz = 1.f / zs;
    const float a = cam[0] * iz, b = cam[1] * iz;
    const float xn = xc * iz, yn = yc * iz;
    e.r[0] = a * xc + cam[2] - uv[0];
    e.r[1] = b * yc + cam[3] - uv[1];
    e.J[0][0] = a;
    e.J[0][1] = 0.f;
    e.J[0][2] = -a * xn;
    e.J[0][3] = -a * xn * yc;
    e.J[0][4] = a * zc + a * xn * xc;
    e.J[0][5] = -a * yc;
    e.J[1][0] = 0.f;
    e.J[1][1] = b;
    e.J[1][2] = -b * yn;
    e.J[1][3] = -b * zc - b * yn * yc;
    e.J[1][4] = b * yn * xc;
    e.J[1][5] = b * xc;
  } else {
    float px[2], p[2][3];
    kb8_project_jac(cam, xc, yc, zc, px, p);
    e.r[0] = px[0] - uv[0];
    e.r[1] = px[1] - uv[1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      e.J[i][0] = p[i][0];
      e.J[i][1] = p[i][1];
      e.J[i][2] = p[i][2];
      e.J[i][3] = p[i][2] * yc - p[i][1] * zc;
      e.J[i][4] = p[i][0] * zc - p[i][2] * xc;
      e.J[i][5] = p[i][1] * xc - p[i][0] * yc;
    }
  }
  e.depth_ok = zc > 1e-3f;
  e.chi2 = w * (e.r[0] * e.r[0] + e.r[1] * e.r[1]);
}

// One edge of a pass at (R, t): re-classify it first when `classify`
// (active = valid & depth > 1e-3 & chi2 <= delta^2), then add its robust
// cost, H and g to `acc`.  An edge that does not count (inactive, behind
// the camera, or `accumulate` unset) adds exact zeros: its weight and
// chi2 are selected to 0 rather than branched around, so the compiler
// does not materialise the accumulators on two paths.  With `may_skip`
// an edge that cannot count (invalid, or inactive when not re-classified)
// is not linearised at all; without, its inputs are replaced by a finite
// point.  For the pinhole J[0][1] = J[1][0] = 0, so rows 0 and 1 of H and
// g take one product each.
template <int KIND>
__device__ __forceinline__ void edge_pass(const float* R, const float* t,
                                          const float* cam, const float* X,
                                          const float* uv, float w,
                                          bool valid, bool& active,
                                          bool classify, bool accumulate,
                                          bool robust, bool may_skip,
                                          float (&acc)[kSlots]) {
  const bool countable = classify ? valid : active;
  if (may_skip && !countable) return;
  const float Xs[3] = {countable ? X[0] : 0.f, countable ? X[1] : 0.f,
                       countable ? X[2] : 1.f};
  const float uvs[2] = {countable ? uv[0] : 0.f, countable ? uv[1] : 0.f};
  Edge e;
  linearize<KIND>(R, t, cam, Xs, uvs, w, e);
  if (classify) active = countable && e.depth_ok && e.chi2 <= kDelta2;
  const bool counts = accumulate && active && e.depth_ok;
  const float chi2 = counts ? e.chi2 : 0.f;
  float rho = chi2, we = counts ? w : 0.f;
  if (chi2 > kDelta2) {  // Huber: 2 sqrt(d2 chi2) - d2, weight sqrt(d2 / chi2)
    const float sq = sqrtf(kDelta2 * chi2);
    rho = 2.f * sq - kDelta2;
    if (robust) we *= kDelta2 / sq;
  }
  acc[kCost] += rho;
  int k = 0;
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    const float wu = we * e.J[0][r], wv = we * e.J[1][r];
#pragma unroll
    for (int c = r; c < 6; ++c, ++k) {
      if (KIND == kPinhole && r == 0) {
        if (c != 1) acc[k] += wu * e.J[0][c];
      } else if (KIND == kPinhole && r == 1) {
        acc[k] += wv * e.J[1][c];
      } else {
        acc[k] += wu * e.J[0][c] + wv * e.J[1][c];
      }
    }
    acc[21 + r] += KIND == kPinhole && r == 0   ? wu * e.r[0]
                   : KIND == kPinhole && r == 1 ? wv * e.r[1]
                                                : wu * e.r[0] + wv * e.r[1];
  }
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
pose_kernel(const float* __restrict__ q0, const float* __restrict__ t0,
            const float* __restrict__ cams, const float* __restrict__ pts,
            const float* __restrict__ uv, const float* __restrict__ wts,
            const uint8_t* __restrict__ valid, int N, int rounds, int iters,
            float* __restrict__ q_out, float* __restrict__ t_out,
            uint8_t* __restrict__ inlier, int* __restrict__ n_inliers) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  pts += (size_t)b * N * 3;
  uv += (size_t)b * N * 2;
  wts += (size_t)b * N;
  valid += (size_t)b * N;
  uint8_t* active_mem = inlier + (size_t)b * N;  // edges past the registers

  __shared__ float s_part[kWarps][kSlots];
  __shared__ float s_Rt[12];  // the pose to linearise at: R (row-major), t
  __shared__ int s_count[kWarps];

  float cam[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) cam[k] = cams[8 * b + k];

  // this thread's register edges: i = tid + k * kThreads
  float eX[kRegEdges][3], eUV[kRegEdges][2], eW[kRegEdges];
  bool eValid[kRegEdges], eActive[kRegEdges];
#pragma unroll
  for (int k = 0; k < kRegEdges; ++k) {
    const int i = tid + k * kThreads;
    const bool in = i < N;
#pragma unroll
    for (int c = 0; c < 3; ++c) eX[k][c] = in ? pts[3 * i + c] : 0.f;
    eUV[k][0] = in ? uv[2 * i] : 0.f;
    eUV[k][1] = in ? uv[2 * i + 1] : 0.f;
    eW[k] = in ? wts[i] : 0.f;
    eValid[k] = in && valid[i];
    eActive[k] = eValid[k];
  }
  for (int i = tid + kRegEdges * kThreads; i < N; i += kThreads)
    active_mem[i] = valid[i];

  // warp 0's LM state, the same in every lane
  Pose cur, best;
  float bcost = INFINITY, lam = 1e-3f;
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) cur.q[k] = q0[4 * b + k];
#pragma unroll
    for (int k = 0; k < 3; ++k) cur.t[k] = t0[3 * b + k];
    best = cur;
    if (lane == 0) {
      quat_to_matrix(cur.q, s_Rt);
#pragma unroll
      for (int k = 0; k < 3; ++k) s_Rt[9 + k] = cur.t[k];
    }
  }
  __syncthreads();

  // rounds x (iters + 1) evaluations, then the final classification
  for (int rd = 0, it = 0;;) {
    const bool final_pass = rd == rounds;
    const bool classify = final_pass || (rd > 0 && it == 0);
    const bool robust = rd < 2;
    float R[9], t[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = s_Rt[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = s_Rt[9 + k];
    float acc[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) acc[k] = 0.f;
#pragma unroll
    for (int k = 0; k < kRegEdges; ++k)  // the first edge unconditionally
      edge_pass<KIND>(R, t, cam, eX[k], eUV[k], eW[k], eValid[k],
                      eActive[k], classify, !final_pass, robust, k > 0, acc);
    for (int i = tid + kRegEdges * kThreads; i < N; i += kThreads) {
      bool act = active_mem[i];
      edge_pass<KIND>(R, t, cam, pts + 3 * i, uv + 2 * i, wts[i], valid[i],
                      act, classify, !final_pass, robust, true, acc);
      if (classify) active_mem[i] = act;
    }
    if (final_pass) break;

    const float part = warp_reduce_scatter(acc, lane);
    s_part[warp][lane] = part;
    __syncthreads();
    if (warp == 0) {
      float col = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) col += s_part[w][lane];
      float tot[28];
#pragma unroll
      for (int k = 0; k < 28; ++k) tot[k] = __shfl_sync(0xffffffffu, col, k);
      if (it == 0) {  // a round starts at the previous round's best pose
        bcost = INFINITY;
        lam = 1e-3f;
      }
      const float cost = tot[kCost];
      const bool accept = cost < bcost;
      lam = accept ? fmaxf(lam * 0.5f, 1e-7f) : fminf(lam * 4.f, 1e4f);
      if (accept) {
        best = cur;
        bcost = cost;
      }
      if (it < iters) {
        float H[36], rhs[6], dx[6];
        int k = 0;
#pragma unroll
        for (int r = 0; r < 6; ++r)
#pragma unroll
          for (int c = r; c < 6; ++c, ++k)
            H[6 * r + c] = H[6 * c + r] = tot[k];
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          H[7 * r] += lam * fmaxf(H[7 * r], 1e-6f) + 1e-8f;
          rhs[r] = -tot[21 + r];
        }
        ldlt_solve<6>(H, rhs, dx);
        retract(dx, best, cur);
      } else {
        cur = best;  // the next round, or the final classification
      }
      if (lane == 0) {
        quat_to_matrix(cur.q, s_Rt);
#pragma unroll
        for (int k = 0; k < 3; ++k) s_Rt[9 + k] = cur.t[k];
      }
    }
    __syncthreads();
    if (++it > iters) {
      it = 0;
      ++rd;
    }
  }

  int cnt = 0;
#pragma unroll
  for (int k = 0; k < kRegEdges; ++k) {
    const int i = tid + k * kThreads;
    if (i < N) active_mem[i] = eActive[k];
    cnt += eActive[k];
  }
  for (int i = tid + kRegEdges * kThreads; i < N; i += kThreads)
    cnt += active_mem[i];
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  if (lane == 0) s_count[warp] = cnt;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += s_count[w];
    n_inliers[b] = total;
    for (int k = 0; k < 4; ++k) q_out[4 * b + k] = cur.q[k];
    for (int k = 0; k < 3; ++k) t_out[3 * b + k] = cur.t[k];
  }
}

}  // namespace

// B problems of N edges: q0 [B, 4], t0 [B, 3], cams [B, 8] of camera
// `kind` (0 pinhole, 1 KB8), pts [B, N, 3], uv [B, N, 2], w [B, N] f32,
// valid [B, N] u8 -> q [B, 4], t [B, 3], inlier [B, N] u8, n_inliers [B]
// i32.
extern "C" int mam3_pose_opt(const float* q0, const float* t0,
                             const float* cams, int kind, const float* pts,
                             const float* uv, const float* w,
                             const uint8_t* valid, int B, int N, int rounds,
                             int iters, float* q_out, float* t_out,
                             uint8_t* inlier, int* n_inliers, void* stream) {
  if (kind == kPinhole)
    pose_kernel<kPinhole><<<B, kThreads, 0, (cudaStream_t)stream>>>(
        q0, t0, cams, pts, uv, w, valid, N, rounds, iters, q_out, t_out,
        inlier, n_inliers);
  else if (kind == kKB8)
    pose_kernel<kKB8><<<B, kThreads, 0, (cudaStream_t)stream>>>(
        q0, t0, cams, pts, uv, w, valid, N, rounds, iters, q_out, t_out,
        inlier, n_inliers);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
