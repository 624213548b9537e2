// PGO kernels: the essential graph's 7DoF pose-graph optimisation (the
// loop correction's and the merge's) in three launches an LM iteration
// around the dense Cholesky solve, and a fourth for the starting cost.
//
// Replaces no Pallas kernel: the reference leaves this PGO to XLA
// (mam3slam_tpu/solvers/pgo.py: optimize_essential_graph, forward-mode
// jacobians under jit).  Plain PyTorch version and semantics:
// mam3slam_tpu_torch/solvers/pgo.py: optimize_essential_graph_plain, whose
// iteration issues ~1,290 ATen ops (607 of them torch.func.jacfwd's),
// ~15,500 a 12-iteration call and over a second of host time.
//
// The problem: Sim3 vertices S_k = (q, t, s) [K], edges (i, j) with
// measurement m and weight w [E], residual r = log(m S_i S_j^-1) in the
// tangent [rho, phi, sigma], left perturbation S <- exp(xi) S.  An LM
// iteration: J of r by xi_i and xi_j (zeroed on fixed vertices); H = sum
// w J^T J and g = sum w J^T r over the edges; H's diagonal blocks damped
// by lam max(diag, 1e-6) + 1e-8 (fixed vertices get I added); dx = -H^-1 g
// by Cholesky (0 where it failed or is not finite, and on fixed vertices);
// the candidate exp(dx) S (quaternion normalised) is kept when its cost
// sum w |r|^2 is below the current one, lam then halves (down to 1e-7),
// else grows x5 (up to 1e5).  Everything in float32.
//
//   pgo_linearize (a half-warp per edge, 16 edges a block): each lane
//     evaluates the residual with a dual number along one of the 14
//     tangent directions (csrc/pgo_lie.cuh: lie.py's expressions and
//     Taylor branches, so the derivative is the one jacfwd takes), its
//     column of J is zeroed on a fixed vertex, and lane a forms row a of
//     w J^T J and w J^T r, reading the other columns by shuffles.  It
//     writes the rows _assemble stacks, in its order: w Ji^T Ji [E], w
//     Jj^T Jj [E], w Ji^T Jj [E], its transpose [E] (7x7 each), then
//     w Ji^T r [E], w Jj^T r [E] (7 each).  csrc/segsum.cu sums them into
//     H [K, K, 7, 7] and g [K, 7] with solvers/pgo.py's _block_plans.
//   pgo_damp (grid-stride): H laid out as the [7K, 7K] matrix, its
//     diagonal blocks damped; the right-hand side -g.
//   torch.linalg.cholesky_ex and torch.cholesky_solve (cuSOLVER).
//   pgo_update (one block): dx checked and zeroed as above, every vertex
//     retracted into scratch, every edge's cost at the candidate summed in
//     a fixed order (each thread its edges in turn, then xor shuffles,
//     then the warps in order), compared on the card with the stored
//     cost; lam, the cost and, if accepted, q, t, s written.  With
//     `init` it sums the cost at the current vertices and stores it.
// Nothing is read back to the host; no atomics: two calls on one input
// give the same bits.
//
// What bounds it on the H100: operations, and under them the chain of
// `iters` dependent iterations.  An iteration's dense Cholesky of the
// [7K, 7K] system is (7K)^3 / 3 flops, 15.3 GFLOP at the arena's K = 512,
// 0.23 ms at the f32 peak; the kernels here add ~2 kflop a lane of an
// edge's 16 (E of 100-300) and ~1 kflop a vertex, and move the dense
// system's 51 MB twice (pgo_damp) beside segsum's write of it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pgo_lie.cuh"

namespace {

using pgo::Dual;
using pgo::Sim3;

constexpr int kLinThreads = 256;
constexpr int kEdgesPerBlock = kLinThreads / 16;
constexpr int kDampThreads = 256;
constexpr int kUpdThreads = 512;

template <typename T>
__device__ __forceinline__ Sim3<T> load_sim3(const float* __restrict__ q,
                                             const float* __restrict__ t,
                                             const float* __restrict__ s,
                                             int k) {
  Sim3<T> o;
#pragma unroll
  for (int c = 0; c < 4; ++c) o.q[c] = pgo::lit<T>(q[4 * k + c]);
#pragma unroll
  for (int c = 0; c < 3; ++c) o.t[c] = pgo::lit<T>(t[3 * k + c]);
  o.s = pgo::lit<T>(s[k]);
  return o;
}

__global__ void __launch_bounds__(kLinThreads)
pgo_linearize_kernel(int E, const int* __restrict__ ei,
                     const int* __restrict__ ej, const float* __restrict__ q,
                     const float* __restrict__ t, const float* __restrict__ s,
                     const uint8_t* __restrict__ fixed,
                     const float* __restrict__ mq,
                     const float* __restrict__ mt,
                     const float* __restrict__ ms,
                     const float* __restrict__ w, float* __restrict__ hrows,
                     float* __restrict__ grows) {
  const int lane = threadIdx.x & 15;  // the tangent direction (14, 15: none)
  const int e_at = blockIdx.x * kEdgesPerBlock + (threadIdx.x >> 4);
  // a half-warp past the last edge computes edge 0 for its shuffles and
  // writes nothing
  const bool live = e_at < E;
  const int e = live ? e_at : 0;
  if (E == 0) return;
  const int i = ei[e], j = ej[e];

  Dual xi_i[7], xi_j[7];
#pragma unroll
  for (int c = 0; c < 7; ++c) {
    xi_i[c] = {0.f, lane == c ? 1.f : 0.f};
    xi_j[c] = {0.f, lane == 7 + c ? 1.f : 0.f};
  }
  const Sim3<Dual> Si = pgo::perturbed(xi_i, load_sim3<Dual>(q, t, s, i));
  const Sim3<Dual> Sj = pgo::perturbed(xi_j, load_sim3<Dual>(q, t, s, j));
  const Sim3<Dual> m = load_sim3<Dual>(mq, mt, ms, e);
  Dual r[7];
  pgo::edge_residual(Si, Sj, m, r);

  // this lane's column of J, times 0 on a fixed vertex as the plain
  // version multiplies it
  const float keep = fixed[lane < 7 ? i : j] ? 0.f : 1.f;
  float col[7];
#pragma unroll
  for (int c = 0; c < 7; ++c) col[c] = r[c].d * keep;
  const float we = w[e];
  float row[14];
#pragma unroll
  for (int b = 0; b < 14; ++b) {
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < 7; ++c)
      acc = fmaf(col[c], __shfl_sync(0xffffffffu, col[c], b, 16), acc);
    row[b] = we * acc;
  }
  float gr = 0.f;
#pragma unroll
  for (int c = 0; c < 7; ++c) gr = fmaf(col[c], r[c].v, gr);
  gr *= we;
  if (!live || lane >= 14) return;

  const long long EE = E;
  if (lane < 7) {  // row `lane` of Ji^T Ji and of Ji^T Jj
    float* hii = hrows + (e * 49LL + lane * 7);
    float* hij = hrows + ((2 * EE + e) * 49 + lane * 7);
#pragma unroll
    for (int b = 0; b < 7; ++b) {
      hii[b] = row[b];
      hij[b] = row[7 + b];
    }
    grows[e * 7LL + lane] = gr;
  } else {         // row p of Jj^T Jj and of (Ji^T Jj)^T
    const int p = lane - 7;
    float* hjj = hrows + ((EE + e) * 49 + p * 7);
    float* hji = hrows + ((3 * EE + e) * 49 + p * 7);
#pragma unroll
    for (int b = 0; b < 7; ++b) {
      hjj[b] = row[7 + b];
      hji[b] = row[b];
    }
    grows[(EE + e) * 7 + p] = gr;
  }
}

__global__ void __launch_bounds__(kDampThreads)
pgo_damp_kernel(int K, const float* __restrict__ H,
                const float* __restrict__ g,
                const uint8_t* __restrict__ fixed,
                const float* __restrict__ lam, float* __restrict__ A,
                float* __restrict__ rhs) {
  const long long n = 7LL * K, total = n * n;
  const float l = *lam;
  for (long long x = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       x < total; x += (long long)gridDim.x * blockDim.x) {
    const long long R = x / n, C = x - R * n;
    const long long a = R / 7, b = C / 7;
    const int r = (int)(R - 7 * a), c = (int)(C - 7 * b);
    float v = H[((a * K + b) * 7 + r) * 7 + c];
    if (a == b) {
      // Hd + (I where fixed) + damp I, damp = lam max(diag, 1e-6) + 1e-8
      const bool d = r == c;
      const float f = d && fixed[a] ? 1.f : 0.f;
      const float cl = v < 1e-6f ? 1e-6f : v;
      const float damp = d ? __fadd_rn(__fmul_rn(l, cl), 1e-8f) : 0.f;
      v = __fadd_rn(__fadd_rn(v, f), damp);
    }
    A[x] = v;
    if (x < n) rhs[x] = -g[x];
  }
}

__global__ void __launch_bounds__(kUpdThreads)
pgo_update_kernel(int K, int E, int init, const float* __restrict__ dx,
                  const int* __restrict__ info,
                  const uint8_t* __restrict__ fixed,
                  const int* __restrict__ ei, const int* __restrict__ ej,
                  const float* __restrict__ mq, const float* __restrict__ mt,
                  const float* __restrict__ ms, const float* __restrict__ w,
                  float* __restrict__ q, float* __restrict__ t,
                  float* __restrict__ s, float* __restrict__ cq,
                  float* __restrict__ ct, float* __restrict__ cs,
                  float* __restrict__ lam, float* __restrict__ cost) {
  __shared__ float s_part[kUpdThreads / 32];
  __shared__ int s_accept;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float *pq = q, *pt = t, *ps = s;
  if (!init) {
    // the solve's dx, or 0 where it failed or is not finite, and on fixed
    // vertices
    bool finite = true;
    for (int k = tid; k < 7 * K; k += kUpdThreads) finite &= isfinite(dx[k]);
    const bool ok = __syncthreads_and(finite) && *info == 0;
    for (int v = tid; v < K; v += kUpdThreads) {
      const bool use = ok && !fixed[v];
      float d[7];
#pragma unroll
      for (int c = 0; c < 7; ++c) d[c] = use ? dx[7 * v + c] : 0.f;
      Sim3<float> n = pgo::perturbed(d, load_sim3<float>(q, t, s, v));
      pgo::quat_normalize(n.q);
#pragma unroll
      for (int c = 0; c < 4; ++c) cq[4 * v + c] = n.q[c];
#pragma unroll
      for (int c = 0; c < 3; ++c) ct[3 * v + c] = n.t[c];
      cs[v] = n.s;
    }
    __syncthreads();
    pq = cq;
    pt = ct;
    ps = cs;
  }
  float part = 0.f;
  for (int e = tid; e < E; e += kUpdThreads) {
    float r[7];
    pgo::edge_residual(load_sim3<float>(pq, pt, ps, ei[e]),
                       load_sim3<float>(pq, pt, ps, ej[e]),
                       load_sim3<float>(mq, mt, ms, e), r);
    float rr = 0.f;
#pragma unroll
    for (int c = 0; c < 7; ++c) rr += r[c] * r[c];
    part += w[e] * rr;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, o);
  if (lane == 0) s_part[warp] = part;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < kUpdThreads / 32; ++k) total += s_part[k];
    if (init) {
      *cost = total;
      s_accept = 0;
    } else {
      const bool accept = total < *cost;
      const float l = *lam;
      *lam = accept ? fmaxf(l * 0.5f, 1e-7f) : fminf(l * 5.f, 1e5f);
      if (accept) *cost = total;
      s_accept = accept;
    }
  }
  __syncthreads();
  if (!s_accept) return;
  for (int v = tid; v < K; v += kUpdThreads) {
#pragma unroll
    for (int c = 0; c < 4; ++c) q[4 * v + c] = cq[4 * v + c];
#pragma unroll
    for (int c = 0; c < 3; ++c) t[3 * v + c] = ct[3 * v + c];
    s[v] = cs[v];
  }
}

}  // namespace

// E edges (ei, ej [E] i32; measurement mq [E, 4], mt [E, 3], ms [E];
// weight w [E], 0 on invalid edges) at vertices q [K, 4], t [K, 3], s [K]
// with fixed [K] u8 -> hrows [4E, 49], grows [2E, 7].
extern "C" int mam3_pgo_linearize(int E, const int* ei, const int* ej,
                                  const float* q, const float* t,
                                  const float* s, const uint8_t* fixed,
                                  const float* mq, const float* mt,
                                  const float* ms, const float* w,
                                  float* hrows, float* grows, void* stream) {
  const int blocks = E > 0 ? (E + kEdgesPerBlock - 1) / kEdgesPerBlock : 1;
  pgo_linearize_kernel<<<blocks, kLinThreads, 0, (cudaStream_t)stream>>>(
      E, ei, ej, q, t, s, fixed, mq, mt, ms, w, hrows, grows);
  return (int)cudaGetLastError();
}

// H [K, K, 7, 7], g [K, 7], fixed [K] u8, lam [] -> A [7K, 7K] (H's
// blocks laid out row by row, diagonal blocks damped), rhs [7K] = -g.
extern "C" int mam3_pgo_damp(int K, const float* H, const float* g,
                             const uint8_t* fixed, const float* lam,
                             float* A, float* rhs, void* stream) {
  const long long total = 49LL * K * K;
  const long long want = (total + kDampThreads - 1) / kDampThreads;
  const int blocks = (int)(want < 4096 ? (want > 0 ? want : 1) : 4096);
  pgo_damp_kernel<<<blocks, kDampThreads, 0, (cudaStream_t)stream>>>(
      K, H, g, fixed, lam, A, rhs);
  return (int)cudaGetLastError();
}

// The step's dx [7K] and Cholesky info [] i32 (unread with init), the
// edges as mam3_pgo_linearize takes them; q, t, s [K] the vertices
// (overwritten when the step is accepted), cq, ct, cs [K] scratch, lam []
// and cost [] the LM state (init: cost written, nothing else).
extern "C" int mam3_pgo_update(int K, int E, int init, const float* dx,
                               const int* info, const uint8_t* fixed,
                               const int* ei, const int* ej, const float* mq,
                               const float* mt, const float* ms,
                               const float* w, float* q, float* t, float* s,
                               float* cq, float* ct, float* cs, float* lam,
                               float* cost, void* stream) {
  pgo_update_kernel<<<1, kUpdThreads, 0, (cudaStream_t)stream>>>(
      K, E, init, dx, info, fixed, ei, ej, mq, mt, ms, w, q, t, s, cq, ct,
      cs, lam, cost);
  return (int)cudaGetLastError();
}
