// Match kernels: masked and unmasked best-two Hamming search on packed
// 256-bit descriptors.
//
// Replace the Pallas TPU kernels mam3slam_tpu/ops/pallas_match.py:
// fused_masked_match (body _match_kernel) and min_hamming2 (body
// _minham2_kernel).  Plain PyTorch versions and semantics:
// mam3slam_tpu_torch/ops/cuda_match.py.
//
// What bounds it on the H100: the tracking step calls it at Q = 4096
// candidates x M = 1024 features: 4.2 M candidate pairs, each 8 XOR +
// 8 popc on 32-byte descriptors plus a radius/level test — about 0.1
// GOP, and 160 KB of inputs that stay in L2/shared memory.  So it is
// neither memory- nor compute-bound at this size: occupancy is.  One
// thread per query gives 4096 threads = 32 blocks of 128, a quarter of
// the 132 SMs, each thread walking all M targets serially.  Splitting the
// targets of a query across a warp (and merging the best-two pairs) is
// the next step and is left to a later change.
//
// Design: one thread per query, targets staged through shared memory in
// tiles of kTile and scanned in ascending index.  Distances are exact
// integers (XOR + __popc over 8 u32 words), not the MXU bit-matmul
// identity nor the Pallas kernel's packed f32 keys / bf16 nibbles.  The
// update rule d < d1 -> (d2, d1, idx) = (d1, d, j); else d < d2 -> d2 = d,
// from d1 = d2 = BIG, idx = 0, reproduces best_in_mask exactly: the
// lowest index wins ties, d2 may equal d1, a query with no candidate gets
// (0, BIG, BIG).  The radius test uses __fmul_rn / __fadd_rn so nvcc
// cannot contract dx*dx + dy*dy into an FMA, which would flip candidates
// that sit exactly on the radius.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 128;
constexpr int kBig = 1 << 20;

struct Best2 {
  int idx, d1, d2;
  __device__ Best2() : idx(0), d1(kBig), d2(kBig) {}
  __device__ __forceinline__ void push(int d, int j) {
    if (d < d1) {
      d2 = d1;
      d1 = d;
      idx = j;
    } else if (d < d2) {
      d2 = d;
    }
  }
};

__device__ __forceinline__ int hamming(const uint32_t (&q)[8],
                                       const uint32_t* t) {
  int d = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) d += __popc(q[k] ^ t[k]);
  return d;
}

template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
best2_kernel(const uint32_t* __restrict__ q_desc,
             const float* __restrict__ q_uv, const float* __restrict__ q_rad,
             const int* __restrict__ q_level,
             const uint8_t* __restrict__ q_valid, int nq,
             const uint32_t* __restrict__ t_desc,
             const float* __restrict__ t_uv, const int* __restrict__ t_level,
             const uint8_t* __restrict__ t_valid, int nt,
             int* __restrict__ out_idx, int* __restrict__ out_d1,
             int* __restrict__ out_d2) {
  __shared__ uint32_t s_desc[kTile][8];
  __shared__ float s_uv[kTile][2];
  __shared__ int s_level[kTile];
  __shared__ uint8_t s_valid[kTile];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < nq && q_valid[i];
  uint32_t q[8];
  float qu = 0.f, qv = 0.f, r2 = 0.f;
  int ql = 0;
  if (live) {
#pragma unroll
    for (int k = 0; k < 8; ++k) q[k] = q_desc[8 * i + k];
    if (kMasked) {
      qu = q_uv[2 * i];
      qv = q_uv[2 * i + 1];
      r2 = __fmul_rn(q_rad[i], q_rad[i]);
      ql = q_level[i];
    }
  }
  Best2 best;
  for (int base = 0; base < nt; base += kTile) {
    const int n = min(kTile, nt - base);
    for (int e = threadIdx.x; e < n * 8; e += kThreads)
      s_desc[e / 8][e % 8] = t_desc[8 * base + e];
    for (int e = threadIdx.x; e < n; e += kThreads) {
      s_valid[e] = t_valid[base + e];
      if (kMasked) {
        s_uv[e][0] = t_uv[2 * (base + e)];
        s_uv[e][1] = t_uv[2 * (base + e) + 1];
        s_level[e] = t_level[base + e];
      }
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < n; ++j) {
        if (!s_valid[j]) continue;
        if (kMasked) {
          const int lv = s_level[j];
          if (lv < ql - 1 || lv > ql + 1) continue;
          const float dx = __fsub_rn(qu, s_uv[j][0]);
          const float dy = __fsub_rn(qv, s_uv[j][1]);
          if (!(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= r2))
            continue;
        }
        best.push(hamming(q, s_desc[j]), base + j);
      }
    }
    __syncthreads();
  }
  if (i < nq) {
    out_idx[i] = best.idx;
    out_d1[i] = best.d1;
    out_d2[i] = best.d2;
  }
}

int blocks(int nq) { return (nq + kThreads - 1) / kThreads; }

}  // namespace

// Queries [Q] (desc [Q, 8] u32, uv [Q, 2] f32, radius [Q] f32, level [Q]
// i32, valid [Q] u8) against targets [M] -> idx, d1, d2 [Q] i32.
extern "C" int mam3_masked_match(const uint32_t* q_desc, const float* q_uv,
                                 const float* q_rad, const int* q_level,
                                 const uint8_t* q_valid, int nq,
                                 const uint32_t* t_desc, const float* t_uv,
                                 const int* t_level, const uint8_t* t_valid,
                                 int nt, int* idx, int* d1, int* d2,
                                 void* stream) {
  best2_kernel<true><<<blocks(nq), kThreads, 0, (cudaStream_t)stream>>>(
      q_desc, q_uv, q_rad, q_level, q_valid, nq, t_desc, t_uv, t_level,
      t_valid, nt, idx, d1, d2);
  return (int)cudaGetLastError();
}

// Every valid query against every valid target -> idx, d1, d2 [Q] i32.
extern "C" int mam3_min_hamming2(const uint32_t* q_desc,
                                 const uint8_t* q_valid, int nq,
                                 const uint32_t* t_desc,
                                 const uint8_t* t_valid, int nt, int* idx,
                                 int* d1, int* d2, void* stream) {
  best2_kernel<false><<<blocks(nq), kThreads, 0, (cudaStream_t)stream>>>(
      q_desc, nullptr, nullptr, nullptr, q_valid, nq, t_desc, nullptr,
      nullptr, t_valid, nt, idx, d1, d2);
  return (int)cudaGetLastError();
}
