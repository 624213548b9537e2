// Segment sum in a fixed order: out[key[s], c] = the sum of
// vals[perm[r], c] over the sorted positions r in [start[s], end[s]).
//
// Replaces no Pallas kernel: the reference's solvers reduce per-edge rows
// onto vertices with one-hot matmuls (mam3slam_tpu/solvers/ba_window.py)
// and XLA scatters, whose order is fixed on the CPU.  On the card an
// index_add_ sums duplicate indices with atomics in an order that changes
// from run to run; this kernel takes one order whatever the grid, the
// stream or the timing.  Plain PyTorch version and semantics:
// mam3slam_tpu_torch/ops/segsum.py:segment_sum_plain (bit for bit).
//
// What bounds it on the H100: it reads each kept row once (C values) and
// its index, and writes each output row once; a few adds per value.  At
// the global BA's caps (E = 24576 x 16 edges of 27 values) that is 42 MB,
// ~13 us of HBM bandwidth, so bytes bound it.
//
// Design: one warp per (segment, block of kCols columns), 8 warps a
// block, the grid over every (segment, block).  Lane l walks the
// segment's sorted rows l, l + 32, l + 64, ... in turn, keeping kCols
// running sums from 0 in registers (the loads of a row are kCols
// consecutive values); then an xor butterfly over offsets 16, 8, 4, 2, 1
// folds the lanes.  Each step adds lane l and lane l ^ off, so after it
// lane l < off holds x[l] + x[l + off], the plain version's
// x[:off] + x[off:2 off]; IEEE addition is commutative, so every lane
// holds the same bits and lane c stores column c.  No value is added
// across warps or blocks and no atomics are used, so the result depends
// on the plan alone.  The sums are carried in double and rounded once
// to the output's type: a f32 segment sum is then the correctly rounded
// sum of its rows unless that lies within ~1e-9 of a rounding boundary,
// so another layout of the lanes or columns (a faster kernel) gives the
// same bits almost everywhere; f64 has no headroom and keeps the order's
// rounding.  Adds only, so nvcc has no product to contract into an FMA.
// The segments come from a stable sort of the index (segment_plan),
// built once per solve, so the rows of a segment keep their original
// order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
segsum_kernel(const T* __restrict__ vals, int C, int n_blk,
              const int* __restrict__ perm, const int* __restrict__ start,
              const int* __restrict__ end, const int* __restrict__ key,
              long long n_work, T* __restrict__ out) {
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= n_work) return;
  const int lane = threadIdx.x & 31;
  const int seg = (int)(w / n_blk);
  const int c0 = (int)(w % n_blk) * kCols;
  const int s0 = start[seg], s1 = end[seg];
  if (s0 >= s1) return;  // the same for the whole warp
  const int nc = min(kCols, C - c0);
  double acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.0;
  // unrolled so that the loads of four rows issue before their adds,
  // which stay in row order
#pragma unroll 4
  for (int r = s0 + lane; r < s1; r += 32) {
    const T* v = vals + (size_t)perm[r] * C + c0;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (c < nc) acc[c] += (double)v[c];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
  }
  T* o = out + (size_t)key[seg] * C + c0;
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (c < nc && lane == c) o[c] = (T)acc[c];
}

template <typename T>
int launch(const void* vals, int C, const int* perm, const int* start,
           const int* end, const int* key, int S, void* out,
           cudaStream_t stream) {
  const int n_blk = (C + kCols - 1) / kCols;
  const long long n_work = (long long)S * n_blk;
  const long long blocks = (n_work + kWarps - 1) / kWarps;
  segsum_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(vals), C, n_blk, perm, start, end, key, n_work,
      static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// vals [E, C] (f32, or f64 when is_f64), perm [E], start / end / key [S]
// int32, out [n_out, C] zeroed by the caller (rows no segment writes
// stay 0).  Returns cudaGetLastError() after the launch.
extern "C" int mam3_segsum(const void* vals, int is_f64, int C,
                           const int* perm, const int* start, const int* end,
                           const int* key, int S, void* out, void* stream) {
  if (S <= 0 || C <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return is_f64 ? launch<double>(vals, C, perm, start, end, key, S, out, st)
                : launch<float>(vals, C, perm, start, end, key, S, out, st);
}
