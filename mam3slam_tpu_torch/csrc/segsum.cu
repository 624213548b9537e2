// Segment sum in a fixed order: out[key[s], c] = the sum of
// vals[perm[r], c] over the sorted positions r in [start[s], end[s]);
// every other element of out is 0.
//
// Replaces no Pallas kernel: the reference's solvers reduce per-edge rows
// onto vertices with one-hot matmuls (mam3slam_tpu/solvers/ba_window.py)
// and XLA scatters, whose order is fixed on the CPU.  On the card an
// index_add_ sums duplicate indices with atomics in an order that changes
// from run to run; this kernel takes one order whatever the grid, the
// stream or the timing.  Plain PyTorch version and semantics:
// mam3slam_tpu_torch/ops/segsum.py:segment_sum_plain (bit for bit).
//
// What bounds it on the H100: bytes.  It reads each kept row once (C
// values and its sorted index) and writes every element of out once; a
// few adds per value.  The callers' outputs run from a few KB (camera
// sums) to 905 MB (the global BA's (point, slot) sums at the arena caps,
// nearly all zero), so the write of out is most of the bound where out is
// large, and the gathered reads of a few long segments where it is small.
//
// Design: one launch, two kinds of blocks, and every output element has
// exactly one writer (no atomics, no value added across blocks).
//  * Row-range blocks (the last n_fill blocks) each own a tile of up to
//    kTileBytes of the flattened [n_out, C] output.  A block finds the
//    segments whose keys fall in its rows from the plan's row index
//    (row_seg) and, where a row starts no index group, one block-wide
//    search step over the ascending keys; a tile no segment lands in is
//    written as zeros at once.  Otherwise the block sums each short
//    segment (<= kShort rows) with one thread per (segment, column),
//    builds its tile in shared memory with zeros where no segment lands,
//    and writes it out with 16-byte stores.  Elements of a longer segment
//    are flagged and left to the work blocks.
//  * Work blocks (the first n_work blocks) walk the plan's list of longer
//    segments: a segment of kShort < n <= kLong rows is one warp's item
//    per kCols columns, a segment of more than kLong rows one block's.
//    Their count is fixed from the plan's sizes on the host (no host
//    read of the data); a block with nothing to do returns at once.
// The order of a segment's sum depends on its length alone:
//  * n <= kLong: lane l of 32 adds rows l, l + 32, ... from 0, then the
//    lanes fold x[l] + x[l + off] for off = 16, 8, 4, 2, 1.  A warp does
//    it with an xor butterfly (lane l adds lane l ^ off; IEEE addition
//    commutes, so every lane holds the same bits); a thread does it for
//    n <= kShort over the least power of two W >= n lanes (each lane
//    holds at most one row, the lanes past n hold 0, and adding an exact
//    0 to a lane sum, which is never -0, changes no bit).
//  * n > kLong: thread t of kThreads adds rows t, t + kThreads, ... from
//    0; each warp folds its lanes as above; the kWarps warp sums fold
//    w + off for off = 4, 2, 1 in shared memory.
// Sums are carried in double and rounded once to the output's type, so a
// f32 segment sum is the correctly rounded sum of its rows unless that
// lies within ~1e-9 of a rounding boundary.  Every add is __dadd_rn, so
// nvcc neither contracts nor drops one (0 + -0 must stay +0).  The
// segments come from a stable sort of the index (segment_plan), built once
// per solve, so the rows of a segment keep their original order.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kShort = 4;          // ops/segsum.py: SHORT
constexpr int kLong = 256;         // ops/segsum.py: LONG
constexpr int kCols = 4;           // columns of a warp's or a block's item
constexpr int kBatch = 4;          // rows a thread loads before adding them
constexpr int kItems = 2;          // (segment, column) items a thread loads
constexpr int kTileBytes = 32768;  // the most a row-range tile holds
constexpr int kMinTile = 256;      // elements: the least a tile holds
constexpr int kFillPerSm = 4;      // row-range tiles an SM at least
constexpr int kWorkPerSm = 4;      // work blocks an SM at most

__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}

// The 32-lane order for n <= W <= kShort rows, one row a lane.
template <int W, typename T>
__device__ __forceinline__ double tree_sum(const T* __restrict__ vals,
                                           const int* __restrict__ rows,
                                           int n, int C, int c) {
  double x[W];
#pragma unroll
  for (int l = 0; l < W; ++l)
    x[l] = l < n ? add(0.0, (double)vals[(size_t)rows[l] * C + c]) : 0.0;
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int l = 0; l < off; ++l) x[l] = add(x[l], x[l + off]);
  }
  return x[0];
}

template <typename T>
__device__ double short_sum(const T* vals, const int* rows, int n, int C,
                            int c) {
  static_assert(kShort == 4, "short_sum covers up to 4 rows");
  return n <= 2 ? tree_sum<2>(vals, rows, n, C, c)
                : tree_sum<4>(vals, rows, n, C, c);
}

// Rows [a, b) of columns [c0, c0 + nc) summed by this thread, `step`
// rows apart from row a + first, into acc (from 0), then folded across
// the warp (xor 16 .. 1).  The rows go in batches of kBatch: a batch's
// sorted indices load first, then all of its values, then the adds in
// row order.
template <typename T>
__device__ __forceinline__ void lane_sums(const T* __restrict__ vals,
                                          const int* __restrict__ perm,
                                          int a, int b, int first, int step,
                                          int C, int c0, int nc,
                                          double (&acc)[kCols]) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.0;
  for (int r0 = a + first; r0 < b; r0 += kBatch * step) {
    int row[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      row[k] = r0 + k * step < b ? perm[r0 + k * step] : -1;
    T v[kBatch][kCols];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        v[k][c] = row[k] >= 0 && c < nc
                      ? vals[(size_t)row[k] * C + c0 + c] : T(0);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (row[k] < 0) break;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = add(acc[c], (double)v[k][c]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      acc[c] = add(acc[c], __shfl_xor_sync(0xffffffffu, acc[c], off));
  }
}

// True while segment s lies before output row r (the used segments come
// first with ascending keys; the empty ones after them have key -1).
__device__ __forceinline__ bool before(const int* key, int s, int r) {
  const int k = key[s];
  return k >= 0 && k < r;
}

// A block-wide search for the first segment in [lo, hi] not before row
// r (the answer is hi where all of [lo, hi) lie before r), for two rows
// at once: each step cuts [lo, hi) into kThreads buckets, thread t
// probes the last position of bucket t, and the count of probes still
// before r picks the bucket, so a range of at most kThreads takes one
// step.  A step's probes for both rows are loaded before its barriers.
// Block-uniform.
__device__ __forceinline__ void search(const int* key, int ra, int& lo_a,
                                       int& hi_a, int rb, int& lo_b,
                                       int& hi_b) {
  const int t = threadIdx.x;
  while (hi_a > lo_a || hi_b > lo_b) {
    const int ba = (hi_a - lo_a + kThreads - 1) / kThreads;
    const int bb = (hi_b - lo_b + kThreads - 1) / kThreads;
    const int pa = lo_a + (t + 1) * ba - 1, pb = lo_b + (t + 1) * bb - 1;
    const bool fa = ba > 0 && pa < hi_a && before(key, pa, ra);
    const bool fb = bb > 0 && pb < hi_b && before(key, pb, rb);
    const int na = __syncthreads_count(fa);
    const int nb = __syncthreads_count(fb);
    if (ba > 0) {
      hi_a = min(hi_a, lo_a + (na + 1) * ba - 1);
      lo_a += na * ba;
    }
    if (bb > 0) {
      hi_b = min(hi_b, lo_b + (nb + 1) * bb - 1);
      lo_b += nb * bb;
    }
  }
}

// Elements [e0, e0 + te) of the flattened output (fewer at its end).
// row_seg[g] is the first segment whose row is g * group or later, so a
// row's first segment is row_seg's entry where the row starts a group,
// else one search step among the group's segments away.
template <typename T>
__device__ void fill_block(const T* __restrict__ vals, int C,
                           const int* __restrict__ perm,
                           const int* __restrict__ start,
                           const int* __restrict__ end,
                           const int* __restrict__ key,
                           const int* __restrict__ row_seg, int group,
                           int te, long long e0, long long total,
                           T* __restrict__ out) {
  constexpr int kTile = kTileBytes / sizeof(T);
  constexpr int kVec = 16 / sizeof(T);
  __shared__ __align__(16) T tile[kTile];
  __shared__ unsigned skip[kTile / 32];  // elements of a longer segment
  const int t = threadIdx.x;
  const int n = (int)min((long long)te, total - e0);
  // the segments of rows [r0, r1): [lo, hi)
  const int r0 = (int)(e0 / C), r1 = (int)((e0 + n - 1) / C) + 1;
  int lo = row_seg[r0 / group], hi_a = row_seg[r0 / group + 1];
  int lo_b = row_seg[r1 / group], hi = row_seg[r1 / group + 1];
  T* o = out + e0;
  const bool vec = ((uintptr_t)o & 15) == 0;
  if (lo < hi) {
    if (r0 % group == 0) hi_a = lo;
    if (r1 % group == 0) hi = lo_b;
    search(key, r0, lo, hi_a, r1, lo_b, hi);
    hi = lo_b;
  }
  if (hi <= lo && vec) {  // no segment lands here: zeros straight out
    for (int i = t * kVec; i < n; i += kThreads * kVec) {
      if (i + kVec <= n)
        *reinterpret_cast<uint4*>(o + i) = make_uint4(0u, 0u, 0u, 0u);
      else
        for (int v = 0; i + v < n; ++v) o[i + v] = T(0);
    }
    return;
  }
  for (int i = t * kVec; i < n; i += kThreads * kVec)
    *reinterpret_cast<uint4*>(tile + i) = make_uint4(0u, 0u, 0u, 0u);
  for (int i = t; i < te / 32; i += kThreads) skip[i] = 0u;
  __syncthreads();
  // one thread per (segment, column), kItems at a time: their segments'
  // bounds load together, then the rows of the one-row segments, then
  // their values
  const int items = (hi - lo) * C;
  for (int j0 = t; j0 < items; j0 += kThreads * kItems) {
    int a[kItems], len[kItems], c[kItems], e[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int j = j0 + u * kThreads;
      len[u] = 0;
      if (j < items) {
        const int q = j / C, s = lo + q;
        c[u] = j - q * C;
        const long long ej = (long long)key[s] * C + c[u] - e0;
        a[u] = start[s];
        len[u] = ej >= 0 && ej < n ? end[s] - a[u] : 0;
        e[u] = (int)ej;
      }
    }
    int row[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) row[u] = len[u] == 1 ? perm[a[u]] : 0;
    T v[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u)
      v[u] = len[u] == 1 ? vals[(size_t)row[u] * C + c[u]] : T(0);
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      if (len[u] == 1)
        tile[e[u]] = (T)add(0.0, (double)v[u]);
      else if (len[u] > kShort)
        atomicOr(&skip[e[u] >> 5], 1u << (e[u] & 31));
      else if (len[u] > 1)
        tile[e[u]] = (T)short_sum(vals, perm + a[u], len[u], C, c[u]);
    }
  }
  __syncthreads();
  for (int i = t * kVec; i < n; i += kThreads * kVec) {
    const unsigned bits = (skip[i >> 5] >> (i & 31)) & ((1u << kVec) - 1);
    if (vec && i + kVec <= n && bits == 0) {
      *reinterpret_cast<uint4*>(o + i) =
          *reinterpret_cast<const uint4*>(tile + i);
    } else {
      for (int v = 0; v < kVec && i + v < n; ++v)
        if (!(bits >> v & 1u)) o[i + v] = tile[i + v];
    }
  }
}

// The plan's segments of more than kShort rows: work[0, n_med) hold
// kShort < n <= kLong rows, a warp's item per kCols columns;
// work[n_med, n_med + n_long) more than kLong, a block's item.
template <typename T>
__device__ void work_block(const T* __restrict__ vals, int C, int S,
                           const int* __restrict__ perm,
                           const int* __restrict__ start,
                           const int* __restrict__ end,
                           const int* __restrict__ key,
                           const int* __restrict__ work,
                           const int* __restrict__ counts, int n_work,
                           T* __restrict__ out) {
  __shared__ double part[kWarps][kCols];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nch = (C + kCols - 1) / kCols;
  double acc[kCols];
  // a medium item's segment loads before the counts say it is one
  const long long step = (long long)n_work * kWarps;
  long long j = (long long)blockIdx.x * kWarps + warp;
  int s = j / nch < S ? work[j / nch] : 0;
  const int n_med = counts[0], n_long = counts[1];
  for (; j < (long long)n_med * nch;
       j += step, s = j / nch < S ? work[j / nch] : 0) {
    const int c0 = (int)(j % nch) * kCols, nc = min(kCols, C - c0);
    lane_sums(vals, perm, start[s], end[s], lane, 32, C, c0, nc, acc);
    T* o = out + (size_t)key[s] * C + c0;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (c < nc && lane == c) o[c] = (T)acc[c];
  }
  for (long long i = blockIdx.x; i < (long long)n_long * nch; i += n_work) {
    s = work[n_med + i / nch];
    const int c0 = (int)(i % nch) * kCols, nc = min(kCols, C - c0);
    lane_sums(vals, perm, start[s], end[s], t, kThreads, C, c0, nc, acc);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) part[warp][c] = acc[c];
    }
    __syncthreads();
    if (t < nc) {
      double x[kWarps];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) x[w] = part[w][t];
#pragma unroll
      for (int off = kWarps / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int w = 0; w < off; ++w) x[w] = add(x[w], x[w + off]);
      }
      out[(size_t)key[s] * C + c0 + t] = (T)x[0];
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segsum_kernel(const T* __restrict__ vals, int C,
              const int* __restrict__ perm, const int* __restrict__ start,
              const int* __restrict__ end, const int* __restrict__ key,
              int S, const int* __restrict__ work,
              const int* __restrict__ counts,
              const int* __restrict__ row_seg, int group, int n_work,
              int te, long long total, T* __restrict__ out) {
  if ((int)blockIdx.x < n_work)
    work_block(vals, C, S, perm, start, end, key, work, counts, n_work, out);
  else
    fill_block(vals, C, perm, start, end, key, row_seg, group, te,
               (long long)(blockIdx.x - n_work) * te, total, out);
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

template <typename T>
int launch(const void* vals, int C, int E, const int* perm, const int* start,
           const int* end, const int* key, int S, const int* work,
           const int* counts, const int* row_seg, int group, int n_out,
           void* out, cudaStream_t stream) {
  using ll = long long;
  const ll total = (ll)n_out * C;
  const ll sms = sm_count();
  // a tile: the largest power of two of elements in [kMinTile, kTile]
  // that leaves kFillPerSm tiles an SM
  const ll most = kTileBytes / sizeof(T);
  ll te = kMinTile;
  while (2 * te <= most && 2 * te * kFillPerSm * sms <= total) te *= 2;
  const ll n_fill = (total + te - 1) / te;
  // work blocks: the most items the plan's sizes allow (segments of more
  // than kShort rows, a warp each per kCols columns; of more than kLong,
  // a block), kWorkPerSm an SM at most
  const ll nch = (C + kCols - 1) / kCols;
  const ll most_long = std::min<ll>(S, E / (kLong + 1));
  const ll most_med = std::min<ll>(S, E / (kShort + 1));
  const ll n_work = std::min<ll>(
      std::max(most_long * nch, (most_med * nch + kWarps - 1) / kWarps),
      kWorkPerSm * sms);
  segsum_kernel<T><<<(unsigned)(n_work + n_fill), kThreads, 0, stream>>>(
      static_cast<const T*>(vals), C, perm, start, end, key, S, work, counts,
      row_seg, group, (int)n_work, (int)te, total, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// vals [E, C] (f32, or f64 when is_f64), perm [E], start / end / key /
// work [S], counts [2] and row_seg [n_out / group + 2] int32
// (ops/segsum.py:SegmentPlan), out [n_out, C] uninitialised: the kernel
// writes every element.  Returns cudaGetLastError() after the launch.
extern "C" int mam3_segsum(const void* vals, int is_f64, int C, int E,
                           const int* perm, const int* start, const int* end,
                           const int* key, int S, const int* work,
                           const int* counts, const int* row_seg, int group,
                           int n_out, void* out, void* stream) {
  if (n_out <= 0 || C <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return is_f64 ? launch<double>(vals, C, E, perm, start, end, key, S, work,
                                 counts, row_seg, group, n_out, out, st)
                : launch<float>(vals, C, E, perm, start, end, key, S, work,
                                counts, row_seg, group, n_out, out, st);
}
