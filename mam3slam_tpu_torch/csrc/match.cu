// Match kernels: masked and unmasked best-two Hamming search on packed
// 256-bit descriptors.
//
// Replace the Pallas TPU kernels mam3slam_tpu/ops/pallas_match.py:
// fused_masked_match (body _match_kernel) and min_hamming2 (body
// _minham2_kernel).  Plain PyTorch versions and semantics:
// mam3slam_tpu_torch/ops/cuda_match.py.  Both reproduce best_in_mask
// exactly: the lowest index wins ties, d2 is the best over the other
// targets (it may equal d1), and a query with no candidate gets
// (0, BIG, BIG).  Distances are exact integers (XOR + __popc over 8 u32
// words in the masked kernel, binary tensor-core products in the
// unmasked one), not the Pallas kernels' packed f32 keys / bf16 nibbles.
//
// masked_match_kernel (fused_masked_match).
// What bounds it on the H100: the callers pass Q = 4096 candidates
// (tracking, 2-3 launches a frame) or Q = 24576 arena points of which
// 10-17% are visible (the fuse, the server's Sim3 search) against the
// frame's M = 1024 features.  The least work is a level and radius test
// per (valid query, valid target) pair, ~8 ops (4.2 M pairs at Q = 4096:
// ~0.5 us at the f32 CUDA-core peak), and 8 XOR + 8 popc for the < 1% of
// pairs inside the mask; the inputs are 0.2-1.2 MB (0.1-0.4 us at
// 3.35 TB/s).  Either way the bound is under a microsecond: launch
// latency and filling the SMs decide the time.
// Design: one block of 1024 threads per SM at most (a persistent grid
// sized by the device's SM count), each block stages the whole target set in dynamic
// shared memory once: descriptors word-major, u32[8][M], so lanes reading
// neighbouring targets hit neighbouring banks, and one 16-byte record
// (u, v, level, valid) per target, so the mask test is one 128-bit shared
// load.  The staging repacks (transposes the descriptors, packs the
// records), so it uses plain 16-byte global loads rather than cp.async or
// a bulk TMA copy, which copy bytes as they are; at M = 1024 it is 48 KB
// a block.  Larger M is staged in passes of kMaxTile targets whose
// best-two results merge exactly.  The queries go in chunks of 32 to the
// blocks in turn (chunk c to block c mod grid), so that valid queries
// that sit together, as the visible points among recent arena slots do,
// spread over the blocks.  A block reads its chunks' valid flags (one a
// thread), compacts the valid queries in shared memory (a ballot per
// warp, a prefix over the warps), and its warps take one valid query each
// in turn: an invalid query costs one flag load.  A warp loads its query
// in one round trip (lanes 0-11 load the descriptor words, u, v, radius
// and level; shuffles share them).
// Lane l tests targets l, l + 32, ... in ascending order: the level window
// and the radius with __fmul_rn / __fadd_rn / __fsub_rn in the plain
// version's order (dx^2 + dy^2 <= r^2; an FMA would flip candidates that
// sit exactly on the radius), computed without branches so the shared
// loads of later targets issue early, then the Hamming distance of the
// survivors only.  Each lane keeps (d1, idx, d2); since its targets
// come in ascending order, d < d1 is the lexicographic (d, j) < (d1, idx).
// The lanes merge by a 5-step xor butterfly of
//   merge(a, b) = (b.d1, b.idx) < (a.d1, a.idx)
//                 ? (b.d1, b.idx, min(a.d1, b.d2))
//                 : (a.d1, a.idx, min(a.d2, b.d1)),
// which is exact whatever the order of the merge: an empty lane holds
// (BIG, INT_MAX, BIG), and idx = 0 where d1 == BIG at the end.  No binary
// tensor cores here: < 1% of pairs pass the mask.
//
// best2_mma_kernel (min_hamming2).
// What bounds it on the H100: every (valid query, valid target) pair,
// 1024 x 1024 at the callers: as a binary tensor-core product 2 x 256 bit
// operations a pair, 0.27 us at the int8 tensor-core rate; 64 KB of
// descriptors in.  Launch latency and how many SMs take part decide the
// time, so the grid is one block per 16 queries (64 blocks at Q = 1024).
// Design: the distances come from the binary tensor cores,
// mma.sync.m16n8k256.row.col.s32.b1.b1.s32.and.popc, which gives
// popc(a & b) for a 16-query x 8-target tile.  Since
// popc(a ^ b) = popc(a & ~b) + popc(~a & b), two chained products, the
// second accumulating onto the first, leave the exact Hamming distance in
// the accumulator: no row or column popcount is needed.  The packed
// descriptor is the fragment layout as it is: lane l holds two words of
// rows l/4 and l/4 + 8 (A) and of target l/4 (B), and since A and B take
// the same words in the same places, and one bit order inside a word,
// the sum over k is the popcount over all 256 bits; so no repacking.
// B fragments are loaded straight from global memory (L2), not staged in
// shared memory: with one 16-query tile per block no target is read
// twice in a block, so a stage would buy no reuse (and, as [n][8] words,
// a two-way bank conflict on the fragment loads); one 8-byte load per
// lane covers the tile's 256 contiguous bytes exactly.  Warp w of a
// block of 16 warps takes the 8-target tiles w, w + 16, w + 32, ... in
// ascending order, in chunks of 8 tiles whose loads all go out before
// the first product (one L2 round trip per chunk, not per tile; one
// chunk at M = 1024); the accumulator gives lane l rows l/4 and l/4 + 8
// and columns 2(l%4) and 2(l%4) + 1 of each tile, so each lane sees its
// columns in ascending index and the strict-less update keeps the
// lexicographic (d, idx) order.  Invalid and out-of-range targets count
// as BIG.  The 4 lanes of a row merge by a 2-step xor butterfly of
// merge_best2, the 16 warps through shared memory, in any order (the
// merge is exact).  cuda_match.best_two_mma replays this reduction on
// the CPU.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 20;

// ---------------------------------------------------------------------------
// masked_match_kernel
// ---------------------------------------------------------------------------

constexpr int kMatchThreads = 1024;
constexpr int kMatchWarps = kMatchThreads / 32;
constexpr int kMaxTile = 2048;  // targets per pass: 96 KB of shared memory

struct __align__(16) TargetRec {
  float u, v;
  int level, valid;
};

constexpr size_t kBytesPerTarget = sizeof(TargetRec) + 8 * sizeof(uint32_t);

// (d1, idx, d2) <- merge((d1, idx, d2), (od1, oidx, od2)); symmetric.
__device__ __forceinline__ void merge_best2(int& d1, int& idx, int& d2,
                                            int od1, int oidx, int od2) {
  if (od1 < d1 || (od1 == d1 && oidx < idx)) {
    d2 = min(d1, od2);
    d1 = od1;
    idx = oidx;
  } else {
    d2 = min(d2, od1);
  }
}

// One lane's best two: targets come in ascending index, so d < d1 is the
// lexicographic (d, j) < (d1, idx).
__device__ __forceinline__ void push_best2(int& d1, int& idx, int& d2, int d,
                                           int j) {
  if (d < d1) {
    d2 = d1;
    d1 = d;
    idx = j;
  } else {
    d2 = min(d2, d);
  }
}

// One query against the staged targets [base, base + n): lanes 0-7 hold
// its descriptor words, lanes 8-11 its u, v, radius and level, loaded in
// one round trip and shared by shuffles; returns the warp's (d1, idx, d2)
// in every lane.
__device__ __forceinline__ void scan_query(
    int i, int lane, const uint32_t* __restrict__ q_desc,
    const float* __restrict__ q_uv, const float* __restrict__ q_rad,
    const int* __restrict__ q_level, const TargetRec* s_rec,
    const uint32_t* s_desc, int tile, int base, int n, int& d1, int& idx,
    int& d2) {
  uint32_t mine = 0u;
  if (lane < 8) mine = q_desc[8 * i + lane];
  else if (lane < 10) mine = __float_as_uint(q_uv[2 * i + lane - 8]);
  else if (lane == 10) mine = __float_as_uint(q_rad[i]);
  else if (lane == 11) mine = (uint32_t)q_level[i];
  uint32_t q[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) q[k] = __shfl_sync(0xffffffffu, mine, k);
  const float qu = __uint_as_float(__shfl_sync(0xffffffffu, mine, 8));
  const float qv = __uint_as_float(__shfl_sync(0xffffffffu, mine, 9));
  const float rad = __uint_as_float(__shfl_sync(0xffffffffu, mine, 10));
  const int ql = (int)__shfl_sync(0xffffffffu, mine, 11);
  const float r2 = __fmul_rn(rad, rad);
  d1 = kBig;
  idx = INT_MAX;
  d2 = kBig;
#pragma unroll 4
  for (int e = lane; e < n; e += 32) {
    const TargetRec t = s_rec[e];
    const float dx = __fsub_rn(qu, t.u);
    const float dy = __fsub_rn(qv, t.v);
    // level in [ql - 1, ql + 1] as one unsigned compare
    const bool in = t.valid && (unsigned)(t.level - ql + 1) <= 2u &&
                    __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= r2;
    if (in) {
      int d = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) d += __popc(q[k] ^ s_desc[k * tile + e]);
      push_best2(d1, idx, d2, d, base + e);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int od1 = __shfl_xor_sync(0xffffffffu, d1, o);
    const int oidx = __shfl_xor_sync(0xffffffffu, idx, o);
    const int od2 = __shfl_xor_sync(0xffffffffu, d2, o);
    merge_best2(d1, idx, d2, od1, oidx, od2);
  }
}

__global__ void __launch_bounds__(kMatchThreads)
masked_match_kernel(const uint32_t* __restrict__ q_desc,
                    const float* __restrict__ q_uv,
                    const float* __restrict__ q_rad,
                    const int* __restrict__ q_level,
                    const uint8_t* __restrict__ q_valid, int nq,
                    const uint32_t* __restrict__ t_desc,
                    const float* __restrict__ t_uv,
                    const int* __restrict__ t_level,
                    const uint8_t* __restrict__ t_valid, int nt, int tile,
                    int* __restrict__ out_idx, int* __restrict__ out_d1,
                    int* __restrict__ out_d2) {
  extern __shared__ __align__(16) unsigned char smem[];
  TargetRec* s_rec = reinterpret_cast<TargetRec*>(smem);
  uint32_t* s_desc = reinterpret_cast<uint32_t*>(s_rec + tile);  // [8][tile]
  __shared__ int s_list[kMatchThreads];  // this round's valid queries
  __shared__ int s_warp_count[kMatchWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // queries in chunks of 32, dealt to the blocks in turn: valid queries
  // that sit together (recent arena slots) spread over the blocks
  const int n_chunks = (nq + 31) / 32;

  for (int base = 0; base < max(nt, 1); base += tile) {
    const int n = max(0, min(tile, nt - base));
    for (int e = threadIdx.x; e < n; e += kMatchThreads) {
      const int j = base + e;
      TargetRec r;
      r.u = t_uv[2 * j];
      r.v = t_uv[2 * j + 1];
      r.level = t_level[j];
      r.valid = t_valid[j];
      s_rec[e] = r;
    }
    // each 16-byte chunk is half a descriptor: words 4h..4h+3 of target e
    const uint4* t_chunks = reinterpret_cast<const uint4*>(t_desc) + 2 * base;
    for (int c = threadIdx.x; c < 2 * n; c += kMatchThreads) {
      const uint4 w = t_chunks[c];
      const int e = c >> 1, k = (c & 1) * 4;
      s_desc[(k + 0) * tile + e] = w.x;
      s_desc[(k + 1) * tile + e] = w.y;
      s_desc[(k + 2) * tile + e] = w.z;
      s_desc[(k + 3) * tile + e] = w.w;
    }

    // rounds of one chunk a warp: one valid flag a thread, the valid
    // queries compacted into s_list, then one warp a valid query
    for (int r0 = blockIdx.x; r0 < n_chunks; r0 += gridDim.x * kMatchWarps) {
      const int chunk = r0 + warp * gridDim.x;
      const int i = chunk * 32 + lane;
      const bool in = chunk < n_chunks && i < nq;
      const bool live = in && q_valid[i];
      if (base == 0 && in && !live) {
        out_idx[i] = 0;
        out_d1[i] = kBig;
        out_d2[i] = kBig;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, live);
      if (lane == 0) s_warp_count[warp] = __popc(ballot);
      __syncthreads();  // also: the staged targets are in place
      int offset = 0, total = 0;
      for (int w = 0; w < kMatchWarps; ++w) {
        const int c = s_warp_count[w];
        offset += w < warp ? c : 0;
        total += c;
      }
      if (live) s_list[offset + __popc(ballot & ((1u << lane) - 1u))] = i;
      __syncthreads();
      for (int k = warp; k < total; k += kMatchWarps) {
        const int qi = s_list[k];
        int d1, idx, d2;
        scan_query(qi, lane, q_desc, q_uv, q_rad, q_level, s_rec, s_desc,
                   tile, base, n, d1, idx, d2);
        if (lane == 0) {
          if (base)
            merge_best2(d1, idx, d2, out_d1[qi], out_idx[qi], out_d2[qi]);
          out_idx[qi] = d1 == kBig ? 0 : idx;
          out_d1[qi] = d1;
          out_d2[qi] = d2;
        }
      }
      __syncthreads();  // s_list and s_warp_count are reused
    }
  }
}

// ---------------------------------------------------------------------------
// best2_mma_kernel
// ---------------------------------------------------------------------------

constexpr int kRows = 16;        // queries per block: one m16 tile
constexpr int kB2Warps = 16;     // target slices per block
constexpr int kB2Threads = 32 * kB2Warps;
constexpr int kChunk = 8;        // tiles a warp loads before it multiplies

// d += popc(a & b) over the 16 x 8 tile (fragments in the PTX layout of
// mma.m16n8k256 .b1: a 16 x 256 row-major, b 256 x 8 column-major).
__device__ __forceinline__ void mma_and_popc(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kB2Threads)
best2_mma_kernel(const uint32_t* __restrict__ q_desc,
                 const uint8_t* __restrict__ q_valid, int nq,
                 const uint32_t* __restrict__ t_desc,
                 const uint8_t* __restrict__ t_valid, int nt,
                 int* __restrict__ out_idx, int* __restrict__ out_d1,
                 int* __restrict__ out_d2) {
  __shared__ int s_best[kB2Warps][kRows][3];  // (d1, idx, d2) per warp, row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row / column group
  const int row0 = blockIdx.x * kRows;

  // A = the 16 queries, and ~A.  The fragment takes from lane l two
  // 32-bit words of each of its rows as its two k-halves; lane l gives
  // words 2(l%4) and 2(l%4) + 1 (one 8-byte load), and B below gives the
  // same words of its target in the same places, so the sum over k is the
  // popcount over all 256 bits.  Rows past nq are zero (not written).
  const uint2* q2 = reinterpret_cast<const uint2*>(q_desc);  // [nq][4]
  const uint2* t2 = reinterpret_cast<const uint2*>(t_desc);  // [nt][4]
  const int r_lo = row0 + g, r_hi = row0 + g + 8;
  const uint2 lo = r_lo < nq ? q2[4 * r_lo + t] : make_uint2(0u, 0u);
  const uint2 hi = r_hi < nq ? q2[4 * r_hi + t] : make_uint2(0u, 0u);
  const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
  const uint32_t na[4] = {~lo.x, ~hi.x, ~lo.y, ~hi.y};

  // (d1, idx, d2) of rows g and g + 8 over this lane's columns
  int d1[2] = {kBig, kBig}, idx[2] = {INT_MAX, INT_MAX}, d2[2] = {kBig, kBig};
  const int n_tiles = (nt + 7) >> 3;
  for (int tile0 = warp; tile0 < n_tiles; tile0 += kChunk * kB2Warps) {
    // the chunk's fragments and valid flags, all loads issued at once
    uint2 b[kChunk];
    uint32_t valid = 0u;                  // bit 2c + e: column j0(c) + e
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int tile = tile0 + c * kB2Warps;
      const int tg = 8 * tile + g;        // the target this lane loads
      b[c] = tg < nt ? t2[4 * tg + t] : make_uint2(0u, 0u);
      const int j0 = 8 * tile + 2 * t;    // this lane's two columns
      valid |= (uint32_t)(j0 < nt && t_valid[j0]) << (2 * c);
      valid |= (uint32_t)(j0 + 1 < nt && t_valid[j0 + 1]) << (2 * c + 1);
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (tile0 + c * kB2Warps >= n_tiles) break;  // the same in the warp
      const int j0 = 8 * (tile0 + c * kB2Warps) + 2 * t;
      int acc[4] = {0, 0, 0, 0};
      mma_and_popc(acc, a, ~b[c].x, ~b[c].y);  // popc(a & ~b)
      mma_and_popc(acc, na, b[c].x, b[c].y);   // + popc(~a & b)
#pragma unroll
      for (int h = 0; h < 2; ++h) {            // rows g, g + 8
        push_best2(d1[h], idx[h], d2[h],
                   valid >> (2 * c) & 1u ? acc[2 * h] : kBig, j0);
        push_best2(d1[h], idx[h], d2[h],
                   valid >> (2 * c + 1) & 1u ? acc[2 * h + 1] : kBig, j0 + 1);
      }
    }
  }

  // the 4 lanes of a row, then the warps
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const int od1 = __shfl_xor_sync(0xffffffffu, d1[h], o);
      const int oidx = __shfl_xor_sync(0xffffffffu, idx[h], o);
      const int od2 = __shfl_xor_sync(0xffffffffu, d2[h], o);
      merge_best2(d1[h], idx[h], d2[h], od1, oidx, od2);
    }
    if (t == 0) {
      s_best[warp][g + 8 * h][0] = d1[h];
      s_best[warp][g + 8 * h][1] = idx[h];
      s_best[warp][g + 8 * h][2] = d2[h];
    }
  }
  __syncthreads();
  const int r = row0 + threadIdx.x;
  if (threadIdx.x < kRows && r < nq) {
    int m1 = s_best[0][threadIdx.x][0], mi = s_best[0][threadIdx.x][1],
        m2 = s_best[0][threadIdx.x][2];
    for (int w = 1; w < kB2Warps; ++w)
      merge_best2(m1, mi, m2, s_best[w][threadIdx.x][0],
                  s_best[w][threadIdx.x][1], s_best[w][threadIdx.x][2]);
    const bool live = q_valid[r];  // an invalid query: (0, BIG, BIG)
    out_idx[r] = live && m1 < kBig ? mi : 0;
    out_d1[r] = live ? m1 : kBig;
    out_d2[r] = live ? m2 : kBig;
  }
}

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
  // on the current device: the SM count that sizes the persistent grid,
  // and the dynamic shared memory the kernel may take
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(masked_match_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(kMaxTile * kBytesPerTarget));
  if (err != cudaSuccess) return (int)err;
  const int tile = max(1, min(nt, kMaxTile));
  const int blocks = max(1, min(sms, (nq + kMatchWarps - 1) / kMatchWarps));
  masked_match_kernel<<<blocks, kMatchThreads, tile * kBytesPerTarget,
                        (cudaStream_t)stream>>>(
      q_desc, q_uv, q_rad, q_level, q_valid, nq, t_desc, t_uv, t_level,
      t_valid, nt, tile, idx, d1, d2);
  return (int)cudaGetLastError();
}

// Every valid query against every valid target -> idx, d1, d2 [Q] i32.
extern "C" int mam3_min_hamming2(const uint32_t* q_desc,
                                 const uint8_t* q_valid, int nq,
                                 const uint32_t* t_desc,
                                 const uint8_t* t_valid, int nt, int* idx,
                                 int* d1, int* d2, void* stream) {
  best2_mma_kernel<<<(nq + kRows - 1) / kRows, kB2Threads, 0,
                     (cudaStream_t)stream>>>(q_desc, q_valid, nq, t_desc,
                                             t_valid, nt, idx, d1, d2);
  return (int)cudaGetLastError();
}
