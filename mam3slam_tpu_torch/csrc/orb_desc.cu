// Describe kernel: IC orientation + 256-bit rBRIEF, one warp per keypoint.
//
// Replaces the Pallas TPU kernel mam3slam_tpu/ops/pallas_orb_desc.py:
// ic_brief_fused (body _kernel).  Plain PyTorch version and semantics:
// mam3slam_tpu_torch/ops/cuda_orb_desc.py:ic_brief_plain.
//
// What bounds it on the H100: per keypoint it reads ~700 raw pixels for
// the moments and 512 blurred taps, ~5 KB scattered around one point of a
// [L, Hp, Wp] f32 stack (the EuRoC stack is 11.5 MB, so it sits in the
// 50 MB L2 after the blur writes it).  With N = 1000 keypoints the work
// is ~5 MB of L2 reads and a few hundred thousand flops: the latency of
// the dependent gathers and of one launch bounds it, not bandwidth or
// math.  So the design keeps every phase inside one warp, with no
// barrier, and issues each phase's loads all at once.
//
// Design: 8 warps per block, one warp per keypoint (grid over N / 8).
// The pattern's 8 int4 of a lane load first (they do not depend on the
// angle).  Moments: lane l takes column dx = l - 15 (lane 31 idles) and
// walks the 31 rows dy = -15..15 of the r=15 circle: each row is one
// coalesced load of 32 consecutive f32, clamped to the stack's (Hp, Wp),
// all 31 issued before the first is used, and the circle's mask
// |dx| <= umax[|dy|] (umax in __constant__) is a select, not a branch
// that would hold the loads apart.  m10 and m01 are summed in f32, in
// the order of the rows; an xor butterfly leaves both
// sums, bit-identical, in every lane (f32 addition is commutative), so
// every lane takes the same atan2f, cosf and sinf (the reference's CPU
// path does the same, not the normalised moments of the Pallas kernel).
// BRIEF: 8 rounds w = 0..7; in round w lane l evaluates pattern pair
// 32w + l (one coalesced int4 load of the device-resident pattern): two
// rotated taps rounded half-to-even (rintf, as jnp.round / torch.round),
// clamped to the level's (h, w), on the blurred stack.  A lane issues
// all 16 gathers of its 8 rounds, then 8 ballots compare them:
// __ballot_sync of round w gives word w, which holds bytes 4w..4w+3 of
// the OpenCV descriptor (little endian); lane w keeps it, and lanes 0-7
// write the 32 bytes in one store.  The rotations use __fmul_rn / __fadd_rn /
// __fsub_rn so nvcc cannot contract them into FMAs, which would move taps
// at rounding boundaries.  The Mosaic-only parts of the Pallas kernel
// (48x256 aligned windows, the [2, N] scalar prefetch, the one-hot MXU tap
// gather) are not needed: a CUDA thread loads any address.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kR = 15;

__constant__ int c_umax[kR + 1] = {15, 15, 15, 15, 14, 14, 14, 13,
                                   13, 12, 11, 10, 9,  8,  6,  3};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
orb_desc_kernel(const float* __restrict__ raw, const float* __restrict__ blur,
                int Hp, int Wp, const int* __restrict__ xy,
                const int* __restrict__ lvl, const int* __restrict__ hw,
                const int4* __restrict__ pattern, int n_kp,
                float* __restrict__ angle, uint32_t* __restrict__ desc) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= n_kp) return;  // a whole warp: no shuffle is left short
  // the pattern pairs of the 8 rounds do not depend on the angle: their
  // loads go out first, beside the keypoint's
  int4 p[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) p[r] = pattern[32 * r + lane];
  const int x = xy[2 * n];
  const int y = xy[2 * n + 1];
  const int level = lvl[n];
  const int h = hw[2 * n], w = hw[2 * n + 1];
  const size_t plane = (size_t)Hp * Wp;

  // moments: lane l is column dx = l - 15.  Every row's load is issued
  // (its clamped address is valid) and the circle's mask is a select, so
  // no branch holds the 31 loads apart
  const float* img = raw + (size_t)level * plane;
  const int dx = lane - kR;
  const int adx = dx < 0 ? -dx : dx;
  const float* col = img + clampi(x + dx, 0, Wp - 1);
  float v[2 * kR + 1];
#pragma unroll
  for (int i = 0; i <= 2 * kR; ++i)
    v[i] = col[(size_t)clampi(y + i - kR, 0, Hp - 1) * Wp];
  float m10 = 0.f, m01 = 0.f;
#pragma unroll
  for (int i = 0; i <= 2 * kR; ++i) {
    const int dy = i - kR;
    const float vi = adx <= c_umax[dy < 0 ? -dy : dy] ? v[i] : 0.f;
    m10 += (float)dx * vi;
    m01 += (float)dy * vi;
  }
  m10 = warp_allsum(m10);
  m01 = warp_allsum(m01);
  const float ang = atan2f(m01, m10);
  if (lane == 0) angle[n] = ang;
  const float ca = cosf(ang), sa = sinf(ang);

  // rBRIEF: all 16 taps of a lane first, then round w's ballot is word w
  const float* bl = blur + (size_t)level * plane;
  float va[8], vb[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float x1 = (float)p[r].x, y1 = (float)p[r].y;
    const float x2 = (float)p[r].z, y2 = (float)p[r].w;
    const int rx1 =
        (int)rintf(__fsub_rn(__fmul_rn(x1, ca), __fmul_rn(y1, sa)));
    const int ry1 =
        (int)rintf(__fadd_rn(__fmul_rn(x1, sa), __fmul_rn(y1, ca)));
    const int rx2 =
        (int)rintf(__fsub_rn(__fmul_rn(x2, ca), __fmul_rn(y2, sa)));
    const int ry2 =
        (int)rintf(__fadd_rn(__fmul_rn(x2, sa), __fmul_rn(y2, ca)));
    va[r] = bl[(size_t)clampi(y + ry1, 0, h - 1) * Wp +
               clampi(x + rx1, 0, w - 1)];
    vb[r] = bl[(size_t)clampi(y + ry2, 0, h - 1) * Wp +
               clampi(x + rx2, 0, w - 1)];
  }
  uint32_t mine = 0u;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const uint32_t word = __ballot_sync(0xffffffffu, va[r] < vb[r]);
    if (lane == r) mine = word;
  }
  if (lane < 8) desc[8 * n + lane] = mine;
}

}  // namespace

// raw/blur [L, Hp, Wp] f32; xy [N, 2] i32 (x, y); lvl [N] i32; hw [N, 2]
// i32 (h, w); pattern [256, 4] i32 (x1, y1, x2, y2), 16-byte aligned ->
// angle [N] f32, desc [N, 32] u8 (written as [N, 8] u32).
extern "C" int mam3_orb_desc(const float* raw, const float* blur, int L,
                             int Hp, int Wp, const int* xy, const int* lvl,
                             const int* hw, const int* pattern, int n,
                             float* angle, uint8_t* desc, void* stream) {
  (void)L;
  orb_desc_kernel<<<(n + kWarps - 1) / kWarps, kThreads, 0,
                    (cudaStream_t)stream>>>(
      raw, blur, Hp, Wp, xy, lvl, hw, reinterpret_cast<const int4*>(pattern),
      n, angle, reinterpret_cast<uint32_t*>(desc));
  return (int)cudaGetLastError();
}
