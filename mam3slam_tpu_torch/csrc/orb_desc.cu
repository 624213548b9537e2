// Describe kernel: IC orientation + 256-bit rBRIEF, one block per keypoint.
//
// Replaces the Pallas TPU kernel mam3slam_tpu/ops/pallas_orb_desc.py:
// ic_brief_fused (body _kernel).  Plain PyTorch version and semantics:
// mam3slam_tpu_torch/ops/cuda_orb_desc.py:ic_brief_plain.
//
// What bounds it on the H100: per keypoint it reads ~700 raw pixels for
// the moments and 512 blurred taps, ~5 KB scattered around one point of a
// [L, Hp, Wp] f32 stack (the EuRoC stack is 11.5 MB, so it sits in the
// 50 MB L2 after the blur writes it).  With N = 1000 keypoints the work
// is ~5 MB of L2 reads and a few hundred thousand flops: latency of the
// dependent gathers and of one launch bounds it, not bandwidth or math.
//
// Design: a block of 256 threads per keypoint (grid over N).  Threads
// stride over the r=15 circle (umax table in __constant__) summing the
// two moments in f32, reduced across the block with warp shuffles.
// Thread 0 takes atan2f; every thread then takes cosf/sinf of that angle
// (the reference's CPU path does the same, not the normalised moments of
// the Pallas kernel), and thread k evaluates pattern pair k: two rotated
// taps rounded half-to-even (rintf, as jnp.round / torch.round), clamped
// to the level's (h, w), compared on the blurred stack.  __ballot_sync
// packs each warp's 32 bits into one u32 word: word w holds bytes
// 4w..4w+3 of the OpenCV descriptor (little endian), so packing is fused.
// The rotations use __fmul_rn / __fadd_rn / __fsub_rn so nvcc cannot
// contract them into FMAs, which would move taps at rounding boundaries.
// The Mosaic-only parts of the Pallas kernel (48x256 aligned windows,
// the [2, N] scalar prefetch, the one-hot MXU tap gather) are not needed:
// a CUDA thread loads any address.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kR = 15;

__constant__ int c_umax[kR + 1] = {15, 15, 15, 15, 14, 14, 14, 13,
                                   13, 12, 11, 10, 9,  8,  6,  3};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
orb_desc_kernel(const float* __restrict__ raw, const float* __restrict__ blur,
                int Hp, int Wp, const int* __restrict__ xy,
                const int* __restrict__ lvl, const int* __restrict__ hw,
                const int* __restrict__ pattern, float* __restrict__ angle,
                uint32_t* __restrict__ desc) {
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int x = xy[2 * n];
  const int y = xy[2 * n + 1];
  const size_t plane = (size_t)Hp * Wp;
  const float* img = raw + (size_t)lvl[n] * plane;

  float m10 = 0.f, m01 = 0.f;
  for (int i = tid; i < (2 * kR + 1) * (2 * kR + 1); i += kThreads) {
    const int dy = i / (2 * kR + 1) - kR;
    const int dx = i % (2 * kR + 1) - kR;
    if (abs(dx) <= c_umax[abs(dy)]) {
      const float v = img[(size_t)clampi(y + dy, 0, Hp - 1) * Wp +
                          clampi(x + dx, 0, Wp - 1)];
      m10 += (float)dx * v;
      m01 += (float)dy * v;
    }
  }
  __shared__ float s_m10[kThreads / 32], s_m01[kThreads / 32];
  __shared__ float s_angle;
  m10 = warp_sum(m10);
  m01 = warp_sum(m01);
  if ((tid & 31) == 0) {
    s_m10[tid >> 5] = m10;
    s_m01[tid >> 5] = m01;
  }
  __syncthreads();
  if (tid == 0) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      a += s_m10[w];
      b += s_m01[w];
    }
    s_angle = atan2f(b, a);
    angle[n] = s_angle;
  }
  __syncthreads();

  const float ang = s_angle;
  const float ca = cosf(ang), sa = sinf(ang);
  const int4 p = reinterpret_cast<const int4*>(pattern)[tid];
  const float x1 = (float)p.x, y1 = (float)p.y;
  const float x2 = (float)p.z, y2 = (float)p.w;
  const int h = hw[2 * n], w = hw[2 * n + 1];
  const float* bl = blur + (size_t)lvl[n] * plane;
  const int rx1 = (int)rintf(__fsub_rn(__fmul_rn(x1, ca), __fmul_rn(y1, sa)));
  const int ry1 = (int)rintf(__fadd_rn(__fmul_rn(x1, sa), __fmul_rn(y1, ca)));
  const int rx2 = (int)rintf(__fsub_rn(__fmul_rn(x2, ca), __fmul_rn(y2, sa)));
  const int ry2 = (int)rintf(__fadd_rn(__fmul_rn(x2, sa), __fmul_rn(y2, ca)));
  const float va = bl[(size_t)clampi(y + ry1, 0, h - 1) * Wp +
                      clampi(x + rx1, 0, w - 1)];
  const float vb = bl[(size_t)clampi(y + ry2, 0, h - 1) * Wp +
                      clampi(x + rx2, 0, w - 1)];
  const uint32_t word = __ballot_sync(0xffffffffu, va < vb);
  if ((tid & 31) == 0) desc[8 * n + (tid >> 5)] = word;
}

}  // namespace

// raw/blur [L, Hp, Wp] f32; xy [N, 2] i32 (x, y); lvl [N] i32; hw [N, 2]
// i32 (h, w); pattern [256, 4] i32 (x1, y1, x2, y2) -> angle [N] f32,
// desc [N, 32] u8 (written as [N, 8] u32).
extern "C" int mam3_orb_desc(const float* raw, const float* blur, int L,
                             int Hp, int Wp, const int* xy, const int* lvl,
                             const int* hw, const int* pattern, int n,
                             float* angle, uint8_t* desc, void* stream) {
  (void)L;
  orb_desc_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(
      raw, blur, Hp, Wp, xy, lvl, hw, pattern, angle,
      reinterpret_cast<uint32_t*>(desc));
  return (int)cudaGetLastError();
}
