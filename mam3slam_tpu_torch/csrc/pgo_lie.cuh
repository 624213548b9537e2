// Sim(3) algebra of csrc/pgo.cu, on a scalar type T that is either float
// (values) or Dual (a value and one forward-mode derivative).  Each
// function is geometry/lie.py's, written with the same expressions and the
// same small-angle branches (torch.where picks one branch's value and its
// tangent, as the `?:` here does), so the Dual evaluation gives the
// derivative that torch.func.jacfwd takes through lie.py, rounded in
// float32 in another order.  Plain C++ besides the qualifiers:
// tests/test_torch_pgo_paths.py builds it with the host compiler and holds
// it to torch.func.jacfwd on the CPU.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define PGO_FN __host__ __device__ __forceinline__
#else
#define PGO_FN inline
#endif

namespace pgo {

struct Dual {
  float v, d;  // value and derivative along one tangent direction
};

template <typename T>
PGO_FN T lit(float x);
template <>
PGO_FN float lit<float>(float x) { return x; }
template <>
PGO_FN Dual lit<Dual>(float x) { return {x, 0.f}; }

PGO_FN float val(float x) { return x; }
PGO_FN float val(Dual x) { return x.v; }

PGO_FN Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
PGO_FN Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
PGO_FN Dual operator-(Dual a) { return {-a.v, -a.d}; }
PGO_FN Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
PGO_FN Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
PGO_FN Dual operator+(Dual a, float b) { return {a.v + b, a.d}; }
PGO_FN Dual operator+(float a, Dual b) { return {a + b.v, b.d}; }
PGO_FN Dual operator-(Dual a, float b) { return {a.v - b, a.d}; }
PGO_FN Dual operator-(float a, Dual b) { return {a - b.v, -b.d}; }
PGO_FN Dual operator*(Dual a, float b) { return {a.v * b, a.d * b}; }
PGO_FN Dual operator*(float a, Dual b) { return {a * b.v, a * b.d}; }
PGO_FN Dual operator/(Dual a, float b) { return {a.v / b, a.d / b}; }
PGO_FN Dual operator/(float a, Dual b) {
  const float q = a / b.v;
  return {q, -q * b.d / b.v};
}

PGO_FN float Sqrt(float x) { return sqrtf(x); }
PGO_FN float Sin(float x) { return sinf(x); }
PGO_FN float Cos(float x) { return cosf(x); }
PGO_FN float Exp(float x) { return expf(x); }
PGO_FN float Log(float x) { return logf(x); }
PGO_FN float Atan2(float y, float x) { return atan2f(y, x); }
PGO_FN Dual Sqrt(Dual x) {
  const float r = sqrtf(x.v);
  return {r, x.d / (2.f * r)};
}
PGO_FN Dual Sin(Dual x) { return {sinf(x.v), cosf(x.v) * x.d}; }
PGO_FN Dual Cos(Dual x) { return {cosf(x.v), -sinf(x.v) * x.d}; }
PGO_FN Dual Exp(Dual x) {
  const float e = expf(x.v);
  return {e, e * x.d};
}
PGO_FN Dual Log(Dual x) { return {logf(x.v), x.d / x.v}; }
PGO_FN Dual Atan2(Dual y, Dual x) {
  return {atan2f(y.v, x.v),
          (x.v * y.d - y.v * x.d) / (x.v * x.v + y.v * y.v)};
}

// torch.clamp: the bound where x lies past it (with no derivative), x
// otherwise (NaN included)
template <typename T>
PGO_FN T clamp_min(T x, float lo) {
  return val(x) < lo ? lit<T>(lo) : x;
}
template <typename T>
PGO_FN T clamp(T x, float lo, float hi) {
  return val(x) < lo ? lit<T>(lo) : (val(x) > hi ? lit<T>(hi) : x);
}

template <typename T>
struct Sim3 {
  T q[4], t[3], s;  // x_out = s R(q) x + t
};

template <typename T>
PGO_FN void cross(const T* a, const T* b, T* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename T>
PGO_FN void quat_normalize(T* q) {
  const T n = clamp_min(Sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] +
                             q[3] * q[3]), 1e-8f);
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = q[k] / n;
}

template <typename T>
PGO_FN void quat_mul(const T* a, const T* b, T* o) {
  o[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  o[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  o[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  o[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

// v + 2 (w (u x v) + u x (u x v)), u = q.xyz
template <typename T>
PGO_FN void quat_rotate(const T* q, const T* v, T* o) {
  T uv[3], uuv[3];
  cross(q + 1, v, uv);
  cross(q + 1, uv, uuv);
#pragma unroll
  for (int c = 0; c < 3; ++c) o[c] = v[c] + 2.f * (q[0] * uv[c] + uuv[c]);
}

// so3_exp_quat
template <typename T>
PGO_FN void so3_exp_quat(const T* phi, T* q) {
  const T th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const bool small = val(th2) < 1e-8f;
  const T th = Sqrt(small ? lit<T>(1.f) : th2);
  const T half = 0.5f * th;
  const T k = small ? 0.5f - th2 / 48.f : Sin(half) / th;
  q[0] = small ? 1.f - th2 / 8.f : Cos(half);
#pragma unroll
  for (int c = 0; c < 3; ++c) q[1 + c] = k * phi[c];
  quat_normalize(q);
}

// so3_log_quat
template <typename T>
PGO_FN void so3_log_quat(const T* q_in, T* phi) {
  const float sgn = val(q_in[0]) < 0.f ? -1.f : 1.f;
  T q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = q_in[k] * sgn;
  const T w = clamp(q[0], -1.f, 1.f);
  const T vn2 = q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  const bool small = val(vn2) < 1e-12f;
  const T vn = Sqrt(small ? lit<T>(1.f) : vn2);
  const T theta = 2.f * Atan2(vn, w);
  const T k = small ? 2.f / clamp_min(w, 1e-6f) : theta / vn;
#pragma unroll
  for (int c = 0; c < 3; ++c) phi[c] = k * q[1 + c];
}

// _sim3_W: W = A hat(phi) + B hat(phi)^2 + C I, row-major
template <typename T>
PGO_FN void sim3_W(const T* phi, T sigma, T* W) {
  const T th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const T s = Exp(sigma);
  const T sig2 = sigma * sigma;
  const bool small_sigma = fabsf(val(sigma)) < 1e-4f;
  const bool small_theta = val(th2) < 1e-8f;
  const T safe_sigma = small_sigma ? lit<T>(1.f) : sigma;
  const T safe_th2 = small_theta ? lit<T>(1.f) : th2;
  const T safe_th = Sqrt(safe_th2);
  const T C = small_sigma ? 1.f + 0.5f * sigma + sig2 / 6.f
                          : (s - 1.f) / safe_sigma;
  T A, B;
  if (small_sigma) {
    A = small_theta ? 0.5f - th2 / 24.f : (1.f - Cos(safe_th)) / safe_th2;
    B = small_theta ? 1.f / 6.f - th2 / 120.f
                    : (safe_th - Sin(safe_th)) / (safe_th2 * safe_th);
  } else if (small_theta) {
    A = ((safe_sigma - 1.f) * s + 1.f) / sig2;
    B = (s * 0.5f * sig2 + s - 1.f - sigma * s) / (sig2 * safe_sigma);
  } else {
    const T a_ = s * Sin(safe_th);
    const T b_ = s * Cos(safe_th);
    const T c_ = th2 + sig2;
    const T safe_c = val(c_) < 1e-12f ? lit<T>(1.f) : c_;
    A = (a_ * sigma + (1.f - b_) * safe_th) / (safe_th * safe_c);
    B = (C - ((b_ - 1.f) * sigma + a_ * safe_th) / safe_c) / safe_th2;
  }
  const T z = lit<T>(0.f);
  const T K[9] = {z, -phi[2], phi[1], phi[2], z, -phi[0], -phi[1], phi[0], z};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T kk = K[3 * i] * K[j] + K[3 * i + 1] * K[3 + j] +
                   K[3 * i + 2] * K[6 + j];
      W[3 * i + j] = A * K[3 * i + j] + B * kk + C * (i == j ? 1.f : 0.f);
    }
}

// sim3_exp of the tangent [rho, phi, sigma]
template <typename T>
PGO_FN Sim3<T> sim3_exp(const T* xi) {
  Sim3<T> o;
  T W[9];
  sim3_W(xi + 3, xi[6], W);
  so3_exp_quat(xi + 3, o.q);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    o.t[i] = W[3 * i] * xi[0] + W[3 * i + 1] * xi[1] + W[3 * i + 2] * xi[2];
  o.s = Exp(xi[6]);
  return o;
}

template <typename T>
PGO_FN Sim3<T> sim3_compose(const Sim3<T>& a, const Sim3<T>& b) {
  Sim3<T> o;
  quat_mul(a.q, b.q, o.q);
  quat_normalize(o.q);
  T r[3];
  quat_rotate(a.q, b.t, r);
#pragma unroll
  for (int c = 0; c < 3; ++c) o.t[c] = a.s * r[c] + a.t[c];
  o.s = a.s * b.s;
  return o;
}

template <typename T>
PGO_FN Sim3<T> sim3_inverse(const Sim3<T>& a) {
  Sim3<T> o;
  o.q[0] = a.q[0];
#pragma unroll
  for (int c = 1; c < 4; ++c) o.q[c] = -a.q[c];
  const T s_inv = 1.f / a.s;
  T r[3];
  quat_rotate(o.q, a.t, r);
#pragma unroll
  for (int c = 0; c < 3; ++c) o.t[c] = -s_inv * r[c];
  o.s = s_inv;
  return o;
}

// _solve3: A^-1 b by the adjugate
template <typename T>
PGO_FN void solve3(const T* A, const T* b, T* x) {
  T c0[3], c1[3], c2[3];
  cross(A + 3, A + 6, c0);
  cross(A + 6, A, c1);
  cross(A, A + 3, c2);
  const T det = A[0] * c0[0] + A[1] * c0[1] + A[2] * c0[2];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    x[c] = (c0[c] * b[0] + c1[c] * b[1] + c2[c] * b[2]) / det;
}

// sim3_log -> [rho, phi, sigma]
template <typename T>
PGO_FN void sim3_log(const Sim3<T>& a, T* xi) {
  so3_log_quat(a.q, xi + 3);
  xi[6] = Log(a.s);
  T W[9];
  sim3_W(xi + 3, xi[6], W);
  solve3(W, a.t, xi);
}

// pgo.edge_residual: log(m * S_i * S_j^-1)
template <typename T>
PGO_FN void edge_residual(const Sim3<T>& Si, const Sim3<T>& Sj,
                          const Sim3<T>& m, T* r) {
  sim3_log(sim3_compose(m, sim3_compose(Si, sim3_inverse(Sj))), r);
}

// the retraction: exp(xi) * S
template <typename T>
PGO_FN Sim3<T> perturbed(const T* xi, const Sim3<T>& S) {
  return sim3_compose(sim3_exp(xi), S);
}

}  // namespace pgo
