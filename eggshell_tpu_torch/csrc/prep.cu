// Per-body pre-solve prep of the fused step, float32.
//
// Replaces the TPU kernel `_prep_kernel` of eggshell_tpu/ops/prep_kernel.py
// (reached through `prep_packed`).  Per body of every scenario:
//   R     = quat_to_mat(q)
//   invIg = R I_b^-1 R^T,  Ig = R I_b R^T
//   F     = [m g + ext_lin; -w x (Ig w) + ext_ang]     (m = 1/inv_mass, 0 if static)
//   uhat  = u/dt + M^-1 F = [v/dt + inv_mass F_lin; w/dt + invIg F_ang]
// with every sum taken in the TPU kernel's order, so that, built with
// --fmad=false, it rounds as the plain torch version does.
//
// What bounds it on an H100: bytes.  A body reads 10 floats of state (and
// 6 of external force) and writes 21; its ~150 flops are nothing beside
// that.  One thread per (scenario, body); the per-body constants (I_b,
// I_b^-1, inv_mass) are n * 19 floats shared by every scenario and stay in
// L1/L2.  The TPU kernel's (8, 128) scenario tiles are not carried over:
// the arrays stay scenario-major (B, n, ...).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// C = A B for row-major 3x3, sums in k order.
__device__ __forceinline__ void mat3_mul(const float* A, const float* B, float* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

// C = A B^T for row-major 3x3.
__device__ __forceinline__ void mat3_mul_t(const float* A, const float* B, float* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[3 * j] + A[3 * i + 1] * B[3 * j + 1] + A[3 * i + 2] * B[3 * j + 2];
}

__global__ void prep_kernel(const float* __restrict__ q, const float* __restrict__ v,
                            const float* __restrict__ w, const float* __restrict__ ext,
                            const float* __restrict__ inv_mass, const float* __restrict__ Ib,
                            const float* __restrict__ invIb, float* __restrict__ uhat,
                            float* __restrict__ invig, float* __restrict__ F, int64_t total,
                            int n, float inv_dt, float gx, float gy, float gz) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int b = (int)(t % n);

  const float qw = q[4 * t], qx = q[4 * t + 1], qy = q[4 * t + 2], qz = q[4 * t + 3];
  const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
  const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
  const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
  const float R[9] = {
      1.f - 2.f * (yy + zz), 2.f * (xy - wz), 2.f * (xz + wy),
      2.f * (xy + wz), 1.f - 2.f * (xx + zz), 2.f * (yz - wx),
      2.f * (xz - wy), 2.f * (yz + wx), 1.f - 2.f * (xx + yy),
  };
  float T[9], iIg[9], Ig[9];
  mat3_mul(R, invIb + 9 * b, T);
  mat3_mul_t(T, R, iIg);
  mat3_mul(R, Ib + 9 * b, T);
  mat3_mul_t(T, R, Ig);
  for (int e = 0; e < 9; ++e) invig[9 * t + e] = iIg[e];

  const float w0 = w[3 * t], w1 = w[3 * t + 1], w2 = w[3 * t + 2];
  float Igw[3];
  for (int i = 0; i < 3; ++i) Igw[i] = Ig[3 * i] * w0 + Ig[3 * i + 1] * w1 + Ig[3 * i + 2] * w2;
  float fang[3] = {-(w1 * Igw[2] - w2 * Igw[1]), -(w2 * Igw[0] - w0 * Igw[2]),
                   -(w0 * Igw[1] - w1 * Igw[0])};
  const float im = inv_mass[b];
  const float m = im > 0.f ? 1.f / im : 0.f;
  float flin[3] = {m * gx, m * gy, m * gz};
  if (ext != nullptr) {
    for (int c = 0; c < 3; ++c) {
      flin[c] = flin[c] + ext[6 * t + c];
      fang[c] = fang[c] + ext[6 * t + 3 + c];
    }
  }
  for (int c = 0; c < 3; ++c) {
    F[6 * t + c] = flin[c];
    F[6 * t + 3 + c] = fang[c];
    uhat[6 * t + c] = v[3 * t + c] * inv_dt + im * flin[c];
  }
  const float wv[3] = {w0, w1, w2};
  for (int i = 0; i < 3; ++i) {
    float acc = wv[i] * inv_dt;
    for (int j = 0; j < 3; ++j) acc = acc + iIg[3 * i + j] * fang[j];
    uhat[6 * t + 3 + i] = acc;
  }
}

}  // namespace

extern "C" int eggshell_prep_f32(const float* q, const float* v, const float* w,
                                 const float* ext, const float* inv_mass, const float* Ib,
                                 const float* invIb, float* uhat, float* invig, float* F,
                                 int64_t B, int n, float inv_dt, float gx, float gy, float gz,
                                 void* stream) {
  const int64_t total = B * n;
  if (total <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  prep_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(q, v, w, ext, inv_mass, Ib, invIb,
                                                            uhat, invig, F, total, n, inv_dt,
                                                            gx, gy, gz);
  return (int)cudaGetLastError();
}
