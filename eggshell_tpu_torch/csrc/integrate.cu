// Post-solve integration of the fused chain, float32.
//
// Replaces the TPU kernel `_integrate_kernel` of
// eggshell_tpu/ops/integrate_kernel.py (reached through `integrate_step`).
// Per body of every scenario:
//   J^T lambda = sum over lanes k, slots s with lane body b_s[k] == body, of
//                sum_r lambda[3k + r] Jc[3k + r, slot s]    (the ground, -1, is no body)
//   vdot       = [inv_mass (F + J^T lambda)_lin; invIg (F + J^T lambda)_ang]
//   u_new      = u + dt vdot,  u_mid = (u + u_new) / 2,  p += dt u_mid_lin
//   q          = normalize(exp(dt u_mid_ang) * q)
// with the TPU kernel's small-angle branch (|phi|^2 < 1e-12) and its order
// of operations; sinf, cosf and sqrtf are the correctly rounded or 1-ulp
// library functions, not the __ intrinsics.
//
// What bounds it on an H100: bytes.  Each body reads its own 36 floats
// of state, inertia and force, and the K lanes' lambda (3K floats) and
// Jc (36K floats) of its scenario: n threads of a scenario read the same
// lanes, so Jc is fetched from device memory once and from L1 after that.
// One thread per (scenario, body), which loops over the lanes.  The TPU
// kernel's (8, 128) tiles and one-hot body masks are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void integrate_kernel(const float* __restrict__ Jc, const float* __restrict__ lam,
                                 const int64_t* __restrict__ b0, const int64_t* __restrict__ b1,
                                 const float* __restrict__ p, const float* __restrict__ q,
                                 const float* __restrict__ v, const float* __restrict__ w,
                                 const float* __restrict__ inv_mass,
                                 const float* __restrict__ invIg, const float* __restrict__ F,
                                 float* __restrict__ p_out, float* __restrict__ q_out,
                                 float* __restrict__ v_out, float* __restrict__ w_out,
                                 int64_t total, int K, int n, int lam_stride, float dt) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;  // scenario * n + body
  if (t >= total) return;
  const int64_t s = t / n;
  const int body = (int)(t % n);

  float jtl[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const float* Js = Jc + s * (int64_t)K * 36;
  const float* ls = lam + s * (int64_t)lam_stride;
  for (int k = 0; k < K; ++k) {
    for (int slot = 0; slot < 2; ++slot) {
      const int64_t bsel = slot == 0 ? b0[s * K + k] : b1[s * K + k];
      if (bsel != body) continue;
      const float* J = Js + k * 36 + 6 * slot;
      for (int c = 0; c < 6; ++c) {
        const float contrib = ls[3 * k] * J[c] + ls[3 * k + 1] * J[12 + c] + ls[3 * k + 2] * J[24 + c];
        jtl[c] = jtl[c] + contrib;
      }
    }
  }

  float rhs[6];
  for (int c = 0; c < 6; ++c) rhs[c] = F[6 * t + c] + jtl[c];
  const float im = inv_mass[body];
  const float* ig = invIg + 9 * t;
  float vdot[6];
  for (int c = 0; c < 3; ++c) vdot[c] = im * rhs[c];
  for (int i = 0; i < 3; ++i) vdot[3 + i] = ig[3 * i] * rhs[3] + ig[3 * i + 1] * rhs[4] + ig[3 * i + 2] * rhs[5];

  float u[6], u_new[6], u_mid[6];
  for (int c = 0; c < 3; ++c) {
    u[c] = v[3 * t + c];
    u[3 + c] = w[3 * t + c];
  }
  for (int i = 0; i < 6; ++i) {
    u_new[i] = u[i] + dt * vdot[i];
    u_mid[i] = 0.5f * (u[i] + u_new[i]);
  }
  for (int c = 0; c < 3; ++c) {
    p_out[3 * t + c] = p[3 * t + c] + dt * u_mid[c];
    v_out[3 * t + c] = u_new[c];
    w_out[3 * t + c] = u_new[3 + c];
  }

  const float phi0 = dt * u_mid[3], phi1 = dt * u_mid[4], phi2 = dt * u_mid[5];
  const float t2 = phi0 * phi0 + phi1 * phi1 + phi2 * phi2;
  const bool small = t2 < 1e-12f;
  const float safe_t = sqrtf(small ? 1.f : t2);
  const float kfac = small ? 0.5f - t2 / 48.f : sinf(0.5f * safe_t) / safe_t;
  const float dw = small ? 1.f - t2 / 8.f : cosf(0.5f * safe_t);
  const float dx = kfac * phi0, dy = kfac * phi1, dz = kfac * phi2;

  const float qw = q[4 * t], qx = q[4 * t + 1], qy = q[4 * t + 2], qz = q[4 * t + 3];
  const float nw = dw * qw - dx * qx - dy * qy - dz * qz;
  const float nx = dw * qx + dx * qw + dy * qz - dz * qy;
  const float ny = dw * qy - dx * qz + dy * qw + dz * qx;
  const float nz = dw * qz + dx * qy - dy * qx + dz * qw;
  const float norm = sqrtf(nw * nw + nx * nx + ny * ny + nz * nz);
  const float inv = 1.f / (norm > 0.f ? norm : 1.f);
  q_out[4 * t] = nw * inv;
  q_out[4 * t + 1] = nx * inv;
  q_out[4 * t + 2] = ny * inv;
  q_out[4 * t + 3] = nz * inv;
}

}  // namespace

extern "C" int eggshell_integrate_f32(const float* Jc, const float* lam, const int64_t* b0,
                                      const int64_t* b1, const float* p, const float* q,
                                      const float* v, const float* w, const float* inv_mass,
                                      const float* invIg, const float* F, float* p_out,
                                      float* q_out, float* v_out, float* w_out, int64_t B, int K,
                                      int n, int lam_stride, float dt, void* stream) {
  const int64_t total = B * n;
  if (total <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  integrate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      Jc, lam, b0, b1, p, q, v, w, inv_mass, invIg, F, p_out, q_out, v_out, w_out, total, K, n,
      lam_stride, dt);
  return (int)cudaGetLastError();
}
