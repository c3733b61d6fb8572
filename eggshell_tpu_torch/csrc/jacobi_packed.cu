// Heavy-ball projected Jacobi on the fused chain's contact LCP, float32.
//
// Replaces the TPU kernel `_jacobi_packed_kernel` of
// eggshell_tpu/ops/pgs_kernel.py (reached through `solve_lcp_jacobi_packed`,
// block=False, pyramid_mu=0).  Unlike csrc/jacobi.cu it takes no bounds:
// they are built here from the lane masks.  Row i < 3K of lane k = i / 3:
//   inactive lane             -> never projected;
//   equality (ball-joint) lane -> clamped to [-3.4e38, 3.4e38] (free);
//   tangential row (i % 3 < 2) -> clamped to [-mu, mu];
//   normal row                 -> clamped to [0, 3.4e38].
// Rows 3K..mp-1 have b = 0 and a unit row of A, and are not projected.
// diag(A) comes from the A-formation kernel and is not re-read from A.
// x0 = proj(b), then `iters` sweeps of
//   r = b - A x + diag x;  x <- proj((1 - omega) x + omega r / diag + beta (x - x_prev)).
//
// What bounds it on an H100: A is read once, mp^2 floats a scenario
// (16 KB at mp = 64), against iters * 2 mp^2 flops: about 8 flops a byte
// at 16 sweeps, below the card's 20 flops a byte in float32, so bytes.
// The design of csrc/jacobi.cu: one block per scenario holds A in shared
// memory with a row stride of mp + 1 (a warp reading its rows at one column
// hits 32 banks), one thread per row, every sweep inside the kernel.  The
// TPU kernel's (8, mp*mp, 128) sublane stripes are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kHiInf = 3.4e38f;

__global__ void jacobi_packed_kernel(const float* __restrict__ A, const float* __restrict__ diag,
                                     const float* __restrict__ rhs,
                                     const uint8_t* __restrict__ act,
                                     const uint8_t* __restrict__ eq, float* __restrict__ x_out,
                                     int K, int mp, int iters, float mu, float omega,
                                     float beta) {
  extern __shared__ float smem[];
  const int ld = mp + 1;
  float* sA = smem;            // mp rows of stride ld
  float* sx = smem + mp * ld;  // current iterate
  const int64_t s = blockIdx.x;
  const int m = 3 * K;
  const float* As = A + s * (int64_t)mp * mp;

  for (int idx = threadIdx.x; idx < mp * mp; idx += blockDim.x) {
    const int i = idx / mp, j = idx % mp;
    sA[i * ld + j] = As[idx];
  }

  const int i = threadIdx.x;
  const bool row = i < mp;
  const bool real = i < m;
  const int k = i / 3;
  const bool active = real && act[s * K + k] != 0;
  const bool eqi = real && eq != nullptr && eq[s * K + k] != 0;
  float lo = 0.f, hi = kHiInf;
  if (eqi) {
    lo = -kHiInf;
  } else if (i % 3 < 2) {
    lo = -mu;
    hi = mu;
  }
  const float bi = real ? rhs[s * m + i] : 0.f;
  float d = 1.f, inv_d = 1.f, x = 0.f, xprev = 0.f;
  if (row) {
    d = diag[s * mp + i];
    inv_d = 1.f / d;
    x = active ? fminf(fmaxf(bi, lo), hi) : bi;
    xprev = x;
    sx[i] = x;
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    float xn = 0.f;
    if (row) {
      const float* a = sA + i * ld;
      float ax = 0.f;
      for (int j = 0; j < mp; ++j) ax = ax + a[j] * sx[j];
      const float r = bi - ax + d * x;
      xn = (1.f - omega) * x + omega * r * inv_d + beta * (x - xprev);
      if (active) xn = fminf(fmaxf(xn, lo), hi);
    }
    __syncthreads();
    if (row) {
      sx[i] = xn;
      xprev = x;
      x = xn;
    }
    __syncthreads();
  }
  if (row) x_out[s * mp + i] = x;
}

}  // namespace

extern "C" int eggshell_jacobi_packed_f32(const float* A, const float* diag, const float* rhs,
                                          const uint8_t* act, const uint8_t* eq, float* x,
                                          int64_t B, int K, int mp, int iters, float mu,
                                          float omega, float beta, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = (size_t)(mp * (mp + 1) + mp) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(jacobi_packed_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = ((mp + 31) / 32) * 32;
  jacobi_packed_kernel<<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(
      A, diag, rhs, act, eq, x, K, mp, iters, mu, omega, beta);
  return (int)cudaGetLastError();
}
