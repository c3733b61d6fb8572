// Batched under-relaxed projected Jacobi for mixed LCPs, float32: scalar
// heavy-ball sweeps and exact 3x3 block-Jacobi sweeps.
//
// `jacobi_kernel` replaces the TPU kernel `_jacobi_kernel` of
// eggshell_tpu/ops/pgs_kernel.py (reached through `solve_lcp_jacobi_pallas`,
// block=False).  Semantics, per scenario, with rows padded to a multiple of
// 8 (unit diagonal, b = 0, equality): x0 = proj(b), then `iters` sweeps of
//   x <- proj((1 - omega) x + omega (b - A x + D x) D^-1 + beta (x - x_prev))
// where proj clamps inequality rows to [lo, hi] and leaves equality rows
// free.  The padded rows stay at exactly 0 and never touch the real rows.
//
// `block_jacobi_kernel` replaces `_block_jacobi_kernel` of the same file
// (`solve_lcp_jacobi_pallas(block=True)`, m % 3 == 0): each sweep solves
// every 3-row constraint block exactly, with no momentum,
//   rv = b - A x;  y_i = x_i + sum_c inv(A_kk)[r, c] rv_3k+c  (i = 3k + r < m),
//   y_i = x_i + rv_i / D_i on the padding rows;  x <- proj((1 - omega) x + omega y).
// Each thread builds its row of its block's inverse once (csrc/block3.cuh,
// the adjugate), and the block's three threads read rv from shared memory
// after a barrier.
//
// What bounds them on an H100: each sweep is a dense (m x m) mat-vec, so a
// scenario costs iters * 2 m^2 flops against one read of A (4 m^2 bytes):
// about 8 flops per byte at iters = 16.  Streaming A from device memory on
// every sweep would make it bandwidth-bound; the design reads A once.  One
// thread block per scenario holds A in shared memory (m_pad <= 64 on the
// main path: 16.6 KB with the row padding below), one thread per row, all
// sweeps inside the kernel, x in shared memory and the previous iterate in
// a register, __syncthreads() between sweeps.  Rows are stored with a
// stride of m_pad + 1 floats so that the threads of a warp, each reading
// its own row at the same column, hit 32 different banks.  The TPU kernel's
// (m, m, lanes) transpose is not carried over: A stays (B, m, m) row-major.
// The tensor cores are not used; a warp-per-scenario or wgmma form is work
// for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block3.cuh"

namespace {

__device__ __forceinline__ float proj(float x, bool eq, float lo, float hi) {
  return eq ? x : fminf(fmaxf(x, lo), hi);
}

__global__ void jacobi_kernel(const float* __restrict__ A, const float* __restrict__ b,
                              const uint8_t* __restrict__ is_eq,
                              const float* __restrict__ lo, const float* __restrict__ hi,
                              float* __restrict__ x_out, int m, int mp, int iters,
                              float omega, float beta) {
  extern __shared__ float smem[];
  const int ld = mp + 1;
  float* sA = smem;            // mp rows of stride ld
  float* sx = smem + mp * ld;  // current iterate
  const int64_t s = blockIdx.x;
  const float* As = A + s * (int64_t)m * m;

  for (int idx = threadIdx.x; idx < mp * mp; idx += blockDim.x) {
    const int i = idx / mp, j = idx % mp;
    float v;
    if (i < m && j < m) v = As[i * m + j];
    else v = (i == j) ? 1.f : 0.f;
    sA[i * ld + j] = v;
  }

  const int i = threadIdx.x;
  const bool row = i < mp;
  const bool real = i < m;
  const float bi = real ? b[s * m + i] : 0.f;
  const bool eqi = real ? (is_eq[s * m + i] != 0) : true;
  const float loi = real ? lo[s * m + i] : 0.f;
  const float hii = real ? hi[s * m + i] : 0.f;
  __syncthreads();

  float diag = 1.f, inv_diag = 1.f, x = 0.f, xprev = 0.f;
  if (row) {
    diag = sA[i * ld + i];
    inv_diag = 1.f / diag;
    x = proj(bi, eqi, loi, hii);
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
      const float r = bi - ax + diag * x;
      xn = proj((1.f - omega) * x + omega * r * inv_diag + beta * (x - xprev), eqi, loi, hii);
    }
    __syncthreads();
    if (row) {
      sx[i] = xn;
      xprev = x;
      x = xn;
    }
    __syncthreads();
  }
  if (real) x_out[s * m + i] = x;
}

__global__ void block_jacobi_kernel(const float* __restrict__ A, const float* __restrict__ b,
                                    const uint8_t* __restrict__ is_eq,
                                    const float* __restrict__ lo, const float* __restrict__ hi,
                                    float* __restrict__ x_out, int m, int mp, int iters,
                                    float omega) {
  extern __shared__ float smem[];
  const int ld = mp + 1;
  float* sA = smem;            // mp rows of stride ld
  float* sx = smem + mp * ld;  // current iterate
  float* srv = sx + mp;        // b - A x of the sweep
  const int64_t s = blockIdx.x;
  const float* As = A + s * (int64_t)m * m;

  for (int idx = threadIdx.x; idx < mp * mp; idx += blockDim.x) {
    const int i = idx / mp, j = idx % mp;
    float v;
    if (i < m && j < m) v = As[i * m + j];
    else v = (i == j) ? 1.f : 0.f;
    sA[i * ld + j] = v;
  }

  const int i = threadIdx.x;
  const int k = i / 3;
  const bool row = i < mp;
  const bool real = i < m;
  const float bi = real ? b[s * m + i] : 0.f;
  const bool eqi = real ? (is_eq[s * m + i] != 0) : true;
  const float loi = real ? lo[s * m + i] : 0.f;
  const float hii = real ? hi[s * m + i] : 0.f;
  __syncthreads();

  float inv_diag = 1.f, x = 0.f;
  float bc[3] = {0.f, 0.f, 0.f};
  if (row) {
    inv_diag = 1.f / sA[i * ld + i];
    x = proj(bi, eqi, loi, hii);
    sx[i] = x;
  }
  if (real) block_inverse_row(sA, ld, k, i % 3, bc);
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    float rv = 0.f;
    if (row) {
      const float* a = sA + i * ld;
      float ax = 0.f;
      for (int j = 0; j < mp; ++j) ax = ax + a[j] * sx[j];
      rv = bi - ax;
      srv[i] = rv;
    }
    __syncthreads();
    if (row) {
      const float y = real ? x + bc[0] * srv[3 * k] + bc[1] * srv[3 * k + 1] +
                                 bc[2] * srv[3 * k + 2]
                           : x + rv * inv_diag;
      x = proj((1.f - omega) * x + omega * y, eqi, loi, hii);
      sx[i] = x;
    }
    __syncthreads();
  }
  if (real) x_out[s * m + i] = x;
}

}  // namespace

extern "C" int eggshell_jacobi_f32(const float* A, const float* b, const uint8_t* is_eq,
                                   const float* lo, const float* hi, float* x,
                                   int64_t B, int m, int mp, int iters, float omega,
                                   float beta, void* stream) {
  if (B <= 0 || m <= 0) return 0;
  const size_t smem = (size_t)(mp * (mp + 1) + mp) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(jacobi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = ((mp + 31) / 32) * 32;
  jacobi_kernel<<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(A, b, is_eq, lo, hi, x, m,
                                                                      mp, iters, omega, beta);
  return (int)cudaGetLastError();
}

extern "C" int eggshell_jacobi_block_f32(const float* A, const float* b, const uint8_t* is_eq,
                                         const float* lo, const float* hi, float* x, int64_t B,
                                         int m, int mp, int iters, float omega, void* stream) {
  if (B <= 0 || m <= 0) return 0;
  const size_t smem = (size_t)(mp * (mp + 1) + 2 * mp) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(block_jacobi_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = ((mp + 31) / 32) * 32;
  block_jacobi_kernel<<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(
      A, b, is_eq, lo, hi, x, m, mp, iters, omega);
  return (int)cudaGetLastError();
}

extern "C" const char* eggshell_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
