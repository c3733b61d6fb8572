// Heavy-ball projected Jacobi on the fused chain's contact LCP with A
// streamed from device memory (B6b), float32.
//
// Replaces the TPU kernel `_jacobi_packed_stream_kernel` of
// eggshell_tpu/ops/pgs_kernel.py (reached through
// `_solve_lcp_jacobi_packed_stream`, the `stream=True` side of
// `solve_lcp_jacobi_packed`).  It computes what csrc/jacobi_packed.cu
// computes, sum for sum: the same bounds built from the lane masks, x0 =
// proj(b), then `iters` sweeps of
//   r = b - A x + diag x;  x <- proj((1 - omega) x + omega r / diag + beta (x - x_prev)),
// each row's A x summed over j in order.  It differs in where A lives: the
// resident kernel copies A into shared memory once; this one leaves it in
// device memory and reads it again on every sweep, in chunks of RB rows.
//
// What bounds it on an H100: bytes.  A is mp^2 floats a scenario (36 KB at
// mp = 96) and is read iters times (16 at the bench configuration), against
// 2 mp^2 flops a sweep: 0.5 flop a byte read.  At B = 4096 and mp = 96, A is
// 151 MB, three times the 50 MB L2, so every sweep's read comes from HBM.
// The design: one block per scenario, one thread per row (x, x_prev, the
// bounds, diag and b in the row's registers, the iterate in shared memory);
// A arrives a chunk of RB rows at a time (RB * mp contiguous floats),
// double-buffered in shared memory with `cp.async`, so the next chunk's copy
// is in flight while the current chunk's rows are summed.  The buffers keep a
// row stride of mp + 1 floats, so a warp reading its rows at one column hits
// 32 banks.  A block holds 2 RB (mp + 1) + mp floats: 25 KB at mp = 96.  The
// TPU kernel's (iters, nchunks) grid and its (8, 128) sublane stripes are not
// carried over: the sweep and chunk loops run inside the block.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kHiInf = 3.4e38f;

// Rows per chunk: the largest of 32, 24, 16, 8 that divides mp (mp is a
// multiple of 8).
__host__ __device__ inline int chunk_rows(int mp) {
  return mp % 32 == 0 ? 32 : mp % 24 == 0 ? 24 : mp % 16 == 0 ? 16 : 8;
}

// Issue the copies of chunk `c` (rows c*rb .. c*rb+rb-1 of the scenario's A)
// into `buf`, and commit them as one group.
__device__ __forceinline__ void load_chunk(float* buf, const float* __restrict__ As, int c,
                                           int rb, int mp, int ld) {
  const float* src = As + (int64_t)c * rb * mp;
  for (int e = threadIdx.x; e < rb * mp; e += blockDim.x)
    __pipeline_memcpy_async(buf + (e / mp) * ld + e % mp, src + e, sizeof(float));
  __pipeline_commit();
}

__global__ void jacobi_packed_stream_kernel(const float* __restrict__ A,
                                            const float* __restrict__ diag,
                                            const float* __restrict__ rhs,
                                            const uint8_t* __restrict__ act,
                                            const uint8_t* __restrict__ eq,
                                            float* __restrict__ x_out, int K, int mp, int iters,
                                            float mu, float omega, float beta) {
  extern __shared__ float smem[];
  const int ld = mp + 1;
  const int rb = chunk_rows(mp);
  const int nchunks = mp / rb;
  float* buf0 = smem;                // chunk buffers, rb rows of stride ld each
  float* buf1 = smem + rb * ld;
  float* sx = smem + 2 * rb * ld;    // current iterate
  const int64_t s = blockIdx.x;
  const int m = 3 * K;
  const float* As = A + s * (int64_t)mp * mp;

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

  const int total = iters * nchunks;  // chunks over all sweeps
  if (total > 0) load_chunk(buf0, As, 0, rb, mp, ld);
  float ax = 0.f;
  for (int g = 0; g < total; ++g) {
    const int c = g % nchunks;
    float* cur = (g & 1) ? buf1 : buf0;
    if (g + 1 < total) {
      load_chunk((g & 1) ? buf0 : buf1, As, (c + 1) % nchunks, rb, mp, ld);
      __pipeline_wait_prior(1);  // all but the chunk just issued have landed
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // the chunk, and the sweep's iterate, are visible to all
    if (i >= c * rb && i < c * rb + rb) {
      const float* a = cur + (i - c * rb) * ld;
      float acc = 0.f;
      for (int j = 0; j < mp; ++j) acc = acc + a[j] * sx[j];
      ax = acc;
    }
    __syncthreads();  // `cur` may be overwritten by the copy issued next
    if (c == nchunks - 1) {  // the sweep's last chunk: update the iterate
      if (row) {
        const float r = bi - ax + d * x;
        float xn = (1.f - omega) * x + omega * r * inv_d + beta * (x - xprev);
        if (active) xn = fminf(fmaxf(xn, lo), hi);
        sx[i] = xn;
        xprev = x;
        x = xn;
      }
      // the next read of sx follows the next iteration's first __syncthreads
    }
  }
  if (row) x_out[s * mp + i] = x;
}

}  // namespace

extern "C" int eggshell_jacobi_packed_stream_f32(const float* A, const float* diag,
                                                 const float* rhs, const uint8_t* act,
                                                 const uint8_t* eq, float* x, int64_t B, int K,
                                                 int mp, int iters, float mu, float omega,
                                                 float beta, void* stream) {
  if (B <= 0) return 0;
  const int rb = chunk_rows(mp);
  const size_t smem = (size_t)(2 * rb * (mp + 1) + mp) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(jacobi_packed_stream_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = ((mp + 31) / 32) * 32;
  jacobi_packed_stream_kernel<<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(
      A, diag, rhs, act, eq, x, K, mp, iters, mu, omega, beta);
  return (int)cudaGetLastError();
}
