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
//
// Where A with the row stride m_pad + 1 does not fit one block's 232,448
// bytes of shared memory (m_pad > 232), `jacobi_global_kernel` and
// `block_jacobi_global_kernel` read A's rows from device memory on every
// sweep instead (csrc/rows_global.cuh: tiles of 32 columns, a warp a row
// segment, coalesced, double-buffered with cp.async), and keep only the
// iterate, the row sums and the block inverses' rows in shared memory.
// Each row is summed over j in increasing order as in the shared form, so
// the two return the same bits on any m both take.  The caller picks the
// form (`ops/pgs_kernel.py:jacobi_launch_plan`).  Reading A every sweep
// makes these forms bound by 16 reads of A; their redesign is queued.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block3.cuh"
#include "rows_global.cuh"

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

// Row i's b, lo, hi and equality flag; padding rows (i >= m) have b = 0 and
// are equality rows.
struct RowIn {
  float b, lo, hi;
  bool eq;
};

__device__ __forceinline__ RowIn row_in(const float* __restrict__ b,
                                        const uint8_t* __restrict__ is_eq,
                                        const float* __restrict__ lo, const float* __restrict__ hi,
                                        int64_t s, int m, int i) {
  if (i >= m) return {0.f, 0.f, 0.f, true};
  const int64_t r = s * m + i;
  return {b[r], lo[r], hi[r], is_eq[r] != 0};
}

// A_ii of the padded matrix.
__device__ __forceinline__ float diag_of(const rows_global::Rows& a, int i) {
  return i < a.m ? a.A[i * a.lda + i] : 1.f;
}

// The global-rows form of `jacobi_kernel`.  Shared memory: the tiles, then
// the iterate, the previous iterate and the row sums, mp floats each.
__global__ void jacobi_global_kernel(const float* __restrict__ A, const float* __restrict__ b,
                                     const uint8_t* __restrict__ is_eq,
                                     const float* __restrict__ lo, const float* __restrict__ hi,
                                     float* __restrict__ x_out, int m, int mp, int iters,
                                     float omega, float beta) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  float* tiles = smem;
  float* sx = tiles + rows_global::tile_floats(T);
  float* sxp = sx + mp;
  float* sax = sxp + mp;
  const int64_t s = blockIdx.x;
  const rows_global::Rows a = {A + s * (int64_t)m * m, m, m, mp};

  for (int i = threadIdx.x; i < mp; i += T) {
    const RowIn in = row_in(b, is_eq, lo, hi, s, m, i);
    sx[i] = sxp[i] = proj(in.b, in.eq, in.lo, in.hi);
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    rows_global::matvec(a, sx, sax, tiles);
    for (int i = threadIdx.x; i < mp; i += T) {  // a thread reads and writes its own rows only
      const RowIn in = row_in(b, is_eq, lo, hi, s, m, i);
      const float diag = diag_of(a, i), inv_diag = 1.f / diag;
      const float x = sx[i], xprev = sxp[i];
      const float r = in.b - sax[i] + diag * x;
      sx[i] = proj((1.f - omega) * x + omega * r * inv_diag + beta * (x - xprev), in.eq, in.lo,
                   in.hi);
      sxp[i] = x;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < m; i += T) x_out[s * m + i] = sx[i];
}

// The global-rows form of `block_jacobi_kernel`.  Shared memory: the tiles,
// then the iterate and the row sums, mp floats each, and each row's row of
// its block inverse, 3 mp floats.
__global__ void block_jacobi_global_kernel(const float* __restrict__ A,
                                           const float* __restrict__ b,
                                           const uint8_t* __restrict__ is_eq,
                                           const float* __restrict__ lo,
                                           const float* __restrict__ hi,
                                           float* __restrict__ x_out, int m, int mp, int iters,
                                           float omega) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  float* tiles = smem;
  float* sx = tiles + rows_global::tile_floats(T);
  float* sax = sx + mp;
  float* sbc = sax + mp;
  const int64_t s = blockIdx.x;
  const rows_global::Rows a = {A + s * (int64_t)m * m, m, m, mp};

  for (int i = threadIdx.x; i < mp; i += T) {
    const RowIn in = row_in(b, is_eq, lo, hi, s, m, i);
    sx[i] = proj(in.b, in.eq, in.lo, in.hi);
    if (i < m) block_inverse_row(a.A, m, i / 3, i % 3, sbc + 3 * i);
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    rows_global::matvec(a, sx, sax, tiles);
    for (int i = threadIdx.x; i < mp; i += T) {  // a thread writes its own rows only
      const RowIn in = row_in(b, is_eq, lo, hi, s, m, i);
      const float x = sx[i];
      float y;
      if (i < m) {
        const int k0 = 3 * (i / 3);
        const float* bc = sbc + 3 * i;
        const float rv0 = row_in(b, is_eq, lo, hi, s, m, k0).b - sax[k0];
        const float rv1 = row_in(b, is_eq, lo, hi, s, m, k0 + 1).b - sax[k0 + 1];
        const float rv2 = row_in(b, is_eq, lo, hi, s, m, k0 + 2).b - sax[k0 + 2];
        y = x + bc[0] * rv0 + bc[1] * rv1 + bc[2] * rv2;
      } else {
        y = x + (in.b - sax[i]) * (1.f / diag_of(a, i));
      }
      sx[i] = proj((1.f - omega) * x + omega * y, in.eq, in.lo, in.hi);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < m; i += T) x_out[s * m + i] = sx[i];
}

}  // namespace

// Shared memory of the shared form: A with the row stride mp + 1, the
// iterate and the block form's residual.
static size_t shared_form_bytes(int mp) { return (size_t)(mp * (mp + 1) + 2 * mp) * sizeof(float); }

// Shared memory of the global-rows forms with `threads` threads: the
// tiles and `vectors` floats a row.
static size_t global_form_bytes(int mp, int threads, int vectors) {
  return (size_t)(rows_global::tile_floats(threads) + vectors * mp) * sizeof(float);
}

// Launch `shared_kernel` with one thread a row and A in shared memory, or,
// with `global_rows`, `global_kernel` with `threads` threads and `vectors`
// floats a row of shared memory; both as the caller's launch plan says
// (`ops/pgs_kernel.py:jacobi_launch_plan`).
template <typename Kernel, typename... Args>
static int launch_form(Kernel shared_kernel, Kernel global_kernel, int global_rows, int threads,
                       int vectors, int64_t B, int mp, void* stream, Args... args) {
  Kernel kernel = global_rows ? global_kernel : shared_kernel;
  size_t smem;
  if (global_rows) {
    if (threads < 32 || threads > 1024 || threads % 32 != 0) return (int)cudaErrorInvalidValue;
    smem = global_form_bytes(mp, threads, vectors);
  } else {
    threads = ((mp + 31) / 32) * 32;
    smem = shared_form_bytes(mp);
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

extern "C" int eggshell_jacobi_f32(const float* A, const float* b, const uint8_t* is_eq,
                                   const float* lo, const float* hi, float* x,
                                   int64_t B, int m, int mp, int iters, float omega,
                                   float beta, int global_rows, int threads, void* stream) {
  if (B <= 0 || m <= 0) return 0;
  return launch_form(jacobi_kernel, jacobi_global_kernel, global_rows, threads, 3, B, mp, stream,
                     A, b, is_eq, lo, hi, x, m, mp, iters, omega, beta);
}

extern "C" int eggshell_jacobi_block_f32(const float* A, const float* b, const uint8_t* is_eq,
                                         const float* lo, const float* hi, float* x, int64_t B,
                                         int m, int mp, int iters, float omega, int global_rows,
                                         int threads, void* stream) {
  if (B <= 0 || m <= 0) return 0;
  return launch_form(block_jacobi_kernel, block_jacobi_global_kernel, global_rows, threads, 5, B,
                     mp, stream, A, b, is_eq, lo, hi, x, m, mp, iters, omega);
}

extern "C" const char* eggshell_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
