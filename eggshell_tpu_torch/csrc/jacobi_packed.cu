// Heavy-ball projected Jacobi on the fused chain's contact LCP, float32.
//
// Replaces the TPU kernel `_jacobi_packed_kernel` of
// eggshell_tpu/ops/pgs_kernel.py (reached through `solve_lcp_jacobi_packed`),
// all four of its forms: scalar or 3x3 block sweeps (`block`), box or
// Coulomb-pyramid bounds (`pyramid_mu`).  Unlike csrc/jacobi.cu it takes
// no bounds: they are built here from the lane masks.  Row i < 3K of lane
// k = i / 3:
//   inactive lane              -> never projected;
//   equality (ball-joint) lane -> clamped to [-3.4e38, 3.4e38] (free);
//   tangential row (i % 3 < 2) -> clamped to [-mu, mu]; under the pyramid
//                                 to [-c, c], c = pyramid_mu max(x_3k+2, 0)
//                                 of the pre-sweep iterate (x0: [0, 0]);
//   normal row                 -> clamped to [0, 3.4e38].
// Rows 3K..mp-1 have b = 0 and a unit row of A, and are not projected.
// diag(A) comes from the A-formation kernel and is not re-read from A.
// x0 = proj(b), then `iters` sweeps of
//   scalar: r = b - A x + diag x;  x <- proj((1 - omega) x + omega r / diag + beta (x - x_prev));
//   block:  rv = b - A x;  y_i = x_i + sum_c inv(A_kk)[r, c] rv_3k+c (rows < 3K),
//           y_i = x_i + rv_i / diag_i (padding rows);
//           x <- proj((1 - omega) x + omega y + beta (x - x_prev)).
//
// What bounds it on an H100: A is read once, mp^2 floats a scenario
// (16 KB at mp = 64), against iters * 2 mp^2 flops: about 8 flops a byte
// at 16 sweeps, below the card's 20 flops a byte in float32, so bytes.
// The design of csrc/jacobi.cu: one block per scenario holds A in shared
// memory with a row stride of mp + 1 (a warp reading its rows at one column
// hits 32 banks), one thread per row, every sweep inside the kernel.  The
// TPU kernel's (8, mp*mp, 128) sublane stripes are not carried over.  The
// block form adds per thread its row of the lane's 3x3 block inverse (three
// registers, built once from shared memory) and one shared vector, the
// residual rv, which the lane's three threads read after a barrier; the
// pyramid form reads the lane's normal row of the iterate from shared
// memory before the barrier that overwrites it.  Each form is its own
// kernel (distinct names in a profile); the row sums are those of the
// scalar form, so B6b and the scalar form stay alike bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block3.cuh"

namespace {

constexpr float kHiInf = 3.4e38f;

template <bool kBlock, bool kPyramid>
__device__ __forceinline__ void jacobi_packed_body(
    const float* __restrict__ A, const float* __restrict__ diag, const float* __restrict__ rhs,
    const uint8_t* __restrict__ act, const uint8_t* __restrict__ eq, float* __restrict__ x_out,
    int K, int mp, int iters, float mu, float omega, float beta, float pyramid_mu) {
  extern __shared__ float smem[];
  const int ld = mp + 1;
  float* sA = smem;             // mp rows of stride ld
  float* sx = smem + mp * ld;   // current iterate
  float* srv = sx + mp;         // block form: b - A x of the sweep
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
  // tangential row bounded by its lane's normal impulse (pyramid form)
  const bool coupled = kPyramid && real && !eqi && i % 3 < 2;
  float lo = 0.f, hi = kHiInf;
  if (eqi) {
    lo = -kHiInf;
  } else if (i % 3 < 2) {
    const float mu_s = kPyramid ? 0.f : mu;
    lo = -mu_s;
    hi = mu_s;
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
  float bc[3] = {0.f, 0.f, 0.f};
  if (kBlock && real) block_inverse_row(sA, ld, k, i % 3, bc);

  for (int it = 0; it < iters; ++it) {
    float xn = 0.f, rv = 0.f;
    if (row) {
      const float* a = sA + i * ld;
      float ax = 0.f;
      for (int j = 0; j < mp; ++j) ax = ax + a[j] * sx[j];
      rv = bi - ax;
      if (kPyramid && coupled) {
        const float cap = fmaxf(sx[3 * k + 2], 0.f) * pyramid_mu;
        lo = -cap;
        hi = cap;
      }
      if (kBlock) {
        srv[i] = rv;
      } else {
        const float r = rv + d * x;
        xn = (1.f - omega) * x + omega * r * inv_d + beta * (x - xprev);
        if (active) xn = fminf(fmaxf(xn, lo), hi);
      }
    }
    __syncthreads();
    if (kBlock && row) {
      const float y = real ? x + bc[0] * srv[3 * k] + bc[1] * srv[3 * k + 1] +
                                 bc[2] * srv[3 * k + 2]
                           : x + rv * inv_d;
      xn = (1.f - omega) * x + omega * y + beta * (x - xprev);
      if (active) xn = fminf(fmaxf(xn, lo), hi);
    }
    if (row) {
      sx[i] = xn;
      xprev = x;
      x = xn;
    }
    __syncthreads();
  }
  if (row) x_out[s * mp + i] = x;
}

#define JACOBI_PACKED_KERNEL(name, block, pyramid)                                          \
  __global__ void name(const float* __restrict__ A, const float* __restrict__ diag,         \
                       const float* __restrict__ rhs, const uint8_t* __restrict__ act,      \
                       const uint8_t* __restrict__ eq, float* __restrict__ x_out, int K,    \
                       int mp, int iters, float mu, float omega, float beta,                \
                       float pyramid_mu) {                                                  \
    jacobi_packed_body<block, pyramid>(A, diag, rhs, act, eq, x_out, K, mp, iters, mu,      \
                                       omega, beta, pyramid_mu);                            \
  }

JACOBI_PACKED_KERNEL(jacobi_packed_kernel, false, false)
JACOBI_PACKED_KERNEL(jacobi_packed_pyramid_kernel, false, true)
JACOBI_PACKED_KERNEL(jacobi_packed_block_kernel, true, false)
JACOBI_PACKED_KERNEL(jacobi_packed_block_pyramid_kernel, true, true)

typedef void (*PackedKernel)(const float*, const float*, const float*, const uint8_t*,
                             const uint8_t*, float*, int, int, int, float, float, float, float);

// `block`: the kernel is a block form and needs the shared residual vector.
// The scalar forms leave it out: at mp = 96 those mp floats would cost a
// sixth of the blocks an SM holds.
int launch(PackedKernel kernel, bool block, const float* A, const float* diag, const float* rhs,
           const uint8_t* act, const uint8_t* eq, float* x, int64_t B, int K, int mp, int iters,
           float mu, float omega, float beta, float pyramid_mu, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = (size_t)(mp * (mp + 1) + (block ? 2 : 1) * mp) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = ((mp + 31) / 32) * 32;
  kernel<<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(A, diag, rhs, act, eq, x, K, mp,
                                                               iters, mu, omega, beta, pyramid_mu);
  return (int)cudaGetLastError();
}

}  // namespace

// Scalar sweeps, box bounds (pyramid_mu unused).
extern "C" int eggshell_jacobi_packed_f32(const float* A, const float* diag, const float* rhs,
                                          const uint8_t* act, const uint8_t* eq, float* x,
                                          int64_t B, int K, int mp, int iters, float mu,
                                          float omega, float beta, float pyramid_mu,
                                          void* stream) {
  return launch(jacobi_packed_kernel, false, A, diag, rhs, act, eq, x, B, K, mp, iters, mu, omega,
                beta, pyramid_mu, stream);
}

// Scalar sweeps, Coulomb-pyramid bounds (pyramid_mu > 0).
extern "C" int eggshell_jacobi_packed_pyramid_f32(const float* A, const float* diag,
                                                  const float* rhs, const uint8_t* act,
                                                  const uint8_t* eq, float* x, int64_t B, int K,
                                                  int mp, int iters, float mu, float omega,
                                                  float beta, float pyramid_mu, void* stream) {
  return launch(jacobi_packed_pyramid_kernel, false, A, diag, rhs, act, eq, x, B, K, mp, iters, mu,
                omega, beta, pyramid_mu, stream);
}

// 3x3 block sweeps: box bounds for pyramid_mu = 0, pyramid bounds above.
extern "C" int eggshell_jacobi_packed_block_f32(const float* A, const float* diag,
                                                const float* rhs, const uint8_t* act,
                                                const uint8_t* eq, float* x, int64_t B, int K,
                                                int mp, int iters, float mu, float omega,
                                                float beta, float pyramid_mu, void* stream) {
  return launch(pyramid_mu > 0.f ? jacobi_packed_block_pyramid_kernel : jacobi_packed_block_kernel,
                true, A, diag, rhs, act, eq, x, B, K, mp, iters, mu, omega, beta, pyramid_mu,
                stream);
}
