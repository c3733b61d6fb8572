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
// What bounds it on an H100.  A is read once, mp^2 floats a scenario (16 KB
// at mp = 64), against iters * 2 mp^2 flops: about 8 flops a byte at 16
// sweeps.  The bytes bound is 0.021 ms at mp = 64 and B = 4096; the flops,
// built with --fmad=false, are 537 M FMUL and FADD instructions, about
// 0.018 ms over 132 SMs.  Both hold only if the inner loop reads A from
// registers: read from shared memory, as the first design did, every
// product costs two shared loads (a_ij and x_j), about 73 us of shared
// issue at mp = 64 (this kernel with rows read from shared memory: 0.0681
// against 0.0434 ms, tools/jacobi_packed_probe.py on an H100 SXM at
// 700 W).  The tensor cores do not apply: each scenario multiplies its own
// A by one vector, half a flop a byte with no reuse across a tile, so
// wgmma has nothing to amortise, and TF32 would change the numerics.
//
// The design:
// - A persistent grid, as many blocks as the card holds at once
//   (`cudaOccupancyMaxActiveBlocksPerMultiprocessor` x SMs); each block walks
//   the scenarios s = blockIdx.x, + gridDim.x, ...  One thread a row,
//   T = mp rounded up to a warp.
// - A scenario's A arrives by one 2D tensor TMA copy into a stage in shared
//   memory, completing on an mbarrier (csrc/jacobi_rows.cuh: row stride
//   mp + 4, the four columns past mp filled with zeros by the copy, so the
//   float4 reads of a column chunk are free of bank conflicts).  The
//   block's next scenario is read ahead: its b, diag and lane masks into
//   registers, its A into the stage.
// - Row lengths up to 128 (template RL = 32, 64, 96 or 128, mp rounded up
//   to a warp): each thread moves its row from the stage into RL registers,
//   columns past mp zero, and the stage is refilled with the block's next
//   scenario while this one sweeps.  The registers and the stage are the
//   two stages of the ring: a second stage in shared memory measured slower,
//   since it halves the blocks an SM holds at mp = 64 and 96.  Longer rows
//   (RL = 0) stay in the stage and are read from there, as the first design
//   did; the stage is refilled after the sweeps, and the other blocks of
//   the SM keep it busy meanwhile.
// - The iterate lives in shared memory, double-buffered, zero past mp, and
//   is read as float4 broadcasts: 16 loads a warp a sweep at mp = 64.  One
//   barrier a sweep (two for the block form, whose lane residuals pass
//   through shared memory between them).
// - Each row's A x is summed over j in increasing order, by the functions
//   B6b (csrc/jacobi_packed_stream.cu) uses too, so B6b returns B6's bits.
// The block form adds per thread its row of the lane's 3x3 block inverse
// (three registers, built once from the stage, csrc/block3.cuh); the
// pyramid form reads the lane's normal row of the pre-sweep iterate.  Each
// form is its own kernel (distinct names in a profile).
//
// Shared memory, in bytes: the stage, mp rows of stride mp + 4 floats
// rounded up to 128 bytes; 16 bytes for the mbarrier; the two iterates, 2 T
// floats, and the block form's residual, T floats.
// `ops/pgs_kernel.py:packed_launch_plan` computes the same and picks RL.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block3.cuh"
#include "jacobi_rows.cuh"

namespace {

using namespace jacobi_rows;

template <int RL, bool kBlock, bool kPyramid>
__device__ __forceinline__ void jacobi_packed_body(
    const CUtensorMap* tmap, const float* __restrict__ A, const float* __restrict__ diag,
    const float* __restrict__ rhs, const uint8_t* __restrict__ act,
    const uint8_t* __restrict__ eq, float* __restrict__ x_out, int64_t B, int K, int mp,
    int iters, float mu, float omega, float beta, float pyramid_mu) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int T = blockDim.x;
  float* sA = reinterpret_cast<float*>(smem_raw);                 // mp rows of ld
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + stage_bytes(mp, mp));
  float* sx = reinterpret_cast<float*>(bar + 2);                  // 2 iterates of T floats
  float* srv = sx + 2 * T;                                        // block form: b - A x
  const int ld = mp + 4;
  const int i = threadIdx.x;
  const bool row = i < mp;
  const bool real = i < 3 * K;
  const int k = i / 3;

  if (i == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (i < 32) load_rows(sA, tmap, A, blockIdx.x * (int64_t)mp, mp, mp, mp, bar);

  uint32_t parity = 0;  // of the stage's phase this scenario waits for
  RowInputs ahead = row_inputs(rhs, diag, act, eq, blockIdx.x, K, mp, i);
  for (int64_t s = blockIdx.x; s < B; s += gridDim.x, parity ^= 1u) {
    const int64_t next = s + gridDim.x;
    const RowInputs in = ahead;
    if (next < B) ahead = row_inputs(rhs, diag, act, eq, next, K, mp, i);

    const RowBounds rb = row_bounds(in, i, kPyramid ? 0.f : mu);
    // tangential row bounded by its lane's normal impulse (pyramid form)
    const bool coupled = kPyramid && real && !in.eq && i % 3 < 2;
    float lo = rb.lo, hi = rb.hi;
    const float bi = in.b, d = in.d, inv_d = 1.f / d;
    float x = in.act ? fminf(fmaxf(bi, lo), hi) : bi;
    float xprev = x;

    mbar_wait(bar, parity);
    RegRow<(RL > 0 ? RL : 4)> a;
    if (RL > 0) a.load(sA + (row ? i : 0) * ld, row ? mp : 0);
    float bc[3] = {0.f, 0.f, 0.f};
    if (kBlock && real) block_inverse_row(sA, ld, k, i % 3, bc);
    sx[i] = x;  // 0 past mp
    __syncthreads();  // x0 visible; the stage is read (register rows)
    if (RL > 0 && i < 32 && next < B) load_rows(sA, tmap, A, next * mp, mp, mp, mp, bar);

    for (int it = 0; it < iters; ++it) {
      const float* xc = sx + (it & 1) * T;
      float* xn_buf = sx + ((it + 1) & 1) * T;
      float xn = 0.f, rv = 0.f;
      if (row) {
        const float ax = RL > 0 ? a.dot(xc) : shared_dot(sA + i * ld, xc, mp);
        rv = bi - ax;
        if (kPyramid && coupled) {
          const float cap = fmaxf(xc[3 * k + 2], 0.f) * pyramid_mu;
          lo = -cap;
          hi = cap;
        }
        if (!kBlock) xn = scalar_update(rv, x, xprev, d, inv_d, omega, beta, in.act, lo, hi);
      }
      if (kBlock) {
        srv[i] = rv;
        __syncthreads();
        if (row) {
          const float y = real ? x + bc[0] * srv[3 * k] + bc[1] * srv[3 * k + 1] +
                                     bc[2] * srv[3 * k + 2]
                               : x + rv * inv_d;
          xn = (1.f - omega) * x + omega * y + beta * (x - xprev);
          if (in.act) xn = fminf(fmaxf(xn, lo), hi);
        }
      }
      xn_buf[i] = xn;
      if (row) {
        xprev = x;
        x = xn;
      }
      __syncthreads();
    }
    if (row) x_out[s * mp + i] = x;
    if (RL == 0) {
      __syncthreads();  // the stage's rows are read (also with no sweep)
      if (i < 32 && next < B) load_rows(sA, tmap, A, next * mp, mp, mp, mp, bar);
    }
  }
}

#define JACOBI_PACKED_KERNEL(name, block, pyramid)                                           \
  template <int RL>                                                                          \
  __global__ void name(const __grid_constant__ CUtensorMap tmap, const float* __restrict__ A, \
                       const float* __restrict__ diag, const float* __restrict__ rhs,        \
                       const uint8_t* __restrict__ act, const uint8_t* __restrict__ eq,      \
                       float* __restrict__ x_out, int64_t B, int K, int mp, int iters,       \
                       float mu, float omega, float beta, float pyramid_mu) {                \
    jacobi_packed_body<RL, block, pyramid>(&tmap, A, diag, rhs, act, eq, x_out, B, K, mp,    \
                                           iters, mu, omega, beta, pyramid_mu);              \
  }

JACOBI_PACKED_KERNEL(jacobi_packed_kernel, false, false)
JACOBI_PACKED_KERNEL(jacobi_packed_pyramid_kernel, false, true)
JACOBI_PACKED_KERNEL(jacobi_packed_block_kernel, true, false)
JACOBI_PACKED_KERNEL(jacobi_packed_block_pyramid_kernel, true, true)

typedef void (*PackedKernel)(const CUtensorMap, const float*, const float*, const float*,
                             const uint8_t*, const uint8_t*, float*, int64_t, int, int, int, float,
                             float, float, float);

// `name##_for(rl)`: the instantiation of a form for row length `rl` (0: rows
// in shared memory), or null for a length that is not instantiated.
#define FORM_TABLE(name)                                                                    \
  PackedKernel name##_for(int rl) {                                                         \
    switch (rl) {                                                                           \
      case 0: return name<0>;                                                               \
      case 32: return name<32>;                                                             \
      case 64: return name<64>;                                                             \
      case 96: return name<96>;                                                             \
      case 128: return name<128>;                                                           \
      default: return nullptr;                                                              \
    }                                                                                       \
  }

FORM_TABLE(jacobi_packed_kernel)
FORM_TABLE(jacobi_packed_pyramid_kernel)
FORM_TABLE(jacobi_packed_block_kernel)
FORM_TABLE(jacobi_packed_block_pyramid_kernel)

// Launch one form on a persistent grid.  `rl` comes from the caller's
// launch plan; a row length this file does not take is refused.
int launch(PackedKernel kernel, bool block, const float* A, const float* diag, const float* rhs,
           const uint8_t* act, const uint8_t* eq, float* x, int64_t B, int K, int mp, int iters,
           float mu, float omega, float beta, float pyramid_mu, int rl, void* stream) {
  if (B <= 0) return 0;
  const int T = ((mp + 31) / 32) * 32;
  if (kernel == nullptr || mp <= 0 || mp % 8 != 0 || 3 * K > mp || (rl != 0 && rl != T))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)B * mp > INT32_MAX) return (int)cudaErrorInvalidValue;  // a box's row coordinate
  const size_t smem = stage_bytes(mp, mp) + 16 + 4 * (size_t)(2 + (block ? 1 : 0)) * T;
  cudaError_t e = allow_shared((const void*)kernel, smem);
  if (e != cudaSuccess) return (int)e;
  int err = 0;
  const int sms = sm_count(&err);
  if (err != 0) return err;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t grid = B < (int64_t)per_sm * sms ? B : (int64_t)per_sm * sms;
  CUtensorMap tmap;
  const int enc = encode_rows_map(&tmap, A, B * mp, mp, mp, mp);
  if (enc != 0) return enc;
  kernel<<<(unsigned)grid, T, smem, (cudaStream_t)stream>>>(
      tmap, A, diag, rhs, act, eq, x, B, K, mp, iters, mu, omega, beta, pyramid_mu);
  return (int)cudaGetLastError();
}

}  // namespace

// Scalar sweeps, box bounds (pyramid_mu unused).
extern "C" int eggshell_jacobi_packed_f32(const float* A, const float* diag, const float* rhs,
                                          const uint8_t* act, const uint8_t* eq, float* x,
                                          int64_t B, int K, int mp, int iters, float mu,
                                          float omega, float beta, float pyramid_mu, int rl,
                                          void* stream) {
  return launch(jacobi_packed_kernel_for(rl), false, A, diag, rhs, act, eq, x, B, K, mp, iters,
                mu, omega, beta, pyramid_mu, rl, stream);
}

// Scalar sweeps, Coulomb-pyramid bounds (pyramid_mu > 0).
extern "C" int eggshell_jacobi_packed_pyramid_f32(const float* A, const float* diag,
                                                  const float* rhs, const uint8_t* act,
                                                  const uint8_t* eq, float* x, int64_t B, int K,
                                                  int mp, int iters, float mu, float omega,
                                                  float beta, float pyramid_mu, int rl,
                                                  void* stream) {
  return launch(jacobi_packed_pyramid_kernel_for(rl), false, A, diag, rhs, act, eq, x, B, K, mp,
                iters, mu, omega, beta, pyramid_mu, rl, stream);
}

// 3x3 block sweeps: box bounds for pyramid_mu = 0, pyramid bounds above.
extern "C" int eggshell_jacobi_packed_block_f32(const float* A, const float* diag,
                                                const float* rhs, const uint8_t* act,
                                                const uint8_t* eq, float* x, int64_t B, int K,
                                                int mp, int iters, float mu, float omega,
                                                float beta, float pyramid_mu, int rl,
                                                void* stream) {
  return launch(pyramid_mu > 0.f ? jacobi_packed_block_pyramid_kernel_for(rl)
                                 : jacobi_packed_block_kernel_for(rl),
                true, A, diag, rhs, act, eq, x, B, K, mp, iters, mu, omega, beta, pyramid_mu, rl,
                stream);
}
