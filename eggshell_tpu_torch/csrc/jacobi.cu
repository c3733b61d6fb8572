// Batched under-relaxed projected Jacobi for mixed LCPs with per-row
// bounds, float32: scalar heavy-ball sweeps (B6c) and exact 3x3
// block-Jacobi sweeps (B6c').
//
// Replaces the TPU kernels `_jacobi_kernel` (B6c) and `_block_jacobi_kernel`
// (B6c') of eggshell_tpu/ops/pgs_kernel.py, both reached through
// `solve_lcp_jacobi_pallas` (block=False / True).  Semantics, per
// scenario, with rows padded to mp = m rounded up to 8 (unit diagonal,
// b = 0, equality) and hi = +-inf read as 3.4e38, as the TPU kernel's
// wrapper has it: x0 = proj(b), then `iters` sweeps of
//   scalar: x <- proj((1 - omega) x + omega (b - A x + D x) D^-1 + beta (x - x_prev)),
//   block (m % 3 == 0): rv = b - A x;  y_i = x_i + sum_c inv(A_kk)[r, c] rv_3k+c
//          (i = 3k + r);  x <- proj((1 - omega) x + omega y),
// where proj clamps inequality rows to [lo, hi] and leaves equality rows
// free.  The padding rows stay at exactly 0 and never touch the real rows,
// so the kernels leave them out: they are idle threads whose iterate is 0.
//
// What bounds them on an H100: each sweep is a dense (m x m) mat-vec, so a
// scenario costs iters * 2 m^2 flops against one read of A (4 m^2 bytes):
// about 8 flops a byte at 16 sweeps, at the ridge of the card's float32
// rate and HBM bandwidth.  At m = 60, B = 4096 the bytes bound is 0.0189
// ms.  Both hold only if A is read from device memory once and each
// product reads a_ij from a register: read from shared memory, as the first
// design did (A copied element by element, a_ij and x_j both from shared
// memory, two barriers a sweep), the shared loads alone cost about 0.07 ms
// at m = 60, and the kernel took 0.1496 ms.  The tensor cores do not apply:
// each scenario multiplies its own A by one vector, with no reuse across a
// tile, and TF32 would change the numerics.
//
// Four forms, one launch plan (`ops/pgs_kernel.py:jacobi_launch_plan`):
//
// - Resident (`jacobi_kernel`, `block_jacobi_kernel`), B6's design
//   (csrc/jacobi_packed.cu) with B6c's inputs.  A persistent grid of
//   `cudaOccupancyMaxActiveBlocksPerMultiprocessor` x SMs blocks, each
//   walking the scenarios; one thread a row, T = mp rounded up to a warp.
//   A scenario's m rows arrive in one stage of shared memory with row
//   stride mp + 4 (csrc/jacobi_rows.cuh): by one 2D tensor TMA over A seen
//   as (B m, m), a box of (mp + 4) x m, so the columns past m fall out of
//   the tensor and arrive as zeros and the box stops at the scenario's
//   last row; where m % 4 != 0 a row's stride is not a multiple of 16
//   bytes, which a tensor map needs, and the threads copy the rows
//   themselves with 4-byte `cp.async`, a warp a row, into the same layout
//   (the zero columns written once).  diag is read from the stage; the
//   rows, of up to 128 floats (mp <= 128), then move into registers
//   (template RL = 32, 64, 96, 128) and the stage is refilled with the
//   block's next scenario while this one sweeps.  A longer row would keep
//   part of itself in the stage, and each of its products would cost a
//   shared load of a_ij beside x_j's: a build of this form that did so
//   took 0.3534 ms at m = 136 against 0.1461 at m = 128 with the row in
//   registers, and 0.3876 ms at mp = 136 against 0.3140 for the cluster
//   form (tools/jacobi_probe.py, H100 SXM at 700 W), so past 128 rows the
//   cluster form takes over.  The iterate is double-buffered in shared
//   memory, zero past m, read as float4 broadcasts: one barrier a sweep
//   (two in the block form, whose 3-row residuals pass through shared
//   memory).  The next scenario's b, lo, hi and flags are read ahead into
//   registers.
// - Cluster (`jacobi_cluster_kernel`, `block_jacobi_cluster_kernel`), B6b's
//   design (csrc/jacobi_packed_stream.cu), past 128 rows.  One scenario's
//   rows are split over a cluster of c blocks, R rows each (the last
//   block fewer), and read once; the block form splits at multiples of 3,
//   so no 3-row block straddles two blocks.  c is at most 8, the portable
//   size, up to mp = 664, and 9 to 16 past that (Hopper's non-portable
//   cluster, `cudaFuncAttributeNonPortableClusterSizeAllowed`), which holds
//   a scenario's A up to about 944 rows: there one block fills an SM's
//   shared memory.  Each block keeps the whole
//   iterate; each sweep a row's new value goes to every block by
//   `st.async`, completing on the receiving block's mbarrier, with no
//   cluster barrier inside a scenario.  A row's first 128 columns are held
//   in registers and the rest of a longer row is summed from the stage,
//   which is refilled only after the sweeps.  The tensor map's box is R
//   rows, so a last block of fewer rows takes its rows by one bulk copy a
//   row instead: no block reads rows of the next scenario.  Rows wider than
//   252 floats (past a tensor box's 256 columns) arrive by one bulk copy a
//   row in every block.  Each row's sum is one chain of m dependent adds
//   (the bits forbid splitting it), and one scenario's A fills an SM's
//   shared memory at m = 240, so each SM has about 8 warps of rows to hide
//   that chain with: the form runs at 3.1 to 3.8x its bytes bound there.
// - Streamed rows (`jacobi_streamed_kernel`, `block_jacobi_streamed_kernel`,
//   csrc/rows_stream.cuh), past what a cluster of 16 holds: the cluster's
//   split and exchange, each block streaming its rows from device memory
//   every sweep through a ring of stages filled by a copy warp.
// - Global rows (`jacobi_global_kernel`, `block_jacobi_global_kernel`),
//   past what the streamed form's ring and iterate leave room for: one
//   block a scenario reads A's rows from device memory every sweep
//   (csrc/rows_global.cuh), in tiles of 32 columns with two block barriers
//   each.  It stays the reference for the other forms' bits.
//
// Every form sums each row over j in increasing order, one product and one
// add at a time (--fmad=false), and updates it in the same expressions, so
// the four return the same bits on any m they all take.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block3.cuh"
#include "jacobi_rows.cuh"
#include "rows_global.cuh"
#include "rows_stream.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace jacobi_rows;

// How a stage is filled; the caller's launch plan names it.
enum Copy : int {
  kTensorMap = 0,  // one 2D tensor copy (m % 4 == 0, mp + 4 <= 256)
  kBulkRows = 1,   // one bulk copy a row (m % 4 == 0)
  kElements = 2,   // 4-byte cp.async by every thread
};

__device__ __forceinline__ float proj(float x, bool eq, float lo, float hi) {
  return eq ? x : fminf(fmaxf(x, lo), hi);
}

// Row i's b, lo, hi (an infinite hi read as 3.4e38) and equality flag;
// padding rows (i >= m) have b = 0 and are equality rows.
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
  const float h = hi[r];
  return {b[r], lo[r], isinf(h) ? kHiInf : h, is_eq[r] != 0};
}

// Zero columns m..ld-1 of the stage's `rows` rows, which the bulk and
// element copies do not write.
__device__ __forceinline__ void zero_pad_columns(float* stage, int rows, int m, int ld) {
  const int w = ld - m;
  for (int e = threadIdx.x; e < rows * w; e += blockDim.x) stage[(e / w) * ld + m + e % w] = 0.f;
}

// Start the copy of `nrows` rows of A, from row row0 of the (B m, m) view,
// into the stage (row stride mp + 4).  Called by every thread.  A tensor
// copy moves `box_rows` rows, the box the map was encoded with.
__device__ __forceinline__ void fill_stage(int copy, float* stage, const CUtensorMap* tmap,
                                           const float* __restrict__ A, int64_t row0, int nrows,
                                           int box_rows, int m, int mp, uint64_t* bar) {
  if (copy == kElements) {
    const int ld = mp + 4, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
    for (int r = threadIdx.x / 32; r < nrows; r += nwarps) {
      const float* src = A + (row0 + r) * m;
      for (int j = lane; j < m; j += 32) __pipeline_memcpy_async(stage + r * ld + j, src + j, 4);
    }
    __pipeline_commit();
    return;
  }
  if (threadIdx.x < 32)
    load_rows(stage, copy == kTensorMap ? tmap : nullptr, A, row0,
              copy == kTensorMap ? box_rows : nrows, mp, m, bar);
}

// Row i's A x: its first RL columns from registers, then, for rows longer
// than 128 (RL = 128 only), the rest from the stage, summed on in
// increasing j.
template <int RL>
__device__ __forceinline__ float row_dot(const RegRow<RL>& a, const float* row, const float* x,
                                         int mp) {
  float ax = a.dot(x);
  if (RL == 128 && mp > RL)
    ax = dot4(reinterpret_cast<const float4*>(row), reinterpret_cast<const float4*>(x), RL / 4,
              mp / 4, ax);
  return ax;
}

// Wait until the stage's copy has landed, for every thread of the block.
__device__ __forceinline__ void wait_stage(int copy, uint64_t* bar, uint32_t parity) {
  if (copy == kElements) {
    __pipeline_wait_prior(0);
    __syncthreads();
  } else {
    mbar_wait(bar, parity);
  }
}

// The resident form, mp <= RL.  Shared memory: the stage (m rows of stride
// mp + 4, rounded up to 128 bytes), 16 bytes of mbarrier, two iterates of T
// floats and the block form's residual, T floats.
template <int RL, bool kBlock>
__device__ __forceinline__ void resident_body(
    const CUtensorMap* tmap, int copy, const float* __restrict__ A, const float* __restrict__ b,
    const uint8_t* __restrict__ is_eq, const float* __restrict__ lo,
    const float* __restrict__ hi, float* __restrict__ x_out, int64_t B, int m, int mp,
    int iters, float omega, float beta) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int T = blockDim.x;
  const int ld = mp + 4;
  float* sA = reinterpret_cast<float*>(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + stage_bytes(m, mp));
  float* sx = reinterpret_cast<float*>(bar + 2);  // 2 iterates of T floats
  float* srv = sx + 2 * T;                        // block form: b - A x
  const int i = threadIdx.x;
  const bool row = i < m;
  const int k = i / 3;

  if (i == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
  }
  if (copy != kTensorMap) zero_pad_columns(sA, m, m, ld);
  __syncthreads();
  fill_stage(copy, sA, tmap, A, blockIdx.x * (int64_t)m, m, m, m, mp, bar);

  uint32_t parity = 0;  // of the stage's phase this scenario waits for
  RowIn ahead = row_in(b, is_eq, lo, hi, blockIdx.x, m, i);
  for (int64_t s = blockIdx.x; s < B; s += gridDim.x, parity ^= 1u) {
    const int64_t next = s + gridDim.x;
    const RowIn in = ahead;
    if (next < B) ahead = row_in(b, is_eq, lo, hi, next, m, i);
    float x = row ? proj(in.b, in.eq, in.lo, in.hi) : 0.f;
    float xprev = x;

    wait_stage(copy, bar, parity);
    const float d = row ? sA[i * ld + i] : 1.f, inv_d = 1.f / d;
    RegRow<RL> a;
    a.load(sA + (row ? i : 0) * ld, row ? mp : 0);
    float bc[3] = {0.f, 0.f, 0.f};
    if (kBlock && row) block_inverse_row(sA, ld, k, i % 3, bc);
    sx[i] = x;  // 0 past m
    __syncthreads();  // x0 visible; the stage is read
    if (next < B) fill_stage(copy, sA, tmap, A, next * m, m, m, m, mp, bar);

    for (int it = 0; it < iters; ++it) {
      const float* xc = sx + (it & 1) * T;
      float* xn_buf = sx + ((it + 1) & 1) * T;
      float xn = 0.f, rv = 0.f;
      if (row) {
        rv = in.b - a.dot(xc);
        if (!kBlock) xn = scalar_update(rv, x, xprev, d, inv_d, omega, beta, !in.eq, in.lo, in.hi);
      }
      if (kBlock) {
        srv[i] = rv;
        __syncthreads();
        if (row) {
          const float y = x + bc[0] * srv[3 * k] + bc[1] * srv[3 * k + 1] + bc[2] * srv[3 * k + 2];
          xn = proj((1.f - omega) * x + omega * y, in.eq, in.lo, in.hi);
        }
      }
      xn_buf[i] = xn;
      if (row) {
        xprev = x;
        x = xn;
      }
      __syncthreads();
    }
    if (row) x_out[s * m + i] = x;
  }
}

// The cluster form.  Block `rank` holds rows rank R .. rank R + nr - 1.
// Shared memory: the stage (R rows of stride mp + 4, rounded up to 128
// bytes), 32 bytes of mbarriers (the stage's, one an iterate buffer), two
// iterates of X floats (X = mp rounded up to a warp) and the block form's
// residual, T floats.  Rows 0..m-1 of an iterate are sent; the rest stays 0.
template <int RL, bool kBlock>
__device__ __forceinline__ void cluster_body(
    const CUtensorMap* tmap, int copy, const float* __restrict__ A, const float* __restrict__ b,
    const uint8_t* __restrict__ is_eq, const float* __restrict__ lo,
    const float* __restrict__ hi, float* __restrict__ x_out, int64_t B, int m, int mp, int R,
    int iters, float omega, float beta) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int X = ((mp + 31) / 32) * 32;
  const int ld = mp + 4;
  float* sA = reinterpret_cast<float*>(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + stage_bytes(R, mp));
  uint64_t* xbars = bar + 1;
  float* xfull = reinterpret_cast<float*>(bar + 4);  // 2 x X: the whole iterate
  float* srv = xfull + 2 * X;                        // block form: b - A x of this block's rows
  const int r0 = rank * R;
  const int nr = min(R, m - r0);  // rows of this block (the plan leaves none empty)
  const int li = threadIdx.x;     // local row
  const int i = r0 + li;          // row of the scenario
  const bool row = li < nr;
  const int ri = row ? i : m;     // idle threads read nothing
  const int lg = li - li % 3;     // block form: the local row of this row's 3-row block
  const bool tail = RL == 128 && mp > RL;  // tails stay in the stage: refill after the sweeps
  const int64_t q0 = blockIdx.x / c, nclusters = gridDim.x / c;
  // a box of R rows would overrun a shorter last block into the next scenario
  if (copy == kTensorMap && nr < R) copy = kBulkRows;

  if (li == 0) {
    mbar_init(bar, 1);
    mbar_init(&xbars[0], 1);
    mbar_init(&xbars[1], 1);
    fence_mbar_init();
  }
  for (int j = li; j < 2 * X; j += blockDim.x) xfull[j] = 0.f;  // stays 0 past m
  if (copy != kTensorMap) zero_pad_columns(sA, R, m, ld);
  cluster.sync();  // every block runs and has its barriers before any store reaches it
  fill_stage(copy, sA, tmap, A, q0 * m + r0, nr, R, m, mp, bar);

  uint32_t parity = 0;  // bit b: parity of the phase buffer b's barrier is in
  uint32_t stage_parity = 0;
  RowIn ahead = row_in(b, is_eq, lo, hi, q0, m, ri);
  for (int64_t s = q0; s < B; s += nclusters, stage_parity ^= 1u) {
    const int64_t next = s + nclusters;
    const RowIn in = ahead;
    if (next < B) ahead = row_in(b, is_eq, lo, hi, next, m, ri);
    float x = row ? proj(in.b, in.eq, in.lo, in.hi) : 0.f;
    float xprev = x;

    wait_stage(copy, bar, stage_parity);
    const float d = row ? sA[li * ld + i] : 1.f, inv_d = 1.f / d;
    RegRow<RL> a;
    a.load(sA + (row ? li : 0) * ld, row ? mp : 0);
    float bc[3] = {0.f, 0.f, 0.f};
    if (kBlock && row) block_inverse_row(sA + lg * ld + (i - li % 3), ld, 0, li % 3, bc);
    __syncthreads();  // the stage is read (rows of at most RL)
    if (!tail && next < B) fill_stage(copy, sA, tmap, A, next * m + r0, nr, R, m, mp, bar);

    // x_t goes to buffer t & 1 of every block; buffer b's barrier expects
    // m * 4 bytes a phase, armed by thread 0 once the phase before is done.
    // A buffer is written again two sweeps later, only by a block that has
    // received all of the sweep between, which every thread of this block
    // sends after it has read the buffer (and, in the block form, its
    // residuals): the data flow keeps a write from overtaking a read.
    if (iters > 0) {
      if (li == 0) mbar_expect(&xbars[0], (uint32_t)m * 4u);
      if (row)
        for (int r = 0; r < c; ++r) send(cluster_addr(xfull + i, r), x, cluster_addr(&xbars[0], r));
    }
    for (int it = 0; it < iters; ++it) {
      const int bb = it & 1;
      mbar_wait(&xbars[bb], (parity >> bb) & 1u);
      parity ^= 1u << bb;
      const bool more = it + 1 < iters;
      if (more && li == 0) mbar_expect(&xbars[bb ^ 1], (uint32_t)m * 4u);
      float xn = 0.f, rv = 0.f;
      if (row) {
        const float* xc = xfull + bb * X;
        const float ax = row_dot(a, sA + li * ld, xc, mp);
        rv = in.b - ax;
        if (!kBlock) xn = scalar_update(rv, x, xprev, d, inv_d, omega, beta, !in.eq, in.lo, in.hi);
      }
      if (kBlock) {
        srv[li] = rv;
        __syncthreads();
        if (row) {
          const float y =
              x + bc[0] * srv[lg] + bc[1] * srv[lg + 1] + bc[2] * srv[lg + 2];
          xn = proj((1.f - omega) * x + omega * y, in.eq, in.lo, in.hi);
        }
      }
      if (row) {
        if (more)
          for (int r = 0; r < c; ++r)
            send(cluster_addr(xfull + (bb ^ 1) * X + i, r), xn, cluster_addr(&xbars[bb ^ 1], r));
        xprev = x;
        x = xn;
      }
    }
    if (row) x_out[s * m + i] = x;
    cluster.sync();  // every block is done with this scenario's iterates and stage
    if (tail && next < B) fill_stage(copy, sA, tmap, A, next * m + r0, nr, R, m, mp, bar);
  }
}

// One signature for every on-chip form: R (rows a block) is read by the
// cluster forms only, beta by the scalar forms only.  A resident block of
// RL threads is held to 128 registers a thread up to RL = 64 (16 and 8
// blocks an SM) and 170 at RL = 96 (4 blocks).
#define RESIDENT_KERNEL(name, block)                                                          \
  template <int RL>                                                                           \
  __global__ void __launch_bounds__(RL, RL == 32 ? 16 : RL == 64 ? 8 : RL == 96 ? 4 : 1)      \
      name(                                                                                   \
      const __grid_constant__ CUtensorMap tmap, int copy, const float* __restrict__ A,        \
      const float* __restrict__ b, const uint8_t* __restrict__ is_eq,                         \
      const float* __restrict__ lo, const float* __restrict__ hi, float* __restrict__ x_out,  \
      int64_t B, int m, int mp, int R, int iters, float omega, float beta) {                  \
    resident_body<RL, block>(&tmap, copy, A, b, is_eq, lo, hi, x_out, B, m, mp, iters, omega, \
                             beta);                                                           \
  }

#define CLUSTER_KERNEL(name, block)                                                            \
  template <int RL>                                                                            \
  __global__ void __launch_bounds__(96, 1) name(                                               \
      const __grid_constant__ CUtensorMap tmap, int copy, const float* __restrict__ A,         \
      const float* __restrict__ b, const uint8_t* __restrict__ is_eq,                          \
      const float* __restrict__ lo, const float* __restrict__ hi, float* __restrict__ x_out,   \
      int64_t B, int m, int mp, int R, int iters, float omega, float beta) {                   \
    cluster_body<RL, block>(&tmap, copy, A, b, is_eq, lo, hi, x_out, B, m, mp, R, iters, omega, \
                            beta);                                                             \
  }

RESIDENT_KERNEL(jacobi_kernel, false)
RESIDENT_KERNEL(block_jacobi_kernel, true)
CLUSTER_KERNEL(jacobi_cluster_kernel, false)
CLUSTER_KERNEL(block_jacobi_cluster_kernel, true)

typedef void (*OnChipKernel)(const CUtensorMap, int, const float*, const float*, const uint8_t*,
                             const float*, const float*, float*, int64_t, int, int, int, int,
                             float, float);

// `name##_for(rl)`: the instantiation that holds `rl` columns of a row in
// registers (128: the first 128 of a longer row), or null for a length
// that is not instantiated.
#define FORM_TABLE(name)                    \
  OnChipKernel name##_for(int rl) {         \
    switch (rl) {                           \
      case 32: return name<32>;             \
      case 64: return name<64>;             \
      case 96: return name<96>;             \
      case 128: return name<128>;           \
      default: return nullptr;              \
    }                                       \
  }

FORM_TABLE(jacobi_kernel)
FORM_TABLE(block_jacobi_kernel)
FORM_TABLE(jacobi_cluster_kernel)
FORM_TABLE(block_jacobi_cluster_kernel)

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

// The streamed form's rows of B6c (kBlock false) and B6c' (true): the
// inputs and updates of `cluster_body`, with diag and the 3x3 block read
// from A in device memory once a scenario.
template <bool kBlockForm>
struct UnfusedRow {
  static constexpr bool kBlock = kBlockForm;
  const float* __restrict__ A;
  const float* __restrict__ b;
  const uint8_t* __restrict__ is_eq;
  const float* __restrict__ lo;
  const float* __restrict__ hi;
  float* __restrict__ x_out;
  int m;
  float omega, beta;

  struct State {
    RowIn in;
    float d, inv_d;
    float bc[3];
  };

  __device__ __forceinline__ State load(int64_t s, int i, bool row) const {
    State st;
    st.in = row_in(b, is_eq, lo, hi, s, m, row ? i : m);
    const float* As = A + s * (int64_t)m * m;
    st.d = row ? As[(int64_t)i * m + i] : 1.f;
    st.inv_d = 1.f / st.d;
    st.bc[0] = st.bc[1] = st.bc[2] = 0.f;
    if (kBlock && row) block_inverse_row(As, m, i / 3, i % 3, st.bc);
    return st;
  }
  __device__ __forceinline__ float x0(const State& st) const {
    return proj(st.in.b, st.in.eq, st.in.lo, st.in.hi);
  }
  __device__ __forceinline__ float residual(const State& st, float ax) const {
    return st.in.b - ax;
  }
  __device__ __forceinline__ float next(const State& st, float rv, float x, float xprev) const {
    return scalar_update(rv, x, xprev, st.d, st.inv_d, omega, beta, !st.in.eq, st.in.lo,
                         st.in.hi);
  }
  __device__ __forceinline__ float next_block(const State& st, const float* rv3, float x) const {
    const float y = x + st.bc[0] * rv3[0] + st.bc[1] * rv3[1] + st.bc[2] * rv3[2];
    return proj((1.f - omega) * x + omega * y, st.in.eq, st.in.lo, st.in.hi);
  }
  __device__ __forceinline__ void store(int64_t s, int i, float x) const { x_out[s * m + i] = x; }
};

#define STREAMED_KERNEL(name, block)                                                          \
  __global__ void __launch_bounds__(rows_stream::kThreadsMax, 1) name(                        \
      const __grid_constant__ CUtensorMap tmap, bool use_tmap, const float* __restrict__ A,   \
      const float* __restrict__ b, const uint8_t* __restrict__ is_eq,                         \
      const float* __restrict__ lo, const float* __restrict__ hi, float* __restrict__ x_out,  \
      int64_t B, int m, int R, int w, int stages, int iters, float omega, float beta) {       \
    const UnfusedRow<block> rw = {A, b, is_eq, lo, hi, x_out, m, omega, beta};                \
    rows_stream::streamed_body(rw, use_tmap ? &tmap : nullptr, A, B, m, R, w, stages, iters); \
  }

STREAMED_KERNEL(jacobi_streamed_kernel, false)
STREAMED_KERNEL(block_jacobi_streamed_kernel, true)

enum Route : int { kResident = 0, kCluster = 1, kGlobalRows = 2, kStreamed = 3 };

int warps(int n) { return ((n + 31) / 32) * 32; }

// Whether `copy` can fill a stage of rows of m floats from A.
bool copy_ok(int copy, const float* A, int m, int mp) {
  if (copy == kElements) return true;
  if (copy != kTensorMap && copy != kBulkRows) return false;
  if (m % 4 != 0 || reinterpret_cast<uintptr_t>(A) % 16 != 0) return false;
  return copy == kBulkRows || mp + 4 <= 256;  // a tensor copy's box is at most 256 wide
}

// Launch one form as the caller's launch plan says
// (`ops/pgs_kernel.py:jacobi_launch_plan`): `route`, `copy`, `rl` (columns
// of a row in registers: mp rounded up to a warp, at most 128), `cluster`
// blocks of `rows` rows (cluster and streamed routes), `threads` (global
// rows; the streamed route's rows rounded up to a warp and its copy warp),
// and the streamed route's ring, `stages` of `chunk` columns, with at most
// `inflight` clusters at once (0: as many as fit).  A plan this file does
// not take is refused.
int launch(bool block, const float* A, const float* b, const uint8_t* is_eq, const float* lo,
           const float* hi, float* x, int64_t B, int m, int mp, int iters, float omega,
           float beta, int route, int copy, int rl, int cluster, int rows, int threads,
           int stages, int chunk, int inflight, void* stream) {
  if (B <= 0 || m <= 0) return 0;
  if (mp != (m + 7) / 8 * 8) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (route == kStreamed) {
    if (copy != kTensorMap && copy != kElements) return (int)cudaErrorInvalidValue;
    if (copy == kTensorMap && (m % 4 != 0 || reinterpret_cast<uintptr_t>(A) % 16 != 0))
      return (int)cudaErrorInvalidValue;
    const void* kernel = block ? (const void*)block_jacobi_streamed_kernel
                               : (const void*)jacobi_streamed_kernel;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg;
    const int err = rows_stream::streamed_config(kernel, &cfg, attr, B, m, cluster, rows, threads,
                                                 chunk, stages, inflight, block, stream);
    if (err != 0) return err;
    CUtensorMap tmap = {};
    if (copy == kTensorMap) {
      const int enc = encode_rows_map(&tmap, A, B * m, m, chunk, rows_stream::box_rows(rows));
      if (enc != 0) return enc;
    }
    e = block ? cudaLaunchKernelEx(&cfg, block_jacobi_streamed_kernel, tmap, copy == kTensorMap, A,
                                   b, is_eq, lo, hi, x, B, m, rows, chunk, stages, iters, omega,
                                   beta)
              : cudaLaunchKernelEx(&cfg, jacobi_streamed_kernel, tmap, copy == kTensorMap, A, b,
                                   is_eq, lo, hi, x, B, m, rows, chunk, stages, iters, omega,
                                   beta);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  if (route == kGlobalRows) {
    if (threads < 32 || threads > 1024 || threads % 32 != 0) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(rows_global::tile_floats(threads) + (block ? 5 : 3) * mp) * 4;
    const void* kernel = block ? (const void*)block_jacobi_global_kernel
                               : (const void*)jacobi_global_kernel;
    e = allow_shared(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    if (block)
      block_jacobi_global_kernel<<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(
          A, b, is_eq, lo, hi, x, m, mp, iters, omega);
    else
      jacobi_global_kernel<<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(
          A, b, is_eq, lo, hi, x, m, mp, iters, omega, beta);
    return (int)cudaGetLastError();
  }
  if (!copy_ok(copy, A, m, mp)) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * m > INT32_MAX) return (int)cudaErrorInvalidValue;  // a box's row coordinate
  const int X = warps(mp);
  if (rl != (X < 128 ? X : 128)) return (int)cudaErrorInvalidValue;
  int err = 0;
  const int sms = sm_count(&err);
  if (err != 0) return err;

  if (route == kResident) {
    const OnChipKernel kernel = block ? block_jacobi_kernel_for(rl) : jacobi_kernel_for(rl);
    if (kernel == nullptr || X != rl) return (int)cudaErrorInvalidValue;  // rows in registers
    const size_t smem = stage_bytes(m, mp) + 16 + 4 * (size_t)(block ? 3 : 2) * X;
    e = allow_shared((const void*)kernel, smem);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, X, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const int64_t grid = B < (int64_t)per_sm * sms ? B : (int64_t)per_sm * sms;
    CUtensorMap tmap = {};
    if (copy == kTensorMap) {
      const int enc = encode_rows_map(&tmap, A, B * m, m, mp, m);
      if (enc != 0) return enc;
    }
    kernel<<<(unsigned)grid, X, smem, (cudaStream_t)stream>>>(tmap, copy, A, b, is_eq, lo, hi, x,
                                                              B, m, mp, m, iters, omega, beta);
    return (int)cudaGetLastError();
  }
  if (route != kCluster) return (int)cudaErrorInvalidValue;
  const OnChipKernel kernel =
      block ? block_jacobi_cluster_kernel_for(rl) : jacobi_cluster_kernel_for(rl);
  // every block holds at least one row, and no 3-row block straddles two
  if (kernel == nullptr || cluster < 1 || cluster > 16 || rows < 1 ||
      (int64_t)rows * cluster < m || (int64_t)rows * (cluster - 1) >= m || (block && rows % 3))
    return (int)cudaErrorInvalidValue;
  const int T = warps(rows);
  if (T > 96) return (int)cudaErrorInvalidValue;  // the kernels' launch bounds
  const size_t smem = stage_bytes(rows, mp) + 32 + 4 * ((size_t)2 * X + (block ? T : 0));
  e = allow_shared((const void*)kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (cluster > 8) {  // Hopper's non-portable cluster sizes, up to 16
    e = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return (int)e;
  }

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster);
  cfg.blockDim = dim3((unsigned)T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t n = B < clusters ? B : clusters;
  cfg.gridDim = dim3((unsigned)(n * cluster));
  CUtensorMap tmap = {};
  if (copy == kTensorMap) {
    const int enc = encode_rows_map(&tmap, A, B * m, m, mp, rows);
    if (enc != 0) return enc;
  }
  e = cudaLaunchKernelEx(&cfg, kernel, tmap, copy, A, b, is_eq, lo, hi, x, B, m, mp, rows, iters,
                         omega, beta);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int eggshell_jacobi_f32(const float* A, const float* b, const uint8_t* is_eq,
                                   const float* lo, const float* hi, float* x, int64_t B, int m,
                                   int mp, int iters, float omega, float beta, int route,
                                   int copy, int rl, int cluster, int rows, int threads,
                                   int stages, int chunk, int inflight, void* stream) {
  return launch(false, A, b, is_eq, lo, hi, x, B, m, mp, iters, omega, beta, route, copy, rl,
                cluster, rows, threads, stages, chunk, inflight, stream);
}

extern "C" int eggshell_jacobi_block_f32(const float* A, const float* b, const uint8_t* is_eq,
                                         const float* lo, const float* hi, float* x, int64_t B,
                                         int m, int mp, int iters, float omega, int route,
                                         int copy, int rl, int cluster, int rows, int threads,
                                         int stages, int chunk, int inflight, void* stream) {
  if (m % 3 != 0) return (int)cudaErrorInvalidValue;
  return launch(true, A, b, is_eq, lo, hi, x, B, m, mp, iters, omega, 0.f, route, copy, rl,
                cluster, rows, threads, stages, chunk, inflight, stream);
}

// The clusters of the cluster form (`route` 1, the instantiation holding
// `rl` columns in registers) or the streamed form (3) that fit the card at
// once with `cluster` blocks of `threads` threads and `smem` bytes, into
// *out: the blocks in flight are `cluster` times that
// (tools/jacobi_wide_probe.py).
extern "C" int eggshell_jacobi_active_clusters(int block, int route, int rl, int cluster,
                                               int threads, int smem, int* out) {
  const void* kernel = nullptr;
  if (route == kCluster)
    kernel = (const void*)(block ? block_jacobi_cluster_kernel_for(rl)
                                 : jacobi_cluster_kernel_for(rl));
  else if (route == kStreamed)
    kernel = block ? (const void*)block_jacobi_streamed_kernel
                   : (const void*)jacobi_streamed_kernel;
  if (kernel == nullptr || cluster < 1 || cluster > 16) return (int)cudaErrorInvalidValue;
  return rows_stream::active_clusters(kernel, cluster, threads, (size_t)smem, out);
}

extern "C" const char* eggshell_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
