// Heavy-ball projected Jacobi on the fused chain's contact LCP with A held
// across a thread-block cluster (B6b), float32.
//
// Replaces the TPU kernel `_jacobi_packed_stream_kernel` of
// eggshell_tpu/ops/pgs_kernel.py (reached through
// `_solve_lcp_jacobi_packed_stream`, the `stream=True` side of
// `solve_lcp_jacobi_packed`).  It computes what csrc/jacobi_packed.cu's
// scalar form computes, bit for bit: the same bounds built from the lane
// masks, x0 = proj(b), then `iters` sweeps of
//   r = b - A x + diag x;  x <- proj((1 - omega) x + omega r / diag + beta (x - x_prev)),
// each row's A x summed over all j in increasing order by the functions of
// csrc/jacobi_rows.cuh that B6 uses.
//
// The TPU kernel streams A from HBM on every sweep because one scenario's
// double-buffered A does not fit its VMEM budget.  On an H100 that costs
// iters reads of A: at mp = 96, B = 4096 and 16 sweeps, 2.4 GB, 0.72 ms at
// the HBM peak, against a 0.0465 ms bound for one read (the first port of
// this kernel did that and took 1.0022 ms).  Here A is read from HBM once
// and held across a cluster of c blocks: each block holds R = mp / c whole
// rows of one scenario rounded up (the last block fewer), one row a thread.
// c is at most 8, the portable size, up to mp = 664, and 9 to 16 past that
// (Hopper's non-portable cluster sizes), which hold one scenario's A up to
// mp = 944: there one block fills an SM's shared memory.
// - The rows arrive by one 2D tensor TMA copy into a stage in the block's
//   shared memory (csrc/jacobi_rows.cuh, row stride mp + 4; rows of more
//   than 252 floats, or a shorter last block's, one bulk copy a row).  Rows
//   of up to 128 floats move
//   into registers (template RL, as in B6), and the stage is refilled with
//   the cluster's next scenario while this one sweeps; longer rows are read
//   from the stage, which is refilled after the sweeps.
// - Every block keeps the whole iterate, double-buffered, zero past mp, and
//   reads it as float4 broadcasts.  Each sweep, a thread sends its row's
//   new value to the same slot of every block of the cluster through
//   distributed shared memory (`st.async` to the address
//   `cooperative_groups::cluster_group::map_shared_rank` names, `mapa`),
//   and each store completes on the receiving block's mbarrier for that
//   buffer, which expects mp * 4 bytes a sweep.  A block starts a sweep when
//   its own mbarrier says the whole iterate has landed: no cluster barrier
//   inside a scenario.  A buffer is written again only two sweeps later, by
//   a block that has by then received this block's next slice, which this
//   block sends after it has read the buffer: so the data flow itself keeps
//   a write from overtaking a read.  A cluster barrier ends each scenario,
//   before the next scenario's x0 lands.  Gathering the slices with
//   `map_shared_rank` loads after a cluster barrier each sweep took 0.29 ms
//   at mp = 96 (`chip_smoke.py`, H100 SXM at 700 W), and plain stores
//   ordered by a cluster barrier each sweep measured slower than these
//   mbarriers too.
// - Rows are split, not columns, so each row is summed as in B6 and no
//   partial sums cross blocks.
// - A persistent grid of clusters (`cudaOccupancyMaxActiveClusters`), each
//   walking the scenarios q, q + clusters, ...
// Launched with `cudaLaunchKernelEx` and the cluster dimension attribute.
// The cluster size c comes from `ops/pgs_kernel.py:packed_launch_plan`:
// up to mp = 664 the smallest c >= 2 that divides mp and leaves at most 64
// rows a block, else 8.  Fewer, fuller blocks measured faster
// (tools/jacobi_packed_probe.py, H100 SXM at 700 W): at mp = 96, 0.1371 ms
// with c = 2 against 0.1435 (c = 3) and 0.1804 (c = 4); at mp = 192,
// 0.6209 ms with c = 3 against 0.6815 (c = 2, 96 rows a block) and 0.7777
// (c = 4).  Past mp = 664, 9 blocks where they hold the rows, else 16
// (`WIDE_CLUSTERS` there: 9 clusters of 9 fit the H100 at once, 7 of any
// size from 10 to 16; at mp = 888, B = 256, 2.2937 ms with c = 16 against
// 2.4492 with 15, tools/jacobi_wide_probe.py).
// Shared memory, in bytes: the stage, R rows of stride mp + 4
// floats rounded up to 128 bytes; 32 bytes of mbarriers; two iterates of X
// floats, X = mp rounded up to a warp.  A block has T threads, R rounded up
// to a warp.
//
// Past what 16 blocks hold, the plan takes the streamed route,
// `jacobi_packed_streamed_kernel` (csrc/rows_stream.cuh): the same split
// and exchange, each block streaming its rows from device memory every
// sweep through a ring of stages that a copy warp fills.  Past what that
// ring and the iterate leave room for (mp above 6,560), it takes the
// global-rows route, `jacobi_packed_rows_kernel`: one block a scenario reads
// its rows of A from device memory on every sweep, in tiles of 32 columns,
// a warp a row segment, double-buffered with cp.async
// (csrc/rows_global.cuh; the streamed scheme of the first port of this
// kernel, whose row chunks in shared memory stopped at mp = 888).  Every
// route sums each row over j in increasing order and updates it through the
// same functions, so each returns B6's bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "jacobi_rows.cuh"
#include "rows_global.cuh"
#include "rows_stream.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace jacobi_rows;

// Rows of 96 in registers (mp 72..96, 36..48 rows a block of 64 threads)
// are held to 170 registers, so that 6 blocks fit an SM (175 registers left
// 5): each sweep waits for the other blocks' stores, and more blocks hide
// that (0.1347 against 0.1553 ms at mp = 96, `chip_smoke.py` on an H100
// SXM at 700 W; 7 blocks spill).
template <int RL>
__global__ void __launch_bounds__(RL == 0 ? 96 : 64, RL == 96 ? 6 : 1)
    jacobi_packed_stream_kernel(const __grid_constant__ CUtensorMap tmap, bool use_tmap,
                                const float* __restrict__ A, const float* __restrict__ diag,
                                const float* __restrict__ rhs, const uint8_t* __restrict__ act,
                                const uint8_t* __restrict__ eq, float* __restrict__ x_out,
                                int64_t B, int K, int mp, int R, int iters, float mu,
                                float omega, float beta) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int nr = min(R, mp - rank * R);  // rows of this block (the plan leaves none empty)
  const int X = ((mp + 31) / 32) * 32;
  float* sA = reinterpret_cast<float*>(smem_raw);            // R rows of ld
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + stage_bytes(R, mp));  // the stage's
  uint64_t* xbars = bar + 1;                                 // one an iterate buffer
  float* xfull = reinterpret_cast<float*>(bar + 4);          // 2 x X: the whole iterate
  // a box of R rows would overrun a shorter last block into the next scenario
  const CUtensorMap* map = use_tmap && nr == R ? &tmap : nullptr;
  const int ld = mp + 4;
  const int li = threadIdx.x;        // local row
  const int i = rank * R + li;       // row of the scenario
  const bool row = li < nr;
  const int64_t q0 = blockIdx.x / c, nclusters = gridDim.x / c;

  if (li == 0) {
    mbar_init(bar, 1);
    mbar_init(&xbars[0], 1);
    mbar_init(&xbars[1], 1);
    fence_mbar_init();
  }
  for (int j = li; j < 2 * X; j += blockDim.x) xfull[j] = 0.f;  // stays 0 past mp
  cluster.sync();  // every block runs and has its barriers before any store reaches it
  if (li < 32) load_rows(sA, map, A, q0 * mp + rank * R, nr, mp, mp, bar);

  uint32_t parity = 0;  // bit b: parity of the phase buffer b's barrier is in
  uint32_t stage_parity = 0;
  const int ri = row ? i : mp;  // idle threads read nothing
  RowInputs ahead = row_inputs(rhs, diag, act, eq, q0, K, mp, ri);
  for (int64_t s = q0; s < B; s += nclusters, stage_parity ^= 1u) {
    const int64_t next = s + nclusters;
    const RowInputs in = ahead;
    if (next < B) ahead = row_inputs(rhs, diag, act, eq, next, K, mp, ri);

    const RowBounds rb = row_bounds(in, i, mu);
    const float bi = in.b, d = in.d, inv_d = 1.f / d;
    float x = in.act ? fminf(fmaxf(bi, rb.lo), rb.hi) : bi;
    float xprev = x;

    mbar_wait(bar, stage_parity);
    RegRow<(RL > 0 ? RL : 4)> a;
    if (RL > 0) a.load(sA + (row ? li : 0) * ld, row ? mp : 0);
    __syncthreads();  // the stage is read (register rows)
    if (RL > 0 && li < 32 && next < B)
      load_rows(sA, map, A, next * mp + rank * R, nr, mp, mp, bar);

    // x_t goes to buffer t & 1 of every block; buffer b's barrier expects
    // mp * 4 bytes a phase, armed by thread 0 once the phase before is done.
    if (iters > 0) {
      if (li == 0) mbar_expect(&xbars[0], (uint32_t)mp * 4u);
      if (row)
        for (int r = 0; r < c; ++r)
          send(cluster_addr(xfull + i, r), x, cluster_addr(&xbars[0], r));
    }
    for (int it = 0; it < iters; ++it) {
      const int b = it & 1;
      mbar_wait(&xbars[b], (parity >> b) & 1u);
      parity ^= 1u << b;
      const bool more = it + 1 < iters;
      if (more && li == 0) mbar_expect(&xbars[b ^ 1], (uint32_t)mp * 4u);
      if (row) {
        const float* xc = xfull + b * X;
        const float ax = RL > 0 ? a.dot(xc) : shared_dot(sA + li * ld, xc, mp);
        const float xn =
            scalar_update(bi - ax, x, xprev, d, inv_d, omega, beta, in.act, rb.lo, rb.hi);
        if (more)
          for (int r = 0; r < c; ++r)
            send(cluster_addr(xfull + (b ^ 1) * X + i, r), xn, cluster_addr(&xbars[b ^ 1], r));
        xprev = x;
        x = xn;
      }
    }
    if (row) x_out[s * mp + i] = x;
    cluster.sync();  // every block is done with this scenario's iterates and stage
    if (RL == 0 && li < 32 && next < B)
      load_rows(sA, map, A, next * mp + rank * R, nr, mp, mp, bar);
  }
}

typedef void (*StreamKernel)(const CUtensorMap, bool, const float*, const float*, const float*,
                             const uint8_t*, const uint8_t*, float*, int64_t, int, int, int, int,
                             float, float, float);

StreamKernel stream_kernel_for(int rl) {
  switch (rl) {
    case 0: return jacobi_packed_stream_kernel<0>;
    case 32: return jacobi_packed_stream_kernel<32>;
    case 64: return jacobi_packed_stream_kernel<64>;
    case 96: return jacobi_packed_stream_kernel<96>;
    case 128: return jacobi_packed_stream_kernel<128>;
    default: return nullptr;
  }
}

// The global-rows route.  Shared memory: the tiles, then the iterate, the
// previous iterate and the row sums, mp floats each.
__global__ void jacobi_packed_rows_kernel(const float* __restrict__ A,
                                          const float* __restrict__ diag,
                                          const float* __restrict__ rhs,
                                          const uint8_t* __restrict__ act,
                                          const uint8_t* __restrict__ eq, float* __restrict__ x_out,
                                          int K, int mp, int iters, float mu, float omega,
                                          float beta) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  float* tiles = smem;
  float* sx = tiles + rows_global::tile_floats(T);
  float* sxp = sx + mp;
  float* sax = sxp + mp;
  const int64_t s = blockIdx.x;
  const rows_global::Rows a = {A + s * (int64_t)mp * mp, mp, mp, mp};

  for (int i = threadIdx.x; i < mp; i += T) {
    const RowInputs in = row_inputs(rhs, diag, act, eq, s, K, mp, i);
    const RowBounds rb = row_bounds(in, i, mu);
    sx[i] = sxp[i] = in.act ? fminf(fmaxf(in.b, rb.lo), rb.hi) : in.b;
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    rows_global::matvec(a, sx, sax, tiles);
    for (int i = threadIdx.x; i < mp; i += T) {  // a thread reads and writes its own rows only
      const RowInputs in = row_inputs(rhs, diag, act, eq, s, K, mp, i);
      const RowBounds rb = row_bounds(in, i, mu);
      const float x = sx[i];
      sx[i] = scalar_update(in.b - sax[i], x, sxp[i], in.d, 1.f / in.d, omega, beta, in.act,
                            rb.lo, rb.hi);
      sxp[i] = x;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < mp; i += T) x_out[s * mp + i] = sx[i];
}

// The streamed route's rows: the inputs and update of
// `jacobi_packed_stream_kernel`.
struct PackedRow {
  static constexpr bool kBlock = false;
  const float* __restrict__ diag;
  const float* __restrict__ rhs;
  const uint8_t* __restrict__ act;
  const uint8_t* __restrict__ eq;
  float* __restrict__ x_out;
  int K, mp;
  float mu, omega, beta;

  struct State {
    RowInputs in;
    RowBounds rb;
    float inv_d;
  };

  __device__ __forceinline__ State load(int64_t s, int i, bool row) const {
    State st;
    st.in = row_inputs(rhs, diag, act, eq, s, K, mp, row ? i : mp);
    st.rb = row_bounds(st.in, i, mu);
    st.inv_d = 1.f / st.in.d;
    return st;
  }
  __device__ __forceinline__ float x0(const State& st) const {
    return st.in.act ? fminf(fmaxf(st.in.b, st.rb.lo), st.rb.hi) : st.in.b;
  }
  __device__ __forceinline__ float residual(const State& st, float ax) const {
    return st.in.b - ax;
  }
  __device__ __forceinline__ float next(const State& st, float rv, float x, float xprev) const {
    return scalar_update(rv, x, xprev, st.in.d, st.inv_d, omega, beta, st.in.act, st.rb.lo,
                         st.rb.hi);
  }
  __device__ __forceinline__ void store(int64_t s, int i, float x) const {
    x_out[s * mp + i] = x;
  }
};

__global__ void __launch_bounds__(rows_stream::kThreadsMax, 1)
    jacobi_packed_streamed_kernel(const __grid_constant__ CUtensorMap tmap,
                                  const float* __restrict__ A, const float* __restrict__ diag,
                                  const float* __restrict__ rhs, const uint8_t* __restrict__ act,
                                  const uint8_t* __restrict__ eq, float* __restrict__ x_out,
                                  int64_t B, int K, int mp, int R, int w, int stages, int iters,
                                  float mu, float omega, float beta) {
  const PackedRow rw = {diag, rhs, act, eq, x_out, K, mp, mu, omega, beta};
  rows_stream::streamed_body(rw, &tmap, A, B, mp, R, w, stages, iters);
}

}  // namespace

// `rl` (row length in registers, 0: rows in shared memory), `cluster` and
// `rows` (rows a block, the last block fewer) come from the caller's launch
// plan; a plan this file does not take is refused.
extern "C" int eggshell_jacobi_packed_stream_f32(const float* A, const float* diag,
                                                 const float* rhs, const uint8_t* act,
                                                 const uint8_t* eq, float* x, int64_t B, int K,
                                                 int mp, int iters, float mu, float omega,
                                                 float beta, int rl, int cluster, int rows,
                                                 void* stream) {
  if (B <= 0) return 0;
  const StreamKernel kernel = stream_kernel_for(rl);
  const int X = ((mp + 31) / 32) * 32;
  // every block holds at least one row
  if (kernel == nullptr || mp <= 0 || mp % 8 != 0 || 3 * K > mp || cluster < 1 || cluster > 16 ||
      rows < 1 || (int64_t)rows * cluster < mp || (int64_t)rows * (cluster - 1) >= mp ||
      (rl != 0 && rl != X))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)B * mp > INT32_MAX) return (int)cudaErrorInvalidValue;  // a box's row coordinate
  const int R = rows;
  const int T = ((R + 31) / 32) * 32;
  if (T > (rl == 0 ? 96 : 64)) return (int)cudaErrorInvalidValue;  // the kernel's launch bounds
  const size_t smem = stage_bytes(R, mp) + 32 + 4 * (size_t)2 * X;
  cudaError_t e = allow_shared((const void*)kernel, smem);
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
  const bool use_tmap = mp + 4 <= 256;  // a tensor copy's box is at most 256 wide
  if (use_tmap) {
    const int enc = encode_rows_map(&tmap, A, B * mp, mp, mp, R);
    if (enc != 0) return enc;
  }
  e = cudaLaunchKernelEx(&cfg, kernel, tmap, use_tmap, A, diag, rhs, act, eq, x, B, K, mp, R,
                         iters, mu, omega, beta);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The global-rows route with `threads` threads a block (the caller's plan).
extern "C" int eggshell_jacobi_packed_rows_f32(const float* A, const float* diag, const float* rhs,
                                               const uint8_t* act, const uint8_t* eq, float* x,
                                               int64_t B, int K, int mp, int iters, float mu,
                                               float omega, float beta, int threads,
                                               void* stream) {
  if (B <= 0) return 0;
  if (mp <= 0 || mp % 8 != 0 || 3 * K > mp || threads < 32 || threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(rows_global::tile_floats(threads) + 3 * mp) * sizeof(float);
  cudaError_t e = allow_shared((const void*)jacobi_packed_rows_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  jacobi_packed_rows_kernel<<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(
      A, diag, rhs, act, eq, x, K, mp, iters, mu, omega, beta);
  return (int)cudaGetLastError();
}

// The streamed route: `cluster` blocks of `rows` rows, `threads` (the rows
// rounded up to a warp and the copy warp), a ring of `stages` chunks of
// `chunk` columns, at most `inflight` clusters at once (0: as many as fit);
// the caller's plan.
extern "C" int eggshell_jacobi_packed_streamed_f32(const float* A, const float* diag,
                                                   const float* rhs, const uint8_t* act,
                                                   const uint8_t* eq, float* x, int64_t B, int K,
                                                   int mp, int iters, float mu, float omega,
                                                   float beta, int cluster, int rows, int threads,
                                                   int stages, int chunk, int inflight,
                                                   void* stream) {
  if (B <= 0) return 0;
  if (mp <= 0 || mp % 8 != 0 || 3 * K > mp || reinterpret_cast<uintptr_t>(A) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  const int err = rows_stream::streamed_config((const void*)jacobi_packed_streamed_kernel, &cfg,
                                               attr, B, mp, cluster, rows, threads, chunk, stages,
                                               inflight, false, stream);
  if (err != 0) return err;
  CUtensorMap tmap = {};
  const int enc = encode_rows_map(&tmap, A, B * mp, mp, chunk, rows_stream::box_rows(rows));
  if (enc != 0) return enc;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, jacobi_packed_streamed_kernel, tmap, A, diag, rhs,
                                           act, eq, x, B, K, mp, rows, chunk, stages, iters, mu,
                                           omega, beta);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The clusters of the cluster route (`streamed` 0, the instantiation
// holding `rl` columns in registers) or the streamed route (1) that fit the
// card at once with `cluster` blocks of `threads` threads and `smem` bytes,
// into *out (tools/jacobi_wide_probe.py).
extern "C" int eggshell_jacobi_packed_active_clusters(int streamed, int rl, int cluster,
                                                      int threads, int smem, int* out) {
  const void* kernel = streamed ? (const void*)jacobi_packed_streamed_kernel
                                : (const void*)stream_kernel_for(rl);
  if (kernel == nullptr || cluster < 1 || cluster > 16) return (int)cudaErrorInvalidValue;
  return rows_stream::active_clusters(kernel, cluster, threads, (size_t)smem, out);
}
