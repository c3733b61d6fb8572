// The "streamed rows" form of the Jacobi solves, float32: one scenario's
// rows split over a thread-block cluster of up to 16 blocks, each block
// streaming its own rows of A from device memory (or L2) every sweep
// through a ring of stages in shared memory.  It takes the rows that a
// cluster cannot hold on chip: B6c and B6c' (csrc/jacobi.cu) and B6b
// (csrc/jacobi_packed_stream.cu) past about 944 rows.
//
// Block `rank` of a cluster of c holds rows rank R .. rank R + nr - 1 of
// the scenario (nr = R but in the last block, which may hold fewer), one
// row a consumer thread, and one more warp, the copy warp, that fills the
// ring.  A stage is R rows by W columns (W = 32, 64 or 128, from the
// caller's plan), row stride W + 4 floats, so the float4 loads of a
// quarter warp's rows fall 4 banks apart.  Where A's rows are 16-byte
// aligned (n % 4 == 0) a stage is one 2D tensor TMA (two past 256 rows, a
// box's limit): a box of (W + 4) columns by R rows over A seen as (B n, n),
// columns past n arriving as zeros; rows past the block's last (a shorter
// last block) arrive too and are never read.  Otherwise the copy warp
// moves the stage's elements with 4-byte `cp.async` and the stage's barrier
// counts its 32 lanes.  Each
// stage has a "full" mbarrier (the copy landed) and an "empty" one (every
// consumer warp has read it); the copy warp runs up to `stages` chunks
// ahead, across sweeps and scenarios, so the next sweep's first chunks
// arrive while this sweep's iterate is exchanged.
//
// Each row is summed over j in increasing order, one product and one add
// at a time, chunk after chunk into one accumulator, as every other form
// sums it (the cluster forms from registers and their stage, the
// global-rows form from its tiles), so all forms return the same bits (up
// to the sign of a zero).
//
// The iterate is exchanged as the cluster forms do it: every block keeps
// the whole iterate, double-buffered, zero past n; each sweep a row's new
// value goes to the same slot of every block by `st.async`, completing on
// the receiving block's mbarrier for that buffer, which expects n * 4
// bytes a phase.  The phases run on across the scenarios a cluster walks
// (phase t in buffer t & 1), so no cluster barrier is needed between
// scenarios: a buffer is written for phase t + 2 only by a block that has
// received every row of phase t + 1, which each block sends after reading
// phase t.  The block form (3x3 block-Jacobi) passes its rows' residuals
// through shared memory behind a named barrier of the consumer warps only.
//
// What bounds it: bytes, A read `iters` times, from L2 where the
// scenarios in flight fit there (the caller's plan may cap the clusters
// in flight for that), else from HBM; and the serial add chain of a row,
// n adds a sweep.

#pragma once

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "jacobi_rows.cuh"

namespace rows_stream {

using namespace jacobi_rows;

constexpr int kMaxStages = 8;
// Rows a block at most.  The consumer threads are the rows rounded up to a
// warp, and the copy warp comes beside them; 512 threads leave each 128
// registers.
constexpr int kMaxRows = 480;
constexpr int kThreadsMax = 512;

// A tensor copy's box is at most 256 rows: a stage of more rows is filled
// by `boxes` copies of box_rows rows each, and holds boxes * box_rows rows
// (the last box's rows past the block's are never read).  box_rows is a
// multiple of 8, so that each box lands 128-byte aligned (8 rows of
// w + 4 floats are a multiple of 128 bytes for w = 32, 64, 128).
__host__ __device__ inline int boxes(int rows) { return (rows + 255) / 256; }
__host__ __device__ inline int box_rows(int rows) {
  return rows <= 256 ? rows : ((rows + boxes(rows) - 1) / boxes(rows) + 7) / 8 * 8;
}

// Bytes of one stage of `rows` rows (boxes rounded up) of chunk width w,
// rounded up to 128 (a tensor copy's destination is 128-byte aligned).
__host__ __device__ inline int64_t stage_bytes(int rows, int w) {
  return ((int64_t)boxes(rows) * box_rows(rows) * (w + 4) * 4 + 127) / 128 * 128;
}

// Shared memory of a block: the ring, 2 * stages + 2 mbarriers, two
// iterates of X floats (n rounded up to a warp) and, in the block form,
// the residuals of its T consumer threads.
__host__ __device__ inline int64_t shared_bytes(int rows, int n, int w, int stages, bool block) {
  const int T = (rows + 31) / 32 * 32;
  const int X = (n + 31) / 32 * 32;
  return stages * stage_bytes(rows, w) + 8 * (2 * stages + 2) + 4 * (2 * (int64_t)X) +
         (block ? 4 * (int64_t)T : 0);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// The barrier of the consumer warps alone (the copy warp never joins it).
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// sum over the chunk's w columns of row[j] x[j], added in increasing j to
// `ax`.  row and x are 16-byte aligned.
__device__ __forceinline__ float chunk_dot(const float* row, const float* x, int w, float ax) {
  const int w4 = w / 4;
  ax = dot4(reinterpret_cast<const float4*>(row), reinterpret_cast<const float4*>(x), 0, w4, ax);
  for (int j = 4 * w4; j < w; ++j) ax = ax + row[j] * x[j];
  return ax;
}

// The solve.  `Row` holds the solve's inputs and its row update:
//   Row::kBlock; Row::State load(s, i, row) (row i's inputs of scenario s;
//   row false: an idle thread); float x0(st); float residual(st, ax);
//   float next(st, rv, x, xprev) (scalar) or next_block(st, rv3, x) (block,
//   rv3 the residuals of the row's 3-row block); void store(s, i, x).
// n: rows and columns of a scenario (A is (B n, n)); R: rows a block;
// w: chunk width; tmap null: element copies.
template <class Row>
__device__ __forceinline__ void streamed_body(const Row& rw, const CUtensorMap* tmap,
                                              const float* __restrict__ A, int64_t B, int n,
                                              int R, int w, int stages, int iters) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int Tc = (int)blockDim.x - 32;  // consumer threads; the last warp copies
  const int X = (n + 31) / 32 * 32;
  const int ld = w + 4;
  const int64_t sfloats = stage_bytes(R, w) / 4;
  float* ring = reinterpret_cast<float*>(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + stages * sfloats * 4);
  uint64_t* empty = full + stages;
  uint64_t* xbars = empty + stages;
  float* xfull = reinterpret_cast<float*>(xbars + 2);  // 2 x X: the whole iterate
  float* srv = xfull + 2 * X;                          // block form: b - A x of this block's rows
  const int r0 = rank * R;
  const int nr = min(R, n - r0);  // rows of this block (the plan leaves none empty)
  const int nch = (n + w - 1) / w;
  const int64_t q0 = blockIdx.x / c, nclusters = gridDim.x / c;

  if (threadIdx.x == 0) {
    for (int k = 0; k < stages; ++k) {
      mbar_init(&full[k], tmap != nullptr ? 1 : 32);
      mbar_init(&empty[k], Tc / 32);
    }
    mbar_init(&xbars[0], 1);
    mbar_init(&xbars[1], 1);
    fence_mbar_init();
  }
  for (int j = threadIdx.x; j < 2 * X; j += blockDim.x) xfull[j] = 0.f;  // stays 0 past n
  cluster.sync();  // every block runs and has its barriers before any store reaches it

  if (threadIdx.x >= Tc) {
    // The copy warp: chunk k of the block's rows goes to stage k % stages
    // once every consumer warp has read what that stage held before.
    const int lane = threadIdx.x - Tc;
    uint32_t k = 0;
    for (int64_t s = q0; s < B; s += nclusters) {
      for (int it = 0; it < iters; ++it) {
        for (int ch = 0; ch < nch; ++ch, ++k) {
          const int st = (int)(k % (uint32_t)stages);
          mbar_wait(&empty[st], ((k / (uint32_t)stages) & 1u) ^ 1u);
          float* dst = ring + st * sfloats;
          const int j0 = ch * w;
          if (tmap != nullptr) {
            if (lane == 0) {
              const int nb = boxes(R), bh = box_rows(R);
              asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
              mbar_expect(&full[st], (uint32_t)(nb * bh) * (uint32_t)ld * 4u);
              for (int b = 0; b < nb; ++b)
                asm volatile(
                    "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
                    " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst + b * bh * ld)),
                    "l"(reinterpret_cast<uint64_t>(tmap)), "r"(j0),
                    "r"((int)(s * n + r0 + b * bh)), "r"(smem_u32(&full[st]))
                    : "memory");
            }
          } else {
            const int cw = min(w, n - j0);
            const float* src = A + (s * n + r0) * (int64_t)n + j0;
            for (int e = lane; e < nr * cw; e += 32) {
              const int r = e / cw, col = e % cw;
              __pipeline_memcpy_async(dst + r * ld + col, src + (int64_t)r * n + col, 4);
            }
            asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                             smem_u32(&full[st]))
                         : "memory");
          }
        }
      }
    }
  } else {
    const int li = threadIdx.x;  // local row
    const int i = r0 + li;       // row of the scenario
    const bool row = li < nr;
    const int lg = li - li % 3;  // block form: the local row of this row's 3-row block
    uint32_t k = 0, t = 0;       // chunks read; iterate phases
    uint32_t parity = 0;         // bit b: parity of the phase buffer b's barrier is in
    for (int64_t s = q0; s < B; s += nclusters) {
      const typename Row::State st = rw.load(s, i, row);
      float x = row ? rw.x0(st) : 0.f;
      float xprev = x;
      // Phase t goes to buffer t & 1 of every block; its barrier expects
      // n * 4 bytes, armed here by thread 0 (stores of faster blocks may
      // land first: the transaction count runs ahead of the arrival).
      if (iters > 0) {
        if (li == 0) mbar_expect(&xbars[t & 1u], (uint32_t)n * 4u);
        if (row)
          for (int r = 0; r < c; ++r)
            send(cluster_addr(xfull + (t & 1u) * X + i, r), x, cluster_addr(&xbars[t & 1u], r));
      }
      for (int it = 0; it < iters; ++it) {
        const uint32_t b = t & 1u;
        mbar_wait(&xbars[b], (parity >> b) & 1u);
        parity ^= 1u << b;
        const float* xc = xfull + b * X;
        const float* mine = ring + li * ld;
        float ax = 0.f;
        for (int ch = 0; ch < nch; ++ch, ++k) {
          const int sidx = (int)(k % (uint32_t)stages);
          mbar_wait(&full[sidx], (k / (uint32_t)stages) & 1u);
          if (row) ax = chunk_dot(mine + sidx * sfloats, xc + ch * w, min(w, n - ch * w), ax);
          __syncwarp();
          if ((li & 31) == 0) mbar_arrive(&empty[sidx]);
        }
        const float rv = rw.residual(st, ax);
        float xn = 0.f;
        if constexpr (Row::kBlock) {
          srv[li] = rv;
          consumers_sync(Tc);
          if (row) xn = rw.next_block(st, srv + lg, x);
        } else {
          if (row) xn = rw.next(st, rv, x, xprev);
        }
        ++t;
        if (it + 1 < iters) {
          const uint32_t nb = t & 1u;
          if (li == 0) mbar_expect(&xbars[nb], (uint32_t)n * 4u);
          if (row)
            for (int r = 0; r < c; ++r)
              send(cluster_addr(xfull + nb * X + i, r), xn, cluster_addr(&xbars[nb], r));
        }
        xprev = x;
        x = xn;
      }
      if (row) rw.store(s, i, x);
    }
  }
  cluster.sync();  // no block leaves while another may still store into it
}

// Check a streamed plan and set up its launch: the shared memory, the
// non-portable cluster size past 8 blocks, and the grid, as many clusters
// as fit the card at once (capped by `inflight` where that is positive) and
// no more than the B scenarios.  Fills `cfg` (its attribute array `attr`
// must outlive it).  Returns 0 or a cudaError_t; a plan the card cannot
// place (no cluster of this size fits) is refused.
inline int streamed_config(const void* kernel, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                           int64_t B, int n, int cluster, int rows, int threads, int w,
                           int stages, int inflight, bool block, void* stream) {
  const int T = (rows + 31) / 32 * 32;
  if (cluster < 1 || cluster > 16 || rows < 1 || rows > kMaxRows ||
      (int64_t)rows * cluster < n || (int64_t)rows * (cluster - 1) >= n || (block && rows % 3) ||
      threads != T + 32 || stages < 3 || stages > kMaxStages || (w != 32 && w != 64 && w != 128))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)B * n > INT32_MAX) return (int)cudaErrorInvalidValue;  // a box's row coordinate
  const size_t smem = (size_t)shared_bytes(rows, n, w, stages, block);
  cudaError_t e = allow_shared(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (cluster > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)cluster);
  cfg->blockDim = dim3((unsigned)threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = (cudaStream_t)stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  if (inflight > 0 && inflight < clusters) clusters = inflight;
  const int64_t nc = B < clusters ? B : clusters;
  cfg->gridDim = dim3((unsigned)(nc * cluster));
  return 0;
}

// The clusters of `cluster` blocks of `threads` threads and `smem` bytes
// of `kernel` that fit the card at once (`cudaOccupancyMaxActiveClusters`,
// what the cluster and streamed launches size their grids by), into *out.
// Returns 0 or a cudaError_t.
inline int active_clusters(const void* kernel, int cluster, int threads, size_t smem, int* out) {
  cudaError_t e = allow_shared(kernel, smem);
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

}  // namespace rows_stream
