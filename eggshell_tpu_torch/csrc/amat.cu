// Contact system matrix A = J M^-1 J^T from compact Jacobian blocks, float32.
//
// Replaces the TPU kernel `_amat_kernel` of eggshell_tpu/ops/amat_kernel.py
// (reached through `contact_system_matrix_packed`).  Per scenario, with
// Jc (3K, 12) holding slot 0 (body b0) in columns 0:6 and slot 1 (body b1)
// in 6:12:
//   X[row, s]        = Jc[row, slot s] M^-1_b    (lin * inv_mass_b, ang * invIg_b)
//   A[row, col]      = sum over slot pairs (si, sj), in the order (0,0) (0,1)
//                      (1,0) (1,1), whose lane bodies are equal, of
//                      X[row, si] . Jc[col, sj]
//   A[row, row]     += cfm on active rows, 1 on inactive rows;
//   rows and columns 3K..mp-1 are those of the identity.
// diag (B, mp) = diag(A) is written beside A, so that the Jacobi kernel
// never gathers it.  A slot pair whose bodies are both -1 (the ground) is
// skipped: its X is zero, so it could only add a zero.  Every entry keeps
// the plain version's order of operations; built with --fmad=false it
// rounds as the plain torch version does (the skipped pairs can change
// only the sign of a zero).
//
// What bounds it on an H100: bytes.  A scenario writes mp^2 floats of A
// (16 KB at K = 20, 36 KB at K = 32) and reads 3K * 12 floats of Jc; each
// entry costs at most 4 six-term dots.  The first design (one thread an
// entry of A, 6-float reads at a 12-float stride, a 4-way bank conflict on
// every load, a division by a run-time mp an entry) took 0.093 ms at
// K = 20 against a 0.0245 ms bound (`chip_smoke.py`, H100 SXM at 700 W):
// it was held back by shared-memory issue, not by its bytes.  The design:
// - A persistent grid (occupancy x SMs).  Each block walks items: one
//   scenario's slab of R rows of A (R = mp at the main path's K: the whole
//   matrix).
// - The scenario's Jc arrives by one bulk copy (`cp.async.bulk`) on an
//   mbarrier, in chunks of C lanes (C = K at the main path's K), into a
//   ring of two buffers: the next item's chunk is in flight while this one
//   is used.
// - X of the slab's rows is formed once, one thread a (row, slot), into
//   shared memory.
// - A first pass, one thread a 3x3 lane block (k, j), writes the blocks
//   whose lanes share no body >= 0 as zeros (and the diagonal fix) and
//   lists the others with the slot pairs that match, a warp's at once.  On
//   the scenes' steps most lane blocks share no body, and a warp that
//   mixed zero and matching blocks would run every pair any of its blocks
//   matches.
// - Then one thread a column of a listed lane block: entries (3k + r,
//   3j + c) for r = 0..2.  It loads row 3j + c of Jc as 3 float4s (a
//   48-byte stride: the 8 threads of a quarter warp hit 8 different
//   16-byte bank groups) and lane k's X rows, and writes its 3 entries
//   into a shared tile laid out as A itself (neighbouring threads on
//   neighbouring words).
// - The tile (R rows of A, contiguous in A) goes out in one bulk store,
//   shared to global, and diag is read from the tile.  There is one tile:
//   its store overlaps the next item's start (X and the lane bodies) and
//   the other resident blocks' work.  The kernel is bound by each item's
//   chain of barriers and loads, which more resident blocks hide, and a
//   second tile costs resident blocks: at K = 20 one tile leaves 6 blocks
//   an SM (registers allow 6, shared memory 8), two leave 5 (shared
//   memory); at K = 32, 4 against 2.  A double-buffered tile was slower on
//   every input it was timed on: box_stack4's first step 0.0479 ms against
//   0.0420 for one, box_stack8's 0.1091 against 0.0712
//   (`tools/amat_probe.py`, H100 SXM at 700 W), so it went.
// - An item starts with no load from device memory: its lane bodies and
//   flags and its scenario's invIg were read into registers during the
//   block's item before (invIg where 9n <= 128; else X reads it from device
//   memory), and with one chunk X is formed from the chunk.
// The TPU kernel's 4-row slabs and sublane-major A layout are not carried
// over: A is (B, mp, mp) row-major.  `ops/amat_kernel.py:amat_launch_plan`
// picks R and C so that the shared memory below fits: past K = 48 the
// slab shrinks to a few lanes' rows, past K = 343 to one lane's rows and
// the chunk to fewer lanes.
//
// Shared memory, in bytes: a tile of R x mp floats; two Jc chunks of
// C x 36 floats; X, min(R, 3K) rows of 12 floats; 128 floats of invIg;
// two 8-byte mbarriers and the list's count (32 bytes); the slab's lane
// bodies and flags, 3 ints a lane; the chunk's lane bodies, 2 ints a lane;
// the list, an int a lane block of the slab and chunk.

#include <cuda_runtime.h>
#include <stdint.h>

#include "jacobi_rows.cuh"

namespace {

using jacobi_rows::fence_mbar_init;
using jacobi_rows::mbar_expect;
using jacobi_rows::mbar_init;
using jacobi_rows::mbar_wait;
using jacobi_rows::smem_u32;

constexpr int kThreads = 128;

struct Layout {
  int64_t tile, jc, x, ig, bars, slab_ints, chunk_ints, list, total;
};

// The shared-memory layout for slabs of R rows and chunks of C lanes.
// `ops/amat_kernel.py:amat_shared_bytes` restates it for the launch plan:
// a change here is made there too.
__host__ __device__ inline Layout layout(int K, int mp, int R, int C) {
  const int xrows = R < 3 * K ? R : 3 * K;
  Layout l;
  l.tile = 0;
  l.jc = l.tile + (int64_t)R * mp * 4;
  l.x = l.jc + 2 * (int64_t)C * 36 * 4;
  l.ig = l.x + (int64_t)xrows * 12 * 4;
  l.bars = l.ig + kThreads * 4;
  l.slab_ints = l.bars + 32;  // two mbarriers and the list's count
  l.chunk_ints = l.slab_ints + 3 * (int64_t)((xrows + 2) / 3) * 4;
  l.list = l.chunk_ints + 2 * (int64_t)C * 4;
  l.total = l.list + (int64_t)((xrows + 2) / 3) * C * 4;
  return l;
}

// Copy lanes [j0, j0 + nc) of scenario s's Jc into `dst`, completing on
// `bar`.  One thread.  `dst` was last read through ordinary loads before a
// barrier of the whole block; the proxy fence orders those reads first.
__device__ __forceinline__ void load_chunk(float* dst, const float* __restrict__ Jc, int64_t s,
                                           int K, int j0, int nc, uint64_t* bar) {
  const uint32_t bytes = (uint32_t)nc * 144u;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  mbar_expect(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(Jc + (s * K + j0) * 36), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 128 threads a block, at most 80 registers a thread (6 blocks an SM by
// registers): more scenarios in flight on an SM than with 256 threads.
// `ops/amat_kernel.py` restates kThreads as AMAT_THREADS (a slab has at
// most that many lanes, one thread each).
__global__ void __launch_bounds__(kThreads, 6)
    amat_kernel(const float* __restrict__ Jc, const int64_t* __restrict__ b0,
                const int64_t* __restrict__ b1, const uint8_t* __restrict__ act,
                const float* __restrict__ inv_mass, const float* __restrict__ invIg,
                float* __restrict__ A, float* __restrict__ diag, int64_t B, int K, int n, int mp,
                float cfm, int R, int C) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Layout lay = layout(K, mp, R, C);
  float* tile = reinterpret_cast<float*>(smem_raw + lay.tile);
  float* sjc = reinterpret_cast<float*>(smem_raw + lay.jc);
  float* sX = reinterpret_cast<float*>(smem_raw + lay.x);
  float* sig = reinterpret_cast<float*>(smem_raw + lay.ig);  // the scenario's invIg, 9n <= 128
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + lay.bars);
  int* sbk = reinterpret_cast<int*>(smem_raw + lay.slab_ints);  // b0, b1, act of the slab's lanes
  int* sbj = reinterpret_cast<int*>(smem_raw + lay.chunk_ints);  // b0, b1 of the chunk's lanes
  int* slist = reinterpret_cast<int*>(smem_raw + lay.list);  // the chunk's nonzero lane blocks
  int* scount = reinterpret_cast<int*>(bars + 2);
  const int lanes_cap = (int)((lay.chunk_ints - lay.slab_ints) / 12);
  const int m = 3 * K;
  const int tid = threadIdx.x;
  const int nslab = (mp + R - 1) / R;
  const int nchunk = (K + C - 1) / C;
  const int items = (int)(B * nslab);  // the entry checks that it fits

  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0 && (int64_t)blockIdx.x < items)
    load_chunk(sjc, Jc, blockIdx.x / nslab, K, 0, min(C, K), &bars[0]);

  // The next item's lane bodies and flags (thread t: slab lane t; a slab
  // has at most 128 lanes) and its scenario's invIg (thread t: float t,
  // where 9n <= 128; else X reads invIg from device memory) are read into
  // registers while this item works, so that an item starts with no load
  // from device memory.
  const bool stage_ig = 9 * n <= kThreads;
  int pb0 = -1, pb1 = -1;
  uint8_t pact = 0;
  float pig = 0.f;
  auto prefetch = [&](int64_t item) {
    if (item >= items) return;
    const int64_t s = item / nslab;
    const int row0 = (int)(item % nslab) * R;
    const int lrow1 = min(min(row0 + R, mp), m);
    if (tid < (lrow1 - row0) / 3) {
      const int64_t g = s * K + row0 / 3 + tid;
      pb0 = (int)b0[g];
      pb1 = (int)b1[g];
      pact = act[g];
    }
    if (stage_ig && tid < 9 * n) pig = invIg[s * n * 9 + tid];
  };
  prefetch(blockIdx.x);

  int step = 0;  // (item, chunk) steps of this block: Jc buffer step & 1
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int64_t s = item / nslab;
    const int row0 = (int)(item % nslab) * R;
    const int row1 = min(row0 + R, mp);
    const int lrow1 = min(row1, m);            // lane rows of the slab end here
    const int lane0 = row0 / 3;                // R is a multiple of 3 where nslab > 1
    const int nl = lrow1 > row0 ? (lrow1 - row0) / 3 : 0;

    if (tid < nl) {
      sbk[tid] = pb0;
      sbk[lanes_cap + tid] = pb1;
      sbk[2 * lanes_cap + tid] = pact != 0;
    }
    if (stage_ig && tid < 9 * n) sig[tid] = pig;
    prefetch(item + gridDim.x);
    // With one chunk, X is formed from the chunk in shared memory.
    const float* jrows = Jc + s * m * 12;
    if (nchunk == 1) {
      mbar_wait(&bars[step & 1], (uint32_t)(step >> 1) & 1u);
      jrows = sjc + (step & 1) * C * 36;
    }
    const float* igs = stage_ig ? sig : invIg + s * n * 9;
    __syncthreads();
    for (int task = tid; task < 6 * nl; task += kThreads) {  // X, one (row, slot) a task
      const int row = task >> 1, slot = task & 1;
      const int b = sbk[slot * lanes_cap + row / 3];
      const float* J = jrows + (row0 + row) * 12 + 6 * slot;
      float* x = sX + row * 12 + 6 * slot;
      const float im = b >= 0 ? inv_mass[b] : 0.f;
      const float* ig = igs + (b >= 0 ? b : 0) * 9;
      for (int c = 0; c < 3; ++c) x[c] = J[c] * im;
      for (int c = 0; c < 3; ++c) {
        const float g0 = b >= 0 ? ig[c] : 0.f;
        const float g1 = b >= 0 ? ig[3 + c] : 0.f;
        const float g2 = b >= 0 ? ig[6 + c] : 0.f;
        x[3 + c] = J[3] * g0 + J[4] * g1 + J[5] * g2;
      }
    }
    if (tid == 0)  // the tile is free once the last item's store has read it
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");

    for (int c = 0; c < nchunk; ++c, ++step) {
      const int j0 = c * C;
      const int nc = min(C, K - j0);
      const int buf = step & 1;
      // The chunk's lane bodies: the slab's where the two hold the same lanes.
      const bool same = j0 == lane0 && nc == nl;
      const int* cb0 = same ? sbk : sbj;
      const int* cb1 = same ? sbk + lanes_cap : sbj + C;
      for (int t = tid; !same && t < nc; t += kThreads) {
        sbj[t] = (int)b0[s * K + j0 + t];
        sbj[C + t] = (int)b1[s * K + j0 + t];
      }
      if (tid == 0) {  // the next step's chunk into the other buffer, read last step
        *scount = 0;
        int ni = item;
        int nc0 = c + 1;
        if (nc0 == nchunk) {
          ni = item + gridDim.x;
          nc0 = 0;
        }
        if (ni < items)
          load_chunk(sjc + (buf ^ 1) * C * 36, Jc, ni / nslab, K, nc0 * C, min(C, K - nc0 * C),
                     &bars[buf ^ 1]);
      }
      __syncthreads();  // X, the lane bodies and the free tile are visible
      mbar_wait(&bars[buf], (uint32_t)(step >> 1) & 1u);
      const float* jc = sjc + buf * C * 36;

      // Each lane block (kl, jl) with no slot pair on a common body >= 0 is
      // written here as zeros (and the diagonal fix); the others are listed,
      // as (kl, jl, the pairs' bits), a warp's at once.
      const int lane = tid & 31;
      for (int base = 0; base < nl * nc; base += kThreads) {
        const int lb = base + tid;
        int key = 0;
        if (lb < nl * nc) {
          const int kl = lb / nc, jl = lb - kl * nc;
          const int bk0 = sbk[kl], bk1 = sbk[lanes_cap + kl];
          const int bj0 = cb0[jl], bj1 = cb1[jl];
          const int pairs = (bk0 >= 0 && bk0 == bj0) | (bk0 >= 0 && bk0 == bj1) << 1 |
                            (bk1 >= 0 && bk1 == bj0) << 2 | (bk1 >= 0 && bk1 == bj1) << 3;
          if (pairs) {
            key = kl << 16 | jl << 4 | pairs;
          } else {
            const bool on_diag = lane0 + kl == j0 + jl;
            const float fix = on_diag ? (sbk[2 * lanes_cap + kl] ? cfm : 1.f) : 0.f;
            float* out = tile + 3 * kl * mp + 3 * (j0 + jl);
#pragma unroll
            for (int r = 0; r < 3; ++r)
#pragma unroll
              for (int cc = 0; cc < 3; ++cc) out[r * mp + cc] = 0.f + (r == cc ? fix : 0.f);
          }
        }
        const unsigned listed = __ballot_sync(0xffffffffu, key != 0);
        int at = 0;
        if (lane == 0 && listed) at = atomicAdd(scount, __popc(listed));
        at = __shfl_sync(0xffffffffu, at, 0);
        if (key) slist[at + __popc(listed & ((1u << lane) - 1u))] = key;
      }
      __syncthreads();  // the list is complete

      // One thread a column cc of a listed lane block: entries (3k + r,
      // 3j + cc), r = 0..2.
      const int nlisted = *scount;
      for (int t = tid; t < 3 * nlisted; t += kThreads) {
        const int key = slist[t / 3], cc = t - 3 * (t / 3);
        const int kl = key >> 16, jl = (key >> 4) & 0xfff, pairs = key & 15;
        const int k = lane0 + kl, j = j0 + jl;
        float jr[12];  // row 3j + cc of Jc, both slots
        const float4* j4 = reinterpret_cast<const float4*>(jc + (3 * jl + cc) * 12);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float4 v = j4[q];
          jr[4 * q] = v.x;
          jr[4 * q + 1] = v.y;
          jr[4 * q + 2] = v.z;
          jr[4 * q + 3] = v.w;
        }
        const float* xk = sX + kl * 36;
        float val[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int si = p >> 1, sj = p & 1;
          if (!(pairs >> p & 1)) continue;
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            const float2* x2 = reinterpret_cast<const float2*>(xk + r * 12 + 6 * si);
            const float2 xa = x2[0], xb = x2[1], xc = x2[2];
            const float xv[6] = {xa.x, xa.y, xb.x, xb.y, xc.x, xc.y};
            float dot = 0.f;
#pragma unroll
            for (int e = 0; e < 6; ++e) dot = dot + xv[e] * jr[6 * sj + e];
            val[r] = val[r] + dot;
          }
        }
        const float fix = sbk[2 * lanes_cap + kl] ? cfm : 1.f;
        float* out = tile + 3 * kl * mp + 3 * j + cc;
#pragma unroll
        for (int r = 0; r < 3; ++r) out[r * mp] = val[r] + ((k == j && r == cc) ? fix : 0.f);
      }
      __syncthreads();  // this chunk's buffer and lane bodies are read
    }

    // Columns past 3K of the lane rows, and the padding rows (identity).
    const int pad_cols = mp - m;
    for (int e = tid; e < (lrow1 - row0) * pad_cols; e += kThreads) {
      const int r = e / pad_cols;
      tile[r * mp + m + (e - r * pad_cols)] = 0.f;
    }
    const int prow0 = max(row0, m);
    for (int e = tid; e < (row1 - prow0) * mp; e += kThreads) {
      const int r = e / mp, col = e - r * mp;
      tile[(prow0 - row0 + r) * mp + col] = prow0 + r == col ? 1.f : 0.f;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the tile, to the bulk store
    __syncthreads();
    for (int r = tid; r < row1 - row0; r += kThreads)
      diag[s * mp + row0 + r] = tile[r * mp + row0 + r];
    if (tid == 0) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
                       A + (s * mp + row0) * (int64_t)mp),
                   "r"(smem_u32(tile)), "r"((uint32_t)(row1 - row0) * (uint32_t)mp * 4u)
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace

// R (rows a slab) and C (lanes a chunk) come from the caller's launch
// plan; one this file does not take is refused.
extern "C" int eggshell_amat_f32(const float* Jc, const int64_t* b0, const int64_t* b1,
                                 const uint8_t* act, const float* inv_mass, const float* invIg,
                                 float* A, float* diag, int64_t B, int K, int n, int mp, float cfm,
                                 int R, int C, void* stream) {
  if (B <= 0) return 0;
  if (K <= 0 || mp % 8 != 0 || mp < 3 * K || mp - 3 * K >= 8 || R <= 0 || R > mp ||
      (R < mp && R % 3 != 0) || (R + 2) / 3 > kThreads || C <= 0 || C > K)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)layout(K, mp, R, C).total;
  cudaError_t e = jacobi_rows::allow_shared((const void*)amat_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  int err = 0;
  const int sms = jacobi_rows::sm_count(&err);
  if (err != 0) return err;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, amat_kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t items = B * ((mp + R - 1) / R);
  if (items > INT32_MAX) return (int)cudaErrorInvalidValue;  // the kernel counts items in 32 bits
  const int64_t grid = items < (int64_t)per_sm * sms ? items : (int64_t)per_sm * sms;
  amat_kernel<<<(unsigned)grid, kThreads, smem, (cudaStream_t)stream>>>(
      Jc, b0, b1, act, inv_mass, invIg, A, diag, B, K, n, mp, cfm, R, C);
  return (int)cudaGetLastError();
}
