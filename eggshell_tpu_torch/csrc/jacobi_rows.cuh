// What the packed Jacobi kernels B6 (csrc/jacobi_packed.cu) and B6b
// (csrc/jacobi_packed_stream.cu) share: the TMA copy of a scenario's rows of
// A into a ring stage of shared memory, a row of A held in registers, the
// row sums of A x, the lane bounds and the heavy-ball update of a row, and
// the cluster's stores of the iterate.  B6b must return the bits of B6's
// scalar form, so both compute a row through these functions alone.  The
// unfused solves B6c and B6c' (csrc/jacobi.cu) take the copy, the register
// row, the update and the stores from here too.
//
// Row layout in a ring stage: row r of the copy at r * ld floats, ld = mp + 4,
// columns mp..mp+3 zero.  The copy is one 2D tensor TMA a stage: a box of
// (mp + 4) columns by the stage's rows over A seen as (B mp) rows of mp
// floats, so the four columns past each row fall out of the tensor and
// arrive as zeros.  Unpadded (a 1D bulk copy of the scenario's
// contiguous mp^2 floats), a warp's rows start in one bank at every column
// (mp is a multiple of 8, usually of 32), and a thread's float4 of column
// chunk c must land in register slot c, a compile-time index, so a
// per-thread rotation of the column cannot be used.  With ld = mp + 4 the
// rows of a quarter warp start 4, 12, 20 or 28 banks apart, and each float4
// load of a column chunk takes one wavefront a quarter warp.  One bulk copy
// a row gives the same layout; B6 at mp = 64 took 0.0573 ms that way and
// 0.0489 ms with one tensor copy a scenario (`chip_smoke.py`, H100 SXM at
// 700 W).  A box is at
// most 256 columns wide, so rows of more than 252 floats (B6b only) still
// go one bulk copy a row, 1 KB or more each.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace jacobi_rows {

constexpr float kHiInf = 3.4e38f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive on `bar` and add `bytes` to the transfer its phase waits for.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Block until the phase of `bar` with parity `parity` has completed; with
// cluster scope, so that stores of other blocks of the cluster that
// completed the phase are visible.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// The shared::cluster address of `p` in block `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// Store `v` at `addr` (shared::cluster) and count its 4 bytes on the
// mbarrier at `bar` of the same block (the cluster kernels' iterate).
__device__ __forceinline__ void send(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];" ::"r"(
                   addr),
               "f"(v), "r"(bar)
               : "memory");
}

// Load `nrows` rows of A from row `row0` of the (rows, lda) view into `dst`
// (row stride ld = mp + 4, zero past lda), completing on `bar`.  lda is mp
// for the packed solves' A and m for the unfused solves' (B6c, B6c').
// Called by every thread of warp 0.  With a tensor map (`encode_rows_map`),
// lane 0 issues one 2D tensor copy of (mp + 4) x nrows; without, the lanes
// issue one bulk copy a row of lda floats (lda % 4 == 0), and the columns
// lda..ld-1 of `dst` must already be zero.  The stage was last read
// through ordinary loads, before a barrier of the whole block; the proxy
// fence orders those reads before the asynchronous writes.
__device__ __forceinline__ void load_rows(float* dst, const CUtensorMap* tmap,
                                          const float* __restrict__ A, int64_t row0, int nrows,
                                          int mp, int lda, uint64_t* bar) {
  const int lane = threadIdx.x;
  const int ld = mp + 4;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  if (tmap != nullptr) {
    if (lane == 0) {
      mbar_expect(bar, (uint32_t)nrows * (uint32_t)ld * 4u);
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
          "l"(reinterpret_cast<uint64_t>(tmap)), "r"(0), "r"((int)row0), "r"(smem_u32(bar))
          : "memory");
    }
    return;
  }
  const uint32_t row_bytes = (uint32_t)lda * 4u;
  if (lane == 0) mbar_expect(bar, row_bytes * (uint32_t)nrows);
  __syncwarp();
  for (int r = lane; r < nrows; r += 32) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
            "r"(smem_u32(dst + (int64_t)r * ld)),
        "l"(A + (row0 + r) * lda), "r"(row_bytes), "r"(smem_u32(bar))
        : "memory");
  }
}

// One row of A in registers, RL floats (a multiple of 32, at least mp);
// columns past mp are zero.  RL is a template constant so that every slot
// index is known at compile time and the row never goes to local memory.
template <int RL>
struct RegRow {
  float4 a[RL / 4];

  __device__ __forceinline__ void load(const float* row, int mp) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int c = 0; c < RL / 4; ++c) a[c] = 4 * c < mp ? r4[c] : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // sum_j a_j x_j over j in increasing order; x (16-byte aligned, RL floats)
  // is zero past mp and is read as float4 broadcasts.
  __device__ __forceinline__ float dot(const float* x) const {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float ax = 0.f;
#pragma unroll
    for (int c = 0; c < RL / 4; ++c) {
      const float4 v = x4[c];
      ax = ax + a[c].x * v.x;
      ax = ax + a[c].y * v.y;
      ax = ax + a[c].z * v.z;
      ax = ax + a[c].w * v.w;
    }
    return ax;
  }
};

// ax + sum over the float4 groups c0..c1-1 of r4[c] . x4[c], added one
// product at a time in increasing column order, from shared memory.  Each
// group's two loads are issued a group ahead of its adds, so a load's
// latency hides behind the previous group's four dependent adds (the row's
// one add chain is what bounds these sums: it cannot be split without
// changing the bits).
__device__ __forceinline__ float dot4(const float4* r4, const float4* x4, int c0, int c1,
                                      float ax) {
  if (c0 >= c1) return ax;
  float4 a = r4[c0], v = x4[c0];
#pragma unroll 4
  for (int c = c0 + 1; c < c1; ++c) {
    const float4 an = r4[c];
    const float4 vn = x4[c];
    ax = ax + a.x * v.x;
    ax = ax + a.y * v.y;
    ax = ax + a.z * v.z;
    ax = ax + a.w * v.w;
    a = an;
    v = vn;
  }
  ax = ax + a.x * v.x;
  ax = ax + a.y * v.y;
  ax = ax + a.z * v.z;
  ax = ax + a.w * v.w;
  return ax;
}

// The same sum for a row kept in shared memory (rows longer than 128),
// over its mp columns.
__device__ __forceinline__ float shared_dot(const float* row, const float* x, int mp) {
  return dot4(reinterpret_cast<const float4*>(row), reinterpret_cast<const float4*>(x), 0,
              mp / 4, 0.f);
}

// Row i's inputs of scenario s: its b, diag(A)_i and its lane's masks;
// rows past 3K have b = 0 and no lane, rows past mp (idle threads) d = 1.
// The kernels read the next scenario's while they sweep this one.
struct RowInputs {
  float b, d;
  bool act, eq;
};

__device__ __forceinline__ RowInputs row_inputs(const float* __restrict__ rhs,
                                                const float* __restrict__ diag,
                                                const uint8_t* __restrict__ act,
                                                const uint8_t* __restrict__ eq, int64_t s, int K,
                                                int mp, int i) {
  RowInputs in = {0.f, 1.f, false, false};
  if (i < mp) in.d = diag[s * mp + i];
  if (i < 3 * K) {
    in.b = rhs[s * 3 * K + i];
    in.act = act[s * K + i / 3] != 0;
    in.eq = eq != nullptr && eq[s * K + i / 3] != 0;
  }
  return in;
}

// A row's bounds, built from its lane's masks (see csrc/jacobi_packed.cu):
// equality lanes free, tangential rows in [-mu, mu], normal rows in
// [0, 3.4e38].  Rows past 3K are never projected.
struct RowBounds {
  float lo, hi;
};

__device__ __forceinline__ RowBounds row_bounds(const RowInputs& in, int i, float mu) {
  RowBounds rb = {0.f, kHiInf};
  if (in.eq) {
    rb.lo = -kHiInf;
  } else if (i % 3 < 2) {
    rb.lo = -mu;
    rb.hi = mu;
  }
  return rb;
}

// x <- proj((1 - omega) x + omega y + beta (x - x_prev)) for the scalar
// sweep's y = (b - A x + d x) / d, written as in the plain version.
__device__ __forceinline__ float scalar_update(float rv, float x, float xprev, float d,
                                               float inv_d, float omega, float beta, bool active,
                                               float lo, float hi) {
  const float r = rv + d * x;
  float xn = (1.f - omega) * x + omega * r * inv_d + beta * (x - xprev);
  if (active) xn = fminf(fmaxf(xn, lo), hi);
  return xn;
}

// Streaming multiprocessors of the current device, read once per device.
inline int sm_count(int* err) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev < 0 || dev >= 64)) e = cudaErrorInvalidDevice;
  if (e != cudaSuccess) {
    *err = (int)e;
    return 0;
  }
  if (cached[dev] == 0) {
    e = cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) {
      *err = (int)e;
      return 0;
    }
  }
  return cached[dev];
}

// The tensor map of A seen as (rows, cols) floats, read in boxes of
// (mp + 4) x box_rows (columns past cols come back as zeros), for
// `load_rows`; cols % 4 == 0 (a row's stride is a multiple of 16 bytes).
// The encoder lives in libcuda; the runtime hands it over by name, so the
// library needs no link to libcuda.  Returns 0 or a cudaError_t.
inline int encode_rows_map(CUtensorMap* map, const float* A, int64_t rows, int cols, int mp,
                           int box_rows) {
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                             const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                             const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                            &found);
#endif
    if (e != cudaSuccess) return (int)e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)(mp + 4), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(A), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Bytes of a ring stage of `rows` rows of stride mp + 4 floats, rounded up
// to 128: a tensor copy's destination is 128-byte aligned.
__host__ __device__ inline int64_t stage_bytes(int rows, int mp) {
  return ((int64_t)rows * (mp + 4) * 4 + 127) / 128 * 128;
}

// Allow `kernel` `smem` bytes of dynamic shared memory where that is more
// than the default 48 KB.
inline cudaError_t allow_shared(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace jacobi_rows
