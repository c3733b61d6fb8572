// Per-body pre-solve prep of the fused step (B1), float32.
//
// Replaces the TPU kernel `_prep_kernel` of eggshell_tpu/ops/prep_kernel.py
// (reached through `prep_packed`).  Per body of every scenario:
//   R     = quat_to_mat(q)
//   invIg = R I_b^-1 R^T,  Ig = R I_b R^T
//   F     = [m g + ext_lin; -w x (Ig w) + ext_ang]     (m = 1/inv_mass, 0 if static)
//   uhat  = u/dt + M^-1 F = [v/dt + inv_mass F_lin; w/dt + invIg F_ang]
// with every sum taken in the TPU kernel's order, so that, built with
// --fmad=false, it rounds as the plain torch version does.
//
// What bounds it on an H100: bytes and latency.  A body reads 10 floats of
// state (16 with external force) and writes 21; its ~150 flops are nothing
// beside that, and at the bench shape (16,384 bodies, 2 MB) the bytes take
// 0.6 us, less than one round trip to device memory and back.  So the
// kernel is a chain of three steps, each made as short as it can be:
//   1. a block takes a tile of T consecutive bodies of the flattened B * n
//      range (`ops.prep_kernel.prep_launch_plan`: T = 128, 64 or 32, the
//      largest that still gives every SM two blocks) and brings the
//      tile's q, v, w and ext, each one contiguous run of bytes, into
//      shared memory in one round of asynchronous copies (`cp.async`, 16
//      bytes a copy where the run starts 16-byte aligned, else 4: a view
//      at a storage offset is taken, never refused), all in flight at
//      once.  Meanwhile each thread reads its body's constants (inv_mass,
//      I_b, I_b^-1: 19 floats shared by every scenario) through the
//      read-only path, for any n;
//   2. one thread a body computes from shared memory, in 32-bit indices,
//      and writes its 21 outputs into shared memory in their final layout;
//   3. the block stores the tile's three output runs (uhat, invIg, F) with
//      16-byte vector stores where the run is 16-byte aligned, else 4-byte
//      stores: every store instruction of a warp writes whole sectors.
// The TPU kernel's (8, 128) scenario tiles are not carried over: the arrays
// stay scenario-major (B, n, ...).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTile = 128;
// Shared floats a body: q, v, w, ext in; uhat, invIg, F out.
constexpr int kInFloats = 4 + 3 + 3 + 6;
constexpr int kOutFloats = 6 + 9 + 6;

// C = A B for row-major 3x3, sums in k order.
__device__ __forceinline__ void mat3_mul(const float* A, const float* B, float* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

// C = A B^T for row-major 3x3.
__device__ __forceinline__ void mat3_mul_t(const float* A, const float* B, float* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[3 * j] + A[3 * i + 1] * B[3 * j + 1] + A[3 * i + 2] * B[3 * j + 2];
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int BYTES>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

// Start the copies of `count` floats from device memory to `dst` (shared,
// 16-byte aligned): 16 bytes a copy where src is 16-byte aligned, the tail
// and a misaligned run 4 bytes a copy.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int count) {
  int done = 0;
  if (aligned16(src)) {
    const int n4 = count >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x) copy_async<16>(dst + 4 * i, src + 4 * i);
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < count; i += blockDim.x) copy_async<4>(dst + i, src + i);
}

// Store `count` floats from `src` (shared, 16-byte aligned) to device
// memory: 16-byte vectors where dst is 16-byte aligned, else floats.
__device__ __forceinline__ void store(float* __restrict__ dst, const float* src, int count) {
  int done = 0;
  if (aligned16(dst)) {
    const int n4 = count >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

__global__ void __launch_bounds__(kMaxTile) prep_kernel(
    const float* __restrict__ q, const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ ext, const float* __restrict__ inv_mass,
    const float* __restrict__ Ib, const float* __restrict__ invIb, float* __restrict__ uhat,
    float* __restrict__ invig, float* __restrict__ F, int64_t total, int n, float inv_dt,
    float gx, float gy, float gz) {
  // T floats of each input, then of each output; T % 4 == 0, so every
  // array starts 16-byte aligned.
  __shared__ __align__(16) float smem[(kInFloats + kOutFloats) * kMaxTile];
  const int T = blockDim.x, i = threadIdx.x;
  const int64_t t0 = (int64_t)blockIdx.x * T;
  const int Te = (int)(total - t0 < T ? total - t0 : T);
  float* sq = smem;
  float* sv = sq + 4 * T;
  float* sw = sv + 3 * T;
  float* se = sw + 3 * T;
  float* su = se + 6 * T;
  float* sg = su + 6 * T;
  float* sF = sg + 9 * T;

  stage(sq, q + 4 * t0, 4 * Te);
  stage(sv, v + 3 * t0, 3 * Te);
  stage(sw, w + 3 * t0, 3 * Te);
  if (ext != nullptr) stage(se, ext + 6 * t0, 6 * Te);

  // the body's constants, loaded while the copies are in flight
  const int b = (int)(t0 % n + i) % n;
  float cI[9], cIi[9];
  float im = 0.f;
  if (i < Te) {
    for (int e = 0; e < 9; ++e) {
      cIi[e] = __ldg(invIb + 9 * b + e);
      cI[e] = __ldg(Ib + 9 * b + e);
    }
    im = __ldg(inv_mass + b);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  if (i < Te) {
    const float4 qq = reinterpret_cast<const float4*>(sq)[i];
    const float qw = qq.x, qx = qq.y, qy = qq.z, qz = qq.w;
    const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
    const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
    const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
    const float R[9] = {
        1.f - 2.f * (yy + zz), 2.f * (xy - wz), 2.f * (xz + wy),
        2.f * (xy + wz), 1.f - 2.f * (xx + zz), 2.f * (yz - wx),
        2.f * (xz - wy), 2.f * (yz + wx), 1.f - 2.f * (xx + yy),
    };
    float Tm[9], iIg[9], Ig[9];
    mat3_mul(R, cIi, Tm);
    mat3_mul_t(Tm, R, iIg);
    mat3_mul(R, cI, Tm);
    mat3_mul_t(Tm, R, Ig);
    for (int e = 0; e < 9; ++e) sg[9 * i + e] = iIg[e];

    const float w0 = sw[3 * i], w1 = sw[3 * i + 1], w2 = sw[3 * i + 2];
    float Igw[3];
    for (int r = 0; r < 3; ++r) Igw[r] = Ig[3 * r] * w0 + Ig[3 * r + 1] * w1 + Ig[3 * r + 2] * w2;
    float fang[3] = {-(w1 * Igw[2] - w2 * Igw[1]), -(w2 * Igw[0] - w0 * Igw[2]),
                     -(w0 * Igw[1] - w1 * Igw[0])};
    const float m = im > 0.f ? 1.f / im : 0.f;
    float flin[3] = {m * gx, m * gy, m * gz};
    if (ext != nullptr) {
      for (int c = 0; c < 3; ++c) {
        flin[c] = flin[c] + se[6 * i + c];
        fang[c] = fang[c] + se[6 * i + 3 + c];
      }
    }
    for (int c = 0; c < 3; ++c) {
      sF[6 * i + c] = flin[c];
      sF[6 * i + 3 + c] = fang[c];
      su[6 * i + c] = sv[3 * i + c] * inv_dt + im * flin[c];
    }
    const float wv[3] = {w0, w1, w2};
    for (int r = 0; r < 3; ++r) {
      float acc = wv[r] * inv_dt;
      for (int c = 0; c < 3; ++c) acc = acc + iIg[3 * r + c] * fang[c];
      su[6 * i + 3 + r] = acc;
    }
  }
  __syncthreads();

  store(uhat + 6 * t0, su, 6 * Te);
  store(invig + 9 * t0, sg, 9 * Te);
  store(F + 6 * t0, sF, 6 * Te);
}

}  // namespace

// `tile` bodies a block (32, 64 or 128: `prep_launch_plan`); any other
// launches nothing and returns cudaErrorInvalidValue.
extern "C" int eggshell_prep_f32(const float* q, const float* v, const float* w,
                                 const float* ext, const float* inv_mass, const float* Ib,
                                 const float* invIb, float* uhat, float* invig, float* F,
                                 int64_t B, int n, float inv_dt, float gx, float gy, float gz,
                                 int tile, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (tile != 32 && tile != 64 && tile != kMaxTile) return (int)cudaErrorInvalidValue;
  const int64_t total = B * n;
  const int64_t blocks = (total + tile - 1) / tile;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  prep_kernel<<<(unsigned)blocks, tile, 0, (cudaStream_t)stream>>>(
      q, v, w, ext, inv_mass, Ib, invIb, uhat, invig, F, total, n, inv_dt, gx, gy, gz);
  return (int)cudaGetLastError();
}
