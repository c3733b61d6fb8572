// Post-solve integration of the fused chain (B7), float32.
//
// Replaces the TPU kernel `_integrate_kernel` of
// eggshell_tpu/ops/integrate_kernel.py (reached through `integrate_step`).
// Per body of every scenario:
//   J^T lambda = sum over lanes k, slots s with lane body b_s[k] == body, of
//                sum_r lambda[3k + r] Jc[3k + r, slot s]    (the ground, -1, is no body)
//   vdot       = [inv_mass (F + J^T lambda)_lin; invIg (F + J^T lambda)_ang]
//   u_new      = u + dt vdot,  u_mid = (u + u_new) / 2,  p += dt u_mid_lin
//   q          = normalize(exp(dt u_mid_ang) * q)
// with the TPU kernel's small-angle branch (|phi|^2 < 1e-12) and its order
// of operations; sinf, cosf and sqrtf are the correctly rounded or 1-ulp
// library functions, not the __ intrinsics.
//
// What bounds it on an H100: bytes, 70 % of them Jc (144 bytes a lane), and
// the latency of reaching them.  One thread a body walking every lane in
// turn leaves the card with too few warps and each thread with a serial
// chain of loads, so the work is spread over the lanes instead.  A block
// takes a tile of S scenarios (`ops.integrate_kernel.integrate_launch_plan`)
// and, in one round of coalesced asynchronous copies (`cp.async`, all in
// flight at once, then one wait), brings into shared memory the tile's Jc
// (16-byte copies of each scenario's contiguous rows), its lambda and lane
// bodies, and the state of its bodies.  Then:
//   1. one thread a (scenario, lane, slot) forms the slot's 6 products
//      (l0 J0 + l1 J1) + l2 J2, zeros where the slot's body is the ground;
//   2. one thread a (scenario, body, component) sums them over the lanes in
//      lane order, slot 0 before slot 1, adding only where the slot's body
//      is its body: the plain version's order, so with --fmad=false the
//      bits are its bits (it adds +0 on a miss, which is the identity on a
//      sum that starts at +0 and so never becomes -0);
//   3. one thread a (scenario, body) integrates and stores.
// No atomics.  Where a tile's lanes and bodies do not fit the shared
// memory the plan allows, the plan's chunk route walks the lanes in chunks
// of `kc` (the sums carry over in shared memory, the order kept) and the
// bodies in chunks of `nb` (each chunk walks every lane chunk).
//
// The plan is computed here as in Python (`plan_of`); the entry refuses
// any other.  EGGSHELL_INTEGRATE_THREADS sets the threads a block, and so
// the tile; the library is built at the default only, and a probe
// (tools/integrate_compact_probe.py --threads) builds this file alone at
// others.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifndef EGGSHELL_INTEGRATE_THREADS
#define EGGSHELL_INTEGRATE_THREADS 256
#endif

constexpr int kMaxThreads = 512;
constexpr int kThreads = EGGSHELL_INTEGRATE_THREADS;
static_assert(kThreads >= 32 && kThreads <= kMaxThreads && kThreads % 32 == 0,
              "threads a block: a multiple of 32 up to kMaxThreads");
constexpr int64_t kMaxShared = 232448;
constexpr int64_t kSharedTarget = kMaxShared / 2;  // two blocks an SM
constexpr int kMaxBodyChunk = 256;
constexpr int kLaneFloats = 36;   // Jc rows 3k..3k+2, 12 columns
// Shared words a scenario: a lane's Jc, 2 x 6 products, 3 lambdas and 2
// int64 body ids; a body's q, p, v, w, invIg, F and J^T lambda.
constexpr int kLaneWords = kLaneFloats + 12 + 3 + 4;
constexpr int kBodyWords = 4 + 3 + 3 + 3 + 9 + 6 + 6;

// An asynchronous copy of BYTES (4, 8 or 16) from device to shared memory.
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(d), "l"(src), "n"(BYTES)
                 : "memory");
}

// Copies width floats of body rows n0 .. n0+nb of scenarios s0 .. s0+Se of
// a (B, n, width) tensor into dst, rows NB apart per scenario.
__device__ __forceinline__ void stage_bodies(float* dst, const float* __restrict__ src,
                                             int width, int64_t s0, int Se, int n, int n0,
                                             int nb, int NB) {
  if (nb == n) {  // one body chunk (NB == n): the tile's rows are one run
    const float* run = src + s0 * n * width;
    for (int i = threadIdx.x; i < Se * n * width; i += blockDim.x)
      copy_async<4>(dst + i, run + i);
    return;
  }
  const int per = nb * width;
  for (int i = threadIdx.x; i < Se * per; i += blockDim.x) {
    const int s = i / per, r = i - s * per;
    copy_async<4>(dst + s * NB * width + r, src + ((s0 + s) * n + n0) * width + r);
  }
}

__global__ void __launch_bounds__(kMaxThreads) integrate_kernel(
    const float* __restrict__ Jc, const float* __restrict__ lam, const int64_t* __restrict__ b0,
    const int64_t* __restrict__ b1, const float* __restrict__ p, const float* __restrict__ q,
    const float* __restrict__ v, const float* __restrict__ w, const float* __restrict__ inv_mass,
    const float* __restrict__ invIg, const float* __restrict__ F, float* __restrict__ p_out,
    float* __restrict__ q_out, float* __restrict__ v_out, float* __restrict__ w_out, int64_t B,
    int K, int n, int lam_stride, float dt, int S, int KC, int NB) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, T = blockDim.x;
  const int64_t s0 = (int64_t)blockIdx.x * S;
  const int Se = (int)(B - s0 < S ? B - s0 : S);
  float* sJ = smem;                        // S * KC * 36, 16-byte aligned
  float* sq = sJ + S * KC * kLaneFloats;   // S * NB * 4, 16-byte aligned
  int64_t* sid = reinterpret_cast<int64_t*>(sq + S * NB * 4);  // S * KC * 2 lane bodies
  float* sc = reinterpret_cast<float*>(sid + S * KC * 2);      // S * KC * 2 * 6 products
  float* sl = sc + S * KC * 12;            // S * KC * 3 lambdas
  float* sp = sl + S * KC * 3;             // S * NB * 3
  float* sv = sp + S * NB * 3;
  float* sw = sv + S * NB * 3;
  float* sg = sw + S * NB * 3;             // S * NB * 9
  float* sF = sg + S * NB * 9;             // S * NB * 6
  float* sj = sF + S * NB * 6;             // S * NB * 6 sums
  float* sm = sj + S * NB * 6;             // NB inverse masses

  for (int n0 = 0; n0 < n; n0 += NB) {
    const int nb = n - n0 < NB ? n - n0 : NB;
    // the tile's bodies: copies issued beside the first lane chunk's
    stage_bodies(sq, q, 4, s0, Se, n, n0, nb, NB);
    stage_bodies(sp, p, 3, s0, Se, n, n0, nb, NB);
    stage_bodies(sv, v, 3, s0, Se, n, n0, nb, NB);
    stage_bodies(sw, w, 3, s0, Se, n, n0, nb, NB);
    stage_bodies(sg, invIg, 9, s0, Se, n, n0, nb, NB);
    stage_bodies(sF, F, 6, s0, Se, n, n0, nb, NB);
    for (int i = tid; i < nb; i += T) copy_async<4>(sm + i, inv_mass + n0 + i);
    for (int i = tid; i < Se * NB * 6; i += T) sj[i] = 0.f;

    for (int k0 = 0; k0 < K; k0 += KC) {
      const int kc = K - k0 < KC ? K - k0 : KC;
      // the chunk's Jc, in 16-byte copies of each scenario's contiguous rows
      const int per4 = kc * kLaneFloats / 4;
      if (kc == K) {  // one lane chunk: the tile's rows are one run
        const float* run = Jc + s0 * K * kLaneFloats;
        for (int i = tid; i < Se * per4; i += T) copy_async<16>(sJ + 4 * i, run + 4 * i);
      } else {
        for (int i = tid; i < Se * per4; i += T) {
          const int s = i / per4, r = i - s * per4;
          copy_async<16>(sJ + 4 * (s * KC * 9 + r), Jc + 4 * (((s0 + s) * K + k0) * 9 + r));
        }
      }
      for (int i = tid; i < Se * kc * 3; i += T) {
        const int s = i / (kc * 3), r = i - s * kc * 3;
        copy_async<4>(sl + s * KC * 3 + r, lam + (s0 + s) * lam_stride + 3 * k0 + r);
      }
      // lane bodies (the ground, -1, matches no body)
      for (int i = tid; i < Se * kc * 2; i += T) {
        const int s = i / (kc * 2), r = i - s * kc * 2, kk = r >> 1;
        copy_async<8>(sid + s * KC * 2 + r, ((r & 1) ? b1 : b0) + (s0 + s) * K + k0 + kk);
      }
      asm volatile("cp.async.wait_all;" ::: "memory");
      __syncthreads();

      // 1. the products of each (scenario, lane, slot)
      for (int i = tid; i < Se * kc * 2; i += T) {
        const int s = i / (kc * 2), r = i - s * kc * 2, kk = r >> 1, slot = r & 1;
        float* c = sc + (s * KC * 2 + r) * 6;
        if (sid[s * KC * 2 + r] < 0) {
#pragma unroll
          for (int j = 0; j < 6; ++j) c[j] = 0.f;
          continue;
        }
        const float* J = sJ + (s * KC + kk) * kLaneFloats + 6 * slot;
        const float* l = sl + (s * KC + kk) * 3;
        const float l0 = l[0], l1 = l[1], l2 = l[2];
#pragma unroll
        for (int j = 0; j < 6; ++j) c[j] = l0 * J[j] + l1 * J[12 + j] + l2 * J[24 + j];
      }
      __syncthreads();

      // 2. each (scenario, body, component) sums its hits in lane order
      for (int i = tid; i < Se * nb * 6; i += T) {
        const int s = i / (nb * 6), r = i - s * nb * 6, b = r / 6, c = r - b * 6;
        const int body = n0 + b;
        const int64_t* ids = sid + s * KC * 2;
        const float* con = sc + s * KC * 12 + c;
        float acc = sj[(s * NB + b) * 6 + c];
#pragma unroll 4
        for (int e = 0; e < 2 * kc; ++e)
          if (ids[e] == body) acc = acc + con[6 * e];
        sj[(s * NB + b) * 6 + c] = acc;
      }
      __syncthreads();  // the next chunk overwrites the stage
    }

    // 3. each (scenario, body) integrates
    for (int i = tid; i < Se * nb; i += T) {
      const int s = i / nb, b = i - s * nb;
      const int l = s * NB + b;
      const int64_t t = (s0 + s) * n + n0 + b;
      float rhs[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) rhs[c] = sF[6 * l + c] + sj[6 * l + c];
      const float im = sm[b];
      const float* ig = sg + 9 * l;
      float vdot[6];
#pragma unroll
      for (int c = 0; c < 3; ++c) vdot[c] = im * rhs[c];
#pragma unroll
      for (int r = 0; r < 3; ++r)
        vdot[3 + r] = ig[3 * r] * rhs[3] + ig[3 * r + 1] * rhs[4] + ig[3 * r + 2] * rhs[5];

      float u[6], u_new[6], u_mid[6];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        u[c] = sv[3 * l + c];
        u[3 + c] = sw[3 * l + c];
      }
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        u_new[r] = u[r] + dt * vdot[r];
        u_mid[r] = 0.5f * (u[r] + u_new[r]);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        p_out[3 * t + c] = sp[3 * l + c] + dt * u_mid[c];
        v_out[3 * t + c] = u_new[c];
        w_out[3 * t + c] = u_new[3 + c];
      }

      const float phi0 = dt * u_mid[3], phi1 = dt * u_mid[4], phi2 = dt * u_mid[5];
      const float t2 = phi0 * phi0 + phi1 * phi1 + phi2 * phi2;
      const bool small = t2 < 1e-12f;
      const float safe_t = sqrtf(small ? 1.f : t2);
      const float kfac = small ? 0.5f - t2 / 48.f : sinf(0.5f * safe_t) / safe_t;
      const float dw = small ? 1.f - t2 / 8.f : cosf(0.5f * safe_t);
      const float dx = kfac * phi0, dy = kfac * phi1, dz = kfac * phi2;

      const float4 qb = reinterpret_cast<const float4*>(sq)[l];
      const float qw = qb.x, qx = qb.y, qy = qb.z, qz = qb.w;
      const float nw = dw * qw - dx * qx - dy * qy - dz * qz;
      const float nx = dw * qx + dx * qw + dy * qz - dz * qy;
      const float ny = dw * qy - dx * qz + dy * qw + dz * qx;
      const float nz = dw * qz + dx * qy - dy * qx + dz * qw;
      const float norm = sqrtf(nw * nw + nx * nx + ny * ny + nz * nz);
      const float inv = 1.f / (norm > 0.f ? norm : 1.f);
      reinterpret_cast<float4*>(q_out)[t] = make_float4(nw * inv, nx * inv, ny * inv, nz * inv);
    }
    __syncthreads();  // the next body chunk overwrites the stage
  }
}

struct Plan {
  int S, KC, NB, threads, shared_bytes;
};

int64_t shared_bytes_of(int64_t S, int64_t KC, int64_t NB) {
  return S * (KC * kLaneWords + NB * kBodyWords) * 4 + NB * 4;
}

// `ops.integrate_kernel.integrate_launch_plan`: S = kThreads / 2K
// scenarios a block (at least 1, at most B), fewer where their stage
// passes kSharedTarget; where one scenario's does too, one scenario a block
// with bodies in chunks of up to kMaxBodyChunk and lanes in the largest
// chunks that fit.
Plan plan_of(int64_t B, int K, int n) {
  int64_t S = kThreads / (K > 0 ? 2 * K : 1);
  S = S < B ? S : B;
  S = S > 1 ? S : 1;
  while (S > 1 && shared_bytes_of(S, K, n) > kSharedTarget) --S;
  if (shared_bytes_of(S, K, n) <= kSharedTarget)
    return {(int)S, K, n, kThreads, (int)shared_bytes_of(S, K, n)};
  const int nb = n < kMaxBodyChunk ? n : kMaxBodyChunk;
  const int64_t fit = (kSharedTarget - shared_bytes_of(1, 0, nb)) / (kLaneWords * 4);
  const int kc = K < fit ? K : (int)fit;
  return {1, kc, nb, kThreads, (int)shared_bytes_of(1, kc, nb)};
}

}  // namespace

// The plan of (B, K, n): out = {scenarios, lanes, bodies, threads,
// shared_bytes}.  Returns cudaErrorInvalidValue where B < 0, K < 0 or n < 1.
extern "C" int eggshell_integrate_plan(int64_t B, int K, int n, int* out) {
  if (B < 0 || K < 0 || n < 1) return (int)cudaErrorInvalidValue;
  const Plan pl = plan_of(B, K, n);
  out[0] = pl.S;
  out[1] = pl.KC;
  out[2] = pl.NB;
  out[3] = pl.threads;
  out[4] = pl.shared_bytes;
  return 0;
}

// (S scenarios a block, lane chunks of KC, body chunks of NB, `threads` a
// block, `shared_bytes`) must be `plan_of(B, K, n)`: any other launches
// nothing and returns cudaErrorInvalidValue.  Jc must be 16-byte aligned.
extern "C" int eggshell_integrate_f32(const float* Jc, const float* lam, const int64_t* b0,
                                      const int64_t* b1, const float* p, const float* q,
                                      const float* v, const float* w, const float* inv_mass,
                                      const float* invIg, const float* F, float* p_out,
                                      float* q_out, float* v_out, float* w_out, int64_t B, int K,
                                      int n, int lam_stride, float dt, int S, int KC, int NB,
                                      int threads, int shared_bytes, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (K < 0) return (int)cudaErrorInvalidValue;
  const Plan pl = plan_of(B, K, n);
  if (S != pl.S || KC != pl.KC || NB != pl.NB || threads != pl.threads ||
      shared_bytes != pl.shared_bytes ||
      (reinterpret_cast<uintptr_t>(Jc) | reinterpret_cast<uintptr_t>(q_out)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (B + S - 1) / S;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (shared_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(integrate_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         shared_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  integrate_kernel<<<(unsigned)blocks, threads, shared_bytes, (cudaStream_t)stream>>>(
      Jc, lam, b0, b1, p, q, v, w, inv_mass, invIg, F, p_out, q_out, v_out, w_out, B, K, n,
      lam_stride, dt, S, KC, NB);
  return (int)cudaGetLastError();
}
