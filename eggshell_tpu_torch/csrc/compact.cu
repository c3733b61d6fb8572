// Contact compaction and dedupe of the fused chain (B3), float32.
//
// Replaces the TPU kernels `_compact_kernel` and `_compact_kernel_ground` of
// eggshell_tpu/ops/compact_kernel.py (reached through
// `compact_contacts_packed`), with the same semantics as the plain version
// `eggshell_tpu_torch.ops.compact_kernel.compact_contacts_plain`.  Per
// scenario:
//
//   candidates  ground corners first, 8 per body, body-major, corner signs
//               in x-major/y/z order: c = p + R0 (sx hx) + R1 (sy hy) + R2 (sz hz)
//               (R from q, the expressions of ops/quaternion.quat_to_mat),
//               active when cz < 0 and the body's ground_enabled, normal +z,
//               depth -cz, b0 = -1, b1 = the body; then pair k's 12 lanes
//               from csrc/narrowphase.cu's packed entry, b0 = pair_i[k],
//               b1 = pair_j[k] (pair_i[s, k], pair_j[s, k] where each
//               scenario has its own list, the broadphase's);
//   depth cap   min(depth, cap) (cap = +inf: none);
//   compaction  stable: active candidate number o goes to lane o, those
//               past K are dropped;
//   dedupe      non-cascaded: lane k is dropped (active cleared, ids kept)
//               when an earlier lane has the same unordered body pair,
//               neither is a ground lane, and |pos_k - pos_j|^2 < eps2;
//   idle lanes  never filled: b0 = b1 = -1, zero geometry, inactive.
//
// What bounds it on an H100: bytes, and few of them: the state of n bodies,
// 12P activity flags, and 28 bytes of geometry for each candidate that lands
// in a lane; a few flops a candidate.  So what costs is latency: a chain of
// dependent round trips to device memory.  The TPU kernel's (8, 128)
// scenario tiles and its K-vectorised one-hot accumulators are not carried
// over.  The design: one warp per scenario, two global round trips.
//
//   round 1   everything the flags depend on, all at once: a lane takes
//             g consecutive corners of one body (g = 1 to 8 by n) and reads
//             the body's p, q, half extents and ground flag (the lanes of a
//             body read the same words: one request a body, and no shuffle
//             after it, which timed slower on the card); the
//             scenario's 12P flag bytes come as 32-bit words, a lane
//             holding up to kWordsPerLane consecutive words.  Counting
//             the active candidates in the lanes below (ground lanes, then
//             pair words, each in lane order, then bit order within a
//             lane: ballots up to 4 candidates a lane, else a warp scan)
//             gives each active candidate its stable slot.  A ground corner
//             that lands below K writes its geometry at once, a pair
//             candidate its index.
//   round 2   the lanes take the landing slots round robin and load, all
//             together, the geometry and body ids of the pair candidates
//             among them.  Candidates past K are never read.
//   dedupe    the tests of each pair lane k against each earlier pair
//             lane j (a ground lane takes no part) spread over the warp's
//             32 lanes, their results OR-ed into a drop mask in shared
//             memory (an OR has no order).
//   stores    contiguous runs of the scenario's K lanes (3K floats of
//             position and of normal), as csrc/jassembly.cu takes them.
//
// `compact_ground_kernel` is the same body without pairs (P = 0), the
// counterpart of `_compact_kernel_ground`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 4;       // scenarios per block, fewer where K's stage needs it
constexpr int kGround = 8;         // corners per body
constexpr int kPairLanes = 12;     // narrowphase lanes per pair
constexpr int kLaneWords = 9;      // b0, b1, pos[3], nrm[3], depth
constexpr int kWordsPerLane = 4;   // flag words a lane holds in one round
constexpr int kMaxShared = 232448;

// Stage words a warp takes at K lanes: the lanes and the drop mask.
__host__ __device__ constexpr int stage_words(int K) { return kLaneWords * K + (K + 31) / 32; }

// The set bits of `mask` (its low `width` bits, the same width in every
// lane) in the lanes below this one, and in the warp (*total): one ballot
// a bit up to 4 bits, which are independent of each other, else an
// exclusive warp scan of the counts, a chain of 5 shuffles.
__device__ __forceinline__ int warp_offset(unsigned mask, int width, int lane, int* total) {
  if (width <= 4) {
    const unsigned below = (1u << lane) - 1u;
    int under = 0, all = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (b < width) {
        const unsigned v = __ballot_sync(kFull, (mask >> b) & 1u);
        under += __popc(v & below);
        all += __popc(v);
      }
    }
    *total = all;
    return under;
  }
  const int x = __popc(mask);
  int v = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += y;
  }
  *total = __shfl_sync(kFull, v, 31);
  return v - x;
}

template <bool PAIRS>
__device__ __forceinline__ void compact_scenario(
    const float* __restrict__ p, const float* __restrict__ q, const float* __restrict__ hs,
    const uint8_t* __restrict__ gen, const float* __restrict__ pp_pos,
    const float* __restrict__ pp_nrm, const float* __restrict__ pp_dep,
    const uint8_t* __restrict__ pp_act, const int64_t* __restrict__ pair_i,
    const int64_t* __restrict__ pair_j, int64_t* __restrict__ out_b0,
    int64_t* __restrict__ out_b1, float* __restrict__ out_pos, float* __restrict__ out_nrm,
    float* __restrict__ out_dep, uint8_t* __restrict__ out_act, int64_t s, int n, int P,
    int64_t pair_stride, int K, float eps2, float cap, int* stage) {
  const int lane = threadIdx.x % 32;
  int* sb0 = stage;
  int* sb1 = stage + K;
  float* spos = reinterpret_cast<float*>(stage + 2 * K);
  float* snrm = spos + 3 * K;
  float* sdep = snrm + 3 * K;
  unsigned* drop = reinterpret_cast<unsigned*>(sdep + K);
  if (PAIRS)
    for (int i = lane; i < (K + 31) / 32; i += 32) drop[i] = 0u;

  // round 1: the first round's flag words, issued before the bodies' loads
  const int W = PAIRS ? 3 * P : 0;  // flag words of the scenario
  const int wpl = W > 32 * kWordsPerLane ? kWordsPerLane : (W + 31) / 32;
  const uint32_t* words = PAIRS ? reinterpret_cast<const uint32_t*>(pp_act) + s * W : nullptr;
  uint32_t fw[kWordsPerLane];
#pragma unroll
  for (int j = 0; j < kWordsPerLane; ++j) {
    const int idx = lane * wpl + j;
    fw[j] = (PAIRS && j < wpl && idx < W) ? words[idx] : 0u;
  }

  // ground corners: a lane takes g consecutive corners of one body (g = 1,
  // 2, 4 or 8, the fewest that put 4g bodies' corners on the 32 lanes of a
  // round) and reads the body's p, q, half extents and ground flag: the
  // lanes of one body read the same words, one request a body
  const int G = kGround * n;
  const int g = n <= 4 ? 1 : n <= 8 ? 2 : n <= 16 ? 4 : 8;
  int filled = 0;  // active candidates seen so far, the same in every lane
  for (int c0 = 0; c0 < G; c0 += 32 * g) {
    const int c = c0 + lane * g;  // this lane's first corner
    const int i = c / kGround;
    float px = 0.f, py = 0.f, pz = 0.f, hx = 0.f, hy = 0.f, hz = 0.f;
    float R0 = 0.f, R1 = 0.f, R2 = 0.f, R3 = 0.f, R4 = 0.f, R5 = 0.f, R6 = 0.f, R7 = 0.f,
          R8 = 0.f;
    unsigned mask = 0u;
    if (c < G) {  // then all g corners are (G is a multiple of 8)
      const float* pb = p + 3 * (s * n + i);
      const float* qb = q + 4 * (s * n + i);
      px = pb[0], py = pb[1], pz = pb[2];
      hx = hs[3 * i], hy = hs[3 * i + 1], hz = hs[3 * i + 2];
      const bool on = gen[i] != 0;
      const float qw = qb[0], qx = qb[1], qy = qb[2], qz = qb[3];
      const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
      const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
      const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
      R0 = 1.f - 2.f * (yy + zz), R1 = 2.f * (xy - wz), R2 = 2.f * (xz + wy);
      R3 = 2.f * (xy + wz), R4 = 1.f - 2.f * (xx + zz), R5 = 2.f * (yz - wx);
      R6 = 2.f * (xz - wy), R7 = 2.f * (yz + wx), R8 = 1.f - 2.f * (xx + yy);
#pragma unroll 1
      for (int j = 0; j < g; ++j) {
        const int corner = c % kGround + j;
        const float ox = (corner & 4 ? 1.f : -1.f) * hx;
        const float oy = (corner & 2 ? 1.f : -1.f) * hy;
        const float oz = (corner & 1 ? 1.f : -1.f) * hz;
        const float cz = pz + R6 * ox + R7 * oy + R8 * oz;
        if (cz < 0.f && on) mask |= 1u << j;
      }
    }
    int total;
    int slot = filled + warp_offset(mask, g, lane, &total);
    for (unsigned m = mask; m != 0u && slot < K; m &= m - 1u, ++slot) {
      const int corner = c % kGround + __ffs(m) - 1;
      const float ox = (corner & 4 ? 1.f : -1.f) * hx;
      const float oy = (corner & 2 ? 1.f : -1.f) * hy;
      const float oz = (corner & 1 ? 1.f : -1.f) * hz;
      const float cz = pz + R6 * ox + R7 * oy + R8 * oz;
      sb0[slot] = -1;
      sb1[slot] = i;
      spos[3 * slot] = px + R0 * ox + R1 * oy + R2 * oz;
      spos[3 * slot + 1] = py + R3 * ox + R4 * oy + R5 * oz;
      spos[3 * slot + 2] = cz;
      snrm[3 * slot] = 0.f;
      snrm[3 * slot + 1] = 0.f;
      snrm[3 * slot + 2] = 1.f;
      sdep[slot] = fminf(-cz, cap);
    }
    filled += total;
  }
  const int ng = filled < K ? filled : K;  // ground lanes: the first ng

  if (PAIRS) {
    // pair candidates: byte b of word j of a lane is its candidate 4j + b
    for (int w0 = 0; w0 < W; w0 += 32 * wpl) {
      if (w0 > 0) {
#pragma unroll
        for (int j = 0; j < kWordsPerLane; ++j) {
          const int idx = w0 + lane * wpl + j;
          fw[j] = (j < wpl && idx < W) ? words[idx] : 0u;
        }
      }
      // a word's nonzero bytes as 4 bits: __vcmpne4 makes each 0xff or 0,
      // and the product moves byte b's low bit to bit 28 + b
      unsigned mask = 0u;
#pragma unroll
      for (int j = 0; j < kWordsPerLane; ++j)
        mask |= (((__vcmpne4(fw[j], 0u) & 0x01010101u) * 0x10204080u) >> 28) << (4 * j);
      int total;
      int slot = filled + warp_offset(mask, 4 * wpl, lane, &total);
      // a landing pair candidate leaves its index (12 k + lane of pair k)
      // as -2 - index in b0, for round 2
      for (unsigned m = mask; m != 0u && slot < K; m &= m - 1u, ++slot) {
        const int bit = __ffs(m) - 1;
        sb0[slot] = -2 - (4 * (w0 + lane * wpl + (bit >> 2)) + (bit & 3));
      }
      filled += total;
    }
  }
  const int nf = filled < K ? filled : K;
  __syncwarp();

  if (PAIRS) {
    // round 2: the landing pair candidates' geometry, a slot a lane
    for (int k = lane; k < nf; k += 32) {
      const int code = sb0[k];
      if (code > -2) continue;  // a ground corner, staged in round 1
      const int c = -2 - code;
      const int pk = c / kPairLanes;
      const int64_t e = s * P * kPairLanes + c;
      const int64_t ep = s * P + pk;
      const float x = pp_pos[3 * e], y = pp_pos[3 * e + 1], z = pp_pos[3 * e + 2];
      const float nx = pp_nrm[3 * ep], ny = pp_nrm[3 * ep + 1], nz = pp_nrm[3 * ep + 2];
      const float d = pp_dep[e];
      const int64_t bi = pair_i[s * pair_stride + pk], bj = pair_j[s * pair_stride + pk];
      sb0[k] = (int)bi;
      sb1[k] = (int)bj;
      spos[3 * k] = x;
      spos[3 * k + 1] = y;
      spos[3 * k + 2] = z;
      snrm[3 * k] = nx;
      snrm[3 * k + 1] = ny;
      snrm[3 * k + 2] = nz;
      sdep[k] = fminf(d, cap);
    }
    __syncwarp();

    // dedupe among the pair lanes ng .. nf-1 (a ground lane neither drops
    // nor is dropped): test t = k (k - 1) / 2 + j, j < k, of those lanes
    // counted from ng, is taken by lane t % 32
    const int np = nf - ng, tests = np * (np - 1) / 2;
    int k = (int)((1.f + sqrtf(8.f * (float)lane + 1.f)) * 0.5f), j;
    while (k * (k - 1) / 2 > lane) --k;
    while ((k + 1) * k / 2 <= lane) ++k;
    j = lane - k * (k - 1) / 2;
    for (int t = lane; t < tests; t += 32) {
      const int a = ng + k, b = ng + j;
      const int c0 = sb0[a], c1 = sb1[a], e0 = sb0[b], e1 = sb1[b];
      const int lo = min(c0, c1), hi = max(c0, c1);
      if (lo >= 0 && min(e0, e1) == lo && max(e0, e1) == hi) {
        const float dx = spos[3 * a] - spos[3 * b], dy = spos[3 * a + 1] - spos[3 * b + 1],
                    dz = spos[3 * a + 2] - spos[3 * b + 2];
        if (dx * dx + dy * dy + dz * dz < eps2) atomicOr(&drop[a >> 5], 1u << (a & 31));
      }
      j += 32;
      while (j >= k) j -= k++;
    }
    __syncwarp();
  }

  // stores: contiguous runs of the scenario's K lanes
  for (int i = lane; i < K; i += 32) {
    const int64_t o = s * K + i;
    const bool f = i < nf;
    out_b0[o] = f ? sb0[i] : -1;
    out_b1[o] = f ? sb1[i] : -1;
    out_dep[o] = f ? sdep[i] : 0.f;
    out_act[o] = f && !(PAIRS && ((drop[i >> 5] >> (i & 31)) & 1u));
  }
  for (int i = lane; i < 3 * K; i += 32) {
    const bool f = i < 3 * nf;
    out_pos[s * 3 * K + i] = f ? spos[i] : 0.f;
    out_nrm[s * 3 * K + i] = f ? snrm[i] : 0.f;
  }
}

__global__ void __launch_bounds__(32 * kMaxWarps) compact_kernel(
    const float* __restrict__ p, const float* __restrict__ q, const float* __restrict__ hs,
    const uint8_t* __restrict__ gen, const float* __restrict__ pp_pos,
    const float* __restrict__ pp_nrm, const float* __restrict__ pp_dep,
    const uint8_t* __restrict__ pp_act, const int64_t* __restrict__ pair_i,
    const int64_t* __restrict__ pair_j, int64_t* __restrict__ b0, int64_t* __restrict__ b1,
    float* __restrict__ pos, float* __restrict__ nrm, float* __restrict__ dep,
    uint8_t* __restrict__ act, int64_t B, int n, int P, int64_t pair_stride, int K, float eps2,
    float cap) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x / 32;
  const int64_t s = (int64_t)blockIdx.x * (blockDim.x / 32) + warp;
  if (s >= B) return;  // a whole warp leaves: the kernel syncs warps only
  compact_scenario<true>(p, q, hs, gen, pp_pos, pp_nrm, pp_dep, pp_act, pair_i, pair_j, b0, b1,
                         pos, nrm, dep, act, s, n, P, pair_stride, K, eps2, cap,
                         smem + warp * stage_words(K));
}

__global__ void __launch_bounds__(32 * kMaxWarps) compact_ground_kernel(
    const float* __restrict__ p, const float* __restrict__ q, const float* __restrict__ hs,
    const uint8_t* __restrict__ gen, int64_t* __restrict__ b0, int64_t* __restrict__ b1,
    float* __restrict__ pos, float* __restrict__ nrm, float* __restrict__ dep,
    uint8_t* __restrict__ act, int64_t B, int n, int K, float eps2, float cap) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x / 32;
  const int64_t s = (int64_t)blockIdx.x * (blockDim.x / 32) + warp;
  if (s >= B) return;
  compact_scenario<false>(p, q, hs, gen, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                          b0, b1, pos, nrm, dep, act, s, n, 0, 0, K, eps2, cap,
                          smem + warp * stage_words(K));
}

}  // namespace

// P = 0 launches the ground-only kernel; the pair pointers are then unused.
// The pair flags are read as 32-bit words: pp_act must be 4-byte aligned.
// pair_stride 0: pair_i / pair_j hold P pairs for every scenario; P: a list
// of P a scenario (the broadphase's selection), read at s * P + k.
// A block takes kMaxWarps scenarios, or as many as K's stage leaves room for.
extern "C" int eggshell_compact_f32(const float* p, const float* q, const float* hs,
                                    const uint8_t* gen, const float* pp_pos, const float* pp_nrm,
                                    const float* pp_dep, const uint8_t* pp_act,
                                    const int64_t* pair_i, const int64_t* pair_j, int64_t* b0,
                                    int64_t* b1, float* pos, float* nrm, float* dep,
                                    uint8_t* act, int64_t B, int n, int P, int64_t pair_stride,
                                    int K, float eps2, float cap, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  if (pair_stride != 0 && pair_stride != P) return (int)cudaErrorInvalidValue;
  if (P > 0 && reinterpret_cast<uintptr_t>(pp_act) % 4 != 0) return (int)cudaErrorInvalidValue;
  const size_t warp_bytes = (size_t)stage_words(K) * sizeof(int);
  int warps = kMaxWarps;
  while (warps > 1 && warps * warp_bytes > (size_t)kMaxShared) --warps;
  if (warp_bytes > (size_t)kMaxShared) return (int)cudaErrorInvalidValue;
  const size_t smem = warps * warp_bytes;
  const unsigned blocks = (unsigned)((B + warps - 1) / warps);
  cudaStream_t st = (cudaStream_t)stream;
  if (P > 0) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(compact_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    compact_kernel<<<blocks, 32 * warps, smem, st>>>(p, q, hs, gen, pp_pos, pp_nrm, pp_dep,
                                                     pp_act, pair_i, pair_j, b0, b1, pos, nrm,
                                                     dep, act, B, n, P, pair_stride, K, eps2,
                                                     cap);
  } else {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(compact_ground_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    compact_ground_kernel<<<blocks, 32 * warps, smem, st>>>(p, q, hs, gen, b0, b1, pos, nrm, dep,
                                                            act, B, n, K, eps2, cap);
  }
  return (int)cudaGetLastError();
}
