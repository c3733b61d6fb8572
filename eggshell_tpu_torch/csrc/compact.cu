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
//               b1 = pair_j[k];
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
// in a lane; a few flops a candidate.  The TPU kernel's (8, 128) scenario
// tiles and its K-vectorised one-hot accumulators are not carried over.  The
// design: one warp per scenario.  Its 32 lanes take 32 candidates at a time;
// `__ballot_sync` of the activity flags and `__popc` of the lower lanes give
// each active candidate its stable slot, and only those that land below K
// read their geometry.  The loop stops once K lanes are filled.  The lanes
// are staged in shared memory (36 bytes each), lane k < K then runs the
// dedupe test against lanes j < k there and writes the `ContactSet` fields
// (b0/b1 int64, position/normal (K, 3), depth, active) scenario-major, as
// csrc/jassembly.cu takes them.  `compact_ground_kernel` is the same body
// without pairs (P = 0), the counterpart of `_compact_kernel_ground`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;        // scenarios per block
constexpr int GROUND = 8;       // corners per body
constexpr int LANES = 12;       // narrowphase lanes per pair
constexpr int LANE_WORDS = 9;   // b0, b1, pos[3], nrm[3], depth

template <bool PAIRS>
__device__ __forceinline__ void compact_scenario(
    const float* __restrict__ p, const float* __restrict__ q, const float* __restrict__ hs,
    const uint8_t* __restrict__ gen, const float* __restrict__ pp_pos,
    const float* __restrict__ pp_nrm, const float* __restrict__ pp_dep,
    const uint8_t* __restrict__ pp_act, const int64_t* __restrict__ pair_i,
    const int64_t* __restrict__ pair_j, int64_t* __restrict__ out_b0,
    int64_t* __restrict__ out_b1, float* __restrict__ out_pos, float* __restrict__ out_nrm,
    float* __restrict__ out_dep, uint8_t* __restrict__ out_act, int64_t s, int n, int P, int K,
    float eps2, float cap, int* lanes) {
  const int lane = threadIdx.x % 32;
  int* sb0 = lanes;
  int* sb1 = lanes + K;
  float* spos = reinterpret_cast<float*>(lanes + 2 * K);
  float* snrm = spos + 3 * K;
  float* sdep = snrm + 3 * K;

  const int G = GROUND * n;
  const int C = G + (PAIRS ? LANES * P : 0);
  int filled = 0;  // active candidates seen so far, the same in every lane
  for (int base = 0; base < C && filled < K; base += 32) {
    const int c = base + lane;
    bool a = false;
    float cx = 0.f, cy = 0.f, cz = 0.f;
    int i = 0, k = 0;
    int64_t e = 0;
    if (c < G) {
      i = c / GROUND;
      const int corner = c % GROUND;
      const float* pb = p + 3 * (s * n + i);
      const float* qb = q + 4 * (s * n + i);
      const float qw = qb[0], qx = qb[1], qy = qb[2], qz = qb[3];
      const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
      const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
      const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
      const float R0 = 1.f - 2.f * (yy + zz), R1 = 2.f * (xy - wz), R2 = 2.f * (xz + wy);
      const float R3 = 2.f * (xy + wz), R4 = 1.f - 2.f * (xx + zz), R5 = 2.f * (yz - wx);
      const float R6 = 2.f * (xz - wy), R7 = 2.f * (yz + wx), R8 = 1.f - 2.f * (xx + yy);
      const float ox = (corner & 4 ? 1.f : -1.f) * hs[3 * i];
      const float oy = (corner & 2 ? 1.f : -1.f) * hs[3 * i + 1];
      const float oz = (corner & 1 ? 1.f : -1.f) * hs[3 * i + 2];
      cx = pb[0] + R0 * ox + R1 * oy + R2 * oz;
      cy = pb[1] + R3 * ox + R4 * oy + R5 * oz;
      cz = pb[2] + R6 * ox + R7 * oy + R8 * oz;
      a = cz < 0.f && gen[i] != 0;
    } else if (PAIRS && c < C) {
      k = (c - G) / LANES;
      e = (s * P + k) * LANES + (c - G) % LANES;
      a = pp_act[e] != 0;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, a);
    const int slot = filled + __popc(mask & ((1u << lane) - 1u));
    if (a && slot < K) {
      if (c < G) {
        sb0[slot] = -1;
        sb1[slot] = i;
        spos[3 * slot] = cx;
        spos[3 * slot + 1] = cy;
        spos[3 * slot + 2] = cz;
        snrm[3 * slot] = 0.f;
        snrm[3 * slot + 1] = 0.f;
        snrm[3 * slot + 2] = 1.f;
        sdep[slot] = fminf(-cz, cap);
      } else if (PAIRS) {
        const int64_t pk = s * P + k;
        sb0[slot] = (int)pair_i[k];
        sb1[slot] = (int)pair_j[k];
        spos[3 * slot] = pp_pos[3 * e];
        spos[3 * slot + 1] = pp_pos[3 * e + 1];
        spos[3 * slot + 2] = pp_pos[3 * e + 2];
        snrm[3 * slot] = pp_nrm[3 * pk];
        snrm[3 * slot + 1] = pp_nrm[3 * pk + 1];
        snrm[3 * slot + 2] = pp_nrm[3 * pk + 2];
        sdep[slot] = fminf(pp_dep[e], cap);
      }
    }
    filled += __popc(mask);
  }
  __syncwarp();

  const int nf = filled < K ? filled : K;
  for (int k = lane; k < K; k += 32) {
    const int64_t o = s * K + k;
    if (k < nf) {
      const int b0 = sb0[k], b1 = sb1[k];
      const int lo = min(b0, b1), hi = max(b0, b1);
      bool drop = false;
      if (lo >= 0) {
        const float x = spos[3 * k], y = spos[3 * k + 1], z = spos[3 * k + 2];
        for (int j = 0; j < k && !drop; ++j) {
          const int c0 = sb0[j], c1 = sb1[j];
          if (min(c0, c1) != lo || max(c0, c1) != hi) continue;
          const float dx = x - spos[3 * j], dy = y - spos[3 * j + 1], dz = z - spos[3 * j + 2];
          drop = dx * dx + dy * dy + dz * dz < eps2;
        }
      }
      out_b0[o] = b0;
      out_b1[o] = b1;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        out_pos[3 * o + d] = spos[3 * k + d];
        out_nrm[3 * o + d] = snrm[3 * k + d];
      }
      out_dep[o] = sdep[k];
      out_act[o] = drop ? 0 : 1;
    } else {
      out_b0[o] = -1;
      out_b1[o] = -1;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        out_pos[3 * o + d] = 0.f;
        out_nrm[3 * o + d] = 0.f;
      }
      out_dep[o] = 0.f;
      out_act[o] = 0;
    }
  }
}

__global__ void __launch_bounds__(32 * WARPS) compact_kernel(
    const float* __restrict__ p, const float* __restrict__ q, const float* __restrict__ hs,
    const uint8_t* __restrict__ gen, const float* __restrict__ pp_pos,
    const float* __restrict__ pp_nrm, const float* __restrict__ pp_dep,
    const uint8_t* __restrict__ pp_act, const int64_t* __restrict__ pair_i,
    const int64_t* __restrict__ pair_j, int64_t* __restrict__ b0, int64_t* __restrict__ b1,
    float* __restrict__ pos, float* __restrict__ nrm, float* __restrict__ dep,
    uint8_t* __restrict__ act, int64_t B, int n, int P, int K, float eps2, float cap) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x / 32;
  const int64_t s = (int64_t)blockIdx.x * WARPS + warp;
  if (s >= B) return;  // a whole warp leaves: the kernel syncs warps only
  compact_scenario<true>(p, q, hs, gen, pp_pos, pp_nrm, pp_dep, pp_act, pair_i, pair_j, b0, b1,
                         pos, nrm, dep, act, s, n, P, K, eps2, cap,
                         smem + warp * LANE_WORDS * K);
}

__global__ void __launch_bounds__(32 * WARPS) compact_ground_kernel(
    const float* __restrict__ p, const float* __restrict__ q, const float* __restrict__ hs,
    const uint8_t* __restrict__ gen, int64_t* __restrict__ b0, int64_t* __restrict__ b1,
    float* __restrict__ pos, float* __restrict__ nrm, float* __restrict__ dep,
    uint8_t* __restrict__ act, int64_t B, int n, int K, float eps2, float cap) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x / 32;
  const int64_t s = (int64_t)blockIdx.x * WARPS + warp;
  if (s >= B) return;
  compact_scenario<false>(p, q, hs, gen, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                          b0, b1, pos, nrm, dep, act, s, n, 0, K, eps2, cap,
                          smem + warp * LANE_WORDS * K);
}

}  // namespace

// P = 0 launches the ground-only kernel; the pair pointers are then unused.
extern "C" int eggshell_compact_f32(const float* p, const float* q, const float* hs,
                                    const uint8_t* gen, const float* pp_pos, const float* pp_nrm,
                                    const float* pp_dep, const uint8_t* pp_act,
                                    const int64_t* pair_i, const int64_t* pair_j, int64_t* b0,
                                    int64_t* b1, float* pos, float* nrm, float* dep,
                                    uint8_t* act, int64_t B, int n, int P, int K, float eps2,
                                    float cap, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  const size_t smem = (size_t)WARPS * LANE_WORDS * K * sizeof(int);
  const unsigned blocks = (unsigned)((B + WARPS - 1) / WARPS);
  cudaStream_t st = (cudaStream_t)stream;
  if (P > 0) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(compact_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    compact_kernel<<<blocks, 32 * WARPS, smem, st>>>(p, q, hs, gen, pp_pos, pp_nrm, pp_dep,
                                                     pp_act, pair_i, pair_j, b0, b1, pos, nrm,
                                                     dep, act, B, n, P, K, eps2, cap);
  } else {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(compact_ground_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    compact_ground_kernel<<<blocks, 32 * WARPS, smem, st>>>(p, q, hs, gen, b0, b1, pos, nrm, dep,
                                                            act, B, n, K, eps2, cap);
  }
  return (int)cudaGetLastError();
}
