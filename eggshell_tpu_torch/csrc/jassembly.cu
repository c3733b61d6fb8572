// Compact contact Jacobian blocks and the LCP right-hand side, float32.
//
// Replaces the TPU kernel `_jassembly_kernel` of
// eggshell_tpu/ops/jassembly_kernel.py (reached through
// `contact_jacobian_blocks` and `contact_jacobian_blocks_from_packed`).
// Per lane k of every scenario, with Rcf = AlignVectors(n, z):
//   slot 0 (body b0): [-Rcf | +Rcf [pos  - p_b0]x]
//   slot 1 (body b1): [+Rcf | -Rcf [pos1 - p_b1]x]
// rows 3k..3k+2 of Jc (B, 3K, 12), and
//   rhs = -erp/dt^2 err - sum over slots of Jc_slot . uhat_body
// with err = (0, 0, -depth) for a contact.  Equality (ball-joint) lanes flip
// both slot signs and take err = pos - pos1.  A slot whose body is -1 (the
// ground) or whose lane is inactive is zero.  The frame is the TPU kernel's
// branchless FromTwoVectors(n, z), antiparallel fallback included: when
// 1 + n_z < 1e-8 it turns 180 degrees about n x e, e the axis of least
// |component| with ties to the lower index.  Stacked boxes have n = -z on
// half their contacts, so that tie rule sets their frames.  Every
// expression keeps the TPU kernel's order; built with --fmad=false it
// rounds as the plain torch version does.
//
// What bounds it on an H100: bytes.  A lane reads about 20 floats of contact
// and 18 of body state and writes 39 floats; its ~400 flops are far below
// the card's rate.  The first design (one thread a lane) took 0.072 ms at
// K = 20 against a 0.0051 ms bound (`chip_smoke.py`, H100 SXM at 700 W):
// 81,920 threads, about 620 an SM, each writing its 36 floats of Jc at a
// 144-byte stride (32 sectors a warp store, 36 times over) and reading its
// inputs at a 12-byte stride.  The design:
// - A block takes a tile of 128 consecutive lanes (scenario-major, across
//   scenario boundaries), whose Jc rows are contiguous (144 bytes a lane).
//   It first copies the tile's per-lane inputs (pos, pos1, nrm, dep, the
//   int64 bodies and the flags) into shared memory, each array one
//   contiguous span read by neighbouring threads at neighbouring
//   addresses.
// - One thread a (lane, row r): 384 threads a tile, three times the first
//   design's.  Each computes the frame (align_to_z, as before) and its row
//   of both slot blocks in the kernel's order: rr[r], minus slot 0's dot,
//   then minus slot 1's.  It writes its row's 12 floats into a shared
//   tile laid out as Jc (three float4s; the 8 threads of a quarter warp
//   hit 8 different 16-byte bank groups) and its rhs entry straight to
//   device memory (neighbouring threads, neighbouring entries).
// - The tile's Jc (18 KB) then goes out as float4 stores by the whole
//   block, each warp store 512 contiguous bytes: every HBM write is a
//   whole line.
// The body rows a thread gathers (p, uhat) are shared by the K lanes of a
// scenario and come from L1/L2.  The TPU kernel's (8, 128) scenario tiles
// and its one-hot body gathers are not carried over: the thread indexes
// the body directly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void align_to_z(float nx, float ny, float nz, float* R) {
  const float w = 1.f + nz;
  float qx = ny, qy = -nx, qz = 0.f * nx;
  const float ax = fabsf(nx), ay = fabsf(ny), az = fabsf(nz);
  const bool lx = (ax <= ay) && (ax <= az);
  const bool ly = !lx && (ay <= az);
  const bool lz = !lx && !ly;
  const float ex = lx ? 1.f : 0.f, ey = ly ? 1.f : 0.f, ez = lz ? 1.f : 0.f;
  const float ox = ny * ez - nz * ey;
  const float oy = nz * ex - nx * ez;
  const float oz = nx * ey - ny * ex;
  const float onorm = sqrtf(ox * ox + oy * oy + oz * oz);
  const float safe = fmaxf(onorm, 1e-30f);
  const bool anti = w < 1e-8f;
  float qw = anti ? 0.f : w;
  if (anti) {
    qx = ox / safe;
    qy = oy / safe;
    qz = oz / safe;
  }
  float qn = sqrtf(qw * qw + qx * qx + qy * qy + qz * qz);
  qn = fmaxf(qn, 1e-30f);
  qw = qw / qn;
  qx = qx / qn;
  qy = qy / qn;
  qz = qz / qn;
  const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
  const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
  const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
  R[0] = 1.f - 2.f * (yy + zz); R[1] = 2.f * (xy - wz);       R[2] = 2.f * (xz + wy);
  R[3] = 2.f * (xy + wz);       R[4] = 1.f - 2.f * (xx + zz); R[5] = 2.f * (yz - wx);
  R[6] = 2.f * (xz - wy);       R[7] = 2.f * (yz + wx);       R[8] = 1.f - 2.f * (xx + yy);
}

constexpr int kLanes = 128;            // lanes a block
constexpr int kThreads = 3 * kLanes;   // one thread a (lane, row)

__global__ void __launch_bounds__(kThreads)
    jassembly_kernel(const int64_t* __restrict__ b0, const int64_t* __restrict__ b1,
                     const float* __restrict__ pos, const float* __restrict__ pos1,
                     const float* __restrict__ nrm, const float* __restrict__ dep,
                     const uint8_t* __restrict__ act, const uint8_t* __restrict__ eq,
                     const float* __restrict__ p, const float* __restrict__ uhat,
                     float* __restrict__ Jc, float* __restrict__ rhs, int64_t total, int K, int n,
                     float erp_dt2) {
  __shared__ __align__(16) float sJ[kLanes * 36];
  __shared__ float spos[kLanes * 3], spos1[kLanes * 3], snrm[kLanes * 3], sdep[kLanes];
  __shared__ int sb[2 * kLanes];
  __shared__ uint8_t sflag[2 * kLanes];  // act, eq
  const int64_t t0 = (int64_t)blockIdx.x * kLanes;
  const int nl = (int)(total - t0 < kLanes ? total - t0 : kLanes);
  const int tid = threadIdx.x;

  for (int e = tid; e < 3 * nl; e += kThreads) {
    spos[e] = pos[3 * t0 + e];
    spos1[e] = pos1[3 * t0 + e];
    snrm[e] = nrm[3 * t0 + e];
  }
  for (int e = tid; e < nl; e += kThreads) {
    sdep[e] = dep[t0 + e];
    sb[e] = (int)b0[t0 + e];
    sb[kLanes + e] = (int)b1[t0 + e];
    sflag[e] = act[t0 + e];
    sflag[kLanes + e] = eq != nullptr ? eq[t0 + e] : 0;
  }
  __syncthreads();

  const int lane = tid / 3, r = tid - 3 * lane;
  if (lane < nl) {
    const int64_t t = t0 + lane;
    const int64_t s = t / K;
    float R[9];
    align_to_z(snrm[3 * lane], snrm[3 * lane + 1], snrm[3 * lane + 2], R);
    const float R0 = r == 0 ? R[0] : r == 1 ? R[3] : R[6];
    const float R1 = r == 0 ? R[1] : r == 1 ? R[4] : R[7];
    const float R2 = r == 0 ? R[2] : r == 1 ? R[5] : R[8];
    const bool a = sflag[lane] != 0;
    const float act_f = a ? 1.f : 0.f;
    const float eq_f = sflag[kLanes + lane] != 0 ? 1.f : 0.f;
    const float sgn_flip = 1.f - 2.f * eq_f;
    const float px = spos[3 * lane], py = spos[3 * lane + 1], pz = spos[3 * lane + 2];
    const float p1x = spos1[3 * lane], p1y = spos1[3 * lane + 1], p1z = spos1[3 * lane + 2];

    float rr;
    if (r == 0) rr = -erp_dt2 * (eq_f * (px - p1x)) * act_f;
    else if (r == 1) rr = -erp_dt2 * (eq_f * (py - p1y)) * act_f;
    else rr = -erp_dt2 * (eq_f * (pz - p1z) + (1.f - eq_f) * (-sdep[lane])) * act_f;

    float row[12];
#pragma unroll
    for (int slot = 0; slot < 2; ++slot) {
      const int bsel = sb[slot * kLanes + lane];
      const float sgn = slot == 0 ? -1.f : 1.f;
      const float valid = (bsel >= 0 && a) ? 1.f : 0.f;
      const int64_t body = s * n + (bsel > 0 ? bsel : 0);
      const float* pb = p + 3 * body;
      const float* ub = uhat + 6 * body;
      const float cx = (slot == 0 ? px : p1x) - pb[0];
      const float cy = (slot == 0 ? py : p1y) - pb[1];
      const float cz = (slot == 0 ? pz : p1z) - pb[2];
      const float C[9] = {0.f * cx, -cz, cy, cz, 0.f * cx, -cx, -cy, cx, 0.f * cx};
      const float s_eff = sgn * sgn_flip;
      const float Rr[3] = {R0, R1, R2};
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float lin = s_eff * Rr[c] * valid;
        const float av = R0 * C[c] + R1 * C[3 + c] + R2 * C[6 + c];
        const float ang = -s_eff * av * valid;
        row[6 * slot + c] = lin;
        row[6 * slot + 3 + c] = ang;
        dot = dot + lin * ub[c] + ang * ub[3 + c];
      }
      rr = rr - dot;
    }
    float4* dst = reinterpret_cast<float4*>(sJ + 12 * tid);
    dst[0] = make_float4(row[0], row[1], row[2], row[3]);
    dst[1] = make_float4(row[4], row[5], row[6], row[7]);
    dst[2] = make_float4(row[8], row[9], row[10], row[11]);
    rhs[3 * t0 + tid] = rr;
  }
  __syncthreads();
  const float4* src = reinterpret_cast<const float4*>(sJ);
  float4* out = reinterpret_cast<float4*>(Jc + 36 * t0);
  for (int e = tid; e < 9 * nl; e += kThreads) out[e] = src[e];
}

}  // namespace

extern "C" int eggshell_jassembly_f32(const int64_t* b0, const int64_t* b1, const float* pos,
                                      const float* pos1, const float* nrm, const float* dep,
                                      const uint8_t* act, const uint8_t* eq, const float* p,
                                      const float* uhat, float* Jc, float* rhs, int64_t B, int K,
                                      int n, float erp_dt2, void* stream) {
  const int64_t total = B * K;
  if (total <= 0) return 0;
  const unsigned blocks = (unsigned)((total + kLanes - 1) / kLanes);
  jassembly_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      b0, b1, pos, pos1, nrm, dep, act, eq, p, uhat, Jc, rhs, total, K, n, erp_dt2);
  return (int)cudaGetLastError();
}
