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
// the card's rate.  One thread per (scenario, lane); the body rows it
// gathers (p, uhat) are shared by the K lanes of a scenario and come from
// L1/L2.  The TPU kernel's (8, 128) scenario tiles and its one-hot body
// gathers are not carried over: the thread indexes the body directly.

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

__global__ void jassembly_kernel(const int64_t* __restrict__ b0, const int64_t* __restrict__ b1,
                                 const float* __restrict__ pos, const float* __restrict__ pos1,
                                 const float* __restrict__ nrm, const float* __restrict__ dep,
                                 const uint8_t* __restrict__ act, const uint8_t* __restrict__ eq,
                                 const float* __restrict__ p, const float* __restrict__ uhat,
                                 float* __restrict__ Jc, float* __restrict__ rhs, int64_t total,
                                 int K, int n, float erp_dt2) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;  // scenario * K + lane
  if (t >= total) return;
  const int64_t s = t / K;

  float R[9];
  align_to_z(nrm[3 * t], nrm[3 * t + 1], nrm[3 * t + 2], R);
  const bool a = act[t] != 0;
  const float act_f = a ? 1.f : 0.f;
  const float eq_f = (eq != nullptr && eq[t] != 0) ? 1.f : 0.f;
  const float sgn_flip = 1.f - 2.f * eq_f;
  const float px = pos[3 * t], py = pos[3 * t + 1], pz = pos[3 * t + 2];
  const float p1x = pos1[3 * t], p1y = pos1[3 * t + 1], p1z = pos1[3 * t + 2];

  float rr[3] = {
      -erp_dt2 * (eq_f * (px - p1x)) * act_f,
      -erp_dt2 * (eq_f * (py - p1y)) * act_f,
      -erp_dt2 * (eq_f * (pz - p1z) + (1.f - eq_f) * (-dep[t])) * act_f,
  };

  float* J = Jc + t * 36;
  for (int slot = 0; slot < 2; ++slot) {
    const int64_t bsel = slot == 0 ? b0[t] : b1[t];
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
    for (int r = 0; r < 3; ++r) {
      float lin[3], ang[3];
      for (int c = 0; c < 3; ++c) {
        lin[c] = s_eff * R[3 * r + c] * valid;
        const float av = R[3 * r] * C[c] + R[3 * r + 1] * C[3 + c] + R[3 * r + 2] * C[6 + c];
        ang[c] = -s_eff * av * valid;
      }
      float* row = J + 12 * r + 6 * slot;
      float dot = 0.f;
      for (int c = 0; c < 3; ++c) {
        row[c] = lin[c];
        row[3 + c] = ang[c];
        dot = dot + lin[c] * ub[c] + ang[c] * ub[3 + c];
      }
      rr[r] = rr[r] - dot;
    }
  }
  for (int r = 0; r < 3; ++r) rhs[3 * t + r] = rr[r];
}

}  // namespace

extern "C" int eggshell_jassembly_f32(const int64_t* b0, const int64_t* b1, const float* pos,
                                      const float* pos1, const float* nrm, const float* dep,
                                      const uint8_t* act, const uint8_t* eq, const float* p,
                                      const float* uhat, float* Jc, float* rhs, int64_t B, int K,
                                      int n, float erp_dt2, void* stream) {
  const int64_t total = B * K;
  if (total <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  jassembly_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      b0, b1, pos, pos1, nrm, dep, act, eq, p, uhat, Jc, rhs, total, K, n, erp_dt2);
  return (int)cudaGetLastError();
}
