// SAT box-box narrowphase for a batch of box pairs, float32.
//
// Replaces the TPU kernel `_narrowphase_kernel` of
// eggshell_tpu/ops/collision_kernel.py, through both of its entries:
// `collide_boxes_lanes` / `collide_boxes_lanes_diff` (kernel
// `narrowphase_kernel`, gathered pairs in, every output of the pair) and
// `collide_boxes_lanes_packed` (kernel `narrowphase_packed_kernel`, the
// fused chain's entry: (B, n) body state and the scene's pair lists in, the
// bodies gathered and R formed from q in the kernel, and only what the
// compaction kernel csrc/compact.cu reads written out).  Both run the one
// SAT device function `sat_contacts`.  Same semantics as
// the plain version `eggshell_tpu_torch.ops.collision.collide_boxes`:
// 15 separating axes, contact codes 1-16, the incident face clipped by the
// six halfspaces of the reference box into at most MAX_POLY points, the
// edge-edge contact and the deep-penetration fallback (code 16).
//
// What bounds it on an H100: arithmetic and registers, not bytes.  A pair
// reads 30 floats and writes 66 floats plus 12 flags, against a few
// thousand floating-point operations (the clip alone is six passes over a
// 12-vertex polygon with a 12x12 one-hot emission).  The design: one
// thread per pair (per scenario and pair on the packed entry), every
// intermediate in registers, every loop statically
// unrolled so that the polygon arrays stay in registers (no dynamic
// indexing, no local memory), and the same branchless selection logic as
// the TPU kernel.  Outputs are written pair-major in the `PairContacts`
// layout (pos (N,12,3), normal (N,3), depth (N,12), active (N,12), code,
// info_depth, separating axis), so no relayout follows the launch; the
// packed entry writes pos (B,P,12,3), normal (B,P,3), depth and active
// (B,P,12), and its gathers of p and q (28 bytes a body, the n bodies of a
// scenario read by its P threads) come from L1 after the first.  Those
// stores are strided across a warp; coalescing them through shared memory
// is work for a later change.
//
// The library is built with --fmad=false: every product and sum is rounded
// on its own, as in the plain version's elementwise torch ops.  Exactly
// tied axes (aligned boxes) are still decided by rounding, so kernel and
// plain version may pick different, equally valid, axes there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_POLY = 12;
constexpr float ALIGN_TOL = 0.9962f;
constexpr float TOL = 1e-9f;
constexpr float BIG = 1e30f;

__device__ __forceinline__ float sgn(float x) { return x >= 0.f ? 1.f : -1.f; }

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// The contacts of one box pair: pos (12, 3), depth and active (12) on the
// clipped polygon's lanes, the contact normal, the contact code (0 =
// separated), the depth along the best axis and that axis.
__device__ __forceinline__ void sat_contacts(
    const float p1[3], const float R1[3][3], const float H1[3], const float p2[3],
    const float R2[3][3], const float H2[3], float pos[MAX_POLY][3], float dep[MAX_POLY],
    bool act[MAX_POLY], float nrm[3], int* code, float* idep, float iax[3]) {
  // box2 in box1's frame: R = R1^T R2, p = R1^T (p2 - p1)
  float R[3][3], Q[3][3], d[3], p[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      R[i][j] = R1[0][i] * R2[0][j] + R1[1][i] * R2[1][j] + R1[2][i] * R2[2][j];
      Q[i][j] = fabsf(R[i][j]);
    }
#pragma unroll
  for (int c = 0; c < 3; ++c) d[c] = p2[c] - p1[c];
#pragma unroll
  for (int i = 0; i < 3; ++i) p[i] = R1[0][i] * d[0] + R1[1][i] * d[1] + R1[2][i] * d[2];

  int aacount = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    aacount += fmaxf(fmaxf(Q[0][i], Q[1][i]), Q[2][i]) > ALIGN_TOL ? 1 : 0;

  // ---- 6 face-normal axes (ties keep the first index) ----
  float sepFN = -BIG;
  int codeFN = 0;
  float axFN[3] = {0.f, 0.f, 0.f};
  bool any_sep_face = false;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float e1, r, nrm[3];
    if (i < 3) {
      e1 = p[i];
      r = H1[i] + (H2[0] * Q[i][0] + H2[1] * Q[i][1] + H2[2] * Q[i][2]);
#pragma unroll
      for (int c = 0; c < 3; ++c) nrm[c] = R1[c][i];
    } else {
      const int k = i - 3;
      e1 = R[0][k] * p[0] + R[1][k] * p[1] + R[2][k] * p[2];
      r = (H1[0] * Q[0][k] + H1[1] * Q[1][k] + H1[2] * Q[2][k]) + H2[k];
#pragma unroll
      for (int c = 0; c < 3; ++c) nrm[c] = R2[c][k];
    }
    const float sep = fabsf(e1) - r;
    any_sep_face = any_sep_face || (sep > 0.f);
    if (sep > sepFN) {
      sepFN = sep;
      codeFN = i + 1;
      const float s = sgn(e1);
#pragma unroll
      for (int c = 0; c < 3; ++c) axFN[c] = s * nrm[c];
    }
  }

  // ---- 9 edge x edge axes, code 7 + 3a + b ----
  float sepEE = -BIG, e1EE = 0.f, lenEE = 1.f;
  int codeEE = 0;
  float nEE[3] = {0.f, 0.f, 0.f};
  bool any_sep_ee = false;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const float v0 = R[0][b], v1 = R[1][b], v2 = R[2][b];
      float nv[3];
      if (a == 0) { nv[0] = 0.f; nv[1] = -v2; nv[2] = v1; }
      else if (a == 1) { nv[0] = v2; nv[1] = 0.f; nv[2] = -v0; }
      else { nv[0] = -v1; nv[1] = v0; nv[2] = 0.f; }
      const float length = sqrtf(dot3(nv, nv));
      const bool valid = length > TOL;
      const float e1 = dot3(nv, p);
      const float span1 = H1[0] * fabsf(nv[0]) + H1[1] * fabsf(nv[1]) + H1[2] * fabsf(nv[2]);
      const float span2 = H2[(b + 1) % 3] * Q[a][(b + 2) % 3] + H2[(b + 2) % 3] * Q[a][(b + 1) % 3];
      const float sep_raw = fabsf(e1) - (span1 + span2);
      any_sep_ee = any_sep_ee || (valid && sep_raw > 0.f);
      const float safe_len = valid ? length : 1.f;
      const float sep = valid ? sep_raw / safe_len : -BIG;
      if (sep > sepEE) {
        sepEE = sep;
        codeEE = 7 + 3 * a + b;
#pragma unroll
        for (int c = 0; c < 3; ++c) nEE[c] = nv[c];
        e1EE = e1;
        lenEE = safe_len;
      }
    }

  const bool separated = any_sep_face || any_sep_ee;

  float axEE[3];
  {
    const float scl = 1.f / (sgn(e1EE) * lenEE);
    float nloc[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) nloc[c] = nEE[c] * scl;
#pragma unroll
    for (int c = 0; c < 3; ++c) axEE[c] = R1[c][0] * nloc[0] + R1[c][1] * nloc[1] + R1[c][2] * nloc[2];
  }

  const bool best_is_FN = sepFN > sepEE;
  const float info_depth = best_is_FN ? -sepFN : -sepEE;

  // ---- edge-edge contact ----
  float ee_pos[3];
  {
    float sa1[3], sa2[3], pa[3], pb[3], ua[3], ub[3], pv[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      sa1[j] = axEE[0] * R1[0][j] + axEE[1] * R1[1][j] + axEE[2] * R1[2][j];
      sa2[j] = axEE[0] * R2[0][j] + axEE[1] * R2[1][j] + axEE[2] * R2[2][j];
    }
    const int a_idx = (codeEE - 7) / 3, b_idx = (codeEE - 7) % 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      pa[c] = p1[c] + (sgn(sa1[0]) * H1[0] * R1[c][0] + sgn(sa1[1]) * H1[1] * R1[c][1] +
                       sgn(sa1[2]) * H1[2] * R1[c][2]);
      pb[c] = p2[c] - (sgn(sa2[0]) * H2[0] * R2[c][0] + sgn(sa2[1]) * H2[1] * R2[c][1] +
                       sgn(sa2[2]) * H2[2] * R2[c][2]);
      ua[c] = a_idx == 0 ? R1[c][0] : a_idx == 1 ? R1[c][1] : a_idx == 2 ? R1[c][2] : 0.f;
      ub[c] = b_idx == 0 ? R2[c][0] : b_idx == 1 ? R2[c][1] : b_idx == 2 ? R2[c][2] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) pv[c] = pb[c] - pa[c];
    const float uaub = dot3(ua, ub);
    const float q1 = dot3(ua, pv);
    const float q2 = -dot3(ub, pv);
    const float dd = 1.f - uaub * uaub;
    const bool degen = dd == 0.f;
    const float alpha = degen ? 0.f : (q1 + uaub * q2) / dd;
    const float beta = degen ? 0.f : (uaub * q1 + q2) / dd;
#pragma unroll
    for (int c = 0; c < 3; ++c) ee_pos[c] = (pa[c] + ua[c] * alpha + pb[c] + ub[c] * beta) * 0.5f;
  }
  const float ee_depth = -sepEE;

  // ---- face-something contact: A = reference box, B = incident box ----
  const bool A1 = codeFN <= 3;
  float Ac[3], Ah[3], Bc0[3], Bh0[3], Afn[3], AR[3][3], BR0[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    Ac[c] = A1 ? p1[c] : p2[c];
    Ah[c] = A1 ? H1[c] : H2[c];
    Bc0[c] = A1 ? p2[c] : p1[c];
    Bh0[c] = A1 ? H2[c] : H1[c];
    Afn[c] = axFN[c] * (A1 ? 1.f : -1.f);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      AR[c][j] = A1 ? R1[c][j] : R2[c][j];
      BR0[c][j] = A1 ? R2[c][j] : R1[c][j];
    }
  }
  float nf[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) nf[i] = BR0[0][i] * Afn[0] + BR0[1][i] * Afn[1] + BR0[2][i] * Afn[2];
  const float anf0 = fabsf(nf[0]), anf1 = fabsf(nf[1]), anf2 = fabsf(nf[2]);
  const int nf_idx = anf2 > fmaxf(anf0, anf1) ? 2 : (anf1 > anf0 ? 1 : 0);
  const int perm1 = (nf_idx + 1) % 3, perm2 = (nf_idx + 2) % 3;
  const float nf_val = nf[0] * (nf_idx == 0) + nf[1] * (nf_idx == 1) + nf[2] * (nf_idx == 2);
  float Rc[3], RR0[3], RR1[3], RR2[3];
  float Bh_sel = 0.f, Rh0 = 0.f, Rh1 = 0.f, Ah_face = 0.f;
  const int face_axis = (codeFN - 1) % 3;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (nf_idx == i) Bh_sel = Bh0[i];
    if (perm1 == i) Rh0 = Bh0[i];
    if (perm2 == i) Rh1 = Bh0[i];
    if (face_axis == i) Ah_face = Ah[i];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float b2 = 0.f, b0 = 0.f, b1 = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (nf_idx == i) b2 = BR0[c][i];
      if (perm1 == i) b0 = BR0[c][i];
      if (perm2 == i) b1 = BR0[c][i];
    }
    RR0[c] = b0;
    RR1[c] = b1;
    RR2[c] = b2;
    const float Bfn = -sgn(nf_val) * b2;
    Rc[c] = Bc0[c] + Bfn * Bh_sel;
  }
  float AfC[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) AfC[c] = Ac[c] + Afn[c] * Ah_face;
  const float Ad = -dot3(Afn, AfC);

  // ---- clip the incident rectangle by the 6 halfspaces of box A ----
  float Bc_rel[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) Bc_rel[c] = Ac[c] - Rc[c];
  float px[MAX_POLY], py[MAX_POLY];
#pragma unroll
  for (int i = 0; i < MAX_POLY; ++i) { px[i] = 0.f; py[i] = 0.f; }
  px[0] = -Rh0; py[0] = -Rh1;
  px[1] = -Rh0; py[1] = Rh1;
  px[2] = Rh0;  py[2] = Rh1;
  px[3] = Rh0;  py[3] = -Rh1;
  int cnt = 4;

#pragma unroll
  for (int i_ax = 0; i_ax < 3; ++i_ax) {
    const float Bn[3] = {AR[0][i_ax], AR[1][i_ax], AR[2][i_ax]};
    const float BnBc = dot3(Bn, Bc_rel);
    const float cv[3] = {Bn[1] * RR2[2] - Bn[2] * RR2[1], Bn[2] * RR2[0] - Bn[0] * RR2[2],
                         Bn[0] * RR2[1] - Bn[1] * RR2[0]};
    const float crossn = sqrtf(dot3(cv, cv));
    const float Hn0 = dot3(RR0, Bn), Hn1 = dot3(RR1, Bn);
    const bool parallel = crossn < TOL;
#pragma unroll
    for (int js = 0; js < 2; ++js) {
      const float jside = js == 0 ? -1.f : 1.f;
      const float Bd = -jside * BnBc - Ah[i_ax];
      if (parallel) {
        if (Bd > 0.f) cnt = 0;  // the whole polygon lies outside
        continue;               // otherwise it lies inside: keep it
      }
      const float nx = -jside * Hn0, ny = -jside * Hn1, dclip = -Bd;
      float kv[MAX_POLY], cxp[MAX_POLY], cyp[MAX_POLY];
      bool inside[MAX_POLY], crosses[MAX_POLY];
      int offs[MAX_POLY];
#pragma unroll
      for (int i = 0; i < MAX_POLY; ++i) kv[i] = px[i] * nx + py[i] * ny + dclip;
      int run = 0;
#pragma unroll
      for (int i = 0; i < MAX_POLY; ++i) {
        // next vertex: i + 1, wrapping to 0 at i + 1 == cnt (slot 11 always wraps)
        const bool wrap = (i == MAX_POLY - 1) || (cnt == i + 1);
        const float k2 = wrap ? kv[0] : kv[(i + 1) % MAX_POLY];
        const float p2x = wrap ? px[0] : px[(i + 1) % MAX_POLY];
        const float p2y = wrap ? py[0] : py[(i + 1) % MAX_POLY];
        const bool valid = i < cnt;
        inside[i] = (kv[i] >= 0.f) && valid;
        crosses[i] = (kv[i] * k2 < 0.f) && valid;
        const float tden = crosses[i] ? k2 - kv[i] : 1.f;
        const float tt = kv[i] / tden;
        cxp[i] = px[i] - tt * (p2x - px[i]);
        cyp[i] = py[i] - tt * (p2y - py[i]);
        offs[i] = run;
        run += (inside[i] ? 1 : 0) + (crosses[i] ? 1 : 0);
      }
      float npx[MAX_POLY], npy[MAX_POLY];
#pragma unroll
      for (int o = 0; o < MAX_POLY; ++o) {
        float accx = 0.f, accy = 0.f;
#pragma unroll
        for (int i = 0; i < MAX_POLY; ++i) {
          const bool sv = (offs[i] == o) && inside[i];
          const bool sc = ((offs[i] + (inside[i] ? 1 : 0)) == o) && crosses[i];
          accx = accx + (sv ? px[i] : 0.f) + (sc ? cxp[i] : 0.f);
          accy = accy + (sv ? py[i] : 0.f) + (sc ? cyp[i] : 0.f);
        }
        npx[o] = accx;
        npy[o] = accy;
      }
#pragma unroll
      for (int i = 0; i < MAX_POLY; ++i) { px[i] = npx[i]; py[i] = npy[i]; }
      cnt = run;
    }
  }

  // ---- contact lanes ----
  bool any_face = false;
#pragma unroll
  for (int i = 0; i < MAX_POLY; ++i) {
    float fpos[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) fpos[c] = Rc[c] + RR0[c] * px[i] + RR1[c] * py[i];
    const float fdep = -(dot3(Afn, fpos) + Ad);
    any_face = any_face || ((i < cnt) && (fabsf(fdep) > TOL || aacount >= 2));
  }
  const bool use_ee = (aacount == 0) && !best_is_FN;
  const float fb_depth = -sepFN;

#pragma unroll
  for (int i = 0; i < MAX_POLY; ++i) {
    float fpos[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) fpos[c] = Rc[c] + RR0[c] * px[i] + RR1[c] * py[i];
    const float fdep = -(dot3(Afn, fpos) + Ad);
    const bool keep = (i < cnt) && (fabsf(fdep) > TOL || aacount >= 2);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      pos[i][c] = use_ee ? ee_pos[c] : (any_face ? fpos[c] : p2[c]);
    dep[i] = use_ee ? ee_depth : (any_face ? fdep : fb_depth);
    const bool lane_act = use_ee ? (i == 0) : (any_face ? keep : (i == 0));
    act[i] = lane_act && !separated;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    nrm[c] = use_ee ? axEE[c] : axFN[c];
    iax[c] = best_is_FN ? axFN[c] : axEE[c];
  }
  *code = separated ? 0 : (use_ee ? codeEE : (any_face ? codeFN : 16));
  *idep = separated ? 0.f : info_depth;
}

// Row-major R of a unit quaternion (w, x, y, z): the expressions of
// eggshell_tpu_torch.ops.quaternion.quat_to_mat, term for term.
__device__ __forceinline__ void quat_rows(const float* q, float R[3][3]) {
  const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
  const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
  const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
  R[0][0] = 1.f - 2.f * (yy + zz); R[0][1] = 2.f * (xy - wz); R[0][2] = 2.f * (xz + wy);
  R[1][0] = 2.f * (xy + wz); R[1][1] = 1.f - 2.f * (xx + zz); R[1][2] = 2.f * (yz - wx);
  R[2][0] = 2.f * (xz - wy); R[2][1] = 2.f * (yz + wx); R[2][2] = 1.f - 2.f * (xx + yy);
}

__global__ void __launch_bounds__(128) narrowphase_kernel(
    const float* __restrict__ gp1, const float* __restrict__ gr1,
    const float* __restrict__ gh1, const float* __restrict__ gp2,
    const float* __restrict__ gr2, const float* __restrict__ gh2,
    float* __restrict__ out_pos, float* __restrict__ out_nrm,
    float* __restrict__ out_dep, uint8_t* __restrict__ out_act,
    int32_t* __restrict__ out_code, float* __restrict__ out_idep,
    float* __restrict__ out_iax, int64_t n) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;

  float p1[3], p2[3], H1[3], H2[3], R1[3][3], R2[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    p1[c] = gp1[3 * t + c];
    p2[c] = gp2[3 * t + c];
    H1[c] = gh1[3 * t + c];
    H2[c] = gh2[3 * t + c];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      R1[r][c] = gr1[9 * t + 3 * r + c];
      R2[r][c] = gr2[9 * t + 3 * r + c];
    }

  float pos[MAX_POLY][3], dep[MAX_POLY], nrm[3], iax[3], idep;
  bool act[MAX_POLY];
  int code;
  sat_contacts(p1, R1, H1, p2, R2, H2, pos, dep, act, nrm, &code, &idep, iax);
#pragma unroll
  for (int i = 0; i < MAX_POLY; ++i) {
#pragma unroll
    for (int c = 0; c < 3; ++c) out_pos[t * (3 * MAX_POLY) + 3 * i + c] = pos[i][c];
    out_dep[t * MAX_POLY + i] = dep[i];
    out_act[t * MAX_POLY + i] = act[i] ? 1 : 0;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out_nrm[3 * t + c] = nrm[c];
    out_iax[3 * t + c] = iax[c];
  }
  out_code[t] = code;
  out_idep[t] = idep;
}

// One thread per (scenario, pair): t = scenario * P + pair.
__global__ void __launch_bounds__(128) narrowphase_packed_kernel(
    const float* __restrict__ gp, const float* __restrict__ gq, const float* __restrict__ ghs,
    const int64_t* __restrict__ pair_i, const int64_t* __restrict__ pair_j,
    float* __restrict__ out_pos, float* __restrict__ out_nrm, float* __restrict__ out_dep,
    uint8_t* __restrict__ out_act, int64_t total, int n, int P) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t s = t / P;
  const int k = (int)(t % P);
  const int64_t i = pair_i[k], j = pair_j[k];
  const int64_t bi = s * n + i, bj = s * n + j;

  float p1[3], p2[3], H1[3], H2[3], R1[3][3], R2[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    p1[c] = gp[3 * bi + c];
    p2[c] = gp[3 * bj + c];
    H1[c] = ghs[3 * i + c];
    H2[c] = ghs[3 * j + c];
  }
  quat_rows(gq + 4 * bi, R1);
  quat_rows(gq + 4 * bj, R2);

  float pos[MAX_POLY][3], dep[MAX_POLY], nrm[3], iax[3], idep;
  bool act[MAX_POLY];
  int code;
  sat_contacts(p1, R1, H1, p2, R2, H2, pos, dep, act, nrm, &code, &idep, iax);
#pragma unroll
  for (int l = 0; l < MAX_POLY; ++l) {
#pragma unroll
    for (int c = 0; c < 3; ++c) out_pos[t * (3 * MAX_POLY) + 3 * l + c] = pos[l][c];
    out_dep[t * MAX_POLY + l] = dep[l];
    out_act[t * MAX_POLY + l] = act[l] ? 1 : 0;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) out_nrm[3 * t + c] = nrm[c];
}

}  // namespace

extern "C" int eggshell_narrowphase_f32(
    const float* p1, const float* r1, const float* h1, const float* p2,
    const float* r2, const float* h2, float* pos, float* nrm, float* dep,
    uint8_t* act, int32_t* code, float* idep, float* iax, int64_t n,
    void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (n + threads - 1) / threads;
  narrowphase_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      p1, r1, h1, p2, r2, h2, pos, nrm, dep, act, code, idep, iax, n);
  return (int)cudaGetLastError();
}

extern "C" int eggshell_narrowphase_packed_f32(
    const float* p, const float* q, const float* hs, const int64_t* pair_i,
    const int64_t* pair_j, float* pos, float* nrm, float* dep, uint8_t* act, int64_t B,
    int n, int P, void* stream) {
  const int64_t total = B * (int64_t)P;
  if (total <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (total + threads - 1) / threads;
  narrowphase_packed_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      p, q, hs, pair_i, pair_j, pos, nrm, dep, act, total, n, P);
  return (int)cudaGetLastError();
}
