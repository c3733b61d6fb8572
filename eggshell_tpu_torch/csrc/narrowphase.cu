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
// SAT device function `sat_group`.  Same semantics as the plain version
// `eggshell_tpu_torch.ops.collision.collide_boxes`: 15 separating axes,
// contact codes 1-16, the incident face clipped by the six halfspaces of
// the reference box into at most MAX_POLY points, the edge-edge contact and
// the deep-penetration fallback (code 16).
//
// What bounds it on an H100: instruction issue, not bytes.  A pair reads
// 30 floats and writes 66 floats and 12 flags, against some 2,000
// float32 operations of one long dependent chain (axes, set-up, six clip
// passes, contact lanes), each product and sum its own instruction
// (--fmad=false).  A thread a pair would leave 1.5 warps a scheduler at
// the bench shape, too few to hide that chain.  The design: a group
// of G = kLanes = 4 lanes of one warp a pair, 32 / G pairs a warp.  The
// code is written for any G of 2, 4, 8 and 16; 4 was the fastest of them
// on the card at every shape the paths launch (PERF.md), and only it is
// built into the library.
// - Axes: lane l evaluates axes l, l + G, ... of the 15 (6 face normals,
//   then the 9 edge-edge axes a-major), with the expressions of the scan
//   term for term; a butterfly of shuffles finds the best face and edge
//   axis with the scan's tie rule (the first of equal seps wins, a NaN or
//   an invalid edge axis is never taken), one ballot finds separation.
// - The pair's frame, the edge-edge contact and the reference/incident
//   set-up are group-uniform and computed by every lane alike (a warp
//   issues them once for all its pairs).
// - Clip: lane l holds vertices l, l + G, ... of the polygon in registers.
//   For each halfspace a lane gets its next vertex by shuffle, two ballots
//   and popcounts give each vertex's output slot, and each lane stores at
//   most its vertex and its crossing point into a per-group buffer in
//   shared memory (v + 0.f: the plain version's one-hot emission gives
//   +0 for a -0 vertex), then reads back its own slots; slots at or past
//   the new count read 0.  A slot no pair of the warp has a vertex in, a
//   crossing point no edge of the warp needs and a halfspace parallel to
//   every pair's incident face are skipped, by warp-uniform branches:
//   shuffles and ballots always run on the whole warp.
// - Contact lanes: a lane computes its vertices' points and depths once,
//   one ballot decides whether any face point is kept, and each lane
//   writes its own lanes.
// Outputs are written pair-major in the `PairContacts` layout (pos (N,12,3),
// normal (N,3), depth (N,12), active (N,12), code, info_depth, separating
// axis); the packed entry writes pos (B,P,12,3), normal (B,P,3), depth and
// active (B,P,12).  Lanes past the last pair compute on the last pair's
// inputs and store nothing.
//
// The library is built with --fmad=false: every product and sum is rounded
// on its own, as in the plain version's elementwise torch ops.  Exactly
// tied axes (aligned boxes) are still decided by rounding, so kernel and
// plain version may pick different, equally valid, axes there.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_POLY = 12;
constexpr int N_AXES = 15;
constexpr float ALIGN_TOL = 0.9962f;
constexpr float TOL = 1e-9f;
constexpr float BIG = 1e30f;
constexpr int NO_AXIS = 64;
// Lanes a pair, threads a block, and the shared memory of a group: two
// polygon buffers of MAX_POLY (x, y) points, used in turns by the clip
// passes that run, and one point more, so that the groups' buffers start
// on different banks.  tools/narrowphase_probe.py builds this file alone
// with another EGGSHELL_NARROWPHASE_LANES to re-measure the group size.
#ifndef EGGSHELL_NARROWPHASE_LANES
#define EGGSHELL_NARROWPHASE_LANES 4
#endif
constexpr int kLanes = EGGSHELL_NARROWPHASE_LANES;
constexpr int kThreads = 128;
constexpr int kGroupPoints = 2 * MAX_POLY + 1;
constexpr int kGroupsPerBlock = kThreads / kLanes;

__device__ __forceinline__ float sgn(float x) { return x >= 0.f ? 1.f : -1.f; }

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ float sel3(int k, float x0, float x1, float x2) {
  return k == 0 ? x0 : (k == 1 ? x1 : x2);
}

// M[r][c] for runtime r, c in 0..2.
__device__ __forceinline__ float at3(const float M[3][3], int r, int c) {
  return sel3(r, sel3(c, M[0][0], M[0][1], M[0][2]), sel3(c, M[1][0], M[1][1], M[1][2]),
              sel3(c, M[2][0], M[2][1], M[2][2]));
}

// The G lanes of one warp that work on one pair.  Every lane of the warp
// runs every shuffle, ballot and warp barrier (full mask: no group of a
// warp branches around one), so they compile to single instructions.
template <int G>
struct Group {
  static_assert(G == 2 || G == 4 || G == 8 || G == 16, "a pair takes 2, 4, 8 or 16 lanes");
  static constexpr unsigned kFull = 0xffffffffu;
  static constexpr unsigned kBits = 0xffffffffu >> (32 - G);
  int base;  // the group's first lane in the warp
  int lane;  // this lane within the group
  __device__ __forceinline__ Group() {
    const int l = threadIdx.x & 31;
    lane = l & (G - 1);
    base = l - lane;
  }
  __device__ __forceinline__ float shfl(float v, int src) const {
    return __shfl_sync(kFull, v, src, G);
  }
  __device__ __forceinline__ float shfl_xor(float v, int m) const {
    return __shfl_xor_sync(kFull, v, m, G);
  }
  __device__ __forceinline__ int shfl_xor(int v, int m) const {
    return __shfl_xor_sync(kFull, v, m, G);
  }
  // The group's votes, bit i for lane i of the group.
  __device__ __forceinline__ unsigned ballot(bool p) const {
    return (__ballot_sync(kFull, p) >> base) & kBits;
  }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
};

// Element i of a value spread over the group as x[s] on lane i - G s.
template <int G, int N>
__device__ __forceinline__ float fetch(const Group<G>& g, const float (&x)[N], int i) {
  float r = g.shfl(x[0], i & (G - 1));
#pragma unroll
  for (int s = 1; s < N; ++s) {
    const float o = g.shfl(x[s], i & (G - 1));
    if (i / G == s) r = o;
  }
  return r;
}

// The clip's next vertex of vertex v = lane + G s held as x[s]: vertex
// v + 1 (the next lane's slot s, or lane 0's slot s + 1 on the last lane),
// or vertex 0 where `wrap`.
template <int G, int N>
__device__ __forceinline__ float next_vertex(const Group<G>& g, const float (&x)[N], int s,
                                             bool wrap) {
  const float first = g.shfl(x[0], 0);
  const float right = g.shfl(x[s], (g.lane + 1) & (G - 1));
  const float up = s + 1 < N ? g.shfl(x[s + 1 < N ? s + 1 : 0], 0) : first;
  return wrap ? first : (g.lane + 1 < G ? right : up);
}

// The sequential scan's choice between a candidate axis (sep, idx) and the
// best so far: the larger sep, and of equal seps the lower index.  Axes the
// scan never takes (a NaN sep, an invalid edge axis: sep <= -BIG) enter as
// (-inf, NO_AXIS), so the order is total and a butterfly gives every lane
// the scan's result.
__device__ __forceinline__ void take_better(float s, int i, float& best, int& idx) {
  if (s > best || (s == best && i < idx)) {
    best = s;
    idx = i;
  }
}

__device__ __forceinline__ void offer(float sep, int i, float& best, int& idx) {
  const bool eligible = sep > -BIG;
  take_better(eligible ? sep : -INFINITY, eligible ? i : NO_AXIS, best, idx);
}

template <int G>
__device__ __forceinline__ void group_best(const Group<G>& g, float& best, int& idx) {
#pragma unroll
  for (int m = G / 2; m >= 1; m >>= 1) {
    const float s = g.shfl_xor(best, m);
    const int i = g.shfl_xor(idx, m);
    take_better(s, i, best, idx);
  }
}

struct PairIn {
  float p1[3], R1[3][3], H1[3], p2[3], R2[3][3], H2[3];
};

// What a group's lane holds of its pair's contacts: its lanes l, l + G, ...
// (pos, depth, active), and the pair's normal, code, depth along the best
// axis and that axis.
template <int G>
struct LaneContacts {
  static constexpr int NV = (MAX_POLY + G - 1) / G;
  float pos[NV][3], dep[NV];
  bool act[NV];
  float nrm[3], iax[3], idep;
  int code;
};

// The contacts of one box pair, computed by the G lanes of `g` together;
// `poly` is the group's kGroupPoints of shared memory.
template <int G>
__device__ __forceinline__ void sat_group(const Group<G>& g, const PairIn& in, float2* poly,
                                          LaneContacts<G>& out) {
  constexpr int NA = (N_AXES + G - 1) / G;
  constexpr int NV = LaneContacts<G>::NV;
  const float(&R1)[3][3] = in.R1;
  const float(&R2)[3][3] = in.R2;
  const float* p1 = in.p1;
  const float* p2 = in.p2;
  const float* H1 = in.H1;
  const float* H2 = in.H2;

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

  // ---- the 15 axes: axis a = lane + G s of this lane ----
  float bestF = -INFINITY, bestE = -INFINITY;
  int idxF = NO_AXIS, idxE = NO_AXIS;
  bool sep_any = false;
  float axf[3][NA], nE[3][NA], e1E[NA], lenE[NA];
#pragma unroll
  for (int s = 0; s < NA; ++s) {
    const int a = g.lane + G * s;
#pragma unroll
    for (int c = 0; c < 3; ++c) axf[c][s] = nE[c][s] = 0.f;
    e1E[s] = 0.f;
    lenE[s] = 1.f;
    if (a < 6) {
      // face normal a: box1's axis a, or box2's axis a - 3 (codes 1-6)
      const bool second = a >= 3;
      const int k = second ? a - 3 : a;
      const float e1 = second ? at3(R, 0, k) * p[0] + at3(R, 1, k) * p[1] + at3(R, 2, k) * p[2]
                              : sel3(k, p[0], p[1], p[2]);
      const float X = second ? sel3(k, H2[0], H2[1], H2[2]) : sel3(k, H1[0], H1[1], H1[2]);
      const float h0 = second ? H1[0] : H2[0], h1 = second ? H1[1] : H2[1],
                  h2 = second ? H1[2] : H2[2];
      const float q0 = second ? at3(Q, 0, k) : at3(Q, k, 0);
      const float q1 = second ? at3(Q, 1, k) : at3(Q, k, 1);
      const float q2 = second ? at3(Q, 2, k) : at3(Q, k, 2);
      const float r = X + (h0 * q0 + h1 * q1 + h2 * q2);
      const float sep = fabsf(e1) - r;
      sep_any = sep_any || (sep > 0.f);
      offer(sep, a, bestF, idxF);
      const float sg = sgn(e1);
#pragma unroll
      for (int c = 0; c < 3; ++c) axf[c][s] = sg * (second ? at3(R2, c, k) : at3(R1, c, k));
    } else if (a < N_AXES) {
      // edge x edge axis 7 + 3 ea + eb
      const int ea = (a - 6) / 3, eb = (a - 6) % 3;
      const float v0 = at3(R, 0, eb), v1 = at3(R, 1, eb), v2 = at3(R, 2, eb);
      float nv[3];
      nv[0] = ea == 0 ? 0.f : (ea == 1 ? v2 : -v1);
      nv[1] = ea == 0 ? -v2 : (ea == 1 ? 0.f : v0);
      nv[2] = ea == 0 ? v1 : (ea == 1 ? -v0 : 0.f);
      const float length = sqrtf(dot3(nv, nv));
      const bool valid = length > TOL;
      const float e1 = dot3(nv, p);
      const float span1 = H1[0] * fabsf(nv[0]) + H1[1] * fabsf(nv[1]) + H1[2] * fabsf(nv[2]);
      const int b1 = eb == 2 ? 0 : eb + 1, b2 = eb == 0 ? 2 : eb - 1;
      const float span2 = sel3(b1, H2[0], H2[1], H2[2]) * at3(Q, ea, b2) +
                          sel3(b2, H2[0], H2[1], H2[2]) * at3(Q, ea, b1);
      const float sep_raw = fabsf(e1) - (span1 + span2);
      sep_any = sep_any || (valid && sep_raw > 0.f);
      const float safe_len = valid ? length : 1.f;
      const float sep = valid ? sep_raw / safe_len : -BIG;
      offer(sep, a - 6, bestE, idxE);
#pragma unroll
      for (int c = 0; c < 3; ++c) nE[c][s] = nv[c];
      e1E[s] = e1;
      lenE[s] = safe_len;
    }
  }
  const bool separated = g.ballot(sep_any) != 0u;
  group_best(g, bestF, idxF);
  group_best(g, bestE, idxE);

  // the best face axis and edge axis, from the lanes that evaluated them
  const bool hasF = idxF != NO_AXIS, hasE = idxE != NO_AXIS;
  const float sepFN = hasF ? bestF : -BIG;
  const int codeFN = hasF ? idxF + 1 : 0;
  float axFN[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v = fetch(g, axf[c], hasF ? idxF : 0);
    axFN[c] = hasF ? v : 0.f;
  }
  const float sepEE = hasE ? bestE : -BIG;
  const int codeEE = hasE ? 7 + idxE : 0;
  const int eaxis = hasE ? 6 + idxE : 6;
  float nEE[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v = fetch(g, nE[c], eaxis);
    nEE[c] = hasE ? v : 0.f;
  }
  const float e1v = fetch(g, e1E, eaxis), lenv = fetch(g, lenE, eaxis);
  const float e1EE = hasE ? e1v : 0.f, lenEE = hasE ? lenv : 1.f;

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
    // codeEE 0 (no valid edge axis) gives a_idx -2, b_idx -1: ua = ub = 0
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
  // vertex v = lane + G s of the polygon in px[s], py[s]
  float Bc_rel[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) Bc_rel[c] = Ac[c] - Rc[c];
  float px[NV], py[NV];
#pragma unroll
  for (int s = 0; s < NV; ++s) {
    const int v = g.lane + G * s;
    px[s] = (v == 0 || v == 1) ? -Rh0 : ((v == 2 || v == 3) ? Rh0 : 0.f);
    py[s] = (v == 0 || v == 3) ? -Rh1 : ((v == 1 || v == 2) ? Rh1 : 0.f);
  }
  int cnt = 4;
  int buf = 0;
  const unsigned below = (1u << g.lane) - 1u;

#pragma unroll
  for (int i_ax = 0; i_ax < 3; ++i_ax) {
    const float Bn[3] = {AR[0][i_ax], AR[1][i_ax], AR[2][i_ax]};
    const float BnBc = dot3(Bn, Bc_rel);
    const float cv[3] = {Bn[1] * RR2[2] - Bn[2] * RR2[1], Bn[2] * RR2[0] - Bn[0] * RR2[2],
                         Bn[0] * RR2[1] - Bn[1] * RR2[0]};
    const float crossn = sqrtf(dot3(cv, cv));
    const float Hn0 = dot3(RR0, Bn), Hn1 = dot3(RR1, Bn);
    // A halfspace parallel to the incident face takes the polygon whole or
    // drops it.  The clip is skipped where every pair of the warp is
    // parallel there; elsewhere every group runs it and a parallel one
    // drops its result.
    const bool parallel = crossn < TOL;
    const bool skip = __all_sync(0xffffffffu, parallel);
#pragma unroll
    for (int js = 0; js < 2; ++js) {
      const float jside = js == 0 ? -1.f : 1.f;
      const float Bd = -jside * BnBc - Ah[i_ax];
      if (parallel && Bd > 0.f) cnt = 0;  // the whole polygon lies outside
      if (skip) continue;                 // otherwise it lies inside: keep it
      const float nx = -jside * Hn0, ny = -jside * Hn1, dclip = -Bd;
      float kv[NV];
#pragma unroll
      for (int s = 0; s < NV; ++s) kv[s] = px[s] * nx + py[s] * ny + dclip;
      bool inside[NV], crosses[NV];
      float cxp[NV], cyp[NV];
      unsigned mi[NV], mc[NV];
#pragma unroll
      for (int s = 0; s < NV; ++s) {
        const int v = g.lane + G * s;
        const bool valid = v < cnt && v < MAX_POLY;
        inside[s] = crosses[s] = false;
        cxp[s] = cyp[s] = 0.f;
        mi[s] = mc[s] = 0u;
        // Slot s is skipped where no pair of the warp has a vertex there:
        // its vertices emit nothing, and no vertex before them wraps to
        // them (the last vertex of a polygon wraps to vertex 0).
        if (s > 0 && !__any_sync(0xffffffffu, valid)) continue;
        // next vertex: v + 1, wrapping to 0 at v + 1 == cnt (slot 11 always wraps)
        const bool wrap = (v >= MAX_POLY - 1) || (cnt == v + 1);
        const float k2 = next_vertex(g, kv, s, wrap);
        const float p2x = next_vertex(g, px, s, wrap);
        const float p2y = next_vertex(g, py, s, wrap);
        inside[s] = (kv[s] >= 0.f) && valid;
        crosses[s] = (kv[s] * k2 < 0.f) && valid;
        // a crossing point is only stored where its edge crosses
        if (__any_sync(0xffffffffu, crosses[s])) {
          const float tden = crosses[s] ? k2 - kv[s] : 1.f;
          const float tt = kv[s] / tden;
          cxp[s] = px[s] - tt * (p2x - px[s]);
          cyp[s] = py[s] - tt * (p2y - py[s]);
        }
        mi[s] = g.ballot(inside[s]);
        mc[s] = g.ballot(crosses[s]);
      }
      // vertex v's first output slot: what the vertices before it emit
      float2* out_xy = poly + buf * MAX_POLY;
      int run = 0;
#pragma unroll
      for (int s = 0; s < NV; ++s) {
        const int offs = run + __popc(mi[s] & below) + __popc(mc[s] & below);
        run += __popc(mi[s]) + __popc(mc[s]);
        const int oc = offs + (inside[s] ? 1 : 0);
        if (inside[s] && offs < MAX_POLY) out_xy[offs] = make_float2(px[s] + 0.f, py[s] + 0.f);
        if (crosses[s] && oc < MAX_POLY) out_xy[oc] = make_float2(cxp[s] + 0.f, cyp[s] + 0.f);
      }
      g.sync();
      const int filled = min(run, MAX_POLY);
#pragma unroll
      for (int s = 0; s < NV; ++s) {
        const int v = g.lane + G * s;
        const float2 xy = v < filled ? out_xy[v] : make_float2(0.f, 0.f);
        px[s] = parallel ? px[s] : xy.x;
        py[s] = parallel ? py[s] : xy.y;
      }
      cnt = parallel ? cnt : run;
      buf ^= 1;  // the next pass writes the other buffer, read before this sync
    }
  }

  // ---- contact lanes ----
  float fpos[NV][3], fdep[NV];
  bool keep[NV];
  bool any_keep = false;
#pragma unroll
  for (int s = 0; s < NV; ++s) {
    const int v = g.lane + G * s;
#pragma unroll
    for (int c = 0; c < 3; ++c) fpos[s][c] = Rc[c] + RR0[c] * px[s] + RR1[c] * py[s];
    fdep[s] = -(dot3(Afn, fpos[s]) + Ad);
    keep[s] = (v < cnt) && (v < MAX_POLY) && (fabsf(fdep[s]) > TOL || aacount >= 2);
    any_keep = any_keep || keep[s];
  }
  const bool any_face = g.ballot(any_keep) != 0u;
  const bool use_ee = (aacount == 0) && !best_is_FN;
  const float fb_depth = -sepFN;

#pragma unroll
  for (int s = 0; s < NV; ++s) {
    const int v = g.lane + G * s;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out.pos[s][c] = use_ee ? ee_pos[c] : (any_face ? fpos[s][c] : p2[c]);
    out.dep[s] = use_ee ? ee_depth : (any_face ? fdep[s] : fb_depth);
    const bool lane_act = use_ee ? (v == 0) : (any_face ? keep[s] : (v == 0));
    out.act[s] = lane_act && !separated;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out.nrm[c] = use_ee ? axEE[c] : axFN[c];
    out.iax[c] = best_is_FN ? axFN[c] : axEE[c];
  }
  out.code = separated ? 0 : (use_ee ? codeEE : (any_face ? codeFN : 16));
  out.idep = separated ? 0.f : info_depth;
}

// Row-major R of a unit quaternion (w, x, y, z): the expressions of
// eggshell_tpu_torch.ops.quaternion.quat_to_mat, term for term.
__device__ __forceinline__ void quat_rows(const float q[4], float R[3][3]) {
  const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
  const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
  const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
  R[0][0] = 1.f - 2.f * (yy + zz); R[0][1] = 2.f * (xy - wz); R[0][2] = 2.f * (xz + wy);
  R[1][0] = 2.f * (xy + wz); R[1][1] = 1.f - 2.f * (xx + zz); R[1][2] = 2.f * (yz - wx);
  R[2][0] = 2.f * (xz - wy); R[2][1] = 2.f * (yz + wx); R[2][2] = 1.f - 2.f * (xx + yy);
}

// A pair's record of NE floats, element e = lane + G s loaded by one lane
// into x[s] (by `load(e)`), then shared: f[e] on every lane.
template <int G, int NE, typename Load>
__device__ __forceinline__ void load_spread(const Group<G>& g, Load load, float (&f)[NE]) {
  constexpr int NS = (NE + G - 1) / G;
  float x[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int e = g.lane + G * s;
    x[s] = e < NE ? load(e) : 0.f;
  }
#pragma unroll
  for (int e = 0; e < NE; ++e) f[e] = g.shfl(x[e / G], e % G);
}

// Write this lane's contact lanes of pair t: pos (12, 3), depth, active.
template <int G>
__device__ __forceinline__ void store_lanes(const Group<G>& g, const LaneContacts<G>& o,
                                            int64_t t, float* __restrict__ out_pos,
                                            float* __restrict__ out_dep,
                                            uint8_t* __restrict__ out_act) {
#pragma unroll
  for (int s = 0; s < LaneContacts<G>::NV; ++s) {
    const int v = g.lane + G * s;
    if (v < MAX_POLY) {
#pragma unroll
      for (int c = 0; c < 3; ++c) out_pos[t * (3 * MAX_POLY) + 3 * v + c] = o.pos[s][c];
      out_dep[t * MAX_POLY + v] = o.dep[s];
      out_act[t * MAX_POLY + v] = o.act[s] ? 1 : 0;
    }
  }
}

// A group of G lanes a pair, kThreads / G pairs a block.
template <int G>
__global__ void __launch_bounds__(kThreads) narrowphase_kernel(
    const float* __restrict__ gp1, const float* __restrict__ gr1,
    const float* __restrict__ gh1, const float* __restrict__ gp2,
    const float* __restrict__ gr2, const float* __restrict__ gh2,
    float* __restrict__ out_pos, float* __restrict__ out_nrm,
    float* __restrict__ out_dep, uint8_t* __restrict__ out_act,
    int32_t* __restrict__ out_code, float* __restrict__ out_idep,
    float* __restrict__ out_iax, int64_t n) {
  extern __shared__ float2 smem[];
  const Group<G> g;
  const int group = threadIdx.x / G;
  const int64_t t = (int64_t)blockIdx.x * (kThreads / G) + group;
  const bool live = t < n;
  const int64_t u = live ? t : n - 1;  // the tail's groups redo the last pair

  // the pair's 30 floats: p1, R1 (row-major), H1, p2, R2, H2
  float f[30];
  load_spread<G>(g, [&](int e) {
    if (e < 3) return gp1[3 * u + e];
    if (e < 12) return gr1[9 * u + e - 3];
    if (e < 15) return gh1[3 * u + e - 12];
    if (e < 18) return gp2[3 * u + e - 15];
    if (e < 27) return gr2[9 * u + e - 18];
    return gh2[3 * u + e - 27];
  }, f);
  PairIn in;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    in.p1[c] = f[c];
    in.H1[c] = f[12 + c];
    in.p2[c] = f[15 + c];
    in.H2[c] = f[27 + c];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      in.R1[c][j] = f[3 + 3 * c + j];
      in.R2[c][j] = f[18 + 3 * c + j];
    }
  }

  LaneContacts<G> o;
  sat_group(g, in, smem + group * kGroupPoints, o);
  if (!live) return;
  store_lanes(g, o, t, out_pos, out_dep, out_act);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    if (g.lane == c % G) {
      out_nrm[3 * t + c] = o.nrm[c];
      out_iax[3 * t + c] = o.iax[c];
    }
  if (g.lane == 3 % G) {
    out_code[t] = o.code;
    out_idep[t] = o.idep;
  }
}

// Pair t = scenario * P + pair, a group of G lanes each.  The pair's
// bodies are pair_i[s * stride + k] and pair_j[s * stride + k]: stride 0
// for one list of P pairs shared by every scenario, P for a list per
// scenario (the broadphase's selection).  With `gate` (B * P flags, the
// broadphase's), a pair whose flag is 0 writes no active lane.
template <int G>
__global__ void __launch_bounds__(kThreads) narrowphase_packed_kernel(
    const float* __restrict__ gp, const float* __restrict__ gq, const float* __restrict__ ghs,
    const int64_t* __restrict__ pair_i, const int64_t* __restrict__ pair_j,
    const uint8_t* __restrict__ gate, float* __restrict__ out_pos, float* __restrict__ out_nrm,
    float* __restrict__ out_dep, uint8_t* __restrict__ out_act, int64_t total, int n, int P,
    int64_t stride) {
  extern __shared__ float2 smem[];
  const Group<G> g;
  const int group = threadIdx.x / G;
  const int64_t t = (int64_t)blockIdx.x * (kThreads / G) + group;
  const bool live = t < total;
  // the tail's groups redo the last pair; total < 2^31 (the entry checks)
  const uint32_t u = (uint32_t)(live ? t : total - 1);
  const uint32_t s = u / (uint32_t)P;
  const int k = (int)(u - s * (uint32_t)P);
  const int64_t i = pair_i[s * stride + k], j = pair_j[s * stride + k];
  const int64_t bi = (int64_t)s * n + i, bj = (int64_t)s * n + j;

  // p, q and half extents of body i, then of body j
  float f[20];
  load_spread<G>(g, [&](int e) {
    if (e < 3) return gp[3 * bi + e];
    if (e < 7) return gq[4 * bi + e - 3];
    if (e < 10) return ghs[3 * i + e - 7];
    if (e < 13) return gp[3 * bj + e - 10];
    if (e < 17) return gq[4 * bj + e - 13];
    return ghs[3 * j + e - 17];
  }, f);
  PairIn in;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    in.p1[c] = f[c];
    in.H1[c] = f[7 + c];
    in.p2[c] = f[10 + c];
    in.H2[c] = f[17 + c];
  }
  quat_rows(f + 3, in.R1);
  quat_rows(f + 13, in.R2);

  LaneContacts<G> o;
  sat_group(g, in, smem + group * kGroupPoints, o);
  if (!live) return;
  if (gate != nullptr && gate[t] == 0) {
#pragma unroll
    for (int v = 0; v < LaneContacts<G>::NV; ++v) o.act[v] = false;
  }
  store_lanes(g, o, t, out_pos, out_dep, out_act);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    if (g.lane == c % G) out_nrm[3 * t + c] = o.nrm[c];
}

// The launch a plan names: `lanes` a pair, `threads` a block, `blocks`
// blocks for n pairs and `shared_bytes` of dynamic shared memory; anything
// else is refused.
bool plan_taken(int64_t n, int lanes, int threads, int64_t blocks, int shared_bytes) {
  return lanes == kLanes && threads == kThreads &&
         blocks == (n + kGroupsPerBlock - 1) / kGroupsPerBlock &&
         shared_bytes == kGroupsPerBlock * kGroupPoints * (int)sizeof(float2);
}

}  // namespace

extern "C" int eggshell_narrowphase_f32(
    const float* p1, const float* r1, const float* h1, const float* p2,
    const float* r2, const float* h2, float* pos, float* nrm, float* dep,
    uint8_t* act, int32_t* code, float* idep, float* iax, int64_t n,
    int lanes, int threads, int64_t blocks, int shared_bytes, void* stream) {
  if (n <= 0 || !plan_taken(n, lanes, threads, blocks, shared_bytes))
    return (int)cudaErrorInvalidValue;
  narrowphase_kernel<kLanes><<<(unsigned)blocks, threads, shared_bytes, (cudaStream_t)stream>>>(
      p1, r1, h1, p2, r2, h2, pos, nrm, dep, act, code, idep, iax, n);
  return (int)cudaGetLastError();
}

// pair_stride 0: pair_i / pair_j hold P pairs for every scenario; P: B * P
// pairs, a list per scenario.  gate: null, or B * P flags.
extern "C" int eggshell_narrowphase_packed_f32(
    const float* p, const float* q, const float* hs, const int64_t* pair_i,
    const int64_t* pair_j, const uint8_t* gate, float* pos, float* nrm, float* dep,
    uint8_t* act, int64_t B, int n, int P, int64_t pair_stride, int lanes, int threads,
    int64_t blocks, int shared_bytes, void* stream) {
  const int64_t total = B * (int64_t)P;
  if (total <= 0 || total >= (int64_t(1) << 31) || (pair_stride != 0 && pair_stride != P) ||
      !plan_taken(total, lanes, threads, blocks, shared_bytes))
    return (int)cudaErrorInvalidValue;
  narrowphase_packed_kernel<kLanes>
      <<<(unsigned)blocks, threads, shared_bytes, (cudaStream_t)stream>>>(
          p, q, hs, pair_i, pair_j, gate, pos, nrm, dep, act, total, n, P, pair_stride);
  return (int)cudaGetLastError();
}
