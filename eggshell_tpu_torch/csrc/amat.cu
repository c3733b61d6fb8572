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
// never gathers it.  Slot bodies -1 (the ground) match each other; their
// Jc slots are zero and their M^-1 is zero, so they add nothing.
//
// What bounds it on an H100: bytes.  A scenario writes mp^2 floats of A
// (16 KB at K = 20, mp = 64) and reads 3K * 12 floats of Jc; each entry
// costs at most 4 six-term dots, about 3 flops per byte written.  One block
// per scenario: Jc, X and the lane bodies go to shared memory, then one
// thread per entry of A, neighbouring threads on neighbouring columns so
// the stores of A are coalesced.  The TPU kernel's 4-row slabs and
// sublane-major A layout are not carried over: A is (B, mp, mp) row-major.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void amat_kernel(const float* __restrict__ Jc, const int64_t* __restrict__ b0,
                            const int64_t* __restrict__ b1, const uint8_t* __restrict__ act,
                            const float* __restrict__ inv_mass, const float* __restrict__ invIg,
                            float* __restrict__ A, float* __restrict__ diag, int K, int n, int mp,
                            float cfm) {
  extern __shared__ float smem[];
  const int m = 3 * K;
  float* sJ = smem;             // (m, 12)
  float* sX = smem + m * 12;    // (m, 12): X of slot 0 in 0:6, slot 1 in 6:12
  int* sb = (int*)(sX + m * 12);  // (2, K) lane bodies
  int* sact = sb + 2 * K;       // (K,)
  const int64_t s = blockIdx.x;

  for (int i = threadIdx.x; i < m * 12; i += blockDim.x) sJ[i] = Jc[s * m * 12 + i];
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    sb[k] = (int)b0[s * K + k];
    sb[K + k] = (int)b1[s * K + k];
    sact[k] = act[s * K + k] != 0;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < m * 12; i += blockDim.x) {
    const int row = i / 12, sc = i % 12, slot = sc / 6, c = sc % 6;
    const int b = sb[slot * K + row / 3];
    const float* J = sJ + row * 12 + 6 * slot;
    float x;
    if (c < 3) {
      x = J[c] * (b >= 0 ? inv_mass[b] : 0.f);
    } else {
      const float* ig = invIg + (s * n + (b >= 0 ? b : 0)) * 9;
      const float g0 = b >= 0 ? ig[c - 3] : 0.f;
      const float g1 = b >= 0 ? ig[3 + c - 3] : 0.f;
      const float g2 = b >= 0 ? ig[6 + c - 3] : 0.f;
      x = J[3] * g0 + J[4] * g1 + J[5] * g2;
    }
    sX[i] = x;
  }
  __syncthreads();

  float* As = A + s * (int64_t)mp * mp;
  for (int i = threadIdx.x; i < mp * mp; i += blockDim.x) {
    const int row = i / mp, col = i % mp;
    float full;
    if (row >= m || col >= m) {
      full = row == col ? 1.f : 0.f;
    } else {
      const int k = row / 3, j = col / 3;
      const int bk[2] = {sb[k], sb[K + k]};
      const int bj[2] = {sb[j], sb[K + j]};
      float val = 0.f;
      for (int si = 0; si < 2; ++si) {
        for (int sj = 0; sj < 2; ++sj) {
          if (bk[si] != bj[sj]) continue;
          const float* x = sX + row * 12 + 6 * si;
          const float* jc = sJ + col * 12 + 6 * sj;
          float dot = 0.f;
          for (int e = 0; e < 6; ++e) dot = dot + x[e] * jc[e];
          val = val + dot;
        }
      }
      full = val + (row == col ? (sact[k] ? cfm : 1.f) : 0.f);
    }
    As[i] = full;
    if (row == col) diag[s * mp + row] = full;
  }
}

}  // namespace

extern "C" int eggshell_amat_f32(const float* Jc, const int64_t* b0, const int64_t* b1,
                                 const uint8_t* act, const float* inv_mass, const float* invIg,
                                 float* A, float* diag, int64_t B, int K, int n, int mp, float cfm,
                                 void* stream) {
  if (B <= 0) return 0;
  const size_t smem = (size_t)(2 * 36 * K) * sizeof(float) + (size_t)(3 * K) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(amat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  amat_kernel<<<(unsigned)B, kThreads, smem, (cudaStream_t)stream>>>(Jc, b0, b1, act, inv_mass,
                                                                     invIg, A, diag, K, n, mp, cfm);
  return (int)cudaGetLastError();
}
