// One row of the inverse of a 3x3 diagonal block of a matrix in shared
// memory, for the block-Jacobi kernels (csrc/jacobi.cu, csrc/jacobi_packed.cu).
//
// The JAX package's kernels invert each constraint block by its adjugate
// (eggshell_tpu/ops/pgs_kernel.py:272-287 and :114-129), with det replaced
// by 1 where |det| <= 1e-30.  These are the same expressions in the same
// order as the plain torch version (`ops.lcp.block_rows`), so with
// --fmad=false the two round alike.

#pragma once

// out[c] = inv(A_kk)[r, c], A_kk the 3x3 block of `a` (row stride ld) at
// (3k, 3k).
__device__ __forceinline__ void block_inverse_row(const float* a, int ld, int k, int r,
                                                  float out[3]) {
  const float* s = a + 3 * k * ld + 3 * k;
  const float a00 = s[0], a01 = s[1], a02 = s[2];
  const float a10 = s[ld], a11 = s[ld + 1], a12 = s[ld + 2];
  const float a20 = s[2 * ld], a21 = s[2 * ld + 1], a22 = s[2 * ld + 2];
  const float det = a00 * (a11 * a22 - a12 * a21) - a01 * (a10 * a22 - a12 * a20) +
                    a02 * (a10 * a21 - a11 * a20);
  const float invdet = 1.f / (fabsf(det) > 1e-30f ? det : 1.f);
  float adj0, adj1, adj2;
  if (r == 0) {
    adj0 = a11 * a22 - a12 * a21;
    adj1 = a02 * a21 - a01 * a22;
    adj2 = a01 * a12 - a02 * a11;
  } else if (r == 1) {
    adj0 = a12 * a20 - a10 * a22;
    adj1 = a00 * a22 - a02 * a20;
    adj2 = a02 * a10 - a00 * a12;
  } else {
    adj0 = a10 * a21 - a11 * a20;
    adj1 = a01 * a20 - a00 * a21;
    adj2 = a00 * a11 - a01 * a10;
  }
  out[0] = adj0 * invdet;
  out[1] = adj1 * invdet;
  out[2] = adj2 * invdet;
}
