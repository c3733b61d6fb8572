// One 2D TMz Yee step (Ez, Hx, Hy) in normalised units, float32.
//
// Replaces the TPU kernel `_fdtd_kernel` of eggshell_tpu/fem/fdtd.py
// (reached through `step_2d_pallas`).  All five grids are (nx, ny),
// row-major: ez, hx_pad and hy_pad (H on ez-shaped grids; the last column
// of hx and the last row of hy are padding and stay as they come), inv_eps
// and pec_free (0 on PEC cells and on the rim, 1 elsewhere).  With
// c = dt / dx, per cell (i, j):
//   hx'(i, j) = hx(i, j) - c (ez(i, j+1) - ez(i, j))    (0 difference at j = ny-1)
//   hy'(i, j) = hy(i, j) + c (ez(i+1, j) - ez(i, j))    (0 difference at i = nx-1)
//   curl_x = hy'(i, j) - hy'(i-1, j) for 0 < i < nx-1, else 0
//   curl_y = hx'(i, j) - hx'(i, j-1) for 0 < j < ny-1, else 0
//   ez'(i, j) = (ez(i, j) + (c inv_eps(i, j)) (curl_x - curl_y)) pec_free(i, j)
//
// What bounds it on an H100: bytes.  Five grids are read and three written,
// 32 n^2 bytes, against about 15 flops a cell: under 0.5 flops a byte.  The
// design: one thread per cell, blocks of 32 x 8 threads with j fastest so a
// warp's loads and stores are 128 contiguous bytes, outputs out of place.
// The TPU kernel's two passes (H, then E from the new H) would need a grid
// barrier here; instead each thread recomputes the two neighbouring H
// values it needs, hy'(i-1, j) and hx'(i, j-1), with the very expressions
// that the neighbour's thread uses, so the step is one pass and the result
// is bit for bit the two-pass plain version's (built with --fmad=false).
// The neighbours' ez and H values come through L1 and L2: each grid is
// still read from device memory about once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void fdtd2d_kernel(const float* __restrict__ ez, const float* __restrict__ hx,
                              const float* __restrict__ hy, const float* __restrict__ inv_eps,
                              const float* __restrict__ pec_free, float* __restrict__ ez_out,
                              float* __restrict__ hx_out, float* __restrict__ hy_out, int nx,
                              int ny, float c) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const int64_t at = (int64_t)i * ny + j;
  const float e = ez[at];

  const float dzy = j < ny - 1 ? ez[at + 1] - e : 0.f;
  const float dzx = i < nx - 1 ? ez[at + ny] - e : 0.f;
  const float hxn = hx[at] - c * dzy;
  const float hyn = hy[at] + c * dzx;

  float curl_x = 0.f, curl_y = 0.f;
  if (i > 0 && i < nx - 1) {
    // hy'(i-1, j), as the thread of cell (i-1, j) computes it
    const float hy_up = hy[at - ny] + c * (e - ez[at - ny]);
    curl_x = hyn - hy_up;
  }
  if (j > 0 && j < ny - 1) {
    // hx'(i, j-1), as the thread of cell (i, j-1) computes it
    const float hx_left = hx[at - 1] - c * (e - ez[at - 1]);
    curl_y = hxn - hx_left;
  }
  ez_out[at] = (e + c * inv_eps[at] * (curl_x - curl_y)) * pec_free[at];
  hx_out[at] = hxn;
  hy_out[at] = hyn;
}

}  // namespace

extern "C" int eggshell_fdtd2d_f32(const float* ez, const float* hx, const float* hy,
                                   const float* inv_eps, const float* pec_free, float* ez_out,
                                   float* hx_out, float* hy_out, int nx, int ny, float c,
                                   void* stream) {
  if (nx <= 0 || ny <= 0) return 0;
  const dim3 threads(32, 8);
  const dim3 blocks((ny + 31) / 32, (nx + 7) / 8);
  fdtd2d_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(ez, hx, hy, inv_eps, pec_free,
                                                              ez_out, hx_out, hy_out, nx, ny, c);
  return (int)cudaGetLastError();
}
