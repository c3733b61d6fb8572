// A x for a dense matrix whose rows are read from device memory on every
// call, float32: the "global rows" form of the Jacobi solves
// (csrc/jacobi.cu, csrc/jacobi_packed_stream.cu).  Their launch plans take
// it only past what the streamed form (csrc/rows_stream.cuh) holds, above
// 6,560 rows; below that it stays the reference that the tests hold the
// cluster and streamed forms' bits to.
//
// One block a scenario, T threads; thread t owns rows t, t + T, ...  The
// block walks tiles of T rows by 32 columns: each warp copies 32
// consecutive floats of one row (128 bytes, one line) with `cp.async`, so
// every read of A is a whole line, and the tiles are double-buffered, so
// the next tile's copy is in flight while this one is summed.  A tile row
// has a stride of 33 floats, so the threads of a warp, each reading its
// own row at one column, hit 32 banks.  Each row is summed over j in
// increasing order, one product and one add at a time, as the forms that
// hold A in shared memory or registers sum it; so the two forms return the
// same bits (up to the sign of a zero).
//
// What bounds it: bytes.  A is read once a sweep, from L2 where it fits
// there (50 MB), else from HBM; and one block a scenario leaves SMs idle
// below B = 132 (at m = 672, B = 64, 16 sweeps it read 0.66 TB/s).

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rows_global {

constexpr int kCols = 32;        // columns of a tile
constexpr int kLd = kCols + 1;   // a tile row's stride in shared memory

// Floats of the two tiles of a block of T threads.
__host__ __device__ inline int tile_floats(int T) { return 2 * T * kLd; }

// A view of one scenario's matrix, mp x mp: rows and columns below m are
// stored at A[i * lda + j]; past m it is the identity (the solves' padding).
struct Rows {
  const float* A;
  int64_t lda;
  int m, mp;
};

// Issue the copies of tile `step` (row group step / nchunk, column chunk
// step % nchunk) into `buf` and commit them as one group.  Entries past m
// are written directly.
__device__ __forceinline__ void issue_tile(const Rows& a, int step, int nchunk, float* buf) {
  const int T = blockDim.x;
  const int i0 = (step / nchunk) * T, j0 = (step % nchunk) * kCols;
  for (int e = threadIdx.x; e < T * kCols; e += T) {
    const int r = e / kCols, c = e % kCols;
    const int i = i0 + r, j = j0 + c;
    float* dst = buf + r * kLd + c;
    if (i < a.m && j < a.m)
      __pipeline_memcpy_async(dst, a.A + i * a.lda + j, sizeof(float));
    else
      *dst = (i == j && i < a.mp) ? 1.f : 0.f;
  }
  __pipeline_commit();
}

// ax[i] = sum_{j < mp} A_ij x_j for every row i < mp.  `x` (mp floats)
// and `ax` are in shared memory; `tiles` holds tile_floats(T).  Called by
// every thread of the block; returns after a barrier, with ax complete and
// x no longer read.
__device__ __forceinline__ void matvec(const Rows& a, const float* x, float* ax, float* tiles) {
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int nchunk = (a.mp + kCols - 1) / kCols;
  const int total = ((a.mp + T - 1) / T) * nchunk;
  issue_tile(a, 0, nchunk, tiles);
  float acc = 0.f;
  for (int step = 0; step < total; ++step) {
    const float* cur = tiles + (step & 1) * T * kLd;
    if (step + 1 < total) {
      issue_tile(a, step + 1, nchunk, tiles + ((step + 1) & 1) * T * kLd);
      __pipeline_wait_prior(1);  // every group but the one just issued has landed
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // the tile is visible to every thread
    const int c = step % nchunk;
    const int i = (step / nchunk) * T + t;
    const int j0 = c * kCols;
    const int n = min(kCols, a.mp - j0);
    if (c == 0) acc = 0.f;
    if (i < a.mp) {
      const float* row = cur + t * kLd;
      for (int j = 0; j < n; ++j) acc = acc + row[j] * x[j0 + j];
      if (c == nchunk - 1) ax[i] = acc;
    }
    __syncthreads();  // `cur` may be overwritten by the copy issued next
  }
}

}  // namespace rows_global
