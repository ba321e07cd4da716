// The in-place Cholesky factorization of one 128 x 128 SPD tile in shared
// memory, shared by K3 (cholinv.cu) and K4's diagonal tiles (panel_chol.cu).
//
// Right-looking: at step j, l_i = A[i][j] / sqrt(A[j][j]) for i >= j (the
// 128 threads of the first half, one row each, into the shared vector lv),
// then A[i][k] -= l_i l_k for j < k <= i, the 256 threads taking one column
// and every second row each, so the warps of a row read neighbouring A[i][k]
// and the same l_i. On return L sits in the lower triangle of As (the upper
// triangle holds stale values) and every thread has passed a barrier.
//
// The pivot's scale is the IEEE square root and division, not rsqrtf: the
// special-function unit's rsqrtf (up to 2 ulp off) left each column of L
// scaled by a rounding error that chol_inv's Schur updates carried into the
// later leaves, and float32 chol_inv of a near-singular m = 1000 gram
// (kappa 2.9e6, one the library's float32 Cholesky factors) came back NaN;
// with the division it factors it (PERF.md, probes/sparse_precision).
//
// Nothing is clamped: a negative pivot gives sqrt = NaN, a zero one a
// division by zero (inf or NaN), and NaN spreads through the trailing update
// to every later column, as the Pallas kernels' rsqrt does. The callers'
// jitter escalations rely on that.

#pragma once

#include "tile_inv.cuh"

namespace gpax {

constexpr int kCholThreads = 256;  // the block size tile_cholesky expects

__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }

// As: the row-major kTile x kTile tile, loaded, with a barrier passed since;
// lv: kTile elements of shared scratch.
template <typename T>
__device__ __forceinline__ void tile_cholesky(T* As, T* lv) {
  constexpr int kRowGroups = kCholThreads / kTile;
  const int tid = threadIdx.x;
  const int c = tid % kTile, g = tid / kTile;  // column, row group
  for (int j = 0; j < kTile; ++j) {
    T v = 0;
    if (g == 0) {
      v = c >= j ? As[c * kTile + j] / sqrt_(As[j * kTile + j]) : T(0);
      lv[c] = v;
    }
    __syncthreads();
    // column j of L; the update below touches only columns k > j
    if (g == 0 && c >= j) As[c * kTile + j] = v;
    if (c > j) {
      const T lk = lv[c];
      for (int i = j + 1 + g; i < kTile; i += kRowGroups)
        if (c <= i) As[i * kTile + c] = fma_(-lv[i], lk, As[i * kTile + c]);
    }
    __syncthreads();
  }
}

}  // namespace gpax
