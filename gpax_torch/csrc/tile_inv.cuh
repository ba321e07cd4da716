// The forward substitution of K5's diagonal tiles (panel_chol.cu): the
// inverse of one 128 x 128 lower-triangular tile, one column per thread.
// Also the tile size and the fma_ overloads that the blocked routine
// (tile_chol_blocked.cuh) builds on.
//
// Thread j (0 <= j < 128) owns column j of W = L^-1 and runs
//
//     W[i][j] = (delta_ij - sum_{k<i} L[i][k] W[k][j]) / L[i][i]
//
// which is the Pallas kernels' row recurrence read column by column
// (gpax_tpu/ops/chol.py, inv_step). Ls is the row-major tile of L in shared
// memory; Wt is the row-major tile of W with row stride ldw, in shared or
// global memory. A thread reads back only the column it wrote, so no barrier
// is needed inside. In the inner loop all threads of a warp read the same
// L[i][k] (a broadcast) and neighbouring W[k][j].
//
// A zero or NaN pivot propagates inf/NaN: nothing is clamped.

#pragma once

namespace gpax {

constexpr int kTile = 128;

__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }

template <typename T>
__device__ __forceinline__ void tile_forward_subst(const T* Ls, T* Wt, size_t ldw, int j) {
  for (int i = 0; i < kTile; ++i) {
    T acc = 0;
    for (int k = 0; k < i; ++k) acc = fma_(Ls[i * kTile + k], Wt[k * ldw + j], acc);
    Wt[i * ldw + j] = ((i == j ? T(1) : T(0)) - acc) / Ls[i * kTile + i];
  }
}

}  // namespace gpax
