// K3: Cholesky factor L and its inverse W = L^-1 of 128 x 128 SPD tiles, for
// Hopper (sm_90a), in float32 and float64.
//
// Replaces gpax_tpu/ops/chol.py::_tile_chol_inv_kernel (launched by
// _tile_chol_inv at the leaves of _chol_inv_rec under chol_inv). The
// recursion around it (L21 = K21 W11^T, the Schur update, W21 = -W22 L21 W11)
// stays in torch.matmul, as the JAX package leaves it to XLA. Each leaf needs
// the Schur complement of the leaves before it, so chol_inv of an m-matrix
// makes ceil(m / 128) launches in order; one launch covers the current leaf
// of every matrix of a batch (grid = batch, one block per matrix).
//
// Per block, the tile of A sits in dynamic shared memory and is overwritten
// by L in its lower triangle:
//   1. the right-looking Cholesky of tile_chol.cuh (shared with K4's
//      diagonal tiles), 256 threads;
//   2. the forward substitution for W of tile_inv.cuh, K2's loop, one column
//      per thread of the first 128.
// In float32 W's tile sits in shared memory beside A's (2 x 64 KB); in
// float64 the two would take 256 KB, more than an SM's 227 KB, so A's tile
// (128 KB) stays in shared memory and each thread keeps its column of W in
// the output itself, in global memory, as K2 does.
//
// What bounds it on an H100: latency, not bytes or FLOPs. A tile is 2 * 128
// dependent steps: 128 factorization steps with two barriers each, and 128
// substitution rows whose dot products grow to 127 terms, all on one SM per
// matrix. It moves 3 * 64 KB (float32) per matrix and does ~1.4 MFLOP. The
// design keeps every step in shared memory (no device-memory round trip
// between steps, which the TPU kernel's VMEM also avoided), spreads each
// trailing update over 8 warps, two per scheduler, and relies on the batch
// (one block per matrix) to fill more than one SM. At one matrix it uses one
// of 132 SMs.
//
// The pivot's scale is the IEEE square root and division, and nothing is
// clamped: a bad pivot's NaN reaches L and W (tile_chol.cuh says why both).
// The caller's jitter escalation (safe_chol_inv) relies on that.

#include <cuda_runtime.h>

#include "tile_chol.cuh"

namespace {

constexpr int kT = gpax::kTile;
constexpr int kThreads = gpax::kCholThreads;

template <typename T>
struct CholTiles {
  static constexpr bool w_in_smem = sizeof(T) == 4;  // W's tile beside A's
  // A's tile, the column vector l, and (float32) W's tile
  static constexpr int smem_bytes = ((w_in_smem ? 2 : 1) * kT * kT + kT) * (int)sizeof(T);
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_chol_inv_kernel(const T* __restrict__ A, T* __restrict__ L, T* __restrict__ W) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);  // [kT][kT] row-major; L in its lower triangle
  T* lv = As + kT * kT;                // column j of L during step j
  const int tid = threadIdx.x;
  const int c = tid % kT, g = tid / kT;  // column, row group
  const size_t base = (size_t)blockIdx.x * kT * kT;

  for (int e = tid; e < kT * kT; e += kThreads) As[e] = A[base + e];
  __syncthreads();

  gpax::tile_cholesky(As, lv);

  for (int e = tid; e < kT * kT; e += kThreads)
    L[base + e] = (e % kT) <= (e / kT) ? As[e] : T(0);
  if (g == 0) {
    // each thread reads back only the column it wrote: no barrier needed
    T* Wt = CholTiles<T>::w_in_smem ? lv + kT : W + base;
    gpax::tile_forward_subst(As, Wt, kT, c);
    if (CholTiles<T>::w_in_smem)
      for (int i = 0; i < kT; ++i) W[base + i * kT + c] = Wt[i * kT + c];
  }
}

template <typename T>
int launch(const T* A, T* L, T* W, int batch, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(tile_chol_inv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         CholTiles<T>::smem_bytes);
  if (err != cudaSuccess) return (int)err;
  tile_chol_inv_kernel<T><<<batch, kThreads, CholTiles<T>::smem_bytes, stream>>>(A, L, W);
  return (int)cudaGetLastError();
}

}  // namespace

// A, L and W: device pointers to contiguous (batch, 128, 128) tiles. Writes
// the Cholesky factor of each tile of A (zero above the diagonal) into L and
// its inverse into W. Returns the first CUDA error of the attribute call or
// the launch.
extern "C" int gpax_tile_chol_inv_f32(const float* A, float* L, float* W, int batch,
                                      cudaStream_t stream) {
  return launch(A, L, W, batch, stream);
}

extern "C" int gpax_tile_chol_inv_f64(const double* A, double* L, double* W, int batch,
                                      cudaStream_t stream) {
  return launch(A, L, W, batch, stream);
}
