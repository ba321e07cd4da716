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
// Per block of 256 threads, the tile sits in dynamic shared memory, swizzled
// (tile_at), and the blocked routine of tile_chol_blocked.cuh (K4's diagonal
// step) factors it and inverts the factor there: L in the lower triangle,
// W^T in the strict upper one, 1/L_ii beside it. Then L (zero above the
// diagonal) and W are stored row-major. The float64 tile, the pivots and the
// row poisons take 130 KB, one block an SM; float32 65 KB.
//
// What bounds it on an H100: latency, not bytes or FLOPs. A tile moves
// 3 x 128 KB (float64) and does ~1.4 MFLOP, 0.12 us at the HBM rate, but
// its 128 pivots are one dependent chain of square roots and divisions, all
// on one SM per matrix. The routine takes 3 block barriers per 16-column
// sub-panel where the unblocked right-looking loop took 2 per column, factors
// each 16-column diagonal block in one warp's registers by shuffles, and runs
// the block products of the trailing update and of the inverse on the tensor
// cores in float64 (mma.sync m8n8k4) and as register-tiled FMAs in float32.
// At one matrix it uses one of 132 SMs; the batch fills more.
//
// The pivot's scale is the IEEE square root and division, and nothing is
// clamped: a bad pivot at row p gives NaN in L's columns from p on, finite
// columns before it, and non-finite entries in every column of W's rows
// from p on, as the Pallas kernel's row recurrence does (above the diagonal
// through the row poison, row_poison). The caller's jitter escalation
// (safe_chol_inv) relies on that.

#include <cuda_runtime.h>

#include "tile_chol_blocked.cuh"

namespace {

constexpr int kT = gpax::kTile;
constexpr int kThreads = gpax::kBlockedThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_chol_inv_kernel(const T* __restrict__ A, T* __restrict__ L, T* __restrict__ W) {
  using Smem = gpax::TileSmem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  T* inv = As + Smem::inv;
  T* z = As + Smem::poison;
  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * kT * kT;

  for (int e = tid; e < kT * kT; e += kThreads) As[gpax::tile_at<T>(e / kT, e % kT)] = A[base + e];
  __syncthreads();
  gpax::tile_chol_blocked(As, inv);
  if (tid < 32) gpax::row_poison((const T*)inv, z, tid);
  gpax::tile_inv_blocked(As, (const T*)inv);
  for (int e = tid; e < kT * kT; e += kThreads) {
    const int r = e / kT, c = e % kT;
    L[base + e] = c <= r ? As[gpax::tile_at<T>(r, c)] : T(0);
    W[base + e] = gpax::inverse_entry((const T*)As, (const T*)inv, (const T*)z, r, c);
  }
}

template <typename T>
int launch(const T* A, T* L, T* W, int batch, cudaStream_t stream) {
  constexpr int bytes = gpax::TileSmem<T>::bytes;
  cudaError_t err = cudaFuncSetAttribute(tile_chol_inv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  tile_chol_inv_kernel<T><<<batch, kThreads, bytes, stream>>>(A, L, W);
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
