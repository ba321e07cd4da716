// K2: inverses of the 128 x 128 diagonal tiles of lower-triangular matrices,
// for Hopper (sm_90a), in float32 and float64.
//
// Replaces gpax_tpu/ops/chol.py::_tile_tri_inv_kernel (launched by
// _tile_tri_inv under _trtri_rec / blocked_trtri). On the TPU the leaf tiles
// ran one after another inside the recursion. Here one launch inverts every
// diagonal tile of every matrix in the batch: each leaf depends only on L's
// own diagonal tile, so the grid is (n / 128, batch) and the blocks run in
// parallel. The off-diagonal combination W21 = -W22 (L21 W11) stays in
// torch.matmul, as the JAX package leaves it to XLA.
//
// Per block of 256 threads: the lower triangle of L's tile is loaded into
// dynamic shared memory, swizzled (tile_at); 1/L_ii is an IEEE division;
// the inverse half of the blocked routine of tile_chol_blocked.cuh
// (tile_inv_blocked, shared with K3 and K4's diagonal step) builds W^T in
// the tile's strict upper triangle, in 16 x 16 blocks; W's tile is stored
// row-major at row stride n. The float64 tile, the pivots and the row
// poisons take 130 KB, one block an SM; float32 65 KB.
//
// What bounds it on an H100: latency, not bytes or FLOPs. The 32 tiles of
// n = 4096 in float64 move 8.4 MB (2.5 us at the HBM rate) and do 22 MFLOP.
// A tile's inverse is 8 dependent block rows; the routine inverts the 8
// diagonal blocks in 8 warps at once, then takes 3 block barriers per block
// row, with the block products on the tensor cores in float64 (mma.sync
// m8n8k4) and as register-tiled FMAs in float32, where a per-column forward
// substitution ran a chain of up to 127 dependent FMAs on one thread. With
// one block per tile, n = 4096 fills 32 of the 132 SMs; the batch of
// posterior draws in predict fills the rest.
//
// A zero or NaN pivot at row p gives non-finite values in every column of
// W's rows from p on and finite values above p and in every other tile, as
// the Pallas kernel's row recurrence does: the row poison (row_poison) is
// added to each row as it is stored. Nothing is clamped; the caller's jitter
// escalation decides what to do with it.

#include <cuda_runtime.h>

#include "tile_chol_blocked.cuh"

namespace {

constexpr int kT = gpax::kTile;
constexpr int kThreads = gpax::kBlockedThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_tri_inv_kernel(const T* __restrict__ L, T* __restrict__ W, int n) {
  using Smem = gpax::TileSmem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  T* inv = As + Smem::inv;
  T* z = As + Smem::poison;
  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.y * n * n + (size_t)blockIdx.x * kT * (n + 1);

  for (int e = tid; e < kT * kT; e += kThreads) {
    const int r = e / kT, c = e % kT;
    if (c <= r) As[gpax::tile_at<T>(r, c)] = L[base + (size_t)r * n + c];
  }
  if (tid < kT) inv[tid] = T(1) / L[base + (size_t)tid * (n + 1)];
  __syncthreads();
  if (tid < 32) gpax::row_poison((const T*)inv, z, tid);
  gpax::tile_inv_blocked(As, (const T*)inv);
  for (int e = tid; e < kT * kT; e += kThreads) {
    const int r = e / kT, c = e % kT;
    W[base + (size_t)r * n + c] = gpax::inverse_entry((const T*)As, (const T*)inv, (const T*)z, r, c);
  }
}

template <typename T>
int launch(const T* L, T* W, int batch, int n, cudaStream_t stream) {
  constexpr int bytes = gpax::TileSmem<T>::bytes;
  cudaError_t err = cudaFuncSetAttribute(tile_tri_inv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n / kT, batch);
  tile_tri_inv_kernel<T><<<grid, kThreads, bytes, stream>>>(L, W, n);
  return (int)cudaGetLastError();
}

}  // namespace

// L and W: device pointers to contiguous (batch, n, n) matrices, n a multiple
// of 128. Writes the inverse of each diagonal tile of L into the same tile
// of W and leaves the rest of W untouched. Returns the first CUDA error of
// the attribute call or the launch.
extern "C" int gpax_tile_tri_inv_f32(const float* L, float* W, int batch, int n,
                                     cudaStream_t stream) {
  return launch(L, W, batch, n, stream);
}

extern "C" int gpax_tile_tri_inv_f64(const double* L, double* W, int batch, int n,
                                     cudaStream_t stream) {
  return launch(L, W, batch, n, stream);
}
