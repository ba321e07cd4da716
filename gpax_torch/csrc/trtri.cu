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
// Layout: 128 threads per block, thread j owns column j of the tile's
// inverse and runs the forward substitution of tile_inv.cuh (shared with
// K3), the Pallas kernel's row recurrence read column by column. L's
// tile sits in dynamic shared memory. In float32 W's tile sits there too
// (2 x 64 KB). In float64 the two tiles would take 256 KB, more than an SM's
// 227 KB, so L's tile (128 KB) stays in shared memory and each thread keeps
// its column of W in the output itself, in global memory: the thread reads
// back only what it wrote, through L1, and a warp's loads of one row are
// coalesced.
//
// What bounds it on an H100: a thread does 128^2 / 2 FMAs per tile, and a
// block of 4 warps gives each scheduler one warp, which issues each term's
// address arithmetic, loads and FMA at their full latencies: the wrapper
// takes 0.099 ms in float32 and 0.219 ms in float64 for the 32 tiles of
// n = 4096, W's zero fill included, at most 21 and 46 cycles per term.
// Splitting the sum into four chains did not change that; more warps per
// column might. It moves only a few hundred KB, so it
// is not bandwidth-bound. With one block per tile, n = 4096 fills 32 of
// the 132 SMs;
// the design relies on the batch of posterior draws in predict to fill the
// rest, and on the recursion's GEMMs, which are n^3 / 3 flops against the
// leaves' n * 128^2 / 2, to dominate the inverse's time.
//
// A zero or NaN pivot propagates inf/NaN, as in the Pallas kernel: nothing
// is clamped. The caller's jitter escalation decides what to do with it.

#include <cuda_runtime.h>

#include "tile_inv.cuh"

namespace {

constexpr int kT = gpax::kTile;

template <typename T>
struct Tiles {
  static constexpr bool w_in_smem = sizeof(T) == 4;  // W's tile beside L's
  static constexpr int smem_bytes = (w_in_smem ? 2 : 1) * kT * kT * (int)sizeof(T);
};

template <typename T>
__global__ void __launch_bounds__(kT)
tile_tri_inv_kernel(const T* __restrict__ L, T* __restrict__ W, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ls = reinterpret_cast<T*>(smem);  // [kT][kT], row-major tile of L

  const int t = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const size_t base = (size_t)b * n * n + (size_t)t * kT * n + (size_t)t * kT;
  // row-major tile of W: in shared memory (stride kT) or in place (stride n)
  T* Wt = Tiles<T>::w_in_smem ? Ls + kT * kT : W + base;
  const size_t ldw = Tiles<T>::w_in_smem ? kT : n;

  for (int i = 0; i < kT; ++i) Ls[i * kT + j] = L[base + (size_t)i * n + j];
  __syncthreads();

  gpax::tile_forward_subst(Ls, Wt, ldw, j);
  // each thread reads back only the column it wrote: no barrier needed
  if (Tiles<T>::w_in_smem)
    for (int i = 0; i < kT; ++i) W[base + (size_t)i * n + j] = Wt[i * kT + j];
}

template <typename T>
int launch(const T* L, T* W, int batch, int n, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tile_tri_inv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tiles<T>::smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n / kT, batch);
  tile_tri_inv_kernel<T><<<grid, kT, Tiles<T>::smem_bytes, stream>>>(L, W, n);
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
