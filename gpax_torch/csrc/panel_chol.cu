// K4: the whole Cholesky factorization of a matrix in one launch, and K5: the
// transposed inverse W^T = L^-T of its factor in one launch, for Hopper
// (sm_90a), in float32 and float64.
//
// Replace scripts/panel_chol.py::_panel_chol_kernel (K4, launched by
// panel_cholesky) and ::_panel_tri_inv_kernel (K5, launched by
// panel_tri_inv_t). On the TPU the grid over 128-column panels runs in order
// on one core, so one launch covers the factorization. Here blocks run in
// parallel on 132 SMs, so each kernel is a cooperative persistent launch:
// as many blocks as fit on the card at once (the occupancy API times the SM
// count), walking the panels together, with a grid-wide barrier
// (cooperative_groups::this_grid().sync()) between phases. The matrices are
// row-major (B, n, n), n a multiple of 128 (the wrapper pads with identity).
//
// K4, for each panel j (left-looking, as on the TPU):
//   1. P = K[rows >= 128j, panel j] - L[rows, :128j] L[panel j rows, :128j]^T,
//      spread over all blocks in 64 x 128 tiles; when there are fewer tiles
//      than blocks, each tile's k-range is split and the partial sums are
//      added by a second pass after a barrier (split-K, in a fixed order, so
//      the result does not depend on the schedule);
//   2. one block per matrix factors the 128 x 128 diagonal tile of P in
//      shared memory with K3's loop (tile_chol.cuh), writes L_D (zero above
//      the diagonal) and its inverse W_D (K2's loop, tile_inv.cuh) to scratch;
//   3. the panel TRSM L[rows > diagonal tile, panel j] = P W_D^T, in place:
//      each 64-row tile reads all 128 columns of its rows before it writes.
// K5 first inverts every diagonal tile of L at once (they are independent),
// writing W_D^T onto W^T's diagonal, then for each panel j in order:
//   1. acc = W^T[rows < 128j, :128j] L[panel j rows, :128j]^T, skipping the
//      zeros of the upper-triangular W^T (row r starts at its own panel);
//   2. W^T[rows < 128j, panel j] = -acc W_D^T, in place.
// Both products are A B^T with A and B read along rows, k contiguous, so the
// loads of every phase are coalesced in row-major storage; W^T is kept (the
// TPU kernel's buffer), which makes K5's products the same shape as K4's.
//
// What bounds them on an H100: each does n^3/3 flops (0.34 ms at n = 4096 at
// 67 TFLOP/s) and moves 2 n^2 elements (0.08 ms in float64), but neither
// bound is near. The GEMM tiles are plain shared-memory CUDA-core FMA
// loops (no tensor cores, no TMA: a later PR's work), and K4's diagonal
// tiles are sequential: n / 128 factorizations of 256 dependent barrier
// steps each on one SM while the others wait, like K3's leaves. The
// left-looking products also re-read ~n^3 / (2 * 128) elements of the left
// factor, through L2. Measured in float64 at n = 4096: K4 13.1 ms (against
// 2.1 for cuSOLVER's Cholesky), K5 5.8 ms (4.2 for a triangular solve
// against I); PERF.md has the rest. In float64 one block fits an SM (132
// KB of shared memory), in float32 three.
//
// The pivot is the IEEE sqrt and division of tile_chol.cuh, and nothing is
// clamped: an indefinite matrix's first bad pivot gives NaN in L_D and W_D,
// which every later panel of L and W picks up through the products.
// Float32 runs float32 FMAs (no TF32), float64 float64 FMAs.
//
// Memory visibility: K is the only read-only operand (__restrict__); L, W^T
// and the scratch are written and read again by other blocks after a grid
// barrier, so they are plain pointers and never read through the
// non-coherent read-only cache.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tile_chol.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kT = gpax::kTile;               // panel width
constexpr int kThreads = gpax::kCholThreads;  // 256: tile_cholesky's block
constexpr int kBM = 64, kBN = kT, kBK = 16;   // product tile: 64 rows x the panel
constexpr int kTM = kBM / 16, kTN = kBN / 16; // 4 x 8 outputs per thread
constexpr int kTileElems = kBM * kBN;

// the diagonal tile and the pivot column; the products' k-slices reuse it
template <typename T>
struct PanelSmem {
  static constexpr int bytes = (kT * kT + kT) * (int)sizeof(T);
};
static_assert(kBK * (kBM + 1) + kBK * (kBN + 1) <= kT * kT + kT,
              "the product's k-slices fit in the diagonal tile's buffer");

// acc = A[0:64, k0:k1] B[0:128, k0:k1]^T, A and B row-major with leading
// dimensions lda and ldb. Thread (tx, ty) of 16 x 16 owns rows ty + 16 i and
// columns tx + 16 jj. Ends with a barrier, after which every read of A and B
// is complete (so a caller may overwrite A in place).
template <typename T>
__device__ __forceinline__ void gemm_nt(const T* A, size_t lda, const T* B, size_t ldb,
                                        int k0, int k1, T (&acc)[kTM][kTN], T* smem) {
  T* As = smem;                    // [kBK][kBM + 1], k-major
  T* Bs = smem + kBK * (kBM + 1);  // [kBK][kBN + 1]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int jj = 0; jj < kTN; ++jj) acc[i][jj] = T(0);
  for (int k = k0; k < k1; k += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads)
      As[(e % kBK) * (kBM + 1) + e / kBK] = A[(e / kBK) * lda + k + e % kBK];
    for (int e = tid; e < kBN * kBK; e += kThreads)
      Bs[(e % kBK) * (kBN + 1) + e / kBK] = B[(e / kBK) * ldb + k + e % kBK];
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      T a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = As[kk * (kBM + 1) + ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < kTN; ++jj) b[jj] = Bs[kk * (kBN + 1) + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int jj = 0; jj < kTN; ++jj) acc[i][jj] = gpax::fma_(a[i], b[jj], acc[i][jj]);
    }
    __syncthreads();
  }
}

// out = (C ? C : 0) + alpha acc on one 64 x 128 tile; C and out share ld.
template <typename T>
__device__ __forceinline__ void store_tile(const T (&acc)[kTM][kTN], T alpha, const T* C,
                                           T* out, size_t ld) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int jj = 0; jj < kTN; ++jj) {
      const size_t o = (size_t)(ty + 16 * i) * ld + tx + 16 * jj;
      out[o] = (C ? C[o] : T(0)) + alpha * acc[i][jj];
    }
}

// how many pieces each tile's k-range is cut into: enough for every block
// to hold one piece when the tiles are fewer than the blocks
__device__ __forceinline__ int splits(int tiles, int max_split) {
  if (tiles >= (int)gridDim.x || max_split <= 1) return 1;
  return min((int)gridDim.x / tiles, max_split);
}

// For every 64-row tile of rows [row0, row0 + 64 row_tiles) of every matrix:
//   out[r, jT:jT+128] = C[r, jT:jT+128] + alpha sum_k A[r, k] Bop[jT + c, k]
// over k in [kstart, jT), kstart = 0, or r's own panel start when A is
// upper triangular (K5's W^T). C may be null (zero). part holds gridDim.x
// tiles of partial sums.
template <typename T>
__device__ void panel_product(cg::grid_group& grid, const T* A, const T* Bop, const T* C,
                              T alpha, T* out, T* part, int batch, int n, int row0,
                              int row_tiles, int jT, bool a_upper, T* smem) {
  const size_t nn = (size_t)n * n;
  const int tiles = batch * row_tiles;
  const int S = splits(tiles, jT / kBK);
  for (int w = blockIdx.x; w < tiles * S; w += gridDim.x) {
    const int t = w / S, s = w % S;
    const size_t mb = (size_t)(t / row_tiles) * nn;
    const int r0 = row0 + (t % row_tiles) * kBM;
    const int kstart = a_upper ? (r0 / kT) * kT : 0;
    const int nk = (jT - kstart) / kBK;
    const int k0 = kstart + kBK * (s * nk / S), k1 = kstart + kBK * ((s + 1) * nk / S);
    T acc[kTM][kTN];
    gemm_nt(A + mb + (size_t)r0 * n, (size_t)n, Bop + mb + (size_t)jT * n, (size_t)n, k0, k1,
            acc, smem);
    const size_t o = mb + (size_t)r0 * n + jT;
    if (S == 1)
      store_tile(acc, alpha, C ? C + o : nullptr, out + o, (size_t)n);
    else
      store_tile(acc, T(1), (const T*)nullptr, part + (size_t)w * kTileElems, (size_t)kBN);
  }
  if (S == 1) return;
  grid.sync();
  const size_t total = (size_t)tiles * kTileElems;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const int t = (int)(e / kTileElems), w = (int)(e % kTileElems);
    T sum = 0;
    for (int s = 0; s < S; ++s) sum += part[((size_t)t * S + s) * kTileElems + w];
    const size_t o = (size_t)(t / row_tiles) * nn +
                     (size_t)(row0 + (t % row_tiles) * kBM + w / kBN) * n + jT + w % kBN;
    out[o] = (C ? C[o] : T(0)) + alpha * sum;
  }
}

// X[r, jT:jT+128] = alpha X[r, jT:jT+128] Wd_b^T in place for rows
// [row0, row0 + 64 row_tiles) of every matrix b, Wd_b = Wd + b wd_stride.
template <typename T>
__device__ void panel_trsm(T* X, const T* Wd, size_t wd_stride, T alpha, int batch, int n,
                           int row0, int row_tiles, int jT, T* smem) {
  for (int w = blockIdx.x; w < batch * row_tiles; w += gridDim.x) {
    const int b = w / row_tiles;
    T* P = X + (size_t)b * n * n + (size_t)(row0 + (w % row_tiles) * kBM) * n + jT;
    T acc[kTM][kTN];
    gemm_nt((const T*)P, (size_t)n, Wd + b * wd_stride, (size_t)kT, 0, kT, acc, smem);
    store_tile(acc, alpha, (const T*)nullptr, P, (size_t)n);
  }
}

// the row-major 128 x 128 tile at D (leading dimension n) into shared memory
template <typename T>
__device__ __forceinline__ void load_tile(const T* D, int n, T* Ts) {
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) Ts[e] = D[(size_t)(e / kT) * n + e % kT];
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
panel_cholesky_kernel(const T* __restrict__ K, T* L, T* Wd, T* part, int batch, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const size_t nn = (size_t)n * n;
  for (int jT = 0; jT < n; jT += kT) {
    // 1. the Schur update of panel j's rows >= jT (the rows above stay zero)
    panel_product(grid, (const T*)L, (const T*)L, K, T(-1), L, part, batch, n, jT,
                  (n - jT) / kBM, jT, false, smem);
    grid.sync();
    // 2. L_D and W_D of each matrix's diagonal tile, one block per matrix
    for (int b = blockIdx.x; b < batch; b += gridDim.x) {
      T* D = L + b * nn + (size_t)jT * n + jT;
      load_tile((const T*)D, n, smem);
      gpax::tile_cholesky(smem, smem + kT * kT);
      for (int e = threadIdx.x; e < kT * kT; e += kThreads)
        D[(size_t)(e / kT) * n + e % kT] = (e % kT) <= (e / kT) ? smem[e] : T(0);
      if (threadIdx.x < kT)
        gpax::tile_forward_subst((const T*)smem, Wd + (size_t)b * kT * kT, kT, threadIdx.x);
      __syncthreads();
    }
    grid.sync();
    // 3. the panel TRSM below the diagonal tile
    panel_trsm(L, (const T*)Wd, (size_t)kT * kT, T(1), batch, n, jT + kT,
               (n - jT - kT) / kBM, jT, smem);
    grid.sync();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
panel_tri_inv_t_kernel(const T* __restrict__ L, T* Wt, T* Wd, T* part, int batch, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const int nT = n / kT;
  const size_t nn = (size_t)n * n;
  // the inverses W_D of every diagonal tile, and W_D^T on W^T's diagonal
  for (int item = blockIdx.x; item < batch * nT; item += gridDim.x) {
    const int b = item / nT, jT = (item % nT) * kT;
    load_tile(L + b * nn + (size_t)jT * n + jT, n, smem);
    T* Wdj = Wd + (size_t)item * kT * kT;
    if (threadIdx.x < kT) gpax::tile_forward_subst((const T*)smem, Wdj, kT, threadIdx.x);
    __syncthreads();
    T* Dt = Wt + b * nn + (size_t)jT * n + jT;
    for (int e = threadIdx.x; e < kT * kT; e += kThreads)
      Dt[(size_t)(e / kT) * n + e % kT] = Wdj[(e % kT) * kT + e / kT];
  }
  grid.sync();
  for (int j = 1; j < nT; ++j) {
    const int jT = j * kT;
    panel_product(grid, (const T*)Wt, L, (const T*)nullptr, T(1), Wt, part, batch, n, 0,
                  jT / kBM, jT, true, smem);
    grid.sync();
    panel_trsm(Wt, (const T*)(Wd + (size_t)j * kT * kT), (size_t)nT * kT * kT, T(-1), batch, n,
               0, jT / kBM, jT, smem);
    grid.sync();
  }
}

template <typename Kernel>
int grid_blocks(Kernel kernel, int smem_bytes, int* blocks) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem_bytes);
  if (err == cudaSuccess && per_sm == 0) err = cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  return (int)err;
}

template <typename Kernel, typename T>
int launch(Kernel kernel, const T* in, T* out, T* Wd, T* part, int batch, int n, int blocks,
           cudaStream_t stream) {
  const int bytes = PanelSmem<T>::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&in, &out, &Wd, &part, &batch, &n};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(kThreads), args,
                                    bytes, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The number of blocks one cooperative launch of K4 (kernel 0) or K5
// (kernel 1) takes on the current device, in float32 (f64 = 0) or float64:
// the wrapper sizes the partial-sum scratch (blocks * 64 * 128 elements)
// from it and passes it back to the launch. Fails with cudaErrorNotSupported
// where the device has no cooperative launch.
extern "C" int gpax_panel_grid(int kernel, int f64, int* blocks) {
  if (kernel == 0)
    return f64 ? grid_blocks(panel_cholesky_kernel<double>, PanelSmem<double>::bytes, blocks)
               : grid_blocks(panel_cholesky_kernel<float>, PanelSmem<float>::bytes, blocks);
  return f64 ? grid_blocks(panel_tri_inv_t_kernel<double>, PanelSmem<double>::bytes, blocks)
             : grid_blocks(panel_tri_inv_t_kernel<float>, PanelSmem<float>::bytes, blocks);
}

// K4. K: contiguous (batch, n, n) SPD, n a multiple of 128; L: zero-filled,
// the same shape; Wd: (batch, 128, 128) scratch; part: blocks * 64 * 128
// scratch. Writes the lower Cholesky factor of each K into L.
extern "C" int gpax_panel_cholesky_f32(const float* K, float* L, float* Wd, float* part,
                                       int batch, int n, int blocks, cudaStream_t stream) {
  return launch(panel_cholesky_kernel<float>, K, L, Wd, part, batch, n, blocks, stream);
}

extern "C" int gpax_panel_cholesky_f64(const double* K, double* L, double* Wd, double* part,
                                       int batch, int n, int blocks, cudaStream_t stream) {
  return launch(panel_cholesky_kernel<double>, K, L, Wd, part, batch, n, blocks, stream);
}

// K5. L: contiguous (batch, n, n) lower triangular, n a multiple of 128;
// Wt: zero-filled, the same shape; Wd: (batch, n / 128, 128, 128) scratch;
// part as for K4. Writes W^T = L^-T (upper triangular) of each L into Wt.
extern "C" int gpax_panel_tri_inv_t_f32(const float* L, float* Wt, float* Wd, float* part,
                                        int batch, int n, int blocks, cudaStream_t stream) {
  return launch(panel_tri_inv_t_kernel<float>, L, Wt, Wd, part, batch, n, blocks, stream);
}

extern "C" int gpax_panel_tri_inv_t_f64(const double* L, double* Wt, double* Wd, double* part,
                                        int batch, int n, int blocks, cudaStream_t stream) {
  return launch(panel_tri_inv_t_kernel<double>, L, Wt, Wd, part, batch, n, blocks, stream);
}
