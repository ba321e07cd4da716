// K1: fused stationary gram for Hopper (sm_90a).
//
// Replaces gpax_tpu/ops/pallas_gram.py::_gram_kernel (launched by
// pallas_gram). For pre-scaled inputs Xs (B, n, d) and Zs (B, m, d) it writes
//
//     out[b, i, j] = map(max(|xs_i|^2 - 2 xs_i . zs_j + |zs_j|^2, 0))
//                    + noise[b, i] * [i == j]          (only when add_noise)
//
// with map(r2) = exp(-r2/2) (RBF) or (1 + sqrt5 r + 5/3 r2) exp(-sqrt5 r),
// r = sqrt(max(r2, 1e-10)) (Matern-5/2). The caller applies k_scale.
//
// What bounds it on an H100: at the main path's d = 1 each element costs a
// handful of FMAs and one expf, so the n*m*4-byte output store is the bound
// (64 MB at n = m = 4096, 20 us at the HBM rate). A kernel that computes one
// element per thread, in 8 x 32 blocks, took 5.4x that bound on the card:
// at 65 536 blocks for n = m = 4096, each block's staging, two barriers and
// norm warps for 256 four-byte stores cost more than the stores. So:
//
//   - A block owns 64 rows x 128 columns of one matrix; each of its 8 warps
//     owns 8 rows, each lane 4 consecutive columns of them, and stores them
//     with one 16-byte store a row: a warp writes 512 contiguous bytes of a
//     row per store. The row and column norms are computed once per tile
//     into shared memory.
//   - The grid is a grid-stride loop over (batch, row tile, column tile),
//     at most 4 waves of resident blocks: n = m = 4096 is 2048 tiles on
//     1584 blocks, and a batch of B 1 x 1 grams (the sparse GP's k(x, x)
//     diagonal) costs B / 1584 passes of each block, not B blocks.
//   - A lane computes its 8 rows in two passes of 4, kept as a loop, so
//     that the cross terms, the norms and the map's temporaries fit in 85
//     registers (3 blocks an SM). At 64 registers (4 blocks an SM) the
//     kernel spilled and took longer on the card (PERF.md).
//   - A row whose 4-column group is not 16-byte aligned (m % 4 != 0, or a
//     ragged last group) is stored element by element: any n, m and d work.
//
// The features are staged in chunks of 32, feature-major, so the cross term
// reads one broadcast per row and one float4 per 4 columns. The cross term
// is a plain fp32 FMA chain in feature order, and the squared norms too, as
// in the one-element-per-thread form: the "highest" precision contract of
// the JAX package, with no TF32 or bf16 anywhere. The noise add stays fused
// on the global diagonal.
//
// Build without --use_fast_math: expf and sqrtf must be the accurate ones.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;                     // output rows per tile
constexpr int kCols = 128;                    // output columns per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kRows / kWarps;  // 8: each lane's rows
constexpr int kPass = kRowsPerWarp / 2;       // rows a lane computes at once
constexpr int kDC = 32;                       // features staged per chunk
constexpr int kBlocksPerSM = 3;               // the launch bound and the grid's cap
constexpr float kSqrt5 = 2.2360679774997896f;

template <int KIND>
__device__ __forceinline__ float map_r2(float r2) {
  if (KIND == 0) return expf(-0.5f * r2);
  const float s5r = kSqrt5 * sqrtf(fmaxf(r2, 1e-10f));
  return (1.0f + s5r + (5.0f / 3.0f) * r2) * expf(-s5r);
}

template <int KIND>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
gram_kernel(const float* __restrict__ X, const float* __restrict__ Z,
            const float* __restrict__ noise, float* __restrict__ out,
            int batch, int n, int m, int d, int add_noise) {
  __shared__ __align__(16) float xs[kDC][kRows];   // feature-major
  __shared__ __align__(16) float zs[kDC][kCols];
  __shared__ __align__(16) float x2s[kRows];
  __shared__ __align__(16) float z2s[kCols];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row_tiles = (n + kRows - 1) / kRows, col_tiles = (m + kCols - 1) / kCols;
  const long long tiles = (long long)batch * row_tiles * col_tiles;
  // at least one chunk, so that d = 0 passes the same barriers
  const int chunks = max(1, (d + kDC - 1) / kDC);

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int b = (int)(t / ((long long)row_tiles * col_tiles));
    const int rc = (int)(t % ((long long)row_tiles * col_tiles));
    const int row0 = (rc / col_tiles) * kRows, col0 = (rc % col_tiles) * kCols;
    const float* Xb = X + (size_t)b * n * d;
    const float* Zb = Z + (size_t)b * m * d;
    const int col = col0 + 4 * lane;

    // the lane's 8 rows in two passes of 4, which halves the cross terms
    // held in registers; the features are staged once when they fit one
    // chunk, and again for the second pass when they do not
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      float cross[kPass][4];
#pragma unroll
      for (int i = 0; i < kPass; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v) cross[i][v] = 0.f;
      float norm = 0.f;  // thread tid < 64: row tid's; 64 <= tid < 192: column tid - 64's
      for (int ch = 0; ch < chunks; ++ch) {
        const int k0 = ch * kDC, kc = max(0, min(kDC, d - k0));
        if (h == 0 || chunks > 1) {
          for (int e = tid; e < kRows * kc; e += kThreads) {
            const int c = e / kRows, r = e % kRows, gr = row0 + r;
            xs[c][r] = gr < n ? Xb[(size_t)gr * d + k0 + c] : 0.f;
          }
          for (int e = tid; e < kCols * kc; e += kThreads) {
            const int c = e / kCols, r = e % kCols, gc = col0 + r;
            zs[c][r] = gc < m ? Zb[(size_t)gc * d + k0 + c] : 0.f;
          }
          __syncthreads();
        }
        if (h == 0) {
          if (tid < kRows) {
            for (int c = 0; c < kc; ++c) norm = fmaf(xs[c][tid], xs[c][tid], norm);
          } else if (tid < kRows + kCols) {
            for (int c = 0; c < kc; ++c) norm = fmaf(zs[c][tid - kRows], zs[c][tid - kRows], norm);
          }
        }
        for (int c = 0; c < kc; ++c) {
          const float4 z = *reinterpret_cast<const float4*>(&zs[c][4 * lane]);
          const float4 x = *reinterpret_cast<const float4*>(&xs[c][kRowsPerWarp * warp + kPass * h]);
          const float xv[kPass] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int i = 0; i < kPass; ++i) {
            cross[i][0] = fmaf(xv[i], z.x, cross[i][0]);
            cross[i][1] = fmaf(xv[i], z.y, cross[i][1]);
            cross[i][2] = fmaf(xv[i], z.z, cross[i][2]);
            cross[i][3] = fmaf(xv[i], z.w, cross[i][3]);
          }
        }
        if (chunks > 1) __syncthreads();  // before the next chunk is staged
      }
      if (h == 0) {
        if (tid < kRows) x2s[tid] = norm;
        else if (tid < kRows + kCols) z2s[tid - kRows] = norm;
        __syncthreads();
      }
      if (col >= m) continue;
      const float4 z2 = *reinterpret_cast<const float4*>(&z2s[4 * lane]);
      const float z2v[4] = {z2.x, z2.y, z2.z, z2.w};
#pragma unroll
      for (int i = 0; i < kPass; ++i) {
        const int r = kRowsPerWarp * warp + kPass * h + i, row = row0 + r;
        if (row >= n) break;
        const float x2 = x2s[r];
        float k[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          k[v] = map_r2<KIND>(fmaxf(x2 - 2.0f * cross[i][v] + z2v[v], 0.0f));
          if (add_noise && row == col + v) k[v] += noise[(size_t)b * n + row];
        }
        float* o = out + ((size_t)b * n + row) * m + col;
        if (col + 4 <= m && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
          *reinterpret_cast<float4*>(o) = make_float4(k[0], k[1], k[2], k[3]);
        } else {
#pragma unroll
          for (int v = 0; v < 4; ++v)
            if (col + v < m) o[v] = k[v];
        }
      }
    }
    __syncthreads();  // the tile's reads of shared memory end before the next tile's staging
  }
}

}  // namespace

// kind: 0 = RBF, 1 = Matern-5/2. All pointers are device pointers to
// contiguous float32: X (batch, n, d), Z (batch, m, d), noise (batch, n),
// out (batch, n, m). Returns the first CUDA error of the device query or
// cudaGetLastError() after the launch.
extern "C" int gpax_gram_f32(const float* X, const float* Z, const float* noise,
                             float* out, int batch, int n, int m, int d,
                             int kind, int add_noise, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles =
      (long long)batch * ((n + kRows - 1) / kRows) * ((m + kCols - 1) / kCols);
  // up to 4 waves of resident blocks, so the scheduler balances the last
  // one; a larger grid loops
  const long long cap = 4LL * sms * kBlocksPerSM;
  const int blocks = (int)(tiles < cap ? tiles : cap);
  if (kind == 0) {
    gram_kernel<0><<<blocks, kThreads, 0, stream>>>(X, Z, noise, out, batch, n, m, d, add_noise);
  } else {
    gram_kernel<1><<<blocks, kThreads, 0, stream>>>(X, Z, noise, out, batch, n, m, d, add_noise);
  }
  return (int)cudaGetLastError();
}
