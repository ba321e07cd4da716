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
// Layout: one thread per output element, 32 x 8 threads per block, so each
// warp stores 32 neighbouring floats of one output row (128-byte stores).
// A block stages its 8 rows of Xs and 32 rows of Zs, a feature chunk of 32
// at a time, in shared memory together with their squared norms, so any d
// works. The cross term is a plain fp32 FMA chain: the "highest" precision
// contract of the JAX package, with no TF32 or bf16 anywhere.
//
// What bounds it on an H100: at the main path's d = 1 each element costs a
// handful of FMAs and one expf, and the n*m*4-byte output store dominates
// (64 MB at n = m = 4096, about 20 us of HBM bandwidth). The design keeps
// that store the only full-size traffic: the norms, the map and the
// diagonal add are fused into the epilogue (no second pass over the gram,
// no scatter for the diagonal), and the inputs are read once per block
// from shared memory. A batch dimension (grid.z) makes a chunk of posterior
// draws one launch.
//
// Build without --use_fast_math: expf and sqrtf must be the accurate ones.

#include <cuda_runtime.h>

namespace {

constexpr int kBX = 32;  // output columns per block
constexpr int kBY = 8;   // output rows per block
constexpr int kDC = 32;  // features staged per chunk
constexpr float kSqrt5 = 2.2360679774997896f;

template <int KIND>
__global__ void __launch_bounds__(kBX * kBY)
gram_kernel(const float* __restrict__ X, const float* __restrict__ Z,
            const float* __restrict__ noise, float* __restrict__ out,
            int n, int m, int d, int add_noise) {
  __shared__ float xs[kBY][kDC + 1];
  __shared__ float zs[kBX][kDC + 1];
  __shared__ float x2s[kBY];
  __shared__ float z2s[kBX];

  const int b = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kBX + tx;
  const int row0 = blockIdx.y * kBY, col0 = blockIdx.x * kBX;
  X += (size_t)b * n * d;
  Z += (size_t)b * m * d;

  if (tid < kBY) x2s[tid] = 0.f;
  if (tid < kBX) z2s[tid] = 0.f;

  float cross = 0.f;
  for (int k0 = 0; k0 < d; k0 += kDC) {
    const int kc = min(kDC, d - k0);
    // stage only the kc live features of the chunk (kc = 1 on the main path)
    for (int e = tid; e < kBY * kc; e += kBX * kBY) {
      const int r = e / kc, c = e % kc, gr = row0 + r;
      xs[r][c] = gr < n ? X[(size_t)gr * d + k0 + c] : 0.f;
    }
    for (int e = tid; e < kBX * kc; e += kBX * kBY) {
      const int r = e / kc, c = e % kc, gc = col0 + r;
      zs[r][c] = gc < m ? Z[(size_t)gc * d + k0 + c] : 0.f;
    }
    __syncthreads();
    // warp 0 accumulates the row norms, warp 1 the column norms
    if (tid < kBY) {
      float s = x2s[tid];
      for (int c = 0; c < kc; ++c) s = fmaf(xs[tid][c], xs[tid][c], s);
      x2s[tid] = s;
    } else if (tid >= 32 && tid < 32 + kBX) {
      const int r = tid - 32;
      float s = z2s[r];
      for (int c = 0; c < kc; ++c) s = fmaf(zs[r][c], zs[r][c], s);
      z2s[r] = s;
    }
    for (int c = 0; c < kc; ++c) cross = fmaf(xs[ty][c], zs[tx][c], cross);
    __syncthreads();
  }

  const int row = row0 + ty, col = col0 + tx;
  if (row >= n || col >= m) return;  // ragged edge
  const float r2 = fmaxf(x2s[ty] - 2.0f * cross + z2s[tx], 0.0f);
  float k;
  if (KIND == 0) {
    k = expf(-0.5f * r2);
  } else {
    const float s5r = kSqrt5 * sqrtf(fmaxf(r2, 1e-10f));
    k = (1.0f + s5r + (5.0f / 3.0f) * r2) * expf(-s5r);
  }
  if (add_noise && row == col) k += noise[(size_t)b * n + row];
  out[((size_t)b * n + row) * m + col] = k;
}

}  // namespace

// kind: 0 = RBF, 1 = Matern-5/2. All pointers are device pointers to
// contiguous float32: X (batch, n, d), Z (batch, m, d), noise (batch, n),
// out (batch, n, m). Returns cudaGetLastError() after the launch.
extern "C" int gpax_gram_f32(const float* X, const float* Z, const float* noise,
                             float* out, int batch, int n, int m, int d,
                             int kind, int add_noise, cudaStream_t stream) {
  const dim3 block(kBX, kBY);
  const dim3 grid((m + kBX - 1) / kBX, (n + kBY - 1) / kBY, batch);
  if (kind == 0) {
    gram_kernel<0><<<grid, block, 0, stream>>>(X, Z, noise, out, n, m, d, add_noise);
  } else {
    gram_kernel<1><<<grid, block, 0, stream>>>(X, Z, noise, out, n, m, d, add_noise);
  }
  return (int)cudaGetLastError();
}
