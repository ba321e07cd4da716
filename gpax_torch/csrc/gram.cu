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
// The float64 instantiation (gpax_gram_f64, the port's x64 mode) is the
// same kernel on doubles: exp/sqrt/fmax, double FMAs, 4 columns a lane
// stored as two 16-byte double2 stores. Its staging takes chunks of 16
// features (25.5 KB of shared memory, under the 48 KB of static shared
// memory a block may have; 32 would need 49.5 KB), and it is launched at 2
// blocks an SM (128 registers a thread) for the doubled cross terms. At
// d = 1 its bound is the n*m*8-byte store: 134 MB, 40 us, at n = m = 4096.
//
// The compensated instantiation (gpax_gram_f32c, the JAX package's
// precision="compensated" branch of _gram_kernel, pallas_gram.py:71-92 with
// _split_f32_dot_nt at :47-61) takes the cross term on the tensor cores:
// each float32 feature is split, as it is staged, into bf16 hi =
// rn(x) and lo = rn(x - hi), and the cross term is hi.hi + (hi.lo + lo.hi)
// from mma.sync m16n8k16 bf16 products with fp32 accumulators (a bf16 x
// bf16 product is exact in fp32; hi + lo carries x to 2^-16 relative, so
// with lo.lo dropped a term is off by at most 3 * 2^-16 |x||z|).
// The squared norms, the map, the noise diagonal and the 16-byte stores are
// those of the fp32 kernel: the norms are fp32 FMA chains in feature order
// read from device memory, once per tile. A block owns the same 64 x 128
// tile; its 8 warps own 32 x 32 each, 2 x 4 mma tiles of 16 x 8, with two
// sets of accumulators (hi.hi and the two cross products: 64 registers).
// The features are staged in chunks of 32, padded with zeros to a multiple
// of 16 (the mma's depth): at d = 1 the tensor cores multiply 15 zero
// features for every real one, which costs nothing in a kernel bound by
// its n*m*4-byte store. Z's rows are staged in an order within each group
// of 16 columns that gives a lane the accumulators of 4 consecutive
// columns of the group, so the output leaves as float4 stores as in the
// fp32 kernel. Shared rows are 40 bf16 apart (80 bytes), so a fragment's 8
// rows x 4 words fall in 32 distinct banks. 2 blocks an SM (at most 128
// registers a thread).
//
// Build without --use_fast_math: expf and sqrtf must be the accurate ones.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;                     // output rows per tile
constexpr int kCols = 128;                    // output columns per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kRows / kWarps;  // 8: each lane's rows
constexpr int kPass = kRowsPerWarp / 2;       // rows a lane computes at once

// per scalar type: features staged per chunk, and blocks an SM (the launch
// bound and the grid's cap)
template <typename T> struct Cfg;
template <> struct Cfg<float> { static constexpr int kDC = 32, kBlocksPerSM = 3; };
template <> struct Cfg<double> { static constexpr int kDC = 16, kBlocksPerSM = 2; };

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float max_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }

// 4 consecutive values, 16-byte aligned: one float4, or two double2
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const double* p, double v[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* p, const double v[4]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

template <int KIND, typename T>
__device__ __forceinline__ T map_r2(T r2) {
  if (KIND == 0) return exp_(T(-0.5) * r2);
  const T s5r = T(2.2360679774997896) * sqrt_(max_(r2, T(1e-10)));
  return (T(1) + s5r + (T(5) / T(3)) * r2) * exp_(-s5r);
}

template <int KIND, typename T>
__global__ void __launch_bounds__(kThreads, Cfg<T>::kBlocksPerSM)
gram_kernel(const T* __restrict__ X, const T* __restrict__ Z,
            const T* __restrict__ noise, T* __restrict__ out,
            int batch, int n, int m, int d, int add_noise) {
  constexpr int kDC = Cfg<T>::kDC;
  __shared__ __align__(16) T xs[kDC][kRows];   // feature-major
  __shared__ __align__(16) T zs[kDC][kCols];
  __shared__ __align__(16) T x2s[kRows];
  __shared__ __align__(16) T z2s[kCols];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row_tiles = (n + kRows - 1) / kRows, col_tiles = (m + kCols - 1) / kCols;
  const long long tiles = (long long)batch * row_tiles * col_tiles;
  // at least one chunk, so that d = 0 passes the same barriers
  const int chunks = max(1, (d + kDC - 1) / kDC);

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int b = (int)(t / ((long long)row_tiles * col_tiles));
    const int rc = (int)(t % ((long long)row_tiles * col_tiles));
    const int row0 = (rc / col_tiles) * kRows, col0 = (rc % col_tiles) * kCols;
    const T* Xb = X + (size_t)b * n * d;
    const T* Zb = Z + (size_t)b * m * d;
    const int col = col0 + 4 * lane;

    // the lane's 8 rows in two passes of 4, which halves the cross terms
    // held in registers; the features are staged once when they fit one
    // chunk, and again for the second pass when they do not
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      T cross[kPass][4];
#pragma unroll
      for (int i = 0; i < kPass; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v) cross[i][v] = T(0);
      T norm = T(0);  // thread tid < 64: row tid's; 64 <= tid < 192: column tid - 64's
      for (int ch = 0; ch < chunks; ++ch) {
        const int k0 = ch * kDC, kc = max(0, min(kDC, d - k0));
        if (h == 0 || chunks > 1) {
          for (int e = tid; e < kRows * kc; e += kThreads) {
            const int c = e / kRows, r = e % kRows, gr = row0 + r;
            xs[c][r] = gr < n ? Xb[(size_t)gr * d + k0 + c] : T(0);
          }
          for (int e = tid; e < kCols * kc; e += kThreads) {
            const int c = e / kCols, r = e % kCols, gc = col0 + r;
            zs[c][r] = gc < m ? Zb[(size_t)gc * d + k0 + c] : T(0);
          }
          __syncthreads();
        }
        if (h == 0) {
          if (tid < kRows) {
            for (int c = 0; c < kc; ++c) norm = fma_(xs[c][tid], xs[c][tid], norm);
          } else if (tid < kRows + kCols) {
            for (int c = 0; c < kc; ++c) norm = fma_(zs[c][tid - kRows], zs[c][tid - kRows], norm);
          }
        }
        for (int c = 0; c < kc; ++c) {
          T z[4], xv[kPass];
          load4(&zs[c][4 * lane], z);
          load4(&xs[c][kRowsPerWarp * warp + kPass * h], xv);
#pragma unroll
          for (int i = 0; i < kPass; ++i)
#pragma unroll
            for (int v = 0; v < 4; ++v) cross[i][v] = fma_(xv[i], z[v], cross[i][v]);
        }
        if (chunks > 1) __syncthreads();  // before the next chunk is staged
      }
      if (h == 0) {
        if (tid < kRows) x2s[tid] = norm;
        else if (tid < kRows + kCols) z2s[tid - kRows] = norm;
        __syncthreads();
      }
      if (col >= m) continue;
      T z2v[4];
      load4(&z2s[4 * lane], z2v);
#pragma unroll
      for (int i = 0; i < kPass; ++i) {
        const int r = kRowsPerWarp * warp + kPass * h + i, row = row0 + r;
        if (row >= n) break;
        const T x2 = x2s[r];
        T k[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          k[v] = map_r2<KIND>(max_(x2 - T(2) * cross[i][v] + z2v[v], T(0)));
          if (add_noise && row == col + v) k[v] += noise[(size_t)b * n + row];
        }
        T* o = out + ((size_t)b * n + row) * m + col;
        if (col + 4 <= m && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
          store4(o, k);
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

template <typename T>
int launch_gram(const T* X, const T* Z, const T* noise, T* out, int batch, int n, int m,
                int d, int kind, int add_noise, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles =
      (long long)batch * ((n + kRows - 1) / kRows) * ((m + kCols - 1) / kCols);
  // up to 4 waves of resident blocks, so the scheduler balances the last
  // one; a larger grid loops
  const long long cap = 4LL * sms * Cfg<T>::kBlocksPerSM;
  const int blocks = (int)(tiles < cap ? tiles : cap);
  if (kind == 0) {
    gram_kernel<0, T><<<blocks, kThreads, 0, stream>>>(X, Z, noise, out, batch, n, m, d, add_noise);
  } else {
    gram_kernel<1, T><<<blocks, kThreads, 0, stream>>>(X, Z, noise, out, batch, n, m, d, add_noise);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The compensated instantiation: bf16 hi/lo cross term on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kCompDC = 32;                 // features staged per chunk
constexpr int kCompLd = kCompDC + 8;        // shared row stride in bf16
constexpr int kCompBlocksPerSM = 2;

// D = A.B + D for a 16 x 16 bf16 A (row), a 16 x 8 bf16 B (col) and a
// 16 x 8 fp32 D. Fragments (PTX ISA, mma.m16n8k16 .bf16), g = lane / 4,
// t = lane % 4: a[0] row g, k 2t..2t+1; a[1] row g+8; a[2] row g, k
// 2t+8..2t+9; a[3] row g+8, k 2t+8..; b[0] k 2t..2t+1, column g; b[1] k
// 2t+8..; d[0..1] row g, columns 2t..2t+1; d[2..3] row g+8.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the shared row of the tile's column c: within each group of 16 columns,
// n-tile u (0, 1) holds at its fragment column g the group's column
// 4(g/2) + 2u + g%2, so that lane (g, t)'s accumulators of the group's two
// n-tiles are its columns 4t..4t+3
__device__ __forceinline__ int comp_zrow(int c) {
  const int q = c & 15;
  return (c & ~15) + 8 * ((q >> 1) & 1) + 2 * (q >> 2) + (q & 1);
}

__device__ __forceinline__ void split_store(float v, __nv_bfloat16* hi, __nv_bfloat16* lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  *hi = h;
  *lo = __float2bfloat16_rn(v - __bfloat162float(h));
}

template <int KIND>
__global__ void __launch_bounds__(kThreads, kCompBlocksPerSM)
gram_comp_kernel(const float* __restrict__ X, const float* __restrict__ Z,
                 const float* __restrict__ noise, float* __restrict__ out,
                 int batch, int n, int m, int d, int add_noise) {
  __shared__ __align__(16) __nv_bfloat16 xh[kRows][kCompLd];
  __shared__ __align__(16) __nv_bfloat16 xl[kRows][kCompLd];
  __shared__ __align__(16) __nv_bfloat16 zh[kCols][kCompLd];
  __shared__ __align__(16) __nv_bfloat16 zl[kCols][kCompLd];
  __shared__ __align__(16) float x2s[kRows];
  __shared__ __align__(16) float z2s[kCols];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = 32 * (warp / 4), wc = 32 * (warp % 4);  // the warp's 32 x 32
  const int row_tiles = (n + kRows - 1) / kRows, col_tiles = (m + kCols - 1) / kCols;
  const long long tiles = (long long)batch * row_tiles * col_tiles;
  const int chunks = max(1, (d + kCompDC - 1) / kCompDC);

  for (long long tt = blockIdx.x; tt < tiles; tt += gridDim.x) {
    const int b = (int)(tt / ((long long)row_tiles * col_tiles));
    const int rc = (int)(tt % ((long long)row_tiles * col_tiles));
    const int row0 = (rc / col_tiles) * kRows, col0 = (rc % col_tiles) * kCols;
    const float* Xb = X + (size_t)b * n * d;
    const float* Zb = Z + (size_t)b * m * d;

    // full fp32 squared norms, in feature order, as in the fp32 kernel
    if (tid < kRows + kCols) {
      const bool is_row = tid < kRows;
      const int r = is_row ? row0 + tid : col0 + tid - kRows;
      const float* p = is_row ? Xb + (size_t)r * d : Zb + (size_t)r * d;
      float s = 0.f;
      if (r < (is_row ? n : m))
        for (int c = 0; c < d; ++c) s = fmaf(p[c], p[c], s);
      if (is_row) x2s[tid] = s; else z2s[tid - kRows] = s;
    }

    float hh[2][4][4], cr[2][4][4];  // hi.hi, and hi.lo + lo.hi
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) hh[i][j][v] = cr[i][j][v] = 0.f;

    for (int ch = 0; ch < chunks; ++ch) {
      const int k0 = ch * kCompDC, kc = max(0, min(kCompDC, d - k0));
      const int kshift = kc > 16 ? 5 : 4, kcp = kc > 0 ? 1 << kshift : 0;
      for (int e = tid; e < kRows * kcp; e += kThreads) {
        const int r = e >> kshift, c = e & (kcp - 1), gr = row0 + r;
        const float v = (gr < n && c < kc) ? Xb[(size_t)gr * d + k0 + c] : 0.f;
        split_store(v, &xh[r][c], &xl[r][c]);
      }
      for (int e = tid; e < kCols * kcp; e += kThreads) {
        const int r = e >> kshift, c = e & (kcp - 1), gc = col0 + r, zr = comp_zrow(r);
        const float v = (gc < m && c < kc) ? Zb[(size_t)gc * d + k0 + c] : 0.f;
        split_store(v, &zh[zr][c], &zl[zr][c]);
      }
      __syncthreads();
      for (int ks = 0; ks < kcp; ks += 16) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = wr + 16 * i + g;
          ah[i][0] = ld_pair(&xh[r][ks + 2 * t]);
          ah[i][1] = ld_pair(&xh[r + 8][ks + 2 * t]);
          ah[i][2] = ld_pair(&xh[r][ks + 2 * t + 8]);
          ah[i][3] = ld_pair(&xh[r + 8][ks + 2 * t + 8]);
          al[i][0] = ld_pair(&xl[r][ks + 2 * t]);
          al[i][1] = ld_pair(&xl[r + 8][ks + 2 * t]);
          al[i][2] = ld_pair(&xl[r][ks + 2 * t + 8]);
          al[i][3] = ld_pair(&xl[r + 8][ks + 2 * t + 8]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int zr = wc + 8 * j + g;
          const uint32_t bh[2] = {ld_pair(&zh[zr][ks + 2 * t]), ld_pair(&zh[zr][ks + 2 * t + 8])};
          const uint32_t bl[2] = {ld_pair(&zl[zr][ks + 2 * t]), ld_pair(&zl[zr][ks + 2 * t + 8])};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_bf16(hh[i][j], ah[i], bh);
            mma_bf16(cr[i][j], ah[i], bl);
            mma_bf16(cr[i][j], al[i], bh);
          }
        }
      }
      __syncthreads();  // before the next chunk is staged, and the norms are read
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = wr + 16 * i + g + 8 * h, row = row0 + rl;
        if (row >= n) continue;
        const float x2 = x2s[rl];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int cl = wc + 16 * p + 4 * t, col = col0 + cl;
          if (col >= m) continue;
          float k[4];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int j = 2 * p + v / 2, e = 2 * h + v % 2;
            const float cross = hh[i][j][e] + cr[i][j][e];
            k[v] = map_r2<KIND>(fmaxf(x2 - 2.f * cross + z2s[cl + v], 0.f));
            if (add_noise && row == col + v) k[v] += noise[(size_t)b * n + row];
          }
          float* o = out + ((size_t)b * n + row) * m + col;
          if (col + 4 <= m && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
            store4(o, k);
          } else {
#pragma unroll
            for (int v = 0; v < 4; ++v)
              if (col + v < m) o[v] = k[v];
          }
        }
      }
    }
    __syncthreads();  // the tile's reads of the norms end before the next tile's
  }
}

int launch_gram_comp(const float* X, const float* Z, const float* noise, float* out,
                     int batch, int n, int m, int d, int kind, int add_noise,
                     cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles =
      (long long)batch * ((n + kRows - 1) / kRows) * ((m + kCols - 1) / kCols);
  const long long cap = 4LL * sms * kCompBlocksPerSM;
  const int blocks = (int)(tiles < cap ? tiles : cap);
  if (kind == 0) {
    gram_comp_kernel<0><<<blocks, kThreads, 0, stream>>>(X, Z, noise, out, batch, n, m, d, add_noise);
  } else {
    gram_comp_kernel<1><<<blocks, kThreads, 0, stream>>>(X, Z, noise, out, batch, n, m, d, add_noise);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// kind: 0 = RBF, 1 = Matern-5/2. All pointers are device pointers to
// contiguous float32 (gpax_gram_f32) or float64 (gpax_gram_f64): X (batch,
// n, d), Z (batch, m, d), noise (batch, n), out (batch, n, m). Returns the
// first CUDA error of the device query or cudaGetLastError() after the
// launch.
extern "C" int gpax_gram_f32(const float* X, const float* Z, const float* noise,
                             float* out, int batch, int n, int m, int d,
                             int kind, int add_noise, cudaStream_t stream) {
  return launch_gram<float>(X, Z, noise, out, batch, n, m, d, kind, add_noise, stream);
}

// K1's compensated instantiation: float32 pointers as gpax_gram_f32, the
// cross term from bf16 hi/lo products on the tensor cores.
extern "C" int gpax_gram_f32c(const float* X, const float* Z, const float* noise,
                              float* out, int batch, int n, int m, int d,
                              int kind, int add_noise, cudaStream_t stream) {
  return launch_gram_comp(X, Z, noise, out, batch, n, m, d, kind, add_noise, stream);
}

extern "C" int gpax_gram_f64(const double* X, const double* Z, const double* noise,
                             double* out, int batch, int n, int m, int d,
                             int kind, int add_noise, cudaStream_t stream) {
  return launch_gram<double>(X, Z, noise, out, batch, n, m, d, kind, add_noise, stream);
}
