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
//      than blocks, each tile's k-range is split (Pieces) and the partial
//      sums are added by a second pass after a barrier (split-K, in a fixed
//      order, so the result does not depend on the schedule);
//   2. one block per matrix factors the 128 x 128 diagonal tile of P in
//      shared memory, blocked (tile_chol_blocked.cuh), and writes L_D
//      (zero above the diagonal) into L and its inverse W_D to scratch;
//   3. the panel TRSM L[rows > diagonal tile, panel j] = P W_D^T, in place:
//      each 64-row tile reads all 128 columns of its rows before it writes.
// K5 first inverts every diagonal tile of L at once (they are independent),
// one block a tile on the blocked routine's inverse half
// (tile_chol_blocked.cuh), writing W_D^T onto W^T's diagonal and W_D to
// scratch, then for each panel j in order:
//   1. acc = W^T[rows < 128j, :128j] L[panel j rows, :128j]^T, skipping the
//      zeros of the upper-triangular W^T (row r starts at its own panel),
//      split along k into pieces of about equal length (Pieces);
//   2. W^T[rows < 128j, panel j] = -acc W_D^T, in place.
// Both products are A B^T with A and B read along rows, k contiguous, so the
// loads of every phase are coalesced in row-major storage; W^T is kept (the
// TPU kernel's buffer), which makes K5's products the same shape as K4's.
//
// What bounds them on an H100: each does n^3/3 flops (0.34 ms at n = 4096 at
// 67 TFLOP/s) and moves 2 n^2 elements (0.08 ms in float64), but neither
// bound is near. What is:
//   - K4's diagonal tiles are sequential: n / 128 factorizations, each on
//     one SM while the others wait at a grid barrier. The blocked step
//     takes 3 block barriers per 16-column sub-panel where K3's loop takes
//     2 per column, inverts the tile in shared memory with register-tiled
//     products and writes W_D once; its 128 pivots (an IEEE sqrt and a
//     division each, in one warp) remain one dependent chain.
//   - The products. In float64 they run on the tensor cores: mma.sync
//     m8n8k4 with .f64 operands (DMMA), each warp a 32 x 32 quarter of the
//     64 x 128 tile. Hopper's wgmma has no float64 type, so the warp-level
//     mma.sync is its only float64 tensor-core path. The 16-deep k-slices
//     go through shared memory, padded so that the fragment loads hit
//     distinct banks, the next slice's loads in flight in registers. One
//     block an SM (the tile's 133 KB) leaves 8 warps to hide latency, and
//     there is no deeper pipeline. Float32 stays on CUDA-core FMA, because
//     the port keeps TF32 off: its k-slices come by cp.async into a ring of
//     4 stages and are read as float4 along k (gemm_nt).
//   - About 3 n / 128 grid barriers, and the split-K passes of the late
//     panels. The left-looking products also re-read ~n^3 / (2 * 128)
//     elements of the left factor, through L2. K5's panels have fewer row
//     tiles (j for panel j) than blocks, so each goes through split-K, cut
//     in proportion to the rows' k-ranges so that the top tile's range
//     does not set the panel's time.
// Measured times and the phase splits (phase_ns): PERF.md. In float64 one
// block fits an SM (133 KB of shared memory), in float32 two (its launch
// bound; shared memory would allow three).
//
// The pivot is the IEEE sqrt and division, and nothing is clamped: an
// indefinite matrix's first bad pivot gives NaN in L_D and W_D from its
// column on, which every later panel of L and W picks up through the
// products. K5 adds each row's poison (gpax::row_poison: 0, or NaN from a
// zero or NaN pivot on) to every entry of W_D's row it stores, as K2 does,
// so the rows of W from a bad pivot on are non-finite in every column up
// to the end of its panel, as the TPU kernel's row recurrence makes them,
// and the rows above it are unchanged.
//
// Memory visibility: K is the only read-only operand (__restrict__); L, W^T
// and the scratch are written and read again by other blocks after a grid
// barrier, so they are plain pointers and never read through the
// non-coherent read-only cache.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tile_chol_blocked.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kT = gpax::kTile;                  // panel width
constexpr int kThreads = gpax::kBlockedThreads;  // 256: the diagonal step's block
constexpr int kBM = 64, kBN = kT, kBK = 16;      // product tile: 64 rows x the panel
constexpr int kTM = kBM / 16, kTN = kBN / 16;    // 4 x 8 outputs per thread (float32)
constexpr int kTileElems = kBM * kBN;

// A block's shared memory: the diagonal tile, its pivots and K5's row
// poisons; the products' k-slices reuse it.
template <typename T>
using Smem = gpax::TileSmem<T>;

// The accumulator of one 64 x 128 product tile, in the registers of the
// block's 256 threads; each(f) calls f(row, column, value) for the thread's
// entries.
template <typename T>
struct Acc;

// float32, on CUDA-core FMA: thread (tx, ty) of 16 x 16 owns rows ty + 16 i
// and columns tx + 16 jj
template <>
struct Acc<float> {
  float v[kTM][kTN];
  template <typename F>
  __device__ __forceinline__ void each(F f) const {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int jj = 0; jj < kTN; ++jj) f(ty + 16 * i, tx + 16 * jj, v[i][jj]);
  }
};

// float64, on the tensor cores (mma.sync m8n8k4, DMMA): warp (wm, wn) of
// 2 x 4 owns a 32 x 32 quarter-row of the tile, as 4 x 4 fragments of
// 8 x 8; lane (g, t) = (lane / 4, lane % 4) holds row g, columns 2t and
// 2t + 1 of each fragment
template <>
struct Acc<double> {
  double v[4][4][2];
  template <typename F>
  __device__ __forceinline__ void each(F f) const {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int r0 = 32 * (warp / 4) + lane / 4, c0 = 32 * (warp % 4) + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) f(r0 + 8 * i, c0 + 8 * j + e, v[i][j][e]);
  }
};

// 16-byte copies from global to shared memory that bypass the registers
// and L1 (cp.async.cg: through L2, which the other blocks' writes reach
// before a grid barrier), in commit groups that a thread waits for
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The float32 k-slices: a ring of kStages stages in shared memory, each the
// 64 rows of A and the 128 rows of B over 16 k, row-major with rows padded
// to 20 floats, so that 16-byte reads along k from 8 consecutive rows fall
// in 8 distinct groups of 4 banks.
constexpr int kLdF = kBK + 4;
constexpr int kStages = 4;
constexpr int kStageF = (kBM + kBN) * kLdF;
static_assert(kStages * kStageF * (int)sizeof(float) <= Smem<float>::bytes,
              "the float32 k-slice ring fits in the diagonal tile's buffer");

// acc = A[0:64, k0:k1] B[0:128, k0:k1]^T, A and B row-major with leading
// dimensions lda and ldb, k0 and k1 multiples of 16. Each ends with a
// barrier, after which every read of A and B is complete (so a caller may
// overwrite A in place).
//
// Float32 runs on CUDA-core FMA, not the tensor cores: the port keeps TF32
// off (it would round the operands to 10 bits), so the card's float32 peak
// is 67 TFLOP/s of FFMA. Each thread copies 3 of a slice's 768 16-byte
// pieces with cp.async, kStages - 1 slices ahead of the one the block
// multiplies, so the next slices' loads are in flight during the FMAs and
// a slice costs one barrier. A thread reads its 4 rows of A and, one at a
// time, its 8 rows of B as float4 along k: 12 16-byte shared loads for 128
// FMAs every 4 k (the 8 lanes of a quarter-warp read 8 consecutive B rows,
// conflict-free, and one A row, a broadcast). Each entry's FMAs run in k
// order.
__device__ __forceinline__ void gemm_nt(const float* A, size_t lda, const float* B, size_t ldb,
                                        int k0, int k1, Acc<float>& acc, float* smem) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int jj = 0; jj < kTN; ++jj) acc.v[i][jj] = 0.0f;
  // this thread's pieces: row cr of A, rows cr and cr + 64 of B, k offset cc
  const int cr = tid / 4, cc = 4 * (tid % 4), slices = (k1 - k0) / kBK;
  const float* a_src = A + cr * lda + k0 + cc;
  const float* b_src = B + cr * ldb + k0 + cc;
  const size_t b_half = 64 * ldb;
  auto issue = [&](int s) {
    if (s < slices) {
      float* st = smem + (s % kStages) * kStageF;
      cp_async16(st + cr * kLdF + cc, a_src + s * kBK);
      cp_async16(st + (kBM + cr) * kLdF + cc, b_src + s * kBK);
      cp_async16(st + (kBM + 64 + cr) * kLdF + cc, b_src + b_half + s * kBK);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int s = 0; s < slices; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's pieces of slice s have landed
    __syncthreads();               // everyone's have, and slice s - 1 is done
    issue(s + kStages - 1);        // into slice s - 1's stage
    const float* As = smem + (s % kStages) * kStageF;
    const float* Bs = As + kBM * kLdF;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 a[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + (ty + 16 * i) * kLdF + kk);
#pragma unroll
      for (int jj = 0; jj < kTN; ++jj) {
        const float4 b = *reinterpret_cast<const float4*>(Bs + (tx + 16 * jj) * kLdF + kk);
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          float& c = acc.v[i][jj];
          c = fmaf(a[i].x, b.x, c);
          c = fmaf(a[i].y, b.y, c);
          c = fmaf(a[i].z, b.z, c);
          c = fmaf(a[i].w, b.w, c);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

constexpr int kLd = kBK + 4;  // a float64 k-slice row, padded: fragment loads hit 16 bank pairs
static_assert((kBM + kBN) * kLd <= kT * kT + kT, "the float64 k-slices fit in the tile's buffer");

// The float64 slices are row-major [row][k] (A: 64 rows, B: 128), moved as
// 16-byte pairs, the next slice's loads from global memory in flight in
// registers while the tensor cores work on this one.
__device__ __forceinline__ void gemm_nt(const double* A, size_t lda, const double* B, size_t ldb,
                                        int k0, int k1, Acc<double>& acc, double* smem) {
  constexpr int kPairs = kBK / 2;                       // 16-byte pairs in a slice row
  constexpr int kAp = kBM * kPairs / kThreads, kBp = kBN * kPairs / kThreads;  // 2, 4
  double* As = smem;              // [kBM][kLd]
  double* Bs = smem + kBM * kLd;  // [kBN][kLd]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ar = 32 * (warp / 4) + lane / 4, br = 32 * (warp % 4) + lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc.v[i][j][0] = acc.v[i][j][1] = 0.0;
  double2 ra[kAp], rb[kBp];
  auto fetch = [&](int k) {
#pragma unroll
    for (int i = 0; i < kAp; ++i) {
      const int e = tid + i * kThreads;
      ra[i] = *reinterpret_cast<const double2*>(A + (e / kPairs) * lda + k + 2 * (e % kPairs));
    }
#pragma unroll
    for (int i = 0; i < kBp; ++i) {
      const int e = tid + i * kThreads;
      rb[i] = *reinterpret_cast<const double2*>(B + (e / kPairs) * ldb + k + 2 * (e % kPairs));
    }
  };
  if (k0 < k1) fetch(k0);
  for (int k = k0; k < k1; k += kBK) {
#pragma unroll
    for (int i = 0; i < kAp; ++i) {
      const int e = tid + i * kThreads;
      *reinterpret_cast<double2*>(As + (e / kPairs) * kLd + 2 * (e % kPairs)) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < kBp; ++i) {
      const int e = tid + i * kThreads;
      *reinterpret_cast<double2*>(Bs + (e / kPairs) * kLd + 2 * (e % kPairs)) = rb[i];
    }
    __syncthreads();
    if (k + kBK < k1) fetch(k + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      double a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(ar + 8 * i) * kLd + kk + t];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[(br + 8 * j) * kLd + kk + t];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) gpax::dmma_8x8x4(acc.v[i][j], a[i], b[j]);
    }
    __syncthreads();
  }
}

// out = (C ? C : 0) + alpha acc on one 64 x 128 tile; C and out share ld.
template <typename T>
__device__ __forceinline__ void store_tile(const Acc<T>& acc, T alpha, const T* C, T* out,
                                           size_t ld) {
  acc.each([&](int r, int c, T v) {
    const size_t o = (size_t)r * ld + c;
    out[o] = (C ? C[o] : T(0)) + alpha * v;
  });
}

// How one panel's product is cut along k: the tiles are the 64-row tiles u
// of rows [row0, row0 + 64 rt) of each matrix, tile u's k-range is
// [kstart(u), jT). When the tiles (batch * rt) are at least the blocks,
// each tile is one piece. Otherwise each block holds at most one piece,
// and a second pass sums each tile's pieces in order (split-K):
//   - uniform k-ranges (K4): each tile is cut into S = blocks / tiles
//     equal pieces;
//   - K5's upper-triangular A, whose row tile u starts at its own panel:
//     the top tile's range is jT and the two tiles at the diagonal have
//     128, so each tile is cut into ceil(slices(u) / len) pieces of about
//     equal length, len the least number of k-slices for which the pieces
//     are at most the blocks in all (a binary search): pieces in
//     proportion to the range, and the longest as short as equal pieces
//     allow.
// A matrix's pieces are numbered tile by tile; the sums over tiles are
// taken by every warp at once (every lane gets them), so no barrier is
// needed.
struct Pieces {
  int rt, row0, jT, S, len, per_matrix;  // S: pieces a tile when uniform, else 0
  bool upper;

  __device__ int kstart(int u) const { return upper ? ((row0 + u * kBM) / kT) * kT : 0; }
  __device__ int slices(int u) const { return (jT - kstart(u)) / kBK; }
  __device__ int count(int u) const { return S ? S : (slices(u) + len - 1) / len; }

  // sum of f(u) over u < end
  template <typename F>
  __device__ int warp_sum(int end, F f) const {
    int sum = 0;
    for (int u0 = 0; u0 < end; u0 += 32) {
      const int u = u0 + threadIdx.x % 32;
      sum += __reduce_add_sync(gpax::kFullWarp, u < end ? f(u) : 0);
    }
    return sum;
  }

  __device__ Pieces(int batch, int rt_, int row0_, int jT_, bool upper_)
      : rt(rt_), row0(row0_), jT(jT_), S(0), len(1), upper(upper_) {
    const int tiles = batch * rt, blocks = gridDim.x;
    if (tiles >= blocks) {
      S = 1;
    } else if (!upper) {
      S = max(1, min(blocks / tiles, jT / kBK));
    } else {
      int lo = 1, hi = slices(0);  // the top tile's range is the longest
      while (lo < hi) {
        len = (lo + hi) / 2;
        if (batch * warp_sum(rt, [&](int u) { return count(u); }) <= blocks)
          hi = len;
        else
          lo = len + 1;
      }
      len = lo;
    }
    per_matrix = S ? rt * S : warp_sum(rt, [&](int u) { return count(u); });
  }

  // the pieces of a matrix's tiles before tile u
  __device__ int before(int u) const {
    return S ? u * S : warp_sum(u, [&](int v) { return count(v); });
  }

  // the tile of a matrix's piece q (< per_matrix); first: its first piece
  __device__ int tile_of(int q, int& first) const {
    if (S) {
      first = q - q % S;
      return q / S;
    }
    const int lane = threadIdx.x % 32;
    for (int u0 = 0, base = 0;; u0 += 32) {
      const int u = u0 + lane, c = u < rt ? count(u) : 0;
      int incl = c;  // inclusive scan of the counts over the lanes
#pragma unroll
      for (int o = 1; o < 32; o *= 2) {
        const int t = __shfl_up_sync(gpax::kFullWarp, incl, o);
        if (lane >= o) incl += t;
      }
      const unsigned hit = __ballot_sync(gpax::kFullWarp, base + incl > q);
      if (hit) {
        const int l = __ffs(hit) - 1;
        first = base + __shfl_sync(gpax::kFullWarp, incl - c, l);
        return u0 + l;
      }
      base += __shfl_sync(gpax::kFullWarp, incl, 31);
    }
  }
};

// For every 64-row tile of rows [row0, row0 + 64 row_tiles) of every matrix:
//   out[r, jT:jT+128] = C[r, jT:jT+128] + alpha sum_k A[r, k] Bop[jT + c, k]
// over k in [kstart, jT), kstart = 0, or r's own panel start when A is
// upper triangular (K5's W^T), cut into pieces as Pieces says. C may be
// null (zero). part holds gridDim.x tiles of partial sums.
template <typename T>
__device__ void panel_product(cg::grid_group& grid, const T* A, const T* Bop, const T* C,
                              T alpha, T* out, T* part, int batch, int n, int row0,
                              int row_tiles, int jT, bool a_upper, T* smem) {
  const size_t nn = (size_t)n * n;
  const int tiles = batch * row_tiles;
  const Pieces P(batch, row_tiles, row0, jT, a_upper);
  const bool split = batch * P.per_matrix > tiles;
  for (int w = blockIdx.x; w < batch * P.per_matrix; w += gridDim.x) {
    int first;
    const int u = P.tile_of(w % P.per_matrix, first);
    const int s = w % P.per_matrix - first, S = P.count(u), nk = P.slices(u);
    const size_t mb = (size_t)(w / P.per_matrix) * nn;
    const int r0 = row0 + u * kBM, kstart = P.kstart(u);
    const int k0 = kstart + kBK * (s * nk / S), k1 = kstart + kBK * ((s + 1) * nk / S);
    Acc<T> acc;
    gemm_nt(A + mb + (size_t)r0 * n, (size_t)n, Bop + mb + (size_t)jT * n, (size_t)n, k0, k1,
            acc, smem);
    const size_t o = mb + (size_t)r0 * n + jT;
    if (!split)
      store_tile(acc, alpha, C ? C + o : nullptr, out + o, (size_t)n);
    else
      store_tile(acc, T(1), (const T*)nullptr, part + (size_t)w * kTileElems, (size_t)kBN);
  }
  if (!split) return;
  grid.sync();
  // the second pass: each tile's elements in chunks, one chunk a block
  const int chunks = max(1, (int)gridDim.x / tiles);
  for (int v = blockIdx.x; v < tiles * chunks; v += gridDim.x) {
    const int t = v / chunks, c = v % chunks, b = t / row_tiles, u = t % row_tiles;
    const size_t first = (size_t)b * P.per_matrix + P.before(u);
    const int S = P.count(u);
    const size_t mo = (size_t)b * nn + (size_t)(row0 + u * kBM) * n + jT;
    for (int e = c * kTileElems / chunks + threadIdx.x; e < (c + 1) * kTileElems / chunks;
         e += kThreads) {
      T sum = 0;
      for (int s = 0; s < S; ++s) sum += part[(first + s) * kTileElems + e];
      const size_t o = mo + (size_t)(e / kBN) * n + e % kBN;
      out[o] = (C ? C[o] : T(0)) + alpha * sum;
    }
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
    Acc<T> acc;
    gemm_nt((const T*)P, (size_t)n, Wd + b * wd_stride, (size_t)kT, 0, kT, acc, smem);
    store_tile(acc, alpha, (const T*)nullptr, P, (size_t)n);
  }
}

// The device's nanosecond clock.
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// K4's and K5's phase clock: with phase_ns non-null (4 zeroed integers),
// thread 0 of block 0 reads the clock after each grid barrier and adds the
// time since the last reading to the sum of the phase that barrier ends
// (phase_ns[0] the products, [1] the diagonal tiles: K4's step, K5's
// inverses, [2] the panel TRSM; [3] holds the last reading). The sums live
// in global memory, so the clock keeps one pointer in registers through
// the products; null costs one untaken branch.
struct PhaseClock {
  unsigned long long* out;
  __device__ explicit PhaseClock(unsigned long long* phase_ns)
      : out(blockIdx.x == 0 && threadIdx.x == 0 ? phase_ns : nullptr) {
    if (out) out[3] = global_ns();
  }
  __device__ __forceinline__ void lap(int phase) {
    if (out) {
      const unsigned long long t = global_ns();
      out[phase] += t - out[3];
      out[3] = t;
    }
  }
};

// float32 keeps 2 blocks an SM (128 registers a thread: at 85, for 3 blocks
// an SM, the product tile and the diagonal step spilled and took longer on
// the card); float64's tile leaves room for one
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
panel_cholesky_kernel(const T* __restrict__ K, T* L, T* Wd, T* part, int batch, int n,
                      unsigned long long* phase_ns) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  PhaseClock clock(phase_ns);
  const size_t nn = (size_t)n * n;
  for (int jT = 0; jT < n; jT += kT) {
    // 1. the Schur update of panel j's rows >= jT (the rows above stay zero)
    panel_product(grid, (const T*)L, (const T*)L, K, T(-1), L, part, batch, n, jT,
                  (n - jT) / kBM, jT, false, smem);
    grid.sync();
    clock.lap(0);
    // 2. L_D and W_D of each matrix's diagonal tile, one block per matrix,
    //    in the swizzled tile (tile_chol_blocked.cuh); L_D (zero above the
    //    diagonal) back into L, W_D (row-major) into the scratch
    for (int b = blockIdx.x; b < batch; b += gridDim.x) {
      T* D = L + b * nn + (size_t)jT * n + jT;
      T* Wdb = Wd + (size_t)b * kT * kT;
      T* inv = smem + kT * kT;
      for (int e = threadIdx.x; e < kT * kT; e += kThreads)
        smem[gpax::tile_at<T>(e / kT, e % kT)] = D[(size_t)(e / kT) * n + e % kT];
      __syncthreads();
      gpax::tile_chol_inv_blocked(smem, inv);
      for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
        const int r = e / kT, c = e % kT;
        D[(size_t)r * n + c] = c <= r ? smem[gpax::tile_at<T>(r, c)] : T(0);
        Wdb[e] = c < r ? smem[gpax::tile_at<T>(c, r)] : (c == r ? inv[r] : T(0));
      }
      __syncthreads();
    }
    grid.sync();
    clock.lap(1);
    // 3. the panel TRSM below the diagonal tile
    panel_trsm(L, (const T*)Wd, (size_t)kT * kT, T(1), batch, n, jT + kT,
               (n - jT - kT) / kBM, jT, smem);
    grid.sync();
    clock.lap(2);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
panel_tri_inv_t_kernel(const T* __restrict__ L, T* Wt, T* Wd, T* part, int batch, int n,
                       unsigned long long* phase_ns) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  PhaseClock clock(phase_ns);
  const int nT = n / kT;
  const size_t nn = (size_t)n * n;
  // the inverse W_D of every diagonal tile, one block a tile, on the
  // blocked routine's inverse half in the swizzled tile: W_D (row-major)
  // into the scratch, W_D^T onto W^T's diagonal, each entry of W_D's row r
  // plus the row's poison z_r
  T* inv = smem + Smem<T>::inv;
  T* z = smem + Smem<T>::poison;
  for (int item = blockIdx.x; item < batch * nT; item += gridDim.x) {
    const int b = item / nT, jT = (item % nT) * kT;
    const T* D = L + b * nn + (size_t)jT * n + jT;
    for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
      const int r = e / kT, c = e % kT;
      if (c <= r) smem[gpax::tile_at<T>(r, c)] = D[(size_t)r * n + c];
    }
    if (threadIdx.x < kT) inv[threadIdx.x] = T(1) / D[(size_t)threadIdx.x * (n + 1)];
    __syncthreads();
    if (threadIdx.x < 32) gpax::row_poison((const T*)inv, z, threadIdx.x);
    gpax::tile_inv_blocked(smem, (const T*)inv);
    T* Wdj = Wd + (size_t)item * kT * kT;
    T* Dt = Wt + b * nn + (size_t)jT * n + jT;
    for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
      const int r = e / kT, c = e % kT;
      Wdj[e] = gpax::inverse_entry((const T*)smem, (const T*)inv, (const T*)z, r, c);
      Dt[(size_t)r * n + c] = gpax::inverse_entry((const T*)smem, (const T*)inv, (const T*)z, c, r);
    }
    __syncthreads();  // the tile is read to the end before the next item loads
  }
  grid.sync();
  clock.lap(1);
  for (int j = 1; j < nT; ++j) {
    const int jT = j * kT;
    panel_product(grid, (const T*)Wt, L, (const T*)nullptr, T(1), Wt, part, batch, n, 0,
                  jT / kBM, jT, true, smem);
    grid.sync();
    clock.lap(0);
    panel_trsm(Wt, (const T*)(Wd + (size_t)j * kT * kT), (size_t)nT * kT * kT, T(-1), batch, n,
               0, jT / kBM, jT, smem);
    grid.sync();
    clock.lap(2);
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

// one cooperative launch of kernel with its arguments args, in T's shared
// memory
template <typename T, typename Kernel>
int launch(Kernel kernel, void** args, int blocks, cudaStream_t stream) {
  const int bytes = Smem<T>::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(kThreads), args,
                                    bytes, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cholesky(const T* K, T* L, T* Wd, T* part, int batch, int n, int blocks,
                    cudaStream_t stream, unsigned long long* phase_ns) {
  void* args[] = {&K, &L, &Wd, &part, &batch, &n, &phase_ns};
  return launch<T>(panel_cholesky_kernel<T>, args, blocks, stream);
}

template <typename T>
int launch_tri_inv_t(const T* L, T* Wt, T* Wd, T* part, int batch, int n, int blocks,
                     cudaStream_t stream, unsigned long long* phase_ns) {
  void* args[] = {&L, &Wt, &Wd, &part, &batch, &n, &phase_ns};
  return launch<T>(panel_tri_inv_t_kernel<T>, args, blocks, stream);
}

}  // namespace

// The number of blocks one cooperative launch of K4 (kernel 0) or K5
// (kernel 1) takes on the current device, in float32 (f64 = 0) or float64:
// the wrapper sizes the partial-sum scratch (blocks * 64 * 128 elements)
// from it and passes it back to the launch. Fails with cudaErrorNotSupported
// where the device has no cooperative launch.
extern "C" int gpax_panel_grid(int kernel, int f64, int* blocks) {
  if (kernel == 0)
    return f64 ? grid_blocks(panel_cholesky_kernel<double>, Smem<double>::bytes, blocks)
               : grid_blocks(panel_cholesky_kernel<float>, Smem<float>::bytes, blocks);
  return f64 ? grid_blocks(panel_tri_inv_t_kernel<double>, Smem<double>::bytes, blocks)
             : grid_blocks(panel_tri_inv_t_kernel<float>, Smem<float>::bytes, blocks);
}

// K4. K: contiguous (batch, n, n) SPD, n a multiple of 128; L: zero-filled,
// the same shape; Wd: (batch, 128, 128) scratch; part: blocks * 64 * 128
// scratch. Writes the lower Cholesky factor of each K into L. phase_ns: null,
// or 4 zeroed device integers, the first 3 of which receive the nanoseconds
// spent in the products, the diagonal step and the panel TRSM (PhaseClock).
extern "C" int gpax_panel_cholesky_f32(const float* K, float* L, float* Wd, float* part,
                                       int batch, int n, int blocks, cudaStream_t stream,
                                       unsigned long long* phase_ns) {
  return launch_cholesky(K, L, Wd, part, batch, n, blocks, stream, phase_ns);
}

extern "C" int gpax_panel_cholesky_f64(const double* K, double* L, double* Wd, double* part,
                                       int batch, int n, int blocks, cudaStream_t stream,
                                       unsigned long long* phase_ns) {
  return launch_cholesky(K, L, Wd, part, batch, n, blocks, stream, phase_ns);
}

// K5. L: contiguous (batch, n, n) lower triangular, n a multiple of 128;
// Wt: zero-filled, the same shape; Wd: (batch, n / 128, 128, 128) scratch;
// part as for K4. Writes W^T = L^-T (upper triangular) of each L into Wt.
// phase_ns: null, or 4 zeroed device integers, the first 3 of which receive
// the nanoseconds spent in the products, the diagonal tiles' inverses and
// the panel TRSM.
extern "C" int gpax_panel_tri_inv_t_f32(const float* L, float* Wt, float* Wd, float* part,
                                        int batch, int n, int blocks, cudaStream_t stream,
                                        unsigned long long* phase_ns) {
  return launch_tri_inv_t(L, Wt, Wd, part, batch, n, blocks, stream, phase_ns);
}

extern "C" int gpax_panel_tri_inv_t_f64(const double* L, double* Wt, double* Wd, double* part,
                                        int batch, int n, int blocks, cudaStream_t stream,
                                        unsigned long long* phase_ns) {
  return launch_tri_inv_t(L, Wt, Wd, part, batch, n, blocks, stream, phase_ns);
}
