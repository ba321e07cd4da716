// The blocked 128 x 128 tile routine of K3 (cholinv.cu), K2 (trtri.cu), K4's
// diagonal step and K5's diagonal inverses (panel_chol.cu), in the shared
// memory of one block of
// 256 threads: tile_chol_blocked factors one SPD tile (L), tile_inv_blocked
// inverts a lower-triangular one (W = L^-1), tile_chol_inv_blocked does
// both. They compute what the TPU kernels' row recurrences
// (gpax_tpu/ops/chol.py, scripts/panel_chol.py) compute, with 3 block
// barriers per 16-column sub-panel of the factorization, where an unblocked
// right-looking loop takes 2 per column, and 3 per block row of the inverse.
//
// Factorization, right-looking over the 8 sub-panels of 16 columns:
//   (a) warp 0 factors the sub-panel's 16 x 16 diagonal block in registers,
//       lane r holding row r and taking the other rows' values by warp
//       shuffles (no block barrier inside), and keeps 1 / L_ii;
//   (b) one thread per row below solves x L_bb^T = a for its row, in place,
//       by substitution: x_c = (a_c - sum_{k<c} x_k L_ck) (1 / L_cc), each
//       a_c updated in column order, as the unblocked loop updates it;
//   (c) all threads update the lower triangle of the trailing tile,
//       A -= X X^T, in 16 x 16 blocks.
// Inverse, in 16 x 16 blocks:
//   (d) warp w inverts diagonal block w (lane c owns column c of W_ww);
//   (e) right-looking over block rows K = 0..6: T_IJ += L_IK W_KJ for every
//       I > K, J <= K, once block row K of W is final; then block row
//       K + 1 becomes final, W_{K+1,J} = -W_{K+1,K+1} T_{K+1,J}. T_IJ is
//       kept in W_IJ's own slot.
// The block products of (c) and (e) run on the tensor cores in float64
// (mma.sync m8n8k4, a warp per block) and in 4 x 4 register tiles of FMAs
// in float32 (16 threads per block).
//
// Layout, in the tile buffer alone (the float64 tile and the pivot vector
// fill K4's 132 KB): L in the lower triangle, W^T in the strict upper
// triangle (W[i][j], i > j, at (j, i)), 1/L_ii = W[i][i] in the vector.
// The tile is stored with the column XOR-ed with the row's low bits
// (swizzled), so that a warp reading a row or a column of it hits distinct
// banks; every access goes through tile_at.
//
// Each pivot's scale is the IEEE square root and division (not rsqrt), and
// nothing is clamped, so a bad pivot gives NaN in its column and, through
// (b)-(c) and the inverse, in every later one, while the columns before it
// stay finite. The divisions by L_cc of (b) and (d) are products with
// 1 / L_cc, itself an IEEE division, as the TPU kernel's products with W_D
// stand for the panel's.

#pragma once

namespace gpax {

constexpr int kTile = 128;               // the tile's size
constexpr int kSub = 16;                 // sub-panel width
constexpr int kSubs = kTile / kSub;      // sub-panels of a tile
constexpr int kBlockedThreads = 256;     // the block size the routine expects
constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }

__device__ __forceinline__ float ieee_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double ieee_sqrt(double x) { return sqrt(x); }

// d += a b on one 8 x 8 x 4 float64 fragment on the tensor cores (mma.sync
// m8n8k4, DMMA; A row-major, B column-major): lane (g, t) = (lane / 4,
// lane % 4) passes A[g][t] and B[t][g] and holds D[g][2t] and D[g][2t + 1]
__device__ __forceinline__ void dmma_8x8x4(double (&d)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// Offset of element (r, c) in the swizzled row-major tile: the column's
// bits below 128 bytes are XOR-ed with the row's, so the 32 rows of a
// column fall in distinct banks (16 doubles or 32 floats span the 32).
template <typename T>
__device__ __forceinline__ int tile_at(int r, int c) {
  constexpr int mask = 128 / (int)sizeof(T) - 1;
  return r * kTile + (c ^ (r & mask));
}

// (a) warp 0 factors the diagonal block at (j0, j0). Lanes 16-31 mirror
// lanes 0-15 (the shuffles need the whole warp) and write nothing. Every
// lane keeps the block's diagonal in d and updates it with the same FMA
// that the pivot's own lane applies, so the next pivot needs no shuffle.
template <typename T>
__device__ __forceinline__ void factor_diagonal_block(T* As, T* inv, int j0, int lane) {
  const int r = lane & (kSub - 1);
  T a[kSub], d[kSub];
#pragma unroll
  for (int k = 0; k < kSub; ++k) {
    a[k] = As[tile_at<T>(j0 + r, j0 + k)];
    d[k] = As[tile_at<T>(j0 + k, j0 + k)];
  }
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    const T l = a[j] / ieee_sqrt(d[j]);
    if (r >= j) a[j] = l;
#pragma unroll
    for (int k = j + 1; k < kSub; ++k) {
      const T lk = __shfl_sync(kFullWarp, l, k);
      if (r >= k) a[k] = fma_(-l, lk, a[k]);
      d[k] = fma_(-lk, lk, d[k]);
    }
  }
  if (lane < kSub) {
#pragma unroll
    for (int k = 0; k < kSub; ++k)
      if (k <= r) As[tile_at<T>(j0 + r, j0 + k)] = a[k];
    inv[j0 + r] = T(1) / a[r];
  }
}

// (b) rows j0 + 16 + tid of the sub-panel, one thread each
template <typename T>
__device__ __forceinline__ void sub_panel_trsm(T* As, const T* inv, int j0, int tid) {
  const int i = j0 + kSub + tid;
  if (i >= kTile) return;
  T a[kSub];
#pragma unroll
  for (int k = 0; k < kSub; ++k) a[k] = As[tile_at<T>(i, j0 + k)];
#pragma unroll
  for (int c = 0; c < kSub; ++c) {
    a[c] *= inv[j0 + c];
#pragma unroll
    for (int k = c + 1; k < kSub; ++k) a[k] = fma_(-a[c], As[tile_at<T>(j0 + k, j0 + c)], a[k]);
  }
#pragma unroll
  for (int k = 0; k < kSub; ++k) As[tile_at<T>(i, j0 + k)] = a[k];
}

// (c) A[i][k] -= sum_c X[i][c] X[k][c] over the trailing tile from j1 =
// j0 + 16, for its 16 x 16 blocks on or below the diagonal. 16 threads per
// block, each with 4 x 4 entries: rows tu + 4u, columns 4tv + v, so that
// the rows a warp reads at once fall in distinct banks; the 16 terms of an
// entry in column order, as the unblocked loop adds them.
template <typename T>
__device__ __forceinline__ void trailing_update(T* As, int j0, int tid) {
  const int j1 = j0 + kSub, nb = (kTile - j1) / kSub;
  for (int w = tid; w < 16 * nb * (nb + 1) / 2; w += kBlockedThreads) {
    int BI = 0, blk = w / 16;
    while (blk > BI) blk -= ++BI;
    const int i0 = j1 + kSub * BI + (w / 4) % 4, k0 = j1 + kSub * blk + 4 * (w % 4);
    T acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = As[tile_at<T>(i0 + 4 * u, k0 + v)];
#pragma unroll
    for (int c = 0; c < kSub; ++c) {
      T xi[4], xk[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        xi[u] = As[tile_at<T>(i0 + 4 * u, j0 + c)];
        xk[u] = As[tile_at<T>(k0 + u, j0 + c)];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fma_(-xi[u], xk[v], acc[u][v]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) As[tile_at<T>(i0 + 4 * u, k0 + v)] = acc[u][v];
  }
}

// (d) warp w inverts the diagonal block at (16w, 16w): lane c (and its
// mirror c + 16) owns column c of W_ww, w[i] = (delta_ic - sum_{k<i} L_ik
// w[k]) / L_ii, the division a product with inv; writes W_ww^T above the
// block's diagonal (its diagonal is inv already).
template <typename T>
__device__ __forceinline__ void invert_diagonal_block(T* As, const T* inv, int warp, int lane) {
  const int j0 = warp * kSub, r = lane & (kSub - 1);
  T a[kSub];  // row r of L_ww
#pragma unroll
  for (int k = 0; k < kSub; ++k) a[k] = As[tile_at<T>(j0 + r, j0 + k)];
  T w[kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    T acc[2] = {0, 0};  // two partial sums halve the dependent chain
#pragma unroll
    for (int k = 0; k < i; ++k)
      acc[k % 2] = fma_(__shfl_sync(kFullWarp, a[k], i), w[k], acc[k % 2]);
    w[i] = ((i == r ? T(1) : T(0)) - (acc[0] + acc[1])) * inv[j0 + i];
  }
  if (lane < kSub) {
#pragma unroll
    for (int i = 0; i < kSub; ++i)
      if (i > r) As[tile_at<T>(j0 + r, j0 + i)] = w[i];
  }
}

// (c) in float64 on the tensor cores: warp w takes blocks w, w + 8, ...,
// each as 2 x 2 DMMA fragments of 8 x 8 over 4 k-steps of 4
__device__ __forceinline__ void trailing_update(double* As, int j0, int tid) {
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int j1 = j0 + kSub, nb = (kTile - j1) / kSub;
  for (int w = tid / 32; w < nb * (nb + 1) / 2; w += kBlockedThreads / 32) {
    int BI = 0, BK = w;
    while (BK > BI) BK -= ++BI;
    const int i0 = j1 + kSub * BI, k0 = j1 + kSub * BK;
    double acc[2][2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          acc[i][j][e] = As[tile_at<double>(i0 + 8 * i + g, k0 + 8 * j + 2 * t + e)];
#pragma unroll
    for (int kk = 0; kk < kSub; kk += 4) {
      double a[2], b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[i] = -As[tile_at<double>(i0 + 8 * i + g, j0 + kk + t)];
        b[i] = As[tile_at<double>(k0 + 8 * i + g, j0 + kk + t)];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) dmma_8x8x4(acc[i][j], a[i], b[j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          As[tile_at<double>(i0 + 8 * i + g, k0 + 8 * j + 2 * t + e)] = acc[i][j][e];
  }
}

// W_D[16K + k][16J + c] for J <= K (0 above the diagonal, inv on it)
template <typename T>
__device__ __forceinline__ T w_entry(const T* As, const T* inv, int K, int k, int J, int c) {
  const int row = K * kSub + k, col = J * kSub + c;
  return row > col ? As[tile_at<T>(col, row)] : (row == col ? inv[row] : T(0));
}

// (e), step K: T_IJ (+)= L_IK W_KJ for I > K, J <= K, 16 threads per block,
// each with 4 x 4 entries (rows tu + 4u, columns 4tv + v). T_IJ[r][c] is at
// (16J + c, 16I + r); at J == K it starts from 0 (the slot holds stale
// values of the input's upper triangle).
template <typename T>
__device__ __forceinline__ void inverse_update(T* As, const T* inv, int K, int tid) {
  const int nJ = K + 1, blocks = (kSubs - 1 - K) * nJ;
  for (int e = tid; e < 16 * blocks; e += kBlockedThreads) {
    const int I = K + 1 + (e / 16) / nJ, J = (e / 16) % nJ;
    const int r0 = (e / 4) % 4, c0 = 4 * (e % 4);
    T acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        acc[u][v] = J == K ? T(0) : As[tile_at<T>(J * kSub + c0 + v, I * kSub + r0 + 4 * u)];
#pragma unroll
    for (int k = 0; k < kSub; ++k) {
      T l[4], w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        l[u] = As[tile_at<T>(I * kSub + r0 + 4 * u, K * kSub + k)];
        w[u] = w_entry(As, inv, K, k, J, c0 + u);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fma_(l[u], w[v], acc[u][v]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        As[tile_at<T>(J * kSub + c0 + v, I * kSub + r0 + 4 * u)] = acc[u][v];
  }
}

// (e), after step K: W_IJ = -W_II T_IJ for I = K + 1 and every J <= K, into
// out (same 4 x 4 entries per thread as inverse_update); true if this
// thread has entries, which the caller stores after a barrier
template <typename T>
__device__ __forceinline__ bool inverse_row(const T* As, const T* inv, int K, int tid,
                                            T (&out)[4][4]) {
  const int I = K + 1, J = tid / 16;
  if (J > K) return false;
  const int r0 = (tid / 4) % 4, c0 = 4 * (tid % 4);
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) out[u][v] = 0;
#pragma unroll
  for (int k = 0; k < kSub; ++k) {
    T w[4], t[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      w[u] = w_entry(As, inv, I, r0 + 4 * u, I, k);  // W_II[r][k]
      t[u] = As[tile_at<T>(J * kSub + c0 + u, I * kSub + k)];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) out[u][v] = fma_(-w[u], t[v], out[u][v]);
  }
  return true;
}

// (e) in float64 on the tensor cores, one warp per 16 x 16 block as 2 x 2
// DMMA fragments: inverse_update's T_IJ (+)= L_IK W_KJ, warp w taking the
// blocks w, w + 8, ...; then inverse_row's -W_II T_IJ into out for
// J = warp <= K (true if this warp has a block).
__device__ __forceinline__ void inverse_update(double* As, const double* inv, int K, int tid) {
  const int lane = tid % 32, g = lane / 4, t = lane % 4, nJ = K + 1;
  for (int w = tid / 32; w < (kSubs - 1 - K) * nJ; w += kBlockedThreads / 32) {
    const int I = K + 1 + w / nJ, J = w % nJ;
    double acc[2][2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          acc[i][j][e] = J == K ? 0.0
                                : As[tile_at<double>(J * kSub + 8 * j + 2 * t + e,
                                                     I * kSub + 8 * i + g)];
#pragma unroll
    for (int kk = 0; kk < kSub; kk += 4) {
      double a[2], b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[i] = As[tile_at<double>(I * kSub + 8 * i + g, K * kSub + kk + t)];
        b[i] = w_entry(As, inv, K, kk + t, J, 8 * i + g);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) dmma_8x8x4(acc[i][j], a[i], b[j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          As[tile_at<double>(J * kSub + 8 * j + 2 * t + e, I * kSub + 8 * i + g)] =
              acc[i][j][e];
  }
}

__device__ __forceinline__ bool inverse_row(const double* As, const double* inv, int K,
                                            int tid, double (&out)[2][2][2]) {
  const int I = K + 1, J = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  if (J > K) return false;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) out[i][j][0] = out[i][j][1] = 0.0;
#pragma unroll
  for (int kk = 0; kk < kSub; kk += 4) {
    double a[2], b[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      a[i] = -w_entry(As, inv, I, 8 * i + g, I, kk + t);  // -W_II[r][k]
      b[i] = As[tile_at<double>(J * kSub + 8 * i + g, I * kSub + kk + t)];  // T_IJ[k][c]
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) dmma_8x8x4(out[i][j], a[i], b[j]);
  }
  return true;
}

// The stores after inverse_row: float32's 4 x 4 entries per thread, and
// float64's 2 x 2 fragments per lane
__device__ __forceinline__ void store_inverse_row(float* As, int K, int tid,
                                                  const float (&out)[4][4]) {
  const int I = K + 1, J = tid / 16, r0 = (tid / 4) % 4, c0 = 4 * (tid % 4);
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      As[tile_at<float>(J * kSub + c0 + v, I * kSub + r0 + 4 * u)] = out[u][v];
}

__device__ __forceinline__ void store_inverse_row(double* As, int K, int tid,
                                                  const double (&out)[2][2][2]) {
  const int I = K + 1, J = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        As[tile_at<double>(J * kSub + 8 * j + 2 * t + e, I * kSub + 8 * i + g)] =
            out[i][j][e];
}

// inverse_row's registers: 4 x 4 entries (float32), 2 x 2 fragments (float64)
template <typename T>
struct RowOut {
  T v[4][4];
};
template <>
struct RowOut<double> {
  double v[2][2][2];
};

// (a)-(c). As: the swizzled tile (tile_at), loaded, with a barrier passed
// since; inv: kTile elements of shared scratch. On return L sits in the
// lower triangle of As, 1/L_ii in inv, and every thread has passed a
// barrier. The strict upper triangle keeps the input's values.
template <typename T>
__device__ void tile_chol_blocked(T* As, T* inv) {
  const int tid = threadIdx.x;
  for (int j0 = 0; j0 < kTile; j0 += kSub) {
    if (tid < 32) factor_diagonal_block(As, inv, j0, tid);
    __syncthreads();
    sub_panel_trsm(As, (const T*)inv, j0, tid);
    __syncthreads();
    trailing_update(As, j0, tid);
    __syncthreads();
  }
}

// (d)-(e). As: L in the lower triangle of the swizzled tile (the strict
// upper triangle may hold anything: no value read from it is used before
// the routine writes it), inv: 1/L_ii, both with a barrier passed since. On return W^T sits in the strict upper
// triangle (W's diagonal is inv) and every thread has passed a barrier.
template <typename T>
__device__ void tile_inv_blocked(T* As, const T* inv) {
  const int tid = threadIdx.x;
  invert_diagonal_block(As, inv, tid / 32, tid % 32);
  __syncthreads();
  for (int K = 0; K < kSubs - 1; ++K) {
    inverse_update(As, inv, K, tid);
    __syncthreads();
    RowOut<T> out;
    const bool mine = inverse_row((const T*)As, inv, K, tid, out.v);
    __syncthreads();
    if (mine) store_inverse_row(As, K, tid, out.v);
    __syncthreads();
  }
}

// L and W = L^-1 of one SPD tile (tile_chol_blocked, then tile_inv_blocked)
template <typename T>
__device__ void tile_chol_inv_blocked(T* As, T* inv) {
  tile_chol_blocked(As, inv);
  tile_inv_blocked(As, (const T*)inv);
}

// The shared memory of K2's, K3's, K4's and K5's blocks: the swizzled tile,
// 1/L_ii and each row's poison (row_poison), kTile elements each after the
// tile.
template <typename T>
struct TileSmem {
  static constexpr int inv = kTile * kTile, poison = inv + kTile;
  static constexpr int bytes = (poison + kTile) * (int)sizeof(T);
};

// Warp 0 (call with all 32 lanes) writes z[r] = sum_{k <= r} 0 * inv[k]:
// 0 while every pivot up to row r is finite and nonzero, NaN from the first
// bad one on. Added to every entry of W's row r, it gives the TPU kernel's
// rows of the inverse (row r = (e_r - acc) / l_rr over whole rows): non-finite
// in every column from a bad pivot's row down, where the blocked inverse
// leaves finite the entries above the diagonal and those that do not depend
// on the bad row.
template <typename T>
__device__ __forceinline__ void row_poison(const T* inv, T* z, int lane) {
  T v[4], s = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s += T(0) * inv[4 * lane + i];
    v[i] = s;
  }
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    const T t = __shfl_up_sync(kFullWarp, s, o);
    if (lane >= o) s += t;
  }
  T before = __shfl_up_sync(kFullWarp, s, 1);
  if (lane == 0) before = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) z[4 * lane + i] = before + v[i];
}

// W[r][c] of the tile that tile_inv_blocked leaves in As and inv, plus the
// row's poison z[r] (row_poison)
template <typename T>
__device__ __forceinline__ T inverse_entry(const T* As, const T* inv, const T* z, int r, int c) {
  return (c < r ? As[tile_at<T>(c, r)] : (c == r ? inv[r] : T(0))) + z[r];
}

}  // namespace gpax
