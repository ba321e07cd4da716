// The blocked 128-tile routine of K2, K3 and K4's diagonal step
// (gpax_torch/csrc/tile_chol_blocked.cuh) on one 128 x 128 SPD tile in one
// block, timed by part with clock64 (thread 0 reads the clock after each
// block barrier), beside the unblocked step that K3 ran before it
// (unblocked_cholesky below + tile_forward_subst) timed by CUDA events.
// Prints, for float64 and float32, the microseconds a tile of each, the
// residuals |L L^T - K| and |W L - I| of the blocked step, and its cycles a
// tile by part. Build and run on a card, from the repository root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/diag_step_bench scripts/diag_step_bench.cu && build/diag_step_bench
#include <cstdio>
#include <cmath>
#include <random>
#include <vector>

#include "../gpax_torch/csrc/tile_chol_blocked.cuh"

using namespace gpax;

// The unblocked right-looking Cholesky of one tile in shared memory, the
// baseline: at step j, l_i = A[i][j] / sqrt(A[j][j]) for i >= j (the 128
// threads of the first half, one row each, into lv), then A[i][k] -= l_i l_k
// for j < k <= i, the 256 threads taking one column and every second row
// each; two block barriers a column. L ends in the lower triangle of As.
template <typename T>
__device__ __forceinline__ void unblocked_cholesky(T* As, T* lv) {
  const int tid = threadIdx.x;
  const int c = tid % kTile, g = tid / kTile;  // column, row group
  for (int j = 0; j < kTile; ++j) {
    T v = 0;
    if (g == 0) {
      v = c >= j ? As[c * kTile + j] / ieee_sqrt(As[j * kTile + j]) : T(0);
      lv[c] = v;
    }
    __syncthreads();
    if (g == 0 && c >= j) As[c * kTile + j] = v;
    if (c > j) {
      const T lk = lv[c];
      for (int i = j + 1 + g; i < kTile; i += 2)
        if (c <= i) As[i * kTile + c] = fma_(-lv[i], lk, As[i * kTile + c]);
    }
    __syncthreads();
  }
}

// The baseline's inverse: forward substitution, one column of W = L^-1 per
// thread (0 <= j < 128), W[i][j] = (delta_ij - sum_{k<i} L[i][k] W[k][j]) /
// L[i][i], the Pallas kernels' row recurrence read column by column. Ls is
// the row-major tile of L in shared memory, Wt the row-major tile of W with
// row stride ldw.
template <typename T>
__device__ __forceinline__ void tile_forward_subst(const T* Ls, T* Wt, size_t ldw, int j) {
  for (int i = 0; i < kTile; ++i) {
    T acc = 0;
    for (int k = 0; k < i; ++k) acc = fma_(Ls[i * kTile + k], Wt[k * ldw + j], acc);
    Wt[i * ldw + j] = ((i == j ? T(1) : T(0)) - acc) / Ls[i * kTile + i];
  }
}

template <typename T>
__global__ void __launch_bounds__(256) bench(const T* K, T* L, T* W, long long* cyc, int reps) {
  extern __shared__ __align__(16) unsigned char raw[];
  T* As = (T*)raw;
  T* inv = As + kTile * kTile;
  long long c[7] = {0, 0, 0, 0, 0, 0, 0};
  long long t0 = clock64();
  const int tid = threadIdx.x;
  for (int rep = 0; rep < reps; ++rep) {
    t0 = clock64();
#define LAP(p)                      \
  if (tid == 0) {                   \
    const long long t = clock64();  \
    c[p] += t - t0;                 \
    t0 = t;                         \
  }
    for (int e = tid; e < kTile * kTile; e += 256) As[tile_at<T>(e / kTile, e % kTile)] = K[e];
    __syncthreads();
    LAP(0)
    for (int j0 = 0; j0 < kTile; j0 += kSub) {
      if (tid < 32) factor_diagonal_block(As, inv, j0, tid);
      __syncthreads();
      LAP(1)
      sub_panel_trsm(As, (const T*)inv, j0, tid);
      __syncthreads();
      LAP(2)
      trailing_update(As, j0, tid);
      __syncthreads();
      LAP(3)
    }
    invert_diagonal_block(As, (const T*)inv, tid / 32, tid % 32);
    __syncthreads();
    LAP(4)
    for (int K = 0; K < kSubs - 1; ++K) {
      inverse_update(As, (const T*)inv, K, tid);
      __syncthreads();
      RowOut<T> out;
      const bool mine = inverse_row((const T*)As, (const T*)inv, K, tid, out.v);
      __syncthreads();
      if (mine) store_inverse_row(As, K, tid, out.v);
      __syncthreads();
    }
    LAP(5)
    for (int e = tid; e < kTile * kTile; e += 256) {
      const int r = e / kTile, cc = e % kTile;
      L[e] = cc <= r ? As[tile_at<T>(r, cc)] : T(0);
      W[e] = cc < r ? As[tile_at<T>(cc, r)] : (cc == r ? inv[r] : T(0));
    }
    __syncthreads();
    LAP(6)
  }
  if (tid == 0)
    for (int p = 0; p < 7; ++p) cyc[p] = c[p];
}

template <typename T>
__global__ void __launch_bounds__(256) old_step(const T* K, T* L, T* W, int reps) {
  extern __shared__ __align__(16) unsigned char raw[];
  T* As = (T*)raw;
  for (int rep = 0; rep < reps; ++rep) {
    for (int e = threadIdx.x; e < kTile * kTile; e += 256) As[e] = K[e];
    __syncthreads();
    unblocked_cholesky(As, As + kTile * kTile);
    for (int e = threadIdx.x; e < kTile * kTile; e += 256)
      L[e] = (e % kTile) <= (e / kTile) ? As[e] : T(0);
    if (threadIdx.x < kTile) tile_forward_subst((const T*)As, W, kTile, threadIdx.x);
    __syncthreads();
  }
}

template <typename T>
void run(const char* name) {
  const int n = kTile, reps = 50;
  std::mt19937_64 g(1);
  std::normal_distribution<double> nd;
  std::vector<double> A(n * n), Kd(n * n);
  for (auto& v : A) v = nd(g);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) {
      double s = 0;
      for (int k = 0; k < n; ++k) s += A[i * n + k] * A[j * n + k];
      Kd[i * n + j] = s / n + (i == j ? 0.5 : 0.0);
    }
  std::vector<T> Kt(Kd.begin(), Kd.end()), L(n * n), W(n * n);
  T *dK, *dL, *dW;
  long long* dc;
  cudaMalloc(&dK, n * n * sizeof(T));
  cudaMalloc(&dL, n * n * sizeof(T));
  cudaMalloc(&dW, n * n * sizeof(T));
  cudaMalloc(&dc, 7 * sizeof(long long));
  cudaMemcpy(dK, Kt.data(), n * n * sizeof(T), cudaMemcpyHostToDevice);
  const int smem = (n * n + n) * sizeof(T);
  cudaFuncSetAttribute(bench<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(old_step<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  bench<T><<<1, 256, smem>>>(dK, dL, dW, dc, 1);
  cudaEventRecord(a);
  bench<T><<<1, 256, smem>>>(dK, dL, dW, dc, reps);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms_new = 0;
  cudaEventElapsedTime(&ms_new, a, b);
  long long cyc[7];
  cudaMemcpy(cyc, dc, sizeof cyc, cudaMemcpyDeviceToHost);
  cudaMemcpy(L.data(), dL, n * n * sizeof(T), cudaMemcpyDeviceToHost);
  cudaMemcpy(W.data(), dW, n * n * sizeof(T), cudaMemcpyDeviceToHost);
  double rf = 0, ri = 0;
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) {
      double s = 0, t = 0;
      for (int k = 0; k < n; ++k) {
        s += (double)L[i * n + k] * L[j * n + k];
        t += (double)W[i * n + k] * L[k * n + j];
      }
      rf = fmax(rf, fabs(s - Kd[i * n + j]));
      ri = fmax(ri, fabs(t - (i == j)));
    }
  old_step<T><<<1, 256, smem>>>(dK, dL, dW, 1);
  cudaEventRecord(a);
  old_step<T><<<1, 256, smem>>>(dK, dL, dW, reps);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms_old = 0;
  cudaEventElapsedTime(&ms_old, a, b);
  const char* part[7] = {"load", "factor(a)", "trsm(b)", "trailing(c)", "diag inv(d)", "inverse(e)", "store"};
  printf("%s: blocked %.2f us a tile (old %.2f us); |LL^T-K| %.2e |WL-I| %.2e; err %s\n", name,
         1e3 * ms_new / reps, 1e3 * ms_old / reps, rf, ri,
         cudaGetErrorString(cudaGetLastError()));
  long long tot = 0;
  for (int p = 0; p < 7; ++p) tot += cyc[p];
  for (int p = 0; p < 7; ++p)
    printf("  %-12s %8.0f cycles a tile (%4.1f%%)\n", part[p], (double)cyc[p] / reps,
           100.0 * cyc[p] / tot);
}

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("%s, %d SMs\n", prop.name, prop.multiProcessorCount);
  run<double>("float64");
  run<float>("float32");
  return 0;
}
