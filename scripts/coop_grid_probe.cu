// Which SM each block of a cooperative launch lands on, and what one grid
// barrier (cooperative_groups::this_grid().sync()) costs, at the grids of
// K4/K5 (gpax_torch/csrc/panel_chol.cu): 256 threads a block, their shared
// memory, 2 or 3 float32 blocks an SM and 1 float64 block. Prints, for each,
// the SMs of the first 16 blocks, how many distinct SMs the first 132, 126
// and 64 blocks cover (a phase with that many busy blocks runs some of them
// two to an SM when fewer), and the microseconds of one barrier (1000
// barriers a launch, less an empty launch). Build and run on a card, from
// the repository root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/coop_grid_probe scripts/coop_grid_probe.cu && build/coop_grid_probe
#include <cstdio>
#include <set>
#include <vector>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
template <int MINB>
__global__ void __launch_bounds__(256, MINB) probe(int* out, int syncs) {
  extern __shared__ unsigned char s[];
  unsigned id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  if (threadIdx.x == 0) out[blockIdx.x] = id;
  s[threadIdx.x] = 0;
  auto g = cooperative_groups::this_grid();
  for (int i = 0; i < syncs; ++i) g.sync();
}
template <int MINB>
void run(int smem) {
  cudaFuncSetAttribute(probe<MINB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, probe<MINB>, 256, smem);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  per = per < MINB ? per : MINB;
  const int G = per * sms;
  int* d; cudaMalloc(&d, G * 4);
  float ms[2];
  for (int k = 0; k < 2; ++k) {
    int syncs = k ? 1000 : 0;
    void* args[] = {&d, &syncs};
    cudaLaunchCooperativeKernel((void*)probe<MINB>, G, 256, args, smem, 0);  // warm
    cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
    cudaEventRecord(a);
    for (int r = 0; r < 10; ++r) cudaLaunchCooperativeKernel((void*)probe<MINB>, G, 256, args, smem, 0);
    cudaEventRecord(b); cudaEventSynchronize(b);
    cudaEventElapsedTime(&ms[k], a, b);
  }
  std::vector<int> h(G);
  cudaMemcpy(h.data(), d, G * 4, cudaMemcpyDeviceToHost);
  printf("blocks %d (%d an SM, smem %d); block -> SM:", G, per, smem);
  for (int i = 0; i < 16; ++i) printf(" %d", h[i]);
  printf("\n  distinct SMs among the first 132 blocks: %zu, the first 126: %zu, the first 64: %zu; "
         "one grid barrier %.3f us\n", std::set<int>(h.begin(), h.begin() + 132).size(),
         std::set<int>(h.begin(), h.begin() + 126).size(), std::set<int>(h.begin(), h.begin() + 64).size(),
         (ms[1] - ms[0]) / 10 / 1000 * 1000);
}
int main() {
  run<2>((128 * 128 + 256) * 4);
  run<3>((128 * 128 + 256) * 4);
  run<1>((128 * 128 + 256) * 8);
  return 0;
}
