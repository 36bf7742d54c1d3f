// Latency of the device field and point layer in one warp, in SM clocks.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//       -o build/field_latency tools/field_latency.cu && build/field_latency
//
// One block of 32 threads runs each operation `kReps` times in a dependent
// chain (its result is its next input) between two clock64() reads, so the
// figure is the chain's length in clocks, not a throughput.  The group
// point ops run with 4 and with 8 threads a lane, as the group kernels do.
#include <cstdio>

#include <cuda_runtime.h>

#include "../privacy_auction_tpu_torch/csrc/ec_group.cuh"

using namespace pa;

constexpr int kReps = 200;
constexpr int kOps = 13;

__global__ void latency(uint32_t* sink, long long* clocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  const int g4 = threadIdx.x & 3, g8 = threadIdx.x & 7;
  Fe a, b;
  for (int i = 0; i < 8; ++i) {
    a.w[i] = 0x12345u * (i + 1) + threadIdx.x;
    b.w[i] = 0x9876u * (i + 3);
  }
  Pt P{a, b, a};
  int k = 0;
#define TIME(expr)                                    \
  {                                                   \
    __syncwarp();                                     \
    const long long t0 = clock64();                   \
    for (int r = 0; r < kReps; ++r) { expr; }         \
    __syncwarp();                                     \
    const long long t1 = clock64();                   \
    if (threadIdx.x == 0) clocks[k] = (t1 - t0) / kReps; \
    ++k;                                              \
  }
  TIME(a = fe_mul(a, b))
  TIME(a = fe_mul_fast(a, b))
  TIME(a = fe_add(a, b))
  TIME(a = fe_sub(a, b))
  TIME(a = fe_mul_small(a, 21u))
  TIME(a = fe_mul_small_fast(a, 21u))
  TIME(a = grp::fe_shfl<4>(a, r & 3))
  TIME(P = pt_add(P, P))
  TIME(P = pt_add_t<FieldFast>(P, P))
  TIME(P = grp::pt_add_grp<4>(P, P, g4))
  TIME(P = grp::pt_add_grp<8>(P, P, g8))
  TIME(P = grp::pt_dbl_grp<4>(P, g4))
  TIME(P = grp::pt_select16_shared(sbase + 16 * threadIdx.x, 512, P.x.w[0] & 15))
#undef TIME
  uint32_t s = 0;
  for (int i = 0; i < 8; ++i) s ^= a.w[i] ^ P.x.w[i] ^ P.y.w[i] ^ P.z.w[i];
  sink[threadIdx.x] = s;
}

int main() {
  const char* names[kOps] = {
      "fe_mul", "fe_mul_fast", "fe_add", "fe_sub", "fe_mul_small",
      "fe_mul_small_fast", "fe_shfl (8 words)", "pt_add (1 thread)",
      "pt_add_t<FieldFast> (1 thread)", "pt_add_grp<4>", "pt_add_grp<8>",
      "pt_dbl_grp<4>", "pt_select16_shared"};
  uint32_t* sink;
  long long* clocks;
  const int smem = 32 * grp::kTableBytes;
  if (cudaMalloc(&sink, 32 * sizeof(uint32_t)) || cudaMalloc(&clocks, kOps * sizeof(long long)) ||
      cudaFuncSetAttribute(latency, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return 1;
  latency<<<1, 32, smem>>>(sink, clocks);
  long long h[kOps];
  const cudaError_t err = cudaMemcpy(h, clocks, sizeof(h), cudaMemcpyDeviceToHost);
  if (err != cudaSuccess) {
    printf("error: %s\n", cudaGetErrorString(err));
    return 1;
  }
  for (int i = 0; i < kOps; ++i) printf("%-32s %lld clocks\n", names[i], h[i]);
  return 0;
}
