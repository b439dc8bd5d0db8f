// G1 instances of the curve kernels (field Fq); see curve_kernels.inc.
#define UG_F ug::Fq
#define UG_DRAIN_F ug::Fq
#define UG_CHAIN_F ug::FqCall
#define UG_NAME(x) UG_SYM(g1_##x)
#include "curve_kernels.inc"

// The Fq product probe (lane_fq_mul): no TPU kernel, only the checks of the
// field on the card, in both builds.
__global__ void UG_SYM(fq_mont_mul_k)(const uint32_t* a, const uint32_t* b,
                                      uint32_t* out, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  UG_LANE_BEGIN(ug::FqParams, i, n);
  ug::lane_fq_mul(a, b, out, n, i, live);
}

extern "C" int UG_SYM(fq_mont_mul)(const void* a, const void* b, void* out,
                                   int64_t n, void* stream) {
  int smem;
  if (int rc = ug_kernel_smem(UG_SYM(fq_mont_mul_k), UG_THREADS, &smem)) return rc;
  UG_SYM(fq_mont_mul_k)<<<ug_grid(n, UG_THREADS), UG_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

// The latency probe (lane_fq_chain, no TPU kernel): each lane a chain of
// `steps` dependent Fq products; one warp's time over steps is the latency
// of one product, the floor of the reduction's and the combine's chains.
__global__ void UG_SYM(fq_chain_k)(const uint32_t* a, const uint32_t* b, uint32_t* out,
                                   int64_t n, int32_t steps) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  UG_LANE_BEGIN(ug::FqParams, i, n);
  ug::lane_fq_chain(a, b, out, n, steps, i, live);
}

extern "C" int UG_SYM(fq_chain)(const void* a, const void* b, void* out, int64_t n,
                                int32_t steps, void* stream) {
  int smem;
  if (int rc = ug_kernel_smem(UG_SYM(fq_chain_k), 32, &smem)) return rc;
  UG_SYM(fq_chain_k)<<<ug_grid(n, 32), 32, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, steps);
  return (int)cudaGetLastError();
}
