// Fr kernels of the quotient pipeline: the Montgomery product and one NTT
// butterfly stage.
//
// Replaces (ultragroth_tpu/ops/kernels.py): fr_mont_mul (:22) and
// fr_butterfly (:32), Pallas kernels built by fused_map (ops/fuse.py:46).
// Bound on the H100: a 2^20-lane Fr product moves 96 B per lane (two
// inputs and one output of 32 B) for ~290 32-bit multiply-adds, ~3 per
// byte, so both kernels sit close to the ridge point between memory and
// integer throughput.  First, simple design: one thread per lane (per
// butterfly pair), CIOS in registers, the stage applied in place so the
// per-stage NTT writes no stacked copy; the twiddle of pair j is read from
// a [8, half] table (tw[j] for every block of the stage).
#include <cuda_runtime.h>
#include "curve.cuh"

#define UG_FR_THREADS 256

__global__ void ug_fr_mont_mul_k(const uint32_t* a, const uint32_t* b,
                                 uint32_t* out, int64_t n, int64_t b_n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  ug::lane_fr_mul(a, b, out, n, b_n, i);
}

__global__ void ug_fr_butterfly_k(uint32_t* a, const uint32_t* tw, int64_t n,
                                  int64_t half) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n / 2) return;
  ug::lane_butterfly(a, tw, n, half, i);
}

extern "C" int ug_fr_mont_mul(const void* a, const void* b, void* out,
                              int64_t n, int64_t b_n, void* stream) {
  unsigned blocks = (unsigned)((n + UG_FR_THREADS - 1) / UG_FR_THREADS);
  ug_fr_mont_mul_k<<<blocks, UG_FR_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, b_n);
  return (int)cudaGetLastError();
}

extern "C" int ug_fr_butterfly(void* a, const void* tw, int64_t n,
                               int64_t half, void* stream) {
  unsigned blocks = (unsigned)((n / 2 + UG_FR_THREADS - 1) / UG_FR_THREADS);
  ug_fr_butterfly_k<<<blocks, UG_FR_THREADS, 0, (cudaStream_t)stream>>>(
      (uint32_t*)a, (const uint32_t*)tw, n, half);
  return (int)cudaGetLastError();
}
