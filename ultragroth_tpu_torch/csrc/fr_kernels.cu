// Fr kernels of the quotient pipeline: the Montgomery product, one NTT
// butterfly stage, and the whole NTT of columns (the fast mode's).
//
// Replaces (ultragroth_tpu/ops/kernels.py): fr_mont_mul (:22) and
// fr_butterfly (:32), Pallas kernels built by fused_map (ops/fuse.py:46);
// and ultragroth_tpu/ops/ntt.py:_cg_kernel_call (:196) as fr_cg_ntt, below.
// Bound on the H100: a 2^20-lane Fr product moves 96 B per lane (two
// inputs and one output of 32 B) for ~290 32-bit multiply-adds, ~3 per
// byte, so both kernels sit close to the ridge point between memory and
// integer throughput.  First, simple design: one thread per lane (per
// butterfly pair), CIOS in registers, the stage applied in place so the
// per-stage NTT writes no stacked copy; the twiddle of pair j is read from
// a [8, half] table (tw[j] for every block of the stage).  The MMA build
// (UG_MMA_FIELD) of the same kernels: launch_common.cuh.
#include "launch_common.cuh"
#include "ntt.cuh"

#define UG_FR_THREADS 256

__global__ void UG_SYM(fr_mont_mul_k)(const uint32_t* a, const uint32_t* b,
                                      uint32_t* out, int64_t n, int64_t b_n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  UG_LANE_BEGIN(ug::FrParams, i, n);
  ug::lane_fr_mul(a, b, out, n, b_n, i, live);
}

__global__ void UG_SYM(fr_butterfly_k)(uint32_t* a, const uint32_t* tw, int64_t n,
                                       int64_t half) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  UG_LANE_BEGIN(ug::FrParams, i, n / 2);
  ug::lane_butterfly(a, tw, n, half, i, live);
}

extern "C" int UG_SYM(fr_mont_mul)(const void* a, const void* b, void* out,
                                   int64_t n, int64_t b_n, void* stream) {
  int smem;
  if (int rc = ug_kernel_smem(UG_SYM(fr_mont_mul_k), UG_FR_THREADS, &smem)) return rc;
  UG_SYM(fr_mont_mul_k)<<<ug_grid(n, UG_FR_THREADS), UG_FR_THREADS, smem,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, b_n);
  return (int)cudaGetLastError();
}

extern "C" int UG_SYM(fr_butterfly)(void* a, const void* tw, int64_t n,
                                    int64_t half, void* stream) {
  int smem;
  if (int rc = ug_kernel_smem(UG_SYM(fr_butterfly_k), UG_FR_THREADS, &smem)) return rc;
  UG_SYM(fr_butterfly_k)<<<ug_grid(n / 2, UG_FR_THREADS), UG_FR_THREADS, smem,
                           (cudaStream_t)stream>>>(
      (uint32_t*)a, (const uint32_t*)tw, n, half);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fr_cg_ntt: the NTT of every column of x [8, M, cols] (M = 2^log_m points
// along axis 1, Montgomery planes), natural order in and out; with cb > 0
// (and stw [8, cols/cb, M], null otherwise) each element is first
// multiplied by its split twiddle and the output stored transposed, y [8,
// cols/cb, M, cb] (column j1*cb + b of the input to row j1): the Bailey
// split's first pass (ops/ntt.py:_ntt_cols).  Design: csrc/ntt.cuh.  One
// instance a log_m.
//
// Bound on the H100: at [8, 2^10, 2^10] the transform needs 4,097 products
// a column (by twiddles other than 1: kernels.cg_ntt_products; the kernel
// makes 4,224, the radix-2 network 5,120), the folded twiddle 1,023 more
// (row 0 and output 0 take w^0), 264 32-bit multiply-adds each, against
// 32 MB read and 32 MB written (32 MB more read with the split twiddles):
// bound by its multiplies, 0.066 ms (0.083 folded), not by its 0.02 ms
// (0.03) of bytes.
// ---------------------------------------------------------------------------
#if UG_MMA_FIELD
#define UG_NTT_MIN_BLOCKS 1
#else
#define UG_NTT_MIN_BLOCKS (UG_NTT_THREADS >= 512 ? 1 : 512 / UG_NTT_THREADS)
#endif

template <int LOG_N>
__global__ void __launch_bounds__(UG_NTT_THREADS, UG_NTT_MIN_BLOCKS)
UG_SYM(fr_cg_ntt_k)(ug::NttArgs a) {
#if UG_MMA_FIELD
  ug::mma_block_init<ug::FrParams>();
#endif
  uint32_t* stws = (uint32_t*)ug_own_smem();
  uint32_t* sdat = stws + 8 * ug::NttShape<LOG_N>::HP;
  const ug::NttArgs args = a;
  ug::DevBlock run{(int)threadIdx.x};
  ug::NttDevRegs regs;
  ug::ntt_cols_body<LOG_N>(run, regs, args, sdat, stws, blockIdx.x);
}

template <int LOG_N>
static int ug_ntt_smem(int* bytes) {
  return ug_kernel_smem(UG_SYM(fr_cg_ntt_k)<LOG_N>, UG_NTT_THREADS, bytes,
                        ug::ntt_smem_bytes<LOG_N>());
}

template <int LOG_N>
static int ug_ntt_launch(const ug::NttArgs& a, cudaStream_t stream) {
  int smem;
  if (int rc = ug_ntt_smem<LOG_N>(&smem)) return rc;
  const int64_t cpb = ug::NttShape<LOG_N>::CPB;
  UG_SYM(fr_cg_ntt_k)<LOG_N><<<(unsigned)((a.cols + cpb - 1) / cpb), UG_NTT_THREADS,
                               smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int LOG_N>
static int ug_ntt_info(int* regs, int* local_bytes, int* blocks_per_sm) {
  cudaFuncAttributes at;
  if (cudaError_t rc = cudaFuncGetAttributes(&at, UG_SYM(fr_cg_ntt_k)<LOG_N>))
    return (int)rc;
  *regs = at.numRegs;
  *local_bytes = (int)at.localSizeBytes;
  int smem;
  if (int rc = ug_ntt_smem<LOG_N>(&smem)) return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, UG_SYM(fr_cg_ntt_k)<LOG_N>, UG_NTT_THREADS, smem);
}

#define UG_NTT_CASES(F, ...)                                                  \
  switch (log_m) {                                                            \
    case 1: return F<1>(__VA_ARGS__);                                         \
    case 2: return F<2>(__VA_ARGS__);                                         \
    case 3: return F<3>(__VA_ARGS__);                                         \
    case 4: return F<4>(__VA_ARGS__);                                         \
    case 5: return F<5>(__VA_ARGS__);                                         \
    case 6: return F<6>(__VA_ARGS__);                                         \
    case 7: return F<7>(__VA_ARGS__);                                         \
    case 8: return F<8>(__VA_ARGS__);                                         \
    case 9: return F<9>(__VA_ARGS__);                                         \
    case 10: return F<10>(__VA_ARGS__);                                       \
  }                                                                           \
  return (int)cudaErrorInvalidValue

extern "C" int UG_SYM(fr_cg_ntt)(const void* x, const void* tw, const void* stw, void* y,
                                 int log_m, int64_t cols, int64_t cb, void* stream) {
  if ((stw != nullptr) != (cb > 0)) return (int)cudaErrorInvalidValue;
  const ug::NttArgs a{(const uint32_t*)x, (const uint32_t*)tw, (const uint32_t*)stw,
                      (uint32_t*)y, cols, cb};
  UG_NTT_CASES(ug_ntt_launch, a, (cudaStream_t)stream);
}

// Registers, local (stack and spill) bytes a thread and resident blocks per
// SM of the instance for 2^log_m points.
extern "C" int UG_SYM(fr_cg_ntt_info)(int log_m, int* regs, int* local_bytes,
                                      int* blocks_per_sm) {
  UG_NTT_CASES(ug_ntt_info, regs, local_bytes, blocks_per_sm);
}
