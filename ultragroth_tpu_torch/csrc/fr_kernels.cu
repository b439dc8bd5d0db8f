// Fr kernels of the quotient pipeline: the Montgomery product, one NTT
// butterfly stage, and the whole constant-geometry NTT of a column.
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
// fr_cg_ntt: the constant-geometry (Pease) network of M = 2^log_m points
// along axis 1 of x [8, M, CB] (Montgomery planes), all log_m stages in
// shared memory, twiddles tw [log_m, 8, M/2]; the output y [8, M, CB] is in
// NATURAL order: the kernel applies the final bit reversal as it stores
// (the JAX kernel leaves a bit-reversed layout and _ntt_cols takes it).
//
// Design.  A block holds UG_CG_ELEMS = 1024 elements, 32 KB of static
// shared memory: cols = 1024 / M whole columns (one column at the cap,
// M = 2^10).  UG_CG_MAX_LOG = 10 is this kernel's own cap, chosen from
// shared memory: 2^10 points x 32 B = 32 KB fits under the 48 KB static
// limit and leaves room for two blocks of 512 threads on an SM (the TPU
// kernel's cap of 2^6 was a Mosaic compiler limit).  Larger transforms are
// split by ops/ntt.py:_ntt_cols (Bailey), so 2^20 is two launches of
// 2^10-point columns.  Each of the 512 threads runs one butterfly of each
// stage with the CIOS product of field.cuh, holding its two outputs in
// registers across a __syncthreads() so the stage runs in place; the
// shared planes are limb-major, so the stage's reads are bank-conflict
// free and its interleaved writes two-way conflicted.
//
// Loads: the input is plane-major, so a column's points are CB words
// apart.  The load loop runs over (limb, point, column) with the column
// fastest: with several columns per block (M < 1024) neighbouring threads
// read neighbouring words; at M = 1024 (one column per block) they read
// words CB apart, so each 4-byte load takes its own 32-byte sector.  The
// blocks of neighbouring columns run together and read the other words of
// those sectors, which L2 holds (the 2^20 array is 32 MB), so HBM moves
// about the array once while L2 moves ~8x that.  This is a first, simple
// design: the kernel does ~130 multiply-adds per byte and is bound by its
// multiplies, not by these loads.  Twiddles are read from global memory
// (the table is 160 KB at the cap; threads of one i share one word).
// In the MMA build the 16 warps' reduction tiles (~83 KB) come on top of
// the 32 KB, as dynamic shared memory (one block per SM).
// ---------------------------------------------------------------------------
#define UG_CG_MAX_LOG 10
#define UG_CG_ELEMS (1 << UG_CG_MAX_LOG)

__global__ void __launch_bounds__(UG_CG_ELEMS / 2)
UG_SYM(fr_cg_ntt_k)(const uint32_t* x, const uint32_t* tw, uint32_t* y, int log_m,
                    int64_t cb, int cols) {
  __shared__ uint32_t s[8 * UG_CG_ELEMS];
#if UG_MMA_FIELD
  ug::mma_block_init<ug::FrParams>();
#endif
  const int m = 1 << log_m;
  const int nb = cols * m;                      // elements of this block
  const int64_t c0 = (int64_t)blockIdx.x * cols;
  for (int k = threadIdx.x; k < 8 * nb; k += blockDim.x) {
    const int l = k / nb, e = k - l * nb, j = e / cols, cc = e - j * cols;
    const int64_t c = c0 + cc;
    s[k] = c < cb ? x[((int64_t)l * m + j) * cb + c] : 0u;
  }
  __syncthreads();
  const int b = threadIdx.x;
  // nb / 2 == blockDim.x: every thread has a butterfly (the MMA build needs
  // all of them at every product)
  const bool active = UG_MMA_FIELD || b < nb / 2;
  for (int st = 0; st < log_m; st++) {
    ug::fe hi, lo;
    if (active)
      ug::cg_butterfly(s, tw + (int64_t)st * 8 * (m / 2), nb, m, cols, b, hi, lo);
    __syncthreads();
    if (active) ug::cg_store(s, nb, cols, b, hi, lo);
    __syncthreads();
  }
  // position j of a column holds X[bitrev(j)]: store it there
  for (int k = threadIdx.x; k < 8 * nb; k += blockDim.x) {
    const int l = k / nb, e = k - l * nb, j = e / cols, cc = e - j * cols;
    const int64_t c = c0 + cc;
    const int rj = (int)(__brev((unsigned)j) >> (32 - log_m));
    if (c < cb) y[((int64_t)l * m + rj) * cb + c] = s[k];
  }
}

extern "C" int UG_SYM(fr_cg_ntt)(const void* x, const void* tw, void* y, int log_m,
                                 int64_t cb, void* stream) {
  if (log_m < 1 || log_m > UG_CG_MAX_LOG) return (int)cudaErrorInvalidValue;
  const int cols = UG_CG_ELEMS >> log_m;
  const int64_t blocks = (cb + cols - 1) / cols;
  int smem;
  if (int rc = ug_kernel_smem(UG_SYM(fr_cg_ntt_k), UG_CG_ELEMS / 2, &smem)) return rc;
  UG_SYM(fr_cg_ntt_k)<<<(unsigned)blocks, UG_CG_ELEMS / 2, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)tw, (uint32_t*)y, log_m, cb, cols);
  return (int)cudaGetLastError();
}
