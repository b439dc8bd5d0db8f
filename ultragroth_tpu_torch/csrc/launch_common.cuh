// Launch helpers shared by the kernel sources, in both builds.
//
// UG_LANE_BEGIN(Pm, i, n) opens a one-thread-per-lane kernel body.  The
// CIOS build returns at once for a thread past the end.  The MMA build
// (UG_MMA_FIELD, mma_field.cuh) first builds the block's constant tiles of
// the tensor-core reduction, then keeps every thread: one past the end
// computes lane n-1's values with `live` false and stores nothing, so each
// warp reaches every warp-collective product together.
#pragma once
#include <cuda_runtime.h>
#include "curve.cuh"

#if UG_MMA_FIELD
#define UG_LANE_BEGIN(Pm, i, n)  \
  ug::mma_block_init<Pm>();      \
  const bool live = (i) < (n);   \
  if (!live) (i) = (n) - 1
#else
#define UG_LANE_BEGIN(Pm, i, n)  \
  if ((i) >= (n)) return;        \
  const bool live = true
#endif

static inline unsigned ug_grid(int64_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// The dynamic shared memory of one launch of `kernel` with `threads`
// threads into *bytes: 0 in the CIOS build, the MMA build's reduction tiles
// otherwise, with the kernel's limit raised where they pass the 48 KB that
// needs no opt-in.  Returns the CUDA error of a refused raise, else 0.
template <typename K>
static inline int ug_kernel_smem(K* kernel, int threads, int* bytes) {
#if UG_MMA_FIELD
  *bytes = ug::mma_smem_bytes(threads);
  if (*bytes > 48 * 1024)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     *bytes);
  return 0;
#else
  (void)kernel;
  (void)threads;
  *bytes = 0;
  return 0;
#endif
}
