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
// threads into *bytes: the MMA build's reduction tiles (none in the CIOS
// build) and then `extra` bytes of the kernel's own, with the kernel's
// limit raised where they pass the 48 KB that need no opt-in.  Returns the
// CUDA error of a refused raise, else 0.
template <typename K>
static inline int ug_kernel_smem(K* kernel, int threads, int* bytes, int extra = 0) {
#if UG_MMA_FIELD
  *bytes = ug::mma_smem_bytes(threads) + extra;
#else
  (void)threads;
  *bytes = extra;
#endif
  if (*bytes > 48 * 1024)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     *bytes);
  return 0;
}

// ---------------------------------------------------------------------------
// The bucket drain's prefetch: cp.async (16 B, L2 only) into two slots per
// thread in dynamic shared memory, after the MMA tiles in the MMA build.
// Slot layout [buffer][16 B vector][thread], so a warp's 16-byte accesses
// of one vector are 512 contiguous bytes (no bank conflicts).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void ug_cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void ug_cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void ug_cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

#if !UG_MMA_FIELD
extern __shared__ __align__(16) unsigned char ug_dyn_smem_raw[];
#endif

// A kernel's own dynamic shared memory (16-byte aligned): after the MMA
// build's tiles, or all of it in the CIOS build.
__device__ __forceinline__ unsigned char* ug_own_smem() {
#if UG_MMA_FIELD
  return ug::mma_smem() + ug::kMmaConstBytes + (blockDim.x >> 5) * ug::kMmaWarpBytes;
#else
  return ug_dyn_smem_raw;
#endif
}

__device__ __forceinline__ uint4* ug_drain_slots() { return (uint4*)ug_own_smem(); }

template <class F>
constexpr int ug_drain_slot_bytes(int threads) {
  return 2 * ug::PointIO<F>::kVecs * 16 * threads;
}

// The kernels' fetch (the interface of curve.cuh's DirectFetch): issue(ent)
// starts the copy of the entry's point into the other slot, take() waits
// for it and reads it.  The drain issues step t+1 after taking step t, so
// the slot a copy lands in was read a whole step earlier.  (Its methods are
// __host__ __device__, as the lane body that calls them, with device-only
// bodies: nvcc's host pass parses the kernels.)
template <class F>
struct SlotFetch {
  static constexpr int kVecs = ug::PointIO<F>::kVecs;
  const uint4* table;
  uint4* slot;      // this thread's vector 0 of buffer 0
  int threads;
  int buf;          // the buffer of the copy in flight
  int32_t ent;      // its entry
  __host__ __device__ SlotFetch(const uint32_t* t, int tid, int nthreads)
      : table((const uint4*)t), slot(nullptr), threads(nthreads), buf(1), ent(0) {
#if defined(__CUDA_ARCH__)
    slot = ug_drain_slots() + tid;
#else
    (void)tid;
#endif
  }
  __host__ __device__ void issue(int32_t e) {
    buf ^= 1;
    ent = e;
#if defined(__CUDA_ARCH__)
    const uint4* src = table + (int64_t)(e >> 1) * kVecs;
    uint4* dst = slot + buf * kVecs * threads;
#pragma unroll
    for (int j = 0; j < kVecs; j++) ug_cp_async16(dst + j * threads, src + j);
    ug_cp_async_commit();
#endif
  }
  __host__ __device__ void take(typename F::E& qx, typename F::E& qy) {
#if defined(__CUDA_ARCH__)
    ug_cp_async_wait_all();
    const uint4* s = slot + buf * kVecs * threads;
    uint32_t w[ug::PointIO<F>::kWords];
#pragma unroll
    for (int j = 0; j < kVecs; j++) {
      const uint4 v = s[j * threads];
      w[4 * j] = v.x; w[4 * j + 1] = v.y; w[4 * j + 2] = v.z; w[4 * j + 3] = v.w;
    }
    ug::point_from_words<F>(w, ent, qx, qy);
#else
    (void)qx;
    (void)qy;
#endif
  }
};
