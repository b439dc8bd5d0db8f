// How a block program runs: on the device, or thread by thread in the g++
// host harness (used by csrc/reduce.cuh and csrc/ntt.cuh).
#pragma once
#include "field.cuh"

namespace ug {

// ---------------------------------------------------------------------------
// Block programs.  A kernel body is a sequence of phases; in a phase every
// thread of the block runs the same function of its thread index, then the
// warp (warp()) or the block (block()) synchronises.  On the device
// (DevBlock) that is the thread itself and __syncwarp / __syncthreads; the
// host harness (HostBlock) runs the phase for every thread index in turn,
// which is the same computation because no phase reads what another thread
// writes in it.
// ---------------------------------------------------------------------------
struct DevBlock {
  int tid;
  // the block's first warp, which runs a chain alone (the other warps of
  // its SM sub-partitions would share their integer pipes with it)
  UG_HD bool in_lead() const { return tid < 32; }
  UG_HD DevBlock lead() const { return *this; }
  template <class Fn>
  UG_HD void warp(Fn&& f) {
    f(tid);
#if defined(__CUDA_ARCH__)
    __syncwarp();
#endif
  }
  template <class Fn>
  UG_HD void block(Fn&& f) {
    f(tid);
#if defined(__CUDA_ARCH__)
    __syncthreads();
#endif
  }
};

struct HostBlock {
  int threads;
  bool in_lead() const { return true; }
  HostBlock lead() const { return HostBlock{threads < 32 ? threads : 32}; }
  template <class Fn>
  void warp(Fn&& f) {
    for (int t = 0; t < threads; t++) f(t);
  }
  template <class Fn>
  void block(Fn&& f) {
    for (int t = 0; t < threads; t++) f(t);
  }
};

}  // namespace ug
