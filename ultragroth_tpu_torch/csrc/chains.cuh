// The per-key point chains: the device set-up's fixed-base ladder
// (curve_fixed_base_mul) and the fixed-base MSM's window table
// (curve_window_table), each ONE launch whose lanes run their whole chain
// with the accumulator in registers and end in a batch to-affine inside the
// kernel (affine_epilogue).  __host__ __device__ block programs: the
// kernels of curve_kernels.inc run them, and the g++ host harness runs
// them phase by phase, thread by thread (block.cuh).
//
// Replaces:
//  * the ladder: ultragroth_tpu/ops/kernels.py:64 (curve_madd_valid), 32
//    launches a run of the device set-up's 8-bit windowed fixed-base
//    multiplication (testkit/dsetup.py:_fb_run), and the plain to-affine
//    after them (ops/curve.py CurveOps.to_affine: Fq.batch_inv_mont's two
//    Hillis-Steele scans of plain tensor products);
//  * the window table: ultragroth_tpu/ops/kernels.py:171 (curve_add_where)
//    as the (nw - 1) * c launches of curve_add_where(P, P) that double the
//    table's points (ops/msm.py:msm_fixed_table), and the plain to-affine
//    of every window's rows.  curve_add_where's other use, the fixed-base
//    prove's window folds, keeps its kernel.
//
// What bounds them on the H100: operations.  A ladder lane makes 32 mixed
// adds (8 products and 2 squares each where both sides are finite), a
// table lane c doublings a window (dbl: 9 products); the to-affine ~6
// products a lane (zz * zzz, the batch trick's two, x / zz, y / zzz), an
// Fq2 lane three times as many Fq ones.  At 2^20 lanes: ~5.4 ms (G1) / 15
// ms (G2) a ladder run, ~37 ms / ~99 ms a table at c = 17, nw = 15, whose
// 1 GB / 2 GB of rows take 0.3 / 0.6 ms to write.  Bytes are no limit: a
// ladder lane reads 32 B of scalar and writes its affine point; the
// 32 x 256 window table (0.5 MB G1, 1 MB G2) sits in L2.
//
// What the design does about it:
//  1. the accumulator stays in registers for the whole chain: no 128 B (G1)
//     / 256 B (G2) xyzz read and written a step, as the per-step kernels
//     did (238 such launches a table set, 32 a ladder run);
//  2. the ladder stages window w's 256 points (16 KB G1, 32 KB G2, and
//     their infinity flags) in shared memory while step w - 1 computes
//     (cp.async into the other of two buffers); every lane of a block is
//     at the same window, and its digit picks one staged point;
//  3. the ladder's add is the incomplete mixed add, redone from the
//     accumulator it started with by the complete one where the x
//     coordinates meet (curve.cuh fixed_base_step): canonical scalars
//     never meet it, as the partial sum after w windows is below 256^w
//     and a scalar below r, so a step costs 10 products, not the complete
//     add's 19;
//  4. the to-affine is Montgomery's trick across the block: a product
//     tree of the lanes' zz * zzz in shared memory (an Fq2 value through
//     its norm), ONE Fermat inversion of its root by the block's first
//     warp while the others wait, the inverses carried back down the
//     tree, ~8 products a lane; a per-lane Fermat chain costs ~330 (on
//     the H100 it ran the G1 table 1.58x and the G2 table 1.07x slower,
//     the G1 ladder 1.04x slower and the G2 ladder 1.03x faster:
//     tools/torch_chain_variants.py).  Infinity lanes come out (0, 0)
//     with their flag, as CurveOps.to_affine gives them;
//  5. the Fq product is one out-of-line call in both groups
//     (curve_kernels.inc UG_CHAIN_F): inlined, the G1 table ran 1.36x
//     slower and g1_kernels.cu took ~5 minutes to compile.
// Outputs equal the plain versions' (kernels.py curve_fixed_base_mul_plain,
// curve_window_table_plain) word for word: affine coordinates are unique
// and canonical at exit.
//
// The MMA build (UG_MMA_FIELD) needs every thread of a warp at each product
// together: a lane past the end computes the last lane's values and stores
// nothing, a phase that works on the first m threads runs whole warps
// (chain_runs), and the first warp's 32 threads all run the inversion.
#pragma once
#include "block.cuh"
#include "curve.cuh"

namespace ug {

constexpr int kChainThreads = 128;   // threads (lanes) a block; a power of two
constexpr int kFbWindows = 32;       // the ladder: 8-bit digits of a 256-bit scalar
constexpr int kFbDigits = 256;

// Per-thread registers of a block program: on the device the thread's own
// (the host harness keeps one per thread index).
template <class S>
struct DevRegsOf {
  S s;
  UG_HD S& operator()(int) { return s; }
};

// The Fq field under F (Fq / FqCall, or the base of an Fq2).
template <class F>
struct BaseOf { using T = F; };
template <class B>
struct BaseOf<Fq2Over<B>> { using T = B; };

// The Fq value a lane's d enters the product tree with, and d's inverse
// from that value's inverse li: d itself (Fq); its norm, (d0 li, -d1 li)
// (Fq2).
template <class B>
UG_HD fe inv_leaf(const fe& d) { return d; }
template <class B>
UG_HD fe inv_leaf(const fe2& d) { return Fq2Over<B>::norm(d); }
template <class B>
UG_HD fe inv_apply(const fe&, const fe& li) { return li; }
template <class B>
UG_HD fe2 inv_apply(const fe2& d, const fe& li) { return Fq2Over<B>::conj_scale(d, li); }

// One lane of a chain.
template <class F>
struct ChainLane {
  xyzz<F> a;            // the accumulator
  typename F::E d;      // the epilogue's zz * zzz
  int64_t i;            // the lane (past the end: the last one)
  bool live;            // a real lane: stores its outputs
};

// A block's lane: blk * kChainThreads + t, clamped to the last of n.
template <class F>
UG_HD void chain_lane(ChainLane<F>& l, int64_t blk, int t, int64_t n) {
  const int64_t raw = blk * kChainThreads + t;
  l.live = raw < n;
  l.i = l.live ? raw : n - 1;
}

// Does thread t run a phase's work on the first m threads?  CIOS: t < m.
// MMA: every thread of a warp that holds one of them (a thread past m
// repeats thread m - 1's products and stores nothing).
UG_HD bool chain_runs(int t, int64_t m) {
#if UG_MMA_FIELD
  return (t & ~31) < m;
#else
  return t < m;
#endif
}

// the live lanes of block blk of n lanes: a ragged last block's chain
// steps run on its lanes' warps only
UG_HD int64_t chain_live(int64_t blk, int64_t n) { return n - blk * kChainThreads; }

// The epilogue's shared memory (12 KB): the product tree (node k's
// children 2k, 2k + 1; lane t's leaf kChainThreads + t) and the inverses
// of its inner nodes.
struct AffineSmem {
  fe tree[2 * kChainThreads];
  fe inv[kChainThreads];
};

// The affine epilogue: every lane's xyzz accumulator to affine (x, y, inf)
// with one inversion for the block; store(t, lane, x, y, inf) for each live
// lane, x and y canonical ((0, 0) at infinity).  16 barriers at 128
// threads: the leaves, 7 tree levels up, the inversion, 6 levels down, the
// lanes' own inverses.  A lane at infinity or past the end enters the
// tree as one.
template <class F, class Run, class Regs, class Store>
UG_HD void affine_epilogue(Run& run, Regs& regs, AffineSmem* sm, Store store) {
  using E = typename F::E;
  using B = typename BaseOf<F>::T;
  constexpr int NT = kChainThreads;
  run.block([&](int t) {
    ChainLane<F>& l = regs(t);
    l.d = F::mul(l.a.zz, l.a.zzz);
    const fe leaf = inv_leaf<B>(l.d);
    sm->tree[NT + t] = (F::is_zero(l.a.zz) || !l.live) ? B::one_mont() : leaf;
  });
  for (int m = NT / 2; m >= 1; m >>= 1)
    run.block([&](int t) {
      if (!chain_runs(t, m)) return;
      const int k = m + (t < m ? t : m - 1);
      const fe v = B::mul(sm->tree[2 * k], sm->tree[2 * k + 1]);
      if (t < m) sm->tree[k] = v;
    });
  run.block([&](int t) {
    if (!chain_runs(t, 1)) return;       // the block's first warp alone
    const fe v = B::inv(sm->tree[1]);
    if (t == 0) sm->inv[1] = v;
  });
  for (int m = 2; m < NT; m <<= 1)
    run.block([&](int t) {
      if (!chain_runs(t, m)) return;
      const int k = m + (t < m ? t : m - 1);
      const fe v = B::mul(sm->inv[k >> 1], sm->tree[k ^ 1]);
      if (t < m) sm->inv[k] = v;
    });
  run.block([&](int t) {
    ChainLane<F>& l = regs(t);
    const int k = NT + t;
    const fe li = B::mul(sm->inv[k >> 1], sm->tree[k ^ 1]);
    const E di = inv_apply<B>(l.d, li);
    const bool inf = F::is_zero(l.a.zz);
    E x = F::mul(F::mul(l.a.x, l.a.zzz), di);
    E y = F::mul(F::mul(l.a.y, l.a.zz), di);
    if (inf) {
      x = F::zero();
      y = F::zero();
    }
    if (l.live) store(t, l, F::exit(x), F::exit(y), inf);
  });
}

// A copy of one 4-byte word into shared memory: asynchronous on the device
// (cp.async, waited for by stage_wait before the phase's barrier), plain
// on the host.
UG_HD void stage_word(uint32_t* dst, const uint32_t* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src) : "memory");
#else
  *dst = *src;
#endif
}

UG_HD void stage_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;" ::: "memory");
#endif
}

// ---------------------------------------------------------------------------
// The fixed-base ladder (curve_fixed_base_mul): lane i's 32 steps, step w
// adding entry 256*w + digit w of its standard-form scalar of the affine
// window table, then the epilogue.
// ---------------------------------------------------------------------------
struct FixedBaseArgs {
  const uint32_t* table;    // [2][K][8][T] Montgomery affine, plane-major
  const uint8_t* tinf;      // [T]: entry at infinity (4-byte aligned)
  int64_t T;                // >= 32 * 256
  const uint32_t* scalars;  // [8][n] standard form
  uint32_t* out;            // [2][K][8][n]: x, y
  uint8_t* out_inf;         // [n]
  int64_t n;
};

// A window's staged points: [16-byte vector j][digit d] (word q of vector j
// at ((j * 256 + d) * 4 + q)), then its 256 flags; two such buffers.
template <class F>
struct FbStage {
  static constexpr int kWords = 256 * PointIO<F>::kWords;
  static constexpr int kBytes = 4 * kWords + kFbDigits;
};

template <class F>
constexpr int fixed_base_smem_bytes() {
  return (int)sizeof(AffineSmem) + 2 * FbStage<F>::kBytes;
}

// thread t's share of window w's staging into buffer `st` (words, then the
// flags as 64 words)
template <class F>
UG_HD void fb_stage(const FixedBaseArgs& a, uint32_t* st, int w, int t) {
  constexpr int KW = PointIO<F>::kWords;
  for (int k = t; k < kFbDigits * KW; k += kChainThreads) {
    const int word = k >> 8, d = k & (kFbDigits - 1);
    stage_word(st + ((word >> 2) * kFbDigits + d) * 4 + (word & 3),
               a.table + (int64_t)word * a.T + kFbDigits * w + d);
  }
  const uint32_t* flags = (const uint32_t*)(a.tinf + kFbDigits * w);
  for (int k = t; k < kFbDigits / 4; k += kChainThreads)
    stage_word(st + FbStage<F>::kWords + k, flags + k);
}

// staged point d of buffer `st`
template <class F>
UG_HD void fb_point(const uint32_t* st, int d, typename F::E& qx, typename F::E& qy) {
  constexpr int KV = PointIO<F>::kVecs;
  uint32_t w[PointIO<F>::kWords];
#pragma unroll
  for (int j = 0; j < KV; j++) {
#if defined(__CUDA_ARCH__)
    const uint4 v = ((const uint4*)st)[j * kFbDigits + d];
    w[4 * j] = v.x; w[4 * j + 1] = v.y; w[4 * j + 2] = v.z; w[4 * j + 3] = v.w;
#else
#pragma unroll
    for (int q = 0; q < 4; q++) w[4 * j + q] = st[(j * kFbDigits + d) * 4 + q];
#endif
  }
  elem_from_words(w, qx);
  elem_from_words(w + PointIO<F>::kWords / 2, qy);
}

// Block blk of the ladder; `stage`: the two staging buffers
// (fixed_base_smem_bytes past the epilogue's).
template <class F, class Run, class Regs>
UG_HD void fixed_base_body(Run& run, Regs& regs, const FixedBaseArgs& a, AffineSmem* sm,
                           uint32_t* stage, int64_t blk) {
  using E = typename F::E;
  constexpr int SW = FbStage<F>::kBytes / 4;
  run.block([&](int t) {
    ChainLane<F>& l = regs(t);
    chain_lane(l, blk, t, a.n);
    l.a = inf_xyzz<F>();
    fb_stage<F>(a, stage, 0, t);
    stage_wait();
  });
  for (int w = 0; w < kFbWindows; w++)
    run.block([&](int t) {
      ChainLane<F>& l = regs(t);
      if (w + 1 < kFbWindows) fb_stage<F>(a, stage + ((w + 1) & 1) * SW, w + 1, t);
      if (chain_runs(t, chain_live(blk, a.n))) {
        const uint32_t* st = stage + (w & 1) * SW;
        const int d = (int)fixed_base_digit(a.scalars, a.n, l.i, w);
        E qx, qy;
        fb_point<F>(st, d, qx, qy);
        const bool q_inf = ((const uint8_t*)(st + FbStage<F>::kWords))[d] != 0;
        l.a = fixed_base_step<F>(l.a, qx, qy, q_inf);
      }
      stage_wait();
    });
  affine_epilogue<F>(run, regs, sm, [&](int, const ChainLane<F>& l, const E& x,
                                        const E& y, bool inf) {
    store_elem(a.out, a.n, l.i, 0, x);
    store_elem(a.out, a.n, l.i, 1, y);
    a.out_inf[l.i] = inf ? 1 : 0;
  });
}

// ---------------------------------------------------------------------------
// The window table (curve_window_table): lane i loads point i of window 0
// once, then for w = 1 .. nw - 1 doubles it c times and stores its affine
// row w * npad + i of the point-major table.
// ---------------------------------------------------------------------------
struct WindowTableArgs {
  const uint32_t* table;    // [npad][2][K][8] Montgomery affine: window 0
  const uint8_t* inf;       // [npad]
  uint32_t* out;            // [nw * npad][2][K][8]
  int64_t npad;
  int c, nw;
};

// words [kWords] of a point-major row, 16-byte aligned
template <class F>
UG_HD void row_load(const uint32_t* row, uint32_t* w) {
#pragma unroll
  for (int j = 0; j < PointIO<F>::kVecs; j++) {
#if defined(__CUDA_ARCH__)
    const uint4 v = ((const uint4*)row)[j];
    w[4 * j] = v.x; w[4 * j + 1] = v.y; w[4 * j + 2] = v.z; w[4 * j + 3] = v.w;
#else
#pragma unroll
    for (int q = 0; q < 4; q++) w[4 * j + q] = row[4 * j + q];
#endif
  }
}

template <class F>
UG_HD void row_store(uint32_t* row, const uint32_t* w) {
#pragma unroll
  for (int j = 0; j < PointIO<F>::kVecs; j++) {
#if defined(__CUDA_ARCH__)
    ((uint4*)row)[j] = make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]);
#else
#pragma unroll
    for (int q = 0; q < 4; q++) row[4 * j + q] = w[4 * j + q];
#endif
  }
}

UG_HD void elem_to_words(const fe& a, uint32_t* w) {
#pragma unroll
  for (int l = 0; l < 8; l++) w[l] = a.v[l];
}
UG_HD void elem_to_words(const fe2& a, uint32_t* w) {
  elem_to_words(a.c0, w);
  elem_to_words(a.c1, w + 8);
}

template <class F, class Run, class Regs>
UG_HD void window_table_body(Run& run, Regs& regs, const WindowTableArgs& a, AffineSmem* sm,
                             int64_t blk) {
  using E = typename F::E;
  constexpr int KW = PointIO<F>::kWords;
  run.block([&](int t) {
    ChainLane<F>& l = regs(t);
    chain_lane(l, blk, t, a.npad);
    uint32_t w[KW];
    row_load<F>(a.table + l.i * KW, w);
    elem_from_words(w, l.a.x);
    elem_from_words(w + KW / 2, l.a.y);
    l.a.zz = a.inf[l.i] ? F::zero() : F::one_mont();
    l.a.zzz = l.a.zz;
  });
  for (int win = 1; win < a.nw; win++) {
    run.block([&](int t) {
      ChainLane<F>& l = regs(t);
      if (!chain_runs(t, chain_live(blk, a.npad))) return;
      for (int k = 0; k < a.c; k++) l.a = dbl<F>(l.a);
    });
    affine_epilogue<F>(run, regs, sm, [&](int, const ChainLane<F>& l, const E& x,
                                          const E& y, bool) {
      uint32_t w[KW];
      elem_to_words(x, w);
      elem_to_words(y, w + KW / 2);
      row_store<F>(a.out + ((int64_t)win * a.npad + l.i) * KW, w);
    });
  }
}

}  // namespace ug
