// fr_cg_ntt's block program: the NTT of columns of N = 2^LOG_N points held
// in registers, radix 8 between exchanges through shared memory, and the
// Bailey split's twiddle product and transposed store folded into its last
// pass.  Built by csrc/fr_kernels.cu for the card and by the g++ host
// harness (csrc/host_harness.cpp), which runs the block's phases thread by
// thread.
//
// Replaces ultragroth_tpu/ops/ntt.py:_cg_kernel_call (:196).  Values only
// are fixed: every output equals the constant-geometry network's (and its
// bit reversal), the field being exact; the schedule is the Stockham one.
//
// Schedule.  A thread holds P = min(8, N) points of one column in
// registers, at positions t + i*T (i < P, T = N/P threads a column).  Pass
// p (radix R = 2^B, B <= 3; Ns = R_0 ... R_(p-1)) treats each of the
// thread's P/R groups, j = t + g*T: inputs r at j + r*N/R (slot g + r*G),
// each times w_(Ns R)^(r*(j mod Ns)), then the R-point DFT in registers
// (radix-2 decimation in frequency), output q to position
// (j div Ns)*Ns*R + (j mod Ns) + q*Ns.  The next pass reads positions
// t + i*T again, so a pass reads and writes the exchange buffer once each;
// after the last pass a thread's outputs sit at t + i*T in natural order
// and go straight to global memory.  At N = 2^10: passes of radix 8, 8, 8,
// 2; 4,224 products a column (4,097 of them by twiddles other than 1;
// radix 2: 5,120), three exchanges, six barriers.
//
// Memory.  Global loads and stores are made from registers, the columns of
// a block fastest across its threads (thread c + CPB*t holds column c), so
// a warp reads and writes runs of CPB adjacent words of one row; the
// transposed store (cb > 0, the Bailey split's first pass) writes runs of
// one column's outputs instead.  Shared memory: the twiddle table w^0 ..
// w^(N/2-1) (16.5 KB at the cap, entry e at e + e/32 so that the passes'
// strided reads fall in distinct banks; w^e = -w^(e - N/2) past the half),
// and the exchange buffer [8][N][CPB] whose point rows are swizzled so that
// every pass's writes and reads of a warp fall in distinct banks.  Index
// math is 32-bit shifts and masks inside a block.
//
// The MMA build's product is warp-collective: every thread runs the same
// products in the same order (a thread past the last column computes on
// that column's points and stores nothing).
#pragma once
#include "block.cuh"

// Threads a block (the exchange buffer is 256 B a thread): 512, one block
// an SM, in the CIOS build; 256 in the MMA build, whose 16 warps' tiles
// would not fit beside 512 threads' buffer.  The product: one out-of-line
// call (inlined at every call site, the kernel ran 1.5-1.9x slower;
// tools/torch_ntt_variants.py times both).
#if UG_MMA_FIELD
#define UG_NTT_THREADS 256
#else
#define UG_NTT_THREADS 512
#endif
#define UG_NTT_F ug::FieldCall<ug::FrParams>

namespace ug {

template <int LOG_N>
struct NttShape {
  static constexpr int N = 1 << LOG_N;
  static constexpr int LOG_P = LOG_N < 3 ? LOG_N : 3;
  static constexpr int P = 1 << LOG_P;        // points a thread holds
  static constexpr int LOG_T = LOG_N - LOG_P;
  static constexpr int T = 1 << LOG_T;        // threads a column
  static constexpr int H = N / 2;             // twiddle table: w^0 .. w^(H-1)
  static constexpr int HP = H + H / 32;       // a limb's plane of the staged table
  static constexpr int CPB = UG_NTT_THREADS / T;   // columns a block
  static_assert(CPB >= 1, "a block holds at least one column");
  // rows of a warp's accesses, and the swizzle that spreads them over banks
  static constexpr int SPAN = CPB < 32 ? 32 / CPB : 1;
  static constexpr int SWZ_SHIFT = SPAN > 8 ? (SPAN > 16 ? 5 : 4) : 3;
  UG_HD static int swz(int p) { return p ^ ((p >> SWZ_SHIFT) & (SPAN - 1)); }
  // word (limb l, point p, column c) of the exchange buffer
  UG_HD static int sidx(int l, int p, int c) { return ((l << LOG_N) + swz(p)) * CPB + c; }
};

// The arguments of one launch.
struct NttArgs {
  const uint32_t* x;    // [8][N][cols]
  const uint32_t* tw;   // [8][N/2]: w^0 .. w^(N/2-1)
  const uint32_t* stw;  // [8][cols/cb][N]: the folded split twiddles (cb > 0)
  uint32_t* y;          // [8][N][cols] (cb == 0), or [8][cols/cb][N][cb]
  int64_t cols;
  int64_t cb;           // 0: natural store; else the folded, transposed one
};

// w^e, 0 <= e < N, from the table of w^0 .. w^(N/2-1): in global memory
// (planes of H) or staged in shared memory (planes of HP, padded).
template <int LOG_N, bool kStaged>
struct NttTw {
  const uint32_t* t;
  // w^i, i < N/2
  UG_HD fe half(int i) const {
    using S = NttShape<LOG_N>;
    const int at = kStaged ? i + (i >> 5) : i;
    fe w;
#pragma unroll
    for (int l = 0; l < 8; l++) w.v[l] = t[l * (kStaged ? S::HP : S::H) + at];
    return w;
  }
  UG_HD fe operator()(int e) const {
    using S = NttShape<LOG_N>;
    const fe w = half(e & (S::H - 1));
    const fe nw = Fr::neg(w);
    const uint32_t neg = (e & S::H) ? ~0u : 0u;
    fe r;
#pragma unroll
    for (int l = 0; l < 8; l++) r.v[l] = (nw.v[l] & neg) | (w.v[l] & ~neg);
    return r;
  }
};

// q's B <= 3 bits reversed, without a loop: the slot it picks must be a
// constant as soon as q is one, or the points leave the registers
template <int B>
UG_HD constexpr int ntt_brev(int q) {
  return B == 3 ? ((q & 1) << 2) | (q & 2) | (q >> 2)
                : B == 2 ? ((q & 1) << 1) | (q >> 1) : q;
}

// The R-point DFT (R = 2^B) of slots s[0], s[G], .. s[(R-1)G] in place,
// radix 2 in frequency, w_R = w^(N/R): slot r ends holding output
// ntt_brev<B>(r).  5 products at R = 8, 1 at R = 4.  Stage ST (blocks of
// R >> ST slots) a template argument, so that every slot index is a
// constant and the slots stay in registers.
template <int LOG_N, int B, int G, int ST = 0, class Tw>
UG_HD void ntt_dft(fe* s, const Tw& tw) {
  constexpr int R = 1 << B, LEN = R >> ST, HALF = LEN / 2;
  if constexpr (LEN >= 2) {
#pragma unroll
    for (int blk = 0; blk < R; blk += LEN)
#pragma unroll
      for (int r = 0; r < HALF; r++) {
        const fe a = s[(blk + r) * G], b = s[(blk + r + HALF) * G];
        s[(blk + r) * G] = Fr::add(a, b);
        const fe d = Fr::sub(a, b);
        if (r == 0)
          s[(blk + r + HALF) * G] = d;
        else
          s[(blk + r + HALF) * G] = UG_NTT_F::mul(d, tw.half(r * (NttShape<LOG_N>::N / LEN)));
      }
    ntt_dft<LOG_N, B, G, ST + 1>(s, tw);
  }
}

// Pass of the schedule whose earlier passes made Ns = 2^LNS.
template <int LOG_N, int LNS>
struct NttPass {
  using S = NttShape<LOG_N>;
  static constexpr int B = LOG_N - LNS < 3 ? LOG_N - LNS : 3;
  static constexpr int R = 1 << B;
  static constexpr int G = S::P / R;      // the thread's groups
  static constexpr int NS = 1 << LNS;
  static constexpr bool kLast = LNS + B == LOG_N;

  // group g: its twiddles, then its DFT
  template <class Tw>
  UG_HD static void group(fe* v, int t, int g, const Tw& tw) {
    if (NS > 1) {
      const int k = (t + g * S::T) & (NS - 1);
#pragma unroll
      for (int r = 1; r < R; r++)
        v[g + r * G] = UG_NTT_F::mul(v[g + r * G], tw(r * k * (S::N / (NS * R))));
    }
    ntt_dft<LOG_N, B, G>(v + g, tw);
  }
  template <class Tw>
  UG_HD static void compute(fe* v, int t, const Tw& tw) {
#pragma unroll
    for (int g = 0; g < G; g++) group(v, t, g, tw);
  }
  // output q of group g: the slot holding it and its position in the column
  UG_HD static int slot(int g, int q) { return g + ntt_brev<B>(q) * G; }
  UG_HD static int pos(int t, int g, int q) {
    const int j = t + g * S::T;
    return ((j >> LNS) << (LNS + B)) + (j & (NS - 1)) + q * NS;
  }
};

// Per-thread points on the device: the thread's own registers.
struct NttDevRegs {
  fe v[8];
  UG_HD fe* operator()(int) { return v; }
};

// A thread's place: column c of the block (its global column `col`,
// clamped to the last one, and whether it is real), index t in its column.
template <int LOG_N>
struct NttLane {
  int c, t;
  int64_t col;
  bool live;
  UG_HD NttLane(int tid, int64_t blk, int64_t cols) {
    using S = NttShape<LOG_N>;
    c = tid & (S::CPB - 1);
    t = tid / S::CPB;
    const int64_t raw = blk * S::CPB + c;
    live = raw < cols;
    col = live ? raw : cols - 1;
  }
};

template <int LOG_N, int LNS>
UG_HD void ntt_write(uint32_t* sdat, const fe* v, const NttLane<LOG_N>& ln) {
  using S = NttShape<LOG_N>;
  using Ps = NttPass<LOG_N, LNS>;
#pragma unroll
  for (int g = 0; g < Ps::G; g++)
#pragma unroll
    for (int q = 0; q < Ps::R; q++) {
      const int p = Ps::pos(ln.t, g, q);
#pragma unroll
      for (int l = 0; l < 8; l++) sdat[S::sidx(l, p, ln.c)] = v[Ps::slot(g, q)].v[l];
    }
}

template <int LOG_N>
UG_HD void ntt_read(const uint32_t* sdat, fe* v, const NttLane<LOG_N>& ln) {
  using S = NttShape<LOG_N>;
#pragma unroll
  for (int i = 0; i < S::P; i++)
#pragma unroll
    for (int l = 0; l < 8; l++) v[i].v[l] = sdat[S::sidx(l, ln.t + i * S::T, ln.c)];
}

// The last pass, group by group, each group's outputs stored as soon as
// it is made (so the stores go out while the next groups compute): output
// q of group g is position k = t + (g + q*G)*T of the column, natural
// order; to y natural, or times the split twiddle and transposed.  Each
// split twiddle is loaded one output ahead, before the stores of the
// output before it (which might alias it), so its latency hides behind a
// product.
template <int LOG_N>
UG_HD fe ntt_split_twiddle(const NttArgs& a, int64_t m1, int64_t j1, int k) {
  fe w;
#pragma unroll
  for (int l = 0; l < 8; l++) w.v[l] = a.stw[((int64_t)l * m1 + j1) * NttShape<LOG_N>::N + k];
  return w;
}

template <int LOG_N, int LNS, class Tw>
UG_HD void ntt_finish(const NttArgs& a, fe* v, const NttLane<LOG_N>& ln, const Tw& tw) {
  using S = NttShape<LOG_N>;
  using Ps = NttPass<LOG_N, LNS>;
  int64_t j1 = 0, b = 0, m1 = 0;
  if (a.cb > 0) {
    j1 = ln.col / a.cb;
    b = ln.col - j1 * a.cb;
    m1 = a.cols / a.cb;
  }
  // the launchers give stw exactly when cb > 0; testing cb here in its
  // place costs the CIOS build 24 B of stack a thread (128 registers)
  const bool fold = a.stw != nullptr;
  fe next;
  if (fold) next = ntt_split_twiddle<LOG_N>(a, m1, j1, ln.t);
#pragma unroll
  for (int g = 0; g < Ps::G; g++) {
    Ps::group(v, ln.t, g, tw);
#pragma unroll
    for (int q = 0; q < Ps::R; q++) {
      const int k = ln.t + (g + q * Ps::G) * S::T;
      fe r = v[Ps::slot(g, q)];
      if (fold) {
        const fe w = next;
        // the output after (g, q): (g, q + 1), else (g + 1, 0)
        const int kn = q + 1 < Ps::R ? k + Ps::G * S::T : ln.t + (g + 1) * S::T;
        if (q + 1 < Ps::R || g + 1 < Ps::G) next = ntt_split_twiddle<LOG_N>(a, m1, j1, kn);
        r = UG_NTT_F::mul(r, w);
      }
      if (!ln.live) continue;
#pragma unroll
      for (int l = 0; l < 8; l++) {
        const int64_t at = a.cb > 0 ? (((int64_t)l * m1 + j1) * S::N + k) * a.cb + b
                                    : ((int64_t)l * S::N + k) * a.cols + ln.col;
        a.y[at] = r.v[l];
      }
    }
  }
}

// One phase of a block's program for thread tid (a functor, not a lambda,
// so that it inlines into the kernel and the points stay in registers):
//   kFirst    load the thread's points, stage the table, make the first
//             pass (no twiddles before it; its DFT's constants from the
//             global table), write its outputs (or, the last, store them);
//   kCompute  read the pass's points from the exchange buffer, make the
//             pass (the last: store its outputs as it goes);
//   kWrite    write the pass's outputs to the exchange buffer.
enum { kNttFirst, kNttCompute, kNttWrite };

template <int LOG_N, int LNS, int KIND, class Regs>
struct NttPhase {
  Regs& regs;
  const NttArgs& a;
  uint32_t* sdat;
  uint32_t* stws;
  int64_t blk;
  UG_HD void operator()(int tid) const {
    using S = NttShape<LOG_N>;
    using Ps = NttPass<LOG_N, LNS>;
    const NttLane<LOG_N> ln(tid, blk, a.cols);
    fe* v = regs(tid);
    if constexpr (KIND == kNttFirst) {
      // the points' loads first: the table's stores could alias them
#pragma unroll
      for (int i = 0; i < S::P; i++)
#pragma unroll
        for (int l = 0; l < 8; l++)
          v[i].v[l] = a.x[((int64_t)l * S::N + ln.t + i * S::T) * a.cols + ln.col];
      for (int i = tid; i < 8 * S::H; i += UG_NTT_THREADS) {
        const int l = i / S::H, e = i & (S::H - 1);
        stws[l * S::HP + e + (e >> 5)] = a.tw[i];
      }
      const NttTw<LOG_N, false> tw{a.tw};
      if constexpr (Ps::kLast) {
        ntt_finish<LOG_N, LNS>(a, v, ln, tw);
      } else {
        Ps::compute(v, ln.t, tw);
        ntt_write<LOG_N, LNS>(sdat, v, ln);
      }
    } else if constexpr (KIND == kNttCompute) {
      ntt_read<LOG_N>(sdat, v, ln);
      const NttTw<LOG_N, true> tw{stws};
      if constexpr (Ps::kLast)
        ntt_finish<LOG_N, LNS>(a, v, ln, tw);
      else
        Ps::compute(v, ln.t, tw);
    } else {
      ntt_write<LOG_N, LNS>(sdat, v, ln);
    }
  }
};

// The passes from the one whose earlier passes made Ns = 2^LNS: each reads
// the exchange buffer and computes, then writes it, a barrier after each.
template <int LOG_N, int LNS, class Run, class Regs>
UG_HD void ntt_passes(Run& run, Regs& regs, const NttArgs& a, uint32_t* sdat,
                      uint32_t* stws, int64_t blk) {
  using Ps = NttPass<LOG_N, LNS>;
  run.block(NttPhase<LOG_N, LNS, kNttCompute, Regs>{regs, a, sdat, stws, blk});
  if constexpr (!Ps::kLast) {
    run.block(NttPhase<LOG_N, LNS, kNttWrite, Regs>{regs, a, sdat, stws, blk});
    ntt_passes<LOG_N, LNS + Ps::B>(run, regs, a, sdat, stws, blk);
  }
}

// The block `blk` (columns blk*CPB ..): `regs(tid)` is thread tid's
// points, `stws` the staged table (8 x HP words), `sdat` the exchange
// buffer (8 x N x CPB words; none when one pass does it all).
template <int LOG_N, class Run, class Regs>
UG_HD void ntt_cols_body(Run& run, Regs& regs, const NttArgs& a, uint32_t* sdat,
                         uint32_t* stws, int64_t blk) {
  using P0 = NttPass<LOG_N, 0>;
  run.block(NttPhase<LOG_N, 0, kNttFirst, Regs>{regs, a, sdat, stws, blk});
  if constexpr (!P0::kLast) ntt_passes<LOG_N, P0::B>(run, regs, a, sdat, stws, blk);
}

// Dynamic shared memory of a block past the MMA build's tiles: the staged
// table, then the exchange buffer.
template <int LOG_N>
constexpr int ntt_smem_bytes() {
  using S = NttShape<LOG_N>;
  return 32 * S::HP + (NttPass<LOG_N, 0>::kLast ? 0 : 32 * S::N * S::CPB);
}

}  // namespace ug
