// Host build of the kernels' lane bodies (g++, no CUDA): every launcher of
// the .cu files as a plain loop over lanes, with the carry-chain
// primitives emulated (field.cuh).  The CPU tests build it to check the
// kernels' arithmetic against the plain PyTorch versions without a card.
// Built a second time with -DUG_MMA_FIELD=1, it runs the MMA build's lane
// bodies (branch-free) over mma_field.cuh's product with plain loops in
// place of the tensor-core tile products.
#include <vector>

#include "chains.cuh"
#include "ntt.cuh"
#include "reduce.cuh"

// The reduction's tail and the window combine: each block's program
// (reduce.cuh) with every phase run for each thread index in turn, the
// kernels' blocks one after another, their launch shapes.
template <class F>
int host_reduce_tail(const void* state, int64_t state_n, const void* groups, int ngroups,
                     int64_t nblocks, int u, int arrays_max, void* out, int64_t out_n) {
  using E = typename F::E;
  const int threads = ug::kTailThreads;
  std::vector<ug::TeamSlots<E>> teams(threads / ug::Split<E>::kTeam);
  std::vector<ug::Pt<E>> buf(arrays_max * u + (arrays_max + 1) * (u / 2) + 1);
  for (int64_t blk = 0; blk < nblocks; blk++) {
    int64_t b = blk;
    const int64_t* d = ug::tail_group((const int64_t*)groups, ngroups, b);
    ug::HostBlock run{threads};
    ug::reduce_tail_body<F>(run, threads, teams.data(), buf.data(),
                            buf.data() + arrays_max * u, (const uint32_t*)state, state_n,
                            d[0] + b * u, d[1] * u, (int)d[3], u, (int)d[4],
                            (uint32_t*)out, out_n, d[2] + b);
  }
  return 0;
}

// A wide level of the reduction: thread by thread (G1), or by teams, the
// kernel's blocks of kTailThreads threads in turn (G2).
template <class F, bool kTeamStep>
int host_reduce_step(const void* in, int64_t in_n, void* out, int64_t out_n,
                     const void* segs, int nseg, int64_t n) {
  using E = typename F::E;
  if (!kTeamStep) {
    for (int64_t i = 0; i < n; i++)
      ug::lane_reduce_step<F>((const uint32_t*)in, in_n, (uint32_t*)out, out_n,
                              (const int64_t*)segs, nseg, i, true);
    return 0;
  }
  const int threads = ug::kTailThreads, adds = threads / ug::Split<E>::kTeam;
  std::vector<ug::TeamSlots<E>> teams(adds);
  for (int64_t first = 0; first < n; first += adds) {
    ug::HostBlock run{threads};
    ug::reduce_step_team_body<F>(run, teams.data(), (const uint32_t*)in, in_n,
                                 (uint32_t*)out, out_n, (const int64_t*)segs, nseg, n,
                                 first);
  }
  return 0;
}

template <class F>
int host_window_combine(const void* pts, int64_t W, int c, void* out) {
  using E = typename F::E;
  const int m = ug::combine_width(W);
  const int64_t nblk = ug::combine_blocks<E>(W);
  std::vector<ug::TeamSlots<E>> teams(32 / ug::Split<E>::kTeam);
  std::vector<ug::Pt<E>> buf(m + m / 2);
  std::vector<uint32_t> scaled(4 * (sizeof(E) / 4) * m);
  int counter = 0, flag = 0;
  for (int64_t blk = 0; blk < nblk; blk++) {
    ug::HostBlock run{32};
    ug::combine_body<F>(run, 32, teams.data(), buf.data(), buf.data() + m,
                        (const uint32_t*)pts, W, c, blk, nblk, scaled.data(), &counter,
                        &flag, (uint32_t*)out);
  }
  return counter;     // 0: the last block reset it
}

// The bucket drain: lane by lane, each loading its points at the step that
// adds them (DirectFetch).  The MMA build's lanes run to the largest end of
// their group of 32 (the warp of the kernel), as the kernel's do.
#define UG_HOST_CURVE(G, F, TEAM_STEP)                                        \
  extern "C" int ugh_##G##_bucket_drain(const void* acc, void* out,           \
      const void* table, const void* orders, const void* gidx,                \
      const void* stride, const void* cnt, int32_t t_from, int32_t t_to,      \
      int64_t n) {                                                            \
    const int32_t* c = (const int32_t*)cnt;                                   \
    for (int64_t i = 0; i < n; i++) {                                         \
      int32_t stop_all = ug::drain_stop(c, t_to, i);                          \
      if (UG_MMA_FIELD)                                                       \
        for (int64_t j = i & ~(int64_t)31; j < (i | 31) + 1 && j < n; j++) {  \
          const int32_t s = ug::drain_stop(c, t_to, j);                       \
          stop_all = s > stop_all ? s : stop_all;                             \
        }                                                                     \
      ug::DirectFetch<F> f{(const uint32_t*)table, 0};                        \
      ug::lane_bucket_drain<F>((const uint32_t*)acc, (uint32_t*)out,          \
          (const int32_t*)orders, (const int32_t*)gidx,                       \
          (const int32_t*)stride, c, t_from, t_to, stop_all, n, i, true, f);  \
    }                                                                         \
    return 0;                                                                 \
  }                                                                           \
  extern "C" int ugh_##G##_add_where(const void* a, const void* b,            \
      const void* ok, void* out, int64_t n) {                                 \
    for (int64_t i = 0; i < n; i++)                                           \
      ug::lane_add_where<F>((const uint32_t*)a, (const uint32_t*)b,           \
          (const uint8_t*)ok, (uint32_t*)out, n, i);                          \
    return 0;                                                                 \
  }                                                                           \
  extern "C" int ugh_##G##_reduce_step(const void* in, int64_t in_n, void* out,  \
      int64_t out_n, const void* segs, int nseg, int64_t n) {                 \
    return host_reduce_step<F, TEAM_STEP>(in, in_n, out, out_n, segs, nseg,  \
                                          n);                                 \
  }                                                                           \
  extern "C" int ugh_##G##_reduce_tail(const void* state, int64_t state_n,    \
      const void* groups, int ngroups, int64_t nblocks, int u,                \
      int arrays_max, void* out, int64_t out_n) {                             \
    return host_reduce_tail<F>(state, state_n, groups, ngroups, nblocks, u,   \
                               arrays_max, out, out_n);                       \
  }                                                                           \
  extern "C" int ugh_##G##_window_combine(const void* pts, int64_t W, int c,  \
                                          void* out) {                        \
    return host_window_combine<F>(pts, W, c, out);                            \
  }

// The per-key chains (chains.cuh): each block's program with every phase
// run for each thread index in turn, the kernels' blocks one after another,
// each thread's registers one slot of a vector.
template <class S>
struct HostRegs {
  std::vector<S> v;
  S& operator()(int t) { return v[t]; }
};

template <class F>
int host_fixed_base_mul(const void* table, const void* tinf, int64_t T, const void* scalars,
                        void* out, void* out_inf, int64_t n) {
  const ug::FixedBaseArgs a{(const uint32_t*)table, (const uint8_t*)tinf, T,
                            (const uint32_t*)scalars, (uint32_t*)out, (uint8_t*)out_inf, n};
  std::vector<ug::AffineSmem> sm(1);
  std::vector<uint32_t> stage(ug::fixed_base_smem_bytes<F>() / 4);
  HostRegs<ug::ChainLane<F>> regs{std::vector<ug::ChainLane<F>>(ug::kChainThreads)};
  for (int64_t blk = 0; blk * ug::kChainThreads < n; blk++) {
    ug::HostBlock run{ug::kChainThreads};
    ug::fixed_base_body<F>(run, regs, a, sm.data(), stage.data(), blk);
  }
  return 0;
}

template <class F>
int host_window_table(const void* table, const void* inf, void* out, int64_t npad, int c,
                      int nw) {
  const ug::WindowTableArgs a{(const uint32_t*)table, (const uint8_t*)inf, (uint32_t*)out,
                              npad, c, nw};
  std::vector<ug::AffineSmem> sm(1);
  HostRegs<ug::ChainLane<F>> regs{std::vector<ug::ChainLane<F>>(ug::kChainThreads)};
  for (int64_t blk = 0; blk * ug::kChainThreads < npad; blk++) {
    ug::HostBlock run{ug::kChainThreads};
    ug::window_table_body<F>(run, regs, a, sm.data(), blk);
  }
  return 0;
}

// The field's inversion alone (Field::inv / Fq2Over::inv) on [8][n] / [2][8][n]
// planes: group 1 Fq, 2 Fq2.
extern "C" int ugh_fq_inv(int group, const void* a, void* out, int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    if (group == 1) {
      ug::store((uint32_t*)out, n, i, 0, ug::Fq::inv(ug::load((const uint32_t*)a, n, i, 0)));
    } else {
      ug::fe2 x;
      ug::load_elem((const uint32_t*)a, n, i, 0, x);
      ug::store_elem((uint32_t*)out, n, i, 0, ug::Fq2::inv(x));
    }
  }
  return 0;
}

#define UG_HOST_MADD_VALID(G, F)                                              \
  extern "C" int ugh_##G##_madd_valid(const void* acc, void* out,             \
      const void* table, const void* tinf, int64_t T, const void* scalars,    \
      int w, int64_t n) {                                                     \
    for (int64_t i = 0; i < n; i++)                                           \
      ug::lane_madd_valid<F>((const uint32_t*)acc, (uint32_t*)out,            \
          (const uint32_t*)table, (const uint8_t*)tinf, T,                    \
          (const uint32_t*)scalars, w, n, i);                                 \
    return 0;                                                                 \
  }                                                                           \
  extern "C" int ugh_##G##_fixed_base_mul(const void* table, const void* tinf, \
      int64_t T, const void* scalars, void* out, void* out_inf, int64_t n) {  \
    return host_fixed_base_mul<F>(table, tinf, T, scalars, out, out_inf, n);  \
  }                                                                           \
  extern "C" int ugh_##G##_window_table(const void* table, const void* inf,   \
      void* out, int64_t npad, int c, int nw) {                               \
    return host_window_table<F>(table, inf, out, npad, c, nw);                \
  }

UG_HOST_MADD_VALID(g1, ug::Fq)
UG_HOST_MADD_VALID(g2, ug::Fq2)
UG_HOST_CURVE(g1, ug::Fq, false)
UG_HOST_CURVE(g2, ug::Fq2, true)

extern "C" int ugh_fr_mont_mul(const void* a, const void* b, void* out,
                               int64_t n, int64_t b_n) {
  for (int64_t i = 0; i < n; i++)
    ug::lane_fr_mul((const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out,
                    n, b_n, i);
  return 0;
}

extern "C" int ugh_fr_butterfly(void* a, const void* tw, int64_t n,
                                int64_t half) {
  for (int64_t i = 0; i < n / 2; i++)
    ug::lane_butterfly((uint32_t*)a, (const uint32_t*)tw, n, half, i);
  return 0;
}

// fr_cg_ntt: each block's program (ntt.cuh) with every phase run for each
// thread index in turn, the kernel's blocks one after another.
struct NttHostRegs {
  std::vector<ug::fe> v;
  ug::fe* operator()(int tid) { return &v[8 * tid]; }
};

template <int LOG_N>
int host_ntt(const ug::NttArgs& a) {
  using S = ug::NttShape<LOG_N>;
  std::vector<uint32_t> stws(8 * S::HP), sdat(8 * S::N * S::CPB);
  NttHostRegs regs{std::vector<ug::fe>(8 * UG_NTT_THREADS)};
  for (int64_t blk = 0; blk * S::CPB < a.cols; blk++) {
    ug::HostBlock run{UG_NTT_THREADS};
    ug::ntt_cols_body<LOG_N>(run, regs, a, sdat.data(), stws.data(), blk);
  }
  return 0;
}

extern "C" int ugh_fr_cg_ntt(const void* x, const void* tw, const void* stw, void* y,
                             int log_m, int64_t cols, int64_t cb) {
  if ((stw != nullptr) != (cb > 0)) return -1;
  const ug::NttArgs a{(const uint32_t*)x, (const uint32_t*)tw, (const uint32_t*)stw,
                      (uint32_t*)y, cols, cb};
  switch (log_m) {
    case 1: return host_ntt<1>(a);
    case 2: return host_ntt<2>(a);
    case 3: return host_ntt<3>(a);
    case 4: return host_ntt<4>(a);
    case 5: return host_ntt<5>(a);
    case 6: return host_ntt<6>(a);
    case 7: return host_ntt<7>(a);
    case 8: return host_ntt<8>(a);
    case 9: return host_ntt<9>(a);
    case 10: return host_ntt<10>(a);
  }
  return -1;
}

extern "C" int ugh_fq_mont_mul(const void* a, const void* b, void* out, int64_t n) {
  for (int64_t i = 0; i < n; i++)
    ug::lane_fq_mul((const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, i);
  return 0;
}

// The MMA product alone (field 0: Fr, 1: Fq) on [8][n] planes, in either
// build: mma_field.cuh's lane-side steps with plain-loop tile products.
extern "C" int ugh_mma_mont_mul(int field, const void* a, const void* b, void* out,
                                int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    const ug::fe x = ug::load((const uint32_t*)a, n, i, 0);
    const ug::fe y = ug::load((const uint32_t*)b, n, i, 0);
    ug::store((uint32_t*)out, n, i, 0,
              field == 0 ? ug::mont_mul_mma_ref<ug::FrParams>(x, y)
                         : ug::mont_mul_mma_ref<ug::FqParams>(x, y));
  }
  return 0;
}

// The same product as the device's warps compute it: the lanes in groups
// of 32 through mont_mul_mma_warp_ref (the device's shared-memory offsets
// and fragment maps), a ragged last group clamped to lane n-1 as the MMA
// build's kernels clamp it.
extern "C" int ugh_mma_mont_mul_warp(int field, const void* a, const void* b, void* out,
                                     int64_t n) {
  for (int64_t w0 = 0; w0 < n; w0 += 32) {
    ug::fe x[32], y[32], z[32];
    for (int l = 0; l < 32; l++) {
      const int64_t i = w0 + l < n ? w0 + l : n - 1;
      x[l] = ug::load((const uint32_t*)a, n, i, 0);
      y[l] = ug::load((const uint32_t*)b, n, i, 0);
    }
    if (field == 0)
      ug::mont_mul_mma_warp_ref<ug::FrParams>(x, y, z);
    else
      ug::mont_mul_mma_warp_ref<ug::FqParams>(x, y, z);
    for (int l = 0; l < 32 && w0 + l < n; l++) ug::store((uint32_t*)out, n, w0 + l, 0, z[l]);
  }
  return 0;
}

// The warp product's shared-memory offsets, for the CPU tests' bank
// checks: op [32][2] operand half bytes; cs [32][40] column-sum words;
// ldm [2][32] the byte each thread gives ldmatrix.x4 for m-tile mt;
// cst [2][2][32][5] the word of C pair p of n-tile j of m-tile mt.
extern "C" int ugh_mma_maps(int* op, int* cs, int* ldm, int* cst) {
  for (int r = 0; r < 32; r++) {
    for (int h = 0; h < 2; h++) op[2 * r + h] = ug::mma_op_byte(r, h);
    for (int c = 0; c < ug::kMmaRowWords; c++) cs[ug::kMmaRowWords * r + c] = ug::mma_cs_word(r, c);
  }
  for (int mt = 0; mt < 2; mt++)
    for (int l = 0; l < 32; l++) {
      ldm[32 * mt + l] = ug::mma_op_byte(ug::mma_ldm_row(l, mt), ug::mma_ldm_half(l));
      for (int p = 0; p < 2; p++)
        for (int j = 0; j < 5; j++)
          cst[((mt * 2 + p) * 32 + l) * 5 + j] = ug::mma_cs_word(
              16 * mt + ug::mma_c_row(l, 2 * p), 8 * j + ug::mma_c_col(l, 2 * p));
    }
  return 0;
}

extern "C" int ugh_fq_chain(const void* a, const void* b, void* out, int64_t n,
                            int32_t steps) {
  for (int64_t i = 0; i < n; i++)
    ug::lane_fq_chain((const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, steps, i);
  return 0;
}

extern "C" int ugh_mma_build() { return UG_MMA_FIELD; }
