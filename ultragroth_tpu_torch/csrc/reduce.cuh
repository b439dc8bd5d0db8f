// The MSM's bucket reduction and window combine (curve_bucket_reduce,
// curve_window_combine): the device functions of their kernels, all
// __host__ __device__ so that the tests' g++ harness runs them too.
//
// Replaces (ultragroth_tpu/ops/kernels.py) the chains of curve_add_where
// (:171) and curve_horner_scale (:133) launches that ultragroth_tpu/ops/
// msm.py:342-395 and :443-460 run after the bucket loop: the sub-lane
// pre-folds, the binary-decomposition levels with their banked negated
// even halves, the Horner over the banks, the 2^(c*w) scaling of window w
// and the final pairwise fold.  Both kernels make the very same complete
// adds and doublings in the same order as that chain, so the outputs are
// its canonical coordinates exactly.
//
// What bounds them on the H100.  The wide levels do ~2m complete adds a
// window (14 Fq products each, ~3,700 32-bit multiply-adds for G1):
// operations, when a level is wide.  Everything after that is a dependent
// chain: the banked Horner (2 adds a level, one window a chain), the
// combine's c*w doublings of window w (247 at c = 13, W = 20) and its
// log2(W) folds.  There the bound is latency: dependent product depth x
// one Fq product's latency (0.57 us on the H100: a CIOS product is ~570
// integer instructions at one SM sub-partition's instruction rate).  A doubling
// is 3 products deep, a complete add 4, but done by one thread they are 9
// and 14 products (27 and 40 Fq products for G2).
//
// What the design does about it:
//  1. wide levels (more lanes than a block finishes): one thread per add,
//     ONE launch per level over every window and every bank of every split
//     group, reading the halves in place by index and writing the next
//     level (and, fused, the negated even half) into scratch allocated once
//     per MSM (`reduce_step`); no host op between levels.  The operands are
//     loaded where the formula uses them, the result stored as it is made
//     and the rare doubling run after it (`add_path_at`).  A G2 add does
//     not fit in one thread's registers (it spilled, inlined or with the
//     out-of-line Fq product), so the G2 instance makes each add with a
//     team, as in 3. (`reduce_step_team_body`);
//  2. the narrow levels and the Horner of a window: one block, its state in
//     shared memory (`reduce_tail_body`);
//  3. the dependent chains: a TEAM of threads makes one point operation,
//     each thread one Fq product per round (`team_job`): an add's products
//     in 4 dependent rounds, a doubling's in 3, exchanged through shared
//     memory between rounds; a G2 product's three Karatsuba products are
//     three jobs of the same round.  A team is 8 threads for G1 (an add's
//     widest round: 6 products and the doubling's 2), 16 for G2 (22 Fq
//     products: two passes of its widest rounds), so one thread holds one
//     product's working set and the CIOS build spills nothing;
//  4. the combine (`combine_body`): one team a window doubles it c*w times,
//     then the windows are folded pairwise, in one launch.  As a product
//     takes its sub-partition's instruction slots, no two chains' warps share
//     one: the combine runs one warp a block (the last block to finish
//     folds), the tail its Horner in the block's lead warp alone.
// The MMA build (UG_MMA_FIELD) needs every thread of a warp at each product
// together: every team of a block runs the same rounds the same number of
// times, each thread computes exactly one product a round at one call site
// (an idle thread a discarded one), and a team's doubling branch is always
// computed and selected, as in the CIOS build.
#pragma once
#include "block.cuh"
#include "curve.cuh"

// A device function kept out of line: one copy of the team ops' product
// and operand code, called from every round (inlined at each call site,
// the mma build's G1 tail spilled 120 B).
#if defined(__CUDACC__)
#define UG_HD_CALL __host__ __device__ __noinline__
#else
#define UG_HD_CALL inline
#endif

namespace ug {

// ---------------------------------------------------------------------------
// A point of a block's shared state: the coordinates by index.
// ---------------------------------------------------------------------------
template <class E>
struct Pt { E c[4]; };

template <class F>
UG_HD void load_pt(const uint32_t* p, int64_t n, int64_t i, Pt<typename F::E>& r) {
#pragma unroll
  for (int k = 0; k < 4; k++) load_elem(p, n, i, k, r.c[k]);
}

template <class F>
UG_HD typename F::E inf_coord(int k) { return k < 2 ? F::one_mont() : F::zero(); }

// ---------------------------------------------------------------------------
// Wide levels: one thread, one complete add, operands loaded at their use.
// ---------------------------------------------------------------------------

// The add path of add_unified(P, Q) (curve.cuh: its products and add_core)
// with P, Q lanes ia, ib of the planes `in`, into lane o of `out`: each
// coordinate loaded where the formula first needs it and each result
// coordinate stored as soon as it is made; and the flags that select the
// result.
template <class F>
UG_HD void add_path_at(const uint32_t* in, int64_t n, int64_t ia, int64_t ib, uint32_t* out,
                       int64_t out_n, int64_t o, bool live, bool& same_x, bool& same_y,
                       bool& p_inf, bool& q_inf) {
  using E = typename F::E;
  E zz1, zz2, zzz1, zzz2, t;
  load_elem(in, n, ia, 2, zz1);
  load_elem(in, n, ib, 2, zz2);
  p_inf = F::is_zero(zz1);
  q_inf = F::is_zero(zz2);
  load_elem(in, n, ia, 0, t);
  const E u1 = F::mul(t, zz2);
  load_elem(in, n, ib, 0, t);
  const E pp_ = F::sub(F::mul(t, zz1), u1);
  const E zz_a = F::mul(zz1, zz2);
  load_elem(in, n, ia, 3, zzz1);
  load_elem(in, n, ib, 3, zzz2);
  const E zzz_a = F::mul(zzz1, zzz2);
  load_elem(in, n, ia, 1, t);
  const E s1 = F::mul(t, zzz2);
  load_elem(in, n, ib, 1, t);
  const E r_ = F::sub(F::mul(t, zzz1), s1);
  same_x = F::is_zero(pp_);
  same_y = F::is_zero(r_);
  const E pp = F::sqr(pp_);
  const E ppp = F::mul(pp_, pp);
  t = F::mul(zzz_a, ppp);
  if (live) store_elem(out, out_n, o, 3, F::exit(t));
  t = F::mul(zz_a, pp);
  if (live) store_elem(out, out_n, o, 2, F::exit(t));
  const E q_ = F::mul(u1, pp);
  const E x3 = F::sub(F::sub(F::sqr(r_), ppp), F::add(q_, q_));
  if (live) store_elem(out, out_n, o, 0, F::exit(x3));
  t = F::sub(F::mul(r_, F::sub(q_, x3)), F::mul(s1, ppp));
  if (live) store_elem(out, out_n, o, 1, F::exit(t));
}

// The segment of add t of a wide level (segments: 5 int64 each, (in_off,
// out_off, n, neg_off, n_neg)); t becomes its index in the segment.
UG_HD const int64_t* step_segment(const int64_t* segs, int nseg, int64_t& t) {
  int s = 0;
  while (s + 1 < nseg && t >= segs[5 * s + 2]) {
    t -= segs[5 * s + 2];
    s++;
  }
  return segs + 5 * s;
}

// One wide level of the reduction for global thread t.  A level is a list
// of segments (one a split group), 5 int64 each: (in_off, out_off, n,
// neg_off, n_neg).  Thread t of a segment adds lanes in_off + 2t and
// in_off + 2t + 1 into lane out_off + t; a thread t < n_neg (the segment's
// first array, the group's current sums) also writes the negated even
// lane in_off + 2t into neg_off + t: the bank of this level.  The arrays of
// a group are [array][window][lane], so one segment covers every array and
// window of its group.  Lanes are plane indices (plane strides in_n, out_n).
//
// The add is add_unified's: its add path stored first, then the special
// cases stored over it in add_unified's order of precedence (P at
// infinity: Q; Q at infinity: P; P == -Q: infinity; P == Q: dbl(P)), the
// doubling with nothing else live (where any lane of the warp needs it, in
// the MMA build).
template <class F>
UG_HD void lane_reduce_step(const uint32_t* in, int64_t in_n, uint32_t* out, int64_t out_n,
                            const int64_t* segs, int nseg, int64_t t, bool live) {
  const int64_t* g = step_segment(segs, nseg, t);
  const int64_t ia = g[0] + 2 * t, o = g[1] + t;
  bool same_x, same_y, p_inf, q_inf;
  add_path_at<F>(in, in_n, ia, ia + 1, out, out_n, o, live, same_x, same_y, p_inf, q_inf);
  const bool dbl_p = same_x && same_y && !p_inf && !q_inf;
  if (drain_vote(dbl_p)) {
    const xyzz<F> d = dbl<F>(load_xyzz<F>(in, in_n, ia));
    if (dbl_p && live) store_xyzz<F>(out, out_n, o, d);
  }
  if (live && (p_inf || q_inf)) {
    store_xyzz<F>(out, out_n, o, load_xyzz<F>(in, in_n, p_inf ? ia + 1 : ia));
  } else if (live && same_x && !same_y) {
    store_xyzz<F>(out, out_n, o, inf_xyzz<F>());
  }
  if (live && t < g[4]) {
    typename F::E e;
    for (int k = 0; k < 4; k++) {
      load_elem(in, in_n, ia, k, e);
      store_elem(out, out_n, g[3] + t, k, F::exit(k == 1 ? F::neg(e) : e));
    }
  }
}

// ---------------------------------------------------------------------------
// Team point operations: a team of T threads makes one complete add
// (OP_ADD, add_unified) or doubling (OP_DBL, dbl), each thread one Fq
// product a round.
// ---------------------------------------------------------------------------

// How an F product splits into Fq products (jobs), and back.
template <class E>
struct Split;

template <>
struct Split<fe> {
  static constexpr int kParts = 1;
  static constexpr int kTeam = 8;
  UG_HD static int jobs(bool) { return 1; }
  UG_HD static void operands(bool sq, int, const fe& a, const fe& b, fe& x, fe& y) {
    x = a;
    y = sq ? a : b;
  }
  UG_HD static fe assemble(bool, const fe* p) { return p[0]; }
};

// Fq2: the Karatsuba products of Fq2Over::mul / sqr (field.cuh)
template <>
struct Split<fe2> {
  static constexpr int kParts = 3;
  static constexpr int kTeam = 16;
  UG_HD static int jobs(bool sq) { return sq ? 2 : 3; }
  UG_HD static void operands(bool sq, int k, const fe2& a, const fe2& b, fe& x, fe& y) {
    if (sq) {
      x = k == 0 ? Fq::add(a.c0, a.c1) : a.c0;
      y = k == 0 ? Fq::sub(a.c0, a.c1) : a.c1;
    } else if (k < 2) {
      x = k == 0 ? a.c0 : a.c1;
      y = k == 0 ? b.c0 : b.c1;
    } else {
      x = Fq::add(a.c0, a.c1);
      y = Fq::add(b.c0, b.c1);
    }
  }
  UG_HD static fe2 assemble(bool sq, const fe* p) {
    if (sq) return {p[0], Fq::add(p[1], p[1])};
    return {Fq::sub(p[0], p[1]), Fq::sub(Fq::sub(p[2], p[0]), p[1])};
  }
};

// The products of add_unified (with the doubling of its P == Q branch,
// always made), by dependent round.  dbl alone is rounds {DV, DXX},
// {DW, DS, DMM}, {DT1, DT2, DZZ, DZZZ}.
enum {
  P_U1, P_U2, P_S1, P_S2, P_ZZA, P_ZZZA, P_DV, P_DXX,   // round 0
  P_PP, P_RR, P_DW, P_DS, P_DMM,                        // round 1
  P_PPP, P_Q, P_ZZ3, P_DT1, P_DT2, P_DZZ, P_DZZZ,       // round 2
  P_T1, P_T2, P_ZZZ3,                                   // round 3
  kProducts
};
enum { OP_ADD = 0, OP_DBL = 1 };

UG_HD bool prod_is_sqr(int id) {
  return id == P_DV || id == P_DXX || id == P_PP || id == P_RR || id == P_DMM;
}

UG_HD int op_rounds(int op) { return op == OP_ADD ? 4 : 3; }

// product k of round r of op, -1 past the round's end
UG_HD int round_product(int op, int r, int k) {
  int first, count;
  if (op == OP_ADD) {
    first = r == 0 ? P_U1 : r == 1 ? P_PP : r == 2 ? P_PPP : P_T1;
    count = r == 0 ? 8 : r == 1 ? 5 : r == 2 ? 7 : 3;
  } else {
    first = r == 0 ? P_DV : r == 1 ? P_DW : P_DT1;
    count = r + 2;
  }
  return k < count ? first + k : -1;
}

template <class E>
UG_HD int round_jobs(int op, int r) {
  int n = 0;
  for (int k = 0; round_product(op, r, k) >= 0; k++)
    n += Split<E>::jobs(prod_is_sqr(round_product(op, r, k)));
  return n;
}

// A team's shared slots: the operands P, Q, the result, and each product's
// Fq parts (and, last, where a thread without a job puts its product).
template <class E>
struct TeamSlots {
  E p[4], q[4], res[4];
  fe part[kProducts + 1][Split<E>::kParts];
};

template <class E>
UG_HD E prod(const TeamSlots<E>& s, int id) {
  return Split<E>::assemble(prod_is_sqr(id), s.part[id]);
}

// The F operands of product `id`, from P, Q and the earlier rounds.
template <class F>
UG_HD void prod_operands(int id, const TeamSlots<typename F::E>& s, typename F::E& a,
                         typename F::E& b) {
  using E = typename F::E;
  const E* P = s.p;
  const E* Q = s.q;
  switch (id) {
    case P_U1: a = P[0]; b = Q[2]; break;
    case P_U2: a = Q[0]; b = P[2]; break;
    case P_S1: a = P[1]; b = Q[3]; break;
    case P_S2: a = Q[1]; b = P[3]; break;
    case P_ZZA: a = P[2]; b = Q[2]; break;
    case P_ZZZA: a = P[3]; b = Q[3]; break;
    case P_DV: a = b = F::add(P[1], P[1]); break;                    // u = 2y
    case P_DXX: a = b = P[0]; break;
    case P_PP: a = b = F::sub(prod(s, P_U2), prod(s, P_U1)); break;  // pp_
    case P_RR: a = b = F::sub(prod(s, P_S2), prod(s, P_S1)); break;  // r_
    case P_DW: a = F::add(P[1], P[1]); b = prod(s, P_DV); break;
    case P_DS: a = P[0]; b = prod(s, P_DV); break;
    case P_DMM: {
      const E xx = prod(s, P_DXX);
      a = b = F::add(F::add(xx, xx), xx);                             // m
    } break;
    case P_PPP: a = F::sub(prod(s, P_U2), prod(s, P_U1)); b = prod(s, P_PP); break;
    case P_Q: a = prod(s, P_U1); b = prod(s, P_PP); break;
    case P_ZZ3: a = prod(s, P_ZZA); b = prod(s, P_PP); break;
    case P_DT1: {
      const E xx = prod(s, P_DXX), ds = prod(s, P_DS);
      a = F::add(F::add(xx, xx), xx);
      b = F::sub(ds, F::sub(prod(s, P_DMM), F::add(ds, ds)));         // s - x3
    } break;
    case P_DT2: a = prod(s, P_DW); b = P[1]; break;
    case P_DZZ: a = prod(s, P_DV); b = P[2]; break;
    case P_DZZZ: a = prod(s, P_DW); b = P[3]; break;
    case P_T1: {
      const E q_ = prod(s, P_Q);
      a = F::sub(prod(s, P_S2), prod(s, P_S1));                        // r_
      b = F::sub(q_, F::sub(F::sub(prod(s, P_RR), prod(s, P_PPP)), F::add(q_, q_)));
    } break;
    case P_T2: a = prod(s, P_S1); b = prod(s, P_PPP); break;
    default: a = prod(s, P_ZZZA); b = prod(s, P_PPP); break;          // P_ZZZ3
  }
}

// Job `job` of round r of op for one thread: its one Fq product.  A thread
// past the round's jobs makes a copy of the round's first product into the
// spare slot, so that every thread of a warp makes exactly one product
// here, with no branch around it.
template <class F>
UG_HD_CALL void team_job(int op, int r, int job, TeamSlots<typename F::E>& s) {
  using E = typename F::E;
  int id = -1, comp = job;
  for (int k = 0; round_product(op, r, k) >= 0; k++) {
    const int nj = Split<E>::jobs(prod_is_sqr(round_product(op, r, k)));
    if (comp < nj) {
      id = round_product(op, r, k);
      break;
    }
    comp -= nj;
  }
  const int slot = id >= 0 ? id : kProducts;
  comp = id >= 0 ? comp : 0;
  id = id >= 0 ? id : round_product(op, r, 0);
  E a, b;
  fe x, y;
  prod_operands<F>(id, s, a, b);
  Split<E>::operands(prod_is_sqr(id), comp, a, b, x, y);
#if defined(__CUDA_ARCH__)
  __syncwarp();
#endif
  s.part[slot][comp] = Fq::mul(x, y);
}

// Coordinate k of the operation's result (add_unified's selects; dbl; or,
// with guard_inf, P where P is at infinity and dbl(P) elsewhere, which is
// add_unified(P, P)).  A plain doubling reads only the products, so its
// result may be written over P in the same phase.
template <class F>
UG_HD_CALL typename F::E team_result(int op, bool guard_inf, int k,
                                const TeamSlots<typename F::E>& s) {
  using E = typename F::E;
  E d;
  if (k == 0 || k == 1) {
    const E ds = prod(s, P_DS);
    const E x3 = F::sub(prod(s, P_DMM), F::add(ds, ds));
    d = k == 0 ? x3 : F::sub(prod(s, P_DT1), prod(s, P_DT2));
  } else {
    d = prod(s, k == 2 ? P_DZZ : P_DZZZ);
  }
  if (op == OP_DBL) return guard_inf && F::is_zero(s.p[2]) ? s.p[k] : d;
  const bool p_inf = F::is_zero(s.p[2]), q_inf = F::is_zero(s.q[2]);
  const bool same_x = F::is_zero(F::sub(prod(s, P_U2), prod(s, P_U1)));
  const bool same_y = F::is_zero(F::sub(prod(s, P_S2), prod(s, P_S1)));
  E out;
  if (k == 0 || k == 1) {
    const E q_ = prod(s, P_Q), ppp = prod(s, P_PPP);
    const E x3 = F::sub(F::sub(prod(s, P_RR), ppp), F::add(q_, q_));
    out = k == 0 ? x3 : F::sub(prod(s, P_T1), prod(s, P_T2));
  } else {
    out = prod(s, k == 2 ? P_ZZ3 : P_ZZZ3);
  }
  if (same_x && same_y) out = d;
  if (same_x && !same_y && !p_inf && !q_inf) out = inf_coord<F>(k);
  if (q_inf) out = s.p[k];
  if (p_inf) out = s.q[k];
  return out;
}

// Every team makes one operation on the operands already in its slots;
// thread t < 4 of a team passes coordinate t of the result to
// store(thread, coordinate, value), by default into the slots' res.
template <class F, class Run, class Store>
UG_HD void team_op(Run& run, TeamSlots<typename F::E>* teams, int op, bool guard_inf,
                   Store store) {
  using E = typename F::E;
  constexpr int T = Split<E>::kTeam;
  for (int r = 0; r < op_rounds(op); r++) {
    const int nj = round_jobs<E>(op, r);
    for (int sub = 0; sub * T < nj; sub++)
      run.warp([=](int t) { team_job<F>(op, r, sub * T + t % T, teams[t / T]); });
  }
  run.warp([=](int t) {
    if (t % T < 4) store(t, t % T, team_result<F>(op, guard_inf, t % T, teams[t / T]));
  });
}

template <class F, class Run>
UG_HD void team_op(Run& run, TeamSlots<typename F::E>* teams, int op, bool guard_inf) {
  using E = typename F::E;
  constexpr int T = Split<E>::kTeam;
  team_op<F>(run, teams, op, guard_inf,
             [=](int t, int k, const E& v) { teams[t / T].res[k] = v; });
}

// Team threads j < 4 copy coordinate j of *p into P, 4 <= j < 8 of *q into Q.
template <class E>
UG_HD void team_load(TeamSlots<E>& s, int j, const Pt<E>& p, const Pt<E>* q) {
  if (j < 4) s.p[j] = p.c[j];
  else if (j < 8 && q != nullptr) s.q[j - 4] = q->c[j - 4];
}

// One pass of pairwise adds over a shared array: dst[i] = src[2i] + src[2i+1]
// for i < n, the adds spread over the teams (each team ceil(n / teams) in
// turn, every team the same number).
template <class F, class Run>
UG_HD void team_fold(Run& run, TeamSlots<typename F::E>* teams, int nteams,
                     const Pt<typename F::E>* src, Pt<typename F::E>* dst, int n,
                     int src_stride, int dst_stride, int arrays) {
  using E = typename F::E;
  constexpr int T = Split<E>::kTeam;
  const int total = n * arrays;
  for (int base = 0; base < total; base += nteams) {
    run.warp([=](int t) {
      int i = base + t / T;
      i = i < total ? i : total - 1;
      const int a = i / n, k = i - a * n;
      team_load(teams[t / T], t % T, src[a * src_stride + 2 * k], &src[a * src_stride + 2 * k + 1]);
    });
    team_op<F>(run, teams, OP_ADD, false, [=](int t, int j, const E& v) {
      const int i = base + t / T;
      if (i >= total) return;
      const int a = i / n, k = i - a * n;
      dst[a * dst_stride + k].c[j] = v;
    });
  }
}

// One wide level by teams, for the G2 instance (one thread's complete G2
// add holds more than a thread's 255 registers): team k of a block makes
// add `first + k` of the level's segments as lane_reduce_step does,
// P and Q loaded into its slots, its result and the bank's negated P
// stored canonical.  Teams past the level's n adds make its last add and
// store nothing.
template <class F, class Run>
UG_HD void reduce_step_team_body(Run& run, TeamSlots<typename F::E>* teams,
                                 const uint32_t* in, int64_t in_n, uint32_t* out,
                                 int64_t out_n, const int64_t* segs, int nseg, int64_t n,
                                 int64_t first) {
  using E = typename F::E;
  constexpr int T = Split<E>::kTeam;
  run.warp([=](int t) {
    int64_t i = first + t / T;
    i = i < n ? i : n - 1;
    const int64_t ia = step_segment(segs, nseg, i)[0] + 2 * i;
    const int j = t % T;
    if (j < 4) load_elem(in, in_n, ia, j, teams[t / T].p[j]);
    else if (j < 8) load_elem(in, in_n, ia + 1, j - 4, teams[t / T].q[j - 4]);
  });
  team_op<F>(run, teams, OP_ADD, false, [=](int t, int k, const E& v) {
    int64_t i = first + t / T;
    if (i >= n) return;
    const int64_t o = step_segment(segs, nseg, i)[1] + i;
    store_elem(out, out_n, o, k, F::exit(v));
  });
  run.warp([=](int t) {
    int64_t i = first + t / T;
    const int k = t % T;
    if (i >= n || k >= 4) return;
    const int64_t* g = step_segment(segs, nseg, i);
    if (i < g[4]) {
      const E& c = teams[t / T].p[k];
      store_elem(out, out_n, g[3] + i, k, F::exit(k == 1 ? F::neg(c) : c));
    }
  });
}

// Launch shapes, shared by the kernels and the host harness.
constexpr int kTailThreads = 256;

// The combine runs one warp a block, 32 / T windows a block, so that no
// two of its chains share an SM sub-partition.
template <class E>
UG_HD int combine_blocks(int64_t W) {
  const int per = 32 / Split<E>::kTeam;
  return (int)((W + per - 1) / per);
}

// the combine's padded width m = 2^k >= max(W, 2)
UG_HD int combine_width(int64_t W) {
  int m = 2;
  while (m < W) m *= 2;
  return m;
}

// The tail's group of block b (groups: 5 int64 each, the second one its
// windows); b becomes the window's index in its group.
UG_HD const int64_t* tail_group(const int64_t* groups, int ngroups, int64_t& b) {
  int g = 0;
  while (g + 1 < ngroups && b >= groups[5 * g + 1]) {
    b -= groups[5 * g + 1];
    g++;
  }
  return groups + 5 * g;
}

// ---------------------------------------------------------------------------
// The reduction's tail: one block finishes one window.  Its state is
// `arrays` arrays of u lanes at lanes base + a*arr_stride + k of the planes
// `state` (the current sums, then the banks in the order they were made);
// `prefolds` pre-folds (sub-lane folds, no bank) come first.  Each level
// folds every array pairwise and, after the pre-folds, banks the negated
// even half of the current sums; at width 1 the Horner over the banks,
// total = 2 total + bank, last bank first (add_unified(total, total), then
// add_unified(., bank)), makes sum_i (i+1) B_i, stored canonical at lane
// out_i of `out`.  buf_a holds arrays*u points, buf_b (arrays+1)*u/2.
// ---------------------------------------------------------------------------
template <class F, class Run>
UG_HD void reduce_tail_body(Run& run, int threads, TeamSlots<typename F::E>* teams,
                            Pt<typename F::E>* buf_a, Pt<typename F::E>* buf_b,
                            const uint32_t* state, int64_t state_n, int64_t base,
                            int64_t arr_stride, int arrays, int u, int prefolds,
                            uint32_t* out, int64_t out_n, int64_t out_i) {
  using E = typename F::E;
  constexpr int T = Split<E>::kTeam;
  const int nteams = threads / T;
  run.block([=](int t) {
    for (int i = t; i < arrays * u; i += threads)
      load_pt<F>(state, state_n, base + (i / u) * arr_stride + i % u, buf_a[i]);
  });
  Pt<E>* src = buf_a;
  Pt<E>* dst = buf_b;
  while (u > 1) {
    const int h = u / 2;
    team_fold<F>(run, teams, nteams, src, dst, h, u, h, arrays);
    const bool bank = prefolds == 0;
    run.block([=](int t) {
      if (!bank) return;
      for (int k = t; k < h; k += threads) {
        Pt<E> e = src[2 * k];
        e.c[1] = F::neg(e.c[1]);
        dst[arrays * h + k] = e;
      }
    });
    if (bank) arrays++;
    else prefolds--;
    Pt<E>* tmp = src;
    src = dst;
    dst = tmp;
    u = h;
  }
  // the Horner, in the lead warp alone: each of its teams computes it
  // (the MMA build's warp stays whole), team 0 stores
  if (!run.in_lead()) return;
  auto lead = run.lead();
  lead.warp([=](int t) { team_load(teams[t / T], t % T, src[0], (const Pt<E>*)nullptr); });
  for (int l = arrays - 1; l >= 1; l--) {
    team_op<F>(lead, teams, OP_DBL, true);
    lead.warp([=](int t) {
      if (t % T < 4) teams[t / T].p[t % T] = teams[t / T].res[t % T];
      else if (t % T < 8) teams[t / T].q[t % T - 4] = src[l].c[t % T - 4];
    });
    team_op<F>(lead, teams, OP_ADD, false);
    lead.warp([=](int t) {
      if (t % T < 4) teams[t / T].p[t % T] = teams[t / T].res[t % T];
    });
  }
  lead.warp([=](int t) {
    if (t < 4) store_elem(out, out_n, out_i, t, F::exit(teams[0].p[t]));
  });
}

// ---------------------------------------------------------------------------
// The window combine: window w of the sums pts [4][K][8][W] doubled c*w
// times (dbl, as curve_horner_scale), padded with infinity to m = 2^k >= 2,
// m >= W, and folded pairwise to one point, stored canonical at lane 0 of
// out.  Block blk of nblk (one warp) doubles windows blk*teams + team:
// every team runs the block's largest count of doublings and keeps the
// first c*w; the scaled windows go to `scaled` [4][K][8][m]; the block
// that takes the last ticket of `counter` (zero at the launch, zero again
// after it) folds them.  `flag` is a shared int of the block.  buf_a and
// buf_b hold m and m/2 points.
// ---------------------------------------------------------------------------
UG_HD int take_ticket(int* counter) {
#if defined(__CUDA_ARCH__)
  __threadfence();
  return atomicAdd(counter, 1);
#else
  return (*counter)++;
#endif
}

template <class F, class Run>
UG_HD void combine_body(Run& run, int threads, TeamSlots<typename F::E>* teams,
                        Pt<typename F::E>* buf_a, Pt<typename F::E>* buf_b,
                        const uint32_t* pts, int64_t W, int c, int64_t blk, int64_t nblk,
                        uint32_t* scaled, int* counter, int* flag, uint32_t* out) {
  using E = typename F::E;
  constexpr int T = Split<E>::kTeam;
  const int nteams = threads / T;
  const int m = combine_width(W);
  const int64_t first = blk * nteams;
  const int64_t last_w = first + nteams - 1 < W - 1 ? first + nteams - 1 : W - 1;
  run.warp([=](int t) {
    if (t % T >= 4) return;
    int64_t w = first + t / T;
    w = w < W ? w : W - 1;
    load_elem(pts, W, w, t % T, teams[t / T].p[t % T]);
  });
  for (int64_t s = 0; s < (int64_t)c * last_w; s++)
    team_op<F>(run, teams, OP_DBL, false, [=](int t, int k, const E& v) {
      if (s < (int64_t)c * (first + t / T)) teams[t / T].p[k] = v;
    });
  run.block([=](int t) {
    const int64_t w = first + t / T;
    if (t % T < 4 && w < W) store_elem(scaled, m, w, t % T, F::exit(teams[t / T].p[t % T]));
  });
  run.block([=](int t) {
    if (t == 0) *flag = take_ticket(counter) == nblk - 1;
  });
  if (!*flag) return;
#if defined(__CUDA_ARCH__)
  __threadfence();
#endif
  run.block([=](int t) {
    for (int w = t; w < m; w += threads)
      for (int k = 0; k < 4; k++)
        if (w < W) load_elem(scaled, m, w, k, buf_a[w].c[k]);
        else buf_a[w].c[k] = inf_coord<F>(k);
  });
  Pt<E>* src = buf_a;
  Pt<E>* dst = buf_b;
  for (int h = m / 2; h >= 1; h /= 2) {
    team_fold<F>(run, teams, nteams, src, dst, h, 0, 0, 1);
    run.block([=](int) {});
    Pt<E>* tmp = src;
    src = dst;
    dst = tmp;
  }
  run.block([=](int t) {
    if (t < 4) store_elem(out, 1, 0, t, F::exit(src[0].c[t]));
    if (t == 0) *counter = 0;
  });
}

// The latency probe of the Fq product (no TPU kernel): lane i multiplies
// x = a_i by b_i `steps` times in a dependent chain.
UG_HD void lane_fq_chain(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n,
                         int32_t steps, int64_t i, bool live = true) {
  fe x = load(a, n, i, 0);
  const fe y = load(b, n, i, 0);
  for (int32_t s = 0; s < steps; s++) x = Fq::mul(x, y);
  if (live) store(out, n, i, 0, Fq::exit(x));
}

}  // namespace ug
