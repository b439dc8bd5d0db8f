// XYZZ short-Weierstrass group law (a = 0) over Fq (G1) or Fq2 (G2), and
// the per-lane bodies of the curve kernels.
//
// The formulas and the order of the special-case selects are those of the
// JAX package's ultragroth_tpu/ops/curve.py:96-201 (dbl-2008-s-1,
// madd-2008-s, add-2008-s, complete-ified by computing the doubling and
// selecting), so a kernel's canonical output equals the plain PyTorch
// version in ops/curve.py lane for lane.  Each lane body is
// __host__ __device__: the .cu files wrap it in one __global__ function per
// kernel and group, and the tests' g++ harness runs it on the host.
//
// In the MMA build (UG_MMA_FIELD, field.cuh) every product is warp-
// collective, so a lane body must reach each product together with the
// other 31 lanes of its warp: the data-dependent doublings are computed and
// selected (as the JAX package's add_unified / madd_unified do), the bucket
// drain runs every lane of a warp to the warp's largest count with masked
// updates and takes the complete add when any lane of the warp needs it,
// and a lane past the end (`live` false) computes a clamped lane's values
// and stores nothing.  The CIOS build keeps its branches.  The reduction
// and the window combine after the bucket loop are in reduce.cuh.
#pragma once
#include "field.cuh"

namespace ug {

template <class F>
struct xyzz { typename F::E x, y, zz, zzz; };

template <class F>
UG_HD xyzz<F> inf_xyzz() {
  return {F::one_mont(), F::one_mont(), F::zero(), F::zero()};
}

// dbl-2008-s-1; maps the infinity encoding (zz == 0) to itself
template <class F>
UG_HD xyzz<F> dbl(const xyzz<F>& p) {
  using E = typename F::E;
  E u = F::add(p.y, p.y);
  E v = F::mul(u, u);
  E xx = F::mul(p.x, p.x);
  E m = F::add(F::add(xx, xx), xx);
  E w = F::mul(u, v);
  E s = F::mul(p.x, v);
  E mm = F::mul(m, m);
  E x3 = F::sub(mm, F::add(s, s));
  E t1 = F::mul(m, F::sub(s, x3));
  E t2 = F::mul(w, p.y);
  return {x3, F::sub(t1, t2), F::mul(v, p.zz), F::mul(w, p.zzz)};
}

// shared tail of madd / add (ops/curve.py _add_core)
template <class F>
UG_HD xyzz<F> add_core(const typename F::E& u1, const typename F::E& u2,
                       const typename F::E& s1, const typename F::E& s2,
                       const typename F::E& zz_a, const typename F::E& zzz_a,
                       bool& same_x, bool& same_y) {
  using E = typename F::E;
  E pp_ = F::sub(u2, u1);
  E r_ = F::sub(s2, s1);
  same_x = F::is_zero(pp_);
  same_y = F::is_zero(r_);
  E pp = F::sqr(pp_);
  E rr = F::sqr(r_);
  E ppp = F::mul(pp_, pp);
  E q_ = F::mul(u1, pp);
  E zz3 = F::mul(zz_a, pp);
  E x3 = F::sub(F::sub(rr, ppp), F::add(q_, q_));
  E t1 = F::mul(r_, F::sub(q_, x3));
  E t2 = F::mul(s1, ppp);
  return {x3, F::sub(t1, t2), zz3, F::mul(zzz_a, ppp)};
}

// complete mixed add P + (qx, qy) (q_inf marks Q = infinity)
template <class F>
UG_HD xyzz<F> madd_unified(const xyzz<F>& p, const typename F::E& qx,
                           const typename F::E& qy, bool q_inf) {
  using E = typename F::E;
  bool p_inf = F::is_zero(p.zz);
  E u2 = F::mul(qx, p.zz);
  E s2 = F::mul(qy, p.zzz);
  bool same_x, same_y;
  xyzz<F> added = add_core<F>(p.x, u2, p.y, s2, p.zz, p.zzz, same_x, same_y);
  E zq = q_inf ? F::zero() : F::one_mont();
  xyzz<F> q = {qx, qy, zq, zq};
  xyzz<F> out = added;
#if UG_MMA_FIELD
  const xyzz<F> d = dbl<F>(q);
  if (same_x && same_y) out = d;
#else
  if (same_x && same_y) out = dbl<F>(q);
#endif
  if (same_x && !same_y && !p_inf && !q_inf) out = inf_xyzz<F>();
  if (q_inf) out = p;
  if (p_inf) out = q;
  return out;
}

// incomplete mixed add (10 muls); bad = x-collision or P at infinity
template <class F>
UG_HD xyzz<F> madd_fast(const xyzz<F>& p, const typename F::E& qx,
                        const typename F::E& qy, bool& bad) {
  using E = typename F::E;
  E u2 = F::mul(qx, p.zz);
  E s2 = F::mul(qy, p.zzz);
  bool same_x, same_y;
  xyzz<F> added = add_core<F>(p.x, u2, p.y, s2, p.zz, p.zzz, same_x, same_y);
  bad = same_x || F::is_zero(p.zz);
  return added;
}

// complete xyzz + xyzz add (doubles when p == q)
template <class F>
UG_HD xyzz<F> add_unified(const xyzz<F>& p, const xyzz<F>& q) {
  using E = typename F::E;
  bool p_inf = F::is_zero(p.zz);
  bool q_inf = F::is_zero(q.zz);
  E u1 = F::mul(p.x, q.zz);
  E u2 = F::mul(q.x, p.zz);
  E s1 = F::mul(p.y, q.zzz);
  E s2 = F::mul(q.y, p.zzz);
  E zz_a = F::mul(p.zz, q.zz);
  E zzz_a = F::mul(p.zzz, q.zzz);
  bool same_x, same_y;
  xyzz<F> out = add_core<F>(u1, u2, s1, s2, zz_a, zzz_a, same_x, same_y);
#if UG_MMA_FIELD
  const xyzz<F> d = dbl<F>(p);
  if (same_x && same_y) out = d;
#else
  if (same_x && same_y) out = dbl<F>(p);
#endif
  if (same_x && !same_y && !p_inf && !q_inf) out = inf_xyzz<F>();
  if (q_inf) out = p;
  if (p_inf) out = q;
  return out;
}

// ---------------------------------------------------------------------------
// Lane I/O: an xyzz batch is [4 coords][K comps][8 limbs][n lanes], an
// affine table [2][K][8][T]; element slots run coordinate-major.
// ---------------------------------------------------------------------------
template <class F>
UG_HD xyzz<F> load_xyzz(const uint32_t* p, int64_t n, int64_t i) {
  xyzz<F> r;
  load_elem(p, n, i, 0, r.x); load_elem(p, n, i, 1, r.y);
  load_elem(p, n, i, 2, r.zz); load_elem(p, n, i, 3, r.zzz);
  return r;
}

template <class F>
UG_HD void store_xyzz(uint32_t* p, int64_t n, int64_t i, const xyzz<F>& a) {
  store_elem(p, n, i, 0, F::exit(a.x)); store_elem(p, n, i, 1, F::exit(a.y));
  store_elem(p, n, i, 2, F::exit(a.zz)); store_elem(p, n, i, 3, F::exit(a.zzz));
}

// ---------------------------------------------------------------------------
// The bucket drain (curve_bucket_drain): every step of one bucket lane of
// the Pippenger loop in one thread, its xyzz accumulator in registers.
//
// Lane i adds, for t in [t_from, min(t_to, cnt[i])), the point of order
// entry orders[gidx[i] + t*stride[i]] (entry = pid*2 + sign: table point
// pid, negated when sign is set).  Each step is the incomplete madd_fast;
// where it flags (same x, or the accumulator at infinity) the step is
// recomputed from the accumulator it started with by the complete
// madd_unified, which also seeds a lane's first point from infinity.  On
// every other input madd_unified selects `added`, the very value madd_fast
// computes, so the lane ends with the coordinates of the all-complete chain:
// those of the JAX package's drain, whose sticky flag redoes a flagged
// drain with the complete add on every lane (ultragroth_tpu/ops/msm.py:
// 233-292).
//
// The table is point-major: point p's affine (x, y) are kWords u32 words
// at table + p*kWords, x's components then y's, 8 limbs each (the zkey's
// own word order), read as kWords/4 aligned 16-byte loads.
// ---------------------------------------------------------------------------
template <class F>
struct PointIO {
  static constexpr int kWords = 2 * (int)(sizeof(typename F::E) / 4);  // 16 / 32
  static constexpr int kVecs = kWords / 4;                              // 16 B loads
};

UG_HD void elem_from_words(const uint32_t* w, fe& r) {
#pragma unroll
  for (int l = 0; l < 8; l++) r.v[l] = w[l];
}
UG_HD void elem_from_words(const uint32_t* w, fe2& r) {
  elem_from_words(w, r.c0);
  elem_from_words(w + 8, r.c1);
}

// the point of order entry `ent` from its kWords words
template <class F>
UG_HD void point_from_words(const uint32_t* w, int32_t ent, typename F::E& qx,
                            typename F::E& qy) {
  elem_from_words(w, qx);
  elem_from_words(w + PointIO<F>::kWords / 2, qy);
  if (ent & 1) qy = F::neg(qy);
}

// A fetch loads the point of one step: issue(ent) starts it, take() ends
// it.  This one loads at take(), straight from the table (the host
// harness); the kernels' SlotFetch (launch_common.cuh) has the next step's
// point in flight while a step computes.
template <class F>
struct DirectFetch {
  const uint32_t* table;
  int32_t ent;
  UG_HD void issue(int32_t e) { ent = e; }
  UG_HD void take(typename F::E& qx, typename F::E& qy) {
    point_from_words<F>(table + (int64_t)(ent >> 1) * PointIO<F>::kWords, ent, qx, qy);
  }
};

// a lane's end: min(t_to, cnt[i])
UG_HD int32_t drain_stop(const int32_t* cnt, int32_t t_to, int64_t i) {
  return cnt[i] < t_to ? cnt[i] : t_to;
}

// order entry of step t (entry 0 past the lane's end: a valid point whose
// sum is discarded, read by the MMA build's masked steps)
UG_HD int32_t drain_entry(const int32_t* orders, int64_t pos, int64_t stride,
                          int32_t t, int32_t stop) {
  return orders[t < stop ? pos + (int64_t)t * stride : 0];
}

// Does any lane that runs this step with the lane need the complete add?
// CIOS: the lane alone.  MMA: any lane of the warp (the product is warp-
// collective); the host build of the MMA bodies always takes it, which
// must change nothing.
UG_HD bool drain_vote(bool bad) {
#if UG_MMA_FIELD && defined(__CUDA_ARCH__)
  return __any_sync(0xffffffffu, bad);
#elif UG_MMA_FIELD
  (void)bad;
  return true;
#else
  return bad;
#endif
}

// Lane i's drain.  stop_all >= the lane's own stop is where its loop ends:
// the lane's stop in the CIOS build, its warp's largest in the MMA build
// (steps past the lane's stop compute and discard).  out may be acc.
template <class F, class Fetch>
UG_HD void lane_bucket_drain(const uint32_t* acc, uint32_t* out, const int32_t* orders,
                             const int32_t* gidx, const int32_t* stride,
                             const int32_t* cnt, int32_t t_from, int32_t t_to,
                             int32_t stop_all, int64_t n, int64_t i, bool live,
                             Fetch& f) {
  using E = typename F::E;
  xyzz<F> a = acc == nullptr ? inf_xyzz<F>() : load_xyzz<F>(acc, n, i);
  const int32_t stop = drain_stop(cnt, t_to, i);
  const int64_t pos = gidx[i], st = stride[i];
  if (t_from < stop_all) {
    f.issue(drain_entry(orders, pos, st, t_from, stop));
    int32_t next = drain_entry(orders, pos, st, t_from + 1, stop);
    for (int32_t t = t_from; t < stop_all; t++) {
      E qx, qy;
      f.take(qx, qy);
      if (t + 1 < stop_all) {            // step t+1's point in flight
        f.issue(next);
        next = drain_entry(orders, pos, st, t + 2, stop);
      }
      const bool active = t < stop;
      bool bad;
      xyzz<F> s = madd_fast<F>(a, qx, qy, bad);
      bad = bad && active;
      if (drain_vote(bad)) {
        const xyzz<F> u = madd_unified<F>(a, qx, qy, false);
        if (bad) s = u;
      }
      if (active) a = s;
    }
  }
  if (live) store_xyzz<F>(out, n, i, a);
}

// One step of the fixed-base ladder (chains.cuh, curve_fixed_base_mul):
// a + (qx, qy), Q at infinity where q_inf, equal to madd_unified's xyzz
// coordinates on every input.  Infinity on either side is a select
// (madd_unified's order: P at infinity gives Q's xyzz, else Q at infinity
// gives P); two finite points take the incomplete madd_fast, redone from
// `a` by the complete add where their x coordinates meet (P == +-Q, which
// canonical scalars never reach).  The MMA build computes a product where
// any lane of its warp needs it (drain_vote).
template <class F>
UG_HD xyzz<F> fixed_base_step(const xyzz<F>& a, const typename F::E& qx,
                              const typename F::E& qy, bool q_inf) {
  using E = typename F::E;
  const bool p_inf = F::is_zero(a.zz);
  const bool finite = !p_inf && !q_inf;
  xyzz<F> s = a;
  if (drain_vote(finite)) {
    bool bad;
    s = madd_fast<F>(a, qx, qy, bad);
    bad = bad && finite;
    if (drain_vote(bad)) {
      const xyzz<F> u = madd_unified<F>(a, qx, qy, q_inf);
      if (bad) s = u;
    }
  }
  if (q_inf) s = a;
  if (p_inf) {
    const E zq = q_inf ? F::zero() : F::one_mont();
    s = {qx, qy, zq, zq};
  }
  return s;
}

// fixed-base digit w of a lane: byte w of its standard-form scalar (limb
// w/4, bits 8*(w%4)..), scalars [8][n]
UG_HD uint32_t fixed_base_digit(const uint32_t* scalars, int64_t n, int64_t i, int w) {
  return (scalars[(int64_t)(w >> 2) * n + i] >> (8 * (w & 3))) & 0xFFu;
}

// curve_madd_valid: step w of the 8-bit windowed fixed-base multiplication
// of the device set-up (ultragroth_tpu/testkit/dsetup.py:90-121), from an
// accumulator in memory: lane i adds entry e = 256*w + digit of the 32 x
// 256 window table (infinity where tinf[e]) by the ladder's step.  No
// kernel launches it (the ladder keeps its accumulator in registers); the
// g++ harness runs it to hold the step, its exceptional redo included, to
// curve_madd_valid_plain on accumulators the ladder never meets.
template <class F>
UG_HD void lane_madd_valid(const uint32_t* acc, uint32_t* out, const uint32_t* table,
                           const uint8_t* tinf, int64_t T, const uint32_t* scalars,
                           int w, int64_t n, int64_t i) {
  const xyzz<F> a = load_xyzz<F>(acc, n, i);
  const int64_t e = 256 * (int64_t)w + fixed_base_digit(scalars, n, i, w);
  typename F::E qx, qy;
  load_elem(table, T, e, 0, qx);
  load_elem(table, T, e, 1, qy);
  store_xyzz<F>(out, n, i, fixed_base_step<F>(a, qx, qy, tinf[e] != 0));
}

// curve_add_where: out = ok ? a + b : a (ok == nullptr: every lane)
template <class F>
UG_HD void lane_add_where(const uint32_t* a, const uint32_t* b, const uint8_t* ok,
                          uint32_t* out, int64_t n, int64_t i, bool live = true) {
  xyzz<F> pa = load_xyzz<F>(a, n, i);
#if UG_MMA_FIELD
  const xyzz<F> s = add_unified<F>(pa, load_xyzz<F>(b, n, i));
  if (ok == nullptr || ok[i]) pa = s;
#else
  if (ok == nullptr || ok[i]) pa = add_unified<F>(pa, load_xyzz<F>(b, n, i));
#endif
  if (live) store_xyzz<F>(out, n, i, pa);
}

// fr_butterfly, one DIT stage in place over a [8, n] array: pair
// (u, w) = (blk*2h + j, blk*2h + h + j) -> (u + w*tw[j], u - w*tw[j])
UG_HD void lane_butterfly(uint32_t* a, const uint32_t* tw, int64_t n, int64_t half,
                          int64_t i, bool live = true) {
  int64_t blk = i / half, j = i - blk * half;
  int64_t iu = blk * 2 * half + j, iw = iu + half;
  fe u = load(a, n, iu, 0);
  fe t = Fr::mul(load(a, n, iw, 0), load(tw, half, j, 0));
  if (!live) return;
  store(a, n, iu, 0, Fr::add(u, t));
  store(a, n, iw, 0, Fr::sub(u, t));
}

// fr_mont_mul: out = a * b * R^-1, b broadcast over lanes when b_n == 1
UG_HD void lane_fr_mul(const uint32_t* a, const uint32_t* b, uint32_t* out,
                       int64_t n, int64_t b_n, int64_t i, bool live = true) {
  fe bb = b_n == 1 ? load(b, 1, 0, 0) : load(b, n, i, 0);
  const fe r = Fr::mul(load(a, n, i, 0), bb);
  if (live) store(out, n, i, 0, r);
}

// A probe of the field alone (no TPU kernel): out = canonical a * b * R^-1
// over Fq, for the checks of the MMA product on the card and in the tests.
UG_HD void lane_fq_mul(const uint32_t* a, const uint32_t* b, uint32_t* out,
                       int64_t n, int64_t i, bool live = true) {
  const fe r = Fq::exit(Fq::mul(load(a, n, i, 0), load(b, n, i, 0)));
  if (live) store(out, n, i, 0, r);
}

}  // namespace ug
