// BN254 Fr / Fq / Fq2 device arithmetic on 8 x 32-bit limbs.
//
// Replaces the in-kernel field math of the JAX package's Pallas kernels
// (ultragroth_tpu/ops/field.py: _KernelFieldView, FieldOps._mont_mul with
// unroll=True and lazy=..., _add/_sub, _is_zero_lazy, canon) and the Fq2
// tower (ultragroth_tpu/ops/fq2.py:39-55).  The TPU multiplies 16-bit limbs
// held in u32 lanes; Hopper multiplies 32 x 32 -> 64 at full rate, so here
// an element is 8 little-endian 32-bit limbs and the Montgomery product is
// CIOS over 32-bit digits with PTX carry chains (mad.lo/hi.cc, madc).
//
// Montgomery radix R = 2^256 (the zkey wire format).  Fr stays canonical in
// [0, r).  Fq is LAZY inside a kernel: values live in [0, 2q), mont_mul
// skips its final subtract (sound because 4q < 2^256, so the CIOS output
// (a*b + m*q)/R < 2q for a, b < 2q), add/sub reduce against 2q, and the
// zero test accepts both representatives {0, q}.  Every kernel
// canonicalises its outputs at exit, so no lazy value leaves a launch.
//
// Every function is __host__ __device__: on the device the carry-chain
// primitives are single PTX instructions; on the host (the g++ harness of
// the tests, and nvcc's host pass) they are an exact emulation of the same
// carry flag, so the very same CIOS code can be checked without a card.
//
// Two builds of every kernel source: the CIOS build (the default) and the
// MMA build (-DUG_MMA_FIELD=1), whose mont_mul is the warp-collective
// product of mma_field.cuh with the reduction on the tensor cores (the twin
// of ULTRAGROTH_MXU_FIELD).  Its launchers carry the prefix ugm_ instead of
// ug_ (UG_SYM), so both libraries can be loaded side by side.
#pragma once
#include <stdint.h>

#ifndef UG_MMA_FIELD
#define UG_MMA_FIELD 0
#endif

#if UG_MMA_FIELD
#define UG_SYM(x) ugm_##x
#else
#define UG_SYM(x) ug_##x
#endif

#if defined(__CUDACC__)
#define UG_HD __host__ __device__ __forceinline__
#else
#define UG_HD inline
#endif

namespace ug {

// ---------------------------------------------------------------------------
// Carry-chain primitives.  A chain starts with a *_cc op without carry-in,
// continues with c-ops, and ends with a c-op without .cc.  Nothing else may
// be issued between the links of one chain (asm volatile keeps the order).
// ---------------------------------------------------------------------------
#if defined(__CUDA_ARCH__)
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r; asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b)); return r; }
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r; asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b)); return r; }
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r; asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b)); return r; }
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r; asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b)); return r; }
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r; asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b)); return r; }
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r; asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b)); return r; }
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r; asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); return r; }
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r; asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); return r; }
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r; asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); return r; }
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r; asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); return r; }
#else
// Host emulation: one carry flag per thread, same semantics as CC.CF
// (for the sub family it holds the borrow).
static thread_local uint32_t ug_cf = 0;
inline uint32_t add_cc(uint32_t a, uint32_t b) {
  uint64_t s = (uint64_t)a + b; ug_cf = (uint32_t)(s >> 32); return (uint32_t)s; }
inline uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint64_t s = (uint64_t)a + b + ug_cf; ug_cf = (uint32_t)(s >> 32); return (uint32_t)s; }
inline uint32_t addc(uint32_t a, uint32_t b) { return a + b + ug_cf; }
inline uint32_t sub_cc(uint32_t a, uint32_t b) {
  ug_cf = a < b; return a - b; }
inline uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint64_t need = (uint64_t)b + ug_cf; uint32_t r = (uint32_t)((uint64_t)a - need);
  ug_cf = (uint64_t)a < need; return r; }
inline uint32_t subc(uint32_t a, uint32_t b) { return a - b - ug_cf; }
inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return add_cc((uint32_t)((uint64_t)a * b), c); }
inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return addc_cc((uint32_t)((uint64_t)a * b), c); }
inline uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return add_cc((uint32_t)(((uint64_t)a * b) >> 32), c); }
inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return addc_cc((uint32_t)(((uint64_t)a * b) >> 32), c); }
#endif

struct fe { uint32_t v[8]; };

// ---------------------------------------------------------------------------
// Moduli.  Constants live in function-local arrays indexed by unrolled
// constants, so the compiler folds them into immediates.
// ---------------------------------------------------------------------------
struct FrParams {
  static constexpr bool kLazy = false;
  static constexpr uint32_t kNinv = 0xefffffffu;   // -r^-1 mod 2^32
  UG_HD static constexpr uint32_t p(int i) {
    const uint32_t P[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                           0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return P[i]; }
  UG_HD static constexpr uint32_t np(int i) {   // -r^-1 mod 2^256 (the MMA field)
    const uint32_t P[8] = {0xefffffffu, 0xc2e1f593u, 0x4c6911b3u, 0x6586864bu,
                           0x99062391u, 0xe39a9828u, 0x0d8341b2u, 0x73f82f1du};
    return P[i]; }
  UG_HD static uint32_t p2(int i) {
    const uint32_t P[8] = {0xe0000002u, 0x87c3eb27u, 0xf372e122u, 0x5067d090u,
                           0x0302b0bau, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u};
    return P[i]; }
  UG_HD static uint32_t one(int i) {   // R mod r
    const uint32_t P[8] = {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
                           0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return P[i]; }
};

struct FqParams {
  static constexpr bool kLazy = true;
  static constexpr uint32_t kNinv = 0xe4866389u;   // -q^-1 mod 2^32
  UG_HD static constexpr uint32_t p(int i) {
    const uint32_t P[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                           0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return P[i]; }
  UG_HD static constexpr uint32_t np(int i) {   // -q^-1 mod 2^256 (the MMA field)
    const uint32_t P[8] = {0xe4866389u, 0x87d20782u, 0x1eca6ac9u, 0x9ede7d65u,
                           0x1833da80u, 0xd8afcbd0u, 0x91888c6bu, 0xf57a22b7u};
    return P[i]; }
  UG_HD static uint32_t p2(int i) {
    const uint32_t P[8] = {0xb0f9fa8eu, 0x7841182du, 0xd0e3951au, 0x2f02d522u,
                           0x0302b0bbu, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u};
    return P[i]; }
  UG_HD static uint32_t one(int i) {   // R mod q
    const uint32_t P[8] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
                           0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return P[i]; }
};

}  // namespace ug

#include "mma_field.cuh"

namespace ug {

// ---------------------------------------------------------------------------
// Prime field over Params: add / sub / neg / mont_mul / zero test / canon.
// ---------------------------------------------------------------------------
template <class Pm>
struct Field {
  using E = fe;

  // reduction constant of add/sub: 2p in the lazy domain, p otherwise
  UG_HD static uint32_t red(int i) { return Pm::kLazy ? Pm::p2(i) : Pm::p(i); }

  UG_HD static fe zero() { fe r; for (int i = 0; i < 8; i++) r.v[i] = 0; return r; }
  UG_HD static fe one_mont() {
    fe r;
#pragma unroll
    for (int i = 0; i < 8; i++) r.v[i] = Pm::one(i);
    return r;
  }

  // a + b; inputs < red, so the sum < 2 red < 2^256 never carries out
  UG_HD static fe add(const fe& a, const fe& b) {
    fe s, d;
    s.v[0] = add_cc(a.v[0], b.v[0]);
#pragma unroll
    for (int i = 1; i < 7; i++) s.v[i] = addc_cc(a.v[i], b.v[i]);
    s.v[7] = addc(a.v[7], b.v[7]);
    d.v[0] = sub_cc(s.v[0], red(0));
#pragma unroll
    for (int i = 1; i < 8; i++) d.v[i] = subc_cc(s.v[i], red(i));
    uint32_t borrow = subc(0, 0);
    return borrow ? s : d;
  }

  UG_HD static fe sub(const fe& a, const fe& b) {
    fe d, f;
    d.v[0] = sub_cc(a.v[0], b.v[0]);
#pragma unroll
    for (int i = 1; i < 8; i++) d.v[i] = subc_cc(a.v[i], b.v[i]);
    uint32_t borrow = subc(0, 0);
    f.v[0] = add_cc(d.v[0], red(0));
#pragma unroll
    for (int i = 1; i < 7; i++) f.v[i] = addc_cc(d.v[i], red(i));
    f.v[7] = addc(d.v[7], red(7));
    return borrow ? f : d;
  }

  UG_HD static fe neg(const fe& a) { return sub(zero(), a); }

  // [0, 2p) -> [0, p): one conditional subtract of p
  UG_HD static fe canon(const fe& a) {
    fe d;
    d.v[0] = sub_cc(a.v[0], Pm::p(0));
#pragma unroll
    for (int i = 1; i < 8; i++) d.v[i] = subc_cc(a.v[i], Pm::p(i));
    uint32_t borrow = subc(0, 0);
    return borrow ? a : d;
  }

  UG_HD static bool is_zero(const fe& a) {
    uint32_t z = 0, e = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) { z |= a.v[i]; e |= a.v[i] ^ Pm::p(i); }
    return Pm::kLazy ? (z == 0 || e == 0) : z == 0;
  }

  // CIOS Montgomery product a * b * 2^-256 mod p.  Accumulator t holds 10
  // words; each outer step adds a * b_i and m * p as a low-half chain and a
  // high-half chain, then drops the zero word.  Output < 2p whenever
  // a < 2^256 and b < 2p (4p < 2^256); Fr subtracts once more to [0, p).
  // The MMA build takes mma_field.cuh's product instead (canonical output,
  // which is a valid lazy value too): on the device the warp-collective
  // one, on the host its plain-loop reference.
  UG_HD static fe mul(const fe& a, const fe& b) {
#if UG_MMA_FIELD && defined(__CUDA_ARCH__)
    return mont_mul_mma_dev<Pm>(a, b);
#elif UG_MMA_FIELD
    return mont_mul_mma_ref<Pm>(a, b);
#else
    uint32_t t[10];
#pragma unroll
    for (int i = 0; i < 10; i++) t[i] = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
      const uint32_t bi = b.v[i];
      t[0] = mad_lo_cc(a.v[0], bi, t[0]);
#pragma unroll
      for (int j = 1; j < 8; j++) t[j] = madc_lo_cc(a.v[j], bi, t[j]);
      t[8] = addc_cc(t[8], 0);
      t[9] = addc(t[9], 0);
      t[1] = mad_hi_cc(a.v[0], bi, t[1]);
#pragma unroll
      for (int j = 1; j < 8; j++) t[j + 1] = madc_hi_cc(a.v[j], bi, t[j + 1]);
      t[9] = addc(t[9], 0);

      const uint32_t m = t[0] * Pm::kNinv;
      t[0] = mad_lo_cc(m, Pm::p(0), t[0]);
#pragma unroll
      for (int j = 1; j < 8; j++) t[j] = madc_lo_cc(m, Pm::p(j), t[j]);
      t[8] = addc_cc(t[8], 0);
      t[9] = addc(t[9], 0);
      t[1] = mad_hi_cc(m, Pm::p(0), t[1]);
#pragma unroll
      for (int j = 1; j < 8; j++) t[j + 1] = madc_hi_cc(m, Pm::p(j), t[j + 1]);
      t[9] = addc(t[9], 0);
#pragma unroll
      for (int j = 0; j < 9; j++) t[j] = t[j + 1];
      t[9] = 0;
    }
    fe r;
#pragma unroll
    for (int i = 0; i < 8; i++) r.v[i] = t[i];
    return Pm::kLazy ? r : canon(r);
#endif
  }

  UG_HD static fe sqr(const fe& a) { return mul(a, a); }
  UG_HD static fe exit(const fe& a) { return Pm::kLazy ? canon(a) : a; }

  // The Montgomery-domain inverse by Fermat, a^(p-2): inv(xR) = x^-1 R,
  // inv(0) = 0; canonical.  Fixed 4-bit windows over the exponent: 14
  // products for a^2 .. a^15, then 252 squarings and one product a nonzero
  // window (~60); the window's table lives in local memory.  The exponent
  // is a constant, so every lane of a warp takes the same products (the
  // MMA build's lock-step holds).  ~330 dependent products: one chain
  // serves a whole batch (chains.cuh, affine_epilogue).
  UG_HD static fe inv(const fe& a) {
    fe pw[16];
    pw[0] = one_mont();
    pw[1] = a;
#pragma unroll 1
    for (int i = 2; i < 16; i++) pw[i] = mul(pw[i - 1], a);
    fe r = pw[exp_nibble(63)];
#pragma unroll 1
    for (int k = 62; k >= 0; k--) {
      r = sqr(sqr(sqr(sqr(r))));
      const uint32_t e = exp_nibble(k);
      if (e != 0) r = mul(r, pw[e]);
    }
    return canon(r);
  }

  // nibble k (0: the lowest) of the exponent p - 2 (p's low limb is >= 2)
  UG_HD static uint32_t exp_nibble(int k) {
    const uint32_t limb = Pm::p(k >> 3) - (k < 8 ? 2u : 0u);
    return (limb >> (4 * (k & 7))) & 0xFu;
  }
};

using Fr = Field<FrParams>;
using Fq = Field<FqParams>;

// The Fq product as one out-of-line call (CIOS build, on the device), for
// the G2 bucket drain: its loop holds the fast and the complete add, ~90
// Fq products; inlined, it needs more than a thread's 255 registers and
// spills (as the per-step G2 kernels did).  A call keeps one product's
// working set live.  Everywhere else, and in the MMA build (whose product
// is already a call), it is Field::mul itself.
#if defined(__CUDACC__) && !UG_MMA_FIELD
template <class Pm>
__device__ __noinline__ fe mont_mul_call(fe a, fe b) { return Field<Pm>::mul(a, b); }
#endif

template <class Pm>
struct FieldCall : Field<Pm> {
  UG_HD static fe mul(const fe& a, const fe& b) {
#if defined(__CUDA_ARCH__) && !UG_MMA_FIELD
    return mont_mul_call<Pm>(a, b);
#else
    return Field<Pm>::mul(a, b);
#endif
  }
  UG_HD static fe sqr(const fe& a) { return mul(a, a); }
};

using FqCall = FieldCall<FqParams>;

// ---------------------------------------------------------------------------
// Fq2 = Fq[u]/(u^2 + 1), Karatsuba (ultragroth_tpu/ops/fq2.py:39-55), over
// a base field B: Fq, or FqCall (the same values).
// ---------------------------------------------------------------------------
struct fe2 { fe c0, c1; };

template <class B>
struct Fq2Over {
  using E = fe2;
  UG_HD static fe2 zero() { return {B::zero(), B::zero()}; }
  UG_HD static fe2 one_mont() { return {B::one_mont(), B::zero()}; }
  UG_HD static fe2 add(const fe2& a, const fe2& b) { return {B::add(a.c0, b.c0), B::add(a.c1, b.c1)}; }
  UG_HD static fe2 sub(const fe2& a, const fe2& b) { return {B::sub(a.c0, b.c0), B::sub(a.c1, b.c1)}; }
  UG_HD static fe2 neg(const fe2& a) { return {B::neg(a.c0), B::neg(a.c1)}; }
  UG_HD static bool is_zero(const fe2& a) { return B::is_zero(a.c0) && B::is_zero(a.c1); }
  UG_HD static fe2 mul(const fe2& a, const fe2& b) {
    fe t0 = B::mul(a.c0, b.c0);
    fe t1 = B::mul(a.c1, b.c1);
    fe t2 = B::mul(B::add(a.c0, a.c1), B::add(b.c0, b.c1));
    return {B::sub(t0, t1), B::sub(B::sub(t2, t0), t1)};
  }
  UG_HD static fe2 sqr(const fe2& a) {
    fe c0 = B::mul(B::add(a.c0, a.c1), B::sub(a.c0, a.c1));
    fe t = B::mul(a.c0, a.c1);
    return {c0, B::add(t, t)};
  }
  UG_HD static fe2 exit(const fe2& a) { return {B::exit(a.c0), B::exit(a.c1)}; }
  // a0^2 + a1^2, the norm to Fq: nonzero for a != 0 (-1 is not a square
  // mod q), so (a0 - a1 u) / norm(a) is the inverse
  UG_HD static fe norm(const fe2& a) { return B::add(B::sqr(a.c0), B::sqr(a.c1)); }
  // a / n for the Fq inverse ni of a's norm n: (a0 ni, -a1 ni)
  UG_HD static fe2 conj_scale(const fe2& a, const fe& ni) {
    return {B::mul(a.c0, ni), B::neg(B::mul(a.c1, ni))};
  }
  // the Montgomery-domain inverse through the norm, inv(0) = 0; canonical
  UG_HD static fe2 inv(const fe2& a) { return exit(conj_scale(a, B::inv(norm(a)))); }
};

using Fq2 = Fq2Over<Fq>;
using Fq2Call = Fq2Over<FqCall>;

// ---------------------------------------------------------------------------
// Plane-major I/O: element e of lane i, limb l sits at ptr[(e*8 + l)*n + i]
// (an Fq2 element takes two consecutive element slots, c0 then c1), so a
// warp's loads of one limb are 32 neighbouring words.
// ---------------------------------------------------------------------------
UG_HD fe load(const uint32_t* p, int64_t n, int64_t i, int e) {
  fe r;
#pragma unroll
  for (int l = 0; l < 8; l++) r.v[l] = p[(int64_t)(e * 8 + l) * n + i];
  return r;
}
UG_HD void store(uint32_t* p, int64_t n, int64_t i, int e, const fe& a) {
#pragma unroll
  for (int l = 0; l < 8; l++) p[(int64_t)(e * 8 + l) * n + i] = a.v[l];
}
UG_HD void load_elem(const uint32_t* p, int64_t n, int64_t i, int e, fe& r) { r = load(p, n, i, e); }
UG_HD void load_elem(const uint32_t* p, int64_t n, int64_t i, int e, fe2& r) {
  r.c0 = load(p, n, i, 2 * e); r.c1 = load(p, n, i, 2 * e + 1);
}
UG_HD void store_elem(uint32_t* p, int64_t n, int64_t i, int e, const fe& a) { store(p, n, i, e, a); }
UG_HD void store_elem(uint32_t* p, int64_t n, int64_t i, int e, const fe2& a) {
  store(p, n, i, 2 * e, a.c0); store(p, n, i, 2 * e + 1, a.c1);
}

}  // namespace ug
