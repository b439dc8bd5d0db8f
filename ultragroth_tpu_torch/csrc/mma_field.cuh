// Montgomery product with the reduction on the tensor cores: the MMA field.
//
// Replaces ultragroth_tpu/ops/mxufield.py:88 (mont_mul_mxu), the alternative
// multiplier that runs inside every Pallas kernel when ULTRAGROTH_MXU_FIELD
// is set.  Same algorithm, same result: a * b * 2^-256 mod p, canonical, for
// a, b < 2^256 with the product bounded as in CIOS (the lazy [0, 2p) inputs
// of the Fq kernels satisfy it).
//
//   1. t = a * b, 512 bits, on the CUDA cores (mad.lo / mad.hi chains);
//   2. m = (t mod 2^256) * n' mod 2^256, n' = -p^-1 mod 2^256, as the
//      constant banded Toeplitz product Np[32, 32] @ X over bytes, then a
//      carry ripple (the final carry dropped: mod 2^256);
//   3. m * p as Pt[64, 32] @ m over bytes;
//   4. T = t + m * p; its high half (plus the word above it, which can be
//      1 when a, b < 2^256) minus p once where it is >= p.
//
// The byte operands are <= 255 and every column sum < 32 * 255^2 < 2^21,
// so u8 x u8 -> s32 tensor-core products are exact: the f32 work-arounds
// the TPU form needs (mxufield.py:17-32) fall away.
//
// On the device (built with -DUG_MMA_FIELD=1) the product is WARP-
// COLLECTIVE: each thread owns one lane, the warp stages its 32 lanes' byte
// vectors in shared memory as a [32 bytes x 32 lanes] u8 tile, and the two
// Toeplitz products run through WMMA (<mma.h>, 16x16x16 u8 tiles): Np @ X
// is 2 x 2 x 2 tiles, Pt @ m is 4 x 2 x 2, done as two halves of rows so
// the s32 result tile is 4 KB.  All 32 threads of a warp must reach every
// product together, so the kernels of the MMA build run branch-free lane
// bodies (curve.cuh) and clamp, not drop, the lanes past the end.
// Bound (H100): an Fr product moves 96 B a lane and does 128 32-bit
// multiply-adds for t plus 3,072 u8 MACs on the tensor cores; per lane the
// staging costs 2 x 32 B of shared stores and 2 x 128 B of s32 loads.
// First, simple design: WMMA through shared memory; raw mma.sync / wgmma
// and a better staging scheme are later work.
//
// Shared memory (dynamic, `mma_smem_bytes`): 256 B of alignment slack, the
// constant tiles (Np 1 KB, Pt 2 KB, built once per block from the modulus
// words by `mma_block_init`), then 5 KB per warp (the u8 operand tile X or
// m, 1 KB; the s32 result tile, 4 KB).
//
// The lane-side steps (schoolbook, byte ripple, high half, conditional
// subtract) are __host__ __device__; `mont_mul_mma_ref` runs the whole
// algorithm with plain loops in place of the tile products, which is what
// the g++ host harness builds for the CPU tests.
#pragma once

namespace ug {

// t = a * b (16 words).  Row i adds a * b_i: a low-half chain into words
// i..i+8 (word i+8 is still zero), then a high-half chain into words
// i+1..i+8, which never carries out (the partial product fits i+9 words).
UG_HD void mma_wide(const fe& a, const fe& b, uint32_t t[16]) {
#pragma unroll
  for (int i = 0; i < 16; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint32_t bi = b.v[i];
    t[i] = mad_lo_cc(a.v[0], bi, t[i]);
#pragma unroll
    for (int j = 1; j < 8; j++) t[i + j] = madc_lo_cc(a.v[j], bi, t[i + j]);
    t[i + 8] = addc(0, 0);
    t[i + 1] = mad_hi_cc(a.v[0], bi, t[i + 1]);
#pragma unroll
    for (int j = 1; j < 8; j++) t[i + 1 + j] = madc_hi_cc(a.v[j], bi, t[i + 1 + j]);
  }
}

UG_HD uint32_t word_byte(const uint32_t* w, int k) {
  return (w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
}

// m = sum_r cs[r * st] * 2^(8r) mod 2^256, r < 32 (cs < 2^21 each)
UG_HD void mma_m_words(const int32_t* cs, int st, uint32_t m[8]) {
  uint64_t carry = 0;
#pragma unroll
  for (int w = 0; w < 8; w++) {
    uint64_t s = carry;
#pragma unroll
    for (int j = 0; j < 4; j++) s += (uint64_t)(uint32_t)cs[(4 * w + j) * st] << (8 * j);
    m[w] = (uint32_t)s;
    carry = s >> 32;
  }
}

// One half of T = t + m * p: rows 32*half .. 32*half + 31 of m * p (mp[r *
// st] for r < 32) added to words 8*half .. 8*half + 7 of t; the carry runs
// on into the next half.  After half 1, `words` is T's high half and the
// carry the word above it.
UG_HD void mma_add_rows(const uint32_t t[16], const int32_t* mp, int st, int half,
                        uint64_t& carry, uint32_t words[8]) {
#pragma unroll
  for (int w = 0; w < 8; w++) {
    uint64_t s = carry + t[8 * half + w];
#pragma unroll
    for (int j = 0; j < 4; j++) s += (uint64_t)(uint32_t)mp[(4 * w + j) * st] << (8 * j);
    words[w] = (uint32_t)s;
    carry = s >> 32;
  }
}

// (top * 2^256 + hi) minus p once where it is >= p (mxufield.py:161-165)
template <class Pm>
UG_HD fe mma_cond_sub(const uint32_t hi[8], uint32_t top) {
  fe h, d;
#pragma unroll
  for (int i = 0; i < 8; i++) h.v[i] = hi[i];
  d.v[0] = sub_cc(h.v[0], Pm::p(0));
#pragma unroll
  for (int i = 1; i < 8; i++) d.v[i] = subc_cc(h.v[i], Pm::p(i));
  const uint32_t borrow = subc(0, 0);
  return (top != 0 || borrow == 0) ? d : h;
}

template <class Pm>
UG_HD uint32_t np_byte(int k) { return (Pm::np(k >> 2) >> (8 * (k & 3))) & 0xFFu; }
template <class Pm>
UG_HD uint32_t p_byte(int k) { return (Pm::p(k >> 2) >> (8 * (k & 3))) & 0xFFu; }

// The constant tiles: Np[r][c] = byte r-c of n' (r >= c), Pt[r][c] = byte
// r-c of p (0 <= r-c < 32).  Entry k of the 3 KB block: tile k >> 8 (0-3:
// Np tile (rt, ct) = (tile >> 1, tile & 1); 4-11: Pt tile (rt, ct) the same
// from tile - 4), element (rr, cc) = ((k & 255) >> 4, k & 15), row-major.
template <class Pm>
UG_HD uint8_t mma_const_byte(int k) {
  const int tile = k >> 8, rr = (k & 255) >> 4, cc = k & 15;
  const int tt = tile < 4 ? tile : tile - 4;
  const int d = ((tt >> 1) * 16 + rr) - ((tt & 1) * 16 + cc);
  if (d < 0 || d >= 32) return 0;
  return (uint8_t)(tile < 4 ? np_byte<Pm>(d) : p_byte<Pm>(d));
}

// The whole algorithm for one lane, the tile products as plain loops.
template <class Pm>
UG_HD fe mont_mul_mma_ref(const fe& a, const fe& b) {
  uint32_t t[16];
  mma_wide(a, b, t);
  int32_t cs[32];
  for (int r = 0; r < 32; r++) {
    int32_t s = 0;
    for (int c = 0; c <= r; c++) s += (int32_t)(np_byte<Pm>(r - c) * word_byte(t, c));
    cs[r] = s;
  }
  uint32_t m[8];
  mma_m_words(cs, 1, m);
  int32_t mp[64];
  for (int r = 0; r < 64; r++) {
    int32_t s = 0;
    for (int c = 0; c < 32; c++)
      if (r - c >= 0 && r - c < 32) s += (int32_t)(p_byte<Pm>(r - c) * word_byte(m, c));
    mp[r] = s;
  }
  uint64_t carry = 0;
  uint32_t hi[8];
  mma_add_rows(t, mp, 1, 0, carry, hi);
  mma_add_rows(t, mp + 32, 1, 1, carry, hi);
  return mma_cond_sub<Pm>(hi, (uint32_t)carry);
}

// ---------------------------------------------------------------------------
// Device form: the warp-collective product over shared-memory tiles.
// ---------------------------------------------------------------------------
constexpr int kMmaSlack = 256;        // the base is aligned by hand to 256 B
constexpr int kMmaConstBytes = 3072;  // Np 1 KB + Pt 2 KB
constexpr int kMmaWarpBytes = 5120;   // u8 operand tile 1 KB + s32 tile 4 KB

// dynamic shared memory an MMA-build kernel of `threads` threads needs
inline int mma_smem_bytes(int threads) {
  return kMmaSlack + kMmaConstBytes + (threads / 32) * kMmaWarpBytes;
}

// (declared in both of nvcc's passes: kernel bodies name them in each)
#if defined(__CUDACC__) && UG_MMA_FIELD
extern __shared__ __align__(16) unsigned char ug_mma_smem_raw[];

__device__ __forceinline__ unsigned char* mma_smem() {
  return (unsigned char*)(((uintptr_t)ug_mma_smem_raw + (kMmaSlack - 1)) &
                          ~(uintptr_t)(kMmaSlack - 1));
}

// every thread of the block, before any lane work
template <class Pm>
__device__ void mma_block_init() {
  unsigned char* s = mma_smem();
  for (int k = threadIdx.x; k < kMmaConstBytes; k += blockDim.x)
    s[k] = mma_const_byte<Pm>(k);
  __syncthreads();
}

// Not inlined: a G2 lane body holds ~30 products, and inlining this one
// into each (24 tile products, unrolled) made the MMA build's G2 source
// take minutes to compile; the operands pass by value, in registers.
template <class Pm>
__device__ __noinline__ fe mont_mul_mma_dev(fe a, fe b) {
  using namespace nvcuda;
  unsigned char* base = mma_smem();
  const unsigned char* np_t = base;                 // [2][2][16][16]
  const unsigned char* pt_t = base + 1024;          // [4][2][16][16]
  unsigned char* xs = base + kMmaConstBytes + (threadIdx.x >> 5) * kMmaWarpBytes;
  int* acc = (int*)(xs + 1024);                     // [32 rows][32 lanes]
  uint4* xv = (uint4*)xs;                           // [2 halves][32 lanes][16 B]
  const int lane = threadIdx.x & 31;

  uint32_t t[16];
  mma_wide(a, b, t);
  // X = bytes 0..31 of t: lane n's bytes 16h..16h+15 at xs[h*512 + n*16]
  xv[lane] = make_uint4(t[0], t[1], t[2], t[3]);
  xv[32 + lane] = make_uint4(t[4], t[5], t[6], t[7]);
  __syncwarp();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, unsigned char, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, unsigned char, wmma::col_major> fb;
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> fc;
#pragma unroll
  for (int rt = 0; rt < 2; rt++)
#pragma unroll
    for (int nt = 0; nt < 2; nt++) {
      wmma::fill_fragment(fc, 0);
#pragma unroll
      for (int kt = 0; kt < 2; kt++) {
        wmma::load_matrix_sync(fa, np_t + (rt * 2 + kt) * 256, 16);
        wmma::load_matrix_sync(fb, xs + kt * 512 + nt * 256, 16);
        wmma::mma_sync(fc, fa, fb, fc);
      }
      wmma::store_matrix_sync(acc + rt * 16 * 32 + nt * 16, fc, 32, wmma::mem_row_major);
    }
  __syncwarp();
  uint32_t m[8];
  mma_m_words(acc + lane, 32, m);
  __syncwarp();
  xv[lane] = make_uint4(m[0], m[1], m[2], m[3]);
  xv[32 + lane] = make_uint4(m[4], m[5], m[6], m[7]);
  __syncwarp();

  uint64_t carry = 0;
  uint32_t hi[8];
#pragma unroll
  for (int half = 0; half < 2; half++) {
#pragma unroll
    for (int rt2 = 0; rt2 < 2; rt2++)
#pragma unroll
      for (int nt = 0; nt < 2; nt++) {
        wmma::fill_fragment(fc, 0);
#pragma unroll
        for (int kt = 0; kt < 2; kt++) {
          wmma::load_matrix_sync(fa, pt_t + ((half * 2 + rt2) * 2 + kt) * 256, 16);
          wmma::load_matrix_sync(fb, xs + kt * 512 + nt * 256, 16);
          wmma::mma_sync(fc, fa, fb, fc);
        }
        wmma::store_matrix_sync(acc + rt2 * 16 * 32 + nt * 16, fc, 32, wmma::mem_row_major);
      }
    __syncwarp();
    mma_add_rows(t, acc + lane, 32, half, carry, hi);
    __syncwarp();
  }
  return mma_cond_sub<Pm>(hi, (uint32_t)carry);
}
#endif

}  // namespace ug
