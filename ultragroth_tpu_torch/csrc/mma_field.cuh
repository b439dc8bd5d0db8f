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
//      constant banded Toeplitz product Np[32, 32] @ X over bytes;
//   3. m * p as Pt[64, 32] @ m over bytes;
//   4. T = t + m * p; its high half (plus the word above it, which can be
//      1 when a, b < 2^256) minus p once where it is >= p.
//
// The byte operands are <= 255 and every column sum < 32 * 255^2 < 2^21,
// so u8 x u8 -> s32 tensor-core products are exact: the f32 work-arounds
// the TPU form needs (mxufield.py:17-32) fall away.
//
// Column sums back to words (mma_m_words, mma_high_half).  A sum c_r < 2^21
// has three bytes, so sum_r c_r 2^(8r) = A + E + O, three numbers in which
// no two bytes overlap: A holds byte 0 of every c_r at byte r, E bytes 1-2
// of the even c_r at bytes r+1, r+2, O those of the odd c_r.  Each of their
// 32-bit words is one to three byte permutes (prmt), and the value is two
// or three carry chains: ~60 integer instructions for m, ~85 for T's high
// half, where a 64-bit shift-and-add per column sum took ~300.
//
// T's low half is never formed.  T = t + m p is 0 mod 2^256 by the choice
// of m, so S = t_lo + A_lo + E_lo + O_lo (each term's low 256 bits) is
// k 2^256 with k <= 3, and the high half is t_hi + A_hi + E_hi + O_hi + k.
// k comes from word 7 alone: S = s7 2^224 + S' with s7 the sum of the four
// terms' word 7 and S' (the words below) < 4 2^224; S' = (k 2^32 - s7) 2^224
// is a multiple of 2^224, so S' = c 2^224 with c <= 3 and s7 + c = k 2^32,
// whence k = (s7 + 3) >> 32.  Word 7 needs the column sums 26..31 only, so
// of Pt @ m only columns 24..63 are formed: 5 of its 8 n-tiles.  No term
// reaches bit 512: column 63 of Pt is zero and column 62 a single byte
// product (< 2^16), so E and O end below it, and the carries of the three
// high-half chains are the word above T's high half.
//
// On the device (built with -DUG_MMA_FIELD=1) the product is WARP-
// COLLECTIVE: each thread owns one lane, and the warp's 32 lanes are the M
// dimension of raw `mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32`
// products (two m16 tiles; K = the 32 bytes of a lane's operand; N = the
// column sums): Np @ X is 2 x 4 of them, the needed columns of Pt @ m
// 2 x 5, 18 a warp-product.  A lane writes its operand (X, then m) as one
// 32-byte row with two 16-byte stores; `ldmatrix.x4` reads an m16 tile's
// A fragment from those rows in one instruction.  The constant B fragments
// (Np's four n-tiles, Pt's n-tiles 3..7) are stored once a block in
// fragment order, [tile][thread][8 B], one conflict-free 8-byte load each.
// The C fragments go back as adjacent-column pairs (8-byte stores) into a
// [lane][40] s32 buffer, and each lane reads its own row with 16-byte loads
// (8 for m, 10 for T).  Every index map below is __host__ __device__, and
// mont_mul_mma_warp_ref runs a warp's 32 lanes through them on the host.
//
// Shared memory (dynamic, `mma_smem_bytes`): 256 B of alignment slack, the
// B fragments (9 tiles x 32 threads x 8 B = 2,304 B, copied once per block
// by `mma_block_init` from a table the compiler makes), then 5 KB per warp: the
// [32 lanes][40 words] column-sum buffer, whose 16-byte chunks 8 and 9 of a
// row (the words of columns 56..63 in the T step) are also the lane's
// operand row.  The swizzle (chunk q of row r at chunk q ^ ((r >> 2) & 1))
// keeps the operand stores, the ldmatrix row reads, the pair stores and the
// row loads free of bank conflicts.  Five __syncwarp a product: after the
// operand stores (twice), after the C stores (twice), and between the
// second ldmatrix and the C stores that overwrite its rows.  A lane reads
// and writes only its own row outside ldmatrix and the C stores, so
// nothing is needed between one product and the next.
//
// Bound (H100): an Fr product moves 96 B a lane and does 128 32-bit
// multiply-adds for t plus 2,304 u8 MACs on the tensor cores (32 x 32 for
// m, 40 x 32 for T's columns 24..63).
//
// The lane-side steps are __host__ __device__; `mont_mul_mma_ref` runs the
// whole algorithm for one lane with plain loops in place of the tile
// products, which is what the g++ host harness's lane bodies use.
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

// prmt.b32: byte i of the result is byte sel[4i+2:4i] of {b, a} (a's bytes
// 0-3, b's 4-7)
UG_HD uint32_t byte_perm(uint32_t a, uint32_t b, uint32_t sel) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(a, b, sel);
#else
  const uint64_t x = ((uint64_t)b << 32) | a;
  uint32_t r = 0;
  for (int i = 0; i < 4; i++)
    r |= (uint32_t)((x >> (8 * ((sel >> (4 * i)) & 7))) & 0xFFu) << (8 * i);
  return r;
#endif
}

// Word w of A, E and O (see the top) from the column sums c[4w-2 .. 4w+3]
// (each < 2^24: its byte 3 is zero).
UG_HD uint32_t cs_word_a(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3) {
  return byte_perm(byte_perm(c0, c1, 0x0040), byte_perm(c2, c3, 0x0040), 0x5410);
}
UG_HD uint32_t cs_word_e(uint32_t cm2, uint32_t c0, uint32_t c2) {
  return byte_perm(byte_perm(cm2, c0, 0x3652), c2, 0x5210);
}
UG_HD uint32_t cs_word_o(uint32_t cm1, uint32_t c1) { return byte_perm(cm1, c1, 0x6521); }

// m = sum_r cs[r] 2^(8r) mod 2^256, r < 32
UG_HD void mma_m_words(const uint32_t cs[32], uint32_t m[8]) {
  uint32_t a[8], e[8], o[8];
#pragma unroll
  for (int w = 0; w < 8; w++) {
    const uint32_t cm2 = w ? cs[4 * w - 2] : 0u, cm1 = w ? cs[4 * w - 1] : 0u;
    a[w] = cs_word_a(cs[4 * w], cs[4 * w + 1], cs[4 * w + 2], cs[4 * w + 3]);
    e[w] = cs_word_e(cm2, cs[4 * w], cs[4 * w + 2]);
    o[w] = cs_word_o(cm1, cs[4 * w + 1]);
  }
  m[0] = add_cc(a[0], e[0]);
#pragma unroll
  for (int w = 1; w < 7; w++) m[w] = addc_cc(a[w], e[w]);
  m[7] = addc(a[7], e[7]);
  m[0] = add_cc(m[0], o[0]);
#pragma unroll
  for (int w = 1; w < 7; w++) m[w] = addc_cc(m[w], o[w]);
  m[7] = addc(m[7], o[7]);
}

// T's high half from t and the column sums 24..63 of Pt @ m (cs[r - 24]):
// words 8..15 into hi, the word above them returned (see the top).
UG_HD uint32_t mma_high_half(const uint32_t t[16], const uint32_t cs[40], uint32_t hi[8]) {
#define UG_CS(r) cs[(r) - 24]
  const uint64_t s7 = (uint64_t)t[7] + cs_word_a(UG_CS(28), UG_CS(29), UG_CS(30), UG_CS(31)) +
                      cs_word_e(UG_CS(26), UG_CS(28), UG_CS(30)) +
                      cs_word_o(UG_CS(27), UG_CS(29));
  const uint32_t k = (uint32_t)((s7 + 3) >> 32);
  uint32_t a[8], e[8], o[8];
#pragma unroll
  for (int w = 8; w < 16; w++) {
    a[w - 8] = cs_word_a(UG_CS(4 * w), UG_CS(4 * w + 1), UG_CS(4 * w + 2), UG_CS(4 * w + 3));
    e[w - 8] = cs_word_e(UG_CS(4 * w - 2), UG_CS(4 * w), UG_CS(4 * w + 2));
    o[w - 8] = cs_word_o(UG_CS(4 * w - 1), UG_CS(4 * w + 1));
  }
#undef UG_CS
  e[0] += k;     // byte 0 of E's word 8 is byte 2 of c_30 < 2^5: no carry
  hi[0] = add_cc(t[8], a[0]);
#pragma unroll
  for (int w = 1; w < 8; w++) hi[w] = addc_cc(t[8 + w], a[w]);
  uint32_t top = addc(0, 0);
  hi[0] = add_cc(hi[0], e[0]);
#pragma unroll
  for (int w = 1; w < 8; w++) hi[w] = addc_cc(hi[w], e[w]);
  top = addc(top, 0);
  hi[0] = add_cc(hi[0], o[0]);
#pragma unroll
  for (int w = 1; w < 8; w++) hi[w] = addc_cc(hi[w], o[w]);
  return addc(top, 0);
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
UG_HD constexpr uint32_t np_byte(int k) { return (Pm::np(k >> 2) >> (8 * (k & 3))) & 0xFFu; }
template <class Pm>
UG_HD constexpr uint32_t p_byte(int k) { return (Pm::p(k >> 2) >> (8 * (k & 3))) & 0xFFu; }

// The whole algorithm for one lane, the tile products as plain loops.
template <class Pm>
UG_HD fe mont_mul_mma_ref(const fe& a, const fe& b) {
  uint32_t t[16];
  mma_wide(a, b, t);
  uint32_t cs[32];
  for (int r = 0; r < 32; r++) {
    uint32_t s = 0;
    for (int c = 0; c <= r; c++) s += np_byte<Pm>(r - c) * word_byte(t, c);
    cs[r] = s;
  }
  uint32_t m[8];
  mma_m_words(cs, m);
  uint32_t mp[40];
  for (int r = 24; r < 64; r++) {
    uint32_t s = 0;
    for (int c = 0; c < 32; c++)
      if (r - c >= 0 && r - c < 32) s += p_byte<Pm>(r - c) * word_byte(m, c);
    mp[r - 24] = s;
  }
  uint32_t hi[8];
  const uint32_t top = mma_high_half(t, mp, hi);
  return mma_cond_sub<Pm>(hi, top);
}

// ---------------------------------------------------------------------------
// The warp-collective form: layout and fragment maps.
// ---------------------------------------------------------------------------
constexpr int kMmaSlack = 256;        // the base is aligned by hand to 256 B
constexpr int kMmaNpTiles = 4;        // Np @ X: n-tiles 0..3 (columns 0..31)
constexpr int kMmaPtFirst = 3;        // Pt @ m: n-tiles 3..7 (columns 24..63)
constexpr int kMmaBTiles = kMmaNpTiles + 8 - kMmaPtFirst;
constexpr int kMmaConstBytes = kMmaBTiles * 32 * 8;   // B fragments, 2,304 B
constexpr int kMmaRowWords = 40;      // column sums a lane row
constexpr int kMmaWarpBytes = 32 * kMmaRowWords * 4;  // 5,120 B

// dynamic shared memory an MMA-build kernel of `threads` threads needs
inline int mma_smem_bytes(int threads) {
  return kMmaSlack + kMmaConstBytes + (threads / 32) * kMmaWarpBytes;
}

// the swizzle: 16-byte chunk q of buffer row r lies at chunk q ^ mma_swz(r)
UG_HD int mma_swz(int row) { return (row >> 2) & 1; }
// word of column sum `col` (0..39) of lane row `row` in the warp's buffer
UG_HD int mma_cs_word(int row, int col) {
  return row * kMmaRowWords + (((col >> 2) ^ mma_swz(row)) << 2) + (col & 3);
}
// byte of half h (bytes 16h..16h+15) of lane row `row`'s operand: the
// row's chunks 8 and 9
UG_HD int mma_op_byte(int row, int h) {
  return row * kMmaRowWords * 4 + ((8 + (h ^ mma_swz(row))) << 4);
}

// ldmatrix.m8n8.x4 for m-tile mt: thread l gives the address of row l & 7
// of matrix l >> 3, which is operand half l >> 4 of lane row
// 16 mt + 8 ((l >> 3) & 1) + (l & 7); the instruction hands thread l, in
// register q, bytes 4 (l & 3) .. 4 (l & 3) + 3 of row l >> 2 of matrix q.
UG_HD int mma_ldm_row(int l, int mt) { return 16 * mt + 8 * ((l >> 3) & 1) + (l & 7); }
UG_HD int mma_ldm_half(int l) { return l >> 4; }

// The m16n8k32 u8 fragments (PTX ISA, "mma.m16n8k32"), g = l >> 2, u = l & 3:
// A register q, byte i: row g + 8 (q & 1), k = 4u + i + 16 (q >> 1);
// B register q, byte i: k = 4u + i + 16q, column g;
// C register i: row g + 8 (i >> 1), column 2u + (i & 1).
UG_HD int mma_a_row(int l, int q) { return (l >> 2) + 8 * (q & 1); }
UG_HD int mma_a_k(int l, int q, int i) { return 4 * (l & 3) + i + 16 * (q >> 1); }
UG_HD constexpr int mma_b_k(int l, int q, int i) { return 4 * (l & 3) + i + 16 * q; }
UG_HD constexpr int mma_b_col(int l) { return l >> 2; }
UG_HD int mma_c_row(int l, int i) { return (l >> 2) + 8 * (i >> 1); }
UG_HD int mma_c_col(int l, int i) { return 2 * (l & 3) + (i & 1); }

// Register q of thread l's B fragment of constant tile `tile` (0..3: Np's
// n-tile tile, Np[r][c] = byte r-c of n' for r >= c; then Pt's n-tiles
// kMmaPtFirst.., Pt[r][c] = byte r-c of p for 0 <= r-c < 32): B[k][n] =
// M[8 nt + n][k].
template <class Pm>
UG_HD constexpr uint32_t mma_b_reg(int tile, int l, int q) {
  const bool np = tile < kMmaNpTiles;
  const int nt = np ? tile : tile - kMmaNpTiles + kMmaPtFirst;
  uint32_t v = 0;
  for (int i = 0; i < 4; i++) {
    const int d = 8 * nt + mma_b_col(l) - mma_b_k(l, q, i);
    if (d >= 0 && d < 32) v |= (np ? np_byte<Pm>(d) : p_byte<Pm>(d)) << (8 * i);
  }
  return v;
}

// Every B fragment register of a field, [tile][thread][q], made by the
// compiler (constexpr), so a block's start copies 2,304 B from a table in
// device memory instead of computing bytes of the modulus.
struct MmaBFrags { uint32_t w[kMmaBTiles * 64]; };
template <class Pm>
UG_HD constexpr MmaBFrags mma_b_frags() {
  MmaBFrags t{};
  for (int k = 0; k < kMmaBTiles * 64; k++) t.w[k] = mma_b_reg<Pm>(k >> 6, (k >> 1) & 31, k & 1);
  return t;
}

#if !defined(__CUDACC__)
// The device product's data movement for one warp on the host: the same
// shared-memory offsets, with ldmatrix and mma done by their fragment maps
// (a 5 KB buffer and the B fragments as the block's shared memory).
template <class Pm>
inline void mont_mul_mma_warp_ref(const fe a[32], const fe b[32], fe out[32]) {
  uint32_t bfrag[kMmaBTiles][32][2];
  for (int tile = 0; tile < kMmaBTiles; tile++)
    for (int l = 0; l < 32; l++)
      for (int q = 0; q < 2; q++) bfrag[tile][l][q] = mma_b_reg<Pm>(tile, l, q);
  alignas(16) unsigned char buf[kMmaWarpBytes] = {};
  auto word = [&](int w) -> uint32_t* { return (uint32_t*)(buf + 4 * w); };
  auto put_row = [&](int lane, const uint32_t v[8]) {
    for (int h = 0; h < 2; h++)
      for (int j = 0; j < 4; j++) ((uint32_t*)(buf + mma_op_byte(lane, h)))[j] = v[4 * h + j];
  };
  // the warp's tile products: ldmatrix.x4 of both m-tiles, then for each
  // B tile of [first, first + count) the mma and the C pair stores at
  // column base col0 + 8 (tile - first)
  auto products = [&](int first, int count, int col0) {
    uint32_t fa[2][32][4];
    for (int mt = 0; mt < 2; mt++)
      for (int l = 0; l < 32; l++)
        for (int q = 0; q < 4; q++) {
          const int src = 8 * q + (l >> 2);     // the thread that gave the row
          const unsigned char* row = buf + mma_op_byte(mma_ldm_row(src, mt), mma_ldm_half(src));
          fa[mt][l][q] = *(const uint32_t*)(row + 4 * (l & 3));
        }
    for (int tile = first; tile < first + count; tile++)
      for (int mt = 0; mt < 2; mt++) {
        uint32_t A[16][32], B[32][8];
        for (int l = 0; l < 32; l++)
          for (int q = 0; q < 4; q++)
            for (int i = 0; i < 4; i++) {
              A[mma_a_row(l, q)][mma_a_k(l, q, i)] = (fa[mt][l][q] >> (8 * i)) & 0xFFu;
              if (q < 2) B[mma_b_k(l, q, i)][mma_b_col(l)] = (bfrag[tile][l][q] >> (8 * i)) & 0xFFu;
            }
        for (int l = 0; l < 32; l++) {
          uint32_t c[4];
          for (int i = 0; i < 4; i++) {
            c[i] = 0;
            for (int k = 0; k < 32; k++) c[i] += A[mma_c_row(l, i)][k] * B[k][mma_c_col(l, i)];
          }
          const int col = col0 + 8 * (tile - first);
          for (int p = 0; p < 2; p++) {
            uint32_t* w = word(mma_cs_word(16 * mt + mma_c_row(l, 2 * p),
                                           col + mma_c_col(l, 2 * p)));
            w[0] = c[2 * p];
            w[1] = c[2 * p + 1];
          }
        }
      }
  };
  auto get_row = [&](int lane, int n, uint32_t* cs) {
    for (int q = 0; q < n; q++)
      for (int j = 0; j < 4; j++) cs[4 * q + j] = word(mma_cs_word(lane, 4 * q))[j];
  };
  uint32_t t[32][16], m[32][8];
  for (int l = 0; l < 32; l++) {
    mma_wide(a[l], b[l], t[l]);
    put_row(l, t[l]);
  }
  products(0, kMmaNpTiles, 0);
  for (int l = 0; l < 32; l++) {
    uint32_t cs[32];
    get_row(l, 8, cs);
    mma_m_words(cs, m[l]);
    put_row(l, m[l]);
  }
  products(kMmaNpTiles, kMmaBTiles - kMmaNpTiles, 0);
  for (int l = 0; l < 32; l++) {
    uint32_t cs[40], hi[8];
    get_row(l, 10, cs);
    const uint32_t top = mma_high_half(t[l], cs, hi);
    out[l] = mma_cond_sub<Pm>(hi, top);
  }
}
#endif

// (declared in both of nvcc's passes: kernel bodies name them in each)
#if defined(__CUDACC__) && UG_MMA_FIELD
extern __shared__ __align__(16) unsigned char ug_mma_smem_raw[];

__device__ __forceinline__ unsigned char* mma_smem() {
  return (unsigned char*)(((uintptr_t)ug_mma_smem_raw + (kMmaSlack - 1)) &
                          ~(uintptr_t)(kMmaSlack - 1));
}

__device__ const MmaBFrags ug_mma_b_fr = mma_b_frags<FrParams>();
__device__ const MmaBFrags ug_mma_b_fq = mma_b_frags<FqParams>();

// every thread of the block, before any lane work: the B fragments
template <class Pm>
__device__ void mma_block_init() {
  uint32_t* s = (uint32_t*)mma_smem();
  const uint32_t* src = Pm::kLazy ? ug_mma_b_fq.w : ug_mma_b_fr.w;
  for (int k = threadIdx.x; k < kMmaBTiles * 64; k += blockDim.x) s[k] = src[k];
  __syncthreads();
}

#if defined(__CUDA_ARCH__)
__device__ __forceinline__ void mma_ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_u8_16832(uint32_t d[4], const uint32_t a[4], uint2 b) {
  const uint32_t z = 0;
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y), "r"(z));
}
#endif

// The warp's tile products over the operand rows: the A fragments of both
// m-tiles by ldmatrix, then for each B tile of [first, first + count) two
// mma and the C pairs at column base 8 (tile - first) of each lane row,
// stored as soon as they are made.  kLastOverlaps: the last tile's
// columns are the operand rows' bytes (the T step's columns 56..63), so
// its stores wait behind a __syncwarp for every lane's ldmatrix.
template <int kFirst, int kCount, bool kLastOverlaps>
__device__ __forceinline__ void mma_products(const uint2* bfrag, unsigned char* rows,
                                             int lane) {
#if defined(__CUDA_ARCH__)
  const uint32_t rows_s = (uint32_t)__cvta_generic_to_shared(rows);
  uint32_t* cs = (uint32_t*)rows;
  uint32_t fa[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; mt++)
    mma_ldmatrix_x4(fa[mt], rows_s + mma_op_byte(mma_ldm_row(lane, mt), mma_ldm_half(lane)));
#pragma unroll
  for (int j = 0; j < kCount; j++) {
    const uint2 bf = bfrag[(kFirst + j) * 32 + lane];
    uint32_t c[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; mt++) mma_u8_16832(c[mt], fa[mt], bf);
    if (kLastOverlaps && j == kCount - 1) __syncwarp();
#pragma unroll
    for (int mt = 0; mt < 2; mt++)
#pragma unroll
      for (int p = 0; p < 2; p++)
        *(uint2*)(cs + mma_cs_word(16 * mt + mma_c_row(lane, 2 * p),
                                   8 * j + mma_c_col(lane, 2 * p))) =
            make_uint2(c[mt][2 * p], c[mt][2 * p + 1]);
  }
#endif
}

// a lane's first 4 kChunks column sums of its own row, 16 bytes a load
template <int kChunks>
__device__ __forceinline__ void mma_row_load(const uint32_t* cs, int lane, uint32_t* col) {
#pragma unroll
  for (int q = 0; q < kChunks; q++) {
    const uint4 v = *(const uint4*)(cs + mma_cs_word(lane, 4 * q));
    col[4 * q] = v.x;
    col[4 * q + 1] = v.y;
    col[4 * q + 2] = v.z;
    col[4 * q + 3] = v.w;
  }
}

// The product as the kernels call it.  Out of line: a G2 lane body holds
// ~30 products, and inlining each made the MMA build's G2 source take
// minutes to compile; the operands pass by value, in registers.  Inlined
// into the Fr kernels it made fr_mont_mul 1.5 % faster and fr_cg_ntt 1.5x
// slower (tools/torch_mma_variants.py, fr_inline).
template <class Pm>
__device__ __noinline__ fe mont_mul_mma_dev(fe a, fe b) {
  unsigned char* base = mma_smem();
  const uint2* bfrag = (const uint2*)base;
  unsigned char* rows = base + kMmaConstBytes + (threadIdx.x >> 5) * kMmaWarpBytes;
  const uint32_t* cs = (const uint32_t*)rows;
  const int lane = threadIdx.x & 31;

  uint32_t t[16];
  mma_wide(a, b, t);
  *(uint4*)(rows + mma_op_byte(lane, 0)) = make_uint4(t[0], t[1], t[2], t[3]);
  *(uint4*)(rows + mma_op_byte(lane, 1)) = make_uint4(t[4], t[5], t[6], t[7]);
  __syncwarp();
  mma_products<0, kMmaNpTiles, false>(bfrag, rows, lane);
  __syncwarp();
  uint32_t col[40];
  mma_row_load<8>(cs, lane, col);
  uint32_t m[8];
  mma_m_words(col, m);
  *(uint4*)(rows + mma_op_byte(lane, 0)) = make_uint4(m[0], m[1], m[2], m[3]);
  *(uint4*)(rows + mma_op_byte(lane, 1)) = make_uint4(m[4], m[5], m[6], m[7]);
  __syncwarp();
  mma_products<kMmaNpTiles, kMmaBTiles - kMmaNpTiles, true>(bfrag, rows, lane);
  __syncwarp();
  mma_row_load<10>(cs, lane, col);
  uint32_t hi[8];
  const uint32_t top = mma_high_half(t, col, hi);
  return mma_cond_sub<Pm>(hi, top);
}
#endif

}  // namespace ug
