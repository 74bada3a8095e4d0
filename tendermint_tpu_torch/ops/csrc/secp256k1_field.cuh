// The secp256k1 field arithmetic that K3 (secp256k1_ladder.cu) and K6
// (secp256k1_verify.cu) share: libsecp256k1's ten 26-bit limbs of
// ops/fe_secp256k1.py (nine of 26 bits, the top one of 22), the parallel
// and sequential carries, addition and subtraction (a + 2p - b), the
// multiplication by b3 = 21, the 100-product multiplication and the
// 55-product squaring with their fold by 2^260 = 0x1000003D10 (mod p), and
// the canonical form. Every intermediate is the same integer as in
// fe_secp256k1.py's plain version. ops/_build.py hashes this header into
// the library name of every source that includes it, so an edit here
// rebuilds both kernels.

#pragma once

#include <cstdint>

namespace {

constexpr int NL = 10;
constexpr uint32_t M26 = (1u << 26) - 1;
constexpr uint32_t M22 = (1u << 22) - 1;
constexpr uint32_t TOP_LO = 0x3D1, TOP_HI = 0x40;  // 2^256 mod p
constexpr uint32_t FOLD_LO = 0x3D10, FOLD_HI = 0x400;  // 2^260 mod p
constexpr uint32_t FOLD19_LO = 0xF44000, FOLD19_HI = 0x100000;  // 0x400 * 2^260
constexpr uint32_t B3 = 21;

// 2p spread over the limbs (fe_secp256k1.K_SUB)
__constant__ uint32_t KSUB[NL] = {0x7FFF85E, 0x7FFFF7E, 0x7FFFFFE, 0x7FFFFFE,
                                  0x7FFFFFE, 0x7FFFFFE, 0x7FFFFFE, 0x7FFFFFE,
                                  0x7FFFFFE, 0x7FFFFE};

__device__ __forceinline__ int width(int i) { return i == NL - 1 ? 22 : 26; }
__device__ __forceinline__ uint32_t lmask(int i) { return i == NL - 1 ? M22 : M26; }

struct Fe {
  uint32_t v[NL];
};

// one parallel carry pass; the carry out of limb 9 weighs 2^256
__device__ __forceinline__ void carry_par(const uint32_t t[NL], uint32_t o[NL]) {
  uint32_t c[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) c[i] = t[i] >> width(i);
  o[0] = (t[0] & M26) + TOP_LO * c[9];
  o[1] = (t[1] & M26) + c[0] + TOP_HI * c[9];
#pragma unroll
  for (int i = 2; i < NL; ++i) o[i] = (t[i] & lmask(i)) + c[i - 1];
}

__device__ __forceinline__ Fe fe_carried(const uint32_t t[NL]) {
  Fe o;
  carry_par(t, o.v);
  return o;
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  uint32_t t[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) t[i] = a.v[i] + b.v[i];
  return fe_carried(t);
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  uint32_t t[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) t[i] = a.v[i] + KSUB[i] - b.v[i];
  return fe_carried(t);
}

__device__ __forceinline__ Fe fe_mul_b3(const Fe& a) {
  uint32_t t[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) t[i] = B3 * a.v[i];
  return fe_carried(t);
}

// r + a b as a 32x32 -> 64-bit multiply-add
__device__ __forceinline__ uint64_t madw(uint32_t a, uint32_t b, uint64_t r) {
  uint64_t o;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(o) : "r"(a), "r"(b), "l"(r));
  return o;
}

// bits [s, s + 32) of a 64-bit word (one funnel shift)
__device__ __forceinline__ uint32_t shr64(uint64_t x, int s) {
  return __funnelshift_r((uint32_t)x, (uint32_t)(x >> 32), s);
}

// the 19 product columns c[0..18] -> carried limbs: one parallel 26-bit
// pass over the 20 columns brings every column to limb width, then column
// k >= 10 folds by 0x3D10 at k - 10 and 0x400 at k - 9; two carry passes.
// Only the columns and the folded limbs need 64 bits: by fe_secp256k1's
// bounds d_k < 2^30, r_k < 2^44, and after the first carry pass every limb
// and carry is below 2^28, so the rest runs on 32-bit words (the same
// integers as the plain version's int64 schedule).
__device__ __forceinline__ Fe fe_fold(const uint64_t c[2 * NL]) {
  uint32_t d[2 * NL];
  d[0] = (uint32_t)c[0] & M26;
#pragma unroll
  for (int k = 1; k < 2 * NL - 1; ++k) d[k] = ((uint32_t)c[k] & M26) + shr64(c[k - 1], 26);
  d[2 * NL - 1] = shr64(c[2 * NL - 2], 26);
  uint64_t r[NL];
  r[0] = madw(d[19], FOLD19_LO, madw(d[10], FOLD_LO, d[0]));
  r[1] = madw(d[19], FOLD19_HI,
              madw(d[10], FOLD_HI, madw(d[11], FOLD_LO, d[1])));
#pragma unroll
  for (int k = 2; k < NL; ++k)
    r[k] = madw(d[k + 9], FOLD_HI, madw(d[k + 10], FOLD_LO, d[k]));
  uint32_t cr[NL], o[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) cr[i] = shr64(r[i], width(i));
  o[0] = ((uint32_t)r[0] & M26) + TOP_LO * cr[9];
  o[1] = ((uint32_t)r[1] & M26) + cr[0] + TOP_HI * cr[9];
#pragma unroll
  for (int i = 2; i < NL; ++i) o[i] = ((uint32_t)r[i] & lmask(i)) + cr[i - 1];
  return fe_carried(o);
}

// The products are out of line: one copy of each body keeps the window
// loop's code small; the operands travel in registers, by value.
__device__ __noinline__ Fe fe_mul(Fe a, Fe b) {
  uint64_t c[2 * NL];
#pragma unroll
  for (int k = 0; k < 2 * NL; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < NL; ++j) c[i + j] += (uint64_t)a.v[i] * b.v[j];
  }
  return fe_fold(c);
}

// 55 products: the ten squares and the doubled cross terms (2 a_i < 2^28
// for carried limbs); every column is the same integer as fe_mul(a, a)'s
__device__ __noinline__ Fe fe_sq(Fe a) {
  uint32_t a2[NL];
  uint64_t c[2 * NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) a2[i] = a.v[i] << 1;
#pragma unroll
  for (int k = 0; k < 2 * NL; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    c[2 * i] += (uint64_t)a.v[i] * a.v[i];
#pragma unroll
    for (int j = i + 1; j < NL; ++j) c[i + j] += (uint64_t)a2[i] * a.v[j];
  }
  return fe_fold(c);
}

__device__ __forceinline__ Fe fe_sel(bool c, const Fe& a, const Fe& b) {
  Fe o;
#pragma unroll
  for (int i = 0; i < NL; ++i) o.v[i] = c ? a.v[i] : b.v[i];
  return o;
}

__device__ __forceinline__ void seq_carry(uint32_t x[NL], bool fold) {
#pragma unroll
  for (int i = 0; i < NL - 1; ++i) {
    const uint32_t c = x[i] >> 26;
    x[i] &= M26;
    x[i + 1] += c;
  }
  if (fold) {
    const uint32_t c = x[9] >> 22;
    x[9] &= M22;
    x[0] += TOP_LO * c;
    x[1] += TOP_HI * c;
  }
}

// carried -> exact-width limbs of the value mod p (fe_secp256k1.canonical)
__device__ Fe fe_canonical(const Fe& a) {
  Fe x = a;
  for (int r = 0; r < 3; ++r) seq_carry(x.v, true);
  Fe t = x;
  t.v[0] += TOP_LO;
  t.v[1] += TOP_HI;
  seq_carry(t.v, false);
  const bool ge = (t.v[9] >> 22) != 0;
  t.v[9] &= M22;
  return ge ? t : x;
}

__device__ bool fe_is_zero(const Fe& a) {
  const Fe c = fe_canonical(a);
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) acc |= c.v[i];
  return acc == 0;
}

}  // namespace
