// The ed25519 field arithmetic that K2 (ed25519_ladder.cu), K4
// (ed25519_msm.cu) and K5 (ed25519_verify.cu) share: the ten radix-2^25.5
// limbs of ops/fe.py, the parallel and sequential carries, addition and
// subtraction (a + 2p - b), the 100-product multiplication and the
// 55-product squaring, and the canonical form. Every product column is the
// same integer as in fe.py's plain version, so each kernel matches its
// plain version limb for limb. ops/_build.py hashes this header into the
// library name of every source that includes it, so an edit here rebuilds
// all three kernels.

#pragma once

#include <cstdint>

namespace {

constexpr int NL = 10;
constexpr uint32_t M26 = (1u << 26) - 1;
constexpr uint32_t M25 = (1u << 25) - 1;

__device__ __forceinline__ int width(int i) { return (i & 1) ? 25 : 26; }
__device__ __forceinline__ uint32_t lmask(int i) { return (i & 1) ? M25 : M26; }

struct Fe {
  uint32_t v[NL];
};

// 2p spread over the limbs (fe.K_SUB)
__device__ __forceinline__ uint32_t ksub(int i) {
  return i == 0 ? 2u * ((1u << 26) - 19u) : 2u * lmask(i);
}

// one parallel carry pass; the carry out of limb 9 folds into limb 0 * 19
__device__ __forceinline__ Fe carry_par(const uint32_t t[NL]) {
  Fe o;
  uint32_t c[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) c[i] = t[i] >> width(i);
  o.v[0] = (t[0] & M26) + 19u * c[9];
#pragma unroll
  for (int i = 1; i < NL; ++i) o.v[i] = (t[i] & lmask(i)) + c[i - 1];
  return o;
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  uint32_t t[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) t[i] = a.v[i] + b.v[i];
  return carry_par(t);
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  uint32_t t[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) t[i] = a.v[i] + ksub(i) - b.v[i];
  return carry_par(t);
}

// the ten product columns -> carried limbs: one sequential carry 0..9, the
// carry out of limb 9 folded into limb 0 times 19, one more carry 0 -> 1
__device__ __forceinline__ Fe fe_carry(uint64_t h[NL]) {
  uint64_t c;
#pragma unroll
  for (int i = 0; i < NL - 1; ++i) {
    c = h[i] >> width(i);
    h[i] &= lmask(i);
    h[i + 1] += c;
  }
  c = h[9] >> 25;
  h[9] &= M25;
  h[0] += 19u * c;
  c = h[0] >> 26;
  h[0] &= M26;
  h[1] += c;
  Fe o;
#pragma unroll
  for (int i = 0; i < NL; ++i) o.v[i] = (uint32_t)h[i];
  return o;
}

// a_i b_j W[i][j] into column (i + j) % 10: 2 a_i for odd i and j, 19 b_j
// where i + j >= 10, formed in 32 bits (fe.W)
__device__ __forceinline__ void mul_cols(const Fe& a, const Fe& b, uint64_t h[NL]) {
  uint32_t b19[NL], a2[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    b19[i] = 19u * b.v[i];
    a2[i] = a.v[i] << 1;
  }
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const uint32_t ai = ((i & 1) && (j & 1)) ? a2[i] : a.v[i];
      const uint32_t bj = (i + j >= NL) ? b19[j] : b.v[j];
      h[(i + j) % NL] += (uint64_t)ai * bj;
    }
  }
}

// a_i a_j for i <= j, the factors split as ed25519_cuda.sq_split: the
// left operand a_i or 2 a_i, the right a_j, 2 a_j, 19 a_j or 38 a_j (38 on
// odd limbs only); every column equals mul_cols(a, a)'s
__device__ __forceinline__ void sq_cols(const Fe& a, uint64_t h[NL]) {
  uint32_t a2[NL], a19[NL], a38[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    a2[i] = a.v[i] << 1;
    a19[i] = 19u * a.v[i];
    a38[i] = a19[i] << 1;
  }
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = i; j < NL; ++j) {
      const bool wrap = i + j >= NL, odd2 = (i & 1) && (j & 1);
      uint32_t l, r;
      if (i == j) {
        l = (i & 1) ? a2[i] : a.v[i];
        r = wrap ? a19[j] : a.v[j];
      } else {
        l = a2[i];
        r = wrap ? (odd2 ? a38[j] : a19[j]) : (odd2 ? a2[j] : a.v[j]);
      }
      h[(i + j) % NL] += (uint64_t)l * r;
    }
  }
}

// The products are out of line: one copy of each body keeps the kernel's
// code small; the operands travel in registers, by value.
__device__ __noinline__ Fe fe_mul(Fe a, Fe b) {
  uint64_t h[NL] = {};
  mul_cols(a, b, h);
  return fe_carry(h);
}

__device__ __noinline__ Fe fe_sq(Fe a) {
  uint64_t h[NL] = {};
  sq_cols(a, h);
  return fe_carry(h);
}

__device__ __forceinline__ void seq_carry(uint32_t x[NL], bool fold) {
#pragma unroll
  for (int i = 0; i < NL - 1; ++i) {
    const uint32_t c = x[i] >> width(i);
    x[i] &= lmask(i);
    x[i + 1] += c;
  }
  if (fold) {
    const uint32_t c = x[9] >> 25;
    x[9] &= M25;
    x[0] += 19u * c;
  }
}

// carried -> exact-width limbs of the value mod p (fe.canonical)
__device__ Fe fe_canonical(const Fe& a) {
  Fe x = a;
  for (int r = 0; r < 3; ++r) seq_carry(x.v, true);
  Fe t = x;
  t.v[0] += 19u;
  seq_carry(t.v, false);
  const bool ge = (t.v[9] >> 25) != 0;
  t.v[9] &= M25;
  return ge ? t : x;
}

}  // namespace
