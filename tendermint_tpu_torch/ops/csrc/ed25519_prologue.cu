// K1: the Ed25519 verify prologue, one thread per signature row.
// SHA-512(R || A || M) -> exact reduction mod L -> 64 MSB-first 4-bit digits
// of h and of s, plus R's raw y limbs (radix 2^25.5, sign bit dropped) and
// R's sign bit.
//
// Replaces: tendermint_tpu/ops/ed25519_pallas.py::_prologue_kernel (launched
// by _prologue_call; math in _sha512_in_kernel, _sha512_rounds,
// _mod_l_device, _limbs_to_words8), together with the device-side assembly
// of the padded SHA-512 input in _device_verify_packed.
//
// What bounds it on the H100: integer instructions. Two SHA-512 blocks (a
// commit precommit) take about 7,400 32-bit adds, logic ops and funnel
// shifts a row (chip_smoke.SHA512_BLOCK_OPS), against about 700 bytes a row
// moved (64 B of signature, 32 B of key, the varying message words, 556 B
// of digits and limbs out) and 442 Barrett products. The design keeps the message
// out of device memory: each thread builds its padded input on the fly from
// the template row, the varying-word scatter (vidx, vwords) and its own key
// and signature words, so the (rows, b) message array is never written.
// SHA-512 runs on native 64-bit words (the TPU kernel emulated them in u32
// pairs), with the round constants in __constant__: every lane reads the
// same K[t], which the constant cache broadcasts. The schedule is a 16-word
// ring in registers. h mod L is Barrett in radix 2^16 with 64-bit columns,
// the same schedule as the plain version (ed25519_cuda._mod_l16).
// Outputs are (rows, b) so that neighbouring threads write neighbouring words.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ uint64_t K512[80] = {
    0x428A2F98D728AE22ull, 0x7137449123EF65CDull, 0xB5C0FBCFEC4D3B2Full, 0xE9B5DBA58189DBBCull,
    0x3956C25BF348B538ull, 0x59F111F1B605D019ull, 0x923F82A4AF194F9Bull, 0xAB1C5ED5DA6D8118ull,
    0xD807AA98A3030242ull, 0x12835B0145706FBEull, 0x243185BE4EE4B28Cull, 0x550C7DC3D5FFB4E2ull,
    0x72BE5D74F27B896Full, 0x80DEB1FE3B1696B1ull, 0x9BDC06A725C71235ull, 0xC19BF174CF692694ull,
    0xE49B69C19EF14AD2ull, 0xEFBE4786384F25E3ull, 0x0FC19DC68B8CD5B5ull, 0x240CA1CC77AC9C65ull,
    0x2DE92C6F592B0275ull, 0x4A7484AA6EA6E483ull, 0x5CB0A9DCBD41FBD4ull, 0x76F988DA831153B5ull,
    0x983E5152EE66DFABull, 0xA831C66D2DB43210ull, 0xB00327C898FB213Full, 0xBF597FC7BEEF0EE4ull,
    0xC6E00BF33DA88FC2ull, 0xD5A79147930AA725ull, 0x06CA6351E003826Full, 0x142929670A0E6E70ull,
    0x27B70A8546D22FFCull, 0x2E1B21385C26C926ull, 0x4D2C6DFC5AC42AEDull, 0x53380D139D95B3DFull,
    0x650A73548BAF63DEull, 0x766A0ABB3C77B2A8ull, 0x81C2C92E47EDAEE6ull, 0x92722C851482353Bull,
    0xA2BFE8A14CF10364ull, 0xA81A664BBC423001ull, 0xC24B8B70D0F89791ull, 0xC76C51A30654BE30ull,
    0xD192E819D6EF5218ull, 0xD69906245565A910ull, 0xF40E35855771202Aull, 0x106AA07032BBD1B8ull,
    0x19A4C116B8D2D0C8ull, 0x1E376C085141AB53ull, 0x2748774CDF8EEB99ull, 0x34B0BCB5E19B48A8ull,
    0x391C0CB3C5C95A63ull, 0x4ED8AA4AE3418ACBull, 0x5B9CCA4F7763E373ull, 0x682E6FF3D6B2B8A3ull,
    0x748F82EE5DEFB2FCull, 0x78A5636F43172F60ull, 0x84C87814A1F0AB72ull, 0x8CC702081A6439ECull,
    0x90BEFFFA23631E28ull, 0xA4506CEBDE82BDE9ull, 0xBEF9A3F7B2C67915ull, 0xC67178F2E372532Bull,
    0xCA273ECEEA26619Cull, 0xD186B8C721C0C207ull, 0xEADA7DD6CDE0EB1Eull, 0xF57D4F7FEE6ED178ull,
    0x06F067AA72176FBAull, 0x0A637DC5A2C898A6ull, 0x113F9804BEF90DAEull, 0x1B710B35131C471Bull,
    0x28DB77F523047D84ull, 0x32CAAB7B40C72493ull, 0x3C9EBE0A15C9BEBCull, 0x431D67C49C100D4Cull,
    0x4CC5D4BECB3E42B6ull, 0x597F299CFC657E2Aull, 0x5FCB6FAB3AD6FAECull, 0x6C44198C4A475817ull,
};

__constant__ uint64_t H0[8] = {
    0x6A09E667F3BCC908ull, 0xBB67AE8584CAA73Bull, 0x3C6EF372FE94F82Bull, 0xA54FF53A5F1D36F1ull,
    0x510E527FADE682D1ull, 0x9B05688C2B3E6C1Full, 0x1F83D9ABFB41BD6Bull, 0x5BE0CD19137E2179ull,
};

// Barrett constants in radix 2^16 (ed25519_cuda._MU16, _L16, _LC16):
// floor(2^512 / L), L, and 2^272 - L, 17 limbs each
__constant__ uint32_t MU16[17] = {
    0x131b, 0x0a2c, 0xe5a3, 0xed9c, 0x29a7, 0x0863, 0x215d, 0x2106,
    0xffeb, 0xffff, 0xffff, 0xffff, 0xffff, 0xffff, 0xffff, 0xffff, 0x000f};
__constant__ uint32_t L16[17] = {
    0xd3ed, 0x5cf5, 0x631a, 0x5812, 0x9cd6, 0xa2f7, 0xf9de, 0x14de,
    0x0000, 0x0000, 0x0000, 0x0000, 0x0000, 0x0000, 0x0000, 0x1000, 0x0000};
__constant__ uint32_t LC16[17] = {
    0x2c13, 0xa30a, 0x9ce5, 0xa7ed, 0x6329, 0x5d08, 0x0621, 0xeb21,
    0xffff, 0xffff, 0xffff, 0xffff, 0xffff, 0xffff, 0xffff, 0xefff, 0xffff};

__device__ __forceinline__ uint64_t rotr(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// raw limb i (radix 2^25.5) of the 255-bit value in little-endian words w
__device__ __forceinline__ uint32_t raw_limb(const uint32_t w[8], int i) {
  const int off = (i >> 1) * 51 + (i & 1) * 26;
  const int width = (i & 1) ? 25 : 26;
  const int wi = off >> 5, sh = off & 31;
  uint32_t v = w[wi] >> sh;
  if (sh + width > 32) v |= w[wi + 1] << (32 - sh);
  return v & ((1u << width) - 1);
}

__global__ void __launch_bounds__(128)
prologue_kernel(const uint32_t* __restrict__ tmpl, int rows,
                const int32_t* __restrict__ vidx, int k,
                const uint32_t* __restrict__ vwords,
                const uint32_t* __restrict__ pubw,
                const uint32_t* __restrict__ sigw, uint32_t* __restrict__ digs,
                uint32_t* __restrict__ digh, uint32_t* __restrict__ rlimb,
                uint32_t* __restrict__ rsign, int b) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= b) return;
  uint32_t sw[16], pw[8];
#pragma unroll
  for (int j = 0; j < 16; ++j) sw[j] = sigw[r * 16 + j];
#pragma unroll
  for (int j = 0; j < 8; ++j) pw[j] = pubw[r * 8 + j];

  uint64_t H[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) H[j] = H0[j];

  const int nblocks = rows / 32;
  for (int blk = 0; blk < nblocks; ++blk) {
    uint64_t W[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      uint32_t hw, lw;
      if (blk == 0 && t < 4) {  // R: signature words 0..7, big-endian
        hw = bswap32(sw[2 * t]);
        lw = bswap32(sw[2 * t + 1]);
      } else if (blk == 0 && t < 8) {  // A: key words
        hw = bswap32(pw[2 * t - 8]);
        lw = bswap32(pw[2 * t - 7]);
      } else {  // template, with this row's varying words scattered in
        const int row = blk * 32 + 2 * t;
        hw = tmpl[row];
        lw = tmpl[row + 1];
        for (int j = 0; j < k; ++j) {
          const int vr = vidx[j];
          if (vr == row) hw = vwords[r * k + j];
          if (vr == row + 1) lw = vwords[r * k + j];
        }
      }
      W[t] = ((uint64_t)hw << 32) | lw;
    }
    uint64_t a = H[0], bb = H[1], c = H[2], d = H[3];
    uint64_t e = H[4], f = H[5], g = H[6], h = H[7];
#pragma unroll
    for (int t = 0; t < 80; ++t) {
      if (t >= 16) {
        const uint64_t w15 = W[(t - 15) & 15], w2 = W[(t - 2) & 15];
        const uint64_t s0 = rotr(w15, 1) ^ rotr(w15, 8) ^ (w15 >> 7);
        const uint64_t s1 = rotr(w2, 19) ^ rotr(w2, 61) ^ (w2 >> 6);
        W[t & 15] += s0 + W[(t - 7) & 15] + s1;
      }
      const uint64_t S1 = rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41);
      const uint64_t ch = (e & f) ^ (~e & g);
      const uint64_t t1 = h + S1 + ch + K512[t] + W[t & 15];
      const uint64_t S0 = rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39);
      const uint64_t maj = (a & bb) ^ (a & c) ^ (bb & c);
      h = g;
      g = f;
      f = e;
      e = d + t1;
      d = c;
      c = bb;
      bb = a;
      a = t1 + S0 + maj;
    }
    H[0] += a; H[1] += bb; H[2] += c; H[3] += d;
    H[4] += e; H[5] += f; H[6] += g; H[7] += h;
  }

  // the digest read as a little-endian integer, in 32 limbs of 16 bits
  uint32_t x[32];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint64_t le = __byte_perm((uint32_t)(H[j] >> 32), 0, 0x0123) |
                        ((uint64_t)__byte_perm((uint32_t)H[j], 0, 0x0123) << 32);
#pragma unroll
    for (int q = 0; q < 4; ++q) x[4 * j + q] = (uint32_t)(le >> (16 * q)) & 0xFFFF;
  }

  // Barrett (HAC 14.42), b = 2^16, k = 16: q3 = ((x >> 240) * mu) >> 272
  uint64_t acc[34];
#pragma unroll
  for (int i = 0; i < 34; ++i) acc[i] = 0;
#pragma unroll
  for (int j = 0; j < 17; ++j)
#pragma unroll
    for (int i = 0; i < 17; ++i) acc[i + j] += (uint64_t)x[15 + i] * MU16[j];
  uint32_t q3[17];
  {
    uint64_t cy = 0;
#pragma unroll
    for (int i = 0; i < 34; ++i) {
      const uint64_t v = acc[i] + cy;
      if (i >= 17) q3[i - 17] = (uint32_t)v & 0xFFFF;
      cy = v >> 16;
    }
  }
  // r = (x - q3 * L) mod 2^272, in [0, 3L)
  uint64_t ql[17];
#pragma unroll
  for (int i = 0; i < 17; ++i) ql[i] = 0;
#pragma unroll
  for (int j = 0; j < 17; ++j)
#pragma unroll
    for (int i = 0; i < 17; ++i)
      if (i + j < 17) ql[i + j] += (uint64_t)q3[i] * L16[j];
  uint32_t rr[17];
  {
    uint64_t cy = 0;
    int64_t borrow = 0;
#pragma unroll
    for (int i = 0; i < 17; ++i) {
      const uint64_t v = ql[i] + cy;
      cy = v >> 16;
      const int64_t dlt = (int64_t)x[i] - (int64_t)(v & 0xFFFF) - borrow;
      borrow = dlt < 0 ? 1 : 0;
      rr[i] = (uint32_t)dlt & 0xFFFF;
    }
  }
  // subtract L while r >= L (twice): t = r + 2^272 - L carries out iff r >= L
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    uint32_t t[17];
    uint32_t cy = 0;
#pragma unroll
    for (int i = 0; i < 17; ++i) {
      const uint32_t v = rr[i] + LC16[i] + cy;
      t[i] = v & 0xFFFF;
      cy = v >> 16;
    }
    if (cy) {
#pragma unroll
      for (int i = 0; i < 17; ++i) rr[i] = t[i];
    }
  }

  // MSB-first 4-bit digits: window t holds nibble 63 - t
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    const int nib = 63 - t;
    digh[t * b + r] = (rr[nib >> 2] >> (4 * (nib & 3))) & 15u;
    digs[t * b + r] = (sw[8 + (nib >> 3)] >> (4 * (nib & 7))) & 15u;
  }
#pragma unroll
  for (int i = 0; i < 10; ++i) rlimb[i * b + r] = raw_limb(sw, i);
  rsign[r] = sw[7] >> 31;
}

}  // namespace

extern "C" int ed25519_prologue_launch(const void* tmpl, int rows, const void* vidx,
                                       int k, const void* vwords, const void* pubw,
                                       const void* sigw, void* digs, void* digh,
                                       void* rlimb, void* rsign, int b,
                                       void* stream) {
  const int threads = 128;
  const int blocks = (b + threads - 1) / threads;
  prologue_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)tmpl, rows, (const int32_t*)vidx, k,
      (const uint32_t*)vwords, (const uint32_t*)pubw, (const uint32_t*)sigw,
      (uint32_t*)digs, (uint32_t*)digh, (uint32_t*)rlimb, (uint32_t*)rsign, b);
  return (int)cudaGetLastError();
}
