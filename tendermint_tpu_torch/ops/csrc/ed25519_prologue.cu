// K1: the Ed25519 verify prologue, one thread a signature row.
// SHA-512(R || A || M) -> exact reduction mod L -> 64 MSB-first 4-bit digits
// of h and of s, plus R's raw y limbs (radix 2^25.5, sign bit dropped) and
// R's sign bit.
//
// Replaces: tendermint_tpu/ops/ed25519_pallas.py::_prologue_kernel (launched
// by _prologue_call; math in _sha512_in_kernel, _sha512_rounds,
// _mod_l_device, _limbs_to_words8), together with the device-side assembly
// of the padded SHA-512 input in _device_verify_packed.
//
// What bounds it on the H100: integer instructions on a serial chain. Two
// SHA-512 blocks (a commit precommit) take about 7,400 32-bit adds, logic ops
// and funnel shifts a row (chip_smoke.SHA512_BLOCK_OPS), against about 700
// bytes a row moved and 442 Barrett products. The 160 rounds of a row are
// one dependence chain; up to some 17k rows (one warp on each SM
// sub-partition) a row's time is that of its thread's instruction stream,
// beyond that the integer pipes' rate.
//
// So the design keeps that stream short and free of waits. Each SHA-512
// block's message is staged once in shared memory (msg, [word][row]):
// template words (the same address on every lane), R and A for block 0,
// then the row's varying words scattered in, loaded VCHUNK at once before
// any is used. No global load is left between the first round and the
// last. The schedule runs in a 16-word ring beside the rounds. Barrett mod L
// runs the plain version's columns in radix 2^16 (ed25519_cuda._mod_l16),
// skipping L's zero limbs, and its last carry, borrow and conditional
// subtractions on 32-bit words. The s digits, R's limbs and R's sign, which
// do not depend on the hash, are stored while the digest is reduced.
//
// Splitting a row over two threads in two warps (a hash warp on the rounds
// fed W[t] through shared memory by a schedule warp, which also took half of
// Barrett's columns) was built and measured slower than this at every batch
// size from 1,280 to 163,840 rows (PERF.md, section 6): the schedule warp
// lags the rounds of block 0, and the hand-over and barriers cost what the
// shorter hash stream saves.
//
// SHA-512 runs on native 64-bit words with the round constants in
// __constant__. Outputs are (rows, b) so that neighbouring threads write
// neighbouring words.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LPR = 1;    // threads a row
constexpr int RPB = 64;   // rows (threads) a block: 160 blocks at b = 10,240, so every SM has work
constexpr int SMEM_BYTES = 32 * RPB * 4;  // one SHA-512 block's staged message
constexpr int VCHUNK = 8;  // varying words loaded at once

#ifdef K1_TRACE
// Phase stamps, in a traced build only (tools/k1_trace.py): the clock of
// each block's first row at each K1_STAMP point, and the block's SM.
constexpr int TRACE_POINTS = 8, TRACE_BLOCKS = 8192;
__device__ long long k1_trace[TRACE_POINTS][TRACE_BLOCKS];
#define K1_STAMP(i)                                                  \
  do {                                                               \
    if (lane == 0 && blockIdx.x < TRACE_BLOCKS)                      \
      k1_trace[i][blockIdx.x] = (long long)clock64();                \
  } while (0)
#define K1_START()                                                   \
  do {                                                               \
    unsigned sm_;                                                    \
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm_));                 \
    if (lane == 0 && blockIdx.x < TRACE_BLOCKS)                      \
      k1_trace[TRACE_POINTS - 1][blockIdx.x] = sm_;                  \
    K1_STAMP(0);                                                     \
  } while (0)
#else
#define K1_STAMP(i) \
  do {              \
  } while (0)
#define K1_START() \
  do {             \
  } while (0)
#endif

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

// the limbs of L16 that are not zero; the zero ones are skipped in q3 L
// (tests/test_torch_k1_design.py holds this against the constant)
__host__ __device__ constexpr bool l16_nonzero(int j) { return j < 8 || j == 15; }

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

__device__ __forceinline__ void load_row(const uint32_t* __restrict__ sigw,
                                         const uint32_t* __restrict__ pubw, int rr,
                                         uint32_t sw[16], uint32_t pw[8]) {
  const uint4* s4 = reinterpret_cast<const uint4*>(sigw + (size_t)rr * 16);
  const uint4* p4 = reinterpret_cast<const uint4*>(pubw + (size_t)rr * 8);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint4 v = s4[j];
    sw[4 * j] = v.x; sw[4 * j + 1] = v.y; sw[4 * j + 2] = v.z; sw[4 * j + 3] = v.w;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint4 v = p4[j];
    pw[4 * j] = v.x; pw[4 * j + 1] = v.y; pw[4 * j + 2] = v.z; pw[4 * j + 3] = v.w;
  }
}

// The s digits, R's raw limbs and R's sign of row r: they do not depend on
// the hash.
__device__ __forceinline__ void store_s_outputs(const uint32_t sw[16], int r, int b,
                                                uint32_t* __restrict__ digs,
                                                uint32_t* __restrict__ rlimb,
                                                uint32_t* __restrict__ rsign) {
#pragma unroll
  for (int t = 0; t < 64; ++t) {  // MSB-first: window t holds nibble 63 - t
    const int nib = 63 - t;
    digs[(size_t)t * b + r] = (sw[8 + (nib >> 3)] >> (4 * (nib & 7))) & 15u;
  }
#pragma unroll
  for (int i = 0; i < 10; ++i) rlimb[(size_t)i * b + r] = raw_limb(sw, i);
  rsign[r] = sw[7] >> 31;
}

// Stage the 32 message words of SHA-512 block blk of the thread's row in
// msg ([word][RPB]) and return its 16 64-bit words: template words, R and
// A in block 0, then each of the row's varying words that falls in the
// block, in vidx order (mirrored by tests/test_torch_k1_design.py).
__device__ __forceinline__ void stage_message(
    int blk, int lane, int rr, const uint32_t* __restrict__ tmpl,
    const int32_t* __restrict__ vidx, int k, const uint32_t* __restrict__ vwords,
    const uint32_t sw[16], const uint32_t pw[8], uint32_t* msg, uint64_t W[16]) {
  const int base = blk * 32;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    uint32_t v;
    if (blk == 0 && i < 8) v = bswap32(sw[i]);            // R
    else if (blk == 0 && i < 16) v = bswap32(pw[i - 8]);  // A
    else v = tmpl[base + i];                              // same address on every lane
    msg[i * RPB + lane] = v;
  }
  for (int j0 = 0; j0 < k; j0 += VCHUNK) {
    int w[VCHUNK];
    uint32_t v[VCHUNK];
#pragma unroll
    for (int u = 0; u < VCHUNK; ++u) {  // every load of the chunk before any use
      const bool in = j0 + u < k;
      w[u] = in ? vidx[j0 + u] - base : -1;
      v[u] = in ? vwords[(size_t)rr * k + j0 + u] : 0;
    }
#pragma unroll
    for (int u = 0; u < VCHUNK; ++u)
      if (w[u] >= 0 && w[u] < 32) msg[w[u] * RPB + lane] = v[u];
  }
#pragma unroll
  for (int t = 0; t < 16; ++t)
    W[t] = ((uint64_t)msg[2 * t * RPB + lane] << 32) | msg[(2 * t + 1) * RPB + lane];
}

// schedule word t >= 16, in place in the 16-word ring W
__device__ __forceinline__ uint64_t schedule_word(uint64_t W[16], int t) {
  const uint64_t w15 = W[(t - 15) & 15], w2 = W[(t - 2) & 15];
  const uint64_t s0 = rotr(w15, 1) ^ rotr(w15, 8) ^ (w15 >> 7);
  const uint64_t s1 = rotr(w2, 19) ^ rotr(w2, 61) ^ (w2 >> 6);
  W[t & 15] = W[t & 15] + s0 + W[(t - 7) & 15] + s1;  // s1, on the chain, comes last
  return W[t & 15];
}

// compression round t on schedule word w
__device__ __forceinline__ void sha_round(uint64_t& a, uint64_t& bb, uint64_t& c, uint64_t& d,
                                          uint64_t& e, uint64_t& f, uint64_t& g, uint64_t& h,
                                          int t, uint64_t w) {
  const uint64_t t1 = (h + K512[t] + w) + (rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41)) +
                      ((e & f) ^ (~e & g));
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

// the digest read as a little-endian integer, in 32 limbs of 16 bits
__device__ __forceinline__ void digest_limbs(const uint64_t H[8], uint32_t x[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint64_t le = __byte_perm((uint32_t)(H[j] >> 32), 0, 0x0123) |
                        ((uint64_t)__byte_perm((uint32_t)H[j], 0, 0x0123) << 32);
#pragma unroll
    for (int q = 0; q < 4; ++q) x[4 * j + q] = (uint32_t)(le >> (16 * q)) & 0xFFFF;
  }
}

// Barrett (HAC 14.42), b = 2^16, k = 16: q3 = ((x >> 240) mu) >> 272.
// Column c of q1 mu, q1 = x[15..31].
__device__ __forceinline__ uint64_t mu_col(const uint32_t q1[17], int c) {
  uint64_t s = 0;
#pragma unroll
  for (int i = 0; i < 17; ++i)
    if (c - i >= 0 && c - i < 17) s += (uint64_t)q1[i] * MU16[c - i];
  return s;
}

// column c < 17 of q3 L
__device__ __forceinline__ uint64_t l_col(const uint32_t q3[17], int c) {
  uint64_t s = 0;
#pragma unroll
  for (int j = 0; j <= c; ++j)
    if (l16_nonzero(j)) s += (uint64_t)q3[c - j] * L16[j];
  return s;
}

// r = (x - q3 L) mod 2^272 from q3 L's low 17 columns, in [0, 3L); then
// subtract L while r >= L (twice): r + 2^272 - L carries out of bit 272 iff
// r >= L. The value is the plain version's (ed25519_cuda._mod_l16); the
// carry and borrow chains run on nine 32-bit words (the ninth holds bits
// 256..271), two 16-bit limbs a step, to halve their length.
__device__ __forceinline__ void barrett_finish(const uint32_t x[17], const uint64_t ql[17],
                                               uint32_t r[17]) {
  uint32_t w[9];
  uint64_t cy = 0;
  int64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const uint64_t hi = 2 * j + 1 < 17 ? ql[2 * j + 1] : 0;  // columns < 2^36
    const uint64_t v = ql[2 * j] + (hi << 16) + cy;
    cy = v >> 32;
    const uint32_t xw = x[2 * j] | (2 * j + 1 < 17 ? x[2 * j + 1] << 16 : 0u);
    const int64_t d = (int64_t)xw - (int64_t)(uint32_t)v - borrow;
    borrow = d < 0 ? 1 : 0;
    w[j] = (uint32_t)d;
  }
  w[8] &= 0xFFFF;  // mod 2^272
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    uint32_t t[9];
    uint64_t c1 = 0;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const uint32_t lc = LC16[2 * j] | (2 * j + 1 < 17 ? LC16[2 * j + 1] << 16 : 0u);
      const uint64_t v = (uint64_t)w[j] + lc + c1;
      t[j] = (uint32_t)v;
      c1 = v >> 32;
    }
    if (t[8] >> 16) {  // the carry out of bit 272
#pragma unroll
      for (int j = 0; j < 9; ++j) w[j] = t[j];
      w[8] &= 0xFFFF;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    r[2 * j] = w[j] & 0xFFFF;
    r[2 * j + 1] = w[j] >> 16;
  }
  r[16] = w[8];
}

// MSB-first 4-bit digits of h from its 16-bit limbs: window t holds nibble 63 - t
__device__ __forceinline__ void store_h_digits(const uint32_t h16[16], int r, int b,
                                               uint32_t* __restrict__ digh) {
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    const int nib = 63 - t;
    digh[(size_t)t * b + r] = (h16[nib >> 2] >> (4 * (nib & 3))) & 15u;
  }
}

__global__ void __launch_bounds__(RPB)
prologue_kernel(const uint32_t* __restrict__ tmpl, int rows,
                const int32_t* __restrict__ vidx, int k,
                const uint32_t* __restrict__ vwords,
                const uint32_t* __restrict__ pubw,
                const uint32_t* __restrict__ sigw, uint32_t* __restrict__ digs,
                uint32_t* __restrict__ digh, uint32_t* __restrict__ rlimb,
                uint32_t* __restrict__ rsign, int b) {
  extern __shared__ __align__(16) uint32_t msg[];  // [32][RPB]
  const int lane = threadIdx.x;
  const int r = blockIdx.x * RPB + lane;
  if (r >= b) return;  // rows past b: no thread waits on another
  K1_START();
  uint32_t sw[16], pw[8];
  load_row(sigw, pubw, r, sw, pw);
  uint64_t H[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) H[j] = H0[j];
  const int nblocks = rows / 32;
  for (int blk = 0; blk < nblocks; ++blk) {
    uint64_t W[16];
    stage_message(blk, lane, r, tmpl, vidx, k, vwords, sw, pw, msg, W);
    if (blk == 0) K1_STAMP(1);
    uint64_t a = H[0], bb = H[1], c = H[2], d = H[3];
    uint64_t e = H[4], f = H[5], g = H[6], h = H[7];
#pragma unroll
    for (int t = 0; t < 80; ++t)
      sha_round(a, bb, c, d, e, f, g, h, t, t < 16 ? W[t] : schedule_word(W, t));
    H[0] += a; H[1] += bb; H[2] += c; H[3] += d;
    H[4] += e; H[5] += f; H[6] += g; H[7] += h;
    if (blk == 0) K1_STAMP(2);
  }
  K1_STAMP(3);
  store_s_outputs(sw, r, b, digs, rlimb, rsign);
  uint32_t x[32];
  digest_limbs(H, x);
  uint64_t cy = 0;
  uint32_t q3[17];
#pragma unroll
  for (int c = 0; c < 34; ++c) {
    const uint64_t v = mu_col(x + 15, c) + cy;
    if (c >= 17) q3[c - 17] = (uint32_t)v & 0xFFFF;
    cy = v >> 16;
  }
  K1_STAMP(4);
  uint64_t ql[17];
#pragma unroll
  for (int c = 0; c < 17; ++c) ql[c] = l_col(q3, c);
  uint32_t r16[17];
  barrett_finish(x, ql, r16);
  K1_STAMP(5);
  store_h_digits(r16, r, b, digh);
  K1_STAMP(6);
}

}  // namespace

// The geometry comes from the caller (ed25519_cuda.k1_geometry) and must be
// the one this build serves.
extern "C" int ed25519_prologue_launch(const void* tmpl, int rows, const void* vidx,
                                       int k, const void* vwords, const void* pubw,
                                       const void* sigw, void* digs, void* digh,
                                       void* rlimb, void* rsign, int b, int lanes_per_row,
                                       int rows_per_block, int blocks, int smem_bytes,
                                       void* stream) {
  if (lanes_per_row != LPR || rows_per_block != RPB || smem_bytes != SMEM_BYTES || b <= 0 ||
      rows < 32 || rows % 32 || k <= 0 || (long long)blocks * RPB < b ||
      (long long)(blocks - 1) * RPB >= b || ((uintptr_t)sigw | (uintptr_t)pubw) % 16)
    return (int)cudaErrorInvalidValue;
  prologue_kernel<<<blocks, RPB, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const uint32_t*)tmpl, rows, (const int32_t*)vidx, k,
      (const uint32_t*)vwords, (const uint32_t*)pubw, (const uint32_t*)sigw,
      (uint32_t*)digs, (uint32_t*)digh, (uint32_t*)rlimb, (uint32_t*)rsign, b);
  return (int)cudaGetLastError();
}

#ifdef K1_TRACE
extern "C" int k1_trace_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, k1_trace, sizeof(k1_trace));
}
#endif
