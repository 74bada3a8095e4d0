// The secp256k1 double-scalar ladder that K3 (secp256k1_ladder.cu) and K6
// (secp256k1_verify.cu) share: R = u1 G + u2 Q over 64 MSB-first 4-bit
// windows, two lanes a row and 16 rows a one-warp block, the per-row table
// [0..15]Q in dynamic shared memory behind the constant [0..15]G, then the
// inversion-free check X = r Z or X = (r + n) Z with Z != 0.
// secp256k1_ladder.cu describes the design. The two kernels differ only in
// where a window's digits come from and in what the epilogue writes (Digits
// below). ops/_build.py hashes this header into the library name of every
// source that includes it, so an edit here rebuilds both kernels.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "secp256k1_field.cuh"

namespace {

constexpr int NWIN = 64;                 // 4-bit windows over 256 bits
constexpr int PTW = 3 * NL;              // words of a projective point
constexpr int NCONSTS = 16 * PTW;        // [0..15]G: X, Y, Z limbs per entry
constexpr int LPR = 2;                   // lanes that serve one row
constexpr int RPB = 16;                  // rows a block serves
constexpr int THREADS = LPR * RPB;
constexpr int TABLE_WORDS = 16 * PTW * RPB;  // [0..15]Q of the block's rows
constexpr int SMEM_BYTES = (NCONSTS + TABLE_WORDS) * 4;
// blocks an SM can hold by shared memory (228 KB, 1 KB reserved a block);
// the register budget is set so that as many fit
constexpr int MIN_BLOCKS = 233472 / (SMEM_BYTES + 1024);
constexpr unsigned FULL = 0xffffffffu;
static_assert(LPR == 2, "the exchanges pair two lanes");

struct Pt {  // projective (X:Y:Z)
  Fe X, Y, Z;
};

struct Fe2 {
  Fe x, y;
};

// two independent products in one body, so that their multiplies interleave
__device__ __noinline__ Fe2 fe_mul2(Fe a0, Fe b0, Fe a1, Fe b1) {
  uint64_t c0[2 * NL], c1[2 * NL];
#pragma unroll
  for (int k = 0; k < 2 * NL; ++k) c0[k] = c1[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      c0[i + j] += (uint64_t)a0.v[i] * b0.v[j];
      c1[i + j] += (uint64_t)a1.v[i] * b1.v[j];
    }
  }
  Fe2 o;
  o.x = fe_fold(c0);
  o.y = fe_fold(c1);
  return o;
}

// the same value from the row's other lane
__device__ __forceinline__ Fe other(const Fe& a) {
  Fe o;
#pragma unroll
  for (int i = 0; i < NL; ++i) o.v[i] = __shfl_xor_sync(FULL, a.v[i], 1);
  return o;
}

// a + b, or a - b (a + (2p - b)) where neg, carried: the words of fe_add or
// fe_sub, so that the two lanes of a row run one instruction stream
__device__ __forceinline__ Fe fe_add_or_sub(const Fe& a, const Fe& b, bool neg) {
  uint32_t t[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) t[i] = a.v[i] + (neg ? KSUB[i] - b.v[i] : b.v[i]);
  return fe_carried(t);
}

// RCB16 algorithm 7: complete addition, a = 0. Lane 0 | lane 1 of a row
// compute, in round 1, t0 | t2, t1 | m5 and m3 | m4 (m3 = (X1+Y1)(X2+Y2),
// m4 = (Y1+Z1)(Y2+Z2), m5 = (X1+Z1)(X2+Z2)); then t3 | t4 and z3 | t1'; in
// round 2, t3 t1' | t4 y3b, t1' z3 | z3 t4 and t0x3 t3 | y3b t0x3. Each
// exchange trades one value with the other lane.
__device__ __forceinline__ Pt pt_add(const Pt& p, const Pt& r, bool lane1) {
  const Fe a0 = fe_sel(lane1, p.Z, p.X), b0 = fe_sel(lane1, r.Z, r.X);
  const Fe a1 = fe_sel(lane1, fe_add(p.X, p.Z), p.Y);
  const Fe b1 = fe_sel(lane1, fe_add(r.X, r.Z), r.Y);
  const Fe2 m01 = fe_mul2(a0, b0, a1, b1);
  const Fe m2 = fe_mul(fe_add(p.Y, a0), fe_add(r.Y, b0));
  const Fe o0 = other(m01.x), o1 = other(m01.y);
  const Fe t0 = fe_sel(lane1, o0, m01.x), t2 = fe_sel(lane1, m01.x, o0);
  const Fe t1 = fe_sel(lane1, o1, m01.y), m5 = fe_sel(lane1, m01.y, o1);
  const Fe u1 = fe_sub(m2, fe_add(t1, m01.x));  // t3 | t4
  const Fe t2b = fe_mul_b3(t2);
  const Fe u2 = fe_add_or_sub(t1, t2b, lane1);  // z3 | t1'
  const Fe y3b = fe_mul_b3(fe_sub(m5, fe_add(t0, t2)));
  const Fe t0x3 = fe_add(fe_add(t0, t0), t0);
  const Fe ou = other(u2);  // t1' | z3
  const Fe2 n01 = fe_mul2(u1, fe_sel(lane1, y3b, ou), ou, fe_sel(lane1, u1, u2));
  const Fe n2 = fe_mul(t0x3, fe_sel(lane1, y3b, u1));
  // X3 = t3 t1' - t4 y3b, Y3 = y3b t0x3 + t1' z3, Z3 = z3 t4 + t0x3 t3
  Fe sx;
#pragma unroll
  for (int i = 0; i < NL; ++i) sx.v[i] = lane1 ? KSUB[i] - n01.x.v[i] : n01.x.v[i];
  const Fe sy = fe_sel(lane1, n2, n01.y), sz = fe_sel(lane1, n01.y, n2);
  Pt o;
  o.X = fe_add(sx, other(sx));
  o.Y = fe_add(sy, other(sy));
  o.Z = fe_add(sz, other(sz));
  return o;
}

// RCB16 algorithm 9: complete doubling, a = 0. Lane 0 | lane 1 of a row
// compute, in round 1, Y^2 | Z^2 and Y Z | X Y; then z3 = 8 t0 | t0' =
// t0 - 3 t2 by the same three steps; in round 2, t2 z3 | t0' y3 and
// t1 z3 | t0' XY.
__device__ __forceinline__ Pt pt_double(const Pt& p, bool lane1) {
  const Fe s0 = fe_sq(fe_sel(lane1, p.Z, p.Y));                          // Y^2 | Z^2
  const Fe s1 = fe_mul(fe_sel(lane1, p.X, p.Y), fe_sel(lane1, p.Y, p.Z));  // Y Z | X Y
  const Fe o0 = other(s0);
  const Fe t0 = fe_sel(lane1, o0, s0);
  const Fe t2 = fe_mul_b3(fe_sel(lane1, s0, o0));
  const Fe w = fe_sel(lane1, t2, t0);
  const Fe v1 = fe_add(w, w);                                  // 2 t0 | 2 t2
  const Fe v2 = fe_add(v1, fe_sel(lane1, t2, v1));             // 4 t0 | 3 t2
  const Fe v3 = fe_add_or_sub(fe_sel(lane1, t0, v2), v2, lane1);  // z3 | t0'
  const Fe y3 = fe_add(t0, t2);
  const Fe2 n = fe_mul2(v3, fe_sel(lane1, y3, t2), v3, s1);
  // X3 = 2 t0' XY, Y3 = t2 z3 + t0' y3, Z3 = t1 z3
  const Fe o1 = other(n.y);
  const Fe xy = fe_sel(lane1, n.y, o1);
  Pt o;
  o.X = fe_add(xy, xy);
  o.Y = fe_add(n.x, other(n.x));
  o.Z = fe_sel(lane1, o1, n.y);
  return o;
}

__device__ __forceinline__ Fe load_fe(const uint32_t* src, int stride) {
  Fe o;
#pragma unroll
  for (int i = 0; i < NL; ++i) o.v[i] = src[i * stride];
  return o;
}

__device__ __forceinline__ uint32_t pt_word(const Pt& p, int w) {
  return w < NL ? p.X.v[w] : w < 2 * NL ? p.Y.v[w - NL] : p.Z.v[w - 2 * NL];
}

// Where a kernel's window digits come from. kRows (K3): the host's digit
// rows, dig[t * b + r] holding window t's digit. kWords (K6): the scalars'
// bit words, words[k * b + r] holding bits 32 k .. 32 k + 31, window t being
// the 4-bit field at bit 4 (NWIN - 1 - t). kWords writes the verdict alone,
// kRows X and Z too.
enum class Digits { kRows, kWords };

template <Digits D>
__device__ __forceinline__ int window_digit(const uint32_t* __restrict__ src, int t, int r,
                                            int b) {
  if (D == Digits::kRows) return src[t * b + r] & 15u;
  const int u = NWIN - 1 - t;
  return (src[(u >> 3) * b + r] >> ((u & 7) * 4)) & 15u;
}

template <Digits D>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ladder_kernel(const uint32_t* __restrict__ consts, const uint32_t* __restrict__ qx,
              const uint32_t* __restrict__ qy, const uint32_t* __restrict__ dig1,
              const uint32_t* __restrict__ dig2, const uint32_t* __restrict__ rl,
              const uint32_t* __restrict__ rnl, const uint32_t* __restrict__ rnok,
              uint32_t* __restrict__ ok, uint32_t* __restrict__ out_x,
              uint32_t* __restrict__ out_z, int b, int nwin) {
  // smem[w * 16 + j]: word w of [j]G; smem[NCONSTS + (j * PTW + w) * RPB + row]:
  // word w of the block row's [j]Q
  extern __shared__ uint32_t smem[];
  for (int i = threadIdx.x; i < NCONSTS; i += THREADS) smem[(i % PTW) * 16 + i / PTW] = consts[i];
  __syncthreads();
  const int q = threadIdx.x % LPR;
  const int lr = threadIdx.x / LPR;
  const int row = blockIdx.x * RPB + lr;
  const bool live = row < b;
  const int r = live ? row : b - 1;
  uint32_t* tq = smem + NCONSTS + lr;

  Fe zero, one;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    zero.v[i] = 0;
    one.v[i] = i == 0 ? 1u : 0u;
  }
  Pt acc;
  acc.X = zero;
  acc.Y = one;
  acc.Z = zero;
  const Pt ident = acc;
  Pt qp;  // the row's key Q
  qp.X = load_fe(qx + r, b);
  qp.Y = load_fe(qy + r, b);
  qp.Z = one;

  // per-row table [0..15]Q by complete additions through the identity; the
  // row's lanes share the writes
#pragma unroll 1
  for (int j = 0; j < 16; ++j) {
    if (j > 0) acc = pt_add(acc, qp, q != 0);
#pragma unroll
    for (int w = 0; w < PTW; ++w) {
      if (w % LPR == q) tq[(j * PTW + w) * RPB] = pt_word(acc, w);
    }
  }
  __syncwarp();

  acc = ident;
#pragma unroll 1
  for (int t = 0; t < nwin; ++t) {
#pragma unroll 1
    for (int k = 0; k < 4; ++k) acc = pt_double(acc, q != 0);
    const int d1 = window_digit<D>(dig1, t, r, b), d2 = window_digit<D>(dig2, t, r, b);
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const uint32_t* e = h == 0 ? smem + d1 : tq + d2 * PTW * RPB;
      const int stride = h == 0 ? 16 : RPB;
      Pt g;
      g.X = load_fe(e, stride);
      g.Y = load_fe(e + NL * stride, stride);
      g.Z = load_fe(e + 2 * NL * stride, stride);
      acc = pt_add(acc, g, q != 0);
    }
  }

  // x(R) = r (mod n) iff X = r Z or X = (r + n) Z (mod p), Z != 0: lane 0
  // checks r, lane 1 r + n
  const bool eq_mine =
      fe_is_zero(fe_sub(acc.X, fe_mul(load_fe((q == 0 ? rl : rnl) + r, b), acc.Z)));
  const bool eq_other = __shfl_xor_sync(FULL, (int)eq_mine, 1) != 0;
  if (live && q == 0) {
    ok[r] = (!fe_is_zero(acc.Z) && (eq_mine || (eq_other && rnok[r] != 0))) ? 1u : 0u;
    if (D == Digits::kWords) return;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      out_x[i * b + r] = acc.X.v[i];
      out_z[i * b + r] = acc.Z.v[i];
    }
  }
}

// Validates the caller's geometry (secp256k1_cuda.k3_geometry, which
// secp256k1_verify.k6_geometry returns too) against this build's, raises the
// kernel's dynamic shared memory limit once a device and launches it on
// stream; returns 0 or the cudaError. kWords runs NWIN windows.
template <Digits D>
int launch_ladder(const void* consts, const void* qx, const void* qy, const void* dig1,
                  const void* dig2, const void* rl, const void* rnl, const void* rnok, void* ok,
                  void* out_x, void* out_z, int b, int nwin, int lanes_per_row,
                  int rows_per_block, int blocks, int smem_bytes, void* stream) {
  if (lanes_per_row != LPR || rows_per_block != RPB || smem_bytes != SMEM_BYTES || b <= 0 ||
      nwin <= 0 || (D == Digits::kWords && nwin != NWIN) || (long long)blocks * RPB < b ||
      (long long)(blocks - 1) * RPB >= b)
    return (int)cudaErrorInvalidValue;
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(ladder_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  ladder_kernel<D><<<blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const uint32_t*)consts, (const uint32_t*)qx, (const uint32_t*)qy,
      (const uint32_t*)dig1, (const uint32_t*)dig2, (const uint32_t*)rl,
      (const uint32_t*)rnl, (const uint32_t*)rnok, (uint32_t*)ok, (uint32_t*)out_x,
      (uint32_t*)out_z, b, nwin);
  return (int)cudaGetLastError();
}

}  // namespace
