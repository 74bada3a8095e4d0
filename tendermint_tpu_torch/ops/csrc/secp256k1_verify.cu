// K6: the secp256k1 ECDSA bit-serial ladder, R = u1 G + u2 Q, then Z^-1 and
// the check x(R) in {r, r + n}. One thread a row.
//
// Replaces: tendermint_tpu/ops/secp256k1_verify.py::_verify_kernel (jitted by
// _compiled_kernel; the JAX package's XLA route, which every sharded
// dispatch of its verifier runs).
//
// What it computes, row r (the plain version is secp256k1_verify.verify_ref):
// 256 steps from bit 255 of u1 and u2 down to bit 0, each a doubling by the
// complete addition of the point to itself, then an addition of G where u1
// has the bit, then an addition of Q where u2 has it, all by
// Renes-Costello-Batina 2016 algorithm 7 (complete, a = 0, b3 = 21); then
// accept iff Z != 0 and the canonical affine x (X Z^-1, libsecp256k1's
// inversion chain) equals r, or r + n where r + n < p (rn_ok).
//
// What bounds it on the H100: integer instructions. A row does 256
// doublings and one addition for each set bit of u1 and of u2 (about 256),
// each 12 multiplications and 2 by b3, then 16 multiplications and 255
// squarings: about 6,160 multiplications of 100 products of 32x32 -> 64
// bits (IMAD.WIDE) and 255 squarings of 55, some 630k products a row
// against K3's 359k (secp256k1_verify.k6_fe_ops counts a batch's). It reads
// 228 bytes a row and writes 4.
//
// What the design does about it: nothing yet; this is the simple kernel the
// JAX package's XLA route becomes. One thread runs a row's whole ladder,
// with the field of secp256k1_field.cuh (shared with K3: the 100-product
// multiply and the 55-product squaring, out of line), G in constant
// memory, and a branch where the reference selects (the verdict is the
// same). Scalar bits are read from global memory at each step.
//
// Every product is the same integer as in the plain version over
// fe_secp256k1.py, so every intermediate is; the overflow bounds are
// certified by fe_secp256k1.certify().

#include <cstdint>
#include <cuda_runtime.h>

#include "secp256k1_field.cuh"

namespace {

constexpr int NBITS = 256;
constexpr int THREADS = 128;

// G's affine coordinates, as fe_secp256k1.int_to_limbs gives them
// (secp256k1_verify.G_LIMBS; a CPU test reads them from this file)
__constant__ uint32_t GX[NL] = {0x2f81798, 0xa056c5, 0x28d959f, 0x36cb738, 0x3029bfc,
                                0x3a1c2c1, 0x206295c, 0x2eeb156, 0x27ef9dc, 0x1e6f99};
__constant__ uint32_t GY[NL] = {0x310d4b8, 0x1f423fe, 0x14199c4, 0x1229a15, 0xfd17b4,
                                0x384422a, 0x24fbfc0, 0x3119576, 0x27726a3, 0x120eb6};

struct Pt {  // projective (X:Y:Z)
  Fe X, Y, Z;
};

__device__ __forceinline__ Fe fe_const(const uint32_t* c) {
  Fe o;
#pragma unroll
  for (int i = 0; i < NL; ++i) o.v[i] = c[i];
  return o;
}

__device__ __forceinline__ Fe fe_small(uint32_t x) {
  Fe o;
  o.v[0] = x;
#pragma unroll
  for (int i = 1; i < NL; ++i) o.v[i] = 0;
  return o;
}

__device__ Fe fe_sqn(Fe a, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) a = fe_sq(a);
  return a;
}

// z^(p-2), libsecp256k1's chain: 255 squarings, 15 multiplications
// (secp256k1_verify.fe_inv)
__device__ Fe fe_inv(const Fe& x) {
  const Fe x2 = fe_mul(fe_sq(x), x);
  const Fe x3 = fe_mul(fe_sq(x2), x);
  const Fe x6 = fe_mul(fe_sqn(x3, 3), x3);
  const Fe x9 = fe_mul(fe_sqn(x6, 3), x3);
  const Fe x11 = fe_mul(fe_sqn(x9, 2), x2);
  const Fe x22 = fe_mul(fe_sqn(x11, 11), x11);
  const Fe x44 = fe_mul(fe_sqn(x22, 22), x22);
  const Fe x88 = fe_mul(fe_sqn(x44, 44), x44);
  const Fe x176 = fe_mul(fe_sqn(x88, 88), x88);
  const Fe x220 = fe_mul(fe_sqn(x176, 44), x44);
  const Fe x223 = fe_mul(fe_sqn(x220, 3), x3);
  Fe t = fe_mul(fe_sqn(x223, 23), x22);
  t = fe_mul(fe_sqn(t, 5), x);
  t = fe_mul(fe_sqn(t, 3), x2);
  return fe_mul(fe_sqn(t, 2), x);
}

// RCB16 algorithm 7 (secp256k1_cuda._pt_add): complete addition, a = 0
__device__ Pt pt_add(const Pt& p, const Pt& q) {
  const Fe t0 = fe_mul(p.X, q.X), t1 = fe_mul(p.Y, q.Y), t2 = fe_mul(p.Z, q.Z);
  const Fe t3 = fe_sub(fe_mul(fe_add(p.X, p.Y), fe_add(q.X, q.Y)), fe_add(t0, t1));
  const Fe t4 = fe_sub(fe_mul(fe_add(p.Y, p.Z), fe_add(q.Y, q.Z)), fe_add(t1, t2));
  const Fe x3 = fe_mul(fe_add(p.X, p.Z), fe_add(q.X, q.Z));
  const Fe y3 = fe_sub(x3, fe_add(t0, t2));
  const Fe t0x3 = fe_add(fe_add(t0, t0), t0);
  const Fe t2b = fe_mul_b3(t2);
  const Fe z3 = fe_add(t1, t2b);
  const Fe t1m = fe_sub(t1, t2b);
  const Fe y3b = fe_mul_b3(y3);
  Pt r;
  r.X = fe_sub(fe_mul(t3, t1m), fe_mul(t4, y3b));
  r.Y = fe_add(fe_mul(y3b, t0x3), fe_mul(t1m, z3));
  r.Z = fe_add(fe_mul(z3, t4), fe_mul(t0x3, t3));
  return r;
}

__device__ __forceinline__ Fe load_fe(const uint32_t* src, int r, int b) {
  Fe o;
#pragma unroll
  for (int i = 0; i < NL; ++i) o.v[i] = src[i * b + r];
  return o;
}

__device__ __forceinline__ bool fe_eq(const Fe& a, const Fe& c) {
  bool e = true;
#pragma unroll
  for (int i = 0; i < NL; ++i) e = e && (a.v[i] == c.v[i]);
  return e;
}

__global__ void __launch_bounds__(THREADS)
verify_kernel(const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
              const uint32_t* __restrict__ u1w, const uint32_t* __restrict__ u2w,
              const uint32_t* __restrict__ rl, const uint32_t* __restrict__ rnl,
              const uint32_t* __restrict__ rnok, uint32_t* __restrict__ ok, int b) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= b) return;
  const Fe one = fe_small(1), zero = fe_small(0);
  Pt q;
  q.X = load_fe(qx, r, b);
  q.Y = load_fe(qy, r, b);
  q.Z = one;
  Pt g;
  g.X = fe_const(GX);
  g.Y = fe_const(GY);
  g.Z = one;
  Pt acc;
  acc.X = zero;
  acc.Y = one;
  acc.Z = zero;
#pragma unroll 1
  for (int i = NBITS - 1; i >= 0; --i) {
    const int w = (i >> 5) * b + r, sh = i & 31;
    acc = pt_add(acc, acc);
    if ((u1w[w] >> sh) & 1u) acc = pt_add(acc, g);
    if ((u2w[w] >> sh) & 1u) acc = pt_add(acc, q);
  }
  const bool nonzero = !fe_is_zero(acc.Z);
  const Fe x = fe_canonical(fe_mul(acc.X, fe_inv(acc.Z)));
  const bool eq_r = fe_eq(x, load_fe(rl, r, b));
  const bool eq_rn = fe_eq(x, load_fe(rnl, r, b)) && rnok[r] != 0;
  ok[r] = (nonzero && (eq_r || eq_rn)) ? 1u : 0u;
}

}  // namespace

// One thread a row, THREADS rows a block; the geometry comes from the
// caller (secp256k1_verify.k6_geometry) and must be the one this build
// serves.
extern "C" int secp256k1_verify_launch(const void* qx, const void* qy, const void* u1w,
                                       const void* u2w, const void* rl, const void* rnl,
                                       const void* rnok, void* ok, int b, int threads,
                                       int blocks, void* stream) {
  if (b <= 0 || threads != THREADS || blocks != (b + THREADS - 1) / THREADS)
    return (int)cudaErrorInvalidValue;
  verify_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)qx, (const uint32_t*)qy, (const uint32_t*)u1w,
      (const uint32_t*)u2w, (const uint32_t*)rl, (const uint32_t*)rnl,
      (const uint32_t*)rnok, (uint32_t*)ok, b);
  return (int)cudaGetLastError();
}
