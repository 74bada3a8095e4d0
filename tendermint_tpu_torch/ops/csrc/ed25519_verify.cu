// K5: the Ed25519 bit-serial ladder, R' = [s]B + [h](-A), then Z^-1 and a
// byte-exact compare of R''s canonical encoding with R. One thread a row.
//
// Replaces: tendermint_tpu/ops/ed25519_verify.py::_verify_kernel (jitted by
// _compiled_kernel; the JAX package's XLA route, which every sharded
// dispatch of its verifier runs).
//
// What it computes, row r (the plain version is ed25519_verify.verify_ref):
// 253 steps from bit 252 of s and h down to bit 0, each a doubling, then an
// addition of B where s has the bit, then an addition of -A where h has it,
// with the complete extended formulas (add-2008-hwcd-3 with 2d,
// dbl-2008-hwcd); then Z^-1 (ref10's chain), canonical x and y, and accept
// iff y's limbs equal R's raw limbs (the low 255 bits of R, unreduced, so a
// non-canonical R is rejected) and x's parity equals R's sign bit.
//
// What bounds it on the H100: integer instructions. A row does 253
// doublings (4 multiplications and 4 squarings each), one addition (9
// multiplications) for each set bit of s and of h (about 253 for random
// scalars), then 14 multiplications and 254 squarings: about 3,303
// multiplications of 100 products of 32x32 -> 64 bits (IMAD.WIDE) and 1,266
// squarings of 55, some 400k products a row against K2's 282k
// (ed25519_verify.k5_fe_ops counts a batch's). It reads 192 bytes a row and
// writes 4.
//
// What the design does about it: nothing yet; this is the simple kernel the
// JAX package's XLA route becomes. One thread runs a row's whole ladder,
// with the field of ed25519_field.cuh (the 100-product multiply and the
// 55-product squaring, out of line), B and 2d in constant memory, and a
// branch where the reference selects (the verdict is the same). Scalar bits
// are read from global memory at each step.
//
// Every product is the same integer as in the plain version over fe.py, so
// every intermediate is; the overflow bounds are certified by fe.certify().

#include <cstdint>
#include <cuda_runtime.h>

#include "ed25519_field.cuh"

namespace {

constexpr int NBITS = 253;  // s, h < 2^253
constexpr int THREADS = 128;

// B's extended coordinates (Z = 1) and 2d, as fe.int_to_limbs gives them
// (ed25519_verify.B_LIMBS, D2_LIMBS; a CPU test reads them from this file)
__constant__ uint32_t BX[NL] = {0x325d51a, 0x18b5823, 0xf6592a, 0x104a92d, 0x1a4b31d,
                                0x1d6dc5c, 0x27118fe, 0x7fd814, 0x13cd6e5, 0x85a4db};
__constant__ uint32_t BY[NL] = {0x2666658, 0x1999999, 0xcccccc, 0x1333333, 0x1999999,
                                0x666666, 0x3333333, 0xcccccc, 0x2666666, 0x1999999};
__constant__ uint32_t BT[NL] = {0x1b7dda3, 0x1a2ace9, 0x25eadbb, 0x3ba8a, 0x83c27e,
                                0xabe37d, 0x1274732, 0xccacdd, 0xfd78b7, 0x19e1d7c};
__constant__ uint32_t D2C[NL] = {0x2b2f159, 0x1a6e509, 0x22add7a, 0xd4141d, 0x38052,
                                 0xf3d130, 0x3407977, 0x19ce331, 0x1c56dff, 0x901b67};

struct Ext {  // extended (X:Y:Z:T)
  Fe X, Y, Z, T;
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

// z^(p-2), ref10's chain (fe.inv)
__device__ Fe fe_inv(const Fe& z) {
  Fe t0 = fe_sq(z);
  Fe t1 = fe_mul(z, fe_sqn(t0, 2));
  t0 = fe_mul(t0, t1);
  t1 = fe_mul(t1, fe_sq(t0));
  t1 = fe_mul(fe_sqn(t1, 5), t1);
  Fe t2 = fe_mul(fe_sqn(t1, 10), t1);
  t2 = fe_mul(fe_sqn(t2, 20), t2);
  t1 = fe_mul(fe_sqn(t2, 10), t1);
  t2 = fe_mul(fe_sqn(t1, 50), t1);
  t2 = fe_mul(fe_sqn(t2, 100), t2);
  t1 = fe_mul(fe_sqn(t2, 50), t1);
  return fe_mul(fe_sqn(t1, 5), t0);
}

// add-2008-hwcd-3 (ed25519_cuda._pt_add): complete for a = -1
__device__ Ext pt_add(const Ext& p, const Ext& q, const Fe& d2) {
  const Fe A = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
  const Fe B = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
  const Fe C = fe_mul(fe_mul(p.T, d2), q.T);
  const Fe D = fe_mul(fe_add(p.Z, p.Z), q.Z);
  const Fe E = fe_sub(B, A), F = fe_sub(D, C), G = fe_add(D, C), H = fe_add(B, A);
  Ext r;
  r.X = fe_mul(E, F);
  r.Y = fe_mul(G, H);
  r.Z = fe_mul(F, G);
  r.T = fe_mul(E, H);
  return r;
}

// dbl-2008-hwcd (ed25519_cuda._pt_double)
__device__ Ext pt_double(const Ext& p) {
  const Fe A = fe_sq(p.X), B = fe_sq(p.Y), ZZ = fe_sq(p.Z);
  const Fe C = fe_add(ZZ, ZZ), H = fe_add(A, B);
  const Fe E = fe_sub(H, fe_sq(fe_add(p.X, p.Y)));
  const Fe G = fe_sub(A, B), F = fe_add(C, G);
  Ext r;
  r.X = fe_mul(E, F);
  r.Y = fe_mul(G, H);
  r.Z = fe_mul(F, G);
  r.T = fe_mul(E, H);
  return r;
}

__device__ __forceinline__ Fe load_fe(const uint32_t* src, int r, int b) {
  Fe o;
#pragma unroll
  for (int i = 0; i < NL; ++i) o.v[i] = src[i * b + r];
  return o;
}

__global__ void __launch_bounds__(THREADS)
verify_kernel(const uint32_t* __restrict__ negax, const uint32_t* __restrict__ ay,
              const uint32_t* __restrict__ sw, const uint32_t* __restrict__ hw,
              const uint32_t* __restrict__ rlimb, const uint32_t* __restrict__ rsign,
              uint32_t* __restrict__ ok, int b) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= b) return;
  const Fe one = fe_small(1), zero = fe_small(0), d2 = fe_const(D2C);
  Ext na;
  na.X = load_fe(negax, r, b);
  na.Y = load_fe(ay, r, b);
  na.Z = one;
  na.T = fe_mul(na.X, na.Y);
  Ext bp;
  bp.X = fe_const(BX);
  bp.Y = fe_const(BY);
  bp.Z = one;
  bp.T = fe_const(BT);
  Ext acc;
  acc.X = zero;
  acc.Y = one;
  acc.Z = one;
  acc.T = zero;
#pragma unroll 1
  for (int i = NBITS - 1; i >= 0; --i) {
    const int w = (i >> 5) * b + r, sh = i & 31;
    acc = pt_double(acc);
    if ((sw[w] >> sh) & 1u) acc = pt_add(acc, bp, d2);
    if ((hw[w] >> sh) & 1u) acc = pt_add(acc, na, d2);
  }
  const Fe zinv = fe_inv(acc.Z);
  const Fe x = fe_canonical(fe_mul(acc.X, zinv));
  const Fe y = fe_canonical(fe_mul(acc.Y, zinv));
  bool good = (x.v[0] & 1u) == rsign[r];
#pragma unroll
  for (int i = 0; i < NL; ++i) good = good && (y.v[i] == rlimb[i * b + r]);
  ok[r] = good ? 1u : 0u;
}

}  // namespace

// One thread a row, THREADS rows a block; the geometry comes from the
// caller (ed25519_verify.k5_geometry) and must be the one this build serves.
extern "C" int ed25519_verify_launch(const void* negax, const void* ay, const void* sw,
                                     const void* hw, const void* rlimb, const void* rsign,
                                     void* ok, int b, int threads, int blocks,
                                     void* stream) {
  if (b <= 0 || threads != THREADS || blocks != (b + THREADS - 1) / THREADS)
    return (int)cudaErrorInvalidValue;
  verify_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)negax, (const uint32_t*)ay, (const uint32_t*)sw,
      (const uint32_t*)hw, (const uint32_t*)rlimb, (const uint32_t*)rsign,
      (uint32_t*)ok, b);
  return (int)cudaGetLastError();
}
