// K3: the secp256k1 ECDSA double-scalar ladder, R = u1 G + u2 Q, and the
// inversion-free check of x(R) against r, one thread per signature row, 128
// rows per block.
//
// Replaces: tendermint_tpu/ops/secp256k1_pallas.py::_ladder_kernel (launched
// by _ladder_call; math in ladder_math, pt_add and _build_g_table).
//
// What bounds it on the H100: integer multiplies. Each row does 3,254 field
// multiplications, 512 squarings and 542 multiplications by b3 = 21
// (secp256k1_cuda.ladder_fe_ops): about 359k products of 32x32 -> 64 bits
// (IMAD.WIDE) at 100 a multiplication, 55 a squaring and 10 a small
// multiplication; this kernel squares with the full 100-product multiply
// (382k a row). It reads and writes under 900 bytes a row. The field is ten
// 26-bit limbs (libsecp256k1's field_10x26, ops/fe_secp256k1.py) with 64-bit
// column sums, instead of the TPU's twenty 13-bit limbs; the product's high
// columns are carried down to limb width and then folded by
// 2^260 = 0x1000003D10 (mod p) in two parts, 0x3D10 at the same limb and
// 0x400 one limb up, so no 64-bit column is ever multiplied by the 2^36-size
// fold constant. Additions are Renes-Costello-Batina 2016 algorithm 7
// (complete, a = 0); doublings its algorithm 9. The per-row table [0..15]Q
// (1.9 KB) lives in thread-local memory; the constant table [0..15]G lives
// in shared memory, loaded once per block (lanes of a warp pick different
// digits, and divergent __constant__ reads would serialise). Digits pick
// table entries by direct indexing: keys and digits are public, so the
// TPU's 16-way masked select is not needed. The check X = r Z or
// X = (r + n) Z needs no inversion.
//
// Same schedule as the plain version (secp256k1_cuda.ladder_point_ref,
// ladder_ref over fe_secp256k1.py), so every intermediate is the same
// integer; the overflow bounds are certified by fe_secp256k1.certify().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NL = 10;
constexpr int NCONSTS = 16 * 3 * NL;  // [0..15]G: X, Y, Z limbs per entry
constexpr uint32_t M26 = (1u << 26) - 1;
constexpr uint32_t M22 = (1u << 22) - 1;
constexpr uint32_t TOP_LO = 0x3D1, TOP_HI = 0x40;  // 2^256 mod p
constexpr uint64_t FOLD_LO = 0x3D10, FOLD_HI = 0x400;  // 2^260 mod p
constexpr uint64_t FOLD19_LO = 0xF44000, FOLD19_HI = 0x100000;  // 0x400 * 2^260
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

struct Pt {  // projective (X:Y:Z)
  Fe X, Y, Z;
};

// one parallel carry pass; the carry out of limb 9 weighs 2^256
template <typename T>
__device__ __forceinline__ void carry_par(const T t[NL], T o[NL]) {
  T c[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) c[i] = t[i] >> width(i);
  o[0] = (t[0] & M26) + TOP_LO * c[9];
  o[1] = (t[1] & M26) + c[0] + TOP_HI * c[9];
#pragma unroll
  for (int i = 2; i < NL; ++i) o[i] = (t[i] & lmask(i)) + c[i - 1];
}

__device__ __forceinline__ Fe fe_carried(const uint32_t t[NL]) {
  Fe o;
  carry_par<uint32_t>(t, o.v);
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

// Out of line: one copy of the 100-product body keeps the kernel small;
// the operands travel by value.
__device__ __noinline__ Fe fe_mul(Fe a, Fe b) {
  uint64_t c[2 * NL];
#pragma unroll
  for (int k = 0; k < 2 * NL; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < NL; ++j) c[i + j] += (uint64_t)a.v[i] * b.v[j];
  }
  // one parallel 26-bit pass over the 20 columns: every column to limb width
  uint64_t d[2 * NL];
  d[0] = c[0] & M26;
#pragma unroll
  for (int k = 1; k < 2 * NL; ++k) d[k] = (c[k] & M26) + (c[k - 1] >> 26);
  // fold column k >= 10: 0x3D10 at k - 10, 0x400 at k - 9
  uint64_t r[NL], o[NL];
  r[0] = d[0] + FOLD_LO * d[10] + FOLD19_LO * d[19];
  r[1] = d[1] + FOLD_LO * d[11] + FOLD_HI * d[10] + FOLD19_HI * d[19];
#pragma unroll
  for (int k = 2; k < NL; ++k) r[k] = d[k] + FOLD_LO * d[k + 10] + FOLD_HI * d[k + 9];
  carry_par<uint64_t>(r, o);
  carry_par<uint64_t>(o, r);
  Fe out;
#pragma unroll
  for (int i = 0; i < NL; ++i) out.v[i] = (uint32_t)r[i];
  return out;
}

__device__ __forceinline__ Fe fe_sq(const Fe& a) { return fe_mul(a, a); }

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

// RCB16 algorithm 7: complete addition, a = 0
__device__ Pt pt_add(const Pt& p, const Pt& q) {
  const Fe t0 = fe_mul(p.X, q.X);
  Fe t1 = fe_mul(p.Y, q.Y);
  const Fe t2 = fe_mul(p.Z, q.Z);
  const Fe t3 = fe_sub(fe_mul(fe_add(p.X, p.Y), fe_add(q.X, q.Y)), fe_add(t0, t1));
  const Fe t4 = fe_sub(fe_mul(fe_add(p.Y, p.Z), fe_add(q.Y, q.Z)), fe_add(t1, t2));
  const Fe x3 = fe_mul(fe_add(p.X, p.Z), fe_add(q.X, q.Z));
  const Fe y3 = fe_sub(x3, fe_add(t0, t2));
  const Fe t0x3 = fe_add(fe_add(t0, t0), t0);
  const Fe t2b = fe_mul_b3(t2);
  const Fe z3 = fe_add(t1, t2b);
  t1 = fe_sub(t1, t2b);
  const Fe y3b = fe_mul_b3(y3);
  Pt o;
  o.X = fe_sub(fe_mul(t3, t1), fe_mul(t4, y3b));
  o.Y = fe_add(fe_mul(y3b, t0x3), fe_mul(t1, z3));
  o.Z = fe_add(fe_mul(z3, t4), fe_mul(t0x3, t3));
  return o;
}

// RCB16 algorithm 9: complete doubling, a = 0
__device__ Pt pt_double(const Pt& p) {
  Fe t0 = fe_sq(p.Y);
  Fe z3 = fe_add(t0, t0);
  z3 = fe_add(z3, z3);
  z3 = fe_add(z3, z3);
  const Fe t1 = fe_mul(p.Y, p.Z);
  Fe t2 = fe_mul_b3(fe_sq(p.Z));
  Pt o;
  o.X = fe_mul(t2, z3);
  const Fe y3 = fe_add(t0, t2);
  o.Z = fe_mul(t1, z3);
  t2 = fe_add(fe_add(t2, t2), t2);
  t0 = fe_sub(t0, t2);
  o.Y = fe_add(o.X, fe_mul(t0, y3));
  const Fe x3 = fe_mul(t0, fe_mul(p.X, p.Y));
  o.X = fe_add(x3, x3);
  return o;
}

__device__ __forceinline__ Fe load_fe(const uint32_t* src, int stride) {
  Fe o;
#pragma unroll
  for (int i = 0; i < NL; ++i) o.v[i] = src[i * stride];
  return o;
}

__global__ void __launch_bounds__(128)
ladder_kernel(const uint32_t* __restrict__ consts, const uint32_t* __restrict__ qx,
              const uint32_t* __restrict__ qy, const uint32_t* __restrict__ dig1,
              const uint32_t* __restrict__ dig2, const uint32_t* __restrict__ rl,
              const uint32_t* __restrict__ rnl, const uint32_t* __restrict__ rnok,
              uint32_t* __restrict__ ok, uint32_t* __restrict__ out_x,
              uint32_t* __restrict__ out_z, int b, int nwin) {
  __shared__ uint32_t s_g[NCONSTS];
  for (int i = threadIdx.x; i < NCONSTS; i += blockDim.x) s_g[i] = consts[i];
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= b) return;

  Fe zero, one;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    zero.v[i] = 0;
    one.v[i] = i == 0 ? 1u : 0u;
  }
  Pt ident;
  ident.X = zero;
  ident.Y = one;
  ident.Z = zero;
  Pt q1;
  q1.X = load_fe(qx + r, b);
  q1.Y = load_fe(qy + r, b);
  q1.Z = one;

  // per-row table [0..15]Q by complete additions through the identity
  Pt tbl[16];
  tbl[0] = ident;
  for (int j = 1; j < 16; ++j) tbl[j] = pt_add(tbl[j - 1], q1);

  Pt acc = ident;
  for (int t = 0; t < nwin; ++t) {
    for (int k = 0; k < 4; ++k) acc = pt_double(acc);
    const uint32_t* e = s_g + (dig1[t * b + r] & 15u) * 3 * NL;
    Pt g;
    g.X = load_fe(e, 1);
    g.Y = load_fe(e + NL, 1);
    g.Z = load_fe(e + 2 * NL, 1);
    acc = pt_add(acc, g);
    acc = pt_add(acc, tbl[dig2[t * b + r] & 15u]);
  }

  // x(R) = r (mod n) iff X = r Z or X = (r + n) Z (mod p), Z != 0
  const bool eq_r = fe_is_zero(fe_sub(acc.X, fe_mul(load_fe(rl + r, b), acc.Z)));
  const bool eq_rn =
      fe_is_zero(fe_sub(acc.X, fe_mul(load_fe(rnl + r, b), acc.Z))) && rnok[r] != 0;
  ok[r] = (!fe_is_zero(acc.Z) && (eq_r || eq_rn)) ? 1u : 0u;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    out_x[i * b + r] = acc.X.v[i];
    out_z[i * b + r] = acc.Z.v[i];
  }
}

}  // namespace

extern "C" int secp256k1_ladder_launch(const void* consts, const void* qx,
                                       const void* qy, const void* dig1,
                                       const void* dig2, const void* rl,
                                       const void* rnl, const void* rnok, void* ok,
                                       void* out_x, void* out_z, int b, int nwin,
                                       void* stream) {
  const int threads = 128;
  const int blocks = (b + threads - 1) / threads;
  ladder_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)consts, (const uint32_t*)qx, (const uint32_t*)qy,
      (const uint32_t*)dig1, (const uint32_t*)dig2, (const uint32_t*)rl,
      (const uint32_t*)rnl, (const uint32_t*)rnok, (uint32_t*)ok, (uint32_t*)out_x,
      (uint32_t*)out_z, b, nwin);
  return (int)cudaGetLastError();
}
