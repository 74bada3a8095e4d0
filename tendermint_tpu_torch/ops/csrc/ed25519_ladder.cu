// K2: the Ed25519 double-scalar ladder, R' = [s]B + [h](-A), one thread per
// signature row, 128 rows per block.
//
// Replaces: tendermint_tpu/ops/ed25519_pallas.py::_ladder_kernel (launched by
// _ladder_call; math in ladder_math and the point ops above it).
//
// What bounds it on the H100: integer multiplies. Each row does 2,105 field
// multiplications and 1,306 squarings (ed25519_cuda.ladder_fe_ops), about
// 282k products of 32x32 -> 64 bits (IMAD.WIDE) at 100 a multiplication and
// 55 a squaring; this kernel squares with the full 100-product multiply
// (341k a row). It reads and writes under 700 bytes a row. Hopper
// multiplies 32x32 -> 64 natively and
// emulates 64x64 -> 128, so the field uses ten 32-bit limbs in radix 2^25.5
// (ops/fe.py) with 64-bit column sums instead of the TPU's twenty 13-bit
// limbs. The per-row table [0..15](-A) (2.5 KB) lives in thread-local memory;
// the constant table [0..15]B lives in shared memory, loaded once per block
// (lanes of a warp pick different digits, and divergent __constant__ reads
// would serialise). The digit picks are direct indexing: the inputs are
// public, so the TPU's 16-way masked select is not needed.
//
// Same schedule as the plain version (ed25519_cuda.ladder_point_ref,
// ladder_ref over fe.py), so every intermediate is the same integer; the
// overflow bounds are certified by fe.certify().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NL = 10;
constexpr int NCONSTS = 16 * 3 * NL + NL;  // niels table [0..15]B, then 2d
constexpr uint32_t M26 = (1u << 26) - 1;
constexpr uint32_t M25 = (1u << 25) - 1;

__device__ __forceinline__ int width(int i) { return (i & 1) ? 25 : 26; }
__device__ __forceinline__ uint32_t lmask(int i) { return (i & 1) ? M25 : M26; }

struct Fe {
  uint32_t v[NL];
};

struct Pt {  // extended coordinates
  Fe X, Y, Z, T;
};

struct Cached {  // (Y+X, Y-X, Z, 2d*T)
  Fe ypx, ymx, Z, t2d;
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

// Out of line: one copy of the 100-product body keeps the kernel small;
// the operands travel by value.
__device__ __noinline__ Fe fe_mul(Fe a, Fe b) {
  uint32_t b19[NL], a2[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    b19[i] = 19u * b.v[i];
    a2[i] = (i & 1) ? 2u * a.v[i] : a.v[i];
  }
  uint64_t h[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) h[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const uint32_t ai = ((i & 1) && (j & 1)) ? a2[i] : a.v[i];
      const uint32_t bj = (i + j >= NL) ? b19[j] : b.v[j];
      h[(i + j) % NL] += (uint64_t)ai * bj;
    }
  }
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

__device__ __forceinline__ Fe fe_sq(const Fe& a) { return fe_mul(a, a); }

__device__ Fe fe_sqn(Fe a, int n) {
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

__device__ __forceinline__ Pt pt_finish(const Fe& A, const Fe& B, const Fe& C,
                                        const Fe& D) {
  const Fe E = fe_sub(B, A);
  const Fe F = fe_sub(D, C);
  const Fe G = fe_add(D, C);
  const Fe H = fe_add(B, A);
  Pt o;
  o.X = fe_mul(E, F);
  o.Y = fe_mul(G, H);
  o.Z = fe_mul(F, G);
  o.T = fe_mul(E, H);
  return o;
}

__device__ Pt pt_double(const Pt& p) {
  const Fe A = fe_sq(p.X);
  const Fe B = fe_sq(p.Y);
  const Fe ZZ = fe_sq(p.Z);
  const Fe C = fe_add(ZZ, ZZ);
  const Fe H = fe_add(A, B);
  const Fe E = fe_sub(H, fe_sq(fe_add(p.X, p.Y)));
  const Fe G = fe_sub(A, B);
  const Fe F = fe_add(C, G);
  Pt o;
  o.X = fe_mul(E, F);
  o.Y = fe_mul(G, H);
  o.Z = fe_mul(F, G);
  o.T = fe_mul(E, H);
  return o;
}

__device__ Pt pt_add(const Pt& p, const Pt& q, const Fe& d2) {
  const Fe A = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
  const Fe B = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
  const Fe C = fe_mul(fe_mul(p.T, d2), q.T);
  const Fe D = fe_mul(fe_add(p.Z, p.Z), q.Z);
  return pt_finish(A, B, C, D);
}

__device__ Pt pt_add_cached(const Pt& p, const Cached& c) {
  const Fe A = fe_mul(fe_sub(p.Y, p.X), c.ymx);
  const Fe B = fe_mul(fe_add(p.Y, p.X), c.ypx);
  const Fe C = fe_mul(p.T, c.t2d);
  const Fe D = fe_mul(fe_add(p.Z, p.Z), c.Z);
  return pt_finish(A, B, C, D);
}

__device__ Pt pt_madd(const Pt& p, const Fe& ypx, const Fe& ymx, const Fe& t2d) {
  const Fe A = fe_mul(fe_sub(p.Y, p.X), ymx);
  const Fe B = fe_mul(fe_add(p.Y, p.X), ypx);
  const Fe C = fe_mul(p.T, t2d);
  return pt_finish(A, B, C, fe_add(p.Z, p.Z));
}

__device__ __forceinline__ Fe load_fe_smem(const uint32_t* s) {
  Fe o;
#pragma unroll
  for (int i = 0; i < NL; ++i) o.v[i] = s[i];
  return o;
}

__global__ void __launch_bounds__(128)
ladder_kernel(const uint32_t* __restrict__ consts, const uint32_t* __restrict__ negax,
              const uint32_t* __restrict__ ay, const uint32_t* __restrict__ digs,
              const uint32_t* __restrict__ digh, const uint32_t* __restrict__ rlimb,
              const uint32_t* __restrict__ rsign, uint32_t* __restrict__ ok,
              uint32_t* __restrict__ renc, int b, int nwin) {
  __shared__ uint32_t s_consts[NCONSTS];
  for (int i = threadIdx.x; i < NCONSTS; i += blockDim.x) s_consts[i] = consts[i];
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= b) return;

  const Fe d2 = load_fe_smem(s_consts + 16 * 3 * NL);
  Fe zero, one;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    zero.v[i] = 0;
    one.v[i] = i == 0 ? 1u : 0u;
  }
  Pt a1;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    a1.X.v[i] = negax[i * b + r];
    a1.Y.v[i] = ay[i * b + r];
  }
  a1.Z = one;
  a1.T = fe_mul(a1.X, a1.Y);

  // per-row table [0..15](-A): evens by doubling, odds by adding -A
  Cached tbl[16];
  {
    Pt pts[16];
    pts[0].X = zero;
    pts[0].Y = one;
    pts[0].Z = one;
    pts[0].T = zero;
    pts[1] = a1;
    for (int j = 2; j < 16; ++j)
      pts[j] = (j & 1) ? pt_add(pts[j - 1], a1, d2) : pt_double(pts[j / 2]);
    for (int j = 0; j < 16; ++j) {
      tbl[j].ypx = fe_add(pts[j].Y, pts[j].X);
      tbl[j].ymx = fe_sub(pts[j].Y, pts[j].X);
      tbl[j].Z = pts[j].Z;
      tbl[j].t2d = fe_mul(pts[j].T, d2);
    }
  }

  Pt acc;
  acc.X = zero;
  acc.Y = one;
  acc.Z = one;
  acc.T = zero;
  for (int t = 0; t < nwin; ++t) {
    for (int k = 0; k < 4; ++k) acc = pt_double(acc);
    const uint32_t ds = digs[t * b + r] & 15u;
    const uint32_t* e = s_consts + ds * 3 * NL;
    acc = pt_madd(acc, load_fe_smem(e), load_fe_smem(e + NL), load_fe_smem(e + 2 * NL));
    const uint32_t dh = digh[t * b + r] & 15u;
    acc = pt_add_cached(acc, tbl[dh]);
  }

  const Fe zinv = fe_inv(acc.Z);
  const Fe x = fe_canonical(fe_mul(acc.X, zinv));
  const Fe y = fe_canonical(fe_mul(acc.Y, zinv));
  bool good = (x.v[0] & 1u) == rsign[r];
#pragma unroll
  for (int i = 0; i < NL; ++i) good = good && (y.v[i] == rlimb[i * b + r]);
  ok[r] = good ? 1u : 0u;

  // encoding of R': y | (x & 1) << 255, as 8 little-endian words
  uint32_t w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = 0;
  int off = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int wi = off >> 5, sh = off & 31, wd = width(i);
    w[wi] |= y.v[i] << sh;
    if (sh + wd > 32) w[wi + 1] |= y.v[i] >> (32 - sh);
    off += wd;
  }
  w[7] |= (x.v[0] & 1u) << 31;
#pragma unroll
  for (int j = 0; j < 8; ++j) renc[j * b + r] = w[j];
}

}  // namespace

extern "C" int ed25519_ladder_launch(const void* consts, const void* negax,
                                     const void* ay, const void* digs,
                                     const void* digh, const void* rlimb,
                                     const void* rsign, void* ok, void* renc,
                                     int b, int nwin, void* stream) {
  const int threads = 128;
  const int blocks = (b + threads - 1) / threads;
  ladder_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)consts, (const uint32_t*)negax, (const uint32_t*)ay,
      (const uint32_t*)digs, (const uint32_t*)digh, (const uint32_t*)rlimb,
      (const uint32_t*)rsign, (uint32_t*)ok, (uint32_t*)renc, b, nwin);
  return (int)cudaGetLastError();
}
