// K6: the secp256k1 ECDSA double-scalar ladder of the verifier's mesh
// route, R = u1 G + u2 Q, and the check x(R) in {r, r + n}. Two adjacent
// lanes of a warp serve one signature row; a block of one warp serves 16
// rows.
//
// Replaces: tendermint_tpu/ops/secp256k1_verify.py::_verify_kernel (jitted by
// _compiled_kernel; the JAX package's XLA route, which every sharded
// dispatch of its verifier runs).
//
// What it computes, row r (the plain version is secp256k1_verify.verify_ref,
// the reference's bit-serial ladder): R = u1 G + u2 Q, and accept iff Z != 0
// and the affine x equals r, or r + n where r + n < p (rnok). It writes the
// verdict alone.
//
// What bounds it on the H100: integer instructions. The reference's
// bit-serial schedule (256 doublings by the complete addition, and one
// addition a set bit of u1 and of u2, then Z^-1) does about 6,160
// multiplications of 100 products of 32x32 -> 64 bits (IMAD.WIDE), 255
// squarings of 55 and 1,024 multiplications by b3 a row, some 630k products
// (secp256k1_verify.k6_fe_ops counts a batch's; the bound is read against
// it). This design does K3's 3,254 multiplications, 512 squarings and 542
// by b3, some 359k (secp256k1_cuda.ladder_fe_ops). It reads 228 bytes a row
// and writes 4.
//
// What the design does about it: it is K3's (secp256k1_ladder.cu describes
// it), and its body is K3's, in secp256k1_ladder.cuh:
//  * two lanes a row split each formula's independent products (an
//    addition two rounds of six, the doubling RCB16 algorithm 9's two
//    rounds of four, in place of a doubling by the 12-product addition), so
//    a 10,240-row batch fills 640 one-warp blocks and a 2,560-row shard 160,
//    where one thread a row left most of the card idle;
//  * 64 windows of 4 bits over a per-row table [0..15]Q in dynamic shared
//    memory, behind the constant [0..15]G (the kernel's constant input,
//    secp256k1_cuda._CONSTS);
//  * the 55-product squaring and paired out-of-line products;
//  * the inversion-free check X = r Z or X = (r + n) Z, Z != 0, in place of
//    the 255 squarings of Z^-1.
// Only the digits and the epilogue differ from K3 (Digits::kWords): digit t
// is the 4-bit field at bit 4 (63 - t) of the scalar's bit words, which
// the host packs as it did for the bit-serial kernel, so no host pass or
// extra launch forms digits. Rows past b (the last block's ragged edge)
// compute row b - 1 again and write nothing.
//
// The group element R is the plain version's, so the verdict is, on every
// row; every product of the windowed schedule is the same integer as in
// secp256k1_cuda.ladder_point_ref over fe_secp256k1.py, whose overflow
// bounds fe_secp256k1.certify() certifies.

#include <cstdint>
#include <cuda_runtime.h>

#include "secp256k1_field.cuh"
#include "secp256k1_ladder.cuh"

// The geometry comes from the caller (secp256k1_verify.k6_geometry, K3's)
// and must be the one this build serves; the dynamic shared memory limit is
// raised once per device.
extern "C" int secp256k1_verify_launch(const void* consts, const void* qx, const void* qy,
                                       const void* u1w, const void* u2w, const void* rl,
                                       const void* rnl, const void* rnok, void* ok, int b,
                                       int lanes_per_row, int rows_per_block, int blocks,
                                       int smem_bytes, void* stream) {
  return launch_ladder<Digits::kWords>(consts, qx, qy, u1w, u2w, rl, rnl, rnok, ok, nullptr,
                                       nullptr, b, NWIN, lanes_per_row, rows_per_block, blocks,
                                       smem_bytes, stream);
}
