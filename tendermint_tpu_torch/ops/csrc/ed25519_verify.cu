// K5: the Ed25519 double-scalar ladder of the verifier's mesh route,
// R' = [s]B + [h](-A), then Z^-1 and a byte-exact compare of R''s canonical
// encoding with R. Two adjacent lanes of a warp serve one signature row; a
// block of one warp serves 16 rows.
//
// Replaces: tendermint_tpu/ops/ed25519_verify.py::_verify_kernel (jitted by
// _compiled_kernel; the JAX package's XLA route, which every sharded
// dispatch of its verifier runs).
//
// What it computes, row r (the plain version is ed25519_verify.verify_ref,
// the reference's bit-serial ladder): R' = [s]B + [h](-A) for s, h below
// 2^253, then Z^-1, canonical x and y, and accept iff y's limbs equal R's
// raw limbs (the low 255 bits of R, unreduced, so a non-canonical R is
// rejected) and x's parity equals R's sign bit. It writes the verdict alone.
//
// What bounds it on the H100: integer instructions. The reference's
// bit-serial schedule does about 3,303 multiplications of 100 products of
// 32x32 -> 64 bits (IMAD.WIDE) and 1,266 squarings of 55 a row, some 400k
// products (ed25519_verify.k5_fe_ops counts a batch's; the bound is read
// against it). This design does K2's 2,105 multiplications and 1,306
// squarings, some 282k (ed25519_cuda.ladder_fe_ops). It reads 192 bytes a
// row and writes 4.
//
// What the design does about it: it is K2's (ed25519_ladder.cu describes
// it), and its body is K2's, in ed25519_ladder.cuh:
//  * two lanes a row split each point formula's independent products, so a
//    10,240-row batch fills 640 one-warp blocks and a 2,560-row shard 160,
//    where one thread a row left most of the card idle;
//  * 64 windows of 4 bits over a per-row table [0..15](-A) in dynamic
//    shared memory, behind the constant niels table [0..15]B and 2d (the
//    kernel's constant input, ed25519_cuda._CONSTS), in place of 253
//    doublings and an addition a set bit;
//  * the 55-product squaring and paired out-of-line products.
// Only the digits and the epilogue differ from K2 (Digits::kWords): digit t
// is the 4-bit field at bit 4 (63 - t) of the scalar's bit words, which
// the host packs as it did for the bit-serial kernel, so no host pass or
// extra launch forms digits; the top window keeps bit 252 alone, as the
// plain version reads 253 bits. Rows past b (the last block's ragged edge)
// compute row b - 1 again and write nothing.
//
// The group element R' is the plain version's, so the verdict is, on every
// row; every product of the windowed schedule is the same integer as in
// ed25519_cuda.ladder_point_ref over fe.py, whose overflow bounds
// fe.certify() certifies.

#include <cstdint>
#include <cuda_runtime.h>

#include "ed25519_field.cuh"
#include "ed25519_ladder.cuh"

// The geometry comes from the caller (ed25519_verify.k5_geometry, K2's) and
// must be the one this build serves; the dynamic shared memory limit is
// raised once per device.
extern "C" int ed25519_verify_launch(const void* consts, const void* negax, const void* ay,
                                     const void* sw, const void* hw, const void* rlimb,
                                     const void* rsign, void* ok, int b, int lanes_per_row,
                                     int rows_per_block, int blocks, int smem_bytes,
                                     void* stream) {
  return launch_ladder<Digits::kWords>(consts, negax, ay, sw, hw, rlimb, rsign, ok, nullptr, b,
                                       NWIN, lanes_per_row, rows_per_block, blocks, smem_bytes,
                                       stream);
}
