// K2: the Ed25519 double-scalar ladder, R' = [s]B + [h](-A), then Z^-1 and
// the canonical encoding of R'. Two adjacent lanes of a warp serve one
// signature row; a block of one warp serves 16 rows.
//
// Replaces: tendermint_tpu/ops/ed25519_pallas.py::_ladder_kernel (launched by
// _ladder_call; math in ladder_math and the point ops above it).
//
// What bounds it on the H100: integer instructions. Each row does 2,105
// field multiplications and 1,306 squarings (ed25519_cuda.ladder_fe_ops):
// about 282k products of 32x32 -> 64 bits (IMAD.WIDE, which an H100 SM
// retires at about 30 a clock against 64 for 32-bit instructions:
// ops/imad_probe.py) at 100 a multiplication and 55 a squaring, and beside
// them the 32-bit instructions of the carries, the additions, the operand
// selects and the exchanges between a row's lanes. It reads and writes
// under 700 bytes a row. Hopper multiplies 32x32 -> 64 natively and
// emulates 64x64 -> 128, so the field uses ten 32-bit limbs in radix 2^25.5
// (ops/fe.py) with 64-bit column sums instead of the TPU's twenty 13-bit
// limbs.
//
// What the design does about it:
//  * Two lanes a row. A commit has 10,000 signatures, so one thread a row
//    leaves most of the card idle and nothing hides a dependent multiply.
//    The two lanes of a row split each point formula's independent
//    products (ed25519_cuda.DOUBLE_ROUNDS / MADD_ROUNDS / CACHED_ROUNDS:
//    lane q computes product 2 s + q of a round in slot s): a doubling is
//    two squarings and then two products a lane, either add two products
//    and two products. Per window a lane runs 8 squaring slots and 16
//    multiply slots, 2,040 products, against 4,700 a row on one thread.
//    A warp runs every instruction for all of its lanes, so each lane
//    computes only the linear values its own next products read, with the
//    two lanes' different steps written as one instruction stream
//    (operands picked by lane, a - b as a + (2p - b)); the lanes trade
//    single values with __shfl_xor_sync. After every formula lane 0 holds
//    X, T, Y and lane 1 Z, Y, T, which is what every formula reads first.
//    The mixed add runs through the cached add's body: lane 1 keeps 2Z in
//    place of its second product of round 1.
//  * Squarings use 55 products: the ten squares and the 45 cross terms,
//    with the factors 2, 2 (odd x odd limbs) and 19 (wrapped columns)
//    split between the two 32-bit operands (ed25519_cuda.sq_split: 1 or 2
//    on the left, 1, 2, 19 or 38 on the right; 76 on an even limb would
//    overflow). Its columns are the same integers as the 100-product
//    multiply's, so the carry that follows is unchanged.
//  * The products are out of line, and a lane's two independent products of
//    a round go through one body (fe_mul2, fe_sq2) so that their multiplies
//    interleave; the loops stay rolled.
//  * The per-row table [0..15](-A) is built by the row's lanes as the plain
//    version builds it (the identity, -A, then 2 [j/2](-A) for even j and
//    [j-1](-A) + (-A) by the full add for odd j; the full add is the cached
//    add's first round with one more product on lane 1,
//    ed25519_cuda.pt_add_rounds), converted to cached form (Y+X, Y-X, Z,
//    2d T), and kept in dynamic shared memory, laid out [entry][word][row]
//    so that the rows of a warp read different banks whatever their
//    digits. The constant niels table [0..15]B and 2d sit in front of it,
//    laid out [word][entry], so that different digits read different banks
//    too. Digits pick table entries by direct indexing: keys and digits are
//    public, so the TPU's 16-way masked select is not needed.
//  * Rows past b (the last block's ragged edge) compute row b - 1 again,
//    so that both lanes of every pair take part in the exchanges, and write
//    nothing.
// The epilogue (Z^-1 by 254 squarings and 11 multiplications) runs on both
// lanes; lane 0 | lane 1 then compute X Z^-1 | Y Z^-1 in one slot, and lane
// 0 writes ok and the encoding.
//
// The kernel's body is in ed25519_ladder.cuh, which K5 (ed25519_verify.cu)
// shares; K2 instantiates it with Digits::kRows, K1's digit rows in and the
// encoding of R' out.
//
// Every product is the same integer as in the plain version
// (ed25519_cuda.ladder_point_ref, ladder_ref over fe.py; the lane schedule
// is ed25519_cuda.pt_double_rounds / pt_madd_rounds / pt_add_cached_rounds /
// pt_add_rounds), so every intermediate is, and the table is the plain
// version's entry for entry; the overflow bounds are certified by
// fe.certify().

#include <cstdint>
#include <cuda_runtime.h>

#include "ed25519_field.cuh"
#include "ed25519_ladder.cuh"

// The geometry comes from the caller (ed25519_cuda.k2_geometry) and must be
// the one this build serves; the dynamic shared memory limit is raised once
// per device.
extern "C" int ed25519_ladder_launch(const void* consts, const void* negax,
                                     const void* ay, const void* digs,
                                     const void* digh, const void* rlimb,
                                     const void* rsign, void* ok, void* renc, int b,
                                     int nwin, int lanes_per_row, int rows_per_block,
                                     int blocks, int smem_bytes, void* stream) {
  return launch_ladder<Digits::kRows>(consts, negax, ay, digs, digh, rlimb, rsign, ok, renc, b,
                                      nwin, lanes_per_row, rows_per_block, blocks, smem_bytes,
                                      stream);
}
