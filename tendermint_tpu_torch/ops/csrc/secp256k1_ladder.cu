// K3: the secp256k1 ECDSA double-scalar ladder, R = u1 G + u2 Q, and the
// inversion-free check of x(R) against r. Two adjacent lanes of a warp serve
// one signature row; a block of one warp serves 16 rows.
//
// Replaces: tendermint_tpu/ops/secp256k1_pallas.py::_ladder_kernel (launched
// by _ladder_call; math in ladder_math, pt_add and _build_g_table).
//
// What bounds it on the H100: integer instructions. Each row does 3,254
// field multiplications, 512 squarings and 542 multiplications by b3 = 21
// (secp256k1_cuda.ladder_fe_ops): about 359k products of 32x32 -> 64 bits
// (IMAD.WIDE, which an H100 SM retires at about 30 a clock against 64 for
// 32-bit instructions: ops/imad_probe.py) at 100 a multiplication, 55 a
// squaring and 10 a small multiplication, and beside them the 32-bit
// instructions of the carries, the fold, the additions, the operand selects
// and the exchanges between a row's lanes. It reads and writes under 900
// bytes a row. The field is ten 26-bit limbs (libsecp256k1's field_10x26,
// ops/fe_secp256k1.py) with 64-bit column sums, instead of the TPU's twenty
// 13-bit limbs; the product's high columns are carried down to limb width
// and then folded by 2^260 = 0x1000003D10 (mod p) in two parts, 0x3D10 at
// the same limb and 0x400 one limb up, so no 64-bit column is ever
// multiplied by the 2^36-size fold constant. Additions are
// Renes-Costello-Batina 2016 algorithm 7 (complete, a = 0); doublings its
// algorithm 9.
//
// What the design does about it:
//  * Two lanes a row. A commit has 10,000 signatures, so one thread a row
//    leaves most of the card idle and nothing hides a dependent multiply.
//    The two lanes of a row split each point formula's independent
//    products: an addition is two rounds of six, three a lane; a doubling
//    two rounds of four, two a lane (secp256k1_cuda.ADD_ROUNDS /
//    DOUBLE_ROUNDS: lane q computes product 2 s + q of a round in slot s).
//    A warp runs every instruction for all of its lanes, so the products
//    are paired so that each lane computes only the linear values (sums,
//    differences, x21 steps) its own next products read, with the two
//    lanes' different formulas written as one instruction stream: operands
//    picked by lane, and a - b as a + (2p - b). The lanes trade single
//    values with __shfl_xor_sync; both end each formula holding the whole
//    point.
//  * A slot whose products are all squares (the doubling's Y^2 | Z^2) uses
//    the 55-product squaring (the squares and the doubled cross terms). Its
//    columns are the same integers as the 100-product multiply's, so the
//    fold that follows is unchanged.
//  * The products are out of line, and a lane's two independent products of
//    a round go through one body (fe_mul2) so that their multiplies
//    interleave; inlining them measured slower. The window loops stay
//    rolled.
//  * The fold runs on 32-bit words wherever fe_secp256k1's bounds allow,
//    with explicit wide multiply-adds and funnel shifts.
//  * The per-row table [0..15]Q is built by the row's lanes and kept in
//    dynamic shared memory, laid out [entry][word][row] so that the rows of
//    a warp read different banks whatever their digits. The constant table
//    [0..15]G sits in front of it, laid out [word][entry], so that
//    different digits read different banks too. Digits pick table entries
//    by direct indexing: keys and digits are public, so the TPU's 16-way
//    masked select is not needed.
//  * Rows past b (the last block's ragged edge) compute row b - 1 again,
//    so that both lanes of every pair take part in the exchanges, and write
//    nothing.
// The check X = r Z or X = (r + n) Z needs no inversion; lanes 0 and 1 of
// the row compute the two products and lane 0 writes ok, X and Z.
//
// The kernel's body is in secp256k1_ladder.cuh, which K6
// (secp256k1_verify.cu) shares; K3 instantiates it with Digits::kRows, the
// host's digit rows in and X and Z out.
//
// Every product is the same integer as in the plain version
// (secp256k1_cuda.ladder_point_ref, ladder_ref over fe_secp256k1.py; the
// lane schedule is secp256k1_cuda.pt_add_rounds / pt_double_rounds), so
// every intermediate is; the overflow bounds are certified by
// fe_secp256k1.certify().

#include <cstdint>
#include <cuda_runtime.h>

#include "secp256k1_field.cuh"
#include "secp256k1_ladder.cuh"

// The geometry comes from the caller (secp256k1_cuda.k3_geometry) and must
// be the one this build serves; the dynamic shared memory limit is raised
// once per device.
extern "C" int secp256k1_ladder_launch(const void* consts, const void* qx,
                                       const void* qy, const void* dig1,
                                       const void* dig2, const void* rl,
                                       const void* rnl, const void* rnok, void* ok,
                                       void* out_x, void* out_z, int b, int nwin,
                                       int lanes_per_row, int rows_per_block, int blocks,
                                       int smem_bytes, void* stream) {
  return launch_ladder<Digits::kRows>(consts, qx, qy, dig1, dig2, rl, rnl, rnok, ok, out_x,
                                      out_z, b, nwin, lanes_per_row, rows_per_block, blocks,
                                      smem_bytes, stream);
}
