"""K1's design and launch geometry on the CPU
(tendermint_tpu_torch/ops/ed25519_cuda.py, csrc/ed25519_prologue.cu).

The kernel serves a signature row with one thread: it stages each SHA-512
block's message in shared memory (template words, R and A in block 0, then
the row's varying words scattered in, in vidx order), runs the schedule in a
16-word ring beside the rounds, sums Barrett's columns in radix 2^16 with
L's zero limbs skipped, and runs the last carry, borrow and conditional
subtractions on 32-bit words. ``_kernel_mirror`` evaluates that schedule on
the CPU: it must equal ``prologue_ref`` on every output, its digest
hashlib's and the JAX package's ``sha512_batch``, its Barrett columns the
plain version's, bit for bit. The geometry must cover every row within the
shared memory a block has without opting in, and the kernel source's
constants must be the ones mirrored here."""

import hashlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tendermint_tpu.ops import sha512_batch as jsha
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.ops import ed25519_cuda as ec
from tendermint_tpu_torch.ops import sha512 as tsha
from tendermint_tpu_torch.tools import k1_compare

SRC = (Path(ec.__file__).parent / "csrc" / "ed25519_prologue.cu").read_text()
LENGTHS = (0, 33, 104, 111, 112, 200)
STATIC_SMEM_LIMIT = 48 * 1024  # dynamic shared memory a block gets without opting in
N = 24
M32 = 0xFFFFFFFF
L16_NONZERO = tuple(j for j, v in enumerate(ec._L16) if v)  # the limbs q3 L multiplies


def _rows(length: int, n: int = N):
    """n seeded rows: pubs, sigs, messages and K1's five CPU inputs. Lengths
    104, 112 and 200 share a template with a varying fixed64 at byte 17, as
    commit sign-bytes do; at the others every byte varies."""
    rng = np.random.default_rng(300 + length)
    pubs = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    sigs = rng.integers(0, 256, (n, 64), dtype=np.uint8)
    if length in (104, 112, 200):
        m = np.tile(rng.integers(0, 256, length, dtype=np.uint8), (n, 1))
        m[:, 17:25] = rng.integers(0, 256, (n, 8), dtype=np.uint8)
    else:
        m = rng.integers(0, 256, (n, length), dtype=np.uint8)
    msgs = [m[i].tobytes() for i in range(n)]
    tmpl, vrows, vwords = ec.pack_variable_words(pubs, msgs, sigs, length, n)
    ins = tuple(ec._put(a, "cpu") for a in (
        tmpl, vrows, vwords, np.ascontiguousarray(pubs).view("<u4"),
        np.ascontiguousarray(sigs).view("<u4")))
    return pubs, sigs, msgs, ins


def _staged_words(tmpl, vidx, vwords, pub_words, sig_words) -> np.ndarray:
    """(b, rows) u32 padded SHA-512 input as the kernel stages it, block by
    block: template words, R and A in block 0, then each of the row's
    varying words that falls in the block, in vidx order."""
    tmpl, vidx, vwords, pw, sw = (t.numpy().astype(np.int64) & M32 for t in (
        tmpl, vidx, vwords, pub_words, sig_words))
    bswap = lambda x: (((x >> 24) & 0xFF) | ((x >> 8) & 0xFF00)
                       | ((x << 8) & 0xFF0000) | ((x << 24) & 0xFF000000))
    out = np.empty((sw.shape[0], tmpl.shape[0]), np.int64)
    for base in range(0, tmpl.shape[0], 32):
        m = np.tile(tmpl[base: base + 32], (sw.shape[0], 1))
        if base == 0:
            m[:, 0:8], m[:, 8:16] = bswap(sw[:, 0:8]), bswap(pw)
        for j, v in enumerate(vidx):
            if base <= v < base + 32:
                m[:, v - base] = vwords[:, j]
        out[:, base: base + 32] = m
    return out


def _sha512_ring(words: np.ndarray) -> np.ndarray:
    """SHA-512 state words (b, 8) uint64 of (b, rows) message words, as the
    kernel runs it: the schedule in a 16-word ring, word t made just before
    round t, and h + K[t] + W[t] summed first in the round."""
    words = words.astype(np.uint64)
    k = np.array(tsha.K, np.uint64)
    rot = lambda x, n: (x >> np.uint64(n)) | (x << np.uint64(64 - n))
    H = np.tile(np.array(tsha.H0, np.uint64), (words.shape[0], 1))
    with np.errstate(over="ignore"):
        for blk in range(words.shape[1] // 32):
            W = [(words[:, blk * 32 + 2 * t] << np.uint64(32)) | words[:, blk * 32 + 2 * t + 1]
                 for t in range(16)]
            a, b_, c, d, e, f, g, h = (H[:, j] for j in range(8))
            for t in range(80):
                if t >= 16:
                    w15, w2 = W[(t - 15) % 16], W[(t - 2) % 16]
                    s0 = rot(w15, 1) ^ rot(w15, 8) ^ (w15 >> np.uint64(7))
                    s1 = rot(w2, 19) ^ rot(w2, 61) ^ (w2 >> np.uint64(6))
                    W[t % 16] = W[t % 16] + s0 + W[(t - 7) % 16] + s1
                t1 = (h + k[t] + W[t % 16]) + (rot(e, 14) ^ rot(e, 18) ^ rot(e, 41)) \
                    + ((e & f) ^ (~e & g))
                maj = (a & b_) ^ (a & c) ^ (b_ & c)
                h, g, f, e, d, c, b_, a = (g, f, e, d + t1, c, b_, a,
                                           t1 + (rot(a, 28) ^ rot(a, 34) ^ rot(a, 39)) + maj)
            H = H + np.stack([a, b_, c, d, e, f, g, h], axis=1)
    return H


def _raw_cols(cols, const, ncols):
    """The uncarried columns of ``ec._mul_const16``'s product, in its order."""
    prod = [cols[0] * 0 for _ in range(len(cols) + len(const))]
    for j, cj in enumerate(const):
        if cj:
            for i, v in enumerate(cols):
                prod[i + j] = prod[i + j] + v * cj
    return prod[:ncols]


def _x16(values):
    """Python ints < 2^512 -> 32 16-bit limb tensors."""
    return [torch.tensor([(v >> (16 * i)) & 0xFFFF for v in values], dtype=torch.int64)
            for i in range(32)]


def test_barrett_columns_are_the_plain_ones():
    """The kernel's q1 mu columns, q3 and q3 L columns (zero limbs skipped)
    equal the plain version's uncarried columns and q3, on seeded digests
    and edge values."""
    rng = np.random.default_rng(71)
    L = ted.L
    values = [int.from_bytes(rng.bytes(64), "little") for _ in range(100)]
    values += [0, 1, L - 1, L, L + 1, 2 * L, 3 * L - 1, (1 << 512) - 1, (1 << 256) - 1,
               ((1 << 512) // L) * L, ((1 << 512) // L) * L - 1, 1 << 511]
    x = _x16(values)
    mu_plain = _raw_cols(x[15:], ec._MU16, 34)
    q3_plain = ec._mul_const16(x[15:], ec._MU16)[17:]
    ql_plain = _raw_cols(q3_plain, ec._L16, 17)
    for i in range(len(values)):
        mu, q3, ql = _barrett_cols([int(t[i]) for t in x])
        assert mu == [int(c[i]) for c in mu_plain]
        assert q3 == [int(c[i]) for c in q3_plain]
        assert ql == [int(c[i]) for c in ql_plain]


def _finish32(x, ql):
    """The kernel's ``barrett_finish`` on Python ints: the carry and borrow
    chains on nine 32-bit words, then two conditional subtractions of L."""
    w, cy, borrow = [], 0, 0
    for j in range(9):
        hi = ql[2 * j + 1] if 2 * j + 1 < 17 else 0
        v = ql[2 * j] + (hi << 16) + cy
        cy = v >> 32
        xw = x[2 * j] | ((x[2 * j + 1] << 16) if 2 * j + 1 < 17 else 0)
        d = xw - (v & 0xFFFFFFFF) - borrow
        borrow = int(d < 0)
        w.append(d & 0xFFFFFFFF)
    w[8] &= 0xFFFF
    lc = [ec._LC16[2 * j] | ((ec._LC16[2 * j + 1] << 16) if 2 * j + 1 < 17 else 0)
          for j in range(9)]
    for _ in range(2):
        t, c1 = [], 0
        for j in range(9):
            v = w[j] + lc[j] + c1
            t.append(v & 0xFFFFFFFF)
            c1 = v >> 32
        if t[8] >> 16:
            w = t[:8] + [t[8] & 0xFFFF]
    return sum(v << (32 * j) for j, v in enumerate(w))


def test_barrett_finish_in_32_bit_words_equals_the_plain():
    """The kernel runs Barrett's last carry pass, borrow and conditional
    subtractions two 16-bit limbs a step; on digests whose r lands on each
    side of L and 2L, and on seeded ones, it gives ``_mod_l16``'s value."""
    L = ted.L
    rng = np.random.default_rng(73)
    mu = (1 << 512) // L
    values = [int.from_bytes(rng.bytes(64), "little") for _ in range(300)]
    for q in (1, 2, mu // 3, mu - 1, (1 << 256) // L):  # x = qL + small: r near 0, L, 2L
        for dlt in (0, 1, L - 1, L, L + 1, 2 * L - 1, 2 * L):
            values.append((q * L + dlt) % (1 << 512))
    values += [0, (1 << 512) - 1]
    x = _x16(values)
    q3 = ec._mul_const16(x[15:], ec._MU16)[17:]
    cols = _raw_cols(q3, ec._L16, 17)
    plain = ec._mod_l16(x)
    for i, v in enumerate(values):
        got = _finish32([int(t[i]) for t in x[:17]], [int(c[i]) for c in cols])
        assert got == sum(int(plain[k][i]) << (16 * k) for k in range(16)) == v % L


def _barrett_cols(x):
    """The kernel's column sums: q1 mu over all 34 columns (q1 = x[15..31]),
    carried to q3, then q3 L's low 17 columns with L's zero limbs skipped."""
    q1 = x[15:]
    mu = [sum(q1[i] * ec._MU16[c - i] for i in range(17) if 0 <= c - i < 17) for c in range(34)]
    q3, cy = [], 0
    for c, v in enumerate(mu):
        v += cy
        if c >= 17:
            q3.append(v & 0xFFFF)
        cy = v >> 16
    ql = [sum(q3[c - j] * ec._L16[j] for j in L16_NONZERO if j <= c) for c in range(17)]
    return mu, q3, ql


def _kernel_mirror(tmpl, vidx, vwords, pub_words, sig_words):
    """K1 as the kernel computes it, on the CPU: same inputs and outputs as
    ``prologue_ref``."""
    H = _sha512_ring(_staged_words(tmpl, vidx, vwords, pub_words, sig_words))
    sw = sig_words.numpy().astype(np.int64) & M32
    b = sw.shape[0]
    digs, digh, rlimb, rsign = (np.zeros((n, b), np.int64) for n in (64, 64, 10, 1))
    for i in range(b):
        digest = b"".join(int(v).to_bytes(8, "big") for v in H[i])
        x = [int.from_bytes(digest[2 * j: 2 * j + 2], "little") for j in range(32)]
        r = _finish32(x[:17], _barrett_cols(x)[2])
        s = sum(int(w) << (32 * j) for j, w in enumerate(sw[i, 8:]))
        for t in range(64):
            digh[t, i] = (r >> (4 * (63 - t))) & 15
            digs[t, i] = (s >> (4 * (63 - t))) & 15
        rv = sum(int(w) << (32 * j) for j, w in enumerate(sw[i, :8]))
        rlimb[:, i] = [(rv % 2**255 >> off) & m for off, m in zip(ec.fe.OFFS, ec.fe.MASKS)]
        rsign[0, i] = rv >> 255
    return tuple(torch.from_numpy(a).to(torch.int32) for a in (digs, digh, rlimb, rsign))


@pytest.mark.parametrize("length", LENGTHS)
def test_kernel_mirror_equals_prologue_ref(length):
    *_, ins = _rows(length)
    for got, want in zip(_kernel_mirror(*ins), ec.prologue_ref(*ins)):
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("length", LENGTHS)
def test_staged_message_is_the_padded_input(length):
    """The staged words are R || A || M, padded, as big-endian words; the
    ring schedule and rounds on them give hashlib's digest and the JAX
    package's."""
    pubs, sigs, msgs, ins = _rows(length)
    data = np.concatenate([sigs[:, :32], pubs,
                           np.frombuffer(b"".join(msgs), np.uint8).reshape(N, length)], axis=1)
    words = _staged_words(*ins)
    assert np.array_equal(words, tsha.be_words(tsha.pad(data)).astype(np.int64))
    digests = np.ascontiguousarray(_sha512_ring(words).astype(">u8")).view(np.uint8)
    digests = digests.reshape(N, 64)
    assert np.array_equal(digests, jsha.sha512_batch(data, data.shape[1]))
    assert np.array_equal(digests, tsha.sha512_batch(data, device="cpu"))
    for i in range(N):
        assert digests[i].tobytes() == hashlib.sha512(data[i].tobytes()).digest()


def test_l16_zero_limbs_match_the_source():
    """q3 L skips L's zero limbs: the kernel's l16_nonzero names the same
    limbs as the constant."""
    assert L16_NONZERO == tuple(range(8)) + (15,)
    body = re.search(r"constexpr bool l16_nonzero\(int j\) \{ return (.*?); \}", SRC).group(1)
    expr = body.replace("||", " or ").replace("&&", " and ")
    assert tuple(j for j in range(17) if eval(expr, {"j": j})) == L16_NONZERO


def _const(name):
    return int(re.search(r"constexpr int " + name + r"\s*=\s*(\d+);", SRC).group(1))


def test_kernel_source_geometry_matches_the_wrapper():
    lanes, rpb, _, smem = ec.k1_geometry(1)
    assert (_const("LPR"), _const("RPB")) == (lanes, rpb) == (1, ec.K1_ROWS_PER_BLOCK)
    assert "SMEM_BYTES = 32 * RPB * 4" in SRC and smem == 32 * 4 * rpb
    assert "lanes_per_row" in SRC  # the compare tool launches by this


@pytest.mark.parametrize("b", [1, 63, 64, 65, 200, 1280, 10_240, 40_960, 163_840])
def test_k1_geometry_covers_every_row(b):
    lanes, rpb, blocks, smem = ec.k1_geometry(b)
    assert (lanes, rpb) == (1, ec.K1_ROWS_PER_BLOCK)
    assert blocks == -(-b // rpb)
    assert blocks * rpb >= b and (blocks - 1) * rpb < b  # the last block ragged or full
    # one SHA-512 block's staged message, 32 u32 a row
    assert smem == 32 * 4 * rpb <= STATIC_SMEM_LIMIT
    assert rpb % 32 == 0


def test_every_sm_gets_work_at_the_main_path_bucket():
    assert ec.k1_geometry(ec._bucket(10_000))[2] >= 132  # an H100's SMs


def test_k1_geometry_refuses_an_empty_batch():
    with pytest.raises(ValueError):
        ec.k1_geometry(0)


def test_prologue_into_launches_only_on_cuda():
    b, k = 8, 2
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32)
    ins = (z(64), z(k), z(b, k), z(b, 8), z(b, 16))
    outs = (z(64, b), z(64, b), z(10, b), z(1, b))
    before = ec.launches["ed25519_prologue"]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ec.prologue_into(ins, outs)
    with pytest.raises(ValueError, match="shape"):
        ec.prologue_into(ins, outs[:3] + (z(1, b + 1),))
    assert ec.launches["ed25519_prologue"] == before


SASS = """
        Function : _ZN12_GLOBAL__N_115prologue_kernelEPKjiPKiiS1_S1_S1_PjS4_S4_S4_i
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   SHF.R.W.U32.HI R2, R3, 0xe, R4 ;
        /*0020*/                   LOP3.LUT R5, R2, R6, R7, 0x96, !PT ;
        /*0030*/                   IMAD.WIDE.U32 R8, R9, R10, R8 ;
        /*0040*/                   LDS.64 R10, [R11] ;
        /*0050*/                   BAR.SYNC R12, 0x40 ;
        /*0060*/                   EXIT ;
        /*0070*/                   BRA 0x70;
        /*0080*/                   NOP;
"""


def test_sass_mix_counts_the_whole_kernel():
    assert k1_compare.sass_mix(SASS) == {"move": 1, "alu": 2, "imad_wide": 1, "memory": 1,
                                         "control": 3, "kernels": 1}
