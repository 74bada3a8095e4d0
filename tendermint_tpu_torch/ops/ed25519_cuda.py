"""Batched Go-exact Ed25519 verification on the H100: host side, the plain
versions of the two kernels, and the kernel wrappers.

Counterpart of the JAX package's ``ops/ed25519_pallas.py``. Per signature
row, everything after point decompression runs on the device in two
hand-written CUDA kernels (``csrc/``):

  * K1, the prologue (``prologue``): SHA-512(R || A || M) assembled on the
    device from a template row plus the words that vary per row, the exact
    reduction of the digest mod L, the 64 MSB-first 4-bit digits of h and of
    s, R's raw y limbs and R's sign bit; one thread a row, ``k1_geometry``
    gives its launch geometry;
  * K2, the ladder (``ladder``): windowed Straus R' = [s]B + [h](-A) over 64
    windows (4 doublings, one mixed add from the constant niels table
    [0..15]B, one cached add from a per-row table [0..15](-A)), complete
    extended formulas throughout, then Z^-1 and the canonical encoding of
    R'. A row is accepted iff that encoding equals R's bytes. The kernel
    serves each row with two lanes of a warp, which split each point
    formula's independent products between them (``DOUBLE_ROUNDS``,
    ``MADD_ROUNDS``, ``CACHED_ROUNDS``, evaluated on the plain field ops by
    ``pt_double_rounds``, ``pt_madd_rounds``, ``pt_add_cached_rounds`` and,
    for the table, ``pt_add_rounds``), and keeps the per-row table in
    shared memory; ``k2_geometry`` gives its launch geometry.

The host keeps Go's accept set (see ``crypto/ed25519.py``): s is checked only
by ``sig[63] & 224``, A is decompressed with non-canonical y accepted (cached
per validator set), and a key that fails decompression is rejected.

Field elements are ten radix-2^25.5 limbs (``ops/fe.py``). The device tensors
are int32 holding uint32 bit patterns; the plain versions compute in int64.
A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.

``rlc_verify_batch`` is the one-MSM-per-batch route (``[verify]
ed25519_path = "msm"``): K1 hashes, K4 (``ops/ed25519_msm.py``) checks the
batch as one random linear combination, and a rejected batch is checked
row by row on K1 + K2, with host chunk RLCs only where that finds a
rejected row (``ed25519_msm.rlc_resolve``).
"""

from __future__ import annotations

import ctypes
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tendermint_tpu_torch.crypto import ed25519 as _ed
from tendermint_tpu_torch.device import DeviceLike, resolve_device
from tendermint_tpu_torch.libs import trace
from tendermint_tpu_torch.ops import _build, fe
from tendermint_tpu_torch.ops import sha512 as _sha

P = _ed.P
L_ORDER = _ed.L
NLIMB = fe.NLIMB
LANES = 128  # rows per CUDA block; buckets are multiples of it on the card
CPU_LANES = 8  # the plain version has no alignment constraint
NWIN = 64  # 4-bit windows covering s, h < 2^256
M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Constant tables
# ---------------------------------------------------------------------------


def _build_b_niels() -> np.ndarray:
    """(16, 3, 10) uint32: (y+x, y-x, 2dxy) limbs of [j]B, identity at 0."""
    out = np.zeros((16, 3, NLIMB), dtype=np.uint32)
    for j in range(16):
        x, y = _ed.pt_affine(_ed.pt_scalar_mult(_ed.B_EXT, j))
        out[j, 0] = fe.int_to_limbs((y + x) % P)
        out[j, 1] = fe.int_to_limbs((y - x) % P)
        out[j, 2] = fe.int_to_limbs(2 * _ed.D * x * y % P)
    return out


_B_NIELS = _build_b_niels()
# the ladder kernel's constant input: the niels table, then 2d
_CONSTS = np.concatenate(
    [_B_NIELS.reshape(-1), np.asarray(fe.int_to_limbs(_ed.D2), np.uint32)]
).astype(np.uint32)
NCONSTS = _CONSTS.shape[0]  # 490

# ---------------------------------------------------------------------------
# Host prologue: decompression cache, packing
# ---------------------------------------------------------------------------

_decompress_cache: dict = {}
_DECOMPRESS_CACHE_MAX = 1 << 16


def _decompress_neg_cached(pub: bytes) -> Optional[Tuple[List[int], List[int]]]:
    """(-x, y) limbs of pubkey A, or None when A fails decompression."""
    hit = _decompress_cache.get(pub, False)
    if hit is not False:
        return hit
    xy = _ed._decompress_xy(pub)
    out = None if xy is None else (
        fe.int_to_limbs((P - xy[0]) % P), fe.int_to_limbs(xy[1]))
    if len(_decompress_cache) >= _DECOMPRESS_CACHE_MAX:
        _decompress_cache.clear()
    _decompress_cache[pub] = out
    return out


def _bits_to_limbs(bits: np.ndarray) -> np.ndarray:
    """(N, >=255) little-endian bit matrix -> (N, 10) uint32 limbs."""
    limbs = np.zeros((bits.shape[0], NLIMB), dtype=np.uint32)
    for i in range(NLIMB):
        w = fe.WIDTHS[i]
        weights = (1 << np.arange(w, dtype=np.uint64))
        limbs[:, i] = bits[:, fe.OFFS[i]: fe.OFFS[i] + w].astype(np.uint64) @ weights
    return limbs


def _bytes_to_raw_limbs(r32: np.ndarray) -> np.ndarray:
    """(N, 32) uint8 little-endian -> (N, 10) raw limbs of the low 255 bits."""
    return _bits_to_limbs(np.unpackbits(r32, axis=1, bitorder="little"))


_valset_cache: dict = {}
_VALSET_CACHE_MAX = 64


def _decompress_valset(pubs: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(N, 32) pubkeys -> (neg_ax, ay, valid), neg_ax/ay (N, 10) uint32;
    cached per validator set (commit verification repeats it every height)."""
    key = hashlib.sha256(pubs.tobytes()).digest()
    hit = _valset_cache.get(key)
    if hit is not None:
        return hit
    n = pubs.shape[0]
    neg_ax = np.zeros((n, NLIMB), dtype=np.uint32)
    ay = np.zeros((n, NLIMB), dtype=np.uint32)
    valid = np.ones((n,), dtype=bool)
    for i in range(n):
        dec = _decompress_neg_cached(pubs[i].tobytes())
        if dec is None:
            valid[i] = False
        else:
            neg_ax[i], ay[i] = dec
    if len(_valset_cache) >= _VALSET_CACHE_MAX:
        _valset_cache.clear()
    _valset_cache[key] = (neg_ax, ay, valid)
    return neg_ax, ay, valid


def valset_from_jax(neg_ax: np.ndarray, ay: np.ndarray, valid: np.ndarray):
    """The JAX package's (N, 20) radix-2^13 key material -> this port's
    (N, 10) radix-2^25.5 layout (same values, same validity)."""

    def convert(limbs13: np.ndarray) -> np.ndarray:
        limbs13 = np.asarray(limbs13, dtype=np.uint32)
        bits = ((limbs13[:, :, None] >> np.arange(13, dtype=np.uint32)) & 1)
        return _bits_to_limbs(bits.reshape(limbs13.shape[0], -1).astype(np.uint8))

    return convert(neg_ax), convert(ay), np.asarray(valid, dtype=bool).copy()


def _pad_rows(a: np.ndarray, b: int) -> np.ndarray:
    if a.shape[0] == b:
        return a
    return np.concatenate(
        [a, np.zeros((b - a.shape[0],) + a.shape[1:], dtype=a.dtype)], axis=0
    )


def _bucket(n: int, lanes: int = LANES) -> int:
    """Padded batch size: powers of two from ``lanes`` to 4096, then
    multiples of 2048 (10,000 rows -> 10,240)."""
    b = lanes
    while b < n and b < 4096:
        b *= 2
    if n <= b:
        return b
    return ((n + 2047) // 2048) * 2048


def _put(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 (or smaller) numpy array -> int32 tensor of its bit patterns."""
    a = np.ascontiguousarray(np.asarray(a).astype(np.uint32))
    return torch.from_numpy(a.view(np.int32)).to(device)


_dev_valset_cache: dict = {}
_DEV_VALSET_CACHE_MAX = 32
_dev_consts: Dict[torch.device, torch.Tensor] = {}


def _consts_on(device: torch.device) -> torch.Tensor:
    c = _dev_consts.get(device)
    if c is None:
        c = _dev_consts[device] = _put(_CONSTS, device)
    return c


def _upload_valset(pubs, neg_ax, ay, b, device: torch.device):
    """Device-resident (negax (10, b), ay (10, b), pub_words (b, 8)) padded
    to bucket b, cached per (validator set, bucket, device)."""
    key = (hashlib.sha256(pubs.tobytes()).digest(), b, device)
    hit = _dev_valset_cache.get(key)
    if hit is not None:
        return hit
    pub_words = np.ascontiguousarray(pubs).view("<u4")
    entry = (
        _put(_pad_rows(neg_ax, b).T, device),
        _put(_pad_rows(ay, b).T, device),
        _put(_pad_rows(pub_words, b), device),
    )
    if len(_dev_valset_cache) >= _DEV_VALSET_CACHE_MAX:
        _dev_valset_cache.clear()
    _dev_valset_cache[key] = entry
    return entry


def pack_variable_words(pubs, msgs, sigs, ln: int, b: int):
    """(tmpl, vrows, vwords): the padded SHA-512 input of batch row 0 as
    big-endian words, the word rows (>= 16) that vary across the batch, and
    each row's words there. Rows 0..15 (R || A) come from the signature and
    key words on the device. With no varying byte, vrows is [16]; vrows and
    vwords pad to a power of two by repeating the first row, so the device
    scatter sees duplicate indices with identical values."""
    n = pubs.shape[0]
    total = 64 + ln
    rows = _sha.nblocks(total) * 32
    m = (
        np.frombuffer(b"".join(msgs), dtype=np.uint8).reshape(n, ln)
        if ln else np.zeros((n, 0), np.uint8)
    )
    row0 = np.concatenate([sigs[0, :32], pubs[0], m[0]])[None, :]
    tmpl = _sha.be_words(_sha.pad(row0))[0]
    diff_cols = np.nonzero((m != m[0]).any(axis=0))[0]
    vrows = np.unique((64 + diff_cols) // 4).astype(np.int32)
    if vrows.size == 0:
        vrows = np.array([16], np.int32)  # row 16 always exists (rows >= 32)
    k = int(vrows.size)
    k_pad = 1 << (k - 1).bit_length()
    mpad = np.zeros((b, (rows - 16) * 4), dtype=np.uint8)
    mpad[:n, : total - 64] = m
    mpad[:, total - 64] = 0x80
    mpad[:, -16:] = np.frombuffer((total * 8).to_bytes(16, "big"), np.uint8)
    vwords = _sha.be_words(mpad)[:, vrows - 16]
    if k_pad > k:
        vrows = np.concatenate([vrows, np.full((k_pad - k,), vrows[0], np.int32)])
        vwords = np.concatenate(
            [vwords, np.tile(vwords[:, :1], (1, k_pad - k))], axis=1
        )
    return tmpl, vrows, vwords


# ---------------------------------------------------------------------------
# Plain version of K1 (prologue)
# ---------------------------------------------------------------------------


def _int16_limbs(x: int, n: int) -> List[int]:
    return [(x >> (16 * i)) & 0xFFFF for i in range(n)]


# Barrett mod L in radix 2^16: k = 16 limbs (L < 2^256), digest < 2^512
_MU16 = _int16_limbs((1 << 512) // L_ORDER, 17)
_L16 = _int16_limbs(L_ORDER, 17)
_LC16 = _int16_limbs((1 << 272) - L_ORDER, 17)  # 2^272 - L


def _u32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & M32


def _bswap32(x: torch.Tensor) -> torch.Tensor:
    return (((x >> 24) & 0xFF) | ((x >> 8) & 0xFF00)
            | ((x << 8) & 0xFF0000) | ((x << 24) & 0xFF000000))


def _carry16(cols: List[torch.Tensor]) -> Tuple[List[torch.Tensor], torch.Tensor]:
    out = []
    carry = cols[0] * 0
    for v in cols:
        v = v + carry
        out.append(v & 0xFFFF)
        carry = v >> 16
    return out, carry


def _mul_const16(cols: List[torch.Tensor], const: Sequence[int]) -> List[torch.Tensor]:
    """Columns times a constant limb vector, carried to 16-bit limbs
    (column sums < 17 * 2^32)."""
    prod = [cols[0] * 0 for _ in range(len(cols) + len(const))]
    for j, cj in enumerate(const):
        if cj:
            for i, v in enumerate(cols):
                prod[i + j] = prod[i + j] + v * cj
    return _carry16(prod)[0]


def _mod_l16(x: List[torch.Tensor]) -> List[torch.Tensor]:
    """32 16-bit limbs of a 512-bit integer -> 16 limbs of it mod L (HAC
    14.42 Barrett: r < 3L before the two conditional subtractions)."""
    q3 = _mul_const16(x[15:], _MU16)[17:]
    q3l = _mul_const16(q3, _L16)[:17]
    r = []
    borrow = x[0] * 0
    for i in range(17):
        v = x[i] - q3l[i] - borrow
        borrow = (v < 0).to(torch.int64)
        r.append(v & 0xFFFF)
    for _ in range(2):
        t, carry = _carry16([r[i] + _LC16[i] for i in range(17)])
        ge = carry > 0
        r = [torch.where(ge, t[i], r[i]) for i in range(17)]
    return r[:16]


def _digest_limbs16(state) -> List[torch.Tensor]:
    """SHA-512 state (8 (hi, lo) pairs) -> 32 16-bit limbs of the digest
    read as a little-endian integer."""
    out = []
    for j in range(32):
        hi, lo = state[j // 4]
        half = hi if (j % 4) < 2 else lo
        v = half >> (16 if j % 2 == 0 else 0)  # bytes 2j, 2j+1 of the digest
        out.append(((v & 0xFF) << 8 | ((v >> 8) & 0xFF)))
    return out


def _raw_limbs_from_words(w: List[torch.Tensor]) -> List[torch.Tensor]:
    """8 little-endian u32 words -> 10 raw limbs of the low 255 bits."""
    out = []
    for i in range(NLIMB):
        off, width = fe.OFFS[i], fe.WIDTHS[i]
        wi, sh = divmod(off, 32)
        v = w[wi] >> sh
        if sh + width > 32:
            v = v | (w[wi + 1] << (32 - sh))
        out.append(v & fe.MASKS[i])
    return out


def prologue_ref(tmpl, vidx, vwords, pub_words, sig_words):
    """Plain version of K1, same inputs and outputs: tmpl (rows,), vidx (k,),
    vwords (b, k), pub_words (b, 8), sig_words (b, 16), all u32 bit patterns;
    returns int32 digs (64, b), digh (64, b), rlimb (10, b), rsign (1, b)."""
    b = sig_words.shape[0]
    rows = tmpl.shape[0]
    sw = _u32(sig_words)
    mw = _u32(tmpl).unsqueeze(0).expand(b, rows).clone()
    mw[:, 0:8] = _bswap32(sw[:, 0:8])
    mw[:, 8:16] = _bswap32(_u32(pub_words))
    mw[:, vidx.to(torch.int64)] = _u32(vwords)  # duplicates carry equal values
    h = _mod_l16(_digest_limbs16(_sha.sha512_words(mw)))
    s_words = [sw[:, 8 + j] for j in range(8)]
    digh, digs = [], []
    for t in range(NWIN):  # MSB-first 4-bit windows
        k = NWIN - 1 - t
        digh.append((h[k // 4] >> (4 * (k % 4))) & 15)
        digs.append((s_words[k // 8] >> (4 * (k % 8))) & 15)
    rlimb = _raw_limbs_from_words([sw[:, j] for j in range(8)])
    rsign = sw[:, 7] >> 31
    return (torch.stack(digs).to(torch.int32), torch.stack(digh).to(torch.int32),
            torch.stack(rlimb).to(torch.int32), rsign.unsqueeze(0).to(torch.int32))


# ---------------------------------------------------------------------------
# Plain version of K2 (ladder): extended coordinates, complete formulas
# ---------------------------------------------------------------------------


def _pt_double(p):
    X1, Y1, Z1, _ = p
    A = fe.sq(X1)
    B = fe.sq(Y1)
    ZZ = fe.sq(Z1)
    C = fe.add(ZZ, ZZ)
    H = fe.add(A, B)
    E = fe.sub(H, fe.sq(fe.add(X1, Y1)))
    G = fe.sub(A, B)
    F = fe.add(C, G)
    return fe.mul(E, F), fe.mul(G, H), fe.mul(F, G), fe.mul(E, H)


def _pt_finish(A, B, C, Dv):
    E = fe.sub(B, A)
    F = fe.sub(Dv, C)
    G = fe.add(Dv, C)
    H = fe.add(B, A)
    return fe.mul(E, F), fe.mul(G, H), fe.mul(F, G), fe.mul(E, H)


def _pt_add(p, q, d2):
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = fe.mul(fe.sub(Y1, X1), fe.sub(Y2, X2))
    B = fe.mul(fe.add(Y1, X1), fe.add(Y2, X2))
    C = fe.mul(fe.mul(T1, d2), T2)
    Dv = fe.mul(fe.add(Z1, Z1), Z2)
    return _pt_finish(A, B, C, Dv)


def _pt_add_cached(p, c):
    """Add a cached point (Y+X, Y-X, Z, 2d*T)."""
    X1, Y1, Z1, T1 = p
    ypx, ymx, Z2, t2d = c
    A = fe.mul(fe.sub(Y1, X1), ymx)
    B = fe.mul(fe.add(Y1, X1), ypx)
    C = fe.mul(T1, t2d)
    Dv = fe.mul(fe.add(Z1, Z1), Z2)
    return _pt_finish(A, B, C, Dv)


def _pt_madd(p, ypx, ymx, t2d):
    """Mixed add of an affine niels point (y+x, y-x, 2dxy), Z = 1."""
    X1, Y1, Z1, T1 = p
    A = fe.mul(fe.sub(Y1, X1), ymx)
    B = fe.mul(fe.add(Y1, X1), ypx)
    C = fe.mul(T1, t2d)
    return _pt_finish(A, B, C, fe.add(Z1, Z1))


def ladder_fe_ops(nwin: int = NWIN) -> tuple:
    """(multiplications, squarings) per row in K2 (and in ``ladder_ref``):
    T of -A, the table (7 doublings, 7 adds, 16 cached conversions), per
    window 4 doublings + a mixed add + a cached add, then Z^-1 and x, y.
    A doubling is 4 squarings and 4 multiplications."""
    muls = 1 + 7 * 4 + 7 * 9 + 16 + nwin * (4 * 4 + 7 + 8) + fe.INV_MULS + 2
    squarings = 7 * 4 + nwin * 4 * 4 + fe.INV_SQUARINGS
    return muls, squarings


def ladder_point_ref(consts, negax, ay, digs, digh, nwin: int = NWIN):
    """R' = [s]B + [h](-A) over ``nwin`` MSB-first windows, in extended
    coordinates: returns (X, Y, Z, T), each (b, 10) int64 carried limbs.
    consts (490,), negax/ay (10, b), digs/digh (nwin, b)."""
    consts = _u32(consts)
    niels = consts[: 16 * 3 * NLIMB].reshape(16, 3, NLIMB)
    d2 = consts[16 * 3 * NLIMB:]
    ax, ay = _u32(negax).T, _u32(ay).T
    digs, digh = _u32(digs), _u32(digh)
    one = fe.const(1, ax)
    zero = torch.zeros_like(ax)
    ident = (zero, one, one, zero)
    a1 = (ax, ay, one, fe.mul(ax, ay))
    tbl = [ident, a1]
    for j in range(2, 16):
        tbl.append(_pt_double(tbl[j // 2]) if j % 2 == 0
                   else _pt_add(tbl[j - 1], a1, d2))
    cached = [(fe.add(Y, X), fe.sub(Y, X), Z, fe.mul(T, d2)) for X, Y, Z, T in tbl]
    stacked = [torch.stack([c[i] for c in cached]) for i in range(4)]  # (16, b, 10)
    rows = torch.arange(ax.shape[0], device=ax.device)
    acc = ident
    for t in range(nwin):
        for _ in range(4):
            acc = _pt_double(acc)
        entry = niels[digs[t]]  # (b, 3, 10)
        acc = _pt_madd(acc, entry[:, 0], entry[:, 1], entry[:, 2])
        dh = digh[t]
        acc = _pt_add_cached(acc, tuple(s[dh, rows] for s in stacked))
    return acc


def _enc_words(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Canonical x, y (b, 10) -> (8, b) u32 words of enc = y | (x & 1) << 255."""
    words = [x[:, 0] * 0 for _ in range(8)]
    for i in range(NLIMB):
        wi, sh = divmod(fe.OFFS[i], 32)
        words[wi] = words[wi] | ((y[:, i] << sh) & M32)
        if sh + fe.WIDTHS[i] > 32:
            words[wi + 1] = words[wi + 1] | (y[:, i] >> (32 - sh))
    words[7] = words[7] | ((x[:, 0] & 1) << 31)
    return torch.stack(words)


def ladder_ref(consts, negax, ay, digs, digh, rlimb, rsign, nwin: int = NWIN):
    """Plain version of K2, same inputs and outputs: returns int32
    ok (b,) and the encoding of R' as (8, b) u32 words."""
    if digs.shape[0] != nwin or digh.shape[0] != nwin:
        raise ValueError(f"digit rows {digs.shape[0]} != nwin {nwin}")
    X, Y, Z, _ = ladder_point_ref(consts, negax, ay, digs, digh, nwin)
    zinv = fe.inv(Z)
    x = fe.canonical(fe.mul(X, zinv))
    y = fe.canonical(fe.mul(Y, zinv))
    ok = (y == _u32(rlimb).T).all(dim=1) & ((x[:, 0] & 1) == _u32(rsign)[0])
    return ok.to(torch.int32), _enc_words(x, y).to(torch.int32)


# ---------------------------------------------------------------------------
# K2's two-lane schedule. Each round lists a point formula's independent
# products (operand names) in slot order: lane q of a row computes product
# 2 s + q in slot s. Between rounds each lane computes only the linear
# values its own next products read, and the lanes trade single values.
# A slot whose products are all squares uses the 55-product squaring.
# Every formula ends with lane 0 holding X, T and Y, lane 1 Z, Y and T,
# which is what every formula's first round reads. The functions below
# evaluate the schedule on the plain field ops; each equals its one-lane
# formula limb for limb.
# ---------------------------------------------------------------------------

LANES_PER_ROW = 2  # lanes of a warp that serve one signature row, in K2 and K3
K2_ROWS_PER_BLOCK = 16  # rows a block serves: one warp

_FINISH = (("E", "H"), ("G", "F"), ("E", "F"), ("G", "H"))  # T3 | Z3, X3 | Y3
DOUBLE_ROUNDS = ((("X", "X"), ("Y", "Y"), ("X+Y", "X+Y"), ("Z", "Z")), _FINISH)
MADD_ROUNDS = ((("Y-X", "ymx"), ("T", "t2d"), ("Y+X", "ypx")), _FINISH)
CACHED_ROUNDS = ((("Y-X", "ymx"), ("T", "t2d"), ("Y+X", "ypx"), ("2Z", "Z2")), _FINISH)


def lane_slots(nprod: int) -> List[List[int]]:
    """[lane][slot] -> the product of a round a lane computes."""
    return [list(range(q, nprod, LANES_PER_ROW)) for q in range(LANES_PER_ROW)]


def run_round(envs: Sequence[dict], round_, field=fe) -> List[list]:
    """One round as the kernel (K2 or K3) runs it: each lane its slots'
    products, from the values that lane holds, over the field module
    ``field``."""
    out = []
    for q, slots in enumerate(lane_slots(len(round_))):
        mine = []
        for k in slots:
            a, b = round_[k]
            squares = all(x == y for x, y in round_[k - q: k - q + LANES_PER_ROW])
            mine.append(field.sq(envs[q][a]) if squares else field.mul(envs[q][a], envs[q][b]))
        out.append(mine)
    return out


def _last_round(E, F, G, H):
    """Round 2 of every formula: lane 0 holds E, H and F, lane 1 F, G and
    H; they compute E H, E F | G F, G H (T3, X3 | Z3, Y3) and trade
    T3 | Y3."""
    envs = [{"E": E, "H": H, "F": F}, {"G": G, "F": F, "H": H}]
    (T3, X3), (Z3, Y3) = run_round(envs, _FINISH)
    return X3, Y3, Z3, T3


def _finish_rounds(A, B, C, D):
    """``_pt_finish`` in K2's schedule: lane 0 forms E, H from A, B, lane 1
    F, G from C, D, and they trade H | F."""
    return _last_round(fe.sub(B, A), fe.sub(D, C), fe.add(D, C), fe.add(B, A))


def pt_double_rounds(p):
    """``_pt_double`` in K2's schedule: lane 0 squares X and X+Y, lane 1 Y
    and Z; they trade A | B, then lane 0 forms E = H - S and lane 1
    F = 2 ZZ + G, and they trade E | F."""
    X, Y, Z, _ = p
    envs = [{"X": X, "X+Y": fe.add(X, Y)}, {"Y": Y, "Z": Z}]
    (A, S), (B, ZZ) = run_round(envs, DOUBLE_ROUNDS[0])
    G, H = fe.sub(A, B), fe.add(A, B)  # both lanes
    E = fe.sub(H, S)  # lane 0
    F = fe.add(G, fe.add(ZZ, ZZ))  # lane 1
    return _last_round(E, F, G, H)


def pt_add_cached_rounds(p, c):
    """``_pt_add_cached`` in K2's schedule: lane 0 computes (Y-X) ymx and
    (Y+X) ypx, lane 1 T t2d and 2Z Z2."""
    X, Y, Z, T = p
    ypx, ymx, Z2, t2d = c
    envs = [{"Y-X": fe.sub(Y, X), "Y+X": fe.add(Y, X), "ymx": ymx, "ypx": ypx},
            {"T": T, "t2d": t2d, "2Z": fe.add(Z, Z), "Z2": Z2}]
    (A, B), (C, D) = run_round(envs, CACHED_ROUNDS[0])
    return _finish_rounds(A, B, C, D)


def pt_madd_rounds(p, ypx, ymx, t2d):
    """``_pt_madd`` in K2's schedule: the cached add's rounds, where lane 1
    keeps 2Z (the niels entry's Z is 1) in place of a second product."""
    X, Y, Z, T = p
    envs = [{"Y-X": fe.sub(Y, X), "Y+X": fe.add(Y, X), "ymx": ymx, "ypx": ypx},
            {"T": T, "t2d": t2d}]
    (A, B), (C,) = run_round(envs, MADD_ROUNDS[0])
    return _finish_rounds(A, B, C, fe.add(Z, Z))


def pt_add_rounds(p, q, d2):
    """``_pt_add`` (the table's odd entries, [j-1](-A) + (-A)) in K2's
    schedule: the cached add's first round with lane 0's operands Y2-X2 and
    Y2+X2 and lane 1's 2d and Z2, then one slot in which lane 1 computes
    C = (T 2d) T2 (lane 0's product of that slot is not used)."""
    X, Y, Z, T = p
    X2, Y2, Z2, T2 = q
    envs = [{"Y-X": fe.sub(Y, X), "Y+X": fe.add(Y, X),
             "ymx": fe.sub(Y2, X2), "ypx": fe.add(Y2, X2)},
            {"T": T, "t2d": d2, "2Z": fe.add(Z, Z), "Z2": Z2}]
    (A, B), (Td, D) = run_round(envs, CACHED_ROUNDS[0])
    return _finish_rounds(A, B, fe.mul(Td, T2), D)


def sq_split(i: int, j: int) -> Tuple[int, int]:
    """K2's squaring: the factors by which it multiplies a_i and a_j
    (i <= j) before their 32x32 -> 64 product, so that the product is the
    term fe.mul(a, a) puts in column (i + j) % 10: W[i][j] a_i a_j, twice
    for i != j. The left factor is 1 or 2, the right 1, 2, 19 or 38, so
    neither operand overflows 32 bits (76 on an even limb would)."""
    wrap = 19 if i + j >= NLIMB else 1
    if i == j:
        return (2 if i % 2 else 1), wrap
    return 2, (2 if i % 2 and j % 2 else 1) * wrap


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

# launches per kernel: each wrapper adds one where it launches its kernel
launches: Dict[str, int] = {"ed25519_prologue": 0, "ed25519_ladder": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # tmpl, rows, vidx, k, vwords, pub_words, sig_words, digs, digh, rlimb,
    # rsign, b, lanes_per_row, rows_per_block, blocks, smem_bytes, stream
    "ed25519_prologue": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P] + [_I] * 5 + [_P],
    # consts, negax, ay, digs, digh, rlimb, rsign, ok, renc, b, nwin,
    # lanes_per_row, rows_per_block, blocks, smem_bytes, stream
    "ed25519_ladder": [_P] * 9 + [_I] * 6 + [_P],
}
_fns: dict = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _kernel_fn(name: str, argtypes, lib: Optional[str] = None):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load(lib or name), name + "_launch")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _on_cpu(tensors) -> bool:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...]) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: dtype {t.dtype}, want torch.int32")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def launch_kernel(name: str, argtypes, counts: Dict[str, int],
                  dev: torch.device, *args, lib: Optional[str] = None) -> None:
    """Launch kernel ``name`` (the library ``lib``'s ``name_launch``; the
    library of that name by default) on ``dev``'s current stream and add
    one to ``counts[name]``; raises if the launch failed."""
    fn = _kernel_fn(name, argtypes, lib)
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    counts[name] += 1
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _launch(name: str, dev: torch.device, *args) -> None:
    launch_kernel(name, _SIGNATURES[name], launches, dev, *args)


def prologue(tmpl, vidx, vwords, pub_words, sig_words):
    """K1. CPU tensors take ``prologue_ref``; CUDA tensors launch the kernel
    on the current stream (no synchronisation)."""
    ins = (tmpl, vidx, vwords, pub_words, sig_words)
    if _on_cpu(ins):
        return prologue_ref(*ins)
    b, dev = sig_words.shape[0], tmpl.device
    outs = tuple(torch.empty((n, b), dtype=torch.int32, device=dev)
                 for n in (NWIN, NWIN, NLIMB, 1))
    prologue_into(ins, outs)
    return outs


K1_ROWS_PER_BLOCK = 64  # rows (threads) a K1 block serves


def k1_geometry(b: int) -> Tuple[int, int, int, int]:
    """(lanes_per_row, rows_per_block, blocks, smem_bytes) of K1 over b
    rows: one thread a row, one block per 64 rows (the last one ragged; 160
    blocks at b = 10,240, so that every SM of an H100 has work), and dynamic
    shared memory for one SHA-512 block's staged message (32 u32 a row)."""
    if b <= 0:
        raise ValueError(f"bad batch size {b}")
    rpb = K1_ROWS_PER_BLOCK
    return 1, rpb, -(-b // rpb), 32 * 4 * rpb


def prologue_into(ins, outs) -> None:
    """Launch K1 on CUDA inputs ``ins`` (``prologue``'s five) into the
    given int32 outputs digs (64, b), digh (64, b), rlimb (10, b), rsign
    (1, b); the kernel writes rows below b only."""
    tmpl, vidx, vwords, pub_words, sig_words = ins
    rows, k, b = tmpl.shape[0], vidx.shape[0], sig_words.shape[0]
    if rows % 32 or rows < 32 or b == 0 or k == 0:
        raise ValueError(f"bad sizes rows={rows} k={k} b={b}")
    for nm, t, shp in (("tmpl", tmpl, (rows,)), ("vidx", vidx, (k,)),
                       ("vwords", vwords, (b, k)), ("pub_words", pub_words, (b, 8)),
                       ("sig_words", sig_words, (b, 16))):
        _check(nm, t, shp)
    for nm, t, n in zip(("digs", "digh", "rlimb", "rsign"), outs, (NWIN, NWIN, NLIMB, 1)):
        _check(nm, t, (n, b))
    if _on_cpu((*ins, *outs)):
        raise ValueError("prologue_into launches the kernel: CUDA tensors only")
    _launch("ed25519_prologue", tmpl.device, tmpl.data_ptr(), rows, vidx.data_ptr(), k,
            vwords.data_ptr(), pub_words.data_ptr(), sig_words.data_ptr(),
            *(t.data_ptr() for t in outs), b, *k1_geometry(b))


def k2_geometry(b: int) -> Tuple[int, int, int, int]:
    """(lanes_per_row, rows_per_block, blocks, smem_bytes) of K2 over b
    rows: one block per 16 rows (the last one ragged), and dynamic shared
    memory for the constants (niels [0..15]B, 2d) and each of the block's
    rows' [0..15](-A) (16 entries of 40 words)."""
    if b <= 0:
        raise ValueError(f"bad batch size {b}")
    rpb = K2_ROWS_PER_BLOCK
    smem = (NCONSTS + 16 * 4 * NLIMB * rpb) * 4
    return LANES_PER_ROW, rpb, -(-b // rpb), smem


def ladder(consts, negax, ay, digs, digh, rlimb, rsign):
    """K2 over ``digs.shape[0]`` windows. CPU tensors take ``ladder_ref``;
    CUDA tensors launch the kernel on the current stream (no
    synchronisation). Returns int32 ok (b,), renc (8, b)."""
    ins = (consts, negax, ay, digs, digh, rlimb, rsign)
    if _on_cpu(ins):
        return ladder_ref(*ins, nwin=digs.shape[0])
    b, dev = negax.shape[1], negax.device
    ok = torch.empty((b,), dtype=torch.int32, device=dev)
    renc = torch.empty((8, b), dtype=torch.int32, device=dev)
    ladder_into(ins, ok, renc)
    return ok, renc


def ladder_into(ins, ok, renc) -> None:
    """Launch K2 on CUDA inputs ``ins`` (``ladder``'s seven) into the given
    int32 outputs ok (b,), renc (8, b); the kernel writes rows below b
    only."""
    consts, negax, ay, digs, digh, rlimb, rsign = ins
    nwin, b = digs.shape[0], negax.shape[1]
    if b == 0 or nwin == 0:
        raise ValueError(f"bad sizes b={b} nwin={nwin}")
    for nm, t, shp in (("consts", consts, (NCONSTS,)), ("negax", negax, (NLIMB, b)),
                       ("ay", ay, (NLIMB, b)), ("digs", digs, (nwin, b)),
                       ("digh", digh, (nwin, b)), ("rlimb", rlimb, (NLIMB, b)),
                       ("rsign", rsign, (1, b)), ("ok", ok, (b,)), ("renc", renc, (8, b))):
        _check(nm, t, shp)
    if _on_cpu((*ins, ok, renc)):
        raise ValueError("ladder_into launches the kernel: CUDA tensors only")
    _launch("ed25519_ladder", negax.device, *(t.data_ptr() for t in ins),
            ok.data_ptr(), renc.data_ptr(), b, nwin, *k2_geometry(b))


# ---------------------------------------------------------------------------
# Device verify and the host entry point
# ---------------------------------------------------------------------------


def _device_verify_packed(consts, negax, ay, pub_words, sig_words, tmpl, vidx,
                          vwords) -> torch.Tensor:
    """K1 then K2 on device-resident inputs; (b,) int32 verdicts."""
    digs, digh, rlimb, rsign = prologue(tmpl, vidx, vwords, pub_words, sig_words)
    ok, _ = ladder(consts, negax, ay, digs, digh, rlimb, rsign)
    return ok


def packed_inputs(pubs, msgs, sigs, neg_ax, ay, valid, ln: int,
                  device: torch.device):
    """Everything ``_device_verify_packed`` takes for one uniform-length
    group, on ``device``; returns (inputs tuple, bucket)."""
    n = pubs.shape[0]
    lanes = LANES if device.type == "cuda" else CPU_LANES
    b = _bucket(n, lanes)
    sig_words = np.ascontiguousarray(sigs).view("<u4").copy()
    sig_words[~valid] = 0  # keep device work defined on rejected rows
    tmpl, vrows, vwords = pack_variable_words(pubs, msgs, sigs, ln, b)
    negax_d, ay_d, pubw_d = _upload_valset(pubs, neg_ax, ay, b, device)
    inputs = (
        _consts_on(device), negax_d, ay_d, pubw_d,
        _put(_pad_rows(sig_words, b), device),
        _put(tmpl, device), _put(vrows, device), _put(vwords, device),
    )
    return inputs, b


def _verify_uniform(pubs, msgs, sigs, neg_ax, ay, valid, ln, device):
    n = pubs.shape[0]
    inputs, _ = packed_inputs(pubs, msgs, sigs, neg_ax, ay, valid, ln, device)
    ok = _device_verify_packed(*inputs)[:n].cpu().numpy() != 0
    return ok & valid


def verify_batch(pubs: np.ndarray, msgs: Sequence[bytes], sigs: np.ndarray,
                 device: DeviceLike = None) -> np.ndarray:
    """Go-exact batched verify: (N, 32) pubkeys, N messages, (N, 64)
    signatures -> (N,) bool. Runs on ``cuda`` unless ``device="cpu"``."""
    dev = resolve_device(device)
    pubs = np.ascontiguousarray(pubs, dtype=np.uint8)
    sigs = np.ascontiguousarray(sigs, dtype=np.uint8)
    n = pubs.shape[0]
    if n == 0:
        return np.zeros((0,), dtype=bool)
    neg_ax, ay, valid = _decompress_valset(pubs)
    valid = valid & ((sigs[:, 63] & 224) == 0)  # Go's only s range check
    lens = np.array([len(m) for m in msgs])
    out = np.zeros((n,), dtype=bool)
    for ln in np.unique(lens):
        idx = np.nonzero(lens == ln)[0]
        out[idx] = _verify_uniform(
            pubs[idx], [bytes(msgs[i]) for i in idx], sigs[idx],
            neg_ax[idx], ay[idx], valid[idx], int(ln), dev,
        )
    return out


# ---------------------------------------------------------------------------
# The RLC entry: one MSM a batch (ops/ed25519_msm.py, K4)
# ---------------------------------------------------------------------------


def rlc_seed(pubs: np.ndarray, sigs: np.ndarray) -> int:
    """Deterministic RLC coefficient seed, the reference's: SHA-256 over
    b"ed25519-rlc" + the batch's keys and signatures, the first 8 bytes
    little-endian. The coefficients need only be unpredictable before the
    signatures are fixed, so a replay of the same batch draws the same."""
    dig = hashlib.sha256(b"ed25519-rlc" + pubs.tobytes() + sigs.tobytes()).digest()
    return int.from_bytes(dig[:8], "little")


def _prologue_h(pubs: np.ndarray, msgs: Sequence[bytes], sigs: np.ndarray,
                device: torch.device) -> List[int]:
    """h = SHA-512(R || A || M) mod L for every row, read from K1's digh
    output: one K1 call a message-length group, its 64 MSB-first 4-bit
    digits reassembled into host ints for the MSM schedule."""
    n = pubs.shape[0]
    lanes = LANES if device.type == "cuda" else CPU_LANES
    lens = np.array([len(m) for m in msgs])
    hs = [0] * n
    for ln in np.unique(lens):
        idx = np.nonzero(lens == ln)[0]
        k = idx.size
        b = _bucket(k, lanes)
        p, s = pubs[idx], sigs[idx]
        tmpl, vrows, vwords = pack_variable_words(p, [bytes(msgs[i]) for i in idx], s,
                                                  int(ln), b)
        _, digh, _, _ = prologue(
            _put(tmpl, device), _put(vrows, device), _put(vwords, device),
            _put(_pad_rows(np.ascontiguousarray(p).view("<u4"), b), device),
            _put(_pad_rows(np.ascontiguousarray(s).view("<u4"), b), device))
        d = (digh[:, :k].cpu().numpy().T & 15).astype(np.uint8)  # (k, 64) MSB first
        be = (d[:, 0::2] << 4) | d[:, 1::2]
        for j, i in enumerate(idx):
            hs[i] = int.from_bytes(be[j].tobytes(), "big")
    return hs


def rlc_verify_batch(pubs: np.ndarray, msgs: Sequence[bytes], sigs: np.ndarray, *,
                     device: DeviceLike = None, seed: Optional[int] = None) -> np.ndarray:
    """Go-exact batched verify through one multi-scalar multiplication:
    the host parse keeps Go's edges (``crypto.ed25519._parse_batch``), K1
    hashes (``_prologue_h``), K4 checks the whole batch as one random
    linear combination, and a rejected batch goes through K1 + K2
    (``verify_batch``) in one call, with the reference's host chunk RLCs
    on the chunks that hold a rejected row (``ed25519_msm.rlc_resolve``).
    Same contract as ``verify_batch``; ``seed`` pins the coefficients
    (default ``rlc_seed``: a replay draws the same)."""
    from tendermint_tpu_torch.ops import ed25519_msm as _msm

    dev = resolve_device(device)
    pubs = np.ascontiguousarray(pubs, dtype=np.uint8)
    sigs = np.ascontiguousarray(sigs, dtype=np.uint8)
    n = pubs.shape[0]
    if n == 0:
        return np.zeros((0,), dtype=bool)
    items = [(pubs[i].tobytes(), bytes(msgs[i]), sigs[i].tobytes()) for i in range(n)]
    with trace.span("msm.parse", n=n):
        parsed, out = _ed._parse_batch(items, compute_h=False)
    if parsed:
        with trace.span("msm.prologue_h", n=n):
            hs = _prologue_h(pubs, msgs, sigs, dev)
        parsed = [(i, na, nr, hs[i], s) for (i, na, nr, _h, s) in parsed]
    if seed is None:
        seed = rlc_seed(pubs, sigs)

    def ladder_fn(idx: List[int]) -> np.ndarray:
        return verify_batch(pubs[idx], [msgs[i] for i in idx], sigs[idx], device=dev)

    _msm.rlc_resolve(parsed, out, ladder_fn, seed=seed, device=dev)
    return np.asarray(out, dtype=bool)
