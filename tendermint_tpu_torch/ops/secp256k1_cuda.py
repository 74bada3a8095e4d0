"""Batched secp256k1 ECDSA verification on the H100: host prologue, the
plain version of the ladder kernel, and its wrapper.

Counterpart of the JAX package's ``ops/secp256k1_pallas.py`` (with the host
prologue of ``ops/secp256k1_verify.py``). Per signature row the host parses
the strict DER, checks the range of r and s and the low-s rule, computes
w = s^-1 mod n, u1 = e w and u2 = r w, and decompresses the key (cached);
then one hand-written CUDA kernel (``csrc/secp256k1_ladder.cu``), K3
(``ladder``), computes R = u1 G + u2 Q by windowed Straus over 64 MSB-first
4-bit windows (4 doublings, one complete add from the constant projective
table [0..15]G and one from a per-row table [0..15]Q built by 15 complete
additions through the identity) and accepts iff
Z != 0 and (X = r Z or (r + n < p and X = (r + n) Z)) mod p: x(R) mod n = r
without an inversion. The kernel serves each row with two lanes of a warp,
which split each point formula's independent products between them
(``ADD_ROUNDS``, ``DOUBLE_ROUNDS``; ``pt_add_rounds`` and
``pt_double_rounds`` evaluate that schedule on the plain field ops), and
keeps the per-row table in shared memory; ``k3_geometry`` gives its launch
geometry.

Additions use Renes-Costello-Batina 2016 algorithm 7 (complete, a = 0, 12
multiplications and 2 by b3 = 21), doublings its algorithm 9 (6
multiplications, 2 squarings and 1 by b3). Field elements are ten 26-bit
limbs (``ops/fe_secp256k1.py``); the device tensors are int32 holding uint32
bit patterns, the plain version computes in int64.

Rows the host decides ("forced") are kept exactly as the JAX package keeps
them: a key that does not decompress, DER that does not parse, r or s out
of range, or a high s give 0; when u1 or u2 is 0 the host oracle
``crypto.secp256k1.verify`` gives the verdict. This is the reference's own
design (the ladder degenerates to a single scalar there), not a fallback:
honest signatures never reach it. A wrapper runs the plain version only for
tensors on the CPU; for CUDA tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tendermint_tpu_torch.crypto import secp256k1 as _s
from tendermint_tpu_torch.device import DeviceLike, resolve_device
from tendermint_tpu_torch.ops import ed25519_cuda as _ec
from tendermint_tpu_torch.ops import fe_secp256k1 as F

P = _s.P
N = _s.N
NLIMB = F.NLIMB
LANES = _ec.LANES  # rows per CUDA block
CPU_LANES = _ec.CPU_LANES
NWIN = 64  # 4-bit windows over 256-bit scalars

_u32 = _ec._u32
_put = _ec._put
_bucket = _ec._bucket  # the JAX package shares ed25519's bucket here too

# ---------------------------------------------------------------------------
# Constant table: [0..15]G projective, identity (0:1:0) at digit 0
# ---------------------------------------------------------------------------


def _build_g_table() -> np.ndarray:
    """(16, 3, 10) uint32: X, Y, Z limbs of j G (Z = 1), identity at 0."""
    out = np.zeros((16, 3, NLIMB), dtype=np.uint32)
    out[0, 1] = F.int_to_limbs(1)
    for j in range(1, 16):
        x, y = _s._to_affine(_s._jmul(_s._G, j))
        out[j, 0] = F.int_to_limbs(x)
        out[j, 1] = F.int_to_limbs(y)
        out[j, 2] = F.int_to_limbs(1)
    return out


_G_TABLE = _build_g_table()
_CONSTS = _G_TABLE.reshape(-1)  # the kernel's constant input
NCONSTS = _CONSTS.shape[0]  # 480

# ---------------------------------------------------------------------------
# Host prologue (the JAX package's secp256k1_verify.prep_item, verbatim)
# ---------------------------------------------------------------------------

_decompress_cache: dict = {}
_DECOMPRESS_CACHE_MAX = 1 << 16


def _decompress_cached(pub: bytes) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(x, y) limbs of a 33-byte compressed key, or None."""
    hit = _decompress_cache.get(pub, False)
    if hit is not False:
        return hit
    xy = _s.decompress_pubkey(pub)
    out = None if xy is None else (
        np.asarray(F.int_to_limbs(xy[0]), np.uint32),
        np.asarray(F.int_to_limbs(xy[1]), np.uint32))
    if len(_decompress_cache) >= _DECOMPRESS_CACHE_MAX:
        _decompress_cache.clear()
    _decompress_cache[pub] = out
    return out


def prep_item(pubkey: bytes, digest: bytes, sig: bytes):
    """Host prologue for one signature: ("forced", 0|1) for a row the host
    decides, else ("kernel", (qx, qy), u1, u2, r)."""
    Q = _decompress_cached(pubkey)
    parsed = _s.der_decode_sig(sig)
    if Q is None or parsed is None:
        return ("forced", 0)
    r, s = parsed
    if not (0 < r < N and 0 < s < N) or s > _s._HALF_N:
        return ("forced", 0)
    e = int.from_bytes(digest, "big")
    w = pow(s, -1, N)  # the reference's pow(s, N - 2, N): the same value
    u1 = e * w % N
    u2 = r * w % N
    if u1 == 0 or u2 == 0:
        # the ladder degenerates to a single scalar: the host oracle decides
        return ("forced", int(_s.verify(pubkey, digest, sig)))
    return ("kernel", Q, u1, u2, r)


def _digits_batch(xs: Sequence[int]) -> np.ndarray:
    """(n, 64) uint32 MSB-first 4-bit digits of n 256-bit scalars."""
    a = np.frombuffer(b"".join(x.to_bytes(32, "big") for x in xs), np.uint8)
    a = a.reshape(len(xs), 32)
    return np.stack([a >> 4, a & 15], axis=-1).reshape(len(xs), NWIN).astype(np.uint32)


def _bits_to_limbs(bits: np.ndarray) -> np.ndarray:
    """(n, >=256) little-endian bit matrix -> (n, 10) uint32 limbs."""
    limbs = np.zeros((bits.shape[0], NLIMB), dtype=np.uint32)
    for i in range(NLIMB):
        w = F.WIDTHS[i]
        weights = 1 << np.arange(w, dtype=np.uint64)
        limbs[:, i] = bits[:, F.OFFS[i]: F.OFFS[i] + w].astype(np.uint64) @ weights
    return limbs


def _limbs_batch(xs: Sequence[int]) -> np.ndarray:
    """(n, 10) uint32 exact limbs of n integers below 2^256."""
    a = np.frombuffer(b"".join(x.to_bytes(32, "little") for x in xs), np.uint8)
    return _bits_to_limbs(np.unpackbits(a.reshape(len(xs), 32), axis=1,
                                        bitorder="little"))


def points_from_jax(qx: np.ndarray, qy: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The JAX package's (n, 20) radix-2^13 coordinate limbs -> this port's
    (n, 10) layout (same values, which lie below 2^256)."""

    def convert(limbs13: np.ndarray) -> np.ndarray:
        limbs13 = np.asarray(limbs13, dtype=np.uint32)
        bits = (limbs13[:, :, None] >> np.arange(13, dtype=np.uint32)) & 1
        bits = bits.reshape(limbs13.shape[0], -1)
        if bits[:, 256:].any():
            raise ValueError("coordinate at or above 2^256")
        return _bits_to_limbs(bits.astype(np.uint8))

    return convert(qx), convert(qy)


def pack_rows(pubkeys: Sequence[bytes], digests: Sequence[bytes],
              sigs: Sequence[bytes], b: int):
    """Host prologue of a batch padded to b rows with zeros: returns
    ((qx, qy, dig1, dig2, rl, rnl, rnok), forced) as numpy arrays, row-major
    ((b, 10), (b, 64), (b,)); forced[i] is -1 where the kernel decides."""
    qx = np.zeros((b, NLIMB), np.uint32)
    qy = np.zeros((b, NLIMB), np.uint32)
    d1 = np.zeros((b, NWIN), np.uint32)
    d2 = np.zeros((b, NWIN), np.uint32)
    rl = np.zeros((b, NLIMB), np.uint32)
    rnl = np.zeros((b, NLIMB), np.uint32)
    rnok = np.zeros((b,), np.uint32)
    forced = np.full((b,), -1, np.int8)
    rows: List[int] = []
    u1s: List[int] = []
    u2s: List[int] = []
    rs: List[int] = []
    for i in range(len(pubkeys)):
        item = prep_item(bytes(pubkeys[i]), bytes(digests[i]), bytes(sigs[i]))
        if item[0] == "forced":
            forced[i] = item[1]
            continue
        _, Q, u1, u2, r = item
        qx[i], qy[i] = Q
        rows.append(i)
        u1s.append(u1)
        u2s.append(u2)
        rs.append(r)
    if rows:
        idx = np.asarray(rows)
        d1[idx] = _digits_batch(u1s)
        d2[idx] = _digits_batch(u2s)
        rl[idx] = _limbs_batch(rs)
        rn_ok = np.asarray([r + N < P for r in rs])
        if rn_ok.any():
            rnl[idx[rn_ok]] = _limbs_batch([r + N for r in rs if r + N < P])
            rnok[idx[rn_ok]] = 1
    return (qx, qy, d1, d2, rl, rnl, rnok), forced


_dev_consts: Dict[torch.device, torch.Tensor] = {}


def _consts_on(device: torch.device) -> torch.Tensor:
    c = _dev_consts.get(device)
    if c is None:
        c = _dev_consts[device] = _put(_CONSTS, device)
    return c


def upload(host, device: torch.device) -> tuple:
    """``pack_rows``' arrays -> the kernel's inputs on ``device``: consts
    (480,), qx, qy (10, b), dig1, dig2 (64, b), rl, rnl (10, b), rnok (1, b)."""
    qx, qy, d1, d2, rl, rnl, rnok = host
    cols = [_put(np.ascontiguousarray(a.T), device) for a in (qx, qy, d1, d2, rl, rnl)]
    return (_consts_on(device), *cols, _put(rnok[None, :], device))


# ---------------------------------------------------------------------------
# Plain version of K3: projective (X:Y:Z), complete formulas
# ---------------------------------------------------------------------------


def _pt_add(p, q):
    """RCB16 algorithm 7: complete addition, a = 0."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    t0 = F.mul(X1, X2)
    t1 = F.mul(Y1, Y2)
    t2 = F.mul(Z1, Z2)
    t3 = F.sub(F.mul(F.add(X1, Y1), F.add(X2, Y2)), F.add(t0, t1))
    t4 = F.sub(F.mul(F.add(Y1, Z1), F.add(Y2, Z2)), F.add(t1, t2))
    X3 = F.mul(F.add(X1, Z1), F.add(X2, Z2))
    Y3 = F.sub(X3, F.add(t0, t2))
    t0x3 = F.add(F.add(t0, t0), t0)
    t2b = F.mul_small(t2)
    Z3 = F.add(t1, t2b)
    t1 = F.sub(t1, t2b)
    Y3b = F.mul_small(Y3)
    X3 = F.sub(F.mul(t3, t1), F.mul(t4, Y3b))
    Y3 = F.add(F.mul(Y3b, t0x3), F.mul(t1, Z3))
    Z3 = F.add(F.mul(Z3, t4), F.mul(t0x3, t3))
    return X3, Y3, Z3


def _pt_double(p):
    """RCB16 algorithm 9: complete doubling, a = 0."""
    X, Y, Z = p
    t0 = F.sq(Y)
    Z3 = F.add(t0, t0)
    Z3 = F.add(Z3, Z3)
    Z3 = F.add(Z3, Z3)
    t1 = F.mul(Y, Z)
    t2 = F.mul_small(F.sq(Z))
    X3 = F.mul(t2, Z3)
    Y3 = F.add(t0, t2)
    Z3 = F.mul(t1, Z3)
    t2 = F.add(F.add(t2, t2), t2)
    t0 = F.sub(t0, t2)
    Y3 = F.add(X3, F.mul(t0, Y3))
    X3 = F.mul(t0, F.mul(X, Y))
    X3 = F.add(X3, X3)
    return X3, Y3, Z3


ADD_OPS = (12, 0, 2)  # (multiplications, squarings, mul_small) per add
DOUBLE_OPS = (6, 2, 1)  # ... per doubling


def ladder_fe_ops(nwin: int = NWIN) -> tuple:
    """(multiplications, squarings, mul_small) per row in K3 (and in
    ``ladder_ref``): 15 table adds, per window 4 doublings and 2 adds, then
    r Z and (r + n) Z."""
    adds, doubles = 15 + 2 * nwin, 4 * nwin
    m, s, k = (adds * a + doubles * d for a, d in zip(ADD_OPS, DOUBLE_OPS))
    return m + 2, s, k


# ---------------------------------------------------------------------------
# K3's two-lane schedule. Each round lists a point formula's independent
# products (operand names) in slot order: lane q of a row computes product
# 2 s + q in slot s (``ed25519_cuda.lane_slots``; ``ed25519_cuda.run_round``
# evaluates a round). Between rounds each lane computes only the linear
# values its own next products read, and the lanes trade single values.
# A slot whose products are all squares uses the 55-product squaring.
# ---------------------------------------------------------------------------

K3_LANES_PER_ROW = _ec.LANES_PER_ROW  # lanes of a warp that serve one signature row

ADD_ROUNDS = (
    (("X1", "X2"), ("Z1", "Z2"), ("Y1", "Y2"), ("X1+Z1", "X2+Z2"),
     ("X1+Y1", "X2+Y2"), ("Y1+Z1", "Y2+Z2")),
    (("t3", "t1'"), ("t4", "y3b"), ("t1'", "z3"), ("z3", "t4"), ("t0x3", "t3"),
     ("y3b", "t0x3")),
)
DOUBLE_ROUNDS = (
    (("Y", "Y"), ("Z", "Z"), ("Y", "Z"), ("X", "Y")),
    (("t2", "z3"), ("t0'", "y3"), ("t1", "z3"), ("t0'", "XY")),
)


lane_slots = _ec.lane_slots


def pt_add_rounds(p, q):
    """``_pt_add`` evaluated in K3's lane schedule: (X, Y, Z), which both
    lanes hold after the last exchange."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    envs = [{"X1": X1, "X2": X2, "Y1": Y1, "Y2": Y2,
             "X1+Y1": F.add(X1, Y1), "X2+Y2": F.add(X2, Y2)},
            {"Z1": Z1, "Z2": Z2, "X1+Z1": F.add(X1, Z1), "X2+Z2": F.add(X2, Z2),
             "Y1+Z1": F.add(Y1, Z1), "Y2+Z2": F.add(Y2, Z2)}]
    (t0, t1, m3), (t2, m5, m4) = _ec.run_round(envs, ADD_ROUNDS[0], F)
    # each lane: its own third product; t0, t1, t2 and m5 after the exchange
    t2b = F.mul_small(t2)
    shared = {"y3b": F.mul_small(F.sub(m5, F.add(t0, t2))),
              "t0x3": F.add(F.add(t0, t0), t0)}
    z3, t1p = F.add(t1, t2b), F.sub(t1, t2b)  # lane 0's, lane 1's
    envs = [{"t3": F.sub(m3, F.add(t1, t0)), "z3": z3, "t1'": t1p, **shared},
            {"t4": F.sub(m4, F.add(t1, t2)), "t1'": t1p, "z3": z3, **shared}]
    (n0, n3, n5), (n1, n4, n2) = _ec.run_round(envs, ADD_ROUNDS[1], F)
    return F.sub(n0, n1), F.add(n3, n2), F.add(n5, n4)


def pt_double_rounds(p):
    """``_pt_double`` evaluated in K3's lane schedule: (X, Y, Z), which
    both lanes hold after the last exchange."""
    X, Y, Z = p
    envs = [{"X": X, "Y": Y, "Z": Z}] * K3_LANES_PER_ROW
    (t0, t1), (zz, xy) = _ec.run_round(envs, DOUBLE_ROUNDS[0], F)
    t2 = F.mul_small(zz)  # both lanes, after the exchange of slot 0
    z3 = F.add(t0, t0)
    z3 = F.add(z3, z3)
    z3 = F.add(z3, z3)  # lane 0's
    t0p = F.sub(t0, F.add(F.add(t2, t2), t2))  # lane 1's, the same three steps
    envs = [{"t2": t2, "z3": z3, "t1": t1},
            {"t0'": t0p, "y3": F.add(t0, t2), "XY": xy}]
    (n0, n2), (n1, n3) = _ec.run_round(envs, DOUBLE_ROUNDS[1], F)
    return F.add(n3, n3), F.add(n0, n1), n2


def ladder_point_ref(consts, qx, qy, dig1, dig2, nwin: int = NWIN):
    """R = u1 G + u2 Q over ``nwin`` MSB-first windows, projective: returns
    (X, Y, Z), each (b, 10) int64 carried limbs. consts (480,), qx/qy
    (10, b), dig1/dig2 (nwin, b)."""
    g = _u32(consts).reshape(16, 3, NLIMB)
    qx, qy = _u32(qx).T, _u32(qy).T
    dig1, dig2 = _u32(dig1), _u32(dig2)
    one = F.const(1, qx)
    zero = torch.zeros_like(qx)
    ident = (zero, one, zero)
    q1 = (qx, qy, one)
    tbl = [ident]
    for _ in range(15):  # complete additions through the identity
        tbl.append(_pt_add(tbl[-1], q1))
    stacked = [torch.stack([t[i] for t in tbl]) for i in range(3)]  # (16, b, 10)
    rows = torch.arange(qx.shape[0], device=qx.device)
    acc = ident
    for t in range(nwin):
        for _ in range(4):
            acc = _pt_double(acc)
        entry = g[dig1[t]]  # (b, 3, 10)
        acc = _pt_add(acc, (entry[:, 0], entry[:, 1], entry[:, 2]))
        d = dig2[t]
        acc = _pt_add(acc, tuple(s[d, rows] for s in stacked))
    return acc


def _is_zero(x: torch.Tensor) -> torch.Tensor:
    return (F.canonical(x) == 0).all(dim=-1)


def ladder_ref(consts, qx, qy, dig1, dig2, rl, rnl, rnok, nwin: int = NWIN):
    """Plain version of K3, same inputs and outputs: returns int32 ok (b,),
    X (10, b) and Z (10, b) (R's carried projective limbs)."""
    if dig1.shape[0] != nwin or dig2.shape[0] != nwin:
        raise ValueError(f"digit rows {dig1.shape[0]} != nwin {nwin}")
    X, _, Z = ladder_point_ref(consts, qx, qy, dig1, dig2, nwin)
    eq_r = _is_zero(F.sub(X, F.mul(_u32(rl).T, Z)))
    eq_rn = _is_zero(F.sub(X, F.mul(_u32(rnl).T, Z))) & (_u32(rnok)[0] != 0)
    ok = ~_is_zero(Z) & (eq_r | eq_rn)
    return (ok.to(torch.int32), X.T.contiguous().to(torch.int32),
            Z.T.contiguous().to(torch.int32))


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

NAME = "secp256k1_ladder"
# launches of K3: the wrapper adds one where it launches the kernel
launches: Dict[str, int] = {NAME: 0}

# K3's geometry; the kernel source's LPR and RPB must agree
K3_ROWS_PER_BLOCK = 16  # rows a block serves: one warp


def k3_geometry(b: int) -> Tuple[int, int, int, int]:
    """(lanes_per_row, rows_per_block, blocks, smem_bytes) of K3 over b
    rows: one block per 16 rows (the last one ragged), and dynamic shared
    memory for the constant [0..15]G and each of the block's rows' [0..15]Q
    (16 points of 30 words)."""
    if b <= 0:
        raise ValueError(f"bad batch size {b}")
    rpb = K3_ROWS_PER_BLOCK
    smem = (NCONSTS + 16 * 3 * NLIMB * rpb) * 4
    return K3_LANES_PER_ROW, rpb, -(-b // rpb), smem


_P = ctypes.c_void_p
_I = ctypes.c_int
# consts, qx, qy, dig1, dig2, rl, rnl, rnok, ok, X, Z, b, nwin,
# lanes_per_row, rows_per_block, blocks, smem_bytes, stream
_ARGTYPES = [_P] * 11 + [_I] * 6 + [_P]


def reset_launches() -> None:
    launches[NAME] = 0


def ladder(consts, qx, qy, dig1, dig2, rl, rnl, rnok):
    """K3 over ``dig1.shape[0]`` windows. CPU tensors take ``ladder_ref``;
    CUDA tensors launch the kernel on the current stream (no
    synchronisation). Returns int32 ok (b,), X (10, b), Z (10, b)."""
    ins = (consts, qx, qy, dig1, dig2, rl, rnl, rnok)
    if _ec._on_cpu(ins):
        return ladder_ref(*ins, nwin=dig1.shape[0])
    b, dev = qx.shape[1], qx.device
    ok = torch.empty((b,), dtype=torch.int32, device=dev)
    X = torch.empty((NLIMB, b), dtype=torch.int32, device=dev)
    Z = torch.empty((NLIMB, b), dtype=torch.int32, device=dev)
    ladder_into(ins, ok, X, Z)
    return ok, X, Z


def ladder_into(ins, ok, X, Z) -> None:
    """Launch K3 on CUDA inputs ``ins`` (``ladder``'s eight) into the given
    int32 outputs ok (b,), X (10, b), Z (10, b); the kernel writes rows
    below b only."""
    consts, qx, qy, dig1, dig2, rl, rnl, rnok = ins
    nwin, b = dig1.shape[0], qx.shape[1]
    if b == 0 or nwin == 0:
        raise ValueError(f"bad sizes b={b} nwin={nwin}")
    for nm, t, shp in (("consts", consts, (NCONSTS,)), ("qx", qx, (NLIMB, b)),
                       ("qy", qy, (NLIMB, b)), ("dig1", dig1, (nwin, b)),
                       ("dig2", dig2, (nwin, b)), ("rl", rl, (NLIMB, b)),
                       ("rnl", rnl, (NLIMB, b)), ("rnok", rnok, (1, b)),
                       ("ok", ok, (b,)), ("X", X, (NLIMB, b)), ("Z", Z, (NLIMB, b))):
        _ec._check(nm, t, shp)
    if _ec._on_cpu((*ins, ok, X, Z)):
        raise ValueError("ladder_into launches the kernel: CUDA tensors only")
    _ec.launch_kernel(NAME, _ARGTYPES, launches, qx.device, *(t.data_ptr() for t in ins),
                      ok.data_ptr(), X.data_ptr(), Z.data_ptr(), b, nwin, *k3_geometry(b))


# ---------------------------------------------------------------------------
# Host entry point
# ---------------------------------------------------------------------------


def verify_batch(pubkeys: Sequence[bytes], digests: Sequence[bytes],
                 sigs: Sequence[bytes], device: DeviceLike = None) -> np.ndarray:
    """Batched ECDSA verify, bit-exact with ``crypto.secp256k1.verify``:
    33-byte compressed keys, 32-byte digests, DER signatures -> (n,) bool.
    Runs on ``cuda`` unless ``device="cpu"``."""
    dev = resolve_device(device)
    n = len(pubkeys)
    if n == 0:
        return np.zeros((0,), dtype=bool)
    b = _bucket(n, LANES if dev.type == "cuda" else CPU_LANES)
    host, forced = pack_rows(pubkeys, digests, sigs, b)
    ok = ladder(*upload(host, dev))[0][:n].cpu().numpy() != 0
    f = forced[:n]
    return np.where(f >= 0, f.astype(bool), ok)
