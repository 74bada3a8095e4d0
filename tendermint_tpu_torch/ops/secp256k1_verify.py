"""Batched secp256k1 ECDSA verification on the verifier's mesh route: K6,
its plain version, its packing and its entry point.

Counterpart of the JAX package's ``ops/secp256k1_verify.py``, the XLA route
its verifier takes whenever a mesh is given (``TPUBatchVerifier(mesh=)``,
``backend="xla"``). The host prologue is ``secp256k1_cuda.prep_item``, the
one K3 takes, so that K3 and K6 cannot drift apart: the strict DER parse,
the range and low-s checks, w = s^-1 mod n, u1 and u2, the cached key
decompression; the rows it decides (a bad key or signature, u1 = 0 or
u2 = 0) stay the host's. K6 (``csrc/secp256k1_verify.cu``, ``verify_rows``)
computes R = u1 G + u2 Q with K3's windowed two-lane ladder
(``csrc/secp256k1_ladder.cuh``), its 4-bit digits taken in the kernel from
the scalars' bit words, and accepts iff Z != 0 and X = r Z, or X = (r + n) Z where r + n < p. The plain
version (``verify_ref``) is the reference's bit-serial ladder over 256
bits, MSB first, with the complete Renes-Costello-Batina addition
(doubling by adding the point to itself), Z^-1 and the affine compare: the
same group element, so the same verdict.
``verify_batch`` pads to the reference's bucket, splits the rows over a
``DeviceMesh`` when one is given, and launches K6 once a shard.

Field elements are the ten 26-bit limbs of ``ops/fe_secp256k1.py``; device
tensors are int32 holding uint32 bit patterns, laid out (limbs, rows).
``verify_rows`` runs the plain version (``verify_ref``) only for tensors on
the CPU; for CUDA tensors it launches K6 or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from tendermint_tpu_torch.crypto import secp256k1 as _s
from tendermint_tpu_torch.device import DeviceLike, resolve_device
from tendermint_tpu_torch.ops import ed25519_cuda as _ec
from tendermint_tpu_torch.ops import fe
from tendermint_tpu_torch.ops import fe_secp256k1 as F
from tendermint_tpu_torch.ops import secp256k1_cuda as _sc

P = _s.P
N = _s.N
NLIMB = F.NLIMB
NBITS = 256
NAME = "secp256k1_verify"

# G's affine coordinates in limbs: what the kernel's constant input
# (secp256k1_cuda._CONSTS, the table [0..15]G) is held against
G_LIMBS = {"GX": F.int_to_limbs(_s._G[0]), "GY": F.int_to_limbs(_s._G[1])}


def _bucket(n: int, mesh=None) -> int:
    """The reference's pad size: powers of two from 32 up to 4096, then
    multiples of 4096; with a mesh, rounded up to a multiple of its device
    count."""
    if n <= 4096:
        b = 32
        while b < n:
            b <<= 1
    else:
        b = ((n + 4095) // 4096) * 4096
    if mesh is not None:
        m = int(mesh.devices.size)
        b = -(-b // m) * m
    return b


def _scalar_words(xs: Sequence[int]) -> np.ndarray:
    """(n, 8) uint32 little-endian words of n scalars below 2^256."""
    a = np.frombuffer(b"".join(x.to_bytes(32, "little") for x in xs), "<u4")
    return a.reshape(len(xs), 8).astype(np.uint32)


def pack_rows(pubkeys: Sequence[bytes], digests: Sequence[bytes],
              sigs: Sequence[bytes], b: int):
    """Host prologue of a batch padded to b rows: returns ((qx, qy, u1w,
    u2w, rl, rnl, rnok), forced), row-major numpy ((b, 10), (b, 8), (b,));
    forced[i] is -1 where K6 decides, else the host's 0 or 1."""
    qx = np.zeros((b, NLIMB), np.uint32)
    qy = np.zeros((b, NLIMB), np.uint32)
    u1w = np.zeros((b, 8), np.uint32)
    u2w = np.zeros((b, 8), np.uint32)
    rl = np.zeros((b, NLIMB), np.uint32)
    rnl = np.zeros((b, NLIMB), np.uint32)
    rnok = np.zeros((b,), np.uint32)
    forced = np.full((b,), -1, np.int8)
    rows, u1s, u2s, rs = [], [], [], []
    for i in range(len(pubkeys)):
        item = _sc.prep_item(bytes(pubkeys[i]), bytes(digests[i]), bytes(sigs[i]))
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
        u1w[idx] = _scalar_words(u1s)
        u2w[idx] = _scalar_words(u2s)
        rl[idx] = _sc._limbs_batch(rs)
        rn_ok = np.asarray([r + N < P for r in rs])
        if rn_ok.any():
            rnl[idx[rn_ok]] = _sc._limbs_batch([r + N for r in rs if r + N < P])
            rnok[idx[rn_ok]] = 1
    return (qx, qy, u1w, u2w, rl, rnl, rnok), forced


def upload(host, device: torch.device) -> tuple:
    """``pack_rows``' seven row-major arrays (rows of one shard) -> K6's
    inputs on ``device``: qx, qy (10, b), u1w, u2w (8, b), rl, rnl (10, b),
    rnok (1, b)."""
    *cols, rnok = host
    return (*(_ec._put(np.ascontiguousarray(a.T), device) for a in cols),
            _ec._put(np.asarray(rnok)[None, :], device))


# ---------------------------------------------------------------------------
# Plain version of K6
# ---------------------------------------------------------------------------


def _sqn(a: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        a = F.sq(a)
    return a


def fe_inv(x: torch.Tensor) -> torch.Tensor:
    """x^(p-2) by libsecp256k1's chain: 255 squarings, 15 multiplications."""
    x2 = F.mul(F.sq(x), x)
    x3 = F.mul(F.sq(x2), x)
    x6 = F.mul(_sqn(x3, 3), x3)
    x9 = F.mul(_sqn(x6, 3), x3)
    x11 = F.mul(_sqn(x9, 2), x2)
    x22 = F.mul(_sqn(x11, 11), x11)
    x44 = F.mul(_sqn(x22, 22), x22)
    x88 = F.mul(_sqn(x44, 44), x44)
    x176 = F.mul(_sqn(x88, 88), x88)
    x220 = F.mul(_sqn(x176, 44), x44)
    x223 = F.mul(_sqn(x220, 3), x3)
    t = F.mul(_sqn(x223, 23), x22)
    t = F.mul(_sqn(t, 5), x)
    t = F.mul(_sqn(t, 3), x2)
    return F.mul(_sqn(t, 2), x)


INV_MULS, INV_SQUARINGS = 15, 255


def _pt_add(p, q):
    """RCB16 algorithm 7 (``secp256k1_cuda._pt_add``, K6's addition) with
    its six independent products of each round in one call of ``F.mul``
    (``fe.stacked``): the same integers."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    t0, t1, t2, m3, m4, x3 = fe.stacked(
        F.mul, (X1, X2), (Y1, Y2), (Z1, Z2), (F.add(X1, Y1), F.add(X2, Y2)),
        (F.add(Y1, Z1), F.add(Y2, Z2)), (F.add(X1, Z1), F.add(X2, Z2)))
    t3 = F.sub(m3, F.add(t0, t1))
    t4 = F.sub(m4, F.add(t1, t2))
    y3 = F.sub(x3, F.add(t0, t2))
    t0x3 = F.add(F.add(t0, t0), t0)
    t2b = F.mul_small(t2)
    z3 = F.add(t1, t2b)
    t1m = F.sub(t1, t2b)
    y3b = F.mul_small(y3)
    a, b, c, d, e, f = fe.stacked(F.mul, (t3, t1m), (t4, y3b), (y3b, t0x3), (t1m, z3),
                                 (z3, t4), (t0x3, t3))
    return F.sub(a, b), F.add(c, d), F.add(e, f)


def verify_ref(qx, qy, u1w, u2w, rl, rnl, rnok) -> torch.Tensor:
    """Plain version of K6, same inputs and output: qx, qy, rl, rnl (10, b),
    u1w, u2w (8, b), rnok (1, b), int32 bit patterns; returns int32 ok (b,).
    Every row computes both additions and keeps the one its bit selects,
    as the reference does; the kernel branches."""
    x, y = _ec._u32(qx).T, _ec._u32(qy).T
    w1, w2 = _ec._u32(u1w), _ec._u32(u2w)
    one, zero = F.const(1, x), torch.zeros_like(x)
    q = (x, y, one)
    g = (F.const(_s._G[0], x), F.const(_s._G[1], x), one)
    acc = (zero, one, zero)
    for i in range(NBITS - 1, -1, -1):
        acc = _pt_add(acc, acc)
        for words, pt in ((w1, g), (w2, q)):
            bit = ((words[i // 32] >> (i % 32)) & 1).bool().unsqueeze(-1)
            acc = tuple(torch.where(bit, a, b) for a, b in zip(_pt_add(acc, pt), acc))
    X, _, Z = acc
    nonzero = ~(F.canonical(Z) == 0).all(dim=1)
    xa = F.canonical(F.mul(X, fe_inv(Z)))
    eq_r = (xa == _ec._u32(rl).T).all(dim=1)
    eq_rn = (xa == _ec._u32(rnl).T).all(dim=1) & (_ec._u32(rnok)[0] != 0)
    return (nonzero & (eq_r | eq_rn)).to(torch.int32)


def k6_fe_ops(u1w: np.ndarray, u2w: np.ndarray) -> Tuple[int, int, int]:
    """(multiplications, squarings, multiplications by b3) of the
    reference's bit-serial schedule (``verify_ref``) over these rows
    (row-major (n, 8) words), which K6's bound is read against: a row's 256
    doublings and an addition for each set bit of u1 and of u2, each 12
    multiplications and 2 by b3, then Z^-1 and X Z^-1. K6's own schedule
    does ``secp256k1_cuda.ladder_fe_ops()`` a row whatever the scalars."""
    n = u1w.shape[0]
    bits = sum(int(np.unpackbits(np.ascontiguousarray(w, dtype="<u4").view(np.uint8)).sum())
               for w in (u1w, u2w))
    adds = n * NBITS + bits
    return 12 * adds + n * (INV_MULS + 1), n * INV_SQUARINGS, 2 * adds


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

# launches of K6: the wrapper adds one where it launches the kernel
launches: Dict[str, int] = {NAME: 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
# consts, qx, qy, u1w, u2w, rl, rnl, rnok, ok, b, lanes_per_row,
# rows_per_block, blocks, smem_bytes, stream
_ARGTYPES = [_P] * 9 + [_I] * 5 + [_P]


def reset_launches() -> None:
    launches[NAME] = 0


def k6_geometry(b: int) -> Tuple[int, int, int, int]:
    """(lanes_per_row, rows_per_block, blocks, smem_bytes) of K6 over b
    rows: K3's (``secp256k1_cuda.k3_geometry``), whose body K6 runs."""
    return _sc.k3_geometry(b)


def verify_rows(qx, qy, u1w, u2w, rl, rnl, rnok) -> torch.Tensor:
    """K6. CPU tensors take ``verify_ref``; CUDA tensors launch the kernel
    on the current stream (no synchronisation). Returns int32 ok (b,)."""
    ins = (qx, qy, u1w, u2w, rl, rnl, rnok)
    b = qx.shape[1]
    for nm, t, shp in (("qx", qx, (NLIMB, b)), ("qy", qy, (NLIMB, b)),
                       ("u1w", u1w, (8, b)), ("u2w", u2w, (8, b)),
                       ("rl", rl, (NLIMB, b)), ("rnl", rnl, (NLIMB, b)),
                       ("rnok", rnok, (1, b))):
        _ec._check(nm, t, shp)
    if _ec._on_cpu(ins):
        return verify_ref(*ins)
    if b == 0:
        raise ValueError("bad batch size 0")
    ok = torch.empty((b,), dtype=torch.int32, device=qx.device)
    _ec.launch_kernel(NAME, _ARGTYPES, launches, qx.device,
                      _sc._consts_on(qx.device).data_ptr(),
                      *(t.data_ptr() for t in ins), ok.data_ptr(), b, *k6_geometry(b))
    return ok


# ---------------------------------------------------------------------------
# Host entry point
# ---------------------------------------------------------------------------


def verify_batch(pubkeys: Sequence[bytes], digests: Sequence[bytes],
                 sigs: Sequence[bytes], mesh=None, *,
                 device: DeviceLike = None) -> np.ndarray:
    """Batched ECDSA verify through K6, bit-exact with
    ``crypto.secp256k1.verify``: 33-byte compressed keys, 32-byte digests,
    DER signatures -> (n,) bool. With a ``DeviceMesh`` the padded rows
    split into one contiguous shard a mesh device, each launched on its own
    device without a synchronisation between them (a shard of padding rows
    only is not launched), and the verdicts are gathered once; without one it runs on ``device`` (``cuda`` unless
    ``device="cpu"``)."""
    n = len(pubkeys)
    if n == 0:
        return np.zeros((0,), dtype=bool)
    b = _bucket(n, mesh)
    host, forced = pack_rows(pubkeys, digests, sigs, b)
    if mesh is None:
        ok = verify_rows(*upload(host, resolve_device(device)))
    else:
        oks = [verify_rows(*upload([a[lo:hi] for a in host], d)) if lo < n
               else torch.zeros((hi - lo,), dtype=torch.int32, device=d)
               for (lo, hi), d in zip(mesh.split_rows(b), mesh.flat)]
        ok = mesh.gather(oks)
    ok = ok[:n].cpu().numpy() != 0
    f = forced[:n]
    return np.where(f >= 0, f.astype(bool), ok)
