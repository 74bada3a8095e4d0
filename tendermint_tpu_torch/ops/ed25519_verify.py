"""Batched Go-exact Ed25519 verification on the verifier's mesh route: K5,
its plain version, its host prologue and its entry point.

Counterpart of the JAX package's ``ops/ed25519_verify.py``, the XLA route
its verifier takes whenever a mesh is given (``TPUBatchVerifier(mesh=)``,
``backend="xla"``). The host prologue (``host_prologue``) hashes R || A || M
with hashlib's SHA-512 and reduces it mod L, checks Go's top three bits of
s, decompresses A (cached per key; a key that fails makes its row invalid)
and zeroes an invalid row's scalars. K5 (``csrc/ed25519_verify.cu``,
``verify_rows``) then computes R' = [s]B + [h](-A) with K2's windowed
two-lane ladder (``csrc/ed25519_ladder.cuh``), its 4-bit digits taken in
the kernel from the scalars' bit words, inverts Z, and accepts a row iff R''s canonical y equals R's raw low 255
bits and x's parity R's sign bit. The plain version (``verify_ref``) is
the reference's bit-serial ladder over 253 bits, MSB first, with the
complete extended formulas: the same group element, so the same verdict.
``verify_batch`` pads to the reference's bucket, splits the rows over a
``DeviceMesh`` when one is given, launches K5 once a shard and returns
``ok & valid``.

Field elements are the ten radix-2^25.5 limbs of ``ops/fe.py``; device
tensors are int32 holding uint32 bit patterns, laid out (limbs, rows) so
that neighbouring threads read neighbouring words. ``verify_rows`` runs
the plain version (``verify_ref``) only for tensors on the CPU; for CUDA
tensors it launches K5 or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from tendermint_tpu_torch.crypto import ed25519 as _ed
from tendermint_tpu_torch.device import DeviceLike, resolve_device
from tendermint_tpu_torch.ops import ed25519_cuda as _ec
from tendermint_tpu_torch.ops import fe

P = _ed.P
L_ORDER = _ed.L
NLIMB = fe.NLIMB
NBITS = 253  # s, h < 2^253
NAME = "ed25519_verify"

# B's extended coordinates (Z = 1) and 2d in limbs: what the kernel's
# constant input (ed25519_cuda._CONSTS: the niels table [0..15]B, then 2d)
# is held against
B_LIMBS = {
    "BX": fe.int_to_limbs(_ed.B_AFFINE),
    "BY": fe.int_to_limbs(_ed._BY),
    "BT": fe.int_to_limbs(_ed.B_AFFINE * _ed._BY % P),
}
D2_LIMBS = fe.int_to_limbs(_ed.D2)

# ---------------------------------------------------------------------------
# Host prologue (the JAX package's host_prologue, in this port's limbs)
# ---------------------------------------------------------------------------


def host_prologue(pubs: np.ndarray, msgs: Sequence[bytes], sigs: np.ndarray):
    """(N, 32) keys, N messages, (N, 64) signatures -> row-major numpy
    (neg_ax (N, 10), ay (N, 10), s_words (N, 8), h_words (N, 8),
    r_limbs (N, 10), r_sign (N,), valid (N,)), all uint32 but ``valid``."""
    pubs = np.ascontiguousarray(pubs, dtype=np.uint8)
    sigs = np.ascontiguousarray(sigs, dtype=np.uint8)
    n = pubs.shape[0]
    valid = np.ones((n,), dtype=bool)
    if n:
        valid &= (sigs[:, 63] & 224) == 0  # Go checks only sig[63] & 224
    neg_ax = np.zeros((n, NLIMB), dtype=np.uint32)
    ay = np.zeros((n, NLIMB), dtype=np.uint32)
    h_bytes = np.zeros((n, 32), dtype=np.uint8)
    for i in range(n):
        if not valid[i]:
            continue
        pk = pubs[i].tobytes()
        dec = _ec._decompress_neg_cached(pk)
        if dec is None:
            valid[i] = False
            continue
        neg_ax[i], ay[i] = dec
        h = int.from_bytes(
            hashlib.sha512(sigs[i, :32].tobytes() + pk + bytes(msgs[i])).digest(),
            "little") % L_ORDER
        h_bytes[i] = np.frombuffer(h.to_bytes(32, "little"), dtype=np.uint8)
    s_words = np.ascontiguousarray(sigs[:, 32:]).view("<u4").astype(np.uint32)
    h_words = h_bytes.view("<u4").astype(np.uint32)
    s_words[~valid] = 0  # keeps the device work defined on invalid rows
    h_words[~valid] = 0
    r_limbs = _ec._bytes_to_raw_limbs(np.ascontiguousarray(sigs[:, :32]))
    r_sign = (sigs[:, 31] >> 7).astype(np.uint32)
    return neg_ax, ay, s_words, h_words, r_limbs, r_sign, valid


def _bucket(n: int, mesh=None) -> int:
    """The reference's pad size: powers of two 64..4096, then multiples of
    4096; with a mesh, rounded up to a multiple of its device count."""
    b = 64
    while b < n and b < 4096:
        b *= 2
    if n > b:
        b = ((n + 4095) // 4096) * 4096
    if mesh is not None:
        nd = int(mesh.devices.size)
        b = -(-b // nd) * nd
    return b


def upload(host, device: torch.device) -> tuple:
    """``host_prologue``'s six row-major arrays (rows of one shard) -> K5's
    inputs on ``device``: negax, ay (10, b), s_words, h_words (8, b), rlimb
    (10, b), rsign (1, b)."""
    neg_ax, ay, s_words, h_words, r_limbs, r_sign = host
    cols = [_ec._put(np.ascontiguousarray(a.T), device)
            for a in (neg_ax, ay, s_words, h_words, r_limbs)]
    return (*cols, _ec._put(np.asarray(r_sign)[None, :], device))


# ---------------------------------------------------------------------------
# Plain version of K5
# ---------------------------------------------------------------------------


def _pt_add(p, q, d2):
    """add-2008-hwcd-3 with 2d (``ed25519_cuda._pt_add``), its independent
    products in one call each round (``fe.stacked``): the same integers."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A, B, Td, D = fe.stacked(fe.mul, (fe.sub(Y1, X1), fe.sub(Y2, X2)),
                             (fe.add(Y1, X1), fe.add(Y2, X2)), (T1, d2), (fe.add(Z1, Z1), Z2))
    C = fe.mul(Td, T2)
    E, F, G, H = fe.sub(B, A), fe.sub(D, C), fe.add(D, C), fe.add(B, A)
    return fe.stacked(fe.mul, (E, F), (G, H), (F, G), (E, H))


def _pt_double(p):
    """dbl-2008-hwcd (``ed25519_cuda._pt_double``), stacked likewise."""
    X1, Y1, Z1, _ = p
    S = fe.add(X1, Y1)
    A, B, ZZ, SS = fe.stacked(fe.mul, (X1, X1), (Y1, Y1), (Z1, Z1), (S, S))
    C, H = fe.add(ZZ, ZZ), fe.add(A, B)
    E = fe.sub(H, SS)
    G = fe.sub(A, B)
    F = fe.add(C, G)
    return fe.stacked(fe.mul, (E, F), (G, H), (F, G), (E, H))


def _bit(words: torch.Tensor, i: int) -> torch.Tensor:
    """Bit i of (8, b) little-endian words, as a (b, 1) bool column."""
    return ((words[i // 32] >> (i % 32)) & 1).bool().unsqueeze(-1)


def verify_ref(negax, ay, s_words, h_words, rlimb, rsign) -> torch.Tensor:
    """Plain version of K5, same inputs and output: negax, ay, rlimb
    (10, b), s_words, h_words (8, b), rsign (1, b), int32 bit patterns;
    returns int32 ok (b,). Every row computes both additions and keeps the
    one its bit selects, as the reference does; the kernel branches."""
    ax, a_y = _ec._u32(negax).T, _ec._u32(ay).T
    sw, hw = _ec._u32(s_words), _ec._u32(h_words)
    one, zero = fe.const(1, ax), torch.zeros_like(ax)
    d2 = fe.const(_ed.D2, ax)
    na = (ax, a_y, one, fe.mul(ax, a_y))
    bp = tuple(fe.const(v, ax) for v in (_ed.B_AFFINE, _ed._BY, 1, _ed.B_AFFINE * _ed._BY % P))
    acc = (zero, one, one, zero)
    for i in range(NBITS - 1, -1, -1):
        acc = _pt_double(acc)
        for words, q in ((sw, bp), (hw, na)):
            bit = _bit(words, i)
            acc = tuple(torch.where(bit, a, b) for a, b in zip(_pt_add(acc, q, d2), acc))
    zinv = fe.inv(acc[2])
    x = fe.canonical(fe.mul(acc[0], zinv))
    y = fe.canonical(fe.mul(acc[1], zinv))
    ok = (y == _ec._u32(rlimb).T).all(dim=1) & ((x[:, 0] & 1) == _ec._u32(rsign)[0])
    return ok.to(torch.int32)


def k5_fe_ops(s_words: np.ndarray, h_words: np.ndarray) -> Tuple[int, int]:
    """(multiplications, squarings) of the reference's bit-serial schedule
    (``verify_ref``) over these rows (row-major (n, 8) words), which K5's
    bound is read against: a row's 253 doublings (4 and 4), an addition (9
    multiplications) for each set bit of s and of h below 2^253, -A's T,
    Z^-1 and x, y. K5's own schedule does ``ed25519_cuda.ladder_fe_ops()``
    a row whatever the scalars."""
    n = s_words.shape[0]
    bits = sum(int(np.unpackbits(np.ascontiguousarray(w, dtype="<u4").view(np.uint8),
                                 bitorder="little").sum()) for w in (s_words, h_words))
    muls = n * (NBITS * 4 + 1 + fe.INV_MULS + 2) + 9 * bits
    return muls, n * (NBITS * 4 + fe.INV_SQUARINGS)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

# launches of K5: the wrapper adds one where it launches the kernel
launches: Dict[str, int] = {NAME: 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
# consts, negax, ay, sw, hw, rlimb, rsign, ok, b, lanes_per_row,
# rows_per_block, blocks, smem_bytes, stream
_ARGTYPES = [_P] * 8 + [_I] * 5 + [_P]


def reset_launches() -> None:
    launches[NAME] = 0


def k5_geometry(b: int) -> Tuple[int, int, int, int]:
    """(lanes_per_row, rows_per_block, blocks, smem_bytes) of K5 over b
    rows: K2's (``ed25519_cuda.k2_geometry``), whose body K5 runs."""
    return _ec.k2_geometry(b)


def verify_rows(negax, ay, s_words, h_words, rlimb, rsign) -> torch.Tensor:
    """K5. CPU tensors take ``verify_ref``; CUDA tensors launch the kernel
    on the current stream (no synchronisation). Returns int32 ok (b,)."""
    ins = (negax, ay, s_words, h_words, rlimb, rsign)
    b = negax.shape[1]
    for nm, t, shp in (("negax", negax, (NLIMB, b)), ("ay", ay, (NLIMB, b)),
                       ("s_words", s_words, (8, b)), ("h_words", h_words, (8, b)),
                       ("rlimb", rlimb, (NLIMB, b)), ("rsign", rsign, (1, b))):
        _ec._check(nm, t, shp)
    if _ec._on_cpu(ins):
        return verify_ref(*ins)
    if b == 0:
        raise ValueError("bad batch size 0")
    ok = torch.empty((b,), dtype=torch.int32, device=negax.device)
    _ec.launch_kernel(NAME, _ARGTYPES, launches, negax.device,
                      _ec._consts_on(negax.device).data_ptr(),
                      *(t.data_ptr() for t in ins), ok.data_ptr(), b, *k5_geometry(b))
    return ok


# ---------------------------------------------------------------------------
# Host entry point
# ---------------------------------------------------------------------------


def verify_batch(pubs: np.ndarray, msgs: Sequence[bytes], sigs: np.ndarray,
                 mesh=None, *, device: DeviceLike = None) -> np.ndarray:
    """Go-exact batched verify through K5: (N, 32) keys, N messages,
    (N, 64) signatures -> (N,) bool. Pads to ``_bucket(N, mesh)``; with a
    ``DeviceMesh`` the rows split into one contiguous shard a mesh device,
    each launched on its own device without a synchronisation between
    them (a shard of padding rows only is not launched), and the verdicts
    are gathered once. Without a mesh it runs on ``device`` (``cuda``
    unless ``device="cpu"``)."""
    n = len(pubs)
    if n == 0:
        return np.zeros((0,), dtype=bool)
    *host, valid = host_prologue(pubs, msgs, sigs)
    b = _bucket(n, mesh)
    host = [_ec._pad_rows(np.asarray(a), b) for a in host]
    if mesh is None:
        ok = verify_rows(*upload(host, resolve_device(device)))
    else:
        oks = [verify_rows(*upload([a[lo:hi] for a in host], d)) if lo < n
               else torch.zeros((hi - lo,), dtype=torch.int32, device=d)
               for (lo, hi), d in zip(mesh.split_rows(b), mesh.flat)]
        ok = mesh.gather(oks)
    return (ok[:n].cpu().numpy() != 0) & valid
