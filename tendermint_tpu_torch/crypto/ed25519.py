"""Host-side Ed25519 with the accept/reject set of Go's x/crypto ed25519.

Pure Python: the port's oracle and its key generation/signing. The Go
accept set that every batch path must reproduce:

  * s is checked only by ``sig[63] & 224 != 0`` (reject); s in [L, 2^253)
    is accepted, so no batch path may range-check s;
  * A's y is loaded as a 255-bit little-endian integer and reduced mod p:
    a non-canonical key (y >= p) is accepted; a key that does not
    decompress is rejected;
  * the final check compares the canonical encoding of R' = [s]B - [h]A
    with sig[:32] byte for byte, so a non-canonical R never matches;
  * h = SHA-512(R || A || M) reduced exactly mod L: A may carry a
    small-order component, so [h]A depends on h itself.

Key layout mirrors the reference: private key = seed || pubkey (64 bytes),
pubkey 32 bytes, signature 64 bytes.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional, Tuple

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493  # group order
D = (-121665 * pow(121666, P - 2, P)) % P
D2 = (2 * D) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

_BY = (4 * pow(5, P - 2, P)) % P  # base point y = 4/5


def _decompress_xy(s: bytes) -> Optional[Tuple[int, int]]:
    """Go's ExtendedGroupElement.FromBytes: affine (x, y) or None. Accepts a
    non-canonical y (reduced mod p); the sign bit selects x's parity."""
    y_raw = int.from_bytes(s, "little")
    sign = (y_raw >> 255) & 1
    y = (y_raw & ((1 << 255) - 1)) % P
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    x = (u * pow(v, 3, P) * pow((u * pow(v, 7, P)) % P, (P - 5) // 8, P)) % P
    vxx = (v * x * x) % P
    if (vxx - u) % P != 0:
        if (vxx + u) % P != 0:
            return None
        x = (x * SQRT_M1) % P
    if (x & 1) != sign:
        x = (P - x) % P
    return (x, y)


_B_PT = _decompress_xy(_BY.to_bytes(32, "little"))
B_AFFINE = _B_PT[0]
del _B_PT

# Extended coordinates (X, Y, Z, T), x = X/Z, y = Y/Z, T = XY/Z. The law is
# complete for a = -1 and non-square d, so low-order points need no case.
IDENT = (0, 1, 1, 0)


def _to_extended(pt: Tuple[int, int]) -> Tuple[int, int, int, int]:
    x, y = pt
    return (x, y, 1, (x * y) % P)


def pt_add(p1, p2):
    """add-2008-hwcd-3."""
    X1, Y1, Z1, T1 = p1
    X2, Y2, Z2, T2 = p2
    A = ((Y1 - X1) * (Y2 - X2)) % P
    Bv = ((Y1 + X1) * (Y2 + X2)) % P
    C = (T1 * D2 % P) * T2 % P
    Dv = (Z1 * 2 * Z2) % P
    E = (Bv - A) % P
    F = (Dv - C) % P
    G = (Dv + C) % P
    H = (Bv + A) % P
    return ((E * F) % P, (G * H) % P, (F * G) % P, (E * H) % P)


def pt_double(p1):
    """dbl-2008-hwcd."""
    X1, Y1, Z1, _ = p1
    A = (X1 * X1) % P
    Bv = (Y1 * Y1) % P
    C = (2 * Z1 * Z1) % P
    H = (A + Bv) % P
    E = (H - (X1 + Y1) * (X1 + Y1)) % P
    G = (A - Bv) % P
    F = (C + G) % P
    return ((E * F) % P, (G * H) % P, (F * G) % P, (E * H) % P)


def pt_scalar_mult(pt, k: int):
    acc = IDENT
    base = pt
    while k:
        if k & 1:
            acc = pt_add(acc, base)
        base = pt_double(base)
        k >>= 1
    return acc


def pt_affine(p1) -> Tuple[int, int]:
    X, Y, Z, _ = p1
    zi = pow(Z, P - 2, P)
    return (X * zi) % P, (Y * zi) % P


def pt_encode(p1) -> bytes:
    x, y = pt_affine(p1)
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


B_EXT = _to_extended((B_AFFINE, _BY))


def _verify_pure(public_key: bytes, message: bytes, sig: bytes) -> bool:
    """Literal mirror of golang.org/x/crypto/ed25519.Verify."""
    if len(public_key) != 32 or len(sig) != 64:
        return False
    if sig[63] & 224 != 0:
        return False
    A = _decompress_xy(public_key)
    if A is None:
        return False
    neg_a = ((P - A[0]) % P, A[1])
    h = int.from_bytes(
        hashlib.sha512(sig[:32] + public_key + message).digest(), "little"
    ) % L
    s = int.from_bytes(sig[32:], "little")
    r_check = pt_add(
        pt_scalar_mult(_to_extended(neg_a), h), pt_scalar_mult(B_EXT, s)
    )
    return pt_encode(r_check) == sig[:32]


# [d * 2^(8w)]B for every byte window w and digit d: any [k]B then costs at
# most 32 additions and no doublings. Built on first use (~8k point adds).
_B_TABLE = None


def _b_table():
    global _B_TABLE
    if _B_TABLE is None:
        table = []
        base = B_EXT
        for _ in range(32):
            row = [None] * 256
            acc = base
            for d in range(1, 256):
                row[d] = acc
                acc = pt_add(acc, base)
            table.append(row)
            base = acc  # [256 * 2^(8w)]B == [2^(8(w+1))]B
        _B_TABLE = table
    return _B_TABLE


def _mul_b(k: int):
    """[k]B off the byte-window table, for 0 <= k < 2^256."""
    table = _b_table()
    acc = None
    w = 0
    while k:
        d = k & 0xFF
        if d:
            p = table[w][d]
            acc = p if acc is None else pt_add(acc, p)
        k >>= 8
        w += 1
    return IDENT if acc is None else acc


def _clamped_scalar(seed: bytes) -> Tuple[int, bytes]:
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def pubkey_from_seed(seed: bytes) -> bytes:
    a, _ = _clamped_scalar(seed)
    return pt_encode(_mul_b(a))


def gen_privkey(seed: Optional[bytes] = None) -> bytes:
    """64-byte private key (seed || pubkey), Go's NewKeyFromSeed layout."""
    if seed is None:
        seed = os.urandom(32)
    if len(seed) != 32:
        raise ValueError("seed must be 32 bytes")
    return seed + pubkey_from_seed(seed)


def sign(private_key: bytes, message: bytes) -> bytes:
    """RFC 8032 sign (identical to Go's Sign); [r]B comes off the window
    table, and the pubkey half of the private key is used as A."""
    if len(private_key) != 64:
        raise ValueError("ed25519 private key must be 64 bytes (seed || pubkey)")
    a, prefix = _clamped_scalar(private_key[:32])
    A_enc = private_key[32:]
    r = int.from_bytes(hashlib.sha512(prefix + message).digest(), "little") % L
    R_enc = pt_encode(_mul_b(r))
    k = int.from_bytes(
        hashlib.sha512(R_enc + A_enc + message).digest(), "little"
    ) % L
    s = (r + k * a) % L
    return R_enc + s.to_bytes(32, "little")
