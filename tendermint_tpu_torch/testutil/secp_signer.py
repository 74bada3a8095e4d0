"""Fast secp256k1 key generation and signing for the port's fixtures.

The same keys and the same RFC 6979 low-s DER signatures as the oracle
(``crypto/secp256k1.py``: ``pubkey_compressed``, ``sign``), with k G and d G
taken from a fixed-base table [j 16^i] G (64 rows of 15 affine points), so a
scalar multiplication is at most 64 additions instead of 256 doublings and
about 128 additions. Inverses use ``pow(x, -1, m)``, which equals the
oracle's ``pow(x, m - 2, m)`` for the prime moduli here.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Tuple

from tendermint_tpu_torch.crypto import secp256k1 as _s

P, N = _s.P, _s.N
_table: List[List[Optional[tuple]]] = []


def _affine(pt) -> Optional[Tuple[int, int]]:
    if pt is None:
        return None
    X, Y, Z = pt
    zi = pow(Z, -1, P)
    zi2 = zi * zi % P
    return X * zi2 % P, Y * zi2 * zi % P


def _g_table() -> List[List[Optional[tuple]]]:
    """_table[i][j] = (j 16^i) G as Jacobian (x, y, 1); None at j = 0."""
    if not _table:
        base = _s._G
        for _ in range(64):
            row, acc = [None], None
            for _ in range(15):
                acc = _s._jadd(acc, base)
                row.append(_affine(acc) + (1,))
            _table.append(row)
            for _ in range(4):
                base = _s._jdouble(base)
    return _table


def mul_g(k: int):
    """k G (0 <= k < 2^256) in Jacobian coordinates, None for the identity."""
    table = _g_table()
    acc = None
    for i in range(64):
        d = (k >> (4 * i)) & 15
        if d:
            acc = _s._jadd(acc, table[i][d])
    return acc


def pubkey_compressed(privkey: bytes) -> bytes:
    d = int.from_bytes(privkey, "big")
    if not 0 < d < N:
        raise ValueError("invalid secp256k1 private key")
    return _s.compress_point(*_affine(mul_g(d)))


def sign(privkey: bytes, digest: bytes) -> bytes:
    """``crypto.secp256k1.sign``, step for step, with the table."""
    d = int.from_bytes(privkey, "big")
    if not 0 < d < N:
        raise ValueError("invalid secp256k1 private key")
    e = int.from_bytes(digest, "big")
    while True:
        k = _s._rfc6979_k(privkey, digest)
        r = _affine(mul_g(k))[0] % N
        if r == 0:
            digest = hashlib.sha256(digest).digest()
            continue
        s = pow(k, -1, N) * (e + r * d) % N
        if s == 0:
            digest = hashlib.sha256(digest).digest()
            continue
        if s > _s._HALF_N:
            s = N - s
        return _s.der_encode_sig(r, s)
