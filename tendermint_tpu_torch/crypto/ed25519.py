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

``verify_batch`` is the reference's host random-linear-combination batch
check (one Pippenger MSM a clean batch, chunk RLCs and exact leaf checks
to localize a dirty one), the default backend of the vote and tx feeds.
It is not an exact per-lane oracle on rows whose equation leaves a
small-order point (the RLC omits the cofactor), so the guards' audits keep
``_verify_pure``.

``verify`` is the reference's single check: OpenSSL (the ``cryptography``
package, where the host has it) on inputs in the canonical zone, where its
accept set is Go's, and ``_verify_pure`` on every other input. A key's
``verify_bytes`` and ``HostBatchVerifier`` use it, as the reference's do: at 3-7 ms a
``_verify_pure`` call, a nine-node net in one process spent its rounds
verifying each other's votes (``partition_heal_9``).
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional, Tuple

try:  # the host's OpenSSL for the canonical zone (verify)
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PublicKey

    _HAVE_CRYPTOGRAPHY = True
except ImportError:  # pragma: no cover - environment-dependent
    _HAVE_CRYPTOGRAPHY = False

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
    zi = pow(Z, -1, P)  # the inverse by extended Euclid, ~6x faster than Z^(p-2)
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


def _in_canonical_zone(public_key: bytes, sig: bytes) -> bool:
    """True when stricter RFC 8032 verifiers (OpenSSL) agree with Go: s < L,
    and both the key's y and R's y are canonical (< p)."""
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    y_pub = int.from_bytes(public_key, "little") & ((1 << 255) - 1)
    y_r = int.from_bytes(sig[:32], "little") & ((1 << 255) - 1)
    return y_pub < P and y_r < P


def verify(public_key: bytes, message: bytes, sig: bytes) -> bool:
    """Go-exact single verify (the reference's ``crypto/ed25519.verify``):
    OpenSSL in the canonical zone, ``_verify_pure`` elsewhere."""
    if len(public_key) != 32 or len(sig) != 64 or sig[63] & 224 != 0:
        return False
    if _HAVE_CRYPTOGRAPHY and _in_canonical_zone(public_key, sig):
        try:
            Ed25519PublicKey.from_public_bytes(public_key).verify(sig, message)
            return True
        except InvalidSignature:
            return False
        except ValueError:  # the key does not decompress: Go's answer
            return _verify_pure(public_key, message, sig)
    return _verify_pure(public_key, message, sig)


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


def _is_identity(pt) -> bool:
    X, Y, Z, _ = pt
    return X % P == 0 and (Y - Z) % P == 0


def _msm(pairs):
    """Pippenger multi-scalar multiplication: the sum of [k]P over (k, P)
    pairs. The bucket width follows the pair count; scalars of different
    widths (128-bit coefficients, 252-bit hash scalars) pay only for the
    windows they occupy, and the bucket fold bridges a gap of empty
    buckets with one [gap]running instead of walking it."""
    pairs = [(k, p) for k, p in pairs if k]
    if not pairs:
        return IDENT
    n = len(pairs)
    c = 4 if n < 32 else 5 if n < 128 else 6 if n < 512 else 7 if n < 2048 else 8
    maxbits = max(k.bit_length() for k, _ in pairs)
    nwin = (maxbits + c - 1) // c
    mask = (1 << c) - 1
    acc = IDENT
    for w in range(nwin - 1, -1, -1):
        if not _is_identity(acc):
            for _ in range(c):
                acc = pt_double(acc)
        shift = w * c
        buckets = {}
        for k, p in pairs:
            d = (k >> shift) & mask
            if d:
                b = buckets.get(d)
                buckets[d] = p if b is None else pt_add(b, p)
        if not buckets:
            continue
        # window_sum = sum(d * bucket[d]): a running sum over the nonzero
        # buckets in descending d, a gap bridged by [gap]running
        running = None
        window_sum = None
        prev_d = None
        for d in sorted(buckets, reverse=True):
            if running is not None:
                gap = prev_d - d
                stride = running if gap == 1 else pt_scalar_mult(running, gap)
                window_sum = (stride if window_sum is None
                              else pt_add(window_sum, stride))
            running = (buckets[d] if running is None
                       else pt_add(running, buckets[d]))
            prev_d = d
        stride = running if prev_d == 1 else pt_scalar_mult(running, prev_d)
        window_sum = stride if window_sum is None else pt_add(window_sum, stride)
        acc = window_sum if _is_identity(acc) else pt_add(acc, window_sum)
    return acc


def _rlc_holds(parsed) -> bool:
    """One random linear combination over parsed rows:
    sum_i z_i ([s_i]B - [h_i]A_i - R_i) == identity, with 128-bit z_i from
    ``os.urandom`` drawn after the signatures are fixed, in row order. The
    shared base point rides the window table as one [sum z_i s_i]B."""
    s_b = 0
    pairs = []
    for _, neg_a, neg_r, h, s in parsed:
        z = int.from_bytes(os.urandom(16), "little") or 1
        s_b = (s_b + z * s) % L
        pairs.append(((z * h) % L, neg_a))
        pairs.append((z, neg_r))
    acc = _msm(pairs)
    return _is_identity(pt_add(acc, _mul_b(s_b)))


def _leaf_verify(item) -> bool:
    """The exact check of one parsed row: [s]B - [h]A == R as group
    elements. Parsing pinned R's encoding to its canonical bytes, where
    group equality is Go's byte compare; the compare cross-multiplies."""
    _, neg_a, neg_r, h, s = item
    t = pt_add(_mul_b(s), pt_scalar_mult(neg_a, h))
    x_r, y_r = (P - neg_r[0]) % P, neg_r[1]
    X, Y, Z, _ = t
    return (X - x_r * Z) % P == 0 and (Y - y_r * Z) % P == 0


_CHUNK = 32  # localization chunk: a failed RLC re-checks N/32 groups


def _resolve_batch(parsed, out) -> None:
    """One RLC for the whole batch (a clean flush, the common case); when
    it fails, one RLC a chunk of ``_CHUNK`` rows, and an exact leaf check
    for each row of a chunk that fails (or of a chunk of 4 rows or
    fewer)."""
    if not parsed:
        return
    if _rlc_holds(parsed):
        for item in parsed:
            out[item[0]] = True
        return
    for lo in range(0, len(parsed), _CHUNK):
        chunk = parsed[lo: lo + _CHUNK]
        if len(chunk) > 4 and _rlc_holds(chunk):
            for item in chunk:
                out[item[0]] = True
            continue
        for item in chunk:
            out[item[0]] = _leaf_verify(item)


# -A in extended coordinates by raw pubkey bytes (None: the key does not
# decompress): a validator's key is decompressed once a process, not once a
# flush. Points are immutable tuples; the bound caps a stream of fresh keys.
_A_NEG_CACHE: dict = {}
_A_NEG_CACHE_MAX = 16384


def _parse_batch(items, compute_h: bool = True) -> Tuple[list, List[bool]]:
    """[(public_key, message, sig), ...] -> (parsed, out). Go's edges are
    applied here: a row with a bad length, a set top-3 bit in s, an A or R
    that does not decompress, or a non-canonical R encoding stays False in
    ``out`` and never reaches the MSM. ``parsed`` holds (i, -A, -R, h, s)
    rows; ``compute_h=False`` leaves h at 0 for a caller that hashes
    elsewhere."""
    out = [False] * len(items)
    parsed = []
    a_cache = _A_NEG_CACHE
    if len(a_cache) > _A_NEG_CACHE_MAX:
        a_cache.clear()
    for i, (pub, msg, sig) in enumerate(items):
        pub, sig = bytes(pub), bytes(sig)
        if len(pub) != 32 or len(sig) != 64 or sig[63] & 224 != 0:
            continue
        if pub in a_cache:
            neg_a = a_cache[pub]
        else:
            A = _decompress_xy(pub)
            neg_a = None if A is None else _to_extended(((P - A[0]) % P, A[1]))
            a_cache[pub] = neg_a
        if neg_a is None:
            continue
        R = _decompress_xy(sig[:32])
        if R is None:
            continue
        # Go compares bytes with the canonical re-encoding of R': an R whose
        # encoding is not its own canonical form can never match
        if (R[1] | ((R[0] & 1) << 255)).to_bytes(32, "little") != sig[:32]:
            continue
        if compute_h:
            h = int.from_bytes(
                hashlib.sha512(sig[:32] + pub + bytes(msg)).digest(), "little"
            ) % L
        else:
            h = 0
        s = int.from_bytes(sig[32:], "little") % L  # [s]B == [s mod L]B
        neg_r = _to_extended(((P - R[0]) % P, R[1]))
        parsed.append((i, neg_a, neg_r, h, s))
    return parsed, out


def verify_batch(items) -> List[bool]:
    """Batch verification of [(public_key, message, sig), ...]: the RLC
    route of the reference's ``verify_batch``, which is what the reference
    runs on a host without the ``cryptography`` package."""
    parsed, out = _parse_batch(items)
    _resolve_batch(parsed, out)
    return out


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
