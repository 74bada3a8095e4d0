"""XSalsa20-Poly1305 secretbox + passphrase-style symmetric encryption
(ref: crypto/xsalsa20symmetric/symmetric.go — NaCl secretbox with a random
24-byte nonce prepended to the ciphertext).

Pure Python: Salsa20 core + HSalsa20 + Poly1305. This guards key files and
operator material, not the data plane — clarity over speed.  Layout matches
the reference: ciphertext = nonce(24) || secretbox(= tag(16) || body).
The port's copy of the reference package's ``crypto/xsalsa20.py``.
"""

from __future__ import annotations

import hmac as _hmac
import os
import struct

NONCE_LEN = 24
SECRET_LEN = 32
OVERHEAD = 16  # poly1305 tag

_MASK = 0xFFFFFFFF
_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _MASK


def _salsa20_rounds(state):
    """20 rounds (10 double rounds) over a 16-word state; returns the
    post-round words WITHOUT the feed-forward addition."""
    x = list(state)

    def qr(a, b, c, d):
        x[b] ^= _rotl((x[a] + x[d]) & _MASK, 7)
        x[c] ^= _rotl((x[b] + x[a]) & _MASK, 9)
        x[d] ^= _rotl((x[c] + x[b]) & _MASK, 13)
        x[a] ^= _rotl((x[d] + x[c]) & _MASK, 18)

    for _ in range(10):
        # column round
        qr(0, 4, 8, 12)
        qr(5, 9, 13, 1)
        qr(10, 14, 2, 6)
        qr(15, 3, 7, 11)
        # row round
        qr(0, 1, 2, 3)
        qr(5, 6, 7, 4)
        qr(10, 11, 8, 9)
        qr(15, 12, 13, 14)
    return x


def _salsa20_block(key: bytes, nonce8: bytes, counter: int) -> bytes:
    """One 64-byte Salsa20 keystream block."""
    k = struct.unpack("<8I", key)
    n = struct.unpack("<2I", nonce8)
    c = (counter & _MASK, (counter >> 32) & _MASK)
    state = (
        _SIGMA[0], k[0], k[1], k[2],
        k[3], _SIGMA[1], n[0], n[1],
        c[0], c[1], _SIGMA[2], k[4],
        k[5], k[6], k[7], _SIGMA[3],
    )
    x = _salsa20_rounds(state)
    return struct.pack("<16I", *((a + b) & _MASK for a, b in zip(x, state)))


def hsalsa20(key: bytes, nonce16: bytes) -> bytes:
    """Subkey derivation: the diagonal+nonce words of the un-fed-forward
    Salsa20 state (NaCl core_hsalsa20)."""
    k = struct.unpack("<8I", key)
    n = struct.unpack("<4I", nonce16)
    state = (
        _SIGMA[0], k[0], k[1], k[2],
        k[3], _SIGMA[1], n[0], n[1],
        n[2], n[3], _SIGMA[2], k[4],
        k[5], k[6], k[7], _SIGMA[3],
    )
    x = _salsa20_rounds(state)
    return struct.pack("<8I", *(x[i] for i in (0, 5, 10, 15, 6, 7, 8, 9)))


def _xsalsa20_stream(key: bytes, nonce24: bytes, length: int) -> bytes:
    """Keystream for XSalsa20: HSalsa20 subkey + 8-byte nonce tail."""
    subkey = hsalsa20(key, nonce24[:16])
    out = bytearray()
    counter = 0
    while len(out) < length:
        out += _salsa20_block(subkey, nonce24[16:], counter)
        counter += 1
    return bytes(out[:length])


def _poly1305(key32: bytes, msg: bytes) -> bytes:
    """One-shot Poly1305 MAC (RFC 8439 §2.5)."""
    r = int.from_bytes(key32[:16], "little") & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key32[16:], "little")
    p = (1 << 130) - 5
    acc = 0
    for i in range(0, len(msg), 16):
        blk = msg[i : i + 16]
        n = int.from_bytes(blk + b"\x01", "little")
        acc = ((acc + n) * r) % p
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def secretbox_seal(plaintext: bytes, nonce24: bytes, key: bytes) -> bytes:
    """NaCl crypto_secretbox: returns tag(16) || ciphertext. The first 32
    keystream bytes become the Poly1305 key; encryption starts at keystream
    offset 32 (i.e. the rest of block 0, then blocks 1..)."""
    stream = _xsalsa20_stream(key, nonce24, 32 + len(plaintext))
    poly_key, pad = stream[:32], stream[32:]
    ct = bytes(a ^ b for a, b in zip(plaintext, pad))
    return _poly1305(poly_key, ct) + ct


def secretbox_open(boxed: bytes, nonce24: bytes, key: bytes):
    """Returns plaintext or None on authentication failure."""
    if len(boxed) < OVERHEAD:
        return None
    tag, ct = boxed[:OVERHEAD], boxed[OVERHEAD:]
    stream = _xsalsa20_stream(key, nonce24, 32 + len(ct))
    poly_key, pad = stream[:32], stream[32:]
    if not _hmac.compare_digest(tag, _poly1305(poly_key, ct)):
        return None
    return bytes(a ^ b for a, b in zip(ct, pad))


def encrypt_symmetric(plaintext: bytes, secret: bytes) -> bytes:
    """symmetric.go:21 EncryptSymmetric: random nonce prepended; secret must
    be 32 bytes (e.g. sha256 of a KDF output)."""
    if len(secret) != SECRET_LEN:
        raise ValueError(f"secret must be {SECRET_LEN} bytes, got {len(secret)}")
    nonce = os.urandom(NONCE_LEN)
    return nonce + secretbox_seal(plaintext, nonce, secret)


def decrypt_symmetric(ciphertext: bytes, secret: bytes) -> bytes:
    """symmetric.go:38 DecryptSymmetric; raises ValueError on failure."""
    if len(secret) != SECRET_LEN:
        raise ValueError(f"secret must be {SECRET_LEN} bytes, got {len(secret)}")
    if len(ciphertext) <= OVERHEAD + NONCE_LEN:
        # NOTE: `<=` (not `<`) is deliberate reference parity — symmetric.go:44
        # also rejects the 40-byte ciphertext of an empty plaintext, so an
        # empty payload encrypts but never decrypts there either
        raise ValueError("ciphertext is too short")
    nonce, boxed = ciphertext[:NONCE_LEN], ciphertext[NONCE_LEN:]
    out = secretbox_open(boxed, nonce, secret)
    if out is None:
        raise ValueError("ciphertext decryption failed")
    return out
