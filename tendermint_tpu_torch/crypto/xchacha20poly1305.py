"""XChaCha20-Poly1305 AEAD — randomized 24-byte nonces for ChaCha20-Poly1305
(ref: crypto/xchacha20poly1305/xchachapoly.go).

Construction mirrors the reference exactly: the first 16 nonce bytes feed
HChaCha20 to derive a subkey; the remaining 8 become the tail of a 12-byte
IETF ChaCha20-Poly1305 nonce (prefixed with 4 zero bytes, xchachapoly.go:74-80).
HChaCha20 is pure Python (one 64-byte block per seal — not a hot path); the
bulk AEAD rides the `cryptography` C implementation when installed, else
the RFC-vector-validated pure-Python fallback (crypto/sts_fallback.py).
The port's copy of the reference package's ``crypto/xchacha20poly1305.py``.
"""

from __future__ import annotations

import struct

try:
    from cryptography.exceptions import InvalidTag
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
except ImportError:  # pragma: no cover - environment-dependent
    from tendermint_tpu_torch.crypto.sts_fallback import ChaCha20Poly1305, InvalidTag

KEY_SIZE = 32
NONCE_SIZE = 24
TAG_SIZE = 16
# single-call plaintext ceiling (xchachapoly.go:27-30)
MAX_PLAINTEXT_SIZE = (1 << 38) - 64
MAX_CIPHERTEXT_SIZE = (1 << 38) - 48

_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
_MASK = 0xFFFFFFFF


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _MASK


def hchacha20(key: bytes, nonce16: bytes) -> bytes:
    """32 pseudo-random bytes from a 256-bit key and 128-bit nonce
    (xchachapoly.go:132-168)."""
    if len(key) != KEY_SIZE:
        raise ValueError("hchacha20: key must be 32 bytes")
    if len(nonce16) != 16:
        raise ValueError("hchacha20: nonce must be 16 bytes")
    v = list(_SIGMA) + list(struct.unpack("<8I", key)) + list(
        struct.unpack("<4I", nonce16)
    )

    def qr(a, b, c, d):
        v[a] = (v[a] + v[b]) & _MASK
        v[d] = _rotl(v[d] ^ v[a], 16)
        v[c] = (v[c] + v[d]) & _MASK
        v[b] = _rotl(v[b] ^ v[c], 12)
        v[a] = (v[a] + v[b]) & _MASK
        v[d] = _rotl(v[d] ^ v[a], 8)
        v[c] = (v[c] + v[d]) & _MASK
        v[b] = _rotl(v[b] ^ v[c], 7)

    for _ in range(10):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    return struct.pack("<8I", *(v[i] for i in (0, 1, 2, 3, 12, 13, 14, 15)))


def _subparts(key: bytes, nonce: bytes):
    if len(key) != KEY_SIZE:
        raise ValueError("xchacha20poly1305: bad key length")
    if len(nonce) != NONCE_SIZE:
        raise ValueError("xchacha20poly1305: bad nonce length")
    subkey = hchacha20(key, nonce[:16])
    return subkey, b"\x00" * 4 + nonce[16:]


def seal(key: bytes, nonce: bytes, plaintext: bytes, ad: bytes = b"") -> bytes:
    """Encrypt + authenticate; output = ciphertext || 16-byte tag."""
    if len(plaintext) > MAX_PLAINTEXT_SIZE:
        raise ValueError("xchacha20poly1305: plaintext too large")
    subkey, n12 = _subparts(key, nonce)
    return ChaCha20Poly1305(subkey).encrypt(n12, plaintext, ad or None)


def open_(key: bytes, nonce: bytes, ciphertext: bytes, ad: bytes = b"") -> bytes:
    """Authenticate + decrypt; raises ValueError on forgery."""
    if len(ciphertext) < TAG_SIZE:
        raise ValueError("xchacha20poly1305: ciphertext too short")
    if len(ciphertext) > MAX_CIPHERTEXT_SIZE:
        raise ValueError("xchacha20poly1305: ciphertext too large")
    subkey, n12 = _subparts(key, nonce)
    try:
        return ChaCha20Poly1305(subkey).decrypt(n12, ciphertext, ad or None)
    except InvalidTag:
        raise ValueError("xchacha20poly1305: message authentication failed")
