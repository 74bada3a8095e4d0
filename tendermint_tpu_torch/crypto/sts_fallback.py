"""Pure-Python fallback primitives for the Station-to-Station transport,
the port's copy of the reference package's ``crypto/sts_fallback.py``.

The p2p secret connection (``p2p/conn/secret_connection.py``) rides the
``cryptography`` package's C implementations when that package imports.
Where it does not, this module is the data plane of every connection: it
supplies drop-in replacements for exactly the surface the secret
connection uses:

* ``X25519PrivateKey`` / ``X25519PublicKey`` — RFC 7748 curve25519
  Diffie-Hellman (Montgomery ladder over GF(2^255-19));
* ``ChaCha20Poly1305`` — RFC 8439 AEAD (ChaCha20 stream cipher keyed
  Poly1305 one-time MAC, IETF 96-bit nonce);
* ``HKDF`` + ``hashes.SHA256`` — RFC 5869 extract-and-expand over the
  stdlib's hmac/hashlib;
* ``InvalidTag`` — raised on AEAD authentication failure, mirroring
  ``cryptography.exceptions.InvalidTag``.

Everything here is held against the RFC 7748 / RFC 8439 / RFC 5869 test
vectors and against ``cryptography`` on seeded inputs in
``tests/test_torch_p2p.py``. Python-speed crypto is 2-3 orders of
magnitude slower than the C path; callers keep preferring ``cryptography``
when it is importable.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import os
import struct

__all__ = [
    "ChaCha20Poly1305",
    "HKDF",
    "InvalidTag",
    "X25519PrivateKey",
    "X25519PublicKey",
    "hashes",
    "x25519_scalarmult",
]


class InvalidTag(Exception):
    """AEAD authentication failed (ciphertext or AAD was tampered with)."""


# ---------------------------------------------------------------------------
# X25519 (RFC 7748 §5)
# ---------------------------------------------------------------------------

_P = 2**255 - 19
_A24 = 121665
_BASE_POINT = (9).to_bytes(32, "little")


def _clamp_scalar(k: bytes) -> int:
    if len(k) != 32:
        raise ValueError("X25519 scalar must be 32 bytes")
    b = bytearray(k)
    b[0] &= 248
    b[31] &= 127
    b[31] |= 64
    return int.from_bytes(bytes(b), "little")


def _decode_u(u: bytes) -> int:
    if len(u) != 32:
        raise ValueError("X25519 u-coordinate must be 32 bytes")
    # mask the unused top bit (RFC 7748 §5: "MUST mask the most significant
    # bit of the final byte")
    b = bytearray(u)
    b[31] &= 127
    return int.from_bytes(bytes(b), "little")


def x25519_scalarmult(k: bytes, u: bytes) -> bytes:
    """RFC 7748 X25519(k, u): constant-structure Montgomery ladder."""
    k_int = _clamp_scalar(k)
    x1 = _decode_u(u) % _P
    x2, z2 = 1, 0
    x3, z3 = x1, 1
    swap = 0
    for t in reversed(range(255)):
        k_t = (k_int >> t) & 1
        swap ^= k_t
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = k_t
        a = (x2 + z2) % _P
        aa = a * a % _P
        b = (x2 - z2) % _P
        bb = b * b % _P
        e = (aa - bb) % _P
        c = (x3 + z3) % _P
        d = (x3 - z3) % _P
        da = d * a % _P
        cb = c * b % _P
        x3 = da + cb
        x3 = x3 * x3 % _P
        z3 = da - cb
        z3 = z3 * z3 % _P
        z3 = z3 * x1 % _P
        x2 = aa * bb % _P
        z2 = e * (aa + _A24 * e) % _P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    return (x2 * pow(z2, _P - 2, _P) % _P).to_bytes(32, "little")


class X25519PublicKey:
    """Mirrors cryptography's X25519PublicKey surface used by the STS code."""

    def __init__(self, data: bytes):
        if len(data) != 32:
            raise ValueError("X25519 public key must be 32 bytes")
        self._data = bytes(data)

    @classmethod
    def from_public_bytes(cls, data: bytes) -> "X25519PublicKey":
        return cls(data)

    def public_bytes_raw(self) -> bytes:
        return self._data


class X25519PrivateKey:
    def __init__(self, data: bytes):
        if len(data) != 32:
            raise ValueError("X25519 private key must be 32 bytes")
        self._data = bytes(data)

    @classmethod
    def generate(cls) -> "X25519PrivateKey":
        return cls(os.urandom(32))

    @classmethod
    def from_private_bytes(cls, data: bytes) -> "X25519PrivateKey":
        return cls(data)

    def private_bytes_raw(self) -> bytes:
        return self._data

    def public_key(self) -> X25519PublicKey:
        return X25519PublicKey(x25519_scalarmult(self._data, _BASE_POINT))

    def exchange(self, peer_public_key: X25519PublicKey) -> bytes:
        shared = x25519_scalarmult(
            self._data, peer_public_key.public_bytes_raw()
        )
        # contributory-behavior check, same as cryptography/OpenSSL: a
        # small-order peer point yields the all-zero secret
        if not any(shared):
            raise ValueError("X25519 exchange produced an all-zero secret")
        return shared


# ---------------------------------------------------------------------------
# ChaCha20 (RFC 8439 §2.3) and Poly1305 (§2.5)
# ---------------------------------------------------------------------------

_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
_MASK = 0xFFFFFFFF


def chacha20_block(key: bytes, counter: int, nonce: bytes) -> bytes:
    """One 64-byte ChaCha20 keystream block (RFC 8439 §2.3)."""
    if len(key) != 32:
        raise ValueError("chacha20: key must be 32 bytes")
    if len(nonce) != 12:
        raise ValueError("chacha20: nonce must be 12 bytes")
    init = list(_SIGMA) + list(struct.unpack("<8I", key)) + [
        counter & _MASK
    ] + list(struct.unpack("<3I", nonce))
    v = init[:]

    def qr(a, b, c, d):
        v[a] = (v[a] + v[b]) & _MASK
        x = v[d] ^ v[a]
        v[d] = ((x << 16) | (x >> 16)) & _MASK
        v[c] = (v[c] + v[d]) & _MASK
        x = v[b] ^ v[c]
        v[b] = ((x << 12) | (x >> 20)) & _MASK
        v[a] = (v[a] + v[b]) & _MASK
        x = v[d] ^ v[a]
        v[d] = ((x << 8) | (x >> 24)) & _MASK
        v[c] = (v[c] + v[d]) & _MASK
        x = v[b] ^ v[c]
        v[b] = ((x << 7) | (x >> 25)) & _MASK

    for _ in range(10):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    return struct.pack("<16I", *((v[i] + init[i]) & _MASK for i in range(16)))


def chacha20_xor(key: bytes, counter: int, nonce: bytes, data: bytes) -> bytes:
    """Encrypt/decrypt `data` with the keystream starting at `counter`."""
    out = bytearray(len(data))
    for block_i in range((len(data) + 63) // 64):
        ks = chacha20_block(key, counter + block_i, nonce)
        off = block_i * 64
        chunk = data[off : off + 64]
        out[off : off + len(chunk)] = bytes(
            a ^ b for a, b in zip(chunk, ks)
        )
    return bytes(out)


_P1305 = (1 << 130) - 5


def poly1305_mac(key: bytes, msg: bytes) -> bytes:
    """RFC 8439 §2.5 one-time authenticator; `key` is r||s (32 bytes)."""
    if len(key) != 32:
        raise ValueError("poly1305: key must be 32 bytes")
    r = int.from_bytes(key[:16], "little") & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key[16:], "little")
    acc = 0
    for i in range(0, len(msg), 16):
        block = msg[i : i + 16]
        n = int.from_bytes(block + b"\x01", "little")
        acc = (acc + n) * r % _P1305
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _pad16(data: bytes) -> bytes:
    rem = len(data) % 16
    return b"" if rem == 0 else b"\x00" * (16 - rem)


class ChaCha20Poly1305:
    """RFC 8439 §2.8 AEAD, mirroring cryptography's ChaCha20Poly1305 API."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("ChaCha20Poly1305 key must be 32 bytes")
        self._key = bytes(key)

    def _mac_key(self, nonce: bytes) -> bytes:
        return chacha20_block(self._key, 0, nonce)[:32]

    def _tag(self, nonce: bytes, aad: bytes, ciphertext: bytes) -> bytes:
        mac_data = (
            aad + _pad16(aad)
            + ciphertext + _pad16(ciphertext)
            + struct.pack("<QQ", len(aad), len(ciphertext))
        )
        return poly1305_mac(self._mac_key(nonce), mac_data)

    def encrypt(self, nonce: bytes, data: bytes, associated_data) -> bytes:
        if len(nonce) != 12:
            raise ValueError("ChaCha20Poly1305 nonce must be 12 bytes")
        aad = associated_data or b""
        ciphertext = chacha20_xor(self._key, 1, nonce, data)
        return ciphertext + self._tag(nonce, aad, ciphertext)

    def decrypt(self, nonce: bytes, data: bytes, associated_data) -> bytes:
        if len(nonce) != 12:
            raise ValueError("ChaCha20Poly1305 nonce must be 12 bytes")
        if len(data) < 16:
            raise InvalidTag("ciphertext shorter than the Poly1305 tag")
        aad = associated_data or b""
        ciphertext, tag = data[:-16], data[-16:]
        expected = self._tag(nonce, aad, ciphertext)
        if not _hmac.compare_digest(tag, expected):
            raise InvalidTag("message authentication failed")
        return chacha20_xor(self._key, 1, nonce, ciphertext)


# ---------------------------------------------------------------------------
# HKDF (RFC 5869) over stdlib hmac/hashlib
# ---------------------------------------------------------------------------

class _SHA256:
    name = "sha256"
    digest_size = 32


class hashes:  # noqa: N801 - mirrors the cryptography module-as-namespace
    SHA256 = _SHA256


class HKDF:
    """RFC 5869 extract-and-expand; only SHA-256 is needed here."""

    def __init__(self, algorithm, length: int, salt, info):
        if getattr(algorithm, "name", None) != "sha256":
            raise ValueError("fallback HKDF supports SHA-256 only")
        if length > 255 * 32:
            raise ValueError("HKDF output length too large")
        self._length = length
        self._salt = salt if salt is not None else b"\x00" * 32
        self._info = info or b""
        self._used = False

    def derive(self, key_material: bytes) -> bytes:
        if self._used:
            raise RuntimeError("HKDF instances can only be used once")
        self._used = True
        prk = _hmac.new(self._salt, key_material, hashlib.sha256).digest()
        okm = b""
        t = b""
        counter = 1
        while len(okm) < self._length:
            t = _hmac.new(
                prk, t + self._info + bytes([counter]), hashlib.sha256
            ).digest()
            okm += t
            counter += 1
        return okm[: self._length]
