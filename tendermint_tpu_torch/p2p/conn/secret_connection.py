"""Authenticated-encryption transport: the Station-to-Station handshake and
framed AEAD channel every peer connection is upgraded through (ref
p2p/conn/secret_connection.go:37-106), the port's copy of the reference
package's ``p2p/conn/secret_connection.py``. Both ends of a connection may
be either package, on either backend: the bytes on the wire are the same.

Protocol (semantics per the reference; wire encoding is the framework codec,
not amino):

1. exchange ephemeral X25519 pubkeys (32 raw bytes each way);
2. shared secret = X25519(local_eph_priv, remote_eph_pub);
3. HKDF-SHA256 expands the secret into two ChaCha20-Poly1305 keys + a 32-byte
   challenge; which key is send vs recv depends on whose ephemeral key sorts
   lexicographically lower (secret_connection.go:241-270) — so both ends
   derive mirrored key assignments;
4. all further traffic is 1028-byte frames (4-byte LE length + 1024 data)
   sealed with ChaCha20-Poly1305 under a 12-byte nonce whose low 8 bytes are
   a little-endian counter (secret_connection.go:336-344);
5. over the now-encrypted channel, exchange (node pubkey, sig(challenge)) and
   verify — authenticating the long-lived node identity.

Concurrency: send and recv use independent keys + nonces; one thread may
write while another reads (MConnection does exactly that). Each direction is
internally locked.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Optional

# `cryptography` gives the C-speed data plane; without it the pure-Python
# fallback (crypto/sts_fallback.py, RFC-vector validated) keeps the STS
# handshake and framed AEAD channel fully functional: slower, but correct
# and wire-compatible, so mixed deployments interoperate. STS_BACKEND says
# which one this process took.
try:
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
        X25519PublicKey,
    )
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF

    STS_BACKEND = "cryptography"
except ImportError:  # pragma: no cover - environment-dependent
    from tendermint_tpu_torch.crypto.sts_fallback import (
        HKDF,
        ChaCha20Poly1305,
        X25519PrivateKey,
        X25519PublicKey,
        hashes,
    )

    STS_BACKEND = "fallback"

from tendermint_tpu_torch.crypto.keys import _PUBKEY_TYPES, PubKey
from tendermint_tpu_torch.encoding.codec import Reader, Writer, length_prefix

DATA_LEN_SIZE = 4
DATA_MAX_SIZE = 1024
TOTAL_FRAME_SIZE = DATA_MAX_SIZE + DATA_LEN_SIZE
AEAD_TAG_SIZE = 16
SEALED_FRAME_SIZE = TOTAL_FRAME_SIZE + AEAD_TAG_SIZE
NONCE_SIZE = 12

HKDF_INFO = b"TENDERMINT_SECRET_CONNECTION_KEY_AND_CHALLENGE_GEN"


class HandshakeError(Exception):
    pass


class _Nonce:
    """96-bit nonce; low 64 bits (offset 4, little-endian) count frames."""

    __slots__ = ("_counter",)

    def __init__(self):
        self._counter = 0

    def next(self) -> bytes:
        n = b"\x00\x00\x00\x00" + struct.pack("<Q", self._counter)
        self._counter += 1
        return n


class RawConn:
    """Minimal blocking byte-stream over a socket object.

    ``set_deadline`` imposes an *absolute* wall-clock bound across all
    subsequent operations (the reference's conn.SetDeadline) — a per-recv
    timeout alone would let a slow-loris peer drip bytes forever."""

    def __init__(self, sock):
        self._sock = sock
        self._deadline: Optional[float] = None

    def set_deadline(self, deadline: Optional[float]) -> None:
        """Absolute time.monotonic() deadline for all following ops; None clears."""
        self._deadline = deadline
        if deadline is None:
            self._sock.settimeout(None)

    def _apply_deadline(self) -> None:
        if self._deadline is not None:
            remaining = self._deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError("connection deadline exceeded")
            self._sock.settimeout(remaining)

    def write(self, data: bytes) -> None:
        self._apply_deadline()
        self._sock.sendall(data)

    def read_exactly(self, n: int) -> bytes:
        chunks = []
        got = 0
        while got < n:
            self._apply_deadline()
            chunk = self._sock.recv(n - got)
            if not chunk:
                raise ConnectionError("connection closed")
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    def close(self) -> None:
        # shutdown first: close() alone does not wake a thread blocked in
        # recv() on the same socket
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def settimeout(self, t: Optional[float]) -> None:
        self._sock.settimeout(t)


class SecretConnection:
    def __init__(self, conn: RawConn, local_priv):
        """Performs the full handshake; raises HandshakeError on failure.
        Caller owns closing `conn`."""
        self._conn = conn
        self._send_lock = threading.Lock()
        self._recv_lock = threading.Lock()
        self._send_nonce = _Nonce()
        self._recv_nonce = _Nonce()
        self._recv_buffer = b""

        # 1. ephemeral key exchange (raw 32 bytes each way; every 32-byte
        #    string is a valid Curve25519 point)
        eph_priv = X25519PrivateKey.generate()
        eph_pub = eph_priv.public_key().public_bytes_raw()
        conn.write(eph_pub)
        rem_eph_pub = conn.read_exactly(32)

        loc_is_least = eph_pub < rem_eph_pub

        # 2-3. DH + HKDF → two AEAD keys + challenge
        try:
            dh_secret = eph_priv.exchange(X25519PublicKey.from_public_bytes(rem_eph_pub))
        except Exception as e:
            raise HandshakeError(f"X25519 exchange failed: {e}") from e
        okm = HKDF(
            algorithm=hashes.SHA256(), length=96, salt=None, info=HKDF_INFO
        ).derive(dh_secret)
        if loc_is_least:
            recv_key, send_key = okm[:32], okm[32:64]
        else:
            send_key, recv_key = okm[:32], okm[32:64]
        challenge = okm[64:96]
        self._send_aead = ChaCha20Poly1305(send_key)
        self._recv_aead = ChaCha20Poly1305(recv_key)

        # 5. authenticate node identities over the encrypted channel
        sig = local_priv.sign(challenge)
        w = Writer()
        w.string(local_priv.pub_key().type_name)
        w.bytes(local_priv.pub_key().bytes())
        w.bytes(sig)
        self.write(length_prefix(w.build()))

        auth = Reader(read_length_prefixed_stream(self.read_exactly, max_size=1024))
        try:
            key_type = auth.string()
            rem_pub = _PUBKEY_TYPES[key_type](auth.bytes())
            rem_sig = auth.bytes()
        except KeyError as e:
            raise HandshakeError(f"unknown pubkey type {e}") from e
        except Exception as e:
            raise HandshakeError(f"malformed auth message: {e}") from e
        if not rem_pub.verify_bytes(challenge, rem_sig):
            raise HandshakeError("challenge verification failed")
        self._remote_pubkey: PubKey = rem_pub

    # -- identity ------------------------------------------------------------
    @property
    def remote_pubkey(self) -> PubKey:
        return self._remote_pubkey

    # -- framed AEAD stream --------------------------------------------------
    def write(self, data: bytes) -> int:
        """Encrypts `data` into ≤1024-byte frames (secret_connection.go:115)."""
        n = 0
        with self._send_lock:
            while data:
                chunk, data = data[:DATA_MAX_SIZE], data[DATA_MAX_SIZE:]
                frame = struct.pack("<I", len(chunk)) + chunk
                frame += b"\x00" * (TOTAL_FRAME_SIZE - len(frame))
                sealed = self._send_aead.encrypt(self._send_nonce.next(), frame, None)
                self._conn.write(sealed)
                n += len(chunk)
        return n

    def read(self, n: int) -> bytes:
        """Returns 1..n bytes (next frame's worth), like a stream socket."""
        with self._recv_lock:
            if not self._recv_buffer:
                sealed = self._conn.read_exactly(SEALED_FRAME_SIZE)
                try:
                    frame = self._recv_aead.decrypt(
                        self._recv_nonce.next(), sealed, None
                    )
                except Exception as e:
                    raise ConnectionError(f"failed to decrypt frame: {e}") from e
                (length,) = struct.unpack("<I", frame[:DATA_LEN_SIZE])
                if length > DATA_MAX_SIZE:
                    raise ConnectionError("frame length exceeds dataMaxSize")
                self._recv_buffer = frame[DATA_LEN_SIZE : DATA_LEN_SIZE + length]
            out, self._recv_buffer = self._recv_buffer[:n], self._recv_buffer[n:]
            return out

    def read_exactly(self, n: int) -> bytes:
        chunks = []
        got = 0
        while got < n:
            chunk = self.read(n - got)
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    def close(self) -> None:
        self._conn.close()

    def settimeout(self, t: Optional[float]) -> None:
        self._conn.settimeout(t)

def read_length_prefixed_stream(read_exactly, max_size: int) -> bytes:
    """uvarint length + payload from a blocking byte stream. The one framing
    helper shared by the handshake auth message and the transport's NodeInfo
    exchange (write side is codec.length_prefix)."""
    length, shift = 0, 0
    while True:
        b = read_exactly(1)[0]
        length |= (b & 0x7F) << shift
        if not (b & 0x80):
            break
        shift += 7
        if shift > 35:
            raise ConnectionError("length-prefix varint too long")
    if length > max_size:
        raise ConnectionError(f"length-prefixed message too large ({length})")
    return read_exactly(length)
