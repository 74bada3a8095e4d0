"""CSPRNG helpers (ref: crypto/random.go).

The reference wraps Go's crypto/rand in a ChaCha20 stream reseeded by
MixEntropy because historical Go runtimes could block or weaken on some
platforms. Python's os.urandom IS the kernel CSPRNG (getrandom(2)), so
these are thin, honest shims keeping the reference's API shape:
MixEntropy is accepted (the kernel pool can always absorb more entropy via
os.urandom usage patterns, but user-supplied seeds cannot strengthen it
from userspace) and recorded for operator visibility only. The port's copy of the reference
package's ``crypto/random.py``.
"""

from __future__ import annotations

import os


def mix_entropy(seed: bytes) -> None:
    """Accepted for API parity (random.go:36), and an explicit no-op:
    os.urandom draws from the kernel CSPRNG, which userspace seeds cannot
    meaningfully strengthen."""


def c_rand_bytes(n: int) -> bytes:
    """random.go:51 CRandBytes."""
    if n < 0:
        raise ValueError("negative byte count")
    return os.urandom(n)


def c_rand_hex(n_digits: int) -> str:
    """random.go:72 CRandHex — with one deliberate divergence: the reference
    hex-encodes n/2 bytes, so CRandHex(11) returns 10 chars; this returns
    exactly n digits (the extra nibble comes from one more CSPRNG byte)."""
    if n_digits < 0:
        raise ValueError("negative digit count")
    return os.urandom((n_digits + 1) // 2).hex()[:n_digits]
