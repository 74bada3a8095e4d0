"""Bech32 address encoding (ref: libs/bech32/bech32.go, which wraps
btcutil's BIP-0173 implementation).

`convert_and_encode(hrp, data)` / `decode_and_convert(bech)` mirror the
reference's two exports; the BIP-0173 primitives are implemented here.
The port's copy of the reference package's ``libs/bech32.py``.
"""

from __future__ import annotations

from typing import List, Tuple

_CHARSET = "qpzry9x8gf2tvdw0s3jn54khce6mua7l"
_GEN = (0x3B6A57B2, 0x26508E6D, 0x1EA119FA, 0x3D4233DD, 0x2A1462B3)


def _polymod(values) -> int:
    chk = 1
    for v in values:
        top = chk >> 25
        chk = (chk & 0x1FFFFFF) << 5 ^ v
        for i in range(5):
            chk ^= _GEN[i] if ((top >> i) & 1) else 0
    return chk


def _hrp_expand(hrp: str) -> List[int]:
    return [ord(c) >> 5 for c in hrp] + [0] + [ord(c) & 31 for c in hrp]


def _create_checksum(hrp: str, data: List[int]) -> List[int]:
    values = _hrp_expand(hrp) + data
    mod = _polymod(values + [0, 0, 0, 0, 0, 0]) ^ 1
    return [(mod >> 5 * (5 - i)) & 31 for i in range(6)]


def _verify_checksum(hrp: str, data: List[int]) -> bool:
    return _polymod(_hrp_expand(hrp) + data) == 1


def bech32_encode(hrp: str, data: List[int]) -> str:
    combined = data + _create_checksum(hrp, data)
    return hrp + "1" + "".join(_CHARSET[d] for d in combined)


def bech32_decode(bech: str) -> Tuple[str, List[int]]:
    if bech.lower() != bech and bech.upper() != bech:
        raise ValueError("bech32: mixed case")
    bech = bech.lower()
    pos = bech.rfind("1")
    if pos < 1 or pos + 7 > len(bech) or len(bech) > 90:
        raise ValueError("bech32: invalid separator position or length")
    hrp = bech[:pos]
    if any(ord(c) < 33 or ord(c) > 126 for c in hrp):
        raise ValueError("bech32: invalid hrp character")
    try:
        data = [_CHARSET.index(c) for c in bech[pos + 1 :]]
    except ValueError:
        raise ValueError("bech32: invalid data character")
    if not _verify_checksum(hrp, data):
        raise ValueError("bech32: checksum mismatch")
    return hrp, data[:-6]


def convert_bits(data, from_bits: int, to_bits: int, pad: bool) -> List[int]:
    """General power-of-2 base conversion (bech32.go ConvertBits)."""
    acc = 0
    bits = 0
    ret: List[int] = []
    maxv = (1 << to_bits) - 1
    max_acc = (1 << (from_bits + to_bits - 1)) - 1
    for value in data:
        if value < 0 or value >> from_bits:
            raise ValueError("bech32: invalid data range")
        acc = ((acc << from_bits) | value) & max_acc
        bits += from_bits
        while bits >= to_bits:
            bits -= to_bits
            ret.append((acc >> bits) & maxv)
    if pad:
        if bits:
            ret.append((acc << (to_bits - bits)) & maxv)
    elif bits >= from_bits or ((acc << (to_bits - bits)) & maxv):
        raise ValueError("bech32: invalid incomplete group")
    return ret


def convert_and_encode(hrp: str, data: bytes) -> str:
    """bech32.go:9 ConvertAndEncode: bytes -> 5-bit groups -> bech32."""
    return bech32_encode(hrp, convert_bits(data, 8, 5, True))


def decode_and_convert(bech: str) -> Tuple[str, bytes]:
    """bech32.go:19 DecodeAndConvert: bech32 -> 5-bit groups -> bytes."""
    hrp, data = bech32_decode(bech)
    return hrp, bytes(convert_bits(data, 5, 8, False))
