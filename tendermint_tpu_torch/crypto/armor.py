"""ASCII armor for key material (ref: crypto/armor/armor.go — OpenPGP-style
armor blocks via x/crypto/openpgp/armor).

Format (RFC 4880 §6.2): BEGIN/END type lines, `Key: Value` headers, blank
line, base64 body wrapped at 64 columns, and a CRC-24 checksum line
(`=XXXX`, base64 of the 3-byte OpenPGP CRC). The port's copy of the
reference package's ``crypto/armor.py``.
"""

from __future__ import annotations

import base64
from typing import Dict, Tuple

_CRC24_INIT = 0xB704CE
_CRC24_POLY = 0x1864CFB
_LINE = 64


def _crc24(data: bytes) -> int:
    crc = _CRC24_INIT
    for b in data:
        crc ^= b << 16
        for _ in range(8):
            crc <<= 1
            if crc & 0x1000000:
                crc ^= _CRC24_POLY
    return crc & 0xFFFFFF


def encode_armor(block_type: str, headers: Dict[str, str], data: bytes) -> str:
    """armor.go:11 EncodeArmor."""
    lines = [f"-----BEGIN {block_type}-----"]
    for k in sorted(headers):
        lines.append(f"{k}: {headers[k]}")
    lines.append("")
    body = base64.b64encode(data).decode()
    for i in range(0, len(body), _LINE):
        lines.append(body[i : i + _LINE])
    # an empty payload still gets its checksum line
    crc = base64.b64encode(_crc24(data).to_bytes(3, "big")).decode()
    lines.append(f"={crc}")
    lines.append(f"-----END {block_type}-----")
    return "\n".join(lines) + "\n"


def decode_armor(armor_str: str) -> Tuple[str, Dict[str, str], bytes]:
    """armor.go:28 DecodeArmor — returns (block_type, headers, data);
    raises ValueError on malformed input or checksum mismatch."""
    lines = [ln.rstrip("\r") for ln in armor_str.strip().splitlines()]
    if not lines or not lines[0].startswith("-----BEGIN ") or not lines[0].endswith("-----"):
        raise ValueError("armor: missing BEGIN line")
    block_type = lines[0][len("-----BEGIN ") : -len("-----")]
    end = f"-----END {block_type}-----"
    if lines[-1] != end:
        raise ValueError("armor: missing or mismatched END line")
    headers: Dict[str, str] = {}
    i = 1
    while i < len(lines) - 1 and lines[i].strip():
        if ":" not in lines[i]:
            break  # body started without a blank separator
        k, _, v = lines[i].partition(":")
        headers[k.strip()] = v.strip()
        i += 1
    if i < len(lines) - 1 and not lines[i].strip():
        i += 1  # blank separator
    body_lines = lines[i:-1]
    crc_b64 = None
    if body_lines and body_lines[-1].startswith("="):
        crc_b64 = body_lines[-1][1:]
        body_lines = body_lines[:-1]
    try:
        data = base64.b64decode("".join(body_lines), validate=True)
    except Exception as e:
        raise ValueError(f"armor: bad base64 body: {e}")
    if crc_b64 is not None:
        want = base64.b64decode(crc_b64)
        if _crc24(data).to_bytes(3, "big") != want:
            raise ValueError("armor: CRC-24 checksum mismatch")
    return block_type, headers, data
