"""Network addresses with node IDs (ref p2p/netaddress.go), the port's copy
of the reference package's ``p2p/netaddress.py``.

Canonical string form is ``id@host:port`` (NetAddress.String, netaddress.go:224).
IDs are hex addresses of node ed25519 pubkeys (p2p/key.go PubKeyToID).
"""

from __future__ import annotations

import ipaddress
import re
from dataclasses import dataclass

ID_BYTE_LENGTH = 20  # address size of the node key (key.go IDByteLength)

_ID_RE = re.compile(r"^[0-9a-f]{40}$")


def validate_id(node_id: str) -> None:
    if not _ID_RE.match(node_id):
        raise ValueError(f"invalid node ID {node_id!r} (want 40 hex chars)")


@dataclass(frozen=True)
class NetAddress:
    """id@host:port. id may be empty for unidentified addresses
    (e.g. an inbound conn before the handshake)."""

    id: str
    host: str
    port: int

    def __post_init__(self):
        if self.id:
            validate_id(self.id)
        if not (0 < self.port < 65536):
            raise ValueError(f"invalid port {self.port}")

    def __str__(self) -> str:
        hp = f"{self.host}:{self.port}"
        return f"{self.id}@{hp}" if self.id else hp

    @property
    def dial_string(self) -> str:
        return f"{self.host}:{self.port}"

    @classmethod
    def parse(cls, s: str) -> "NetAddress":
        """Parse id@host:port (netaddress.go NewNetAddressString). The ID part
        is required for dialing (so a dialer can authenticate what it gets)."""
        s = s.strip()
        if "@" not in s:
            raise ValueError(f"address {s!r} missing node ID (want id@host:port)")
        ident, _, hp = s.partition("@")
        validate_id(ident)
        host, port = _split_host_port(hp)
        return cls(ident, host, port)

    @classmethod
    def parse_no_id(cls, s: str) -> "NetAddress":
        host, port = _split_host_port(s.strip())
        return cls("", host, port)

    def routable(self) -> bool:
        """Globally routable (netaddress.go Routable) — loopback/private/
        unspecified addresses are not shared over PEX outside tests."""
        try:
            ip = ipaddress.ip_address(self.host)
        except ValueError:
            return True  # hostname: assume routable, resolution happens at dial
        return not (
            ip.is_loopback or ip.is_private or ip.is_unspecified
            or ip.is_link_local or ip.is_multicast
        )

    def local(self) -> bool:
        try:
            ip = ipaddress.ip_address(self.host)
        except ValueError:
            return False
        return ip.is_loopback or ip.is_private

    def same_id(self, other: "NetAddress") -> bool:
        return bool(self.id) and self.id == other.id


def _split_host_port(hp: str) -> tuple[str, int]:
    if hp.startswith("["):  # [v6]:port
        host, _, rest = hp[1:].partition("]")
        if not rest.startswith(":"):
            raise ValueError(f"bad address {hp!r}")
        return host, int(rest[1:])
    host, sep, port = hp.rpartition(":")
    if not sep:
        raise ValueError(f"address {hp!r} missing port")
    return host or "0.0.0.0", int(port)
