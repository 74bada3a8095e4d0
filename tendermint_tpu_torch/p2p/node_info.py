"""NodeInfo: the identity and capability record exchanged in the wire
handshake (ref p2p/node_info.go DefaultNodeInfo, validation :119-160,
compatibility :171-205), the port's copy of the reference package's
``p2p/node_info.py`` with the same wire bytes.

Encoded with the framework codec (deterministic, self-delimiting) instead of
amino. The protocol-version triple mirrors node_info.go:24-41.
"""

from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.encoding.codec import Reader, Writer
from tendermint_tpu_torch.p2p.netaddress import NetAddress, validate_id

MAX_NUM_CHANNELS = 16  # node_info.go maxNumChannels


@dataclass(frozen=True)
class ProtocolVersion:
    """(p2p, block, app) version triple — node_info.go:24."""

    p2p: int = 4
    block: int = 8
    app: int = 0

    def encode(self, w: Writer) -> None:
        w.uvarint(self.p2p).uvarint(self.block).uvarint(self.app)

    @classmethod
    def decode(cls, r: Reader) -> "ProtocolVersion":
        return cls(r.uvarint(), r.uvarint(), r.uvarint())


@dataclass(frozen=True)
class NodeInfo:
    protocol_version: ProtocolVersion
    id: str  # hex node ID
    listen_addr: str  # host:port accepting connections ("" if not listening)
    network: str  # chain ID
    version: str  # software semver
    channels: bytes  # supported channel IDs, one byte each
    moniker: str = "node"
    tx_index: str = "on"
    rpc_address: str = ""

    def validate(self) -> None:
        """node_info.go Validate — malformed NodeInfos are rejected at the
        wire handshake before the peer is admitted."""
        validate_id(self.id)
        if len(self.channels) > MAX_NUM_CHANNELS:
            raise ValueError(f"too many channels ({len(self.channels)})")
        if len(set(self.channels)) != len(self.channels):
            raise ValueError("duplicate channel IDs")
        for s in (self.moniker, self.version, self.network):
            if any(ch in s for ch in "\x00\r\n"):
                raise ValueError("control characters in NodeInfo strings")
        if self.tx_index not in ("", "on", "off"):
            raise ValueError(f"invalid tx_index {self.tx_index!r}")

    def compatible_with(self, other: "NodeInfo") -> None:
        """node_info.go CompatibleWith: same block protocol + same network +
        at least one common channel. Raises ValueError when incompatible."""
        if self.protocol_version.block != other.protocol_version.block:
            raise ValueError(
                f"block version mismatch: {self.protocol_version.block} vs "
                f"{other.protocol_version.block}"
            )
        if self.network != other.network:
            raise ValueError(f"network mismatch: {self.network} vs {other.network}")
        if self.channels and other.channels:
            if not set(self.channels) & set(other.channels):
                raise ValueError("no common channels")

    def net_address(self) -> NetAddress:
        host, _, port = self.listen_addr.rpartition(":")
        return NetAddress(self.id, host or "0.0.0.0", int(port))

    # -- wire ----------------------------------------------------------------
    def encode(self, w: Writer) -> None:
        self.protocol_version.encode(w)
        w.string(self.id).string(self.listen_addr).string(self.network)
        w.string(self.version).bytes(self.channels).string(self.moniker)
        w.string(self.tx_index).string(self.rpc_address)

    def to_bytes(self) -> bytes:
        w = Writer()
        self.encode(w)
        return w.build()

    @classmethod
    def decode(cls, r: Reader) -> "NodeInfo":
        return cls(
            protocol_version=ProtocolVersion.decode(r),
            id=r.string(),
            listen_addr=r.string(),
            network=r.string(),
            version=r.string(),
            channels=r.bytes(),
            moniker=r.string(),
            tx_index=r.string(),
            rpc_address=r.string(),
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "NodeInfo":
        return cls.decode(Reader(data))
