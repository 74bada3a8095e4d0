"""The channel descriptor a reactor registers (ref p2p/conn/connection.go:601),
the port's copy of ``ChannelDescriptor`` from the reference package's
``p2p/conn/connection.py``.

Only the descriptor is ported: ``MConnection`` (the multiplexed, rate-limited
stream under it), the transport, the switch and peers are ROADMAP item 17.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ChannelDescriptor:
    """Static channel parameters a reactor registers (connection.go:601)."""

    id: int
    priority: int = 1
    send_queue_capacity: int = 1
    recv_message_capacity: int = 22 * 1024 * 1024  # defaultRecvMessageCapacity

    def __post_init__(self):
        if not (0 <= self.id <= 0xFF):
            raise ValueError(f"channel ID {self.id} out of byte range")
        if self.priority <= 0:
            raise ValueError("channel priority must be positive")
