"""Reactor interface (ref p2p/base_reactor.go), the port's copy of the
reference package's ``p2p/base_reactor.py``.

A reactor owns a set of channels on every peer and reacts to messages on
them. The switch calls the lifecycle hooks; reactors call
``peer.try_send`` / ``switch.broadcast`` to talk back. Only the interface
is ported: the switch, peers and the transport are ROADMAP item 17, so a
reactor here is driven by its caller (``testutil/fastsync.py``'s loopback
switch in the tests and ``chip_smoke.py``).
"""

from __future__ import annotations

from typing import List, Optional

from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.p2p.conn.connection import ChannelDescriptor


class Reactor(BaseService):
    def __init__(self, name: str = "Reactor"):
        super().__init__(name=name)
        self.switch: Optional[object] = None

    def set_switch(self, sw) -> None:
        self.switch = sw

    def get_channels(self) -> List[ChannelDescriptor]:
        """Static channel descriptors this reactor serves."""
        raise NotImplementedError

    def add_peer(self, peer) -> None:
        """Called by the switch after the peer is started and registered."""

    def remove_peer(self, peer, reason: object) -> None:
        """Called by the switch when the peer is stopped (error or graceful).
        May arrive for a peer this reactor never saw add_peer for (a peer can
        error out during admission): implementations must tolerate that."""

    def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        """A complete message arrived on one of this reactor's channels.
        Runs on the peer's receive thread: don't block for long."""
