"""An in-process switch and a serving peer for driving a ``BlockchainReactor``
without the p2p stack, as the reference's in-process tests connect two
switches (the reactor also runs on the real ``p2p/switch.Switch``:
``node/verify_root.node_reactors``).

``LoopbackSwitch`` holds the ``peers`` dict, ``broadcast`` and
``stop_peer_for_error`` (which records each reason and removes the peer from
the reactor) that the reactor calls. ``ServingPeer`` answers what the
syncing reactor sends it through the message codec, on the caller's thread:
a ``BlockRequestMessage`` with a ``BlockResponseMessage`` from its
``BlockStore`` (a ``NoBlockResponseMessage`` above ``height``), a
``StatusRequestMessage`` with its height. ``connect`` registers the peer,
calls the reactor's ``add_peer`` and sends the peer's status, as the
serving node's reactor would on its own ``add_peer``. ``codec`` is the
messages module (default the port's ``blockchain/messages.py``); a test
passes another package's to drive that package's reactor the same way.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from tendermint_tpu_torch.blockchain import messages
from tendermint_tpu_torch.blockchain.reactor import BLOCKCHAIN_CHANNEL


class ServingPeer:
    """Serves ``store``'s blocks up to ``height`` (default: the store's)."""

    def __init__(self, peer_id: str, store, height: Optional[int] = None, codec=messages):
        self.id = peer_id
        self.codec = codec
        self.store = store
        self.height = store.height() if height is None else height
        self.reactor = None  # the syncing reactor, set by connect

    def _reply(self, msg) -> None:
        self.reactor.receive(BLOCKCHAIN_CHANNEL, self, self.codec.encode_msg(msg))

    def try_send(self, chan_id: int, msg_bytes: bytes) -> bool:
        c = self.codec
        msg = c.unmarshal_msg(msg_bytes)
        if isinstance(msg, c.BlockRequestMessage):
            block = self.store.load_block(msg.height) if msg.height <= self.height else None
            self._reply(c.BlockResponseMessage(block) if block is not None
                        else c.NoBlockResponseMessage(msg.height))
        elif isinstance(msg, c.StatusRequestMessage):
            self._reply(c.StatusResponseMessage(self.height))
        return True


class LoopbackSwitch:
    def __init__(self, reactor):
        self.reactor = reactor
        self.peers: Dict[str, object] = {}
        self.stopped: List[Tuple[str, str]] = []  # (peer id, reason)
        reactor.set_switch(self)

    def connect(self, peer: ServingPeer) -> None:
        peer.reactor = self.reactor
        self.peers[peer.id] = peer
        self.reactor.add_peer(peer)
        peer._reply(peer.codec.StatusResponseMessage(peer.height))

    def broadcast(self, chan_id: int, msg_bytes: bytes) -> None:
        for peer in list(self.peers.values()):
            peer.try_send(chan_id, msg_bytes)

    def stop_peer_for_error(self, peer, reason) -> None:
        self.stopped.append((peer.id, str(reason)))
        if self.peers.pop(peer.id, None) is not None:
            self.reactor.remove_peer(peer, reason)
