"""Evidence gossip reactor, channel 0x38 (ref: evidence/reactor.go).

Per-peer broadcast thread walks the pool's concurrent evidence list (shared
walker, libs/gossip); evidence is held back until the peer's height reaches
it (reactor.go:142-154 peer-height check — a syncing peer cannot verify
evidence from heights it hasn't reached). Received evidence is verified by
the pool against historical validator sets before being admitted — invalid
evidence is punishable (reactor.go:87 StopPeerForError), but evidence we
merely cannot verify YET (missing historical valset) is not. The port's
copy of the reference package's ``evidence/reactor.py``; evidence is
verified on the host, as in the reference (``state/validation.py``).
"""

from __future__ import annotations

import threading
from typing import List, Optional

from tendermint_tpu_torch.encoding.codec import Reader, Writer
from tendermint_tpu_torch.evidence.pool import EvidencePool
from tendermint_tpu_torch.libs.gossip import walk_and_send
from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.p2p.conn.connection import ChannelDescriptor
from tendermint_tpu_torch.state.store import NoValSetForHeightError
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence

EVIDENCE_CHANNEL = 0x38
MAX_MSG_SIZE = 1024 * 1024


def encode_evidence_list(evs: List[DuplicateVoteEvidence]) -> bytes:
    w = Writer()
    w.uvarint(1)  # EvidenceListMessage tag
    w.uvarint(len(evs))
    for ev in evs:
        w.bytes(ev.marshal())
    return w.build()


def decode_evidence_list(data: bytes) -> List[DuplicateVoteEvidence]:
    r = Reader(data)
    if r.uvarint() != 1:
        raise ValueError("unknown evidence message tag")
    n = r.uvarint()
    if n > 1024:
        raise ValueError("evidence list too long")
    return [DuplicateVoteEvidence.unmarshal(r.bytes()) for _ in range(n)]


class EvidenceReactor(Reactor):
    def __init__(self, evpool: EvidencePool, peer_height_lookup=None):
        """peer_height_lookup(peer_id) -> Optional[int]: the peer's consensus
        height (normally ConsensusReactor.peer_height, wired by
        ``node/verify_root.evidence_reactor``)."""
        super().__init__(name="EvidenceReactor")
        self.evpool = evpool
        self._peer_height_lookup = peer_height_lookup

    def get_channels(self):
        return [
            ChannelDescriptor(
                id=EVIDENCE_CHANNEL, priority=5, send_queue_capacity=100,
                recv_message_capacity=MAX_MSG_SIZE,
            )
        ]

    def _peer_height(self, peer_id: str) -> Optional[int]:
        if self._peer_height_lookup is None:
            return None
        try:
            return self._peer_height_lookup(peer_id)
        except Exception:
            return None

    def add_peer(self, peer) -> None:
        threading.Thread(
            target=self._broadcast_routine,
            args=(peer,),
            name=f"evidence-gossip-{peer.id[:8]}",
            daemon=True,
        ).start()

    def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        if len(msg_bytes) > MAX_MSG_SIZE:
            raise ValueError("oversized evidence message")
        for ev in decode_evidence_list(msg_bytes):
            try:
                self.evpool.add_evidence(ev)
            except NoValSetForHeightError:
                # we haven't synced that height yet — not the peer's fault
                self.logger.debug(
                    "cannot verify evidence h=%d yet (still syncing)", ev.height
                )
            except Exception as e:
                # invalid evidence — peer is byzantine or byzantine-adjacent
                self.logger.info("invalid evidence from %s: %s", peer.id[:8], e)
                if self.switch is not None:
                    self.switch.stop_peer_for_error(peer, e)
                return

    def _broadcast_routine(self, peer) -> None:
        def hold_back(ev) -> bool:
            # Peer can't verify evidence above its own height.  When the
            # lookup is wired but hasn't reported a height yet (peer still
            # handshaking/syncing), hold back too: treating unknown as
            # send-now used to blast evidence at peers that then failed
            # verification and punished US.  Only a reactor deliberately
            # running standalone (no lookup at all) broadcasts eagerly.
            if self._peer_height_lookup is None:
                return False
            h = self._peer_height(peer.id)
            return h is None or h < ev.height

        walk_and_send(
            alive=lambda: self.is_running and peer.is_running,
            front_wait=self.evpool.evidence_list.front_wait,
            send=lambda ev: peer.send(EVIDENCE_CHANNEL, encode_evidence_list([ev])),
            hold_back=hold_back,
        )
