"""Mempool gossip reactor, channel 0x30 (ref: mempool/reactor.go), the
port's copy of the reference package's ``mempool/reactor.py``.

One broadcast thread per peer walks the mempool's concurrent list with
wait-for-next semantics (reactor.go broadcastTxRoutine:118-166): every good
tx reaches every peer exactly once per connection, new txs wake the walkers.
A tx is held back while the peer lags more than one height behind the height
the tx was validated at (reactor.go:150 peerState height check). Received
txs pass the QoS gate (``mempool/qos.py``) when ``[mempool] qos_enabled``,
then go through CheckTx like any RPC submission — the app is the filter.

Where the port differs: the reference catches only ``MempoolError`` around
``check_tx``, so any other exception stops the sending peer for error. On
the card the port's mempool raises its own CheckTx window's device fault
out of ``check_tx`` (a failed window on the wait timer's thread is raised
by the next call, which may be this reactor's). That fault, and only that
one (``mempool.is_window_fault``), is this node's, not the peer's: the
reactor keeps it as ``device_fault`` (the first one; ``device_faults``
counts them), logs it, and the sender stays connected. The tx whose
``check_tx`` raised is not admitted; each other peer still sends it once.
Every other error, on the card or off it, stops the sender as in the
reference.
"""

from __future__ import annotations

import threading
from typing import Optional

from tendermint_tpu_torch.encoding.codec import Reader, Writer
from tendermint_tpu_torch.libs.gossip import walk_and_send
from tendermint_tpu_torch.mempool.mempool import Mempool, MempoolError, is_window_fault
from tendermint_tpu_torch.mempool.qos import MempoolQoS
from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.p2p.conn.connection import ChannelDescriptor

MEMPOOL_CHANNEL = 0x30
MAX_MSG_SIZE = 1024 * 1024  # reactor.go maxMsgSize
PEER_CATCHUP_SLEEP = 0.1  # reactor.go peerCatchupSleepIntervalMS


def encode_tx_msg(tx: bytes) -> bytes:
    w = Writer()
    w.uvarint(1)  # TxMessage tag
    w.bytes(tx)
    return w.build()


def decode_tx_msg(data: bytes) -> bytes:
    r = Reader(data)
    if r.uvarint() != 1:
        raise ValueError("unknown mempool message tag")
    return r.bytes()


class MempoolReactor(Reactor):
    def __init__(self, mempool: Mempool, peer_height_lookup=None, config=None,
                 metrics=None, now_ns=None):
        """peer_height_lookup(peer_id) -> Optional[int]: the peer's consensus
        height, normally ConsensusReactor.peer_height (wired by
        ``node/verify_root.mempool_reactor``); None = assume caught up.

        When ``config.qos_enabled`` (a MempoolConfig) the per-peer admission
        controller gates every received tx before CheckTx; ``now_ns`` is the
        QoS clock (default ``time.monotonic_ns``)."""
        super().__init__(name="MempoolReactor")
        self.mempool = mempool
        self.config = config
        self._peer_height_lookup = peer_height_lookup
        self.qos: Optional[MempoolQoS] = None
        if config is not None and getattr(config, "qos_enabled", False):
            kwargs = {"metrics": metrics}
            if now_ns is not None:
                kwargs["now_ns"] = now_ns
            self.qos = MempoolQoS(config, **kwargs)
        # this node's CheckTx window fault met on a peer's tx (on the card only)
        self.device_fault: Optional[BaseException] = None
        self.device_faults = 0
        self._fault_mtx = threading.Lock()

    def get_channels(self):
        return [
            ChannelDescriptor(
                id=MEMPOOL_CHANNEL, priority=5, send_queue_capacity=100,
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
        if self.config is not None and not self.config.broadcast:
            return  # tx gossip disabled (reactor.go gates on config.Broadcast)
        threading.Thread(
            target=self._broadcast_tx_routine,
            args=(peer,),
            name=f"mempool-gossip-{peer.id[:8]}",
            daemon=True,
        ).start()

    def remove_peer(self, peer, reason=None) -> None:
        # the broadcast thread exits on peer.is_running; only the QoS
        # ledger needs explicit cleanup (label-cardinality hygiene)
        if self.qos is not None:
            self.qos.forget_peer(peer.id)

    def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        if len(msg_bytes) > MAX_MSG_SIZE:
            raise ValueError("oversized mempool message")
        tx = decode_tx_msg(msg_bytes)
        if self.qos is not None:
            ok, _reason = self.qos.admit(peer.id, len(tx))
            if not ok:
                return  # counted (qos_dropped_total{reason}) — not silent
        try:
            self.mempool.check_tx(tx)
        except MempoolError:
            pass  # dup/full/bad txs are unremarkable from gossip
        except Exception as e:
            if not is_window_fault(e):
                raise
            with self._fault_mtx:
                self.device_faults += 1
                if self.device_fault is None:
                    self.device_fault = e
            self.logger.error("CheckTx device fault on a tx from %s (this node's, not the "
                              "peer's; it stays connected): %r", peer.id[:8], e)

    def qos_snapshot(self):
        """Per-peer admission ledger (the reference's dump_mempool_qos RPC)."""
        if self.qos is None:
            return {"enabled": False, "peers": {}}
        return self.qos.snapshot()

    # -- per-peer walker ---------------------------------------------------------
    def _broadcast_tx_routine(self, peer) -> None:
        def hold_back(memtx) -> bool:
            # hold while the peer's consensus height lags the tx's height
            h = self._peer_height(peer.id)
            return h is not None and h < memtx.height - 1

        walk_and_send(
            alive=lambda: self.is_running and peer.is_running,
            front_wait=self.mempool.txs_wait_chan().front_wait,
            send=lambda memtx: peer.send(MEMPOOL_CHANNEL, encode_tx_msg(memtx.tx)),
            hold_back=hold_back,
        )
