"""PEX reactor — peer discovery over channel 0x00
(ref: p2p/pex/pex_reactor.go).

Behaviors kept:

* outbound peers get an immediate addrs request; inbound peers are only
  recorded (we trust what WE dialed more, pex_reactor.go:166-176);
* requests are rate-limited per peer (one per ensure-period/3); unsolicited
  PexAddrs are a protocol violation → peer stopped (pex_reactor.go:258);
* ``ensure_peers`` loop dials book addresses while below the outbound cap,
  biased toward new addresses when few peers are connected
  (pex_reactor.go ensurePeers:288-338).

The port's copy of the reference package's ``p2p/pex/pex_reactor.py``:
the same messages byte for byte, over the port's switch and
``MConnection``. A node builds it when ``[p2p] pex`` is on
(``node/verify_root.pex_reactor``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from tendermint_tpu_torch.encoding.codec import Reader, Writer
from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.p2p.conn.connection import ChannelDescriptor
from tendermint_tpu_torch.p2p.netaddress import NetAddress
from tendermint_tpu_torch.p2p.pex.addrbook import AddrBook

PEX_CHANNEL = 0x00
MAX_MSG_SIZE = 64 * 1024
ENSURE_PEERS_PERIOD = 30.0  # pex_reactor.go defaultEnsurePeersPeriod
MAX_ADDRS_PER_MSG = 250

# seed/crawler mode (pex_reactor.go:41-47)
CRAWL_PEERS_PERIOD = 30.0  # defaultCrawlPeersPeriod
CRAWL_PEER_INTERVAL = 120.0  # defaultCrawlPeerInterval (no redial sooner)
SEED_DISCONNECT_WAIT = 3 * 3600.0  # defaultSeedDisconnectWaitPeriod
SEED_SHARE_DISCONNECT_DELAY = 5.0  # grace before hanging up after SendAddrs
BIAS_TO_SELECT_NEW_PEERS = 30  # pex_reactor.go:30
MAX_CRAWL_DIALS_PER_PASS = 32  # one thread per dial; a big persisted book
# must not turn the first crawl into a thread/fd storm


def encode_pex_request() -> bytes:
    w = Writer()
    w.uvarint(1)
    return w.build()


def encode_pex_addrs(addrs: List[NetAddress]) -> bytes:
    w = Writer()
    w.uvarint(2).uvarint(len(addrs))
    for a in addrs:
        w.string(str(a))
    return w.build()


def decode_pex_msg(data: bytes):
    r = Reader(data)
    tag = r.uvarint()
    if tag == 1:
        return ("request", None)
    if tag == 2:
        n = r.uvarint()
        if n > MAX_ADDRS_PER_MSG:
            raise ValueError(f"too many addrs ({n})")
        return ("addrs", [NetAddress.parse(r.string()) for _ in range(n)])
    raise ValueError(f"unknown pex message tag {tag}")


class PEXReactor(Reactor):
    def __init__(
        self,
        book: AddrBook,
        ensure_period: float = ENSURE_PEERS_PERIOD,
        seeds: Optional[List[NetAddress]] = None,
        seed_mode: bool = False,
        crawl_period: float = CRAWL_PEERS_PERIOD,
        crawl_interval: float = CRAWL_PEER_INTERVAL,
        seed_disconnect_wait: float = SEED_DISCONNECT_WAIT,
        seed_share_disconnect_delay: float = SEED_SHARE_DISCONNECT_DELAY,
    ):
        super().__init__(name="PEXReactor")
        self.book = book
        self.ensure_period = ensure_period
        self.seeds = seeds or []
        # seed mode: crawl the network instead of keeping peers — answer
        # requests with a biased selection, then hang up
        # (pex_reactor.go:134,183-194,552)
        self.seed_mode = seed_mode
        self.crawl_period = crawl_period
        self.crawl_interval = crawl_interval
        self.seed_disconnect_wait = seed_disconnect_wait
        self.seed_share_disconnect_delay = seed_share_disconnect_delay
        self._requests_sent: Dict[str, float] = {}  # peer_id -> last req time
        # peer_id -> number of outstanding requests (a set would flag the
        # response to our second in-flight request as unsolicited)
        self._asked: Dict[str, int] = {}
        self._connected_at: Dict[str, float] = {}  # peer_id -> add time
        self._mtx = threading.Lock()

    def get_channels(self):
        return [
            ChannelDescriptor(
                id=PEX_CHANNEL, priority=1, send_queue_capacity=10,
                recv_message_capacity=MAX_MSG_SIZE,
            )
        ]

    def on_start(self) -> None:
        routine = (
            self._crawl_peers_routine if self.seed_mode else self._ensure_peers_routine
        )
        threading.Thread(target=routine, name="pex-ensure", daemon=True).start()

    def on_stop(self) -> None:
        self.book.save()

    # -- peer lifecycle -----------------------------------------------------------
    def add_peer(self, peer) -> None:
        with self._mtx:
            self._connected_at[peer.id] = time.monotonic()
        addr = peer.net_address()
        if peer.outbound:
            # we dialed it and the handshake succeeded: it's good
            if addr is not None:
                self.book.mark_good(addr)
            self._request_addrs(peer)
        else:
            # inbound: remember where it claims to live; the ensure loop
            # will ask it for addrs later if we're low
            if addr is not None:
                self.book.add_address(addr, addr)

    def remove_peer(self, peer, reason) -> None:
        with self._mtx:
            self._requests_sent.pop(peer.id, None)
            # the receiver-side throttle key too, or a reconnecting peer's
            # first post-handshake request reads as a flood and gets it
            # dropped again (connection flapping)
            self._requests_sent.pop(f"recv:{peer.id}", None)
            self._asked.pop(peer.id, None)
            self._connected_at.pop(peer.id, None)

    # -- messages ----------------------------------------------------------------
    def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        kind, payload = decode_pex_msg(msg_bytes)
        if kind == "request":
            now = time.monotonic()
            with self._mtx:
                last = self._requests_sent.get(f"recv:{peer.id}", 0.0)
                if now - last < self.ensure_period / 3:
                    raise ValueError("pex request flood")  # switch stops peer
                self._requests_sent[f"recv:{peer.id}"] = now
            if self.seed_mode:
                # answer with a new-biased batch then hang up after a grace
                # period — seeds bootstrap, they don't keep peers
                # (pex_reactor.go:183-194; the request throttle above is the
                # amplification-attack guard the reference notes)
                peer.try_send(
                    PEX_CHANNEL,
                    encode_pex_addrs(
                        self.book.get_selection_with_bias(BIAS_TO_SELECT_NEW_PEERS)
                    ),
                )
                t = threading.Timer(
                    self.seed_share_disconnect_delay,
                    self._disconnect_after_share,
                    args=(peer,),
                )
                t.daemon = True  # pending timers must not block shutdown
                t.start()
            else:
                peer.try_send(
                    PEX_CHANNEL, encode_pex_addrs(self.book.get_selection())
                )
        else:  # addrs
            with self._mtx:
                if self._asked.get(peer.id, 0) <= 0:
                    raise ValueError("unsolicited pex addrs")
                self._asked[peer.id] -= 1
            src = peer.net_address() or NetAddress(peer.id, "0.0.0.0", 1)
            my_id = self.switch.node_id if self.switch else None
            for addr in payload:
                # skip our own address even when the book wasn't seeded with
                # it (a seed's selection echoes requesters back)
                if addr.id == my_id:
                    continue
                if not self.book.is_our_address(addr):
                    self.book.add_address(addr, src)

    def _request_addrs(self, peer) -> None:
        now = time.monotonic()
        with self._mtx:
            # sender-side throttle mirroring the receiver's flood limit
            last = self._requests_sent.get(peer.id, 0.0)
            if now - last < self.ensure_period / 3:
                return
            self._requests_sent[peer.id] = now
            self._asked[peer.id] = self._asked.get(peer.id, 0) + 1
        peer.try_send(PEX_CHANNEL, encode_pex_request())

    # -- discovery loop ------------------------------------------------------------
    def _ensure_peers_routine(self) -> None:
        # seeds go straight into the book
        for seed in self.seeds:
            self.book.add_address(seed, seed)
        while self.is_running and not self._quit.is_set():
            try:
                self._ensure_peers()
            except Exception:
                self.logger.exception("ensure_peers failed")
            # full period between sweeps: receivers rate-limit requests at
            # period/3, so asking any faster gets US dropped as a flooder
            self._quit.wait(self.ensure_period)

    # -- seed/crawler mode ---------------------------------------------------------
    def _disconnect_after_share(self, peer) -> None:
        sw = self.switch
        if sw is not None and sw.peers.has(peer.id):
            try:
                sw.stop_peer_gracefully(peer)
            except Exception:
                pass

    def _crawl_peers_routine(self) -> None:
        """Seed mode main loop (pex_reactor.go:552 crawlPeersRoutine):
        crawl immediately, then periodically disconnect lingerers + crawl."""
        for seed in self.seeds:
            self.book.add_address(seed, seed)
        self._crawl_peers()
        while self.is_running and not self._quit.is_set():
            self._quit.wait(self.crawl_period)
            if self._quit.is_set():
                return
            try:
                self._attempt_disconnects()
                self._crawl_peers()
            except Exception:
                self.logger.exception("crawl failed")

    def _crawl_peers(self) -> None:
        """Dial known addresses (oldest-attempt first), harvesting their
        address books (pex_reactor.go:620 crawlPeers)."""
        sw = self.switch
        if sw is None:
            return
        now = time.monotonic()
        infos = sorted(self.book.list_known(), key=lambda k: k.last_attempt)
        dials = 0
        for ka in infos:
            if dials >= MAX_CRAWL_DIALS_PER_PASS:
                break  # the 30s crawl period amortizes the backlog
            # throttle on the monotonic twin — a wall clock stepping back
            # must not block redials for the step's length (the persisted
            # wall stamp still orders the crawl queue above)
            if ka.last_attempt_mono and now - ka.last_attempt_mono < self.crawl_interval:
                continue
            addr = ka.addr
            if not addr.id or addr.id == sw.node_id or sw.peers.has(addr.id):
                continue
            dials += 1
            self.book.mark_attempt(addr)

            def _dial(a=addr):
                try:
                    sw.dial_peer_with_address(a)
                    self.book.mark_good(a)
                except Exception as e:
                    self.logger.debug("crawl dial %s failed: %s", a, e)
                    return
                peer = sw.peers.get(a.id)
                if peer is not None:
                    self._request_addrs(peer)

            threading.Thread(target=_dial, name="pex-crawl", daemon=True).start()

    def _attempt_disconnects(self) -> None:
        """Drop peers we've held long enough — a seed's peer slots exist to
        be recycled (pex_reactor.go:646 attemptDisconnects)."""
        sw = self.switch
        if sw is None:
            return
        now = time.monotonic()
        for peer in sw.peers.list():
            if getattr(peer, "persistent", False):
                continue
            with self._mtx:
                since = self._connected_at.get(peer.id)
            if since is None or now - since < self.seed_disconnect_wait:
                continue
            try:
                sw.stop_peer_gracefully(peer)
            except Exception:
                pass

    def _ensure_peers(self) -> None:
        sw = self.switch
        if sw is None:
            return
        out = sum(1 for p in sw.peers.list() if p.outbound)
        need = sw.config.max_num_outbound_peers - out
        if need <= 0:
            return
        # few peers -> bias toward NEW addresses (explore); many -> OLD
        bias = max(10, 70 - out * 10)
        tried = set()
        for _ in range(need * 3):
            addr = self.book.pick_address(bias)
            if addr is None:
                break
            if addr.id in tried:
                continue  # random re-draw: skip, don't abort the sweep
            tried.add(addr.id)
            if sw.peers.has(addr.id) or addr.id == sw.node_id:
                continue
            self.book.mark_attempt(addr)

            def _dial(a=addr):
                try:
                    sw.dial_peer_with_address(a)
                    self.book.mark_good(a)
                except Exception as e:
                    self.logger.debug("pex dial %s failed: %s", a, e)

            threading.Thread(target=_dial, name="pex-dial", daemon=True).start()
        # still starving? ask a random connected peer for more addresses
        if self.book.size() < need:
            peers = sw.peers.list()
            if peers:
                import random

                self._request_addrs(random.choice(peers))
