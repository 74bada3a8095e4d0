"""The ``[p2p]`` configuration section.

The port's copy of the JAX package's ``config/config.py`` ``P2PConfig``
(``:65-88``): every field under the same name and with the same default.
``node/verify_root.switch`` builds the transport, the switch and the
``MConnection`` settings from it, and dials ``persistent_peers``.

The peer exchange (``pex/``), its address book and seed nodes are not
ported: ``validate_ported`` refuses a section that turns on ``pex``, names
``seeds``, runs in ``seed_mode``, asks for ``upnp`` or ``test_fuzz``, or
names ``private_peer_ids`` (the address book's), so a section that needs them
fails where it is applied instead of running without them. The defaults
keep ``pex`` on, as the reference does; a node of fixed persistent peers
sets it off.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass
class P2PConfig:
    laddr: str = "tcp://0.0.0.0:26656"
    external_address: str = ""
    seeds: str = ""
    persistent_peers: str = ""
    upnp: bool = False
    addr_book_file: str = "config/addrbook.json"
    addr_book_strict: bool = True
    max_num_inbound_peers: int = 40
    max_num_outbound_peers: int = 10
    flush_throttle_timeout: float = 0.1  # 100ms (config.go:408)
    max_packet_msg_payload_size: int = 1024
    send_rate: int = 5120000
    recv_rate: int = 5120000
    pex: bool = True
    seed_mode: bool = False
    private_peer_ids: str = ""
    allow_duplicate_ip: bool = False
    handshake_timeout: float = 20.0
    dial_timeout: float = 3.0
    test_fuzz: bool = False

    def addr_book_path(self, root: str) -> str:
        return os.path.join(root, self.addr_book_file)

    def validate_ported(self) -> None:
        """Raise ``NotImplementedError`` for a field whose module is not
        ported (the peer exchange and its address book, UPnP, the fuzzed
        connection)."""
        unported = [name for name, on in (
            ("pex", self.pex), ("seeds", bool(self.seeds.strip())),
            ("seed_mode", self.seed_mode), ("private_peer_ids", bool(self.private_peer_ids.strip())),
            ("upnp", self.upnp), ("test_fuzz", self.test_fuzz)) if on]
        if unported:
            raise NotImplementedError(
                f"[p2p] {', '.join(unported)}: the peer exchange, its address book, UPnP and "
                f"the fuzzed connection are not ported (set pex = false and leave the others "
                f"at their defaults)")
