"""The ``[p2p]`` configuration section.

The port's copy of the JAX package's ``config/config.py`` ``P2PConfig``
(``:65-88``): every field under the same name and with the same default.
``node/verify_root.switch`` builds the transport, the switch and the
``MConnection`` settings from it, and dials ``persistent_peers``.

``pex`` (on by default, as in the reference) builds the peer exchange and
its address book (``p2p/pex/``) at ``addr_book_file`` with
``addr_book_strict``, seeded from ``seeds`` and in ``seed_mode`` when set
(``node/verify_root.pex_reactor``). ``private_peer_ids``, ``upnp`` and
``test_fuzz`` are read and wired to nothing, as in the reference package
(whose fields they copy).
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
