"""P2P error taxonomy (ref p2p/errors.go), the port's copy of the
reference package's ``p2p/errors.py``.

The switch/transport use these to decide whether a failed peer should be
marked bad (reject) or simply retried (filter timeouts etc.).
"""

from __future__ import annotations


class P2PError(Exception):
    pass


class SwitchDuplicatePeerIDError(P2PError):
    def __init__(self, peer_id: str):
        super().__init__(f"duplicate peer ID {peer_id}")
        self.peer_id = peer_id


class SwitchDuplicatePeerIPError(P2PError):
    def __init__(self, ip: str):
        super().__init__(f"duplicate peer IP {ip}")
        self.ip = ip


class SwitchConnectToSelfError(P2PError):
    def __init__(self, addr):
        super().__init__(f"connect to self: {addr}")
        self.addr = addr


class SwitchPeerFilteredError(P2PError):
    """Peer rejected by an admission filter (node.go peerFilters — e.g. the
    app's /p2p/filter/id ABCI query said no)."""

    def __init__(self, peer_id: str, reason: str):
        super().__init__(f"peer {peer_id} filtered: {reason}")
        self.peer_id = peer_id
        self.reason = reason


class TransportClosedError(P2PError):
    pass


class RejectedError(P2PError):
    """Connection rejected during upgrade/filtering (ref transport.go
    ErrRejected). `is_auth_failure`/`is_duplicate`/`is_incompatible` mirror
    the reference's reason predicates."""

    def __init__(
        self,
        reason: str,
        *,
        is_auth_failure: bool = False,
        is_duplicate: bool = False,
        is_incompatible: bool = False,
        is_self: bool = False,
        is_filtered: bool = False,
    ):
        super().__init__(f"connection rejected: {reason}")
        self.reason = reason
        self.is_auth_failure = is_auth_failure
        self.is_duplicate = is_duplicate
        self.is_incompatible = is_incompatible
        self.is_self = is_self
        self.is_filtered = is_filtered
