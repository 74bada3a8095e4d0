"""P2P stack: authenticated encrypted transport, multiplexed prioritized
channels, the switch and its reactor registry (ref p2p/), the port's copy
of the reference package's ``p2p/`` with the same exports. Beside them:
the peer exchange and its address book (``pex/``), ``trust``, ``upnp``,
``fuzz`` and the in-process fabric of the simulator (``inproc``).
"""

from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.p2p.conn.connection import ChannelDescriptor, MConnConfig, MConnection
from tendermint_tpu_torch.p2p.conn.secret_connection import SecretConnection
from tendermint_tpu_torch.p2p.key import NodeKey
from tendermint_tpu_torch.p2p.netaddress import NetAddress
from tendermint_tpu_torch.p2p.node_info import NodeInfo, ProtocolVersion
from tendermint_tpu_torch.p2p.peer import Peer, PeerSet
from tendermint_tpu_torch.p2p.switch import Switch, SwitchConfig
from tendermint_tpu_torch.p2p.transport import MultiplexTransport, UpgradedConn

__all__ = [
    "ChannelDescriptor",
    "MConnConfig",
    "MConnection",
    "MultiplexTransport",
    "NetAddress",
    "NodeInfo",
    "NodeKey",
    "Peer",
    "PeerSet",
    "ProtocolVersion",
    "Reactor",
    "SecretConnection",
    "Switch",
    "SwitchConfig",
    "UpgradedConn",
]
