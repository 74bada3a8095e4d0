"""In-process p2p test substrate (ref p2p/test_util.go:68-160
MakeConnectedSwitches / Connect2Switches), the port's copy of the
reference package's ``p2p/test_util.py`` under the same name.

Switches are real (real Switch, real SecretConnection, real MConnection
threads); only the TCP listener is skipped — pairs are wired over
``socket.socketpair()`` so the whole multi-node consensus test tier runs
in one process with no ports, exactly like the reference's net.Pipe tier.
"""

from __future__ import annotations

import socket
import threading
from typing import Callable, List, Optional

from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519
from tendermint_tpu_torch.p2p.conn.connection import MConnConfig
from tendermint_tpu_torch.p2p.conn.secret_connection import RawConn, SecretConnection
from tendermint_tpu_torch.p2p.key import NodeKey
from tendermint_tpu_torch.p2p.netaddress import NetAddress
from tendermint_tpu_torch.p2p.node_info import NodeInfo, ProtocolVersion
from tendermint_tpu_torch.p2p.switch import Switch, SwitchConfig
from tendermint_tpu_torch.p2p.transport import MultiplexTransport, UpgradedConn


def make_node_info(node_key: NodeKey, network: str = "test-chain", channels: bytes = b"") -> NodeInfo:
    return NodeInfo(
        protocol_version=ProtocolVersion(),
        id=node_key.id(),
        listen_addr="127.0.0.1:0",
        network=network,
        version="0.1.0",
        channels=channels,
        moniker=f"test-{node_key.id()[:6]}",
    )


def make_switch(
    idx: int = 0,
    network: str = "test-chain",
    init_switch: Optional[Callable[[int, Switch], Switch]] = None,
    mconfig: Optional[MConnConfig] = None,
    metrics=None,
) -> Switch:
    """A Switch with a fresh node key and test-speed MConn timings.
    `init_switch(i, sw)` registers reactors (test_util.go MakeSwitch)."""
    node_key = NodeKey(PrivKeyEd25519.generate())
    ni = make_node_info(node_key, network)
    transport = MultiplexTransport(ni, node_key)
    sw = Switch(transport, SwitchConfig(), mconfig or MConnConfig.test_config(),
                metrics=metrics)
    if init_switch is not None:
        ret = init_switch(idx, sw)
        if isinstance(ret, Switch):
            sw = ret
    # after reactors registered, advertise their channels in our NodeInfo
    chans = bytes(d.id for d in sw._chan_descs)
    transport.node_info = make_node_info(node_key, network, chans)
    return sw


def connect_switches(sw1: Switch, sw2: Switch) -> None:
    """Upgrade a socketpair on both ends concurrently and admit the peers
    (test_util.go Connect2Switches)."""
    s1, s2 = socket.socketpair()
    results: List = [None, None]
    errors: List = [None, None]

    def _upgrade(i: int, sw: Switch, sock) -> None:
        try:
            sconn = SecretConnection(RawConn(sock), sw.transport.node_key.priv_key)
            ni = sw.transport._exchange_node_info(sconn)
            ni.validate()
            results[i] = (sconn, ni)
        except Exception as e:  # surfaced below
            errors[i] = e

    t1 = threading.Thread(target=_upgrade, args=(0, sw1, s1), daemon=True)
    t2 = threading.Thread(target=_upgrade, args=(1, sw2, s2), daemon=True)
    t1.start(), t2.start()
    t1.join(10), t2.join(10)
    for e in errors:
        if e is not None:
            raise e
    for i, (sw, outbound) in enumerate(((sw1, True), (sw2, False))):
        sconn, ni = results[i]
        sw._add_peer(
            UpgradedConn(
                conn=sconn,
                node_info=ni,
                socket_addr=NetAddress(ni.id, "127.0.0.1", 1 + i),
                outbound=outbound,
            )
        )


def connect_switches_plain(sw1: Switch, sw2: Switch) -> None:
    """Like connect_switches but over bare RawConns — NO SecretConnection,
    so it runs on hosts without the `cryptography` package.  The NodeInfo
    handshake works over any conn exposing write/read_exactly; everything
    above the transport (Switch, Peer, MConnection, metrics) is identical
    to the authenticated path."""
    s1, s2 = socket.socketpair()
    results: List = [None, None]
    errors: List = [None, None]

    def _upgrade(i: int, sw: Switch, sock) -> None:
        try:
            conn = RawConn(sock)
            ni = sw.transport._exchange_node_info(conn)
            ni.validate()
            results[i] = (conn, ni)
        except Exception as e:  # surfaced below
            errors[i] = e

    t1 = threading.Thread(target=_upgrade, args=(0, sw1, s1), daemon=True)
    t2 = threading.Thread(target=_upgrade, args=(1, sw2, s2), daemon=True)
    t1.start(), t2.start()
    t1.join(10), t2.join(10)
    for e in errors:
        if e is not None:
            raise e
    for i, (sw, outbound) in enumerate(((sw1, True), (sw2, False))):
        conn, ni = results[i]
        sw._add_peer(
            UpgradedConn(
                conn=conn,
                node_info=ni,
                socket_addr=NetAddress(ni.id, "127.0.0.1", 1 + i),
                outbound=outbound,
            )
        )


def make_connected_switches(
    n: int,
    init_switch: Optional[Callable[[int, Switch], Switch]] = None,
    network: str = "test-chain",
    mconfig: Optional[MConnConfig] = None,
) -> List[Switch]:
    """N started switches, fully meshed (test_util.go MakeConnectedSwitches)."""
    switches = [
        make_switch(i, network=network, init_switch=init_switch, mconfig=mconfig)
        for i in range(n)
    ]
    for sw in switches:
        sw.start()
    for i in range(n):
        for j in range(i + 1, n):
            connect_switches(switches[i], switches[j])
    return switches


def stop_switches(switches: List[Switch]) -> None:
    for sw in switches:
        if sw.is_running:
            sw.stop()
