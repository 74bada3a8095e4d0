"""In-process fakes for driving ``StateSyncReactor``s without the p2p stack
(the reactor also runs on the real ``p2p/switch.Switch``:
``node/verify_root.node_reactors``), the port's copy of those of the reference's
``tests/test_statesync.py``.

``HubSwitch`` holds the ``peers.list()`` / ``peers.get()``, ``broadcast``
and ``stop_peer_for_error`` surface that the state-sync reactor drives;
``HubPeer.try_send`` delivers each message to the remote switch's reactors
on a thread of its own, as a real receive thread would. ``hub_net`` meshes
one switch a (name, reactor) pair, all started. ``CorruptingStore`` wraps a
``SnapshotStore`` and serves its chunks with every byte flipped: an
adversarial peer whose every chunk fails the manifest check.
"""

from __future__ import annotations

import threading


class CorruptingStore:
    def __init__(self, inner):
        self._inner = inner
        self.corrupted = 0  # chunks served corrupt

    def list(self, limit=10):
        return self._inner.list(limit)

    def load_chunk(self, height, format, index):
        c = self._inner.load_chunk(height, format, index)
        if c is None:
            return None
        self.corrupted += 1
        return bytes(b ^ 0xFF for b in c) or b"\xff"


class HubPeer:
    """A peer handle as one switch sees it."""

    def __init__(self, peer_id):
        self.id = peer_id
        self._deliver = None

    def try_send(self, chan_id, raw):
        threading.Thread(target=self._deliver, args=(chan_id, raw), daemon=True).start()
        return True

    send = try_send

    def has_channel(self, chan_id) -> bool:
        return True  # every hub switch runs every reactor


class HubSwitch:
    def __init__(self, name):
        self.id = name
        self.reactors = {}
        self._peers = {}
        self.peers = self  # .list() / .get() live on the switch itself
        self.stopped = []  # (peer id, reason)

    def list(self):
        return list(self._peers.values())

    def get(self, peer_id):
        return self._peers.get(peer_id)

    def add_reactor(self, name, reactor):
        self.reactors[name] = reactor
        reactor.set_switch(self)

    def broadcast(self, chan_id, raw):
        for p in self.list():
            p.try_send(chan_id, raw)

    def stop_peer_for_error(self, peer, reason):
        self.stopped.append((peer.id, str(reason)))
        if self._peers.pop(peer.id, None) is not None:
            for r in self.reactors.values():
                r.remove_peer(peer, reason)

    def _dispatch(self, chan_id, from_peer, raw):
        for r in self.reactors.values():
            r.receive(chan_id, from_peer, raw)


def hub_connect(a: HubSwitch, b: HubSwitch) -> None:
    peer_b, peer_a = HubPeer(b.id), HubPeer(a.id)
    peer_b._deliver = lambda chan, raw: b._dispatch(chan, peer_a, raw)
    peer_a._deliver = lambda chan, raw: a._dispatch(chan, peer_b, raw)
    a._peers[b.id] = peer_b
    b._peers[a.id] = peer_a
    for r in a.reactors.values():
        r.add_peer(peer_b)
    for r in b.reactors.values():
        r.add_peer(peer_a)


def hub_net(named_reactors):
    """Fully meshed fake switches, one a (name, reactor) pair, all started."""
    switches = []
    for name, reactor in named_reactors:
        sw = HubSwitch(name)
        sw.add_reactor("statesync", reactor)
        switches.append(sw)
    for _, reactor in named_reactors:
        reactor.start()
    for i in range(len(switches)):
        for j in range(i + 1, len(switches)):
            hub_connect(switches[i], switches[j])
    return switches
