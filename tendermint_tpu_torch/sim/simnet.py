"""SimNet — the seeded, fault-injecting message fabric; the port's copy of
the reference package's ``sim/simnet.py``, whose decisions it equals bit
for bit for the same traffic.

Every `InProcSwitch.send` lands here.  For each ordered link (src, dst) the
fabric keeps a policy (delay/jitter/drop/duplicate/reorder) and a
monotonically increasing per-link sequence number; every fault decision is
drawn from ``random.Random(sha256(seed | src | dst | seq))`` in a FIXED
draw order, so the entire fault schedule is a pure function of
``(seed, traffic shape)`` — same seed + same message sequence ⇒ same drops,
same delays, same duplicates.  ``replay_schedule()`` re-derives every
logged decision from the seed and verifies the log matches, which is what
`chaos_smoke` asserts when it claims a run is replayable.

Structural faults are separate from the seeded ones:

* **partition** — a group assignment; cross-group messages are dropped
  (counted, not logged as seeded decisions) until ``heal()``;
* **silence** — outbound blackhole per node (the >1/3-silence scenario);
* per-link FIFO: equal-delay messages arrive in send order (heap ties
  broken by a global sequence), so "reorder" means *extra delay drawn for
  one message*, exactly like a real queueing network.
"""

from __future__ import annotations

import hashlib
import heapq
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple


@dataclass
class LinkPolicy:
    """Fault parameters for one ordered link (or the default for all)."""

    delay_s: float = 0.0       # base one-way latency
    jitter_s: float = 0.0      # + uniform extra in [0, jitter_s)
    drop: float = 0.0          # P(message vanishes)
    duplicate: float = 0.0     # P(a second copy is scheduled)
    reorder: float = 0.0       # P(message gets reorder_extra_s added)
    reorder_extra_s: float = 0.05

    def is_faulty(self) -> bool:
        return any((self.delay_s, self.jitter_s, self.drop,
                    self.duplicate, self.reorder))


@dataclass
class _Decision:
    """One seeded fault decision, as logged and as re-derived on replay."""

    src: str
    dst: str
    seq: int
    chan_id: int
    size: int
    dropped: bool
    duplicated: bool
    delay_s: float
    dup_delay_s: float = 0.0
    # the policy in force when the decision was drawn — policies change
    # mid-run (fault ops), so replay must re-derive under the same one
    policy: LinkPolicy = field(default_factory=LinkPolicy, compare=False)


def _link_rng(seed: int, src: str, dst: str, seq: int) -> random.Random:
    h = hashlib.sha256(f"{seed}|{src}|{dst}|{seq}".encode()).digest()
    return random.Random(int.from_bytes(h[:8], "big"))


def _decide(policy: LinkPolicy, seed: int, src: str, dst: str, seq: int,
            chan_id: int, size: int) -> _Decision:
    """The pure function at the heart of replayability.  Draw order is part
    of the contract: drop, duplicate, jitter, reorder, dup-jitter."""
    rng = _link_rng(seed, src, dst, seq)
    dropped = rng.random() < policy.drop
    duplicated = rng.random() < policy.duplicate
    delay = policy.delay_s + rng.random() * policy.jitter_s
    if rng.random() < policy.reorder:
        delay += policy.reorder_extra_s
    dup_delay = policy.delay_s + rng.random() * (
        policy.jitter_s + policy.reorder_extra_s
    )
    return _Decision(src=src, dst=dst, seq=seq, chan_id=chan_id, size=size,
                     dropped=dropped, duplicated=duplicated,
                     delay_s=delay, dup_delay_s=dup_delay, policy=policy)


class SimNet:
    """The fabric `InProcSwitch` sends through.  Register switches, wire a
    topology with ``connect_full_mesh``, then `start()`."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.default_policy = LinkPolicy()
        self._switches: Dict[str, object] = {}
        self._policies: Dict[Tuple[str, str], LinkPolicy] = {}
        self._link_seq: Dict[Tuple[str, str], int] = {}
        self._partition: Optional[Dict[str, int]] = None  # node -> group
        self._silenced: Set[str] = set()
        self.schedule_log: List[_Decision] = []
        self.stats = {"sent": 0, "delivered": 0, "dropped": 0,
                      "duplicated": 0, "partition_dropped": 0,
                      "silence_dropped": 0}
        self._mtx = threading.Lock()
        self._cv = threading.Condition(self._mtx)
        self._heap: List[tuple] = []  # (due_monotonic, tiebreak, dst, chan, src, msg)
        self._tiebreak = 0
        self._running = False
        self._thread: Optional[threading.Thread] = None

    # -- topology ------------------------------------------------------------
    def register(self, switch) -> None:
        self._switches[switch.node_id] = switch

    def connect_full_mesh(self) -> None:
        ids = sorted(self._switches)
        for a in ids:
            for b in ids:
                if a != b:
                    self._switches[a].connect(b)

    def node_ids(self) -> List[str]:
        return sorted(self._switches)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        with self._mtx:
            if self._running:
                return
            self._running = True
        self._thread = threading.Thread(
            target=self._scheduler, name="simnet-scheduler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        with self._cv:
            self._running = False
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None

    # -- fault controls --------------------------------------------------------
    def set_policy(self, src: Optional[str], dst: Optional[str],
                   policy: LinkPolicy) -> None:
        """Policy for one ordered link, or the all-links default when both
        src and dst are None."""
        with self._mtx:
            if src is None and dst is None:
                self.default_policy = policy
            else:
                self._policies[(src, dst)] = policy

    def clear_policies(self) -> None:
        with self._mtx:
            self._policies.clear()
            self.default_policy = LinkPolicy()

    def set_partition(self, groups: List[Set[str]]) -> None:
        """Messages only flow within a group.  Nodes in no group are
        isolated entirely.

        A partition also DISCONNECTS cross-group peers, like the TCP
        connection breakage a real partition causes.  Dropping silently
        while the peer object stays up would poison the consensus reactor's
        PeerState: votes sent into the blackhole get marked as delivered,
        so after the heal nothing is ever resent and a 2-2 split deadlocks
        forever — real nodes recover precisely because reconnection resets
        the peer's vote bitmaps."""
        assign: Dict[str, int] = {}
        for gi, group in enumerate(groups):
            for node in group:
                assign[node] = gi
        with self._mtx:
            self._partition = assign
            switches = dict(self._switches)
        for a, sw in switches.items():
            for b in switches:
                if a != b and assign.get(a, -1) != assign.get(b, -2):
                    sw.disconnect(b, reason="partitioned")

    def heal_partition(self) -> None:
        with self._mtx:
            self._partition = None
            switches = dict(self._switches)
        for a, sw in switches.items():
            for b in switches:
                if a != b:
                    sw.connect(b)  # idempotent: fresh peers only where cut

    def silence(self, node_ids) -> None:
        with self._mtx:
            self._silenced.update(node_ids)

    def unsilence(self, node_ids=None) -> None:
        """Lift the blackhole AND bounce the node's connections.  While
        silenced, the node kept 'sending' into the void, so its PeerStates
        have marked votes as delivered that never were; without a
        connection reset nothing is ever resent and the voting-power it
        carries never rejoins — a real node coming back from a freeze gets
        its TCP sessions torn down and redialed, which is what resets the
        reactors' per-peer state."""
        with self._mtx:
            affected = (set(self._silenced) if node_ids is None
                        else set(node_ids) & self._silenced)
            self._silenced.difference_update(affected)
            switches = dict(self._switches)
        for a in affected:
            sw = switches.get(a)
            if sw is None:
                continue
            for b in switches:
                if b != a:
                    sw.disconnect(b, reason="unsilenced: session reset")
                    switches[b].disconnect(a, reason="peer unsilenced")
        for a in affected:
            sw = switches.get(a)
            if sw is None:
                continue
            for b in switches:
                if b != a:
                    sw.connect(b)
                    switches[b].connect(a)

    # -- the data path ---------------------------------------------------------
    def send(self, src: str, dst: str, chan_id: int, msg: bytes) -> bool:
        with self._cv:
            if not self._running or dst not in self._switches:
                return False
            self.stats["sent"] += 1
            if src in self._silenced:
                self.stats["silence_dropped"] += 1
                return True  # the sender can't tell a blackhole from slow
            part = self._partition
            if part is not None and part.get(src, -1) != part.get(dst, -2):
                self.stats["partition_dropped"] += 1
                return True
            policy = self._policies.get((src, dst), self.default_policy)
            if not policy.is_faulty():
                # clean link: skip the rng + log entirely so pristine runs
                # don't grow an unbounded decision log
                self._push(0.0, dst, chan_id, src, msg)
                self.stats["delivered"] += 1
                return True
            key = (src, dst)
            seq = self._link_seq.get(key, 0)
            self._link_seq[key] = seq + 1
            d = _decide(policy, self.seed, src, dst, seq, chan_id, len(msg))
            self.schedule_log.append(d)
            if d.dropped:
                self.stats["dropped"] += 1
                return True
            self._push(d.delay_s, dst, chan_id, src, msg)
            self.stats["delivered"] += 1
            if d.duplicated:
                self.stats["duplicated"] += 1
                self._push(d.dup_delay_s, dst, chan_id, src, msg)
            return True

    def _push(self, delay_s: float, dst: str, chan_id: int, src: str,
              msg: bytes) -> None:
        """Caller holds self._cv."""
        due = time.monotonic() + max(0.0, delay_s)
        self._tiebreak += 1
        heapq.heappush(self._heap, (due, self._tiebreak, dst, chan_id, src, msg))
        self._cv.notify()

    def _scheduler(self) -> None:
        while True:
            with self._cv:
                while self._running and (
                    not self._heap or self._heap[0][0] > time.monotonic()
                ):
                    timeout = (
                        None if not self._heap
                        else max(0.0, self._heap[0][0] - time.monotonic())
                    )
                    self._cv.wait(timeout)
                if not self._running:
                    return
                _, _, dst, chan_id, src, msg = heapq.heappop(self._heap)
                part = self._partition
                if part is not None and part.get(src, -1) != part.get(dst, -2):
                    # in-flight messages die with the link when a partition
                    # lands between send and delivery
                    self.stats["partition_dropped"] += 1
                    continue
                sw = self._switches.get(dst)
            if sw is not None:
                try:
                    sw.deliver(chan_id, src, msg)
                except Exception:
                    pass

    # -- replay verification ---------------------------------------------------
    def replay_schedule(self) -> List[int]:
        """Re-derive every logged seeded decision from (seed, link, seq) and
        return the indices that DON'T match — non-empty means the run was
        not replayable (must never happen)."""
        bad = []
        with self._mtx:
            log = list(self.schedule_log)
        for i, d in enumerate(log):
            rd = _decide(d.policy, self.seed, d.src, d.dst, d.seq,
                         d.chan_id, d.size)
            if rd != d:
                bad.append(i)
        return bad

    def fault_summary(self) -> dict:
        with self._mtx:
            out = dict(self.stats)
            out["seeded_decisions"] = len(self.schedule_log)
        return out
