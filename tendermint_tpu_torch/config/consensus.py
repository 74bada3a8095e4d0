"""The ``[consensus]`` configuration section.

The port's copy of the JAX package's ``config/config.py`` ``ConsensusConfig``
(ref config/config.go:573-580): every field under the same name and with
the same default, and the consensus half of its ``test_config()``
(config.go:592-594 TestConsensusConfig) as ``consensus_test_config()``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ConsensusConfig:
    wal_path: str = "data/cs.wal/wal"
    # base timeouts (s) + per-round delta (config.go:573-580)
    timeout_propose: float = 3.0
    timeout_propose_delta: float = 0.5
    timeout_prevote: float = 1.0
    timeout_prevote_delta: float = 0.5
    timeout_precommit: float = 1.0
    timeout_precommit_delta: float = 0.5
    timeout_commit: float = 1.0
    skip_timeout_commit: bool = False
    create_empty_blocks: bool = True
    create_empty_blocks_interval: float = 0.0
    peer_gossip_sleep_duration: float = 0.1
    peer_query_maj23_sleep_duration: float = 2.0
    blocktime_iota: float = 1.0  # min time between blocks (s)

    def propose(self, round: int) -> float:
        return self.timeout_propose + self.timeout_propose_delta * round

    def prevote(self, round: int) -> float:
        return self.timeout_prevote + self.timeout_prevote_delta * round

    def precommit(self, round: int) -> float:
        return self.timeout_precommit + self.timeout_precommit_delta * round

    def commit(self, t: float) -> float:
        """Deadline for starting the next height given commit time t."""
        return t + self.timeout_commit

    def wait_for_txs(self) -> bool:
        return not self.create_empty_blocks or self.create_empty_blocks_interval > 0

    def min_valid_vote_time_ns(self, block_time_ns: int) -> int:
        return block_time_ns + int(self.blocktime_iota * 1e9)


def consensus_test_config() -> ConsensusConfig:
    """The shrunken timeouts of the reference's ``test_config()`` (ref
    config.go:592-594 TestConsensusConfig), ``skip_timeout_commit`` on."""
    return ConsensusConfig(
        timeout_propose=0.5,
        timeout_propose_delta=0.1,
        timeout_prevote=0.1,
        timeout_prevote_delta=0.05,
        timeout_precommit=0.1,
        timeout_precommit_delta=0.05,
        timeout_commit=0.1,
        skip_timeout_commit=True,
        peer_gossip_sleep_duration=0.005,
        peer_query_maj23_sleep_duration=0.25,
        blocktime_iota=0.0,
    )
