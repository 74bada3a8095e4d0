"""State: what the next block is validated against (ref state/state.go:51),
the port's copy of the reference package's ``state/state_types.py``.

``median_time`` is BFT time (state.go:167): the voting-power-weighted
median of the LastCommit's timestamps, which holds while under 1/3 of the
power is byzantine.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from tendermint_tpu_torch.encoding.codec import Reader, Writer
from tendermint_tpu_torch.types.block import Block, Commit, Version
from tendermint_tpu_torch.types.core import BlockID
from tendermint_tpu_torch.types.genesis import GenesisDoc
from tendermint_tpu_torch.types.params import ConsensusParams
from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet


@dataclass
class State:
    chain_id: str = ""
    version: Version = field(default_factory=Version)

    last_block_height: int = 0
    last_block_total_tx: int = 0
    last_block_id: BlockID = field(default_factory=BlockID)
    last_block_time_ns: int = 0

    next_validators: Optional[ValidatorSet] = None
    validators: Optional[ValidatorSet] = None
    last_validators: Optional[ValidatorSet] = None
    last_height_validators_changed: int = 0

    consensus_params: ConsensusParams = field(default_factory=ConsensusParams)
    last_height_consensus_params_changed: int = 0

    last_results_hash: bytes = b""
    app_hash: bytes = b""

    def copy(self) -> "State":
        def cp(vs):
            return vs.copy() if vs is not None else None

        return State(
            chain_id=self.chain_id,
            version=self.version,
            last_block_height=self.last_block_height,
            last_block_total_tx=self.last_block_total_tx,
            last_block_id=self.last_block_id,
            last_block_time_ns=self.last_block_time_ns,
            next_validators=cp(self.next_validators),
            validators=cp(self.validators),
            last_validators=cp(self.last_validators),
            last_height_validators_changed=self.last_height_validators_changed,
            consensus_params=self.consensus_params,
            last_height_consensus_params_changed=self.last_height_consensus_params_changed,
            last_results_hash=self.last_results_hash,
            app_hash=self.app_hash,
        )

    def is_empty(self) -> bool:
        return self.validators is None

    def make_block(self, height: int, txs: List[bytes], commit: Commit,
                   evidence: Optional[list] = None, proposer_address: bytes = b"") -> Block:
        """The next proposal block with the state's header fields (ref
        state.go:132). Its time is the commit's BFT median time, or the
        genesis time at height 1 (state.go:144)."""
        block = Block.make_block(height, txs, commit, evidence)
        h = block.header
        h.version = self.version
        h.chain_id = self.chain_id
        h.time_ns = (self.last_block_time_ns if height == 1
                     else median_time(commit, self.last_validators))
        h.total_txs = self.last_block_total_tx + len(txs)
        h.last_block_id = self.last_block_id
        h.validators_hash = self.validators.hash()
        h.next_validators_hash = self.next_validators.hash()
        h.consensus_hash = self.consensus_params.hash()
        h.app_hash = self.app_hash
        h.last_results_hash = self.last_results_hash
        h.proposer_address = proposer_address
        return block

    def marshal(self) -> bytes:
        w = Writer()
        w.string(self.chain_id)
        self.version.encode(w)
        w.svarint(self.last_block_height).svarint(self.last_block_total_tx)
        self.last_block_id.encode(w)
        w.fixed64(self.last_block_time_ns)
        for vs in (self.next_validators, self.validators, self.last_validators):
            w.bool(vs is not None)
            if vs is not None:
                vs.encode(w)
        w.svarint(self.last_height_validators_changed)
        self.consensus_params.encode(w)
        w.svarint(self.last_height_consensus_params_changed)
        w.bytes(self.last_results_hash).bytes(self.app_hash)
        return w.build()

    @classmethod
    def unmarshal(cls, data: bytes) -> "State":
        r = Reader(data)
        chain_id = r.string()
        version = Version.decode(r)
        lbh, lbt = r.svarint(), r.svarint()
        lbid = BlockID.decode(r)
        lbtime = r.fixed64()
        sets = [ValidatorSet.decode(r) if r.bool() else None for _ in range(3)]
        return cls(
            chain_id=chain_id,
            version=version,
            last_block_height=lbh,
            last_block_total_tx=lbt,
            last_block_id=lbid,
            last_block_time_ns=lbtime,
            next_validators=sets[0],
            validators=sets[1],
            last_validators=sets[2],
            last_height_validators_changed=r.svarint(),
            consensus_params=ConsensusParams.decode(r),
            last_height_consensus_params_changed=r.svarint(),
            last_results_hash=r.bytes(),
            app_hash=r.bytes(),
        )


def median_time(commit: Commit, validators: ValidatorSet) -> int:
    """The voting-power-weighted median of the commit's vote timestamps
    (state.go:167), in unix nanoseconds."""
    weighted: List[Tuple[int, int]] = []  # (time_ns, power)
    total = 0
    vals = validators.validators
    for i, pc in enumerate(commit.precommits):
        if pc is None or i >= len(vals):
            continue
        power = vals[i].voting_power
        weighted.append((pc.timestamp_ns, power))
        total += power
    if not weighted:
        return 0
    weighted.sort()
    half, acc = total // 2, 0
    for t, p in weighted:
        acc += p
        if acc > half:
            return t
    return weighted[-1][0]


def state_from_genesis(genesis: GenesisDoc) -> State:
    """The state at height 0 (ref state.go MakeGenesisState)."""
    genesis.validate_and_complete()
    vals = [Validator(v.pub_key, v.power) for v in genesis.validators]
    vs = ValidatorSet(vals) if vals else None
    return State(
        chain_id=genesis.chain_id,
        last_block_height=0,
        last_block_id=BlockID(),
        last_block_time_ns=genesis.genesis_time_ns,
        validators=vs,
        next_validators=vs.copy_increment_accum(1) if vs else None,
        last_validators=ValidatorSet(),
        last_height_validators_changed=1,
        consensus_params=genesis.consensus_params,
        last_height_consensus_params_changed=1,
        app_hash=genesis.app_hash,
    )
