"""In-process consensus fixtures (ref consensus/common_test.go), the port's
copy of the reference's ``tests/consensus_harness.py`` without its
multi-node net, which needs p2p.

``ValidatorStub`` is a scripted co-validator that signs real votes with a
``MockPV``; ``make_consensus_state`` builds a full ``ConsensusState`` over
in-memory stores and a ``KVStoreApp`` at one validator of a genesis and
returns stubs for the others. ``decide_proposal`` builds and signs the
proposal and parts a stub proposer would send, as the state machine's
``_default_decide_proposal`` does for its own validator (the Go harness's
``decideProposal``). A block's LastCommit is verified through the
installed verifier, and peer votes through a vote feed once the caller
sets one (``ConsensusState.set_vote_feed``).
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

from tendermint_tpu_torch.abci.examples.kvstore import KVStoreApp
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.config.consensus import ConsensusConfig, consensus_test_config
from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519
from tendermint_tpu_torch.evidence.pool import EvidencePool
from tendermint_tpu_torch.libs.db.kv import MemDB
from tendermint_tpu_torch.mempool.mempool import Mempool
from tendermint_tpu_torch.proxy.app_conn import LocalClientCreator, MultiAppConn
from tendermint_tpu_torch.state import store as sm_store
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.state.services import MockEvidencePool
from tendermint_tpu_torch.state.state_types import state_from_genesis
from tendermint_tpu_torch.types.block import Block, Commit
from tendermint_tpu_torch.types.core import BlockID, SignedMsgType
from tendermint_tpu_torch.types.events import EventBus
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.part_set import PartSet
from tendermint_tpu_torch.types.priv_validator import MockPV
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.vote import Vote

CHAIN_ID = "cs-test-chain"


class ValidatorStub:
    """Scripted co-validator (common_test.go:58). ``now_ns`` stamps its
    votes and proposals."""

    def __init__(self, pv: MockPV, index: int, now_ns: Callable[[], int] = time.time_ns):
        self.pv = pv
        self.index = index
        self.height = 1
        self.round = 0
        self.now_ns = now_ns

    @property
    def address(self) -> bytes:
        return self.pv.get_pub_key().address()

    def sign_vote(
        self, vtype: SignedMsgType, block_id: BlockID,
        height: Optional[int] = None, round: Optional[int] = None,
    ) -> Vote:
        vote = Vote(
            vote_type=vtype,
            height=height if height is not None else self.height,
            round=round if round is not None else self.round,
            timestamp_ns=self.now_ns(),
            block_id=block_id,
            validator_address=self.address,
            validator_index=self.index,
        )
        return self.pv.sign_vote(CHAIN_ID, vote)


def make_genesis(n_vals: int, power: int = 10) -> Tuple[GenesisDoc, List[MockPV]]:
    pvs = [MockPV(PrivKeyEd25519.generate(bytes([i + 1]) * 32)) for i in range(n_vals)]
    doc = GenesisDoc(
        chain_id=CHAIN_ID,
        genesis_time_ns=1_700_000_000_000_000_000,
        validators=[GenesisValidator(pv.get_pub_key(), power) for pv in pvs],
    )
    doc.validate_and_complete()
    return doc, pvs


def make_cs_from_genesis(
    doc: GenesisDoc,
    pv=None,
    config: Optional[ConsensusConfig] = None,
    wal=None,
    state_db=None,
    block_store_db=None,
    app=None,
    real_evidence_pool: bool = False,
) -> Tuple[ConsensusState, EventBus]:
    """One full ConsensusState (its own stores and app) for a genesis
    (common_test.go newConsensusStateWithConfigAndBlockStore); ``config``
    defaults to the TestConsensusConfig timeouts."""
    cfg = config or consensus_test_config()
    st = state_from_genesis(doc)
    state_db = state_db if state_db is not None else MemDB()
    sm_store.save_state(state_db, st)

    conn = MultiAppConn(LocalClientCreator(app or KVStoreApp()))
    conn.start()
    mempool = Mempool(conn.mempool)
    if real_evidence_pool:
        evpool = EvidencePool(state_db, MemDB(), st.copy())
    else:
        evpool = MockEvidencePool()
    block_store = BlockStore(block_store_db if block_store_db is not None else MemDB())

    bus = EventBus()
    bus.start()
    block_exec = BlockExecutor(state_db, conn.consensus, mempool, evpool, bus)

    cs = ConsensusState(cfg, st.copy(), block_exec, block_store, mempool, evpool, wal=wal)
    cs.set_event_bus(bus)
    if pv is not None:
        cs.set_priv_validator(pv)
    return cs, bus


def make_consensus_state(
    n_vals: int,
    our_index: int = 0,
    config: Optional[ConsensusConfig] = None,
    wal=None,
    state_db=None,
    block_store_db=None,
    app=None,
    real_evidence_pool: bool = False,
) -> Tuple[ConsensusState, List[ValidatorStub], EventBus]:
    """Our ConsensusState at validator ``our_index`` + stubs for the rest,
    indexed by position in the sorted validator set."""
    doc, pvs = make_genesis(n_vals)
    st = state_from_genesis(doc)
    by_addr = {pv.get_pub_key().address(): pv for pv in pvs}
    sorted_pvs = [by_addr[v.address] for v in st.validators.validators]
    cs, bus = make_cs_from_genesis(
        doc, sorted_pvs[our_index], config=config, wal=wal, state_db=state_db,
        block_store_db=block_store_db, app=app, real_evidence_pool=real_evidence_pool,
    )
    stubs = [
        ValidatorStub(pv, i)
        for i, pv in enumerate(sorted_pvs)
        if i != our_index
    ]
    return cs, stubs, bus


def decide_proposal(cs: ConsensusState, stub: ValidatorStub, height: int,
                    round: int) -> Tuple[Proposal, Block, PartSet]:
    """The proposal, block and parts that ``stub`` sends as the proposer of
    ``height``/``round``: the block from ``cs``'s state, last commit,
    pending evidence and mempool with the stub as proposer, and the
    proposal at ``cs``'s valid round, signed by the stub (as
    ``_default_decide_proposal``, consensus/state.py:593-620). Where ``cs``
    holds no LastCommit (the first height after a fast-sync hand-off), the
    block carries the stored seen commit of the height before."""
    with cs._mtx:
        rs, state = cs.rs, cs.state
        if height == 1:
            commit = Commit()
        elif rs.last_commit is not None:
            commit = rs.last_commit.make_commit()
        else:
            # the stub holds the commit that a node fresh from fast sync
            # lacks (its switch clears the LastCommit): the stored one
            commit = cs.block_store.load_seen_commit(height - 1)
        max_bytes = state.consensus_params.block_size.max_bytes
        max_gas = state.consensus_params.block_size.max_gas
        evidence = cs.evpool.pending_evidence(max_bytes // 10)
        txs = cs.mempool.reap_max_bytes_max_gas(max_bytes * 9 // 10, max_gas)
        block = state.make_block(height, txs, commit, evidence, stub.address)
        pol_round = rs.valid_round
    parts = block.make_part_set()
    proposal = Proposal(
        height=height,
        round=round,
        timestamp_ns=stub.now_ns(),
        block_id=BlockID(hash=block.hash(), parts_header=parts.header()),
        pol_round=pol_round,
    )
    return stub.pv.sign_proposal(CHAIN_ID, proposal), block, parts


def wait_for(predicate, timeout: float = 10.0, interval: float = 0.01) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False
