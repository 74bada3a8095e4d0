"""A signed chain executed block by block: N validators, K heights, real
commits and real state execution (the reference grows such fixtures in
types/test_util.go MakeCommit and consensus/wal_generator.go:31); the
port's copy of the reference package's ``testutil/chain.py``.

Every block is applied through a ``BlockExecutor`` with the installed
verifier, so its LastCommit goes through ``verify_commit`` as a node's
would.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

from tendermint_tpu_torch.abci.examples.kvstore import KVStoreApp
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519
from tendermint_tpu_torch.libs.db.kv import DB, MemDB
from tendermint_tpu_torch.proxy.app_conn import LocalClientCreator, MultiAppConn
from tendermint_tpu_torch.state import store as sm_store
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.state.state_types import State, state_from_genesis
from tendermint_tpu_torch.types.block import Commit
from tendermint_tpu_torch.types.core import BlockID, SignedMsgType
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.priv_validator import MockPV
from tendermint_tpu_torch.types.vote import Vote
from tendermint_tpu_torch.types.vote_set import VoteSet


@dataclass
class ChainFixture:
    chain_id: str
    genesis: GenesisDoc
    pvs: List[MockPV]  # sorted-set order
    state: State  # state after the last applied block
    state_db: DB
    block_store: BlockStore
    height: int


def build_chain(
    n_vals: int = 4,
    n_heights: int = 10,
    chain_id: str = "chain-fixture",
    txs_per_block: int = 0,
    block_store_db: Optional[DB] = None,
    state_db: Optional[DB] = None,
    app_factory: Optional[Callable[[], object]] = None,
    genesis: Optional[GenesisDoc] = None,
    pvs: Optional[List[MockPV]] = None,
    on_height: Optional[Callable[[int, State], List[bytes]]] = None,
    extra_pvs: Optional[List[MockPV]] = None,
) -> ChainFixture:
    """Build and execute a chain: every block's commit is signed by all
    validators and the block applied through a ``BlockExecutor`` and the
    app, so the headers (app hash, results, validator hashes) are what a
    node produces. ``on_height(h, state) -> txs`` gives a height's txs
    (e.g. ``PersistentKVStoreApp`` validator txs); ``extra_pvs`` sign for
    validators that join on the way."""
    if genesis is None:
        # a 4-byte counter repeated: unique for any n_vals
        seeds = [(i + 1).to_bytes(4, "big") * 8 for i in range(n_vals)]
        pv_list = [MockPV(PrivKeyEd25519.generate(s)) for s in seeds]
        genesis = GenesisDoc(
            chain_id=chain_id,
            genesis_time_ns=1_700_000_000_000_000_000,
            validators=[GenesisValidator(pv.get_pub_key(), 10) for pv in pv_list],
        )
        genesis.validate_and_complete()
    else:
        pv_list = list(pvs or [])
        chain_id = genesis.chain_id

    st = state_from_genesis(genesis)
    # the signers in the set's (address) order; extra_pvs sign for
    # validators that join on the way
    by_addr = {pv.get_pub_key().address(): pv for pv in pv_list}
    for pv in extra_pvs or []:
        by_addr[pv.get_pub_key().address()] = pv
    sorted_pvs = [by_addr[v.address] for v in st.validators.validators]

    state_db = state_db if state_db is not None else MemDB()
    sm_store.save_state(state_db, st)
    conn = MultiAppConn(
        LocalClientCreator(app_factory() if app_factory else KVStoreApp())
    )
    conn.start()
    block_exec = BlockExecutor(state_db, conn.consensus)
    block_store = BlockStore(block_store_db if block_store_db is not None else MemDB())

    last_commit = Commit()
    base_time = genesis.genesis_time_ns
    for h in range(1, n_heights + 1):
        if on_height is not None:
            txs = on_height(h, st)
        else:
            txs = [
                f"k{h}-{j}=v{h}".encode() for j in range(txs_per_block)
            ]
        proposer = st.validators.get_proposer()
        block = st.make_block(h, txs, last_commit, [], proposer.address)
        parts = block.make_part_set()
        block_id = BlockID(hash=block.hash(), parts_header=parts.header())

        # every validator precommits, after the block's time, so that the
        # next block's median time passes the monotonic check
        vote_set = VoteSet(chain_id, h, 0, SignedMsgType.PRECOMMIT, st.validators)
        for idx, val in enumerate(st.validators.validators):
            pv = by_addr[val.address]
            vote = Vote(
                vote_type=SignedMsgType.PRECOMMIT,
                height=h,
                round=0,
                timestamp_ns=base_time + (h + 1) * 1_000_000_000,
                block_id=block_id,
                validator_address=val.address,
                validator_index=idx,
            )
            vote_set.add_vote(pv.sign_vote(chain_id, vote))
        seen_commit = vote_set.make_commit()

        block_store.save_block(block, parts, seen_commit)
        st = block_exec.apply_block(st, block_id, block)
        last_commit = seen_commit

    return ChainFixture(
        chain_id=chain_id,
        genesis=genesis,
        pvs=sorted_pvs,
        state=st,
        state_db=state_db,
        block_store=block_store,
        height=n_heights,
    )
