"""The port's state layer and block execution against the reference's on the
same inputs: ``types/params.py``, ``part_set.py``, ``tx.py``,
``results.py``, ``evidence.py``, ``genesis.py``, the block types,
``libs/pubsub.py``, ``types/events.py``, ``state/``,
``blockchain/store.py``, ``evidence/pool.py``, ``testutil/chain.py`` and
``abci/examples/kvstore.PersistentKVStoreApp``.

The restated cases of ``tests/test_state.py`` (``TestStateStore``,
``TestBlockExecutor``, ``TestBlockStore``, ``TestEventBus``),
``tests/test_types.py`` (``TestPartSet``, ``TestBlock``, ``TestEvidence``,
``TestGenesis``) and ``tests/test_mempool_evidence_privval.py``'s
``TestEvidencePool`` run once on each package: the reference test's
assertions hold on both, and what each run observes (hashes, heights,
codes, bytes) is equal. The reference runs with its host verifier (the
suite's conftest installs it); the port with the configuration root's
guarded verifier on ``device="cpu"`` (the kernels' plain versions) at
``dispatch_deadline=0``. The parity case builds one chain on both packages
with two validator-set changes and compares every height's block, part-set
header, app and results hashes, validator hashes, proposer, state bytes and
stored ABCI responses.
"""

import base64
from types import SimpleNamespace

import pytest

import tendermint_tpu.types as rtypes
from tendermint_tpu.abci import types as rabci
from tendermint_tpu.abci.examples import kvstore as rkv
from tendermint_tpu.blockchain import store as rbstore
from tendermint_tpu.crypto import keys as rkeys
from tendermint_tpu.crypto.batch import HostBatchVerifier as RHostBatchVerifier
from tendermint_tpu.crypto.batch import set_batch_verifier as rset_batch_verifier
from tendermint_tpu.encoding.codec import Writer as RWriter
from tendermint_tpu.evidence import pool as rpool
from tendermint_tpu.libs import pubsub as rpubsub
from tendermint_tpu.libs.db import kv as rkvdb
from tendermint_tpu.proxy import app_conn as rapp_conn
from tendermint_tpu.state import execution as rexec
from tendermint_tpu.state import state_types as rst
from tendermint_tpu.state import store as rstore
from tendermint_tpu.state import validation as rvalidation
from tendermint_tpu.testutil import chain as rchain
from tendermint_tpu.types import events as revents
from tendermint_tpu.types import evidence as revidence
from tendermint_tpu.types import part_set as rpart_set
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.examples import kvstore as kv
from tendermint_tpu_torch.blockchain import store as bstore
from tendermint_tpu_torch.config.verify import VerifyConfig
from tendermint_tpu_torch.crypto import keys
from tendermint_tpu_torch.encoding.codec import Writer
from tendermint_tpu_torch.evidence import pool
from tendermint_tpu_torch.libs import fail, pubsub
from tendermint_tpu_torch.libs.db import kv as kvdb
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.proxy import app_conn
from tendermint_tpu_torch.state import execution
from tendermint_tpu_torch.state import state_types as st_types
from tendermint_tpu_torch.state import store
from tendermint_tpu_torch.state import validation
from tendermint_tpu_torch.testutil import chain
from tendermint_tpu_torch.types import block as tblock
from tendermint_tpu_torch.types import core, events, genesis, params, part_set
from tendermint_tpu_torch.types import evidence as tevidence
from tendermint_tpu_torch.types import priv_validator, results, tx
from tendermint_tpu_torch.types import validator_set as tvs
from tendermint_tpu_torch.types import vote as tvote

CHAIN_ID = "exec-chain"
TYPES_CHAIN_ID = "test-chain"
TIME0 = 1_700_000_000_000_000_000

REF = SimpleNamespace(
    name="reference", Writer=RWriter, abci=rabci, kv=rkv, MemDB=rkvdb.MemDB, conn=rapp_conn,
    store=rstore, execution=rexec, st=rst, validation=rvalidation,
    BlockStore=rbstore.BlockStore,
    EventBus=revents.EventBus, EvidencePool=rpool.EvidencePool, pubsub=rpubsub,
    chain=rchain, EvidenceError=revidence.EvidenceError,
    ErrPartSetInvalidProof=rpart_set.ErrPartSetInvalidProof,
    PrivKeyEd25519=rkeys.PrivKeyEd25519, **{n: getattr(rtypes, n) for n in (
        "Block", "BlockID", "Commit", "ConsensusParams", "DuplicateVoteEvidence", "GenesisDoc",
        "GenesisValidator", "MockPV", "Part", "PartSet", "PartSetHeader", "SignedMsgType",
        "Tx", "Txs", "ABCIResults", "Validator", "ValidatorSet", "Vote")})
PORT = SimpleNamespace(
    name="port", Writer=Writer, abci=abci, kv=kv, MemDB=kvdb.MemDB, conn=app_conn,
    store=store, execution=execution, st=st_types, validation=validation,
    BlockStore=bstore.BlockStore,
    EventBus=events.EventBus, EvidencePool=pool.EvidencePool, pubsub=pubsub, chain=chain,
    EvidenceError=tevidence.EvidenceError,
    ErrPartSetInvalidProof=part_set.ErrPartSetInvalidProof,
    PrivKeyEd25519=keys.PrivKeyEd25519, Block=tblock.Block, BlockID=core.BlockID,
    Commit=tblock.Commit, ConsensusParams=params.ConsensusParams,
    DuplicateVoteEvidence=tevidence.DuplicateVoteEvidence, GenesisDoc=genesis.GenesisDoc,
    GenesisValidator=genesis.GenesisValidator, MockPV=priv_validator.MockPV,
    Part=part_set.Part, PartSet=part_set.PartSet, PartSetHeader=core.PartSetHeader,
    SignedMsgType=core.SignedMsgType, Tx=tx.Tx, Txs=tx.Txs, ABCIResults=results.ABCIResults,
    Validator=tvs.Validator, ValidatorSet=tvs.ValidatorSet, Vote=tvote.Vote)


@pytest.fixture(autouse=True)
def _verifiers():
    """The reference's host verifier (as its suite's conftest installs it)
    and the port's guarded verifier on the CPU."""
    rset_batch_verifier(RHostBatchVerifier())
    verify_root.configure_verify(VerifyConfig(dispatch_deadline=0), device="cpu")
    yield
    verify_root.reset_verify()


def both(scenario):
    """Run ``scenario`` on each package; what each observes is equal."""
    want, got = scenario(REF), scenario(PORT)
    assert got == want
    return got


# -- tests/test_state.py's helpers, on either package ------------------------------


def make_genesis(ns, n=1, power=10):
    pvs = [ns.MockPV(ns.PrivKeyEd25519.generate(bytes([i + 1]) * 32)) for i in range(n)]
    doc = ns.GenesisDoc(chain_id=CHAIN_ID, genesis_time_ns=TIME0,
                        validators=[ns.GenesisValidator(pv.get_pub_key(), power) for pv in pvs])
    doc.validate_and_complete()
    return doc, pvs


def commit_for(ns, state, block, pvs, block_id):
    """A commit for ``block`` signed by every validator of ``state``."""
    by_addr = {pv.get_pub_key().address(): pv for pv in pvs}
    precommits = []
    for i, val in enumerate(state.validators.validators):
        vote = ns.Vote(vote_type=ns.SignedMsgType.PRECOMMIT, height=block.height, round=0,
                       timestamp_ns=block.header.time_ns + 1_000_000, block_id=block_id,
                       validator_address=val.address, validator_index=i)
        precommits.append(by_addr[val.address].sign_vote(CHAIN_ID, vote))
    return ns.Commit(block_id=block_id, precommits=precommits)


def setup_executor(ns, n_vals=1, app=None):
    doc, pvs = make_genesis(ns, n_vals)
    st = ns.st.state_from_genesis(doc)
    state_db = ns.MemDB()
    ns.store.save_state(state_db, st)
    conn = ns.conn.MultiAppConn(ns.conn.LocalClientCreator(app or ns.kv.KVStoreApp()))
    conn.start()
    return st, pvs, ns.execution.BlockExecutor(state_db, conn.consensus), state_db


def apply_one(ns, st, pvs, executor, height, txs, last_commit):
    block = st.make_block(height, txs, last_commit,
                          proposer_address=st.validators.get_proposer().address)
    bid = ns.BlockID(hash=block.hash(), parts_header=block.make_part_set().header())
    new_state = executor.apply_block(st, bid, block)
    # the commit of height H is signed by H's validators (the pre-apply set)
    return new_state, block, bid, commit_for(ns, st, block, pvs, bid)


def observe(st):
    return (st.last_block_height, st.last_block_total_tx, st.app_hash, st.last_results_hash,
            st.validators.hash(), st.next_validators.hash(), st.marshal())


# -- tests/test_state.py::TestStateStore --------------------------------------------


class TestStateStore:
    def test_state_roundtrip(self):
        def scenario(ns):
            doc, _ = make_genesis(ns, 3)
            st = ns.st.state_from_genesis(doc)
            db = ns.MemDB()
            ns.store.save_state(db, st)
            rt = ns.store.load_state(db)
            assert rt.chain_id == st.chain_id
            assert rt.validators.hash() == st.validators.hash()
            assert rt.last_block_height == 0
            return rt.marshal(), st.marshal()
        both(scenario)

    def test_validators_pointer_chasing(self):
        def scenario(ns):
            doc, _ = make_genesis(ns, 2)
            st = ns.st.state_from_genesis(doc)
            db = ns.MemDB()
            ns.store.save_validators_info(db, 1, 1, st.validators)
            ns.store.save_validators_info(db, 2, 1, st.validators)  # the pointer only
            v2 = ns.store.load_validators(db, 2)
            assert v2.hash() == st.validators.hash()
            return v2.marshal(), db.get(b"validatorsKey:2")
        both(scenario)

    def test_median_time_weighted(self):
        def scenario(ns):
            doc, pvs = make_genesis(ns, 3)
            st = ns.st.state_from_genesis(doc)
            bid = ns.BlockID(hash=b"\x01" * 32)
            by_addr = {p.get_pub_key().address(): p for p in pvs}
            votes = [by_addr[val.address].sign_vote(CHAIN_ID, ns.Vote(
                ns.SignedMsgType.PRECOMMIT, 1, 0, t, bid, val.address, i))
                for i, (val, t) in enumerate(zip(st.validators.validators, (100, 200, 300)))]
            got = ns.st.median_time(ns.Commit(block_id=bid, precommits=votes), st.validators)
            assert got == 200
            return got
        both(scenario)


# -- tests/test_state.py::TestBlockExecutor -----------------------------------------


class TestBlockExecutor:
    def test_chain_of_blocks(self):
        def scenario(ns):
            st, pvs, executor, _ = setup_executor(ns)
            st1, _, _, c1 = apply_one(ns, st, pvs, executor, 1, [b"a=1"], ns.Commit())
            assert st1.last_block_height == 1 and st1.app_hash != b""
            st2, _, _, c2 = apply_one(ns, st1, pvs, executor, 2, [b"b=2", b"c=3"], c1)
            assert st2.last_block_height == 2 and st2.last_block_total_tx == 3
            st3, *_ = apply_one(ns, st2, pvs, executor, 3, [], c2)
            assert st3.last_block_height == 3
            return [observe(s) for s in (st1, st2, st3)]
        both(scenario)

    def test_invalid_block_rejected(self):
        def scenario(ns):
            st, pvs, executor, _ = setup_executor(ns)
            block = st.make_block(5, [], ns.Commit(),
                                  proposer_address=st.validators.get_proposer().address)
            bid = ns.BlockID(hash=block.hash(), parts_header=block.make_part_set().header())
            with pytest.raises(ns.execution.InvalidBlockError) as ei:
                executor.apply_block(st, bid, block)
            return str(ei.value), block.hash()
        both(scenario)

    def test_tampered_last_commit_rejected(self):
        def scenario(ns):
            st, pvs, executor, _ = setup_executor(ns)
            st1, _, _, c1 = apply_one(ns, st, pvs, executor, 1, [b"a=1"], ns.Commit())
            bad = ns.Commit(block_id=c1.block_id,
                            precommits=[c1.precommits[0].with_signature(b"\x11" * 64)])
            block2 = st1.make_block(2, [], bad,
                                    proposer_address=st1.validators.get_proposer().address)
            bid2 = ns.BlockID(hash=block2.hash(), parts_header=block2.make_part_set().header())
            with pytest.raises(ns.execution.InvalidBlockError, match="signature") as ei:
                executor.apply_block(st1, bid2, block2)
            return str(ei.value), block2.hash()
        both(scenario)

    def test_validator_set_change_via_endblock(self):
        def scenario(ns):
            st, pvs, executor, _ = setup_executor(ns, app=ns.kv.PersistentKVStoreApp())
            new_pv = ns.MockPV(ns.PrivKeyEd25519.generate(b"\x42" * 32))
            tx = b"val:" + base64.b64encode(new_pv.get_pub_key().bytes()) + b"!7"
            st1, _, _, c1 = apply_one(ns, st, pvs, executor, 1, [tx], ns.Commit())
            # the change lands in NextValidators at H + 1, the active set at H + 2
            assert st1.next_validators.size == 2 and st1.validators.size == 1
            st2, *_ = apply_one(ns, st1, pvs, executor, 2, [], c1)
            assert st2.validators.size == 2
            assert st2.last_height_validators_changed == 3
            return observe(st1), observe(st2)
        both(scenario)

    def test_abci_responses_persisted(self):
        def scenario(ns):
            st, pvs, executor, state_db = setup_executor(ns)
            st1, *_ = apply_one(ns, st, pvs, executor, 1, [b"k=v"], ns.Commit())
            resp = ns.store.load_abci_responses(state_db, 1)
            assert len(resp.deliver_tx) == 1
            assert resp.deliver_tx[0].code == ns.abci.CODE_TYPE_OK
            assert st1.last_results_hash == resp.results_hash()
            return resp.marshal(), st1.last_results_hash
        both(scenario)


# -- tests/test_state.py::TestBlockStore and TestEventBus ---------------------------


class TestBlockStore:
    def test_save_load_roundtrip(self):
        def scenario(ns):
            doc, pvs = make_genesis(ns, 1)
            st = ns.st.state_from_genesis(doc)
            bs = ns.BlockStore(ns.MemDB())
            block = st.make_block(1, [b"t=1"], ns.Commit(),
                                  proposer_address=st.validators.get_proposer().address)
            parts = block.make_part_set(256)
            bid = ns.BlockID(hash=block.hash(), parts_header=parts.header())
            bs.save_block(block, parts, commit_for(ns, st, block, pvs, bid))
            assert bs.height() == 1
            loaded = bs.load_block(1)
            assert loaded.hash() == block.hash()
            assert bs.load_block_meta(1).block_id == bid
            assert bs.load_seen_commit(1).block_id == bid
            part = bs.load_block_part(1, 0)
            assert part.bytes_ == parts.get_part(0).bytes_
            return loaded.marshal(), bs.load_block_meta(1).marshal(), part.marshal()
        both(scenario)

    def test_non_contiguous_rejected(self):
        def scenario(ns):
            bs = ns.BlockStore(ns.MemDB())
            doc, _ = make_genesis(ns, 1)
            st = ns.st.state_from_genesis(doc)
            block = st.make_block(2, [], ns.Commit(),
                                  proposer_address=st.validators.get_proposer().address)
            with pytest.raises(ValueError, match="contiguous") as ei:
                bs.save_block(block, block.make_part_set(256), ns.Commit())
            return str(ei.value)
        both(scenario)


class TestEventBus:
    def test_tx_events_queryable(self):
        def scenario(ns):
            bus = ns.EventBus()
            bus.start()
            sub = bus.subscribe("test", "tm.event = 'Tx' AND tx.height = 5")
            res = ns.abci.ResponseDeliverTx(code=0, tags=[ns.abci.KVPair(b"app.key", b"x")])
            bus.publish_event_tx(5, 0, b"tx-bytes", res)
            bus.publish_event_tx(6, 0, b"other", res)
            msg = sub.get(timeout=1)
            assert msg.data.height == 5
            assert msg.tags["app.key"] == "x"
            assert sub.queue.empty()
            bus.stop()
            return msg.tags, msg.data.tx
        both(scenario)


# -- tests/test_types.py: TestPartSet, TestBlock, TestEvidence, TestGenesis ----------


def make_vals(ns, n, power=10):
    pvs = [ns.MockPV(ns.PrivKeyEd25519.generate(bytes([i + 1]) * 32)) for i in range(n)]
    vs = ns.ValidatorSet([ns.Validator(pv.get_pub_key(), power) for pv in pvs])
    by_addr = {pv.get_pub_key().address(): pv for pv in pvs}
    return vs, [by_addr[v.address] for v in vs.validators]


def some_block_id(ns, tag=b"x"):
    return ns.BlockID(hash=bytes(tag) * 32 if len(tag) == 1 else tag,
                      parts_header=ns.PartSetHeader(total=1, hash=b"p" * 32))


def make_vote(ns, pv, vs, height, round, vtype, block_id, ts=TIME0):
    addr = pv.get_pub_key().address()
    idx, _ = vs.get_by_address(addr)
    return pv.sign_vote(TYPES_CHAIN_ID, ns.Vote(
        vote_type=vtype, height=height, round=round, timestamp_ns=ts, block_id=block_id,
        validator_address=addr, validator_index=idx))


class TestPartSet:
    def test_split_and_reassemble(self):
        def scenario(ns):
            data = bytes(range(256)) * 1000  # 256,000 bytes: 4 parts
            ps = ns.PartSet.from_data(data)
            assert ps.total == 4 and ps.is_complete()
            rx = ns.PartSet(ps.header())
            for i in [2, 0, 3, 1]:
                assert rx.add_part(ps.get_part(i))
            assert rx.is_complete() and rx.assemble() == data
            return ps.header(), [ps.get_part(i).marshal() for i in range(4)]
        want, got = scenario(REF), scenario(PORT)
        assert (got[0].total, got[0].hash, got[1]) == (want[0].total, want[0].hash, want[1])

    def test_bad_proof_rejected(self):
        def scenario(ns):
            ps = ns.PartSet.from_data(b"q" * 100000)
            other = ns.PartSet.from_data(b"r" * 100000)
            rx = ns.PartSet(ps.header())
            with pytest.raises(ns.ErrPartSetInvalidProof):
                rx.add_part(other.get_part(0))
            return rx.count
        both(scenario)

    def test_part_codec_roundtrip(self):
        def scenario(ns):
            ps = ns.PartSet.from_data(b"w" * 70000)
            p = ps.get_part(1)
            rt = ns.Part.unmarshal(p.marshal())
            assert rt.index == p.index and rt.bytes_ == p.bytes_
            assert ns.PartSet(ps.header()).add_part(rt)
            return rt.marshal()
        both(scenario)


class TestBlock:
    @staticmethod
    def _block(ns):
        vs, pvs = make_vals(ns, 4)
        bid = some_block_id(ns)
        last_commit = ns.Commit(block_id=bid, precommits=[
            make_vote(ns, pvs[i], vs, 1, 0, ns.SignedMsgType.PRECOMMIT, bid)
            for i in range(vs.size)])
        block = ns.Block.make_block(2, [b"tx1", b"tx2"], last_commit)
        block.header.validators_hash = vs.hash()
        block.header.next_validators_hash = vs.hash()
        block.header.chain_id = TYPES_CHAIN_ID
        block.header.proposer_address = vs.get_proposer().address
        return block, vs

    def test_hash_and_validate(self):
        def scenario(ns):
            block, _ = self._block(ns)
            assert block.hash() is not None
            block.validate_basic()
            return block.hash(), block.last_commit.hash(), block.last_commit.bit_array().marshal()
        both(scenario)

    def test_marshal_roundtrip_preserves_hash(self):
        def scenario(ns):
            block, _ = self._block(ns)
            rt = ns.Block.unmarshal(block.marshal())
            assert rt.hash() == block.hash()
            rt.validate_basic()
            return rt.marshal()
        both(scenario)

    def test_tamper_changes_hash(self):
        def scenario(ns):
            block, _ = self._block(ns)
            h = block.hash()
            block.data.txs.append(b"evil")
            block.header.data_hash = block.data.hash()
            assert block.hash() != h
            return block.hash()
        both(scenario)

    def test_part_set_roundtrip(self):
        def scenario(ns):
            block, _ = self._block(ns)
            ps = block.make_part_set(256)
            assert ps.total > 1
            rt = ns.Block.unmarshal(ps.assemble())
            assert rt.hash() == block.hash()
            return ps.total, ps.header().hash
        both(scenario)


class TestEvidence:
    def test_duplicate_vote_evidence(self):
        def scenario(ns):
            vs, pvs = make_vals(ns, 4)
            v1 = make_vote(ns, pvs[0], vs, 2, 0, ns.SignedMsgType.PREVOTE, some_block_id(ns, b"a"))
            v2 = make_vote(ns, pvs[0], vs, 2, 0, ns.SignedMsgType.PREVOTE, some_block_id(ns, b"b"))
            ev = ns.DuplicateVoteEvidence(pub_key=pvs[0].get_pub_key(), vote_a=v1, vote_b=v2)
            ev.verify(TYPES_CHAIN_ID)
            rt = ns.DuplicateVoteEvidence.unmarshal(ev.marshal())
            assert rt.hash() == ev.hash()
            with pytest.raises(ns.EvidenceError):  # a same-block pair is not evidence
                ns.DuplicateVoteEvidence(pub_key=pvs[0].get_pub_key(), vote_a=v1,
                                         vote_b=v1).verify(TYPES_CHAIN_ID)
            return ev.marshal(), ev.hash()
        both(scenario)


class TestGenesis:
    def test_json_roundtrip(self, tmp_path):
        def scenario(ns):
            _, pvs = make_vals(ns, 2)
            doc = ns.GenesisDoc(chain_id=TYPES_CHAIN_ID, genesis_time_ns=TIME0, validators=[
                ns.GenesisValidator(pv.get_pub_key(), 10, f"v{i}") for i, pv in enumerate(pvs)])
            doc.validate_and_complete()
            p = tmp_path / f"genesis-{ns.name}.json"
            doc.save_as(str(p))
            rt = ns.GenesisDoc.from_file(str(p))
            assert rt.chain_id == doc.chain_id
            assert rt.validator_hash() == doc.validator_hash()
            assert rt.genesis_time_ns == doc.genesis_time_ns
            return p.read_text(), rt.validator_hash()
        both(scenario)


# -- tests/test_mempool_evidence_privval.py::TestEvidencePool ------------------------


def dup_vote(ns, st, pvs, height, tags):
    val = st.validators.validators[0]
    pv = {p.get_pub_key().address(): p for p in pvs}[val.address]
    votes = [pv.sign_vote(st.chain_id, ns.Vote(
        ns.SignedMsgType.PREVOTE, height, 0, 123,
        ns.BlockID(hash=t * 32, parts_header=ns.PartSetHeader(1, b"p" * 32)),
        val.address, 0)) for t in tags]
    return ns.DuplicateVoteEvidence(pub_key=val.pub_key, vote_a=votes[0], vote_b=votes[-1])


class TestEvidencePool:
    def test_add_verify_commit_age(self):
        def scenario(ns):
            doc, pvs = make_genesis(ns, 2)
            st = ns.st.state_from_genesis(doc)
            st.last_block_height = 5
            state_db = ns.MemDB()
            ns.store.save_validators_info(state_db, 5, 5, st.validators)
            evpool = ns.EvidencePool(state_db, ns.MemDB(), st)
            ev = dup_vote(ns, st, pvs, 5, (b"a", b"b"))
            evpool.add_evidence(ev)
            assert len(evpool.pending_evidence()) == 1
            evpool.add_evidence(ev)  # a duplicate is ignored
            pending = [e.marshal() for e in evpool.pending_evidence()]
            assert len(pending) == 1

            class B:
                height = 6

                class evidence:
                    evidence = [ev]

            evpool.update(B, st)
            assert evpool.is_committed(ev)
            assert len(evpool.pending_evidence()) == 0
            return pending, len(evpool.evidence_list)
        both(scenario)

    def test_invalid_evidence_rejected(self):
        def scenario(ns):
            doc, pvs = make_genesis(ns, 1)
            st = ns.st.state_from_genesis(doc)
            st.last_block_height = 3
            state_db = ns.MemDB()
            ns.store.save_validators_info(state_db, 3, 3, st.validators)
            evpool = ns.EvidencePool(state_db, ns.MemDB(), st)
            ev = dup_vote(ns, st, pvs, 3, (b"q",))  # same-block votes: not evidence
            with pytest.raises(Exception) as ei:
                evpool.add_evidence(ev)
            return str(ei.value), evpool.pending_evidence()
        both(scenario)


# -- the build_chain parity case -----------------------------------------------------

PARITY_VALS, PARITY_HEIGHTS, PARITY_TXS = 8, 12, 2
CHANGE_HEIGHTS = (4, 8)


def parity_chain(ns):
    """8 validators, 12 heights, 2 txs a block; at heights 4 and 8 a
    ``PersistentKVStoreApp`` validator tx adds one new key (power 7) and
    another removes one of the genesis keys. Per height: the block's hash,
    its part-set header, its header's app, results and validator hashes
    and proposer, the height's validator set, its stored ABCI responses,
    its seen commit and the marshalled state it was built on."""
    joiners = [ns.MockPV(ns.PrivKeyEd25519.generate(bytes([60 + i]) * 32)) for i in range(2)]

    def val_tx(pub: bytes, power: int) -> bytes:
        return b"val:" + base64.b64encode(pub) + b"!%d" % power

    states = []  # the state each height is built on, as bytes

    def on_height(h, st):
        states.append(st.marshal())
        txs = [b"k%d-%d=v%d" % (h, j, h) for j in range(PARITY_TXS)]
        if h in CHANGE_HEIGHTS:
            i = CHANGE_HEIGHTS.index(h)
            leaver = [v for v in st.next_validators.validators if v.voting_power == 10][i]
            txs += [val_tx(joiners[i].get_pub_key().bytes(), 7),
                    val_tx(leaver.pub_key.bytes(), 0)]
        return txs

    fx = ns.chain.build_chain(n_vals=PARITY_VALS, n_heights=PARITY_HEIGHTS, chain_id="parity",
                              app_factory=ns.kv.PersistentKVStoreApp, on_height=on_height,
                              extra_pvs=joiners)
    heights = []
    state_db = fx.state_db
    for h in range(1, PARITY_HEIGHTS + 1):
        block = fx.block_store.load_block(h)
        meta = fx.block_store.load_block_meta(h)
        vals = ns.store.load_validators(state_db, h)
        heights.append((
            block.hash(), meta.block_id.parts_header.total, meta.block_id.parts_header.hash,
            block.header.app_hash, block.header.last_results_hash,
            block.header.validators_hash, block.header.next_validators_hash,
            block.header.proposer_address, vals.marshal(),
            ns.store.load_abci_responses(state_db, h).marshal(),
            fx.block_store.load_seen_commit(h).marshal(), states[h - 1],
        ))
    return heights, fx.state.marshal(), fx.state.validators.size


def test_build_chain_equals_the_reference_at_every_height():
    want, got = parity_chain(REF), parity_chain(PORT)
    assert len(got[0]) == PARITY_HEIGHTS
    for h, (g, w) in enumerate(zip(got[0], want[0]), start=1):
        assert g == w, f"height {h} differs"
    assert got[1:] == want[1:]
    assert got[2] == PARITY_VALS  # one joined and one left, twice
    # both changes reached the validators hash
    assert len({row[5] for row in got[0]}) == 3


# -- the port's own surfaces -----------------------------------------------------------


def test_state_marshal_roundtrips_every_height():
    fx = chain.build_chain(n_vals=3, n_heights=4, txs_per_block=1)
    rt = st_types.State.unmarshal(fx.state.marshal())
    assert rt.marshal() == fx.state.marshal()
    assert rt.copy().marshal() == fx.state.marshal()
    assert store.load_state(fx.state_db).marshal() == fx.state.marshal()
    doc = fx.genesis
    assert store.load_state_from_db_or_genesis(fx.state_db, doc).last_block_height == 4
    assert store.load_state_from_db_or_genesis(kvdb.MemDB(), doc).last_block_height == 0


@pytest.mark.parametrize("delta", ["none", "block_size", "evidence", "validator", "invalid"])
def test_consensus_params_update_equals_the_reference(delta):
    def run(ns):
        updates = {
            "none": None,
            "block_size": ns.abci.ConsensusParams(block_size=ns.abci.BlockSizeParams(1000, 50)),
            "evidence": ns.abci.ConsensusParams(evidence=ns.abci.EvidenceParams(7)),
            "validator": ns.abci.ConsensusParams(
                validator=ns.abci.ValidatorParams(["ed25519", "secp256k1"])),
            "invalid": ns.abci.ConsensusParams(block_size=ns.abci.BlockSizeParams(0, 1)),
        }
        p = ns.ConsensusParams().update(updates[delta])
        try:
            p.validate()
            ok = None
        except ValueError as e:
            ok = str(e)
        w = ns.Writer()
        p.encode(w)
        return p.hash(), w.build(), ok
    assert run(PORT) == run(REF)


def test_tx_proofs_and_results_equal_the_reference():
    items = [b"tx%d" % i for i in range(7)]

    def run(ns):
        txs = ns.Txs([ns.Tx(t) for t in items])
        proofs = [txs.proof(i) for i in range(len(items))]
        assert all(p.validate(txs.hash()) is None for p in proofs)
        assert proofs[2].validate(b"\x00" * 32) == "proof matches different data hash"
        res = ns.ABCIResults.from_deliver_txs(
            [ns.abci.ResponseDeliverTx(code=i % 3, data=b"d%d" % i) for i in range(5)])
        return txs.hash(), [p.proof.aunts for p in proofs], res.hash(), txs.index(b"tx3")
    assert run(PORT) == run(REF)


def test_block_store_prune_and_backfill_equal_the_reference():
    def run(ns):
        fx = ns.chain.build_chain(n_vals=2, n_heights=6, txs_per_block=1)
        bs = fx.block_store
        assert bs.base() == 1 and bs.height() == 6
        assert bs.prune(4) == 3 and bs.base() == 4
        assert bs.load_block(2) is None and bs.load_block(4) is not None
        metas = [bs.load_block_meta(h) for h in (4, 5)]
        commits = [bs.load_block_commit(h) for h in (4, 5)]
        seeded = ns.BlockStore(ns.MemDB())
        seeded.save_statesync_backfill(metas, commits)
        assert (seeded.base(), seeded.height()) == (4, 5)
        assert seeded.load_block(5) is None
        with pytest.raises(ValueError):
            seeded.save_statesync_backfill(metas, commits)
        reopened = ns.BlockStore(seeded._db)
        return (reopened.base(), reopened.height(), seeded.load_seen_commit(5).marshal(),
                [m.marshal() for m in metas])
    assert run(PORT) == run(REF)


@pytest.mark.parametrize("query,tags,want", [
    ("tm.event = 'Tx'", {"tm.event": "Tx"}, True),
    ("tx.height > 5 AND tx.height <= 7", {"tx.height": "7"}, True),
    ("tx.height > 5", {"tx.height": "5"}, False),
    ("app.creator CONTAINS 'kv'", {"app.creator": "kvstore"}, True),
    ("app.key != 'x'", {"app.key": "x"}, False),
    ("name < 'b'", {"name": "a"}, True),
])
def test_pubsub_queries_match_as_the_reference(query, tags, want):
    assert pubsub.Query(query).matches(tags) is want
    assert rpubsub.Query(query).matches(tags) is want
    with pytest.raises(pubsub.QueryError):
        pubsub.Query("tm.event =")


def test_pubsub_drops_for_a_full_subscriber_and_counts():
    srv = pubsub.Server()
    sub = srv.subscribe("slow", "tm.event = 'Tx'", maxsize=1)
    dropped = []
    srv.set_on_drop(dropped.append)
    for i in range(3):
        srv.publish(i, {"tm.event": "Tx"})
    assert sub.get(timeout=1).data == 0
    assert srv.dropped_events("slow") == 2 and dropped == ["slow", "slow"]
    with pytest.raises(pubsub.DuplicateSubscriptionError):
        srv.subscribe("slow", "tm.event = 'Tx'")
    srv.unsubscribe("slow", "tm.event = 'Tx'")
    assert sub.cancelled.is_set() and srv.num_clients() == 0


def test_fire_events_publish_block_header_and_txs():
    fx = chain.build_chain(n_vals=1, n_heights=1, txs_per_block=0)
    bus = events.EventBus()
    bus.start()
    subs = {q: bus.subscribe("t", q) for q in (
        "tm.event = 'NewBlock'", "tm.event = 'NewBlockHeader'", "tm.event = 'Tx'")}
    st, pvs = fx.state, fx.pvs
    conn = app_conn.MultiAppConn(app_conn.LocalClientCreator(kv.KVStoreApp()))
    conn.start()
    db = kvdb.MemDB()
    st0 = st_types.state_from_genesis(fx.genesis)
    store.save_state(db, st0)
    ex = execution.BlockExecutor(db, conn.consensus, event_bus=bus)
    st1, block, _, _ = apply_one(PORT, st0, pvs, ex, 1, [b"a=1", b"b=2"], tblock.Commit())
    msgs = {q: s.get(timeout=5) for q, s in subs.items()}
    assert msgs["tm.event = 'NewBlock'"].data.block is block
    assert msgs["tm.event = 'NewBlockHeader'"].data.header is block.header
    tx_msgs = [msgs["tm.event = 'Tx'"], subs["tm.event = 'Tx'"].get(timeout=5)]
    assert [m.data.tx for m in tx_msgs] == [b"a=1", b"b=2"]
    assert tx_msgs[0].tags["tx.height"] == "1" and tx_msgs[0].tags["app.key"] == "a"
    bus.stop()


def test_fail_point_counts_to_its_index(monkeypatch):
    exits = []
    monkeypatch.setattr(fail.os, "_exit", exits.append)
    try:
        fail.reset(2)
        for _ in range(4):
            fail.fail_point()
        assert exits == [1]
        fail.reset(None)
        fail.fail_point()
        assert exits == [1]
    finally:
        fail.reset(None)


def test_the_abci_json_form_equals_the_reference():
    def run(ns):
        msg = [[ns.abci.ResponseDeliverTx(code=1, data=b"\x01", log="l",
                                          tags=[ns.abci.KVPair(b"k", b"v")])],
               ns.abci.ResponseEndBlock(validator_updates=[
                   ns.abci.ValidatorUpdate(pub_key_type="ed25519", pub_key=b"\x02" * 32,
                                           power=3)]),
               ns.abci.ResponseBeginBlock()]
        raw = ns.abci.msg_to_json(msg)
        assert ns.abci.msg_from_json(raw) == msg
        return raw
    assert run(PORT) == run(REF)
    # every dataclass a persisted response can carry is in the table
    assert set(abci._MSG_TYPES) >= {"ResponseDeliverTx", "ResponseEndBlock",
                                    "ResponseBeginBlock", "KVPair", "ValidatorUpdate",
                                    "ConsensusParams", "BlockSizeParams", "EvidenceParams",
                                    "ValidatorParams"}
