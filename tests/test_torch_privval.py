"""The port's FilePV (privval/file_pv.py) against the reference's.

Every case of ``tests/test_mempool_evidence_privval.py::TestFilePV`` runs
once on each package, and what each run signs is equal (the signatures are
deterministic ed25519 over equal sign bytes). A ``pv.json`` written by
either package loads in the other with its key and last-sign state, and
both then refuse the same regressions and re-sign the same timestamp-only
change the same way.
"""

from types import SimpleNamespace

import pytest

from tendermint_tpu.privval import file_pv as rfile_pv
from tendermint_tpu.types.core import BlockID as RBlockID
from tendermint_tpu.types.core import PartSetHeader as RPartSetHeader
from tendermint_tpu.types.core import SignedMsgType as RSignedMsgType
from tendermint_tpu.types.proposal import Proposal as RProposal
from tendermint_tpu.types.vote import Vote as RVote
from tendermint_tpu_torch.privval import file_pv
from tendermint_tpu_torch.types.core import BlockID, PartSetHeader, SignedMsgType
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.vote import Vote

CHAIN_ID = "mp-chain"
SEED = b"\x09" * 32

REF = SimpleNamespace(name="reference", pv=rfile_pv, Vote=RVote, BlockID=RBlockID,
                      PartSetHeader=RPartSetHeader, T=RSignedMsgType, Proposal=RProposal)
PORT = SimpleNamespace(name="port", pv=file_pv, Vote=Vote, BlockID=BlockID,
                       PartSetHeader=PartSetHeader, T=SignedMsgType, Proposal=Proposal)
PACKAGES = [REF, PORT]


def vote(pkg, height, round, vtype=None, ts=1000, tag=b"h"):
    return pkg.Vote(
        vote_type=vtype if vtype is not None else pkg.T.PREVOTE, height=height, round=round,
        timestamp_ns=ts,
        block_id=pkg.BlockID(hash=tag * 32, parts_header=pkg.PartSetHeader(1, b"p" * 32)),
        validator_address=b"\x00" * 20, validator_index=0,
    )


@pytest.mark.parametrize("pkg", PACKAGES, ids=lambda p: p.name)
class TestFilePV:
    def test_persist_and_reload(self, pkg, tmp_path):
        path = str(tmp_path / "pv.json")
        pv = pkg.pv.FilePV.generate(path, SEED)
        v = pv.sign_vote(CHAIN_ID, vote(pkg, 3, 0))
        assert v.signature
        pv2 = pkg.pv.FilePV.load(path)
        assert pv2.get_pub_key().equals(pv.get_pub_key())
        assert pv2.last_height == 3

    def test_height_regression_refused(self, pkg, tmp_path):
        pv = pkg.pv.FilePV.generate(str(tmp_path / "pv.json"), SEED)
        pv.sign_vote(CHAIN_ID, vote(pkg, 5, 2))
        with pytest.raises(pkg.pv.DoubleSignError, match="height regression"):
            pv.sign_vote(CHAIN_ID, vote(pkg, 4, 0))
        with pytest.raises(pkg.pv.DoubleSignError, match="round regression"):
            pv.sign_vote(CHAIN_ID, vote(pkg, 5, 1))

    def test_step_regression_refused(self, pkg, tmp_path):
        pv = pkg.pv.FilePV.generate(str(tmp_path / "pv.json"), SEED)
        pv.sign_vote(CHAIN_ID, vote(pkg, 5, 0, pkg.T.PRECOMMIT))
        with pytest.raises(pkg.pv.DoubleSignError, match="step regression"):
            pv.sign_vote(CHAIN_ID, vote(pkg, 5, 0, pkg.T.PREVOTE))

    def test_conflicting_same_hrs_refused(self, pkg, tmp_path):
        pv = pkg.pv.FilePV.generate(str(tmp_path / "pv.json"), SEED)
        pv.sign_vote(CHAIN_ID, vote(pkg, 5, 0, tag=b"a"))
        with pytest.raises(pkg.pv.DoubleSignError, match="conflicting"):
            pv.sign_vote(CHAIN_ID, vote(pkg, 5, 0, tag=b"b"))

    def test_timestamp_only_resign_reuses_signature(self, pkg, tmp_path):
        pv = pkg.pv.FilePV.generate(str(tmp_path / "pv.json"), SEED)
        v1 = pv.sign_vote(CHAIN_ID, vote(pkg, 5, 0, ts=1000))
        v2 = pv.sign_vote(CHAIN_ID, vote(pkg, 5, 0, ts=2000))
        assert v2.signature == v1.signature
        assert v2.timestamp_ns == 1000  # the original timestamp restored
        assert pv.get_pub_key().verify_bytes(v2.sign_bytes(CHAIN_ID), v2.signature)

    def test_proposal_sign(self, pkg, tmp_path):
        pv = pkg.pv.FilePV.generate(str(tmp_path / "pv.json"), SEED)
        p = pkg.Proposal(
            height=7, round=0, timestamp_ns=5555,
            block_id=pkg.BlockID(hash=b"x" * 32, parts_header=pkg.PartSetHeader(2, b"p" * 32)),
        )
        sp = pv.sign_proposal(CHAIN_ID, p)
        assert pv.get_pub_key().verify_bytes(sp.sign_bytes(CHAIN_ID), sp.signature)
        sp2 = pv.sign_proposal(CHAIN_ID, p)  # an exact re-sign: the same signature
        assert sp2.signature == sp.signature


def test_both_packages_sign_alike(tmp_path):
    """The same seed, the same votes and proposal: equal signatures and
    equal files (the JSON's fields, in the same order)."""
    out = {}
    for pkg in PACKAGES:
        path = str(tmp_path / f"{pkg.name}.json")
        pv = pkg.pv.FilePV.generate(path, SEED)
        sigs = [pv.sign_vote(CHAIN_ID, vote(pkg, 2, 0)).signature,
                pv.sign_vote(CHAIN_ID, vote(pkg, 2, 0, pkg.T.PRECOMMIT)).signature,
                pv.sign_vote(CHAIN_ID, vote(pkg, 2, 0, pkg.T.PRECOMMIT, ts=9)).signature]
        p = pkg.Proposal(height=3, round=1, timestamp_ns=77,
                         block_id=pkg.BlockID(hash=b"y" * 32,
                                              parts_header=pkg.PartSetHeader(1, b"q" * 32)))
        sigs.append(pv.sign_proposal(CHAIN_ID, p).signature)
        with open(path) as f:
            out[pkg.name] = (sigs, f.read())
    assert out["reference"] == out["port"]


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["reference-to-port", "port-to-reference"])
def test_a_pv_json_written_by_one_package_loads_in_the_other(writer, reader, tmp_path):
    path = str(tmp_path / "pv.json")
    pv = writer.pv.FilePV.generate(path, SEED)
    v1 = pv.sign_vote(CHAIN_ID, vote(writer, 6, 1, writer.T.PRECOMMIT, ts=1234))
    other = reader.pv.FilePV.load(path)
    assert other.get_pub_key().bytes() == pv.get_pub_key().bytes()
    assert (other.last_height, other.last_round, other.last_step) == (6, 1,
                                                                     reader.pv.STEP_PRECOMMIT)
    assert (other.last_signature, other.last_sign_bytes) == (pv.last_signature,
                                                             pv.last_sign_bytes)
    # the loaded state keeps the double-sign protection ...
    with pytest.raises(reader.pv.DoubleSignError, match="round regression"):
        other.sign_vote(CHAIN_ID, vote(reader, 6, 0))
    with pytest.raises(reader.pv.DoubleSignError, match="conflicting"):
        other.sign_vote(CHAIN_ID, vote(reader, 6, 1, reader.T.PRECOMMIT, ts=1234, tag=b"z"))
    # ... and re-signs a timestamp-only change with the writer's signature
    v2 = other.sign_vote(CHAIN_ID, vote(reader, 6, 1, reader.T.PRECOMMIT, ts=5678))
    assert (v2.signature, v2.timestamp_ns) == (v1.signature, 1234)
    # the reader's file loads back in the writer with the next height signed
    other.sign_vote(CHAIN_ID, vote(reader, 7, 0))
    back = writer.pv.FilePV.load(path)
    assert (back.last_height, back.last_round, back.last_step) == (7, 0, writer.pv.STEP_PREVOTE)
