"""The port's remote signer (``privval/remote_signer.py``) against the
reference's.

* Every case of ``tests/test_remote_signer.py`` runs once on each package:
  TCP over the secret connection, a unix socket, the pinned signer key, a
  consensus state that commits through a remote signer.
* Across the packages: the frames each endpoint writes are byte-equal to
  the reference's for the same calls, in both directions; a port signer
  serves a reference node endpoint and a reference signer a port one, over
  TCP and a unix socket, and a double sign is refused over the wire.
* The node: a port ``Node`` (``device="cpu"``, the host verifying) whose
  ``priv_validator_laddr`` is set commits 3 heights through its remote
  signer; a pin on a unix address is refused, and a node that no signer
  dials tears its endpoint down and gives the port back.
"""

import socket
import time
from types import SimpleNamespace

import pytest

from tendermint_tpu.crypto.batch import HostBatchVerifier as RHostBatchVerifier
from tendermint_tpu.crypto.batch import set_batch_verifier as rset_batch_verifier
from tendermint_tpu.crypto.keys import PrivKeyEd25519 as RKey
from tendermint_tpu.privval import file_pv as r_file_pv
from tendermint_tpu.privval import remote_signer as r_rs
from tendermint_tpu.types import BlockID as RBlockID
from tendermint_tpu.types import GenesisDoc as RGenesisDoc
from tendermint_tpu.types import GenesisValidator as RGenesisValidator
from tendermint_tpu.types import PartSetHeader as RPartSetHeader
from tendermint_tpu.types import SignedMsgType as RSignedMsgType
from tendermint_tpu.types import Vote as RVote
from tendermint_tpu.types.proposal import Proposal as RProposal
from tendermint_tpu_torch.config import config as pconfig
from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519
from tendermint_tpu_torch.node import node as node_mod
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.node.node import init_home
from tendermint_tpu_torch.privval import file_pv
from tendermint_tpu_torch.privval import remote_signer as rs
from tendermint_tpu_torch.testutil import consensus as p_harness
from tendermint_tpu_torch.testutil import node_net
from tendermint_tpu_torch.types.core import BlockID, PartSetHeader, SignedMsgType
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.vote import Vote

from tests import consensus_harness as r_harness

CHAIN = "signer-chain"
DEADLINE = 60.0

REF = SimpleNamespace(name="reference", rs=r_rs, pv=r_file_pv, Vote=RVote, BlockID=RBlockID,
                      PartSetHeader=RPartSetHeader, T=RSignedMsgType, Proposal=RProposal,
                      Key=RKey, GenesisDoc=RGenesisDoc, GenesisValidator=RGenesisValidator,
                      harness=r_harness)
PORT = SimpleNamespace(name="port", rs=rs, pv=file_pv, Vote=Vote, BlockID=BlockID,
                       PartSetHeader=PartSetHeader, T=SignedMsgType, Proposal=Proposal,
                       Key=PrivKeyEd25519, GenesisDoc=GenesisDoc,
                       GenesisValidator=GenesisValidator, harness=p_harness)
PACKAGES = [REF, PORT]
by_pkg = pytest.mark.parametrize("pkg", PACKAGES, ids=lambda p: p.name)


@pytest.fixture(autouse=True)
def _host_verify():
    rset_batch_verifier(RHostBatchVerifier())
    verify_root.install_host_verify()
    yield
    verify_root.reset_verify()


def _vote(pkg, height=1, round=0, h=b"\xaa" * 32, t=None, addr=b"\x01" * 20, ts=None):
    return pkg.Vote(
        vote_type=t if t is not None else pkg.T.PREVOTE, height=height, round=round,
        timestamp_ns=ts if ts is not None else time.time_ns(),
        block_id=pkg.BlockID(hash=h, parts_header=pkg.PartSetHeader(1, b"\xbb" * 32)),
        validator_address=addr, validator_index=0)


def _pair(signer_pkg, node_pkg, tmp_path, addr, seed=None, conn_key=None):
    """A node endpoint of ``node_pkg`` at ``addr`` and a signer of
    ``signer_pkg`` holding a ``FilePV`` that dials it."""
    pv = signer_pkg.pv.FilePV.generate(str(tmp_path / f"pv-{signer_pkg.name}.json"), seed)
    node_end = node_pkg.rs.SignerValidatorEndpoint(addr)
    node_end.start()
    if addr.startswith("tcp://") and addr.endswith(":0"):
        addr = f"tcp://127.0.0.1:{node_end.listen_port}"
    signer = signer_pkg.rs.SignerServiceEndpoint(addr, pv, conn_key=conn_key)
    signer.start()
    assert node_end.wait_for_signer(10)
    return pv, node_end, signer


# ---------------------------------------------------------------------------
# tests/test_remote_signer.py, restated on both packages
# ---------------------------------------------------------------------------


@by_pkg
class TestRemoteSignerTCP:
    def test_pubkey_and_vote_roundtrip(self, pkg, tmp_path):
        pv, node_end, signer = _pair(pkg, pkg, tmp_path, "tcp://127.0.0.1:0")
        try:
            assert node_end.get_pub_key().bytes() == pv.get_pub_key().bytes()
            vote = _vote(pkg, addr=pv.address)
            signed = node_end.sign_vote(CHAIN, vote)
            assert pv.get_pub_key().verify_bytes(vote.sign_bytes(CHAIN), signed.signature)
            assert node_end.ping()
        finally:
            signer.stop(), node_end.stop()

    def test_double_sign_refused_over_wire(self, pkg, tmp_path):
        pv, node_end, signer = _pair(pkg, pkg, tmp_path, "tcp://127.0.0.1:0")
        try:
            node_end.sign_vote(CHAIN, _vote(pkg, height=5, h=b"\xaa" * 32, addr=pv.address))
            with pytest.raises(pkg.rs.RemoteSignerError):
                node_end.sign_vote(CHAIN, _vote(pkg, height=5, h=b"\xcc" * 32, addr=pv.address))
            with pytest.raises(pkg.rs.RemoteSignerError):
                node_end.sign_vote(CHAIN, _vote(pkg, height=4, addr=pv.address))
        finally:
            signer.stop(), node_end.stop()

    def test_channel_is_encrypted(self, pkg, tmp_path, monkeypatch):
        captured = []
        orig_sendall = socket.socket.sendall

        def sniff(self, data, *a):
            captured.append(bytes(data))
            return orig_sendall(self, data, *a)

        monkeypatch.setattr(socket.socket, "sendall", sniff)
        pv, node_end, signer = _pair(pkg, pkg, tmp_path, "tcp://127.0.0.1:0")
        try:
            node_end.sign_vote("very-secret-chain-id", _vote(pkg, addr=pv.address))
        finally:
            signer.stop(), node_end.stop()
        assert captured
        assert all(b"very-secret-chain-id" not in frame for frame in captured)


@by_pkg
class TestRemoteSignerUnix:
    def test_roundtrip_over_unix_socket(self, pkg, tmp_path):
        sock_path = str(tmp_path / "pv.sock")
        pv, node_end, signer = _pair(pkg, pkg, tmp_path, f"unix://{sock_path}")
        try:
            assert node_end.get_pub_key().bytes() == pv.get_pub_key().bytes()
            vote = _vote(pkg, addr=pv.address)
            signed = node_end.sign_vote(CHAIN, vote)
            assert pv.get_pub_key().verify_bytes(vote.sign_bytes(CHAIN), signed.signature)
        finally:
            signer.stop(), node_end.stop()


@by_pkg
class TestConsensusWithRemoteSigner:
    def test_pinned_signer_pubkey_rejects_impostor(self, pkg, tmp_path):
        pv = pkg.pv.FilePV.generate(str(tmp_path / "pv.json"))
        good_key = pkg.Key.generate(b"\x11" * 32)
        bad_key = pkg.Key.generate(b"\x22" * 32)
        node_end = pkg.rs.SignerValidatorEndpoint(
            "tcp://127.0.0.1:0", expected_signer_pubkey=good_key.pub_key())
        node_end.start()
        addr = f"tcp://127.0.0.1:{node_end.listen_port}"
        try:
            impostor = pkg.rs.SignerServiceEndpoint(addr, pv, conn_key=bad_key)
            impostor.start()
            assert not node_end.wait_for_signer(2)
            impostor.stop()
            signer = pkg.rs.SignerServiceEndpoint(addr, pv, conn_key=good_key)
            signer.start()
            assert node_end.wait_for_signer(10)
            assert node_end.get_pub_key().bytes() == pv.get_pub_key().bytes()
            signer.stop()
        finally:
            node_end.stop()

    def test_single_validator_commits_via_remote_signer(self, pkg, tmp_path):
        pv = pkg.pv.FilePV.generate(str(tmp_path / "pv.json"))
        node_end = pkg.rs.SignerValidatorEndpoint("tcp://127.0.0.1:0")
        node_end.start()
        signer = pkg.rs.SignerServiceEndpoint(f"tcp://127.0.0.1:{node_end.listen_port}", pv)
        signer.start()
        assert node_end.wait_for_signer(10)
        doc = pkg.GenesisDoc(chain_id="remote-signer-chain",
                             genesis_time_ns=1_700_000_000_000_000_000,
                             validators=[pkg.GenesisValidator(pv.get_pub_key(), 10)])
        doc.validate_and_complete()
        cs, bus = pkg.harness.make_cs_from_genesis(doc, node_end)
        cs.start()
        try:
            assert pkg.harness.wait_for(lambda: cs.get_round_state().height >= 4,
                                        timeout=DEADLINE), cs.get_round_state().height
        finally:
            cs.stop()
            bus.stop()
            signer.stop()
            node_end.stop()


# ---------------------------------------------------------------------------
# the packages against each other
# ---------------------------------------------------------------------------


def _record_frames(monkeypatch, pkg, frames):
    real = pkg.rs._Conn.send

    def send(self, payload):
        frames.append(bytes(payload))
        return real(self, payload)

    monkeypatch.setattr(pkg.rs._Conn, "send", send)


def _drive(pkg, node_end, pv):
    """The same calls on either package: the key, a ping, a prevote and a
    precommit, a proposal, a refused double sign. Returns what came back."""
    out = [node_end.get_pub_key().bytes(), node_end.ping()]
    for t in (pkg.T.PREVOTE, pkg.T.PRECOMMIT):
        out.append(node_end.sign_vote(CHAIN, _vote(pkg, height=3, t=t, addr=pv.address,
                                                   ts=1_700_000_000_000_000_000)).signature)
    prop = pkg.Proposal(height=4, round=0, timestamp_ns=1_700_000_000_000_000_001,
                        block_id=pkg.BlockID(b"\x02" * 32, pkg.PartSetHeader(1, b"\x01" * 32)))
    out.append(node_end.sign_proposal(CHAIN, prop).signature)
    with pytest.raises(pkg.rs.RemoteSignerError) as ei:
        node_end.sign_vote(CHAIN, _vote(pkg, height=3, h=b"\xcc" * 32, addr=pv.address,
                                        ts=1_700_000_000_000_000_000))
    out.append(str(ei.value))
    return out


@pytest.mark.parametrize("transport", ["tcp", "unix"])
@pytest.mark.parametrize("signer_pkg,node_pkg", [(PORT, REF), (REF, PORT)],
                         ids=["port_signer_reference_node", "reference_signer_port_node"])
def test_the_frames_equal_the_reference_both_ways(monkeypatch, tmp_path, transport,
                                                  signer_pkg, node_pkg):
    """A mixed pair (one package's signer, the other's node endpoint) and
    the all-reference pair make the same calls: every frame each side
    writes, requests and responses, is byte-equal, and so is what the node
    gets back, the double sign's refusal included."""
    runs = []
    for s_pkg, n_pkg in ((signer_pkg, node_pkg), (REF, REF)):
        frames = []
        for pkg in {id(s_pkg): s_pkg, id(n_pkg): n_pkg}.values():
            _record_frames(monkeypatch, pkg, frames)
        d = tmp_path / f"{s_pkg.name}-{n_pkg.name}"
        d.mkdir()
        addr = "tcp://127.0.0.1:0" if transport == "tcp" else f"unix://{d / 'pv.sock'}"
        pv, node_end, signer = _pair(s_pkg, n_pkg, d, addr, seed=b"\x05" * 32)
        try:
            got = _drive(n_pkg, node_end, pv)
        finally:
            signer.stop(), node_end.stop()
        runs.append((frames, got))
        monkeypatch.undo()
    assert runs[0][1] == runs[1][1]
    assert runs[0][0] == runs[1][0]
    assert len(runs[0][0]) == 2 * 6  # six requests, six responses


@pytest.mark.parametrize("signer_pkg,node_pkg", [(PORT, REF), (REF, PORT)],
                         ids=["port_signer_reference_node", "reference_signer_port_node"])
def test_a_signer_of_one_package_serves_a_node_of_the_other(tmp_path, signer_pkg, node_pkg):
    pv, node_end, signer = _pair(signer_pkg, node_pkg, tmp_path, "tcp://127.0.0.1:0")
    try:
        assert node_end.get_pub_key().bytes() == pv.get_pub_key().bytes()
        vote = _vote(node_pkg, height=7, addr=pv.address)
        signed = node_end.sign_vote(CHAIN, vote)
        assert pv.get_pub_key().verify_bytes(vote.sign_bytes(CHAIN), signed.signature)
        # the signer's FilePV refuses a conflicting vote: the refusal crosses
        with pytest.raises(node_pkg.rs.RemoteSignerError, match="conflicting"):
            node_end.sign_vote(CHAIN, _vote(node_pkg, height=7, h=b"\xcc" * 32,
                                            addr=pv.address))
        with pytest.raises(node_pkg.rs.RemoteSignerError, match="height regression"):
            node_end.sign_vote(CHAIN, _vote(node_pkg, height=6, addr=pv.address))
        assert node_end.ping()
    finally:
        signer.stop(), node_end.stop()


def test_parse_addr_equals_the_reference():
    for addr in ("tcp://127.0.0.1:26659", "tcp://:5", "unix:///tmp/pv.sock"):
        assert rs._parse_addr(addr) == r_rs._parse_addr(addr)
    for bad in ("udp://1.2.3.4:5", "127.0.0.1:5"):
        errs = []
        for parse in (rs._parse_addr, r_rs._parse_addr):
            with pytest.raises(ValueError) as ei:
                parse(bad)
            errs.append(str(ei.value))
        assert errs[0] == errs[1]
    tags = [n for n in dir(r_rs) if n.startswith("_") and n.endswith(("_REQ", "_RESP"))]
    assert len(tags) == 11 and all(getattr(rs, n) == getattr(r_rs, n) for n in tags)


# ---------------------------------------------------------------------------
# the node's remote signer
# ---------------------------------------------------------------------------


def _single_home(home: str, key):
    doc = GenesisDoc(chain_id="remote-node-chain", genesis_time_ns=1_700_000_000_000_000_000,
                     validators=[GenesisValidator(key.pub_key(), 10)])
    doc.validate_and_complete()
    init_home(home, doc, priv_key=key)


def test_a_port_node_commits_three_heights_through_its_remote_signer(tmp_path):
    key = PrivKeyEd25519.generate(b"\x31" * 32)
    home = str(tmp_path / "node")
    _single_home(home, key)
    cfg = pconfig.test_config()
    cfg.base.priv_validator_laddr = f"tcp://127.0.0.1:{node_net.free_port()}"
    signer = node_net.RemoteSigner(key, str(tmp_path / "signer" / "pv.json"),
                                   cfg.base.priv_validator_laddr)
    node = None
    try:
        node = node_net.make_single_node(home, config=cfg, device="cpu")
        assert isinstance(node.priv_validator, rs.SignerValidatorEndpoint)
        assert node.priv_validator is node.signer_endpoint
        assert node.consensus_state.priv_validator is node.signer_endpoint
        node.start()
        assert node_net.wait_for(lambda: node.block_store.height() >= 3, DEADLINE), (
            node.block_store.height())
        for h in (2, 3):
            commit = node.block_store.load_block_commit(h - 1) or node.block_store.load_seen_commit(h - 1)
            assert commit.precommits[0].signature
            vals = node.consensus_state.get_state().validators
            vals.verify_commit("remote-node-chain", commit.block_id, h - 1, commit)
        assert signer.requests >= 2 * 3  # a prevote and a precommit a height at least
        # the signer's FilePV holds the last height the node signed
        assert file_pv.FilePV.load(signer.pv.file_path).last_height >= 3
        vi = node.status()["validator_info"]
        assert vi["address"] == key.pub_key().address().hex().upper() and vi["voting_power"] == 10
    finally:
        if node is not None:
            node_net.stop_node_net([node])
        signer.stop()
    assert not node.signer_endpoint.is_running


def test_the_node_refuses_a_pin_on_a_unix_address(tmp_path):
    home = str(tmp_path / "node")
    _single_home(home, PrivKeyEd25519.generate(b"\x32" * 32))
    cfg = pconfig.test_config()
    cfg.base.priv_validator_laddr = f"unix://{tmp_path / 'pv.sock'}"
    cfg.base.priv_validator_signer_pubkey = PrivKeyEd25519.generate().pub_key().bytes().hex()
    with pytest.raises(ValueError, match="requires a tcp://"):
        node_net.make_single_node(home, config=cfg, device="cpu")
    assert node_mod._ROOT["nodes"] == 0


def test_a_node_no_signer_dials_tears_its_endpoint_down(tmp_path, monkeypatch):
    monkeypatch.setattr(rs, "ACCEPT_DEADLINE", 0.5)
    home = str(tmp_path / "node")
    _single_home(home, PrivKeyEd25519.generate(b"\x33" * 32))
    port = node_net.free_port()
    cfg = pconfig.test_config()
    cfg.base.priv_validator_laddr = f"tcp://127.0.0.1:{port}"
    with pytest.raises(RuntimeError, match="no remote signer dialed"):
        node_net.make_single_node(home, config=cfg, device="cpu")
    assert node_mod._ROOT["nodes"] == 0

    # the listener is closed: the port binds again once the accept loop's
    # pending accept (its ACCEPT_DEADLINE timeout) has returned
    def bindable():
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sk:
            sk.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                sk.bind(("127.0.0.1", port))
                return True
            except OSError:
                return False

    assert node_net.wait_for(bindable, 10.0, interval=0.05)
