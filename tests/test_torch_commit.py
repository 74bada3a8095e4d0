"""Commit verification through the port (ValidatorSet.verify_commit ->
TorchBatchVerifier on the CPU, i.e. the kernels' plain versions) against the
JAX package's verify_commit under its host verifier: same sign-bytes, same
signatures, same outcomes and the same CommitError texts."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import ed25519 as jed
from tendermint_tpu.crypto.keys import PubKeyEd25519 as JPub
from tendermint_tpu.types import validator_set as jvs
from tendermint_tpu.types.block import Commit as JCommit
from tendermint_tpu.types.core import BlockID as JBlockID
from tendermint_tpu.types.core import PartSetHeader as JPSH
from tendermint_tpu.types.core import SignedMsgType as JType
from tendermint_tpu.types.vote import Vote as JVote
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.device import NoCudaDeviceError
from tendermint_tpu_torch.testutil import commit as tc
from tendermint_tpu_torch.types.block import Commit as TCommit
from tendermint_tpu_torch.types.core import BlockID, PartSetHeader, SignedMsgType
from tendermint_tpu_torch.types.vote import Vote


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One core for the plain versions: the suite runs timing-sensitive node
    tests in parallel workers beside this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 64


def test_sign_bytes_equal_jax():
    rng = np.random.default_rng(8)
    for _ in range(6):
        h, r, ts = (int(rng.integers(0, 2**40)), int(rng.integers(0, 5)),
                    int(rng.integers(-2**62, 2**62)))
        bh, ph = rng.bytes(32), rng.bytes(32)
        chain = "chain-%d" % int(rng.integers(0, 1000))
        for t in (SignedMsgType.PREVOTE, SignedMsgType.PRECOMMIT):
            tv = Vote(t, h, r, ts, BlockID(bh, PartSetHeader(3, ph)), b"a" * 20, 1)
            jv = JVote(JType(int(t)), h, r, ts, JBlockID(bh, JPSH(3, ph)), b"a" * 20, 1)
            assert tv.sign_bytes(chain) == jv.sign_bytes(chain)
    nil = Vote(SignedMsgType.PRECOMMIT, 1, 0, 0, BlockID(), b"a" * 20, 0)
    jnil = JVote(JType.PRECOMMIT, 1, 0, 0, JBlockID(), b"a" * 20, 0)
    assert nil.sign_bytes("c") == jnil.sign_bytes("c")


def _to_jax(sc: tc.SignedCommit, commit: TCommit):
    """The same validator set and commit as JAX package objects."""
    vals = [jvs.Validator(JPub(v.pub_key.bytes()), v.voting_power)
            for v in sc.valset.validators]
    valset = jvs.ValidatorSet(vals)
    conv = lambda b: JBlockID(b.hash, JPSH(b.parts_header.total, b.parts_header.hash))
    pcs = [None if pc is None else JVote(
        JType(int(pc.vote_type)), pc.height, pc.round, pc.timestamp_ns,
        conv(pc.block_id), pc.validator_address, pc.validator_index, pc.signature)
        for pc in commit.precommits]
    return valset, conv(sc.block_id), JCommit(conv(commit.block_id), pcs)


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # the outcome under comparison, error or not
        return type(e).__name__, str(e)
    return "ok", ""


@pytest.fixture(scope="module")
def signed():
    return tc.build_commit(N, seed=7)


@pytest.fixture(scope="module")
def verifier():
    return tbatch.TorchBatchVerifier(device="cpu")


def _both(sc, commit, verifier):
    port = _outcome(lambda: sc.valset.verify_commit(
        sc.chain_id, sc.block_id, sc.height, commit, verifier=verifier))
    jvalset, jbid, jcommit = _to_jax(sc, commit)
    ref = _outcome(lambda: jvalset.verify_commit(
        sc.chain_id, jbid, sc.height, jcommit, verifier=jbatch.HostBatchVerifier()))
    return port, ref


def test_commit_built_like_the_jax_package(signed):
    """Deterministic signatures: the JAX package signs the same bytes."""
    jvalset, _, jcommit = _to_jax(signed, signed.commit)
    assert [v.address for v in jvalset.validators] == \
        [v.address for v in signed.valset.validators]
    for priv, pc in zip(signed.privs, jcommit.precommits):
        assert jed.sign(priv, pc.sign_bytes(signed.chain_id)) == pc.signature


def _flipped(sc):
    return tc.flip_signature_bit(sc.commit, 5, bit=300)


def _under_quorum(sc):
    return tc.drop_precommits(sc.commit, (2 * N) // 3)


def _stray(sc):
    return tc.stray_vote(sc, 9)


def _stray_flipped(sc):
    return tc.flip_signature_bit(tc.stray_vote(sc, 9), 9, bit=7)


def _strays_under_quorum(sc):
    commit = sc.commit
    for i in range(N // 3 + 1):
        commit = TCommit(commit.block_id, tc.stray_vote(
            replace(sc, commit=commit), i).precommits)
    return commit


CASES = {
    "valid": (lambda sc: sc.commit, "ok", ""),
    "flipped_signature": (_flipped, "CommitError", "invalid signature in commit"),
    "insufficient_power": (_under_quorum, "CommitError", "insufficient voting power"),
    "stray_block_id_vote": (_stray, "ok", ""),
    "stray_vote_bad_signature": (_stray_flipped, "CommitError", "invalid signature"),
    "stray_votes_below_quorum": (_strays_under_quorum, "CommitError",
                                 "insufficient voting power"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_verify_commit_matches_jax(signed, verifier, case):
    make, kind, prefix = CASES[case]
    port, ref = _both(signed, make(signed), verifier)
    assert port == ref
    assert port[0] == kind and port[1].startswith(prefix)


def test_structural_errors_match_jax(signed, verifier):
    short = TCommit(signed.block_id, signed.commit.precommits[:-1])
    port = _outcome(lambda: signed.valset.verify_commit(
        signed.chain_id, signed.block_id, signed.height, short, verifier=verifier))
    jvalset, jbid, _ = _to_jax(signed, signed.commit)
    _, _, jshort = _to_jax(signed, short)
    ref = _outcome(lambda: jvalset.verify_commit(
        signed.chain_id, jbid, signed.height, jshort,
        verifier=jbatch.HostBatchVerifier()))
    assert port == ref == ("CommitError", f"wrong set size: {N} vs {N - 1}")
    wrong_h = _outcome(lambda: signed.valset.verify_commit(
        signed.chain_id, signed.block_id, signed.height + 1, signed.commit,
        verifier=verifier))
    assert wrong_h == ("CommitError", f"wrong height: {signed.height + 1} vs {signed.height}")


def test_dispatch_stats(signed):
    """One verify_commit on a fresh verifier, so the counters do not depend
    on which tests ran before in this process."""
    verifier = tbatch.TorchBatchVerifier(device="cpu")
    signed.valset.verify_commit(signed.chain_id, signed.block_id, signed.height,
                                signed.commit, verifier=verifier)
    assert verifier.stats["ed25519"].dispatches >= 1
    assert verifier.stats["ed25519"].signatures >= N
    assert verifier.stats["secp256k1"].dispatches == 0
    assert verifier.backend == "cpu" and verifier.fe_backend == "vpu"


def test_no_device_and_no_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves")
    with pytest.raises(NoCudaDeviceError):
        tbatch.TorchBatchVerifier()
    with pytest.raises(NoCudaDeviceError):
        tbatch.TorchBatchVerifier(device="cuda")


def test_options_are_validated_and_recorded():
    v = tbatch.TorchBatchVerifier(device="cpu", fe_backend="MXU", carry_mode="eager")
    assert (v.fe_backend, v.carry_mode, v.ed25519_path) == ("mxu", "eager", "ladder")
    for kw in ({"fe_backend": "gpu"}, {"carry_mode": "late"}, {"ed25519_path": "x"}):
        with pytest.raises(ValueError):
            tbatch.TorchBatchVerifier(device="cpu", **kw)


def test_unported_paths_raise():
    # the MSM path is ported (ROADMAP item 6): the knob is accepted and
    # recorded, and a bad value still raises
    assert tbatch.TorchBatchVerifier(device="cpu", ed25519_path="msm").ed25519_path == "msm"
    with pytest.raises(ValueError):
        tbatch.TorchBatchVerifier(device="cpu", ed25519_path="pippenger")
    # multisig routing is ported (ROADMAP item 9): a key of no batchable
    # type is decided by its own verify_bytes, as in the reference
    class OddKey:
        def verify_bytes(self, msg, sig):
            return msg == b"yes"

    v = tbatch.TorchBatchVerifier(device="cpu")
    got = tbatch.verify_generic([OddKey(), OddKey()], [b"yes", b"no"], [b"\0" * 64] * 2,
                                verifier=v)
    assert got.tolist() == [True, False]


def test_default_verifier_seam():
    v = tbatch.TorchBatchVerifier(device="cpu")
    tbatch.set_batch_verifier(v)
    try:
        assert tbatch.get_batch_verifier() is v
    finally:
        tbatch.set_batch_verifier(None)
