"""The port's multisig (crypto/multisig.py) and its routing in
``crypto/batch.verify_generic`` against the reference's: the same keys,
messages and marshalled aggregates through both packages, the reference on
its ``HostBatchVerifier``, the port on ``TorchBatchVerifier("cpu")`` (the
plain versions of K1 and K2). Verdicts must be equal, exactly, including
the reference's divergence from Go that the port copies. Restates the
multisig cases of the reference's ``TestMultisig``, ``TestPlannerMixedKeys``
and the ``verify_generic`` half of ``test_secp_and_multisig_ride_host_lanes``."""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto.keys import PubKeyEd25519 as JEd
from tendermint_tpu.crypto.keys import PubKeySecp256k1 as JSecp
from tendermint_tpu.crypto.multisig import PubKeyMultisigThreshold as JMpk
from tendermint_tpu.parallel import planner as jplanner
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.crypto import secp256k1 as tsecp
from tendermint_tpu_torch.crypto.keys import PubKeyEd25519 as TEd
from tendermint_tpu_torch.crypto.keys import PubKeySecp256k1 as TSecp
from tendermint_tpu_torch.crypto.multisig import (
    CompactBitArray,
    Multisignature,
    PubKeyMultisigThreshold,
)
from tendermint_tpu_torch.frontend.aggregator import BatchingVerifier
from tendermint_tpu_torch.libs import breaker as brk
from tendermint_tpu_torch.libs.metrics import get_verify_metrics
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.testutil import commit as tc
from tendermint_tpu_torch.testutil import multisig as tm
from tendermint_tpu_torch.testutil import secp_signer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    brk.configure_device_guard(dispatch_deadline=0)
    planner.set_device_executor(planner.device_executor("cpu"))
    tbatch.set_batch_verifier(tbatch.TorchBatchVerifier("cpu"))
    yield
    planner.set_device_executor(None)
    tbatch.set_batch_verifier(None)
    brk.reset_device_guard()


class Keys:
    """n ed25519 keys from fixed seeds, as the port's and the reference's
    key objects over the same bytes."""

    def __init__(self, n, base=1):
        self.privs = [ted.gen_privkey(bytes([base + i]) * 32) for i in range(n)]
        self.pubs = [TEd(p[32:]) for p in self.privs]
        self.jpubs = [JEd(p[32:]) for p in self.privs]

    def threshold(self, k):
        return PubKeyMultisigThreshold(k, tuple(self.pubs)), JMpk(k, tuple(self.jpubs))

    def aggregate(self, msg, signers, bad=()):
        ms = Multisignature.new(len(self.pubs))
        for i in signers:
            sig = ted.sign(self.privs[i], b"other" if i in bad else msg)
            ms.add_signature_from_pubkey(sig, self.pubs[i], self.pubs)
        return ms.marshal()


def _counter(reason):
    return get_verify_metrics().host_fallback._values.get((reason,), 0.0)


class CountingVerifier:
    """TorchBatchVerifier("cpu") that counts its ed25519 calls and rows."""

    def __init__(self):
        self._v = tbatch.TorchBatchVerifier("cpu")
        self.calls = []

    def verify_ed25519(self, items):
        self.calls.append(len(items))
        return self._v.verify_ed25519(items)

    def verify_secp256k1(self, items):
        return self._v.verify_secp256k1(items)


# -- tests/test_crypto.py::TestMultisig --------------------------------------


def test_threshold_verify():
    keys = Keys(5)
    mpk, jmpk = keys.threshold(3)
    msg = b"multisig message"
    cases = [keys.aggregate(msg, (0, 2, 4)), keys.aggregate(msg, (1, 3)),
             keys.aggregate(msg, (0, 2, 4), bad=(2,))]
    got = [mpk.verify_bytes(msg, c) for c in cases]
    assert got == [jmpk.verify_bytes(msg, c) for c in cases] == [True, False, False]
    assert mpk.bytes() == jmpk.bytes() and mpk.address() == jmpk.address()


def test_flatten_for_batch():
    keys = Keys(4)
    mpk, jmpk = keys.threshold(2)
    blob = keys.aggregate(b"zz", (1, 3))
    flat = mpk.flatten(b"zz", blob)
    assert flat == jmpk.flatten(b"zz", blob) and len(flat) == 2
    assert all(ted._verify_pure(pk, m, s) for pk, m, s in flat)


def test_batched_aggregate_matches_host():
    """Aggregates flatten into the ed25519 call, interleaved with a plain
    ed25519 key so positions shift; verdicts equal per-aggregate
    verify_bytes and the reference's verify_generic."""
    keys = Keys(5)
    mpk, jmpk = keys.threshold(3)
    msg = b"batch multisig"
    good, below = keys.aggregate(msg, (0, 2, 4)), keys.aggregate(msg, (1, 3))
    bad = keys.aggregate(msg, (0, 2, 4), bad=(2,))
    plain_sig = ted.sign(keys.privs[0], b"plain")
    msgs, sigs = [msg, b"plain", msg, msg], [good, plain_sig, below, bad]
    before = _counter("multisig_structural")
    v = CountingVerifier()
    got = tbatch.verify_generic([mpk, keys.pubs[0], mpk, mpk], msgs, sigs, verifier=v)
    want = jbatch.verify_generic([jmpk, keys.jpubs[0], jmpk, jmpk], msgs, sigs,
                                 verifier=jbatch.HostBatchVerifier())
    assert list(got) == list(want) == [True, True, False, False]
    assert v.calls == [1 + 3 + 3]  # one call: the plain row, good's and bad's spans
    assert _counter("multisig_structural") == before + 1  # below: 2 of k = 3


def test_short_sub_signature_rejected_not_crashing():
    keys = Keys(3)
    mpk, jmpk = keys.threshold(2)
    ms = Multisignature.new(3)
    ms.add_signature_from_pubkey(ted.sign(keys.privs[0], b"m"), keys.pubs[0], keys.pubs)
    ms.add_signature_from_pubkey(b"\x01" * 32, keys.pubs[1], keys.pubs)
    blob = ms.marshal()
    assert mpk.flatten(b"m", blob) is None and jmpk.flatten(b"m", blob) is None
    assert mpk.verify_bytes(b"m", blob) is False
    plain_sig = ted.sign(keys.privs[2], b"p")
    got = tbatch.verify_generic([mpk, keys.pubs[2]], [b"m", b"p"], [blob, plain_sig],
                                verifier=tbatch.TorchBatchVerifier("cpu"))
    assert list(got) == [False, True]


def test_flagged_count_sig_count_mismatch_rejected():
    keys = Keys(3)
    mpk, jmpk = keys.threshold(2)
    blob = bytearray(keys.aggregate(b"m", (0, 1)))
    blob[4] |= 1 << 5  # flag a third signer without a third signature
    blob = bytes(blob)
    assert Multisignature.unmarshal(blob).bitarray.count() == 3
    assert mpk.verify_bytes(b"m", blob) is jmpk.verify_bytes(b"m", blob) is False
    assert mpk.flatten(b"m", blob) is jmpk.flatten(b"m", blob) is None


def test_more_signatures_than_sub_keys_accepted_as_the_reference_does():
    """The divergence from Go that the reference carries (ADVICE.md): size
    3, k 2, five signatures, two bits set. Go's VerifyBytes rejects
    len(sigs) > size; the reference accepts it, and so does the port."""
    keys = Keys(3)
    mpk, jmpk = keys.threshold(2)
    ms = Multisignature.unmarshal(keys.aggregate(b"m", (0, 2)))
    ms.sigs += [b"\x00" * 64] * 3
    blob = ms.marshal()
    assert len(Multisignature.unmarshal(blob).sigs) == 5 > len(keys.pubs)
    assert mpk.verify_bytes(b"m", blob) is jmpk.verify_bytes(b"m", blob) is True
    assert mpk.flatten(b"m", blob) == jmpk.flatten(b"m", blob)
    assert len(mpk.flatten(b"m", blob)) == 2
    got = tbatch.verify_generic([mpk], [b"m"], [blob], verifier=tbatch.TorchBatchVerifier("cpu"))
    assert got.tolist() == jbatch.verify_generic(
        [jmpk], [b"m"], [blob], verifier=jbatch.HostBatchVerifier()).tolist() == [True]


def test_compact_bit_array_round_trip():
    ba = CompactBitArray(11)
    for i in (0, 3, 10):
        assert ba.set_index(i, True)
    assert not ba.set_index(11, True) and not ba.get_index(-1)
    assert ba.count() == 3 and ba.num_true_bits_before(4) == 2
    assert CompactBitArray.from_bytes(ba.to_bytes()) == ba
    ba.set_index(3, False)
    assert ba.count() == 2
    with pytest.raises(ValueError):
        CompactBitArray(-1)


# -- tests/test_planner.py::TestPlannerMixedKeys -----------------------------


def _mixed_window():
    """h0 ed25519 only, h1 secp256k1 only, h2 one of each and a 2-of-3
    multisig; the port's and the reference's key objects."""
    ed = Keys(3, base=1)
    ms = Keys(3, base=33)
    mpk, jmpk = ms.threshold(2)
    sk_privs = [tsecp.gen_privkey(bytes([i + 9]) * 32) for i in range(2)]
    sk_raw = [secp_signer.pubkey_compressed(p) for p in sk_privs]
    msgs = [b"mixed-%d" % h for h in range(3)]
    rows = [
        [(ed.pubs[i], ed.jpubs[i], msgs[0], ted.sign(ed.privs[i], msgs[0])) for i in range(3)],
        [(TSecp(sk_raw[i]), JSecp(sk_raw[i]), msgs[1], tc.sign(sk_privs[i], msgs[1]))
         for i in range(2)],
        [(ed.pubs[0], ed.jpubs[0], msgs[2], ted.sign(ed.privs[0], msgs[2])),
         (TSecp(sk_raw[0]), JSecp(sk_raw[0]), msgs[2], tc.sign(sk_privs[0], msgs[2])),
         (mpk, jmpk, msgs[2], ms.aggregate(msgs[2], (0, 2)))],
    ]
    tvotes = [[(t, m, s) for t, _, m, s in row] for row in rows]
    jvotes = [[(j, m, s) for _, j, m, s in row] for row in rows]
    return tvotes, jvotes, [[1] * 3, [1] * 2, [1] * 3], [3, 2, 3]


def _assert_equal(got, want):
    for k in ("ok", "tally", "committed", "sigs_ok"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k


@pytest.mark.parametrize("use_device", [None, True])
def test_valid_mixed_window_commits(use_device):
    """Every valid mixed-key vote verifies; asking for the device route
    with non-ed25519 keys still verifies them on the verifier route."""
    tvotes, jvotes, powers, totals = _mixed_window()
    got = planner.verify_window(tvotes, powers, totals, use_device=use_device)
    _assert_equal(got, jplanner.verify_window(jvotes, powers, totals, use_device=False))
    for h, row in enumerate(tvotes):
        assert got.ok[h, : len(row)].all()
    assert got.committed.tolist() == [True, True, True]
    assert got.tally.tolist() == [3, 2, 3] and got.lanes_dispatched == 0


def test_forged_votes_fail_their_commit_only():
    tvotes, jvotes, powers, totals = _mixed_window()
    for votes in (tvotes, jvotes):
        pub, msg, sig = votes[1][1]
        votes[1][1] = (pub, msg, sig[:-1] + bytes([sig[-1] ^ 1]))
        pub, msg, sig = votes[2][2]
        ms = Multisignature.unmarshal(sig)
        ms.sigs[1] = ms.sigs[0]
        votes[2][2] = (pub, msg, ms.marshal())
    got = planner.verify_window(tvotes, powers, totals)
    _assert_equal(got, jplanner.verify_window(jvotes, powers, totals, use_device=False))
    assert got.sigs_ok.tolist() == [True, False, False]
    assert not got.ok[1, 1] and not got.ok[2, 2] and got.ok[2, :2].all()


# -- tests/test_vote_batch.py::test_secp_and_multisig_ride_host_lanes ---------


def test_secp_and_multisig_in_one_verify_generic():
    """Four ed25519 keys, a secp256k1 key, a good and a bad 2-of-3
    multisig in one verify_generic: one ed25519 call holds the plain rows
    and both aggregates' spans, one secp256k1 call the rest; verdicts equal
    the reference's on its host verifier."""
    ed = Keys(4, base=1)
    ms = Keys(3, base=0x40)
    mpk, jmpk = ms.threshold(2)
    sk = tsecp.gen_privkey(b"\x77" * 32)
    sk_raw = secp_signer.pubkey_compressed(sk)
    msg = b"vote sign bytes"
    tpubs = ed.pubs + [TSecp(sk_raw), mpk, mpk]
    jpubs = ed.jpubs + [JSecp(sk_raw), jmpk, jmpk]
    msgs = [msg] * 7
    sigs = ([ted.sign(p, msg) for p in ed.privs] + [tc.sign(sk, msg)]
            + [ms.aggregate(msg, (0, 2)), ms.aggregate(msg, (0, 2), bad=(2,))])
    v = CountingVerifier()
    got = tbatch.verify_generic(tpubs, msgs, sigs, verifier=v)
    want = jbatch.verify_generic(jpubs, msgs, sigs, verifier=jbatch.HostBatchVerifier())
    assert got.tolist() == want.tolist() == [True] * 6 + [False]
    assert v.calls == [4 + 2 + 2]


def test_unbatchable_ed25519_signature_goes_to_verify_bytes():
    ed = Keys(2)
    sigs = [ted.sign(ed.privs[0], b"a"), ted.sign(ed.privs[1], b"b")[:63]]
    mpk, _ = Keys(2, base=90).threshold(1)
    before = _counter("unbatchable_key")
    got = tbatch.verify_generic([ed.pubs[0], ed.pubs[1]], [b"a", b"b"], sigs,
                                verifier=tbatch.TorchBatchVerifier("cpu"))
    assert got.tolist() == [True, False] and _counter("unbatchable_key") == before + 1
    assert mpk.verify_bytes(b"x", b"") is False  # unmarshal of nothing


# -- the configuration, and the guarded and batching verifiers --------------


def test_multisig_set_equals_the_bench_construction():
    """testutil/multisig.build is scripts/bench_multisig.py's configuration
    byte for byte (checked here on its first 3 validators)."""
    from tendermint_tpu.crypto import ed25519 as jed
    from tendermint_tpu.crypto.multisig import Multisignature as JMs

    got = tm.build(3)
    rng = np.random.default_rng(tm.SEED)
    for v in range(3):
        privs = [jed.gen_privkey(rng.bytes(32)) for _ in range(tm.N_KEYS)]
        subkeys = tuple(JEd(p[32:]) for p in privs)
        msg = b"multisig-bench|%08d|" % v + rng.bytes(tm.MSG_TAIL)
        ms = JMs.new(tm.N_KEYS)
        for j in range(tm.K):
            ms.add_signature_from_pubkey(jed.sign(privs[j], msg), subkeys[j], subkeys)
        assert got.pubkeys[v].bytes() == JMpk(tm.K, subkeys).bytes()
        assert (got.msgs[v], got.sigs[v]) == (msg, ms.marshal())


@pytest.mark.parametrize("guarded", [False, True])
def test_configuration_rows_reject_exactly_the_planted_faults(guarded):
    """The 3-of-5 set at 8 validators through verify_generic, plain and
    guarded (off the card): all accept in one ed25519 call of 24 rows;
    with one flipped sub-signature and one aggregate below its threshold,
    exactly those two reject and multisig_structural counts one."""
    s = tm.build(8)
    v = CountingVerifier()
    verifier = tbatch.GuardedBatchVerifier(v, deadline=0, audit_rate=1.0) if guarded else v
    assert tbatch.verify_generic(s.pubkeys, s.msgs, s.sigs, verifier=verifier).all()
    assert v.calls == [8 * tm.K]
    sigs = list(s.sigs)
    sigs[2] = tm.flip_sub_signature(sigs[2], 1)
    sigs[5] = tm.below_threshold(sigs[5])
    before = _counter("multisig_structural")
    got = tbatch.verify_generic(s.pubkeys, s.msgs, sigs, verifier=verifier)
    assert np.flatnonzero(~got).tolist() == [2, 5]
    assert _counter("multisig_structural") == before + 1
    assert v.calls == [8 * tm.K, 7 * tm.K]
    jkeys = [JMpk(pk.k, tuple(JEd(p.bytes()) for p in pk.pubkeys)) for pk in s.pubkeys]
    assert got.tolist() == jbatch.verify_generic(
        jkeys, s.msgs, sigs, verifier=jbatch.HostBatchVerifier()).tolist()
    if guarded:
        assert verifier.snapshot()["audit_mismatches"] == 0


def test_multisig_through_the_batching_verifier():
    """Through a BatchingVerifier the flattened sub-signatures are one feed
    row."""
    s = tm.build(4)
    feed = planner.LaneFeed(window_s=0.0)
    try:
        got = tbatch.verify_generic(s.pubkeys, s.msgs,
                                    [s.sigs[0], tm.flip_sub_signature(s.sigs[1])] + s.sigs[2:],
                                    verifier=BatchingVerifier(feed, result_timeout=60.0))
    finally:
        feed.close()
    assert got.tolist() == [True, False, True, True]
    assert (feed.rows_in, feed.lanes_in) == (1, 4 * tm.K)
