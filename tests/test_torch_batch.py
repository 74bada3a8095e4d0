"""verify_generic's routing with a verifier that has no column form
(``verify_ed25519_raw``), such as the gated fakes of the reference's
fast-sync tests: the port must hand a homogeneous ed25519 batch to
``verify_ed25519`` as SigItems in one call, as the reference does, and give
the fake's verdicts, the same as the reference's ``verify_generic`` with
the same fake."""

import numpy as np
import pytest

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto.keys import PubKeyEd25519 as JPub
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.crypto.keys import PubKeyEd25519 as TPub

N = 12


class ItemsOnlyVerifier:
    """Has ``verify_ed25519`` and nothing else; verdicts from the oracle,
    every call recorded."""

    def __init__(self):
        self.calls = []

    def verify_ed25519(self, items):
        self.calls.append([(it.pubkey, it.msg, it.sig) for it in items])
        return np.array([ted._verify_pure(it.pubkey, it.msg, it.sig) for it in items], bool)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(17)
    pubs, msgs, sigs = [], [], []
    for i in range(N):
        priv = ted.gen_privkey(rng.bytes(32))
        msg = rng.bytes(int(rng.integers(0, 120)))
        sig = bytearray(ted.sign(priv, msg))
        if i % 3 == 1:
            sig[int(rng.integers(0, 64))] ^= 1 << int(rng.integers(0, 8))
        pubs.append(priv[32:])
        msgs.append(msg)
        sigs.append(bytes(sig))
    return pubs, msgs, sigs


def test_items_only_verifier_gets_one_sigitem_call(batch):
    pubs, msgs, sigs = batch
    fake = ItemsOnlyVerifier()
    got = tbatch.verify_generic([TPub(p) for p in pubs], msgs, sigs, verifier=fake)
    want = [ted._verify_pure(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    assert got.dtype == bool and got.tolist() == want
    assert 0 < sum(want) < N
    assert fake.calls == [list(zip(pubs, msgs, sigs))]


def test_items_only_verifier_matches_the_reference(batch):
    pubs, msgs, sigs = batch
    port_fake, ref_fake = ItemsOnlyVerifier(), ItemsOnlyVerifier()
    port = tbatch.verify_generic([TPub(p) for p in pubs], msgs, sigs, verifier=port_fake)
    ref = jbatch.verify_generic([JPub(p) for p in pubs], msgs, sigs, verifier=ref_fake)
    assert port.tolist() == np.asarray(ref, dtype=bool).tolist()
    assert port_fake.calls == ref_fake.calls


def test_column_form_is_still_preferred(batch):
    """A verifier with the column form gets the raw columns, not items."""
    pubs, msgs, sigs = batch

    class Both(ItemsOnlyVerifier):
        def verify_ed25519_raw(self, p, m, s):
            self.calls.append("raw")
            return np.ones((len(p),), bool)

    v = Both()
    assert tbatch.verify_generic([TPub(p) for p in pubs], msgs, sigs, verifier=v).all()
    assert v.calls == ["raw"]


# -- TM_BATCH_VERIFIER (the reference's tests/test_device_dispatch.py:322 and
#    tests/test_tpu_probe.py:86, restated) ------------------------------------


@pytest.fixture()
def fresh_default(monkeypatch):
    monkeypatch.delenv("TM_BATCH_VERIFIER", raising=False)
    with tbatch._lock:
        saved, tbatch._default = tbatch._default, None
    yield monkeypatch
    with tbatch._lock:
        tbatch._default = saved


def test_unset_means_the_guarded_card_verifier(fresh_default):
    from tendermint_tpu_torch.device import NoCudaDeviceError

    real = tbatch.TorchBatchVerifier
    fresh_default.setattr(tbatch, "TorchBatchVerifier", lambda: real("cpu"))
    v = tbatch.get_batch_verifier()
    assert isinstance(v, tbatch.GuardedBatchVerifier) and v.device.backend == "cpu"
    fresh_default.setattr(tbatch, "TorchBatchVerifier", real)
    with tbatch._lock:
        tbatch._default = None
    with pytest.raises(NoCudaDeviceError):  # no card here: nothing latches the host
        tbatch.get_batch_verifier()
    assert tbatch.verifier_info()["installed"] is False


@pytest.mark.parametrize("value", ["host", "HOST"])
def test_host_installs_the_host_verifier(fresh_default, value):
    """An operator who names the host verifier gets it, as from the
    reference; the first lazy verify_commit completes on it."""
    from tendermint_tpu_torch.testutil import commit as tc

    fresh_default.setenv("TM_BATCH_VERIFIER", value)
    sc = tc.build_commit(4, seed=3)
    assert sc.valset.verify_commit(sc.chain_id, sc.block_id, sc.height, sc.commit) is None
    picked = tbatch.get_batch_verifier()
    assert isinstance(picked, tbatch.HostBatchVerifier)
    assert tbatch.verifier_info()["name"] == "host"
    with jbatch._lock:
        saved = (jbatch._default, jbatch._latched_reason)
        jbatch._default = jbatch._latched_reason = None
    try:
        assert isinstance(jbatch.get_batch_verifier(), jbatch.HostBatchVerifier)
    finally:
        with jbatch._lock:
            jbatch._default, jbatch._latched_reason = saved


@pytest.mark.parametrize("value", ["xla", "pallas"])
def test_device_values_install_the_guarded_torch_verifier(fresh_default, value):
    real = tbatch.TorchBatchVerifier
    fresh_default.setattr(tbatch, "TorchBatchVerifier", lambda: real("cpu"))
    fresh_default.setenv("TM_BATCH_VERIFIER", value)
    v = tbatch.get_batch_verifier()
    assert isinstance(v, tbatch.GuardedBatchVerifier)
    assert isinstance(v.device, real) and tbatch.get_batch_verifier() is v
