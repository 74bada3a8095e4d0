"""The configuration root (tendermint_tpu_torch/node/verify_root.py) and the
slice as a whole on the CPU: the ``[verify]`` knobs flow into the guard, the
verifier and the planner; a bad ``ed25519_path`` raises; with no CUDA a
root without a device raises; and a seeded signed window
(testutil/window.py) with planted faults gives, on both routes of the
installed path, the verdict its construction implies and the reference
planner's verdict on the same votes."""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.parallel import planner as jplanner
from tendermint_tpu_torch.config.verify import VerifyConfig
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.device import NoCudaDeviceError
from tendermint_tpu_torch.libs import breaker as brk
from tendermint_tpu_torch.libs.metrics import get_verify_metrics
from tendermint_tpu_torch.node.verify_root import configure_verify, reset_verify
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.testutil import window as tw


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run on tensors of a few hundred elements, where
    torch's thread pool buys nothing; one thread keeps this file from
    crowding the CPU that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset():
    reset_verify()
    yield
    reset_verify()


def test_defaults_equal_the_reference_section():
    from tendermint_tpu.config.config import VerifyConfig as JVerifyConfig

    assert VerifyConfig().__dict__ == JVerifyConfig().__dict__


def test_knobs_flow_through():
    cfg = VerifyConfig(breaker_threshold=5, breaker_backoff=0.5, breaker_backoff_max=9.0,
                       dispatch_deadline=7.5, audit_sample_rate=0.25, audit_seed=3,
                       retries=2, fe_backend="mxu16", pipeline_depth=3,
                       windows_per_device=6, planner_reduce="host")
    root = configure_verify(cfg, device="cpu")
    assert brk.guard_config().as_dict() == {
        "breaker_threshold": 5, "breaker_backoff": 0.5, "breaker_backoff_max": 9.0,
        "dispatch_deadline": 7.5, "audit_sample_rate": 0.25, "audit_seed": 3, "retries": 2}
    br = brk.get_device_breaker()
    assert (br.threshold, br.backoff_base, br.backoff_max) == (5, 0.5, 9.0)
    g = root.verifier
    assert g.breaker is br
    assert (g.deadline, g.retries, g.audit_rate, g.audit_seed) == (7.5, 2, 0.25, 3)
    dev = g.device
    assert (dev.backend, dev.fe_backend, dev.carry_mode, dev.ed25519_path) == (
        "cpu", "mxu16", "eager", "ladder")
    assert root.executor.device == torch.device("cpu")
    assert planner.reduce_mode() == "host"
    assert tbatch.get_batch_verifier() is g
    assert planner._device_executor is root.executor
    assert root.build_seconds == {}
    reset_verify()
    assert brk.guard_config() == brk.GuardConfig()
    assert planner.reduce_mode() == "device" and planner._device_executor is None


def test_msm_and_bad_knobs_raise_before_anything_is_installed():
    # "msm" is ported (ROADMAP item 6) and accepted; a bad knob, the path's
    # included, raises before anything is installed
    for cfg in (VerifyConfig(fe_backend="gpu"), VerifyConfig(planner_reduce="both"),
                VerifyConfig(ed25519_path="pippenger")):
        with pytest.raises(ValueError):
            configure_verify(cfg, device="cpu")
    assert planner._device_executor is None
    assert tbatch.verifier_info()["installed"] is False


def test_no_device_means_cuda():
    if torch.cuda.is_available():
        assert configure_verify().device.type == "cuda"
    else:
        with pytest.raises(NoCudaDeviceError):
            configure_verify()
        assert planner._device_executor is None


@pytest.fixture(scope="module")
def faulty_window():
    win = tw.build_window(10, 4, seed=5)
    tw.flip_bit(win, 1, 2)
    tw.drop_precommits(win, 3, 1)  # 30 of 40: commits
    tw.drop_precommits(win, 5, 2)  # 20 of 40: does not
    tw.short_signature(win, 7, 3)
    tw.absent_height(win, 8)
    return win


def test_window_construction(faulty_window):
    win = faulty_window
    votes, powers, totals = win.rows()
    want = tw.expected(win)
    assert (win.H, win.V, totals) == (10, 4, [40] * 10)
    assert want["tally"].tolist() == [40, 30, 40, 30, 40, 20, 40, 30, 0, 40]
    assert want["committed"].tolist() == [True] * 5 + [False, True, True, False, True]
    assert want["sigs_ok"].tolist() == [True, False] + [True] * 5 + [False, True, True]
    assert votes[8] == [None] * 4 and powers[8] == [0] * 4
    assert len(votes[7][3][2]) == 63
    block_ids = {bytes(b.hash) for b in win.block_ids}
    assert len(block_ids) == 10  # every height its own block id
    msgs = {votes[h][0][1] for h in range(8)}
    assert len(msgs) == 8  # every height its own sign-bytes


@pytest.mark.parametrize("use_device", [True, False])
def test_window_through_the_installed_path(faulty_window, use_device):
    # unsupervised: the plain versions on a loaded CPU can outlast 30 s
    root = configure_verify(VerifyConfig(audit_sample_rate=1.0, dispatch_deadline=0),
                            device="cpu")
    votes, powers, totals = faulty_window.rows()
    fallbacks0 = sum(get_verify_metrics().device_fallback._values.values())
    got = planner.verify_window(votes, powers, totals, use_device=use_device)
    want = tw.expected(faulty_window)
    for k in ("ok", "tally", "committed", "sigs_ok"):
        assert np.array_equal(getattr(got, k), want[k]), k
    raw = [[None if t is None else (t[0].bytes(), t[1], t[2]) for t in row] for row in votes]
    ref = jplanner.verify_window(raw, powers, totals, verifier=jbatch.HostBatchVerifier(),
                                 use_device=False)
    for k in ("ok", "tally", "committed", "sigs_ok"):
        assert np.array_equal(getattr(got, k), getattr(ref, k)), k
    assert sum(get_verify_metrics().device_fallback._values.values()) == fallbacks0
    assert brk.get_device_breaker().state == brk.CLOSED
    if not use_device:
        assert root.verifier.snapshot()["dispatches"] == 1
