"""The port's operator smokes on the CPU (``--device cpu``, the host
verifier, as the reference's CPU runs verify): ``tools/statesync_smoke``,
``flight_smoke`` and ``critpath_smoke`` each exit 0 within a stated
deadline, put back the verifier they found installed and write nothing
into the repository's root. Without a card every tool of the slice
(``metrics_lint``, the smokes, ``soak_report``, ``bench_commit_path``)
refuses to start unless given ``--device cpu``: in process it raises
``NoCudaDeviceError``, as a command it exits non-zero naming it.
``tests/test_torch_smokes_sim.py`` holds the sim-net smokes.
"""

import glob
import importlib
import os
import subprocess
import sys
import time

import pytest
import torch

from tendermint_tpu_torch.crypto import batch as p_batch
from tendermint_tpu_torch.device import NoCudaDeviceError
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.parallel import planner
from tendermint_tpu_torch.tools import critpath_smoke, flight_smoke, statesync_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOOLS = ("metrics_lint", "statesync_smoke", "flight_smoke", "critpath_smoke", "quorum_smoke",
         "soak_report", "soak_smoke", "bench_commit_path")
# what the reference's counterparts write into their checkout's root
ROOT_OUTPUTS = ("QUORUM_r*.json", "SOAK_r*.json", "CRITPATH_r*.json", "merged_trace.json",
                "soak_report.json", "quorum_report.json")


def root_outputs() -> set:
    return {p for pat in ROOT_OUTPUTS for p in glob.glob(os.path.join(REPO, pat))}


@pytest.fixture(autouse=True)
def _installed_verifier():
    """A verifier installed before each smoke, which it must put back."""
    verifier = p_batch.HostBatchVerifier()
    p_batch.set_batch_verifier(verifier)
    yield verifier
    verify_root.reset_verify()


def run_smoke(module, argv, deadline_s: float, installed) -> dict:
    before = root_outputs()
    executor = planner._device_executor
    t0 = time.monotonic()
    out = module.run(argv)
    took = time.monotonic() - t0
    assert out["ok"], out["failures"]
    assert took < deadline_s, f"{module.__name__} took {took:.1f} s (deadline {deadline_s} s)"
    assert p_batch.installed_batch_verifier() is installed
    assert planner._device_executor is executor
    assert root_outputs() == before
    return out


def test_statesync_smoke(_installed_verifier):
    out = run_smoke(statesync_smoke, ["--device", "cpu"], 120.0, _installed_verifier)
    assert (out["snapshot"], out["heights"]) == (12, 13)
    assert out["chunks"] >= 2
    assert out["launches"] == {"ed25519_prologue": 0, "ed25519_ladder": 0}  # the host


def test_statesync_smoke_twice_reads_its_own_series(_installed_verifier):
    """The process-wide StateSyncMetrics already holds a restore's series:
    a second run checks its own growth, not the totals."""
    run_smoke(statesync_smoke, ["--device", "cpu"], 120.0, _installed_verifier)
    assert statesync_smoke.main(["--device", "cpu"]) == 0


def test_flight_smoke(_installed_verifier, tmp_path):
    trace = tmp_path / "merged.json"
    out = run_smoke(flight_smoke, ["--device", "cpu", "--trace-out", str(trace)], 120.0,
                    _installed_verifier)
    assert out["stall_s"] < flight_smoke.STALL_BUDGET_S
    assert out["heights"] > flight_smoke.TARGET_HEIGHT
    assert trace.stat().st_size > 0 and out["events"] > 0


def test_critpath_smoke(_installed_verifier):
    out = run_smoke(critpath_smoke, ["--device", "cpu"], 120.0, _installed_verifier)
    assert out["heights"] >= critpath_smoke.TARGET_HEIGHT
    assert out["waterfalls"] >= flight_smoke.N_VALS * (critpath_smoke.TARGET_HEIGHT - 1)


@pytest.mark.parametrize("name", TOOLS)
def test_without_a_card_raises_no_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    module = importlib.import_module(f"tendermint_tpu_torch.tools.{name}")
    with pytest.raises(NoCudaDeviceError):
        module.main([])


def test_without_a_card_the_commands_exit_non_zero():
    """Every tool as an operator starts it: exit code not 0
    and ``NoCudaDeviceError`` on stderr."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for batch in (TOOLS[:4], TOOLS[4:]):  # four interpreters at a time
        procs = {name: subprocess.Popen(
            [sys.executable, "-m", f"tendermint_tpu_torch.tools.{name}"], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for name in batch}
        for name, proc in procs.items():
            _, err = proc.communicate(timeout=120)
            assert proc.returncode != 0, name
            assert "NoCudaDeviceError" in err, (name, err[-2000:])
