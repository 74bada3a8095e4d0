"""The port's sim-net smokes on the CPU (``--device cpu``, the host
verifier): ``tools/quorum_smoke``, ``soak_smoke`` at 42 heights and
``bench_commit_path`` each exit 0 within a stated deadline, put back the
verifier they found installed, write their round files only under the
``--round-dir`` they are given (where ``scripts/bench_check.py --prefix
... --dir`` reads them) and nothing into the repository's root.
``bench_commit_path``'s pooling and phase table equal the reference's
``_pool`` and ``_phase_table`` on the same waterfall dumps; ``soak_smoke``
keeps the reference's marks at 210 heights and their proportions below.
"""

import importlib.util
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from tendermint_tpu_torch.libs.critpath import PHASES
from tendermint_tpu_torch.tools import bench_commit_path, quorum_smoke, soak_smoke
from tendermint_tpu_torch.tools.smoke_verify import write_round

from test_torch_smokes import REPO, _installed_verifier, run_smoke  # noqa: F401 (fixture)


def _load_reference_bench():
    path = os.path.join(REPO, "scripts", "bench_commit_path.py")
    spec = importlib.util.spec_from_file_location("ref_bench_commit_path", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_BENCH = _load_reference_bench()


def bench_check(prefix: str, round_dir) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "bench_check.py"), "--prefix", prefix,
         "--dir", str(round_dir)], capture_output=True, text=True, timeout=120)


def read_round(round_dir, name: str) -> dict:
    with open(os.path.join(round_dir, name)) as f:
        return json.load(f)


def test_quorum_smoke(_installed_verifier, tmp_path):
    out = run_smoke(quorum_smoke, ["--device", "cpu", "--round-dir", str(tmp_path)], 150.0,
                    _installed_verifier)
    assert out["heights"] >= quorum_smoke.TARGET_HEIGHT
    assert os.listdir(tmp_path) == ["QUORUM_r01.json"]
    parsed = read_round(tmp_path, "QUORUM_r01.json")["parsed"]
    assert parsed == out["parsed"] and parsed["quorum_time_to_two_thirds_p99_seconds"] > 0
    checked = bench_check("QUORUM", tmp_path)
    assert checked.returncode == 0, checked.stderr
    assert (f"r01 quorum_time_to_two_thirds_p99_seconds="
            f"{parsed['quorum_time_to_two_thirds_p99_seconds']:g}") in checked.stdout + checked.stderr


def test_round_files_number_on(tmp_path):
    """Each round goes to the next free number, as the reference numbers
    its rounds; bench_check gates the newest against the one before."""
    for name in ("SOAK_r01.json", "SOAK_r07.json", "QUORUM_r03.json"):
        (tmp_path / name).write_text(json.dumps({"rc": 0, "parsed": None}))
    path = write_round(str(tmp_path), "SOAK", {"rc": 0, "parsed": {"soak_commit_p99_seconds": 1.0}},
                       "test")
    assert os.path.basename(path) == "SOAK_r08.json"
    path = write_round(str(tmp_path), "SOAK", {"rc": 0, "parsed": {"soak_commit_p99_seconds": 2.0}},
                       "test")
    assert os.path.basename(path) == "SOAK_r09.json"
    checked = bench_check("SOAK", tmp_path)
    assert checked.returncode == 1, checked.stdout + checked.stderr  # 1.0 -> 2.0: a regression


def test_soak_smoke_at_42_heights(_installed_verifier, tmp_path):
    argv = ["--device", "cpu", "--target-height", "42", "--round-dir", str(tmp_path)]
    out = run_smoke(soak_smoke, argv, 240.0, _installed_verifier)
    assert out["marks"] == {"fault_at": 14, "fault_clear": 24, "crash_at": 28,
                            "spool_interval": 2, "flight_capacity": 6}
    assert out["heights"] >= 42
    parsed = read_round(tmp_path, "SOAK_r01.json")["parsed"]
    assert parsed == out["parsed"]
    assert parsed["soak_commit_samples"] >= 4 * 28 and parsed["soak_legs"] == 4
    checked = bench_check("SOAK", tmp_path)
    assert checked.returncode == 0, checked.stderr
    assert (f"r01 soak_commit_p99_seconds={parsed['soak_commit_p99_seconds']:g}"
            in checked.stdout + checked.stderr)


def test_soak_marks_keep_the_reference_proportions():
    assert soak_smoke.marks(210) == {"fault_at": 70, "fault_clear": 120, "crash_at": 140,
                                     "spool_interval": 10, "flight_capacity": 32}
    assert soak_smoke.marks(63) == {"fault_at": 21, "fault_clear": 36, "crash_at": 42,
                                    "spool_interval": 3, "flight_capacity": 10}
    m = soak_smoke.marks(5)
    assert m["fault_at"] < m["fault_clear"] < m["crash_at"] < 5
    with pytest.raises(ValueError):
        soak_smoke.marks(3)


def test_bench_commit_path(_installed_verifier, tmp_path):
    out = run_smoke(bench_commit_path, ["--device", "cpu", "--round-dir", str(tmp_path)],
                    180.0, _installed_verifier)
    assert set(out["heights"]) == {"vote_storm", "mempool_flood"}
    rnd = read_round(tmp_path, "CRITPATH_r01.json")
    assert rnd["parsed"] == out["summary"]["parsed"] and rnd["tail"] == out["summary"]["tail"]
    assert rnd["parsed"]["commit_heights"] >= 6
    checked = bench_check("CRITPATH", tmp_path)
    assert checked.returncode == 0, checked.stderr
    assert (f"r01 commit_p99_seconds={rnd['parsed']['commit_p99_seconds']:g}"
            in checked.stdout + checked.stderr)


def _dumps(rng, n_nodes: int, n_heights: int) -> list:
    """Seeded waterfall dumps in ``CritPath.snapshot()``'s shape."""
    out = []
    for _ in range(n_nodes):
        records = []
        for h in range(1, n_heights + 1):
            phases = {p: float(rng.gamma(1.5, 0.02)) for p in PHASES}
            records.append({"height": h, "phases": phases,
                            "commit_seconds": float(sum(phases.values())),
                            "critical_path": max(phases, key=phases.get)})
        out.append({"records": records, "total_records": len(records)})
    out.append({"records": [], "total_records": 0})  # a node that committed nothing
    return out


@pytest.mark.parametrize("seed", [1, 7, 99])
def test_pooling_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    results = [SimpleNamespace(name=f"s{i}", ok=True, heights=[n], critpath_dumps=_dumps(rng, 4, n))
               for i, n in enumerate((5, 9))]
    commits, phases, criticals = bench_commit_path.pool(results)
    assert (commits, phases, criticals) == REF_BENCH._pool(results)
    assert len(commits) == 4 * (5 + 9)
    assert bench_commit_path.phase_table(phases, commits) == REF_BENCH._phase_table(phases,
                                                                                    commits)
    summary = bench_commit_path.summarize(results)
    assert summary["commits"] == len(commits)
    assert summary["parsed"]["critical_path_counts"] == criticals
    assert json.loads(summary["tail"])["value"] == summary["parsed"]["commit_p99_seconds"]
