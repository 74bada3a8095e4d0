"""The port's ``tools/soak_report.py`` against the reference's
``scripts/soak_report.py`` (loaded from its file) on the same spools:
seeded snapshot streams written by the port's ``TelemetrySpool`` for four
nodes, one of them torn mid-frame and restarted (its cumulative sketches
shrink and its sequence numbers reset), with growing eviction totals and
spool errors and a later leg slower than the ones before it. Both
packages' ``load_spools`` + ``build_report`` and both command lines must
give the same JSON: fleet sketches bucket for bucket, legs, regression and
loss flags, warnings.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.device import NoCudaDeviceError
from tendermint_tpu_torch.libs.sketch import QuantileSketch
from tendermint_tpu_torch.libs.telemetry import TelemetrySpool, encode_record, read_spool
from tendermint_tpu_torch.tools import soak_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_reference():
    path = os.path.join(REPO, "scripts", "soak_report.py")
    spec = importlib.util.spec_from_file_location("ref_soak_report", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load_reference()

NODES = ("n0", "n1", "n2", "n3")
CRIT = ("commit", "prevote_quorum", "precommit_quorum", "abci_exec")
QUORUM = ("precommit_two_thirds", "prevote_third")


class _Node:
    """One node's instruments as its spool's sources see them: cumulative
    sketches fed from a seeded stream, monotone eviction totals."""

    def __init__(self, rng, slow_from: int):
        self.rng = rng
        self.slow_from = slow_from
        self.height = 0
        self.restart()

    def restart(self):
        self.sketches = {"critpath": {n: QuantileSketch() for n in CRIT},
                         "quorum": {n: QuantileSketch() for n in QUORUM}}
        self.evicted = {"flight": 0, "profile": 0, "critpath": 0, "quorum": 0}

    def step(self):
        self.height += 1
        scale = 3.0 if self.height > self.slow_from else 1.0
        for section in self.sketches.values():
            for sk in section.values():
                sk.add(float(self.rng.gamma(2.0, 0.05)) * scale)
        if self.height > 6:
            self.evicted["flight"] += 1
        if self.rng.random() < 0.2:
            self.evicted["quorum"] += int(self.rng.integers(1, 4))

    def sources(self, spool):
        return {
            "sketches": lambda: {sec: {n: sk.to_dict() for n, sk in d.items()}
                                 for sec, d in self.sketches.items()},
            "evicted": lambda: dict(self.evicted),
            "spool": spool.status,
        }


def _spool(path, node_id, node):
    spool = TelemetrySpool(path, node_id=node_id, interval_heights=3, interval_seconds=0.0,
                           ring_capacity=8, height_fn=lambda: node.height)
    for name, fn in node.sources(spool).items():
        spool.set_source(name, fn)
    return spool


def _write_spools(tmp_path, seed: int, heights: int = 40, crash_at: int = 25):
    """Four nodes' spools; node 2 is killed at ``crash_at`` with a torn
    half-frame appended, then reopened (the torn tail truncated) and
    restarted from empty sketches. Returns the spool head paths."""
    rng = np.random.default_rng(seed)
    nodes = {nid: _Node(np.random.default_rng(rng.integers(1 << 32)), slow_from=30)
             for nid in NODES}
    paths = {nid: str(tmp_path / nid / "spool") for nid in NODES}
    for p in paths.values():
        os.makedirs(os.path.dirname(p))
    spools = {nid: _spool(paths[nid], nid, nodes[nid]) for nid in NODES}
    for h in range(1, heights + 1):
        for nid in NODES:
            nodes[nid].step()
            spools[nid].maybe_flush()
        if h == crash_at:
            spools["n2"].kill()
            with open(paths["n2"], "ab") as f:
                f.write(encode_record(b'{"torn":true}\n')[:9])
            nodes["n2"].restart()
            spools["n2"] = _spool(paths["n2"], "n2", nodes["n2"])
            assert spools["n2"].status()["recovered_bytes"] > 0
        if h == 33:
            spools["n1"].write_errors += 1  # a failed append the report must flag
    for spool in spools.values():
        spool.stop()
    assert read_spool(paths["n2"])["corrupt_frames"] == 0
    return [paths[nid] for nid in NODES]


def _canon(report) -> str:
    return json.dumps(report, sort_keys=True)


@pytest.mark.parametrize("seed", [3, 17, 2026])
@pytest.mark.parametrize("legs,threshold", [(4, 0.25), (3, 0.5), (6, 0.1)])
def test_reports_equal(tmp_path, seed, legs, threshold):
    paths = _write_spools(tmp_path, seed)
    per_node = soak_report.load_spools(paths)
    assert per_node == REF.load_spools(paths)
    port = soak_report.build_report(per_node, legs=legs, threshold=threshold)
    ref = REF.build_report(REF.load_spools(paths), legs=legs, threshold=threshold)
    assert _canon(port) == _canon(ref)
    # the case is not trivial: a restart, a lossy leg, a regression
    assert any("n2: 1 restart(s)" in w for w in port["warnings"])
    assert any(leg["lossy"] for leg in port["legs"])
    assert sum(leg["spool_errors"] for leg in port["legs"]) == 1
    assert port["regressions"] or threshold >= 0.5
    fleet = port["fleet"]["critpath/commit"]
    merged = QuantileSketch.merged(
        QuantileSketch.from_dict(port["per_node_final"][n]["critpath/commit"]) for n in NODES)
    assert fleet["sketch"]["buckets"] == merged.to_dict()["buckets"]


def test_command_lines_write_equal_reports(tmp_path, capsys):
    paths = _write_spools(tmp_path, 5)
    out_p, out_r = tmp_path / "port.json", tmp_path / "ref.json"
    args = ["--spools", ",".join(paths), "--legs", "5", "--threshold", "0.2"]
    assert soak_report.main(args + ["-o", str(out_p), "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    assert REF.main(args + ["-o", str(out_r)]) == 0
    ref_out = capsys.readouterr().out
    assert json.loads(out_p.read_text()) == json.loads(out_r.read_text())
    # the summaries differ only in the report's path
    assert port_out.replace(str(out_p), "OUT") == ref_out.replace(str(out_r), "OUT")


def test_sketch_delta_equal():
    rng = np.random.default_rng(11)
    earlier, later, other = QuantileSketch(), QuantileSketch(), QuantileSketch()
    for x in rng.gamma(2.0, 0.1, 200):
        earlier.add(float(x))
        later.add(float(x))
    for x in rng.gamma(2.0, 0.3, 150):
        later.add(float(x))
        other.add(float(x))
    for a, b in ((later, earlier), (earlier, later), (later, None), (other, earlier)):
        port = soak_report.sketch_delta(a, b).to_dict()
        ref = REF.sketch_delta(a, b).to_dict()
        assert port == ref


def test_argument_errors_and_no_card(tmp_path):
    assert soak_report.main(["--device", "cpu"]) == 2
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(NoCudaDeviceError):
        soak_report.main(["--spools", str(tmp_path / "none"), "-o", str(tmp_path / "o.json")])
