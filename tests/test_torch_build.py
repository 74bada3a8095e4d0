"""The kernel build at first use (tendermint_tpu_torch/ops/_build.py), driven
through a stand-in ``nvcc`` script: libraries are keyed by a hash of their
source, built once, and a failed build raises and leaves nothing behind."""

import os
import stat

import pytest

from tendermint_tpu_torch.ops import _build

FAKE_NVCC = """#!/bin/sh
# stand-in compiler: log the call, then fail or write the -o target
echo "$@" >> "{calls}"
if [ -n "{fail}" ]; then echo "error: {fail}"; exit 2; fi
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo "ptxas info    : Used 1 registers"
printf 'lib' > "$out"
"""


@pytest.fixture
def sandbox(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    for name in _build.SOURCES.values():
        (src / name).write_text("// kernel " + name)
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")

    def install(fail=""):
        calls = tmp_path / "calls.txt"
        exe = tmp_path / "bin" / "nvcc"
        exe.parent.mkdir(exist_ok=True)
        exe.write_text(FAKE_NVCC.format(calls=calls, fail=fail))
        exe.chmod(exe.stat().st_mode | stat.S_IXUSR)
        monkeypatch.setattr(_build, "nvcc", lambda: str(exe))
        return calls

    return src, install


def test_builds_each_source_once(sandbox):
    _, install = sandbox
    calls = install()
    secs = _build.build_all()
    assert set(secs) == set(_build.SOURCES)
    for name in _build.SOURCES:
        assert _build.target(name).read_text() == "lib"
        assert "registers" in _build.build_log(name)
    assert len(calls.read_text().splitlines()) == len(_build.SOURCES)
    assert "arch=compute_90a,code=sm_90a" in calls.read_text()
    assert _build.build_all() == {n: 0.0 for n in _build.SOURCES}  # cached
    assert len(calls.read_text().splitlines()) == len(_build.SOURCES)


def test_changed_source_gets_a_new_library(sandbox):
    src, _ = sandbox
    before = _build.target("ed25519_ladder")
    (src / _build.SOURCES["ed25519_ladder"]).write_text("// changed")
    assert _build.target("ed25519_ladder") != before
    assert _build.target("ed25519_prologue").name.startswith("ed25519_prologue-")


def test_changed_header_rebuilds_the_sources_that_include_it(sandbox):
    src, _ = sandbox
    (src / "field.cuh").write_text('#pragma once\n#include "limbs.cuh"\n')
    (src / "limbs.cuh").write_text("// limbs v1")
    for name in ("ed25519_ladder", "ed25519_msm"):
        (src / _build.SOURCES[name]).write_text(f'#include <cstdint>\n#include "field.cuh"\n// {name}')
    names = ("ed25519_ladder", "ed25519_msm", "ed25519_prologue")
    before = {n: _build.target(n) for n in names}
    (src / "limbs.cuh").write_text("// limbs v2")  # two includes deep
    after = {n: _build.target(n) for n in names}
    assert after["ed25519_ladder"] != before["ed25519_ladder"]
    assert after["ed25519_msm"] != before["ed25519_msm"]
    assert after["ed25519_prologue"] == before["ed25519_prologue"]  # includes neither


def test_kernel_sources_hash_the_shared_field_header():
    """K2 and K4 include csrc/ed25519_field.cuh; their library names cover it."""
    header = (_build.SRC_DIR / "ed25519_field.cuh").read_bytes()
    for name in ("ed25519_ladder", "ed25519_msm"):
        path = _build.SRC_DIR / _build.SOURCES[name]
        assert b'#include "ed25519_field.cuh"' in path.read_bytes()
        assert header in _build._source_bytes(path, set())


def test_failed_build_raises_and_leaves_nothing(sandbox):
    _, install = sandbox
    install(fail="bad kernel")
    with pytest.raises(_build.KernelBuildError, match="bad kernel"):
        _build.build_all(["ed25519_prologue"])
    assert not _build.target("ed25519_prologue").exists()
    assert not [p for p in os.listdir(_build.BUILD_DIR) if p.endswith(".tmp")]
