"""Build the port's CUDA kernels at first use.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
into its own shared library (``-gencode arch=compute_90a,code=sm_90a``),
loaded with ``ctypes``. Libraries land in ``build/tendermint_tpu_torch/`` at
the root of the checkout, named by a hash of the source, of every header it
includes from ``csrc`` (``#include "..."``, followed recursively) and of the
flags, so a changed source or header rebuilds and an unchanged one is
reused. ``build_all`` starts
one ``nvcc`` per missing library, all at once. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tendermint_tpu_torch"

SOURCES = {
    "ed25519_prologue": "ed25519_prologue.cu",
    "ed25519_ladder": "ed25519_ladder.cu",
    "secp256k1_ladder": "secp256k1_ladder.cu",
    "ed25519_msm": "ed25519_msm.cu",
    "ed25519_verify": "ed25519_verify.cu",
    "secp256k1_verify": "secp256k1_verify.cu",
    "imad_probe": "imad_probe.cu",  # a measurement probe, not a port of a TPU kernel
}

FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    pass


def nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def _source_bytes(path: Path, seen: set) -> bytes:
    """``path``'s bytes followed by those of each header it includes with
    quotes (from its own directory, once each)."""
    src = path.read_bytes()
    parts = [src]
    for inc in _INCLUDE.findall(src):
        dep = path.parent / inc.decode()
        if dep not in seen:
            seen.add(dep)
            parts.append(_source_bytes(dep, seen))
    return b"".join(parts)


def target(name: str) -> Path:
    src = _source_bytes(SRC_DIR / SOURCES[name], set())
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_log(name: str) -> str:
    """The compiler's report (``-Xptxas -v``: registers, spills) of a built
    kernel, or '' if it was not built in this checkout."""
    log = target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library in parallel; returns seconds per name
    (0.0 for a library that was already built). Raises on a failed build."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not target(n).exists()]
    out = {n: 0.0 for n in names}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = target(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *FLAGS, "-o", str(tmp), str(SRC_DIR / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        out[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        target(n).with_suffix(".log").write_text(log)
        os.replace(tmp, target(n))
    if failed:
        raise KernelBuildError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = _libs[name] = ctypes.CDLL(str(target(name)))
        return lib
