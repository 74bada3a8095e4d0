"""Build and load the port's host C extensions: the codec
(``encoding/_codec_native.c``), the SHA-256/Merkle hasher
(``crypto/_hash_native.c``) and the WAL scanner (``consensus/_wal_native.c``).

Each is compiled with ``cc`` against the running interpreter's headers at
its first import and loaded under a ``tendermint_tpu_torch.`` module name.
Libraries land in ``build/tendermint_tpu_torch/native/`` at the root of the
checkout, named by a hash of the source, of the flags and of the
interpreter's ``SOABI``: a changed source rebuilds, an unchanged one is
reused. Each build writes a path unique to its process and thread and then
``os.replace``-s it into place, so processes that start together (a
localnet, the test workers) never load a torn library.

These are host code with the same results as the pure-Python paths, which
stay as the fallback: a failed build writes the compiler's message to
stderr and ``load_ext`` returns None. ``TM_NO_NATIVE_CODEC=1`` forces the
fallback for all three.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parents[1] / "build" / "tendermint_tpu_torch" / "native"
_SOABI = sysconfig.get_config_var("SOABI") or "abi"
CFLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
modules: Dict[str, object] = {}  # module name -> the loaded module (one load a process)
build_seconds: Dict[str, float] = {}  # module name -> this process's build (0.0: reused)


def target(src, extra_cflags=(), extra_ldflags=()) -> Path:
    """The library path of ``src`` built with these flags."""
    src = Path(src)
    key = b"\0".join([src.read_bytes(), " ".join(CFLAGS).encode(),
                      " ".join(extra_cflags).encode(), " ".join(extra_ldflags).encode(),
                      _SOABI.encode()])
    digest = hashlib.sha256(key).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.{_SOABI}.so"


def _build(src: Path, so: Path, extra_cflags, extra_ldflags) -> bool:
    include = sysconfig.get_paths()["include"]
    cc = os.environ.get("CC", "cc")
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"{so.name}.", suffix=".tmp", dir=so.parent)
    os.close(fd)
    # the libraries after the source: GNU ld with --as-needed drops a -l
    # that no object before it has asked for
    cmd = [cc, *CFLAGS, f"-I{include}", *extra_cflags, str(src), *extra_ldflags, "-o", tmp]
    try:
        try:
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            sys.stderr.write(f"native build failed ({src.name}): {e}\n")
            return False
        if res.returncode != 0:
            sys.stderr.write(f"native build failed ({src.name}):\n{res.stderr[-1000:]}\n")
            return False
        os.replace(tmp, so)
        return True
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_ext(src, module_name: str, extra_cflags=(), extra_ldflags=()):
    """The extension built from ``src`` and loaded as ``module_name`` (its
    ``PyInit_`` symbol is named after the last component); None when
    ``TM_NO_NATIVE_CODEC`` is set or the build or the load failed."""
    if os.environ.get("TM_NO_NATIVE_CODEC"):
        return None
    src = Path(src)
    with _lock:
        mod = modules.get(module_name)
        if mod is not None:
            return mod
        try:
            so = target(src, extra_cflags, extra_ldflags)
        except OSError as e:
            sys.stderr.write(f"native build failed ({src.name}): {e}\n")
            return None
        t0 = time.perf_counter()
        if not so.exists() and not _build(src, so, extra_cflags, extra_ldflags):
            return None
        built = time.perf_counter() - t0
        try:
            spec = importlib.util.spec_from_file_location(module_name, so)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except Exception as e:  # noqa: BLE001 - any load failure means the fallback
            sys.stderr.write(f"native load failed ({so.name}): {e}\n")
            return None
        modules[module_name] = mod
        build_seconds[module_name] = built
        return mod


def load():
    """The compiled codec module, or None when unavailable."""
    return load_ext(_HERE / "_codec_native.c", "tendermint_tpu_torch.encoding._codec_native")
