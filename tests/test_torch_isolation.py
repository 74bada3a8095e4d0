"""The port stands alone: no file of tendermint_tpu_torch/ nor chip_smoke.py
imports jax or the JAX package, and importing them loads neither."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "tendermint_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib") or top == "tendermint_tpu"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path}: imports {bad}"


C_SOURCES = sorted((ROOT / "tendermint_tpu_torch").rglob("*.c"))


def test_the_port_has_its_three_c_sources():
    assert [str(p.relative_to(ROOT)) for p in C_SOURCES] == [
        "tendermint_tpu_torch/consensus/_wal_native.c",
        "tendermint_tpu_torch/crypto/_hash_native.c",
        "tendermint_tpu_torch/encoding/_codec_native.c",
    ]


@pytest.mark.parametrize("path", C_SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_c_source_names_the_jax_package(path):
    """The port's C sources name no path or module of the JAX package."""
    bad = re.findall(r"tendermint_tpu(?!_torch)\b[./]?\S*", path.read_text())
    assert not bad, f"{path}: {bad}"


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, tendermint_tpu_torch, chip_smoke\n"
        "import tendermint_tpu_torch.crypto.batch, tendermint_tpu_torch.testutil.commit\n"
        "import tendermint_tpu_torch.crypto.secp256k1, tendermint_tpu_torch.crypto.hashing\n"
        "import tendermint_tpu_torch.ops.secp256k1_cuda, tendermint_tpu_torch.ops.fe_secp256k1\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'tendermint_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")])
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_p2p_without_cryptography_takes_the_fallback():
    """On a host without the ``cryptography`` package (the GPU host's
    installation), the port's p2p stack takes ``crypto/sts_fallback`` and
    still completes a secret-connection handshake, loading neither jax nor
    the JAX package. The package is hidden from the child interpreter
    through ``sys.modules``."""
    code = (
        "import sys, socket, threading\n"
        "sys.modules['cryptography'] = None\n"
        "import tendermint_tpu_torch.p2p\n"
        "from tendermint_tpu_torch.p2p.conn import secret_connection as sc\n"
        "from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519\n"
        "assert sc.STS_BACKEND == 'fallback', sc.STS_BACKEND\n"
        "assert sc.ChaCha20Poly1305.__module__ == 'tendermint_tpu_torch.crypto.sts_fallback'\n"
        "s1, s2 = socket.socketpair()\n"
        "out = {}\n"
        "def up(i, s):\n"
        "    out[i] = sc.SecretConnection(sc.RawConn(s), PrivKeyEd25519.generate())\n"
        "ts = [threading.Thread(target=up, args=(i, s)) for i, s in enumerate((s1, s2))]\n"
        "[t.start() for t in ts]; [t.join(30) for t in ts]\n"
        "out[0].write(b'x' * 3000)\n"
        "assert out[1].read_exactly(3000) == b'x' * 3000\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tendermint_tpu')]\n"
        "assert not bad, bad\n"
        "assert not [m for m in sys.modules if m.startswith('cryptography.')]\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")])
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
