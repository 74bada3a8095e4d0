"""The port stands alone: no file of tendermint_tpu_torch/ nor chip_smoke.py
imports jax or the JAX package, and importing them loads neither."""

import ast
import os
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
