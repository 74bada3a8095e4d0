"""The port's native SHA-256 and Merkle tree (``crypto/_hash_native.c``)
against the reference package's pure-Python tree (``_py_leaf_hash``,
``inner_hash``, ``_py_hash_from_byte_slices``) on numpy-seeded leaves:
``leaf_hash``, ``inner_hash``, ``merkle_root``, ``leaf_hashes`` and
``part_leaf_hashes`` at leaf counts 0-300 and at the lengths where SHA-256's
padding changes shape (0, 55, 56, 63, 64, 119, 120, 65,536 +- 1), on the
SHA-NI block function and, in a child interpreter with ``TM_NO_SHANI=1``
(read at module init), on the portable one. ``PartSet.from_data`` gives the
reference's roots and proofs at several block sizes on the native and the
Python path (``TM_NO_NATIVE_CODEC=1``, in a child interpreter). All exact.
"""

import hashlib
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tendermint_tpu.crypto import merkle as jmerkle
from tendermint_tpu.types import part_set as jpart_set
from tendermint_tpu_torch.crypto import merkle as tmerkle
from tendermint_tpu_torch.types import part_set as tpart_set

ROOT = Path(__file__).resolve().parents[1]
LENGTHS = [0, 1, 55, 56, 63, 64, 65, 119, 120, 65_535, 65_536, 65_537]
PART = 65_536


def _leaves(seed: int, n: int, max_len: int = 130):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(k)) for k in rng.integers(0, max_len + 1, size=n)]


def _ref_root(items):
    return jmerkle._py_hash_from_byte_slices(items)


def _ref_leaf(b):
    return jmerkle._py_leaf_hash(b)


def _check_all(native) -> int:
    """Every native function against the reference's pure tree; returns
    the number of roots compared."""
    n_roots = 0
    for length in LENGTHS:
        b = np.random.default_rng(length).bytes(length)
        assert native.sha256(b) == hashlib.sha256(b).digest(), length
        assert native.leaf_hash(b) == _ref_leaf(b), length
        for n in (1, 2, 3, 5):
            items = [b] * n
            assert native.merkle_root(items) == _ref_root(items), (length, n)
            n_roots += 1
    for n in range(0, 301):
        items = _leaves(n, n)
        assert native.merkle_root(items) == _ref_root(items), n
        assert native.leaf_hashes(items) == [_ref_leaf(x) for x in items], n
        n_roots += 1
    rng = np.random.default_rng(3)
    for _ in range(64):
        left, right = rng.bytes(32), rng.bytes(32)
        assert native.inner_hash(left, right) == jmerkle.inner_hash(left, right)
    for size in (0, 1, PART - 1, PART, PART + 1, 3 * PART + 5):
        data = rng.bytes(size)
        for part in (PART, 64, 1000):
            total = max(1, -(-size // part))
            want = [_ref_leaf(data[i * part:(i + 1) * part]) for i in range(total)]
            assert native.part_leaf_hashes(data, part) == want, (size, part)
    return n_roots


def _cpu_has_sha() -> bool:
    try:
        flags = Path("/proc/cpuinfo").read_text()
    except OSError:
        return False
    return " sha_ni" in flags and " sse4_1" in flags


def test_the_native_hasher_is_loaded():
    assert tmerkle._native is not None
    assert tmerkle.leaf_hash is tmerkle._native.leaf_hash
    assert tmerkle.hash_from_byte_slices is tmerkle._native.merkle_root
    assert tmerkle._native.__name__ == "tendermint_tpu_torch.crypto._hash_native"


def test_have_shani_follows_the_cpu():
    if "TM_NO_SHANI" in os.environ:
        assert tmerkle._native.have_shani() is False
    else:
        assert tmerkle._native.have_shani() is _cpu_has_sha()


def test_every_function_equals_the_reference_on_this_block_function():
    assert _check_all(tmerkle._native) == len(LENGTHS) * 4 + 301


def _child(code: str, env_extra: dict):
    env = dict(os.environ)
    env.pop("TM_NO_NATIVE_CODEC", None)
    env.pop("TM_NO_SHANI", None)
    env.update(env_extra)
    env["PYTHONPATH"] = str(ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_the_portable_block_function_equals_the_reference():
    """TM_NO_SHANI=1 is read when the module initializes: a child
    interpreter runs the same comparisons on the portable block function."""
    code = ("import hashlib\nimport numpy as np\n"
            "from tendermint_tpu.crypto import merkle as jmerkle\n"
            "from tendermint_tpu_torch.crypto import merkle as tmerkle\n"
            f"LENGTHS, PART = {LENGTHS!r}, {PART}\n"
            + "".join(inspect.getsource(f) for f in (_leaves, _ref_root, _ref_leaf, _check_all))
            + "assert tmerkle._native is not None and tmerkle._native.have_shani() is False\n"
            "print(_check_all(tmerkle._native))\n")
    res = _child(code, {"TM_NO_SHANI": "1"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == str(len(LENGTHS) * 4 + 301)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 7, 8, 9, 31, 32, 33, 100, 255, 256, 257])
def test_roots_and_proofs_equal_the_references(n):
    items = _leaves(1000 + n, n)
    assert tmerkle.hash_from_byte_slices(items) == jmerkle.hash_from_byte_slices(items)
    assert tmerkle._py_hash_from_byte_slices(items) == _ref_root(items)
    got_root, got = tmerkle.proofs_from_byte_slices(items)
    want_root, want = jmerkle.proofs_from_byte_slices(items)
    assert got_root == want_root == _ref_root(items)
    assert [(p.total, p.index, p.leaf_hash, p.aunts) for p in got] == [
        (p.total, p.index, p.leaf_hash, p.aunts) for p in want]
    for i, p in enumerate(got):
        assert p.verify(got_root, items[i])


SIZES = [0, 1, 1000, PART - 1, PART, PART + 1, 2 * PART, 3 * PART + 17]


def _part_set_view(mod, data: bytes):
    ps = mod.PartSet.from_data(data)
    parts = [ps.get_part(i) for i in range(ps.total)]
    return (ps.header().total, ps.header().hash,
            [(p.index, p.bytes_, p.hash(), p.proof.total, p.proof.index, p.proof.leaf_hash,
              p.proof.aunts) for p in parts])


@pytest.mark.parametrize("size", SIZES)
def test_part_sets_equal_the_references(size):
    data = np.random.default_rng(size).bytes(size)
    got = _part_set_view(tpart_set, data)
    assert got == _part_set_view(jpart_set, data)
    total, root, parts = got
    assert total == max(1, -(-size // PART))
    assert all(p[5] == _ref_leaf(p[1]) for p in parts)


def test_the_python_path_gives_the_same_part_sets_and_roots():
    code = ("import numpy as np\n"
            "from tendermint_tpu_torch.crypto import merkle\n"
            "from tendermint_tpu_torch.types import part_set\n"
            f"SIZES = {SIZES!r}\n"
            "assert merkle._native is None\n"
            "for size in SIZES:\n"
            "    ps = part_set.PartSet.from_data(np.random.default_rng(size).bytes(size))\n"
            "    parts = [ps.get_part(i) for i in range(ps.total)]\n"
            "    print(ps.header().hash.hex(), ' '.join(a.hex() for p in parts for a in "
            "[p.hash()] + p.proof.aunts))\n"
            "print(merkle.hash_from_byte_slices([bytes([i]) * i for i in range(40)]).hex())\n")
    res = _child(code, {"TM_NO_NATIVE_CODEC": "1"})
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    for size, line in zip(SIZES, lines):
        ps = tpart_set.PartSet.from_data(np.random.default_rng(size).bytes(size))
        parts = [ps.get_part(i) for i in range(ps.total)]
        assert line == ps.header().hash.hex() + " " + " ".join(
            a.hex() for p in parts for a in [p.hash()] + p.proof.aunts)
    assert lines[-1] == jmerkle._py_hash_from_byte_slices(
        [bytes([i]) * i for i in range(40)]).hex()


def test_malformed_arguments_raise():
    with pytest.raises(ValueError, match="32-byte"):
        tmerkle._native.inner_hash(b"a", b"b" * 32)
    with pytest.raises(ValueError, match="part_size"):
        tmerkle._native.part_leaf_hashes(b"abc", 0)
    with pytest.raises(TypeError):
        tmerkle.hash_from_byte_slices([b"a", "not bytes"])
    # a part size near the top of ssize_t: one part, no overflow
    assert tmerkle._native.part_leaf_hashes(b"abc", sys.maxsize) == [_ref_leaf(b"abc")]
