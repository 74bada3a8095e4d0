"""The port's native codec (``encoding/_codec_native.c``, loaded by
``encoding/native.py``) against the reference package's pure-Python
``_PyWriter`` and ``_PyReader`` on numpy-seeded field sequences: equal bytes,
equal values, ``tell`` / ``span`` / ``remaining``, and on malformed input the
same exception class with the same message. ``tests/test_codec_native.py``'s
cases run against the port's native types and its Python classes.

The Python path (``TM_NO_NATIVE_CODEC=1``, read when ``codec.py`` is
imported) runs in child interpreters, as do the builds into an empty build
directory: a copy of the port's package under ``tmp_path``, so that its
``build/`` is empty, imported by several interpreters at once.
"""

import inspect
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tendermint_tpu.encoding import codec as jcodec
from tendermint_tpu.encoding import native as jnative
from tendermint_tpu_torch.consensus import wal as twal
from tendermint_tpu_torch.crypto import merkle as tmerkle
from tendermint_tpu_torch.encoding import codec as tcodec
from tendermint_tpu_torch.encoding import native as tnative

ROOT = Path(__file__).resolve().parents[1]
NATIVE_DIR = ROOT / "build" / "tendermint_tpu_torch" / "native"

WRITERS = {"native": lambda: tcodec.Writer(), "python": tcodec._PyWriter}
READERS = {"native": lambda d: tcodec.Reader(d), "python": tcodec._PyReader}
BOTH = pytest.mark.parametrize("path", ["native", "python"])


def _ops(seed: int, n: int = 300):
    """A seeded field sequence covering every writer op and the uvarint
    boundaries."""
    rng = np.random.default_rng(seed)
    edges = [0, 1, 0x7F, 0x80, 0x3FFF, 0x4000, (1 << 63) - 1, 1 << 63, (1 << 64) - 1]
    ops = []
    for _ in range(n):
        k = int(rng.integers(0, 7))
        if k == 0:
            v = (edges[int(rng.integers(0, len(edges)))] if rng.random() < 0.3
                 else int(rng.integers(0, 1 << 63, dtype=np.uint64)))
            ops.append(("uvarint", v))
        elif k == 1:
            ops.append(("svarint", int(rng.integers(-(1 << 63), (1 << 63) - 1))))
        elif k == 2:
            ops.append(("fixed64", int(rng.integers(-(1 << 63), (1 << 63) - 1))))
        elif k == 3:
            ops.append(("bytes", rng.bytes(int(rng.integers(0, 300)))))
        elif k == 4:
            cps = rng.integers(32, 0x2FF, size=int(rng.integers(0, 40)))
            ops.append(("string", "".join(chr(int(c)) for c in cps)))
        elif k == 5:
            ops.append(("bool", bool(rng.integers(0, 2))))
        else:
            ops.append(("raw", rng.bytes(int(rng.integers(0, 20)))))
    return ops


def _encode(writer, ops) -> bytes:
    for name, v in ops:
        getattr(writer, name)(v)
    return writer.build()


# -- where the natives live -------------------------------------------------------


def test_the_natives_build_under_the_ports_build_directory():
    assert twal._get_native_scan() is not None
    mods = {"codec": tcodec._native, "hash": tmerkle._native,
            "wal": tnative.modules.get("tendermint_tpu_torch.consensus._wal_native")}
    assert mods["wal"].scan is twal._get_native_scan()
    for what, mod in mods.items():
        assert mod is not None, what
        path = Path(mod.__file__).resolve()
        assert path.parent == NATIVE_DIR.resolve(), (what, path)
        assert path.relative_to(ROOT).parts[0] == "build", (what, path)
        assert mod.__name__.startswith("tendermint_tpu_torch."), (what, mod.__name__)
    assert tcodec.Writer is tcodec._native.Writer and tcodec.Reader is tcodec._native.Reader
    assert tcodec.Writer.__module__ == "tendermint_tpu_torch.encoding._codec_native"
    assert set(tnative.build_seconds) >= {m.__name__ for m in mods.values()}


def test_both_packages_natives_load_side_by_side():
    """Both C sources name their module ``_codec_native``: each package's
    loads from its own file, and the two types are distinct and agree."""
    jmod = jnative.load()
    if jmod is None:
        pytest.skip("the reference's native codec did not build")
    assert jmod is not tcodec._native
    assert jmod.Writer is not tcodec.Writer and jmod.Reader is not tcodec.Reader
    assert not str(Path(tcodec._native.__file__).resolve()).startswith(
        str((ROOT / "tendermint_tpu").resolve()))
    ops = _ops(5)
    data = _encode(tcodec.Writer(), ops)
    assert data == _encode(jmod.Writer(), ops)
    got, want = tcodec.Reader(data), jmod.Reader(data)
    for name, v in ops:
        args = (len(v),) if name == "raw" else ()
        assert getattr(got, name)(*args) == getattr(want, name)(*args) == v


def test_an_unchanged_source_is_reused_and_flags_name_the_library():
    src = Path(tcodec.__file__).with_name("_codec_native.c")
    so = tnative.target(src)
    assert so == Path(tcodec._native.__file__)
    assert tnative.target(src) == so
    assert tnative.target(src, ("-DX",)) != so
    assert tnative.load() is tcodec._native  # loaded once a process


# -- byte and value parity with the reference's Python classes --------------------


@BOTH
@pytest.mark.parametrize("seed", range(6))
def test_writer_bytes_equal_the_references(path, seed):
    ops = _ops(seed)
    assert _encode(WRITERS[path](), ops) == _encode(jcodec._PyWriter(), ops)


@BOTH
@pytest.mark.parametrize("seed", range(6))
def test_reader_values_tell_and_span_equal_the_references(path, seed):
    ops = _ops(100 + seed)
    data = _encode(jcodec._PyWriter(), ops)
    got, want = READERS[path](data), jcodec._PyReader(data)
    for name, v in ops:
        start = got.tell()
        assert start == want.tell()
        args = (len(v),) if name == "raw" else ()
        assert getattr(got, name)(*args) == getattr(want, name)(*args) == v
        assert got.span(start) == want.span(start)
        assert got.remaining() == want.remaining()
    assert got.at_end() and want.at_end()
    assert got.span(0) == data


# -- malformed input: the same class and message -----------------------------------

BAD = [
    ("uvarint", b"", ()), ("uvarint", b"\x80", ()), ("uvarint", b"\xc0\x00", ()),
    ("uvarint", b"\x80\x80\x00", ()), ("uvarint", b"\x81\x00", ()),
    ("uvarint", b"\xff" * 9 + b"\x02", ()), ("uvarint", b"\xff" * 9 + b"\x81", ()),
    ("uvarint", b"\xff" * 10 + b"\x01", ()), ("uvarint", b"\x80" * 10 + b"\x01", ()),
    ("svarint", b"\x81", ()), ("svarint", b"\xff" * 9 + b"\x03", ()),
    ("fixed64", b"", ()), ("fixed64", b"\x01\x02\x03", ()),
    ("bytes", b"\x05abc", ()), ("bytes", b"\x80", ()), ("bytes", b"", ()),
    ("string", b"\x03ab", ()), ("string", b"\x02\xff\xfe", ()), ("string", b"\x01\x80", ()),
    ("string", b"\x03a\xe2\x82", ()), ("bool", b"", ()), ("raw", b"ab", (3,)),
    ("raw", b"ab", (-1,)),
]


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return type(e), str(e)
    return None


@pytest.mark.parametrize("op,data,args", BAD, ids=[f"{o}-{d.hex()}-{a}" for o, d, a in BAD])
def test_reader_errors_equal_the_references(op, data, args):
    want = _raised(lambda: getattr(jcodec._PyReader(data), op)(*args))
    assert want is not None
    for path in READERS:
        assert _raised(lambda: getattr(READERS[path](data), op)(*args)) == want, path


@BOTH
def test_a_length_past_ssize_t_is_truncation(path):
    """A bytes length above the host's ssize_t reads as truncation on both
    of the port's paths, as in the reference's C reader; the reference's
    Python reader lets BytesIO raise OverflowError there."""
    data = jcodec._PyWriter().uvarint((1 << 64) - 1).build() + b"ab"
    assert _raised(lambda: READERS[path](data).bytes()) == (EOFError, "truncated bytes")
    if jnative.load() is not None:
        assert _raised(lambda: jnative.load().Reader(data).bytes()) == (EOFError,
                                                                        "truncated bytes")


@BOTH
@pytest.mark.parametrize("start", [-1, 3, 99])
def test_span_rejects_a_bad_start(path, start):
    r = READERS[path](b"\x01\x02\x03")
    r.uvarint()
    r.uvarint()
    want = _raised(lambda: jcodec._PyReader(b"").span(start))
    assert _raised(lambda: r.span(start)) == want == (ValueError, "span start out of range")
    assert r.span(2) == b"" and r.span(0) == b"\x01\x02"


@BOTH
def test_writer_rejects_out_of_range_uvarints(path):
    for bad in (-1, 1 << 64, (1 << 64) + 5):
        with pytest.raises(ValueError, match=r"uvarint must be in \[0, 2\^64\)"):
            WRITERS[path]().uvarint(bad)


# -- tests/test_codec_native.py, on the port ---------------------------------------


def test_native_reader_truncation_raises():
    with pytest.raises(EOFError):
        tcodec.Reader(b"\x05ab").bytes()
    with pytest.raises(EOFError):
        tcodec.Reader(b"").uvarint()


def test_chaining():
    out = tcodec.Writer().uvarint(1).svarint(-2).bool(True).string("x").build()
    assert out == jcodec._PyWriter().uvarint(1).svarint(-2).bool(True).string("x").build()


@BOTH
def test_uvarint_full_uint64_domain(path):
    for v in (1 << 63, (1 << 64) - 1):
        b = WRITERS[path]().uvarint(v).build()
        assert b == jcodec._PyWriter().uvarint(v).build()
        assert READERS[path](b).uvarint() == v


@BOTH
def test_non_minimal_uvarint_rejected(path):
    for data in (b"\xc0\x00", b"\x80\x80\x00", b"\x81\x00"):
        with pytest.raises(ValueError, match="non-minimal uvarint"):
            READERS[path](data).uvarint()
    assert READERS[path](b"\x00").uvarint() == 0


@BOTH
def test_tell_and_span(path):
    data = jcodec._PyWriter().uvarint(300).string("hello").fixed64(-1).build()
    r = READERS[path](data)
    assert r.tell() == 0
    r.uvarint()
    start = r.tell()
    r.string()
    assert r.span(start) == jcodec._PyWriter().string("hello").build()
    with pytest.raises(ValueError):
        r.span(len(data) + 10)


@BOTH
def test_reader_accepts_any_bytes_like(path):
    data = _encode(jcodec._PyWriter(), _ops(9, 40))
    for form in (bytearray(data), memoryview(data)):
        r, want = READERS[path](form), jcodec._PyReader(data)
        while not want.at_end():
            assert r.raw(1) == want.raw(1)
        assert r.at_end()


# -- the Python path and the builds, in child interpreters -------------------------


def _run(code: str, cwd: Path, env_extra: dict, timeout: float = 120.0):
    env = dict(os.environ)
    env.pop("TM_NO_NATIVE_CODEC", None)
    env.pop("TM_NO_SHANI", None)
    env.update(env_extra)
    env["PYTHONPATH"] = os.pathsep.join([str(cwd), str(ROOT)])
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_the_python_path_gives_the_same_bytes_and_values():
    code = ("import numpy as np\n" + inspect.getsource(_ops) + inspect.getsource(_encode)
            + "from tendermint_tpu_torch.encoding import codec\n"
            "out = [_encode(codec.Writer(), _ops(s)).hex() for s in range(3)]\n"
            "r = codec.Reader(bytes.fromhex(out[0]))\n"
            "ok = all(getattr(r, n)(*((len(v),) if n == 'raw' else ())) == v for n, v in _ops(0))\n"
            "print(codec.Writer.__name__, codec.Reader.__name__, codec._native is None, ok)\n"
            "print(' '.join(out))\n")
    res = _run(code, ROOT, {"TM_NO_NATIVE_CODEC": "1"})
    assert res.returncode == 0, res.stderr
    head, blobs = res.stdout.splitlines()
    assert head == "_PyWriter _PyReader True True"
    assert blobs.split() == [_encode(tcodec.Writer(), _ops(s)).hex() for s in range(3)]


def test_the_python_path_binds_every_fallback():
    code = ("from tendermint_tpu_torch.encoding import codec\n"
            "from tendermint_tpu_torch.crypto import merkle\n"
            "from tendermint_tpu_torch.consensus import wal\n"
            "assert codec.Writer is codec._PyWriter and codec.Reader is codec._PyReader\n"
            "assert merkle._native is None and merkle.leaf_hash is merkle._py_leaf_hash\n"
            "assert merkle.hash_from_byte_slices is merkle._py_hash_from_byte_slices\n"
            "assert wal._get_native_scan() is None\n")
    res = _run(code, ROOT, {"TM_NO_NATIVE_CODEC": "1"})
    assert res.returncode == 0, res.stderr
    assert "native" not in res.stderr


def _package_copy(tmp_path: Path) -> Path:
    """The port's package under tmp_path, its build directory empty."""
    dst = tmp_path / "checkout"
    shutil.copytree(ROOT / "tendermint_tpu_torch", dst / "tendermint_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


IMPORT_ALL = (
    "from tendermint_tpu_torch.encoding import codec\n"
    "from tendermint_tpu_torch.crypto import merkle\n"
    "from tendermint_tpu_torch.consensus import wal\n"
    "assert codec.Writer is not codec._PyWriter and merkle._native is not None\n"
    "assert wal._get_native_scan() is not None\n"
    "print(codec._native.__file__)\n"
)


def test_interpreters_importing_at_once_build_into_an_empty_directory(tmp_path):
    """Six interpreters import the port at once into an empty build
    directory (the test workers and a localnet's node processes do): each
    loads all three natives, three libraries remain and no temporary file."""
    co = _package_copy(tmp_path)
    env = dict(os.environ)
    env.pop("TM_NO_NATIVE_CODEC", None)
    env["PYTHONPATH"] = str(co)
    procs = [subprocess.Popen([sys.executable, "-c", IMPORT_ALL], cwd=co, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=180) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    built = co / "build" / "tendermint_tpu_torch" / "native"
    assert {o.strip() for o, _ in outs} <= {str(p) for p in built.iterdir()}
    names = sorted(p.name.split("-")[0] for p in built.iterdir())
    assert names == ["_codec_native", "_hash_native", "_wal_native"], names
    # a changed source rebuilds; the unchanged ones are reused
    mtimes = {p.name: p.stat().st_mtime_ns for p in built.iterdir()}
    src = co / "tendermint_tpu_torch" / "encoding" / "_codec_native.c"
    src.write_text(src.read_text() + "\n/* changed */\n")
    res = _run(IMPORT_ALL, co, {})
    assert res.returncode == 0, res.stderr
    after = {p.name: p.stat().st_mtime_ns for p in built.iterdir()}
    assert len(after) == 4 and all(after[n] == t for n, t in mtimes.items())


def test_a_failed_build_falls_back_and_says_so(tmp_path):
    co = _package_copy(tmp_path)
    res = _run("from tendermint_tpu_torch.encoding import codec\n"
               "from tendermint_tpu_torch.crypto import merkle\n"
               "assert codec.Writer is codec._PyWriter and merkle._native is None\n"
               "print(codec.Writer().uvarint(300).string('x').build().hex())\n",
               co, {"CC": str(tmp_path / "no-such-cc")})
    assert res.returncode == 0, res.stderr
    assert res.stderr.count("native build failed") == 2, res.stderr
    assert res.stdout.strip() == jcodec._PyWriter().uvarint(300).string("x").build().hex()
    built = co / "build" / "tendermint_tpu_torch" / "native"
    assert not any(built.iterdir())
