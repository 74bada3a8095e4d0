"""The host C accelerators against the pure-Python paths on one chain's data.

``run`` times, in this interpreter, the paths it bound at import (the C
types of ``encoding/_codec_native.c``, ``crypto/_hash_native.c`` and
``consensus/_wal_native.c``, or the Python classes under
``TM_NO_NATIVE_CODEC=1``): the decode and the encode of every block, the
part-set rehash, ``Header.hash``, ``ValidatorSet.hash`` at 10,000
validators and the WAL decode, with a digest of every result and the error
string of a truncated WAL. Each timed call runs with the garbage collector
off, as ``timeit`` runs, so that the heap a process holds does not weigh
on one path more than the other. ``PythonChild`` runs it in a fresh child
interpreter with ``TM_NO_NATIVE_CODEC=1``, on the Python paths; its
digests must equal the natives'.

``write_inputs`` lays out the inputs in a directory: ``blocks.bin`` (each
block's bytes behind a uvarint length), ``wal/wal`` (the chain's precommits
as ``VoteMessage`` records and an ``#ENDHEIGHT`` marker a height, through
``consensus/wal.WAL``) and ``truncated/wal`` (that WAL cut inside its last
record). Command line, on a directory ``write_inputs`` made::

    python -m tendermint_tpu_torch.tools.bench_native --inputs DIR
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from statistics import median
from typing import List, Optional

import numpy as np

from tendermint_tpu_torch.consensus import messages as msgs
from tendermint_tpu_torch.consensus import wal as wal_mod
from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.crypto.keys import PubKeyEd25519
from tendermint_tpu_torch.encoding import codec
from tendermint_tpu_torch.types.block import Block
from tendermint_tpu_torch.types.part_set import PartSet
from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet

ROOT = Path(__file__).resolve().parents[2]
VALSET_SIZE = 10_000
VALSET_SEED = 30
WAL_MIN_RECORDS = 10_000
SMALL_REPS = 5  # the sub-10 ms calls: the median of this many


def path_name() -> str:
    """'native' when every accelerator is bound, 'python' when none is."""
    natives = (codec.Writer is not codec._PyWriter, merkle._native is not None,
               wal_mod._get_native_scan() is not None)
    if all(natives):
        return "native"
    if not any(natives):
        return "python"
    return f"mixed {natives}"


def write_inputs(out_dir, blocks: List[Block], min_records: int = WAL_MIN_RECORDS) -> dict:
    """The inputs of ``run`` in ``out_dir``: the blocks' bytes and a WAL of
    at least ``min_records`` records (every block's LastCommit, then an
    ``#ENDHEIGHT`` marker, cycling over the chain until there are enough),
    and that WAL cut 7 bytes before its end."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    w = codec.Writer()
    for b in blocks:
        w.bytes(b.marshal())
    framed = w.build()
    (out / "blocks.bin").write_bytes(framed)
    if not any(pc is not None for b in blocks[1:] for pc in b.last_commit.precommits):
        raise ValueError("no precommit in the blocks' LastCommits")
    wal = wal_mod.WAL(str(out / "wal" / "wal"))
    wal.start()
    records = 0
    try:
        while records < min_records:
            for b in blocks[1:]:
                for pc in b.last_commit.precommits:
                    if pc is not None:
                        wal.write(msgs.MsgInfo(msgs.VoteMessage(pc), ""))
                        records += 1
                wal.write(msgs.EndHeightMessage(b.height - 1))
                records += 1
                if records >= min_records:
                    break
    finally:
        wal.stop()
    data = (out / "wal" / "wal").read_bytes()
    (out / "truncated").mkdir(exist_ok=True)
    (out / "truncated" / "wal").write_bytes(data[:-7])
    return {"blocks": len(blocks), "block_bytes": len(framed), "records": records,
            "wal_bytes": len(data)}


def read_blocks(in_dir) -> List[bytes]:
    r = codec.Reader((Path(in_dir) / "blocks.bin").read_bytes())
    raw = []
    while not r.at_end():
        raw.append(r.bytes())
    return raw


def valset() -> ValidatorSet:
    """VALSET_SIZE validators with seeded 32-byte keys and powers."""
    rng = np.random.default_rng(VALSET_SEED)
    keys = rng.bytes(32 * VALSET_SIZE)
    powers = rng.integers(1, 1000, size=VALSET_SIZE)
    return ValidatorSet([Validator(PubKeyEd25519(keys[32 * i: 32 * i + 32]), int(powers[i]))
                         for i in range(VALSET_SIZE)])


def _encode(block: Block) -> bytes:
    w = codec.Writer()
    block.encode(w)  # Block.marshal would hand back a decoded block's wire bytes
    return w.build()


def _wal(path: Path):
    w = wal_mod.WAL(str(path))
    out, err = [], None
    try:
        for tm in w.iter_all():
            out.append(tm)
    except wal_mod.DataCorruptionError as e:
        err = str(e)
    finally:
        w.group.close()
    return out, err


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _small(fn):
    times, out = [], None
    for _ in range(SMALL_REPS):
        out, s = _timed(fn)
        times.append(s)
    return out, median(times)


def _digest(parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(len(p).to_bytes(8, "little"))
        h.update(p)
    return h.hexdigest()


def run(in_dir, ready=None) -> dict:
    """Times (s) and digests of every workload on this interpreter's paths;
    ``ready()``, if given, is called once the inputs are read and returns
    when the timing may start."""
    in_dir = Path(in_dir)
    raw = read_blocks(in_dir)
    vs = valset()
    if ready is not None:
        ready()
    # the collector off while the workloads run (as timeit runs): a
    # collection's pause depends on the heap the process holds, not on the
    # path being timed
    gc.collect()
    gc.disable()
    try:
        return _run(in_dir, raw, vs)
    finally:
        gc.enable()


def _run(in_dir: Path, raw: List[bytes], vs: ValidatorSet) -> dict:
    secs, digest = {}, {}
    blocks, secs["decode"] = _timed(lambda: [Block.decode(codec.Reader(b)) for b in raw])
    digest["decode"] = _digest([b.hash() or b"" for b in blocks]
                               + [pc.signature for b in blocks
                                  for pc in b.last_commit.precommits if pc is not None])
    enc, secs["encode"] = _timed(lambda: [_encode(b) for b in blocks])
    if enc != raw:
        raise AssertionError(f"{path_name()}: a decoded block re-encodes to other bytes")
    digest["encode"] = _digest(enc)
    sets, secs["part_set"] = _timed(lambda: [PartSet.from_data(b) for b in raw])
    digest["part_set"] = _digest([ps.header().hash for ps in sets] + [
        a for ps in sets for i in range(ps.total)
        for a in [ps.get_part(i).proof.leaf_hash] + ps.get_part(i).proof.aunts])
    headers, secs["header_hash"] = _small(lambda: [b.header.hash() for b in blocks])
    digest["header_hash"] = _digest(headers)

    def vs_hash():
        vs._hash = None
        return vs.hash()

    root, secs["valset_hash"] = _small(vs_hash)
    digest["valset_hash"] = root.hex()
    (tms, err), secs["wal"] = _timed(lambda: _wal(in_dir / "wal" / "wal"))
    if err is not None:
        raise AssertionError(f"{path_name()}: the WAL did not decode: {err}")
    digest["wal"] = _digest([tm.time_ns.to_bytes(8, "little") + tm.marshal() for tm in tms])
    t_tms, t_err = _wal(in_dir / "truncated" / "wal")
    digest["truncated"] = f"{len(t_tms)} {t_err}"
    return {"path": path_name(), "seconds": secs, "digest": digest,
            "counts": {"blocks": len(raw), "records": len(tms), "validators": vs.size,
                       "parts": sum(ps.total for ps in sets)}}


class PythonChild:
    """``run`` on the pure-Python paths (``TM_NO_NATIVE_CODEC=1``) in a
    fresh child interpreter, started early so that its imports overlap the
    caller's own work. It reads the inputs, says so (``wait_ready``) and
    waits; ``result`` starts its timing and returns its dict. The caller
    times the natives in its own process between the two, while the child
    is idle."""

    def __init__(self, in_dir, timeout: float = 600.0):
        self.timeout = timeout
        env = dict(os.environ)
        env["TM_NO_NATIVE_CODEC"] = "1"
        env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")])
        self._err = tempfile.TemporaryFile(mode="w+")
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "tendermint_tpu_torch.tools.bench_native", "--inputs",
             str(in_dir), "--barrier"], cwd=ROOT, env=env, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self._err, text=True)
        self._ready = False

    def _fail(self, what: str):
        self.close()
        self._err.seek(0)
        raise RuntimeError(f"bench_native on the Python paths {what}:\n"
                           f"{self._err.read()[-3000:]}")

    def wait_ready(self) -> None:
        if not self._ready:
            if self._proc.stdout.readline().strip() != "ready":
                self._fail("did not start")
            self._ready = True

    def result(self) -> dict:
        self.wait_ready()
        stdout, _ = self._proc.communicate("go\n", timeout=self.timeout)
        if self._proc.returncode != 0:
            self._fail("failed")
        return json.loads(stdout.splitlines()[-1])

    def close(self) -> None:
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()
        for f in (self._proc.stdin, self._proc.stdout):
            if f is not None and not f.closed:
                f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        self._err.close()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--inputs", required=True, help="a directory write_inputs made")
    ap.add_argument("--barrier", action="store_true",
                    help="print 'ready' once the inputs are read, and time after a line "
                         "on stdin")
    args = ap.parse_args(argv)

    def barrier():
        print("ready", flush=True)
        sys.stdin.readline()

    print(json.dumps(run(args.inputs, barrier if args.barrier else None)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
