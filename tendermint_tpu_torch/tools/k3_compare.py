"""Time K3 sources against each other on one card, in turns, on the
10,240-row secp256k1 main-path input, and count their window loops'
instructions.

    python3 -m tendermint_tpu_torch.tools.k3_compare [name=path.cu ...]

Each ``name=path.cu`` names a K3 source, for example an earlier one from
git (``git show <commit>:tendermint_tpu_torch/ops/csrc/secp256k1_ladder.cu``);
``new``, the tree's kernel (``ops/csrc/secp256k1_ladder.cu``), comes last.
A source whose launcher takes no geometry (one thread a row, 128 rows a
block) is launched as such. Each source is built with the port's nvcc flags
(one nvcc each, all at once), checked equal to ``ladder_ref`` on ok, X and
Z, and timed as the mean of 20 launches (CUDA events), in the order given
and then reversed, then at a few batch sizes. With ``cuobjdump`` on the
path, each build's window loop is counted by instruction class, per window
and lane (``window_mix``). Prints the card's name and power limit and, last,
one JSON line. ``compare`` does all of this for any ladder kernel that
``Ladder`` describes; ``tools/k2_compare.py`` runs it on K2.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tendermint_tpu_torch.crypto.hashing import sha256
from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.ops import secp256k1_cuda as sc
from tendermint_tpu_torch.testutil import commit as tc

OUT = _build.BUILD_DIR / "compare"
N_ROWS = 10_000
SCAN = (1280, 8448, 10_240, 16_896)  # 8448 = 528 warps: one for each SM sub-partition

WINDOW_TRIPS = (4, 2)  # K3's doubling and addition loops, a window
_INSN = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")


def _klass(op: str) -> str:
    if op.startswith("IMAD.WIDE"):
        return "imad_wide"
    if op.startswith(("IMAD", "IMUL")):
        return "imad"
    if op.startswith("SHFL"):
        return "shfl"
    if op.startswith(("LD", "ST")):
        return "memory"
    if op.startswith(("BRA", "CALL", "RET", "EXIT", "BSSY", "BSYNC", "BAR", "NOP", "WARPSYNC")):
        return "control"
    if op.startswith(("MOV", "CS2R", "S2R", "UMOV", "ULDC", "S2UR")):
        return "move"
    return "alu"


def window_mix(sass: str, trips: Tuple[int, ...] = WINDOW_TRIPS) -> Optional[Dict[str, int]]:
    """Instructions a lane runs per ladder window, by class, from
    ``cuobjdump -sass``: the window loop is the backward branch that holds
    ``len(trips)`` inner loops, which run ``trips`` times each in address
    order (for K3 the 4 doublings of a window, then its 2 additions); a
    CALL adds its callee's body up to its RET. None if the listing has no
    such loop."""
    insns = [(int(m.group(1), 16), m.group(2), m.group(3).strip())
             for m in map(_INSN.match, sass.splitlines()) if m]
    at = {a: i for i, (a, _, _) in enumerate(insns)}
    loops = [(int(arg.split()[0], 16), a) for a, op, arg in insns
             if op.startswith("BRA") and arg and int(arg.split()[0], 16) < a]

    def body(lo: int, hi: int) -> Counter:
        c = Counter()
        for a, op, arg in insns[at[lo]: at[hi] + 1]:
            c[_klass(op)] += 1
            if op.startswith("CALL"):
                start = at[int(arg.split()[0], 16)]
                end = next(i for i in range(start, len(insns)) if insns[i][1].startswith("RET"))
                c.update(_klass(op) for _, op, _ in insns[start: end + 1])
        return c

    for lo, hi in loops:
        inner = sorted((l2, h2) for l2, h2 in loops if lo < l2 and h2 < hi)
        if len(inner) != len(trips):
            continue
        total = body(lo, hi)
        for (l2, h2), n in zip(inner, trips):
            total.update({k: (n - 1) * v for k, v in body(l2, h2).items()})
        return dict(total)
    return None


def build(srcs: Dict[str, Path], out_dir: Path, count: Callable[[str], Optional[dict]],
          ) -> Dict[str, Tuple[ctypes.CDLL, List[str], Optional[dict]]]:
    """name -> (library, ptxas lines, ``count`` of its ``cuobjdump -sass``
    listing, or None without cuobjdump); one nvcc each, into ``out_dir``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build.nvcc(), *_build.FLAGS, "-o", str(out_dir / f"{name}.so"), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, path in srcs.items()}
    dump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc exit {proc.returncode}\n{log}")
        lines = [ln.strip() for ln in log.splitlines() if "registers" in ln or "stack frame" in ln]
        mix = None
        if Path(dump).exists():
            sass = subprocess.run([dump, "-sass", str(out_dir / f"{name}.so")], capture_output=True,
                                  text=True, timeout=300).stdout
            mix = count(sass)
        out[name] = (ctypes.CDLL(str(out_dir / f"{name}.so")), lines, mix)
    return out


def cuda_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # the host enqueues behind a spin, as chip_smoke does
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main_path_inputs(dev: torch.device) -> tuple:
    """The 10,000-validator secp256k1 commit's rows, packed and uploaded."""
    sc_ = tc.build_commit(N_ROWS, key_type="secp256k1")
    pks, msgs, sigs, _ = sc_.valset.collect_commit_sigs(
        sc_.chain_id, sc_.block_id, sc_.height, sc_.commit)
    host, forced = sc.pack_rows([pk.bytes() for pk in pks], [sha256(m) for m in msgs], sigs,
                                sc._bucket(N_ROWS))
    if not (forced[:N_ROWS] == -1).all():
        raise SystemExit("an honest row was decided on the host")
    return sc.upload(host, dev)


class Ladder(NamedTuple):
    """What ``compare`` needs of one ladder kernel."""
    name: str  # the source's name in ``_build.SOURCES``; its launcher is name + "_launch"
    n_inputs: int  # device inputs, which the launcher takes before the outputs
    out_rows: Tuple[int, ...]  # each output's leading dimension; 0 for a (b,) vector
    geometry: Callable[[int], tuple]  # b -> the launcher's geometry arguments
    ref: Callable  # the plain version: inputs -> outputs
    main_path_inputs: Callable[[torch.device], tuple]
    trips: Tuple[Tuple[int, ...], ...]  # window_mix's loop structures, tried in turn


K3 = Ladder(sc.NAME, 8, (0, sc.NLIMB, sc.NLIMB), sc.k3_geometry, sc.ladder_ref,
            main_path_inputs, (WINDOW_TRIPS,))


def compare(kernel: Ladder, argv: List[str]) -> int:
    """Build the tree's ``kernel`` and each ``name=path.cu`` of ``argv``,
    check each equal to the plain version on the main-path input (which the
    plain version must accept on every row), time them in turns and over
    ``SCAN``, and print the card's name and power limit and one JSON line."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{kernel.name} compare: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    srcs = {name: Path(path) for name, path in (arg.split("=", 1) for arg in argv)}
    srcs["new"] = _build.SRC_DIR / _build.SOURCES[kernel.name]
    t0 = time.perf_counter()
    built = build(srcs, OUT / kernel.name, lambda sass: next(
        filter(None, (window_mix(sass, t) for t in kernel.trips)), None))
    print(f"built {len(built)} sources in {time.perf_counter() - t0:.1f} s", flush=True)
    fns = {}
    for name, (lib, lines, mix) in built.items():
        geometry = "lanes_per_row" in srcs[name].read_text()
        fn = getattr(lib, kernel.name + "_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * (kernel.n_inputs + len(kernel.out_rows)) + [
            ctypes.c_int] * (6 if geometry else 2) + [ctypes.c_void_p]
        fns[name] = (fn, geometry)
        print(f"  {name}: {'; '.join(lines)}; window loop a lane: {mix}", flush=True)

    def launch(name, ins):
        fn, geometry = fns[name]
        b, nwin = ins[1].shape[1], ins[3].shape[0]
        outs = tuple(torch.empty((r, b) if r else (b,), dtype=torch.int32, device=dev)
                     for r in kernel.out_rows)
        geo = kernel.geometry(b) if geometry else ()
        rc = fn(*(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs), b, nwin, *geo,
                torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"{name}: cudaError {rc}")
        return outs

    ins = kernel.main_path_inputs(dev)
    want = kernel.ref(*ins)
    if not bool((want[0][:N_ROWS] != 0).all()):
        raise SystemExit("the plain version rejects a main-path row")
    for name in fns:
        got = launch(name, ins)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"{name} differs from the plain version")
    print(f"every source == the plain version on all {len(want)} outputs at "
          f"b = {ins[1].shape[1]}", flush=True)
    times: Dict[str, List[float]] = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        times[name].append(cuda_ms(lambda: launch(name, ins)))
        print(f"  {name}: {times[name][-1]:.4f} ms", flush=True)
    scan = {}
    rng = np.random.default_rng(7)
    for nb in SCAN:  # rows drawn from the main-path input
        idx = torch.from_numpy(rng.integers(0, N_ROWS, nb)).to(dev)
        sub = (ins[0],) + tuple(t[:, idx].contiguous() for t in ins[1:])
        scan[nb] = {name: cuda_ms(lambda: launch(name, sub), 10) for name in fns}
        print(f"  b = {nb}: " + ", ".join(f"{k} {v:.4f}" for k, v in scan[nb].items()),
              flush=True)
    print(card)
    print(json.dumps({"card": card, "b": ins[1].shape[1], "times_ms": times, "scan_ms": scan,
                      "window_mix": {name: built[name][2] for name in fns},
                      "ptxas": {name: built[name][1] for name in fns}}))
    return 0


if __name__ == "__main__":
    sys.exit(compare(K3, sys.argv[1:]))
