"""Time K1 sources against each other on one card, in turns, on the
10,240-row ed25519 main-path input and over a range of batch sizes, and
count each build's instructions.

    python3 -m tendermint_tpu_torch.tools.k1_compare [name=path.cu ...]

Each ``name=path.cu`` names a K1 source, for example an earlier one from git
(``git show <commit>:tendermint_tpu_torch/ops/csrc/ed25519_prologue.cu``);
``new``, the tree's kernel (``ops/csrc/ed25519_prologue.cu``), comes last
and gets ``ed25519_cuda.k1_geometry``'s launch geometry. Another source
whose launcher takes a geometry is taken to be of the tree's design with
its own ``RPB`` (one thread a row, ``RPB`` rows a block, 128 B of staged
message a row); one whose launcher takes none (one thread a row, 128 rows a
block) is launched as such. The input is a 10,000-validator ed25519 commit's rows,
packed and uploaded as the main path packs them (``k2_compare``), before K1.
Each source is built with the port's nvcc flags (one nvcc each, all at once,
``k3_compare.build``), checked equal to ``prologue_ref`` on all four outputs,
and timed as the mean of 20 launches (CUDA events), in the order given and
then reversed; then at each batch size of ``SCAN`` on rows drawn from the
main-path input, each source checked against ``prologue_ref`` there too.
With ``cuobjdump`` on the path, each build's whole kernel is counted by
instruction class (``sass_mix``: K1 has no window loop). Prints the card's
name and power limit and, last, one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.ops import ed25519_cuda as ec
from tendermint_tpu_torch.tools import k2_compare, k3_compare

NAME = "ed25519_prologue"
# 1,280: a small commit; 10,240: the 10k commit's bucket; 40,960 and
# 163,840: fast-sync windows of 4 and 16 heights of a 10k validator set
SCAN = (1280, 10_240, 40_960, 163_840)
_FUNC = re.compile(r"\s*Function\s*:\s*(\S+)")

_RPB = re.compile(r"constexpr int RPB = (\d+);")


def sass_mix(sass: str) -> Dict[str, int]:
    """Instructions of every kernel in a ``cuobjdump -sass`` listing, by
    class (``k3_compare._klass``), NOPs left out: a static count of the
    whole kernel, not of the instructions a thread runs."""
    c = Counter()
    for line in sass.splitlines():
        m = k3_compare._INSN.match(line)
        if m and not m.group(2).startswith("NOP"):
            c[k3_compare._klass(m.group(2))] += 1
    c["kernels"] = sum(1 for line in sass.splitlines() if _FUNC.match(line))
    return dict(c)


def main(argv: List[str]) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("K1 compare: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    srcs = {name: Path(path) for name, path in (arg.split("=", 1) for arg in argv)}
    srcs["new"] = _build.SRC_DIR / _build.SOURCES[NAME]
    t0 = time.perf_counter()
    built = k3_compare.build(srcs, k3_compare.OUT / NAME, sass_mix)
    print(f"built {len(built)} sources in {time.perf_counter() - t0:.1f} s", flush=True)
    P, I = ctypes.c_void_p, ctypes.c_int
    fns = {}  # name -> (launcher, b -> geometry arguments)
    for name, (lib, lines, mix) in built.items():
        text = srcs[name].read_text()
        fn = getattr(lib, NAME + "_launch")
        fn.restype = I
        fn.argtypes = [P, I, P, I, P, P, P] + [P] * 4 + [I] * (
            5 if "lanes_per_row" in text else 1) + [P]
        if name == "new":
            geometry = ec.k1_geometry
        elif "lanes_per_row" in text:
            rpb = int(_RPB.search(text).group(1))
            geometry = lambda b, rpb=rpb: (1, rpb, -(-b // rpb), 32 * 4 * rpb)
        else:
            geometry = lambda b: ()
        fns[name] = (fn, geometry)
        print(f"  {name}: {'; '.join(lines)}; SASS by class: {mix}", flush=True)

    def launch(name, ins):
        fn, geometry = fns[name]
        tmpl, vidx, vwords, pubw, sigw = ins
        b = sigw.shape[0]
        outs = tuple(torch.empty((n, b), dtype=torch.int32, device=dev)
                     for n in (ec.NWIN, ec.NWIN, ec.NLIMB, 1))
        geo = geometry(b)
        rc = fn(tmpl.data_ptr(), tmpl.shape[0], vidx.data_ptr(), vidx.shape[0],
                vwords.data_ptr(), pubw.data_ptr(), sigw.data_ptr(),
                *(t.data_ptr() for t in outs), b, *geo,
                torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"{name}: cudaError {rc}")
        return outs

    def check_all(ins) -> None:
        want = ec.prologue_ref(*ins)
        for name in fns:
            got = launch(name, ins)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise SystemExit(f"{name} differs from the plain version at b = {ins[4].shape[0]}")

    _, _, _, pubw, sigw, tmpl, vidx, vwords = k2_compare.packed_main_path(dev)
    ins = (tmpl, vidx, vwords, pubw, sigw)
    b = sigw.shape[0]
    check_all(ins)
    print(f"every source == the plain version on all 4 outputs at b = {b} "
          f"(rows {tmpl.shape[0]}, k {vidx.shape[0]})", flush=True)
    times: Dict[str, List[float]] = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        times[name].append(k3_compare.cuda_ms(lambda: launch(name, ins)))
        print(f"  {name}: {times[name][-1]:.4f} ms", flush=True)
    scan = {}
    rng = np.random.default_rng(7)
    for nb in SCAN:  # rows drawn from the main-path input
        idx = torch.from_numpy(rng.integers(0, k3_compare.N_ROWS, nb)).to(dev)
        sub = (tmpl, vidx) + tuple(t[idx].contiguous() for t in (vwords, pubw, sigw))
        check_all(sub)
        order = list(fns) + list(fns)[::-1]
        scan[nb] = {name: [] for name in fns}
        for name in order:
            scan[nb][name].append(k3_compare.cuda_ms(lambda: launch(name, sub), 10))
        print(f"  b = {nb} (exact): " + ", ".join(
            f"{k} {' / '.join(f'{v:.4f}' for v in vs)}" for k, vs in scan[nb].items()), flush=True)
    print(card)
    print(json.dumps({"card": card, "b": b, "times_ms": times, "scan_ms": scan,
                      "sass_mix": {name: mix for name, (_, _, mix) in built.items()},
                      "ptxas": {name: lines for name, (_, lines, _) in built.items()},
                      "geometry": {nb: ec.k1_geometry(nb) for nb in SCAN}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
