"""Where K1's time goes inside a block: the kernel built with its phase
stamps on (``-DK1_TRACE``), run on rows of the 10,000-validator ed25519
commit, with each block's clock at each phase.

    python3 -m tendermint_tpu_torch.tools.k1_trace

For each batch size of ``SIZES`` the traced build is launched on rows drawn
from the main-path input with ``ed25519_cuda.k1_geometry``'s geometry and
checked equal to ``prologue_ref``; then every block's first row reports
``clock64`` at each point of ``POINTS``, less its own start. Prints the
median and the largest over the blocks, in SM clocks, how many blocks each
SM held, and the card's name and power limit. The stamps cost the traced
build a global store each; the kernel the port runs is built without them.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.ops import ed25519_cuda as ec
from tendermint_tpu_torch.tools import k2_compare, k3_compare

SIZES = (1280, 10_240)
# the kernel's K1_STAMP points 1..6 (0 is the block's start, 7 its SM id)
POINTS = {1: "block 0's message staged", 2: "block 0's rounds done",
          3: "last block's rounds done", 4: "q3 done", 5: "r done", 6: "h digits stored"}
NPOINTS, MAX_BLOCKS = 8, 8192  # the stamp array (TRACE_POINTS, TRACE_BLOCKS)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("K1 trace: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    out = k3_compare.OUT / "k1_trace"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "k1_trace.so"
    subprocess.run([_build.nvcc(), *_build.FLAGS, "-DK1_TRACE", "-o", str(so),
                    str(_build.SRC_DIR / _build.SOURCES["ed25519_prologue"])],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.ed25519_prologue_launch
    fn.argtypes, fn.restype = ec._SIGNATURES["ed25519_prologue"], ctypes.c_int
    lib.k1_trace_read.argtypes, lib.k1_trace_read.restype = [ctypes.c_void_p], ctypes.c_int
    _, _, _, pubw, sigw, tmpl, vidx, vwords = k2_compare.packed_main_path(dev)
    rng = np.random.default_rng(7)
    for b in SIZES:
        geo = ec.k1_geometry(b)
        if geo[2] > MAX_BLOCKS:
            raise SystemExit(f"b = {b}: more blocks than the trace holds")
        idx = torch.from_numpy(rng.integers(0, k3_compare.N_ROWS, b)).to(dev)
        ins = (tmpl, vidx) + tuple(t[idx].contiguous() for t in (vwords, pubw, sigw))
        outs = tuple(torch.empty((n, b), dtype=torch.int32, device=dev)
                     for n in (ec.NWIN, ec.NWIN, ec.NLIMB, 1))
        for _ in range(5):  # warm, as the timed launches are; the last one is read
            rc = fn(tmpl.data_ptr(), tmpl.shape[0], vidx.data_ptr(), vidx.shape[0],
                    *(t.data_ptr() for t in ins[2:]), *(t.data_ptr() for t in outs), b, *geo,
                    torch.cuda.current_stream(dev).cuda_stream)
            if rc:
                raise RuntimeError(f"traced K1: cudaError {rc}")
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(outs, ec.prologue_ref(*ins))):
            raise SystemExit(f"traced K1 differs from the plain version at b = {b}")
        stamps = np.zeros((NPOINTS, MAX_BLOCKS), np.int64)
        if lib.k1_trace_read(stamps.ctypes.data_as(ctypes.c_void_p)):
            raise RuntimeError("k1_trace_read failed")
        t = stamps[:, :geo[2]]
        print(f"b = {b}: {geo[2]} blocks of {geo[1]} rows, exact; SM clocks since the "
              f"block's start, median / largest over blocks", flush=True)
        for i, name in POINTS.items():
            d = t[i] - t[0]
            print(f"  {name:28s} {int(np.median(d)):7d} {int(d.max()):7d}")
        on_sm = np.bincount(np.bincount(t[NPOINTS - 1], minlength=132))
        print(f"  SMs by blocks held: {dict((k, int(v)) for k, v in enumerate(on_sm) if v)}",
              flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
