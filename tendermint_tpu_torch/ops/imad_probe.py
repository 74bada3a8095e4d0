"""Throughput of the integer multiply the ladder kernels are built from.

``csrc/imad_probe.cu`` runs independent chains of 32x32 -> 64-bit
multiply-adds (IMAD.WIDE.U32), or of 32-bit multiply-adds (IMAD), one
1,024-thread block per SM, and reads each SM's clock around the loop. The
result is products a clock an SM; ``chip_smoke.py`` prices the ladders'
products at the IMAD.WIDE figure, beside the throughput table's 64. A
measurement probe, not a port of a TPU kernel: it has no plain version and
runs only on a CUDA device.
"""

from __future__ import annotations

import ctypes
import statistics
from typing import Dict

import torch

from tendermint_tpu_torch.ops import ed25519_cuda as _ec

NAME = "imad_probe"
THREADS = 1024
PRODUCTS_PER_ITER = THREADS * 16 * 8  # threads x UNROLL x CHAINS, per block

_P = ctypes.c_void_p
_I = ctypes.c_int
# wide, y, iters, cycles, sink, blocks, stream
_ARGTYPES = [_I, ctypes.c_uint, _I, _P, _P, _I, _P]


def products_per_clock(device: torch.device, iters: int = 4096) -> Dict[str, float]:
    """Median over the SMs of products a clock an SM, for IMAD.WIDE
    (``"imad_wide"``) and 32-bit IMAD (``"imad"``); one block per SM."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the probe runs on a CUDA device, not {device}")
    fn = _ec._kernel_fn(NAME, _ARGTYPES)
    blocks = torch.cuda.get_device_properties(device).multi_processor_count
    out = {}
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for key, wide in (("imad_wide", 1), ("imad", 0)):
            cycles = torch.zeros((blocks,), dtype=torch.int64, device=device)
            sink = torch.empty((blocks * THREADS,), dtype=torch.int64, device=device)
            for _ in range(2):  # the first launch warms the clocks up
                rc = fn(wide, 0x9E3779B1, iters, cycles.data_ptr(), sink.data_ptr(),
                        blocks, stream)
                if rc != 0:
                    raise RuntimeError(f"{NAME} launch failed: cudaError {rc}")
            torch.cuda.synchronize(device)
            per_block = PRODUCTS_PER_ITER * iters / cycles.double()
            out[key] = statistics.median(per_block.tolist())
    return out
