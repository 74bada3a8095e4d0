"""Device choice for the port's entry points.

Counterpart of the JAX package's TPU discovery (``crypto/batch.py``
``_find_tpu_device`` and ``libs/tpu_probe.py``). CUDA discovery does not hang,
so there is no subprocess probe: the device is resolved explicitly, and a
caller that names no device gets ``cuda`` or an error. Nothing here falls
back to the CPU on its own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


class NoCudaDeviceError(RuntimeError):
    """No device was given and no CUDA device is present."""


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    device and raises when CUDA is absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise NoCudaDeviceError(
                "no CUDA device: pass device='cpu' to run the plain versions"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoCudaDeviceError(f"{dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
