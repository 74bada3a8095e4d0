"""``DeviceMesh``: a list of torch devices laid out on named axes, and the
two ways the port splits work over it.

Counterpart of the ``jax.sharding.Mesh`` the JAX package passes as
``mesh=`` and of the two shardings it builds on one: the lane axis split
over every mesh axis (``PartitionSpec(tuple(mesh.axis_names))``: the
planner, ``verify_batch``) and a (height, val) window split by the mesh's
two axes (``PartitionSpec("height", "val")``: the commit window).

A mesh may repeat a device: ``DeviceMesh(["cuda:0"] * 4)`` on one card,
``DeviceMesh(["cpu"] * 8, (2, 4), ("height", "val"))`` in the tests. Each
shard is launched on its own device's current stream, one after another,
without a synchronisation between launches, so that shards on distinct
cards overlap; the caller collects them once at the end (``gather``).
A mesh that names ``cuda`` when CUDA is absent raises ``NoCudaDeviceError``,
as ``device.resolve_device`` does; it never falls back to the CPU.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from tendermint_tpu_torch.device import DeviceLike, resolve_device


class DeviceMesh:
    """Devices on named axes. ``devices`` is a numpy object array of
    ``torch.device`` with the mesh's shape (``.size``, ``.shape``, ``.flat``
    as the reference's code reads them); ``axis_names`` a tuple, one name
    an axis. Two meshes are equal when their devices, shape and axis names
    are, so a mesh can key a cache as the reference's does."""

    def __init__(self, devices: Sequence[DeviceLike],
                 shape: Tuple[int, ...] = None,
                 axis_names: Sequence[str] = ("lanes",)):
        devs = [resolve_device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        shape = (len(devs),) if shape is None else tuple(int(s) for s in shape)
        if int(np.prod(shape)) != len(devs):
            raise ValueError(f"shape {shape} does not hold {len(devs)} devices")
        names = tuple(str(a) for a in axis_names)
        if len(names) != len(shape):
            raise ValueError(f"{len(names)} axis names for a {len(shape)}-d mesh")
        arr = np.empty((len(devs),), dtype=object)
        arr[:] = devs
        self.devices = arr.reshape(shape)
        self.axis_names = names

    def _key(self):
        return (tuple(str(d) for d in self.devices.flat), self.devices.shape,
                self.axis_names)

    def __eq__(self, other) -> bool:
        return isinstance(other, DeviceMesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return (f"DeviceMesh({[str(d) for d in self.devices.flat]}, "
                f"shape={self.devices.shape}, axis_names={self.axis_names})")

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat(self) -> List[torch.device]:
        return list(self.devices.flat)

    def on_card(self) -> bool:
        """True when any shard runs on a CUDA device."""
        return any(d.type == "cuda" for d in self.devices.flat)

    def labels(self) -> List[str]:
        """One metric label a shard: the device index (or type, for the
        CPU); a device the mesh repeats gets its occurrence after a ``#``
        ("0#0" .. "0#3" for ``["cuda:0"] * 4``), so that every shard is
        counted on its own."""
        ids = [str(d.index if d.index is not None else d.type) for d in self.devices.flat]
        counts = Counter(ids)
        seen: Counter = Counter()
        out = []
        for i in ids:
            out.append(i if counts[i] == 1 else f"{i}#{seen[i]}")
            seen[i] += 1
        return out

    # -- the lane split ------------------------------------------------------

    def split_rows(self, n: int) -> List[Tuple[int, int]]:
        """Contiguous equal shards [lo, hi) of a padded axis of ``n`` rows,
        one a device in the mesh's flat order; ``n`` must divide evenly.
        Each caller copies its shard's rows to ``flat[k]`` in the layout its
        kernel takes (``pack_device``, ``ed25519_verify.upload``)."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} devices")
        m = n // self.size
        return [(k * m, (k + 1) * m) for k in range(self.size)]

    def gather(self, shards: Sequence[torch.Tensor]) -> torch.Tensor:
        """The shards back in order, concatenated on the first device (the
        one copy a shard makes to it is where a card waits for another)."""
        dev = self.devices.flat[0]
        return torch.cat([s.to(dev) for s in shards])

    # -- the (height, val) split ---------------------------------------------

    def window_shape(self) -> Tuple[int, int]:
        """(height blocks, val blocks): the two axes of a 2-D mesh; a 1-D
        mesh splits heights only."""
        shape = self.devices.shape
        if len(shape) > 2:
            raise ValueError(f"a (height, val) split needs a 1-d or 2-d mesh, not {shape}")
        return (shape[0], shape[1]) if len(shape) == 2 else (shape[0], 1)

    def pad_window(self, H: int, V: int) -> Tuple[int, int]:
        """H and V rounded up to multiples of ``window_shape``."""
        mh, mv = self.window_shape()
        return -(-H // mh) * mh, -(-V // mv) * mv

    def split_window(self, H: int, V: int) -> Iterator[Tuple[torch.device, slice, slice]]:
        """(device, heights, vals) of each (height-block, val-block) shard of
        an (H, V) grid padded by ``pad_window``, in the mesh's flat order."""
        ph, pv = self.pad_window(H, V)
        mh, mv = self.window_shape()
        bh, bv = ph // mh, pv // mv
        devs = self.devices.reshape(mh, mv)
        for i in range(mh):
            for j in range(mv):
                yield devs[i, j], slice(i * bh, (i + 1) * bh), slice(j * bv, (j + 1) * bv)
