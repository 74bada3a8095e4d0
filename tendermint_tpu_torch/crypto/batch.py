"""The batch-verifier boundary of the port: ``TorchBatchVerifier`` and
``verify_generic``.

Counterpart of the JAX package's ``crypto/batch.py`` (``TPUBatchVerifier``,
``verify_generic``, ``set_batch_verifier`` / ``get_batch_verifier``). Commit
verification collects every precommit signature of a height and makes one
call; homogeneous ed25519 batches go to ``ops.ed25519_cuda.verify_batch``.
What later slices port raises ``NotImplementedError`` naming the ROADMAP
item, rather than running a host loop in its place.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np

from tendermint_tpu_torch.crypto.keys import PubKeyEd25519
from tendermint_tpu_torch.device import DeviceLike, resolve_device
from tendermint_tpu_torch.ops import ed25519_cuda as _kernel

ED25519_PATHS = ("ladder", "msm")
FE_BACKENDS = ("vpu", "mxu", "mxu16")  # the JAX verifier's values
CARRY_MODES = ("eager", "lazy")


def _choice(value: Optional[str], default: str, allowed, name: str) -> str:
    v = (value or default).strip().lower()
    v = default if v == "auto" else v
    if v not in allowed:
        raise ValueError(f"{name} must be one of {allowed}, got {v!r}")
    return v


class SigItem(NamedTuple):
    pubkey: bytes  # raw 32-byte ed25519 key
    msg: bytes
    sig: bytes


@dataclass
class DispatchStats:
    """Plain counters of the dispatches a verifier served. The first
    dispatch pays the kernel build and the key upload, so its seconds are
    kept apart as warm-up."""

    dispatches: int = 0
    signatures: int = 0
    rejects: int = 0
    seconds: float = 0.0
    warmup_seconds: float = 0.0

    def record(self, n: int, seconds: float, rejects: int, first: bool) -> None:
        self.dispatches += 1
        self.signatures += n
        self.rejects += rejects
        if first:
            self.warmup_seconds += seconds
        else:
            self.seconds += seconds


class TorchBatchVerifier:
    """Batched ed25519 verification on a torch device (``cuda`` unless the
    caller passes ``device="cpu"``, which runs the kernels' plain versions).

    ``fe_backend`` and ``carry_mode`` are accepted with the JAX verifier's
    values and recorded; the port has one limb multiplier (32x32 -> 64
    integer products) and one carry schedule.
    ``ed25519_path="msm"`` is not ported yet."""

    name = "torch"

    def __init__(self, device: DeviceLike = None, fe_backend: Optional[str] = None,
                 carry_mode: Optional[str] = None,
                 ed25519_path: Optional[str] = None):
        self.device = resolve_device(device)
        self.backend = self.device.type
        self.fe_backend = _choice(fe_backend, "vpu", FE_BACKENDS, "fe_backend")
        self.carry_mode = _choice(carry_mode, "lazy", CARRY_MODES, "carry_mode")
        path = _choice(ed25519_path, "ladder", ED25519_PATHS, "ed25519_path")
        if path == "msm":
            raise NotImplementedError(
                "ed25519_path='msm' is ported by ROADMAP queue 1 item 6 (the MSM path)"
            )
        self.ed25519_path = path
        self.stats = DispatchStats()

    def verify_ed25519(self, items: Sequence[SigItem]) -> np.ndarray:
        return self.verify_ed25519_raw(
            [it.pubkey for it in items], [it.msg for it in items],
            [it.sig for it in items],
        )

    def verify_ed25519_raw(self, pubs, msgs, sigs) -> np.ndarray:
        """Column form: raw 32-byte keys, messages, 64-byte signatures."""
        n = len(pubs)
        if n == 0:
            return np.zeros((0,), dtype=bool)
        t0 = time.perf_counter()
        first = self.stats.dispatches == 0
        pubs_a = np.frombuffer(b"".join(pubs), dtype=np.uint8).reshape(n, 32)
        sigs_a = np.frombuffer(b"".join(sigs), dtype=np.uint8).reshape(n, 64)
        ok = _kernel.verify_batch(pubs_a, msgs, sigs_a, device=self.device)
        self.stats.record(n, time.perf_counter() - t0,
                          n - int(np.count_nonzero(ok)), first)
        return ok

    def verify_secp256k1(self, items):
        raise NotImplementedError(
            "secp256k1 verification is ported by ROADMAP queue 1 item 7"
        )


_lock = threading.Lock()
_default = None


def set_batch_verifier(v) -> None:
    global _default
    with _lock:
        _default = v


def get_batch_verifier():
    """The installed verifier, else a ``TorchBatchVerifier`` on the current
    CUDA device (which raises when there is none)."""
    global _default
    with _lock:
        if _default is None:
            _default = TorchBatchVerifier()
        return _default


def verify_generic(pubkeys: Sequence[PubKeyEd25519], msgs: Sequence[bytes],
                   sigs: Sequence[bytes], verifier=None) -> np.ndarray:
    """Batch-verify over key objects. Homogeneous ed25519 batches with
    64-byte signatures go to the verifier in one call; other keys are
    ported with the secp256k1 and multisig paths."""
    if not all(type(pk) is PubKeyEd25519 for pk in pubkeys):
        raise NotImplementedError(
            "non-ed25519 keys are ported by ROADMAP queue 1 item 7 (secp256k1)"
        )
    if not all(len(s) == 64 for s in sigs):
        # Go rejects a signature of the wrong length without hashing it
        ok = np.zeros((len(sigs),), dtype=bool)
        idx = [i for i, s in enumerate(sigs) if len(s) == 64]
        if idx:
            ok[idx] = verify_generic([pubkeys[i] for i in idx],
                                     [msgs[i] for i in idx],
                                     [sigs[i] for i in idx], verifier)
        return ok
    if verifier is None:
        verifier = get_batch_verifier()
    return np.asarray(
        verifier.verify_ed25519_raw([pk.bytes() for pk in pubkeys], msgs, sigs),
        dtype=bool,
    )
