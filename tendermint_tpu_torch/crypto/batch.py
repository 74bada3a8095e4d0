"""The batch-verifier boundary of the port: ``TorchBatchVerifier`` and
``verify_generic``.

Counterpart of the JAX package's ``crypto/batch.py`` (``TPUBatchVerifier``,
``verify_generic``, ``set_batch_verifier`` / ``get_batch_verifier``). Commit
verification collects every precommit signature of a height and makes one
call: ed25519 signatures go to ``ops.ed25519_cuda.verify_batch`` (K1, K2),
secp256k1 signatures to ``ops.secp256k1_cuda.verify_batch`` (K3), and a
mixed batch is split by key type and scattered back by index. What later
slices port (multisig keys, the MSM path) raises ``NotImplementedError``
naming the ROADMAP item, rather than running a host loop in its place.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np

from tendermint_tpu_torch.crypto.hashing import sha256
from tendermint_tpu_torch.crypto.keys import PubKeyEd25519, PubKeySecp256k1
from tendermint_tpu_torch.device import DeviceLike, resolve_device
from tendermint_tpu_torch.ops import ed25519_cuda as _kernel
from tendermint_tpu_torch.ops import secp256k1_cuda as _secp_kernel

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
    pubkey: bytes  # raw 32-byte ed25519 key or 33-byte compressed secp256k1
    msg: bytes
    sig: bytes


@dataclass
class DispatchStats:
    """Plain counters of the dispatches a verifier served for one
    algorithm. The first dispatch pays the kernel build and the key upload,
    so its seconds are kept apart as warm-up."""

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


ALGORITHMS = ("ed25519", "secp256k1")


class TorchBatchVerifier:
    """Batched ed25519 and secp256k1 verification on a torch device
    (``cuda`` unless the caller passes ``device="cpu"``, which runs the
    kernels' plain versions). ``stats`` keeps one ``DispatchStats`` per
    algorithm, so each algorithm's first dispatch counts as its warm-up.

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
        self.stats: Dict[str, DispatchStats] = {a: DispatchStats() for a in ALGORITHMS}

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
        pubs_a = np.frombuffer(b"".join(pubs), dtype=np.uint8).reshape(n, 32)
        sigs_a = np.frombuffer(b"".join(sigs), dtype=np.uint8).reshape(n, 64)
        ok = _kernel.verify_batch(pubs_a, msgs, sigs_a, device=self.device)
        self._record("ed25519", ok, t0)
        return ok

    def verify_secp256k1(self, items: Sequence[SigItem]) -> np.ndarray:
        """Items carry (33-byte compressed key, raw message, DER signature);
        the SHA-256 premix (secp256k1.go:140) happens here."""
        n = len(items)
        if n == 0:
            return np.zeros((0,), dtype=bool)
        t0 = time.perf_counter()
        ok = _secp_kernel.verify_batch(
            [it.pubkey for it in items], [sha256(it.msg) for it in items],
            [it.sig for it in items], device=self.device,
        )
        self._record("secp256k1", ok, t0)
        return ok

    def _record(self, algo: str, ok: np.ndarray, t0: float) -> None:
        stats = self.stats[algo]
        stats.record(len(ok), time.perf_counter() - t0,
                     len(ok) - int(np.count_nonzero(ok)), stats.dispatches == 0)


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


def verify_generic(pubkeys: Sequence, msgs: Sequence[bytes],
                   sigs: Sequence[bytes], verifier=None) -> np.ndarray:
    """Batch-verify over key objects, routed as the JAX package routes them:
    a homogeneous ed25519 batch with 64-byte signatures makes one column-form
    call (one ``verify_ed25519`` call over ``SigItem``s where the verifier
    has no column form); otherwise ed25519 keys with 64-byte signatures go to
    ``verify_ed25519`` (any other length is False: Go rejects it without
    hashing), secp256k1 keys to ``verify_secp256k1``, and the verdicts are
    scattered back by index."""
    if verifier is None:
        verifier = get_batch_verifier()
    if all(type(pk) is PubKeyEd25519 for pk in pubkeys) and all(
        len(s) == 64 for s in sigs
    ):
        raw = getattr(verifier, "verify_ed25519_raw", None)
        if raw is not None:
            return np.asarray(raw([pk.bytes() for pk in pubkeys], msgs, sigs), dtype=bool)
        items = [SigItem(pk.bytes(), m, s) for pk, m, s in zip(pubkeys, msgs, sigs)]
        return np.asarray(verifier.verify_ed25519(items), dtype=bool)
    out = np.zeros((len(pubkeys),), dtype=bool)
    ed_idx, ed_items, sk_idx, sk_items = [], [], [], []
    for i, pk in enumerate(pubkeys):
        if isinstance(pk, PubKeyEd25519):
            if len(sigs[i]) == 64:
                ed_idx.append(i)
                ed_items.append(SigItem(pk.bytes(), msgs[i], sigs[i]))
        elif isinstance(pk, PubKeySecp256k1):
            sk_idx.append(i)
            sk_items.append(SigItem(pk.bytes(), msgs[i], sigs[i]))
        else:
            raise NotImplementedError(
                f"{type(pk).__name__} keys (multisig routing) are ported by "
                "ROADMAP queue 1 item 9"
            )
    if ed_items:
        out[ed_idx] = verifier.verify_ed25519(ed_items)
    if sk_items:
        out[sk_idx] = verifier.verify_secp256k1(sk_items)
    return out
