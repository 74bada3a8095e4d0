"""The batch-verifier boundary of the port: ``HostBatchVerifier``,
``RLCHostVerifier``, ``TorchBatchVerifier``, ``GuardedBatchVerifier`` and
``verify_generic``.

Counterpart of the JAX package's ``crypto/batch.py`` (``HostBatchVerifier``,
``RLCHostVerifier``, ``TPUBatchVerifier``, ``GuardedBatchVerifier``,
``verify_generic``, ``set_batch_verifier`` / ``get_batch_verifier``, ``verifier_info``). Commit
verification collects every precommit signature of a height and makes one
call: ed25519 signatures go to ``ops.ed25519_cuda.verify_batch`` (K1, K2),
secp256k1 signatures to ``ops.secp256k1_cuda.verify_batch`` (K3), and a
mixed batch is split by key type and scattered back by index. The default
verifier wraps the device verifier in the guard (breaker, deadline, retry,
seeded audit against the host oracles; on the card a failed dispatch
raises rather than completing on the host), and every dispatch is recorded in
the ``tendermint_verify_*`` metrics. A k-of-n multisig aggregate flattens
into the same ed25519 call. With ``ed25519_path="msm"`` (``[verify]
ed25519_path``, ``TM_ED25519_PATH``) ed25519 batches go through
``ops.ed25519_cuda.rlc_verify_batch`` instead: K1, one MSM (K4), and on a
reject K1 + K2 over the batch with host chunk RLCs where a row fails.
"""

from __future__ import annotations

import math
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from tendermint_tpu_torch.crypto import ed25519 as _ed
from tendermint_tpu_torch.crypto import secp256k1 as _secp
from tendermint_tpu_torch.crypto.hashing import sha256
from tendermint_tpu_torch.crypto.keys import PubKeyEd25519, PubKeySecp256k1
from tendermint_tpu_torch.crypto.multisig import PubKeyMultisigThreshold
from tendermint_tpu_torch.device import DeviceLike, resolve_device
from tendermint_tpu_torch.libs import breaker as _brk
from tendermint_tpu_torch.libs import trace
from tendermint_tpu_torch.libs.metrics import get_verify_metrics
from tendermint_tpu_torch.libs.profile import get_profiler
from tendermint_tpu_torch.ops import ed25519_cuda as _kernel
from tendermint_tpu_torch.ops import secp256k1_cuda as _secp_kernel

ED25519_PATHS = ("ladder", "msm")
FE_BACKENDS = ("vpu", "mxu", "mxu16")  # the JAX verifier's values
CARRY_MODES = ("eager", "lazy")


def _record_dispatch(backend: str, algo: str, n: int, t0: float, ok,
                     first: bool = False, fe_backend: str = "",
                     carry_mode: str = "", ed25519_path: str = "") -> None:
    """One VerifyMetrics record per batch dispatch (size, latency, rejects,
    and the fe backend / carry schedule / verify path recorded for it).
    Telemetry must never take down the verify path."""
    try:
        get_verify_metrics().record_dispatch(
            backend, algo, n, time.perf_counter() - t0,
            rejects=n - int(np.count_nonzero(ok)), first=first,
            fe_backend=fe_backend, carry_mode=carry_mode,
            ed25519_path=ed25519_path,
        )
    except Exception:
        pass


# the process-wide [verify] ed25519_path (the configuration root installs it)
_default_ed25519_path: Optional[str] = None


def set_default_ed25519_path(value: Optional[str]) -> None:
    """Install the process-wide ``[verify] ed25519_path`` choice;
    ``TM_ED25519_PATH`` still overrides it. Stored unvalidated: resolution
    is where a bad value raises."""
    global _default_ed25519_path
    _default_ed25519_path = value or None


def _resolve_ed25519_path(explicit: Optional[str]) -> str:
    """The explicit value, else ``TM_ED25519_PATH``, else the installed
    ``[verify]`` value, else "ladder"; "auto" means "ladder"."""
    v = explicit or os.environ.get("TM_ED25519_PATH", "") or \
        _default_ed25519_path or "ladder"
    v = v.strip().lower()
    if v in ("", "auto"):
        return "ladder"
    if v not in ED25519_PATHS:
        raise ValueError(f"ed25519_path must be one of {ED25519_PATHS}, got {v!r}")
    return v


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


class HostBatchVerifier:
    """Serial host verification over the port's oracles: Go-exact ed25519
    (``crypto/ed25519._verify_pure``) and btcec-exact ECDSA
    (``crypto/secp256k1.verify`` after the SHA-256 premix). The guard's
    fallback and audit path."""

    name = "host"

    def verify_ed25519(self, items: Sequence[SigItem]) -> np.ndarray:
        t0 = time.perf_counter()
        with trace.span("verify.dispatch", backend="host", algo="ed25519",
                        n=len(items)):
            ok = np.array(
                [_ed._verify_pure(it.pubkey, it.msg, it.sig) for it in items],
                dtype=bool,
            )
        _record_dispatch("host", "ed25519", len(items), t0, ok)
        return ok

    def verify_ed25519_raw(self, pubs, msgs, sigs) -> np.ndarray:
        """Column form of verify_ed25519."""
        t0 = time.perf_counter()
        verify = _ed._verify_pure
        with trace.span("verify.dispatch", backend="host", algo="ed25519",
                        n=len(pubs)):
            ok = np.fromiter(
                (verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)),
                dtype=bool, count=len(pubs),
            )
        _record_dispatch("host", "ed25519", len(pubs), t0, ok)
        return ok

    def verify_secp256k1(self, items: Sequence[SigItem]) -> np.ndarray:
        """items carry (33-byte compressed key, raw message, DER signature);
        the SHA-256 premix (secp256k1.go:140) happens here."""
        t0 = time.perf_counter()
        with trace.span("verify.dispatch", backend="host", algo="secp256k1",
                        n=len(items)):
            ok = np.array(
                [_secp.verify(it.pubkey, sha256(it.msg), it.sig) for it in items],
                dtype=bool,
            )
        _record_dispatch("host", "secp256k1", len(items), t0, ok)
        return ok


class RLCHostVerifier(HostBatchVerifier):
    """Host batch verification by the random-linear-combination check
    (``ed25519.verify_batch``): one Pippenger MSM a clean batch, with a
    failed batch localized by chunk and re-checked per signature. The
    default backend of the vote and tx feeds off the card, as in the
    reference; secp256k1 items keep the serial host loop."""

    name = "host_rlc"

    def verify_ed25519(self, items: Sequence[SigItem]) -> np.ndarray:
        t0 = time.perf_counter()
        with trace.span("verify.dispatch", backend="host_rlc",
                        algo="ed25519", n=len(items)):
            ok = np.array(
                _ed.verify_batch([(it.pubkey, it.msg, it.sig) for it in items]),
                dtype=bool,
            ) if items else np.zeros((0,), dtype=bool)
        _record_dispatch("host_rlc", "ed25519", len(items), t0, ok)
        return ok

    def verify_ed25519_raw(self, pubs, msgs, sigs) -> np.ndarray:
        t0 = time.perf_counter()
        with trace.span("verify.dispatch", backend="host_rlc",
                        algo="ed25519", n=len(pubs)):
            ok = np.array(
                _ed.verify_batch(list(zip(pubs, msgs, sigs))), dtype=bool,
            ) if len(pubs) else np.zeros((0,), dtype=bool)
        _record_dispatch("host_rlc", "ed25519", len(pubs), t0, ok)
        return ok


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
    integer products) and one carry schedule. With no ``carry_mode`` the
    JAX verifier's is recorded: lazy, but eager for "mxu16".
    ``ed25519_path`` ("ladder": K1 + K2 a signature; "msm": one MSM a
    batch, ``rlc_verify_batch``) resolves as ``_resolve_ed25519_path``
    does: the argument, ``TM_ED25519_PATH``, the ``[verify]`` value, then
    "ladder"."""

    name = "torch"

    def __init__(self, device: DeviceLike = None, fe_backend: Optional[str] = None,
                 carry_mode: Optional[str] = None,
                 ed25519_path: Optional[str] = None):
        self.device = resolve_device(device)
        self.backend = self.device.type
        self.fe_backend = _choice(fe_backend, "vpu", FE_BACKENDS, "fe_backend")
        self.carry_mode = _choice(
            carry_mode, "eager" if self.fe_backend == "mxu16" else "lazy",
            CARRY_MODES, "carry_mode")
        self.ed25519_path = _resolve_ed25519_path(ed25519_path)
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
        with trace.span("verify.dispatch", backend=self.backend,
                        algo="ed25519", n=n):
            pubs_a = np.frombuffer(b"".join(pubs), dtype=np.uint8).reshape(n, 32)
            sigs_a = np.frombuffer(b"".join(sigs), dtype=np.uint8).reshape(n, 64)
            verify = (_kernel.rlc_verify_batch if self.ed25519_path == "msm"
                      else _kernel.verify_batch)
            ok = verify(pubs_a, msgs, sigs_a, device=self.device)
        self._record("ed25519", ok, t0)
        return ok

    def verify_secp256k1(self, items: Sequence[SigItem]) -> np.ndarray:
        """Items carry (33-byte compressed key, raw message, DER signature);
        the SHA-256 premix (secp256k1.go:140) happens here."""
        n = len(items)
        if n == 0:
            return np.zeros((0,), dtype=bool)
        t0 = time.perf_counter()
        with trace.span("verify.dispatch", backend=self.backend,
                        algo="secp256k1", n=n):
            ok = _secp_kernel.verify_batch(
                [it.pubkey for it in items], [sha256(it.msg) for it in items],
                [it.sig for it in items], device=self.device,
            )
        self._record("secp256k1", ok, t0)
        return ok

    def _record(self, algo: str, ok: np.ndarray, t0: float) -> None:
        stats = self.stats[algo]
        first = stats.dispatches == 0
        stats.record(len(ok), time.perf_counter() - t0,
                     len(ok) - int(np.count_nonzero(ok)), first)
        _record_dispatch(self.backend, algo, len(ok), t0, ok, first=first,
                         fe_backend=self.fe_backend, carry_mode=self.carry_mode,
                         ed25519_path=self.ed25519_path if algo == "ed25519" else "")


class GuardedBatchVerifier:
    """Fault-tolerant wrapper around a device BatchVerifier.

    Every dispatch runs the full guard (libs/breaker.py):

      1. breaker gate — open/quarantined diverts straight to the host
         oracle (bit-identical verdicts, just slower);
      2. supervised deadline — a hung device call becomes a fallback,
         not a stalled consensus routine;
      3. bounded retry — one transient failure is retried before the
         window completes on the host;
      4. seeded silent-corruption audit — k sampled lanes per device
         window are re-verified on the host oracle; any disagreement
         quarantines the breaker (operator reset required) and the
         window's verdict is recomputed entirely on the host, so a
         wrong device verdict never escapes this class.

    Every fallback is counted (``tendermint_verify_device_fallback_total``
    by reason) and recorded as a profiler event. While the wrapped device
    is on the card (``breaker.on_card``), nothing completes on the host:
    where the steps above would fall back, the failure is recorded in the
    breaker as before and the call raises ``DeviceDispatchError``
    (``DeviceAuditMismatch`` after a quarantine), so a failing kernel is
    an error, never a host verdict. The wrapped device object only needs
    the BatchVerifier surface (verify_ed25519 / verify_ed25519_raw /
    verify_secp256k1).
    """

    name = "guarded"

    def __init__(self, device, host=None, breaker=None, deadline=None,
                 retries=None, audit_rate=None, audit_seed=None):
        cfg = _brk.guard_config()
        self.device = device
        self.host = host if host is not None else HostBatchVerifier()
        self.breaker = breaker if breaker is not None \
            else _brk.get_device_breaker()
        self.deadline = cfg.dispatch_deadline if deadline is None else deadline
        self.retries = cfg.retries if retries is None else int(retries)
        self.audit_rate = (
            cfg.audit_sample_rate if audit_rate is None else float(audit_rate)
        )
        self.audit_seed = cfg.audit_seed if audit_seed is None else int(audit_seed)
        self.backend = getattr(
            device, "backend", getattr(device, "name", "device")
        )
        self.on_card = _brk.on_card(device)
        self._mtx = threading.Lock()
        self._dispatches = 0
        self._audit_mismatches = 0

    # -- BatchVerifier surface -------------------------------------------------

    def verify_ed25519(self, items: Sequence[SigItem]) -> np.ndarray:
        return self._guard(
            "ed25519", len(items),
            lambda: self.device.verify_ed25519(items),
            lambda: self.host.verify_ed25519(items),
            lambda i: _ed._verify_pure(items[i].pubkey, items[i].msg, items[i].sig),
        )

    def verify_ed25519_raw(self, pubs, msgs, sigs) -> np.ndarray:
        return self._guard(
            "ed25519", len(pubs),
            lambda: self.device.verify_ed25519_raw(pubs, msgs, sigs),
            lambda: self.host.verify_ed25519_raw(pubs, msgs, sigs),
            lambda i: _ed._verify_pure(pubs[i], msgs[i], sigs[i]),
        )

    def verify_secp256k1(self, items: Sequence[SigItem]) -> np.ndarray:
        return self._guard(
            "secp256k1", len(items),
            lambda: self.device.verify_secp256k1(items),
            lambda: self.host.verify_secp256k1(items),
            lambda i: _secp.verify(
                items[i].pubkey, sha256(items[i].msg), items[i].sig
            ),
        )

    # -- guard machinery -------------------------------------------------------

    def _guard(self, algo, n, dev_call, host_call, oracle) -> np.ndarray:
        if n == 0:
            return np.zeros((0,), dtype=bool)
        br = self.breaker
        if not br.allow():
            reason = (
                "quarantined" if br.state == _brk.QUARANTINED
                else "breaker_open"
            )
            return self._without_device(reason, algo, n, host_call)
        attempts = 0
        while True:
            try:
                ok = _brk.supervised_call(
                    dev_call, self.deadline, name=f"batch-{algo}"
                )
                ok = np.asarray(ok, dtype=bool)
            except Exception as e:
                timeout = isinstance(e, _brk.DispatchTimeout)
                reason = "timeout" if timeout else "error"
                br.record_failure(reason)
                attempts += 1
                if attempts <= self.retries and br.allow():
                    try:
                        get_verify_metrics().device_retries.add(1.0)
                    except Exception:
                        pass
                    continue
                return self._without_device(reason, algo, n, host_call, e)
            if self._audit(algo, n, ok, oracle):
                # the device disagrees with the host oracle: safety bug.
                # Quarantine (latched) and recompute the WHOLE window on
                # the host — the sampled lanes say nothing about the rest.
                br.quarantine(f"audit_mismatch:{algo}")
                return self._without_device("audit_mismatch", algo, n, host_call)
            br.record_success()
            return ok

    def _audit(self, algo, n, ok, oracle) -> bool:
        """Cross-check k seeded-sampled lanes against the host oracle.
        Returns True iff any lane disagrees."""
        rate = self.audit_rate
        if rate <= 0 or oracle is None:
            return False
        with self._mtx:
            seq = self._dispatches
            self._dispatches += 1
        k = min(n, max(1, int(math.ceil(n * rate))))
        rng = random.Random((self.audit_seed << 20) ^ seq)
        lanes = rng.sample(range(n), k)
        with trace.span("verify.audit", algo=algo, lanes=k):
            bad = [i for i in lanes if bool(ok[i]) != bool(oracle(i))]
        try:
            m = get_verify_metrics()
            if len(lanes) - len(bad):
                m.device_audit.add(float(len(lanes) - len(bad)), ("ok",))
            if bad:
                m.device_audit.add(float(len(bad)), ("mismatch",))
        except Exception:
            pass
        if bad:
            with self._mtx:
                self._audit_mismatches += len(bad)
            try:
                get_profiler().record_event(
                    "audit_mismatch", algo=algo, backend=self.backend,
                    sampled=len(lanes), mismatches=len(bad),
                    lanes=bad[:8],
                )
            except Exception:
                pass
        return bool(bad)

    def _without_device(self, reason, algo, n, host_call, cause=None) -> np.ndarray:
        """The dispatch has no device verdict. Off the card the whole batch
        completes on the host oracle and counts as a fallback; on the card
        it raises (a profiler ``device_failure`` event, no fallback)."""
        try:
            get_profiler().record_event(
                "device_failure" if self.on_card else "device_fallback",
                reason=reason, algo=algo, n=n, backend=self.backend,
            )
        except Exception:
            pass
        if self.on_card:
            err = (_brk.DeviceAuditMismatch if reason == "audit_mismatch"
                   else _brk.DeviceDispatchError)
            raise err(reason, f"guarded {algo} batch of {n}") from cause
        try:
            get_verify_metrics().device_fallback.add(1.0, (reason,))
        except Exception:
            pass
        return np.asarray(host_call(), dtype=bool)

    def snapshot(self) -> dict:
        with self._mtx:
            return {
                "backend": self.backend,
                "deadline": self.deadline,
                "retries": self.retries,
                "audit_rate": self.audit_rate,
                "dispatches": self._dispatches,
                "audit_mismatches": self._audit_mismatches,
            }


_lock = threading.Lock()
_default = None


def set_batch_verifier(v) -> None:
    global _default
    with _lock:
        _default = v


def get_batch_verifier():
    """The installed verifier, else the one ``TM_BATCH_VERIFIER`` names
    (the reference's deployment knob): ``host`` installs
    ``HostBatchVerifier``, which an operator chose and which is not a
    fallback; ``xla``, ``pallas`` or anything else install
    ``GuardedBatchVerifier`` over a ``TorchBatchVerifier`` on the current
    CUDA device. Without a card that raises ``NoCudaDeviceError``: nothing
    latches the host path."""
    global _default
    with _lock:
        if _default is None:
            if os.environ.get("TM_BATCH_VERIFIER", "").lower() == "host":
                _default = HostBatchVerifier()
            else:
                _default = GuardedBatchVerifier(TorchBatchVerifier())
        return _default


def installed_batch_verifier():
    """The installed verifier, or None; unlike ``get_batch_verifier`` it
    installs nothing."""
    with _lock:
        return _default


def verifier_info() -> dict:
    """The installed default verifier's identity and, for a guarded one,
    its guard's snapshot. The port has no host latch, so
    ``latched_reason`` is always None."""
    with _lock:
        v = _default
    info = {
        "installed": v is not None,
        "name": getattr(v, "name", None) if v is not None else None,
        "backend": getattr(v, "backend", None) if v is not None else None,
        "latched_reason": None,
    }
    if isinstance(v, GuardedBatchVerifier):
        info["guard"] = v.snapshot()
    return info


def _host_fallback(reason: str) -> None:
    try:
        get_verify_metrics().host_fallback.add(1.0, (reason,))
    except Exception:
        pass


def verify_generic(pubkeys: Sequence, msgs: Sequence[bytes],
                   sigs: Sequence[bytes], verifier=None) -> np.ndarray:
    """Batch-verify over key objects, routed as the JAX package routes them:
    a homogeneous ed25519 batch with 64-byte signatures makes one column-form
    call (one ``verify_ed25519`` call over ``SigItem``s where the verifier
    has no column form). Otherwise ed25519 keys with 64-byte signatures go
    to one ``verify_ed25519`` call, and every k-of-n multisig aggregate
    flattens into that call (each flagged signer's sub-signature; the
    aggregate's verdict is the AND over its span); secp256k1 keys go to
    ``verify_secp256k1``. A structurally bad aggregate, or one with fewer
    flagged signers than k, is decided by its ``verify_bytes`` on the host
    (``host_fallback{multisig_structural}``), as is any other key, such as
    an ed25519 key with a signature that is not 64 bytes
    (``{unbatchable_key}``): that host path is the reference's design, not a
    device fallback."""
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
    # (result index, position in ed_items): multisig sub-items interleave
    ed_idx: List[Tuple[int, int]] = []
    ed_items: List[SigItem] = []
    sk_idx: List[int] = []
    sk_items: List[SigItem] = []
    ms_groups: List[Tuple[int, int, int]] = []  # (result index, start, count)
    for i, pk in enumerate(pubkeys):
        if isinstance(pk, PubKeyEd25519) and len(sigs[i]) == 64:
            ed_idx.append((i, len(ed_items)))
            ed_items.append(SigItem(pk.bytes(), msgs[i], sigs[i]))
        elif isinstance(pk, PubKeySecp256k1):
            sk_idx.append(i)
            sk_items.append(SigItem(pk.bytes(), msgs[i], sigs[i]))
        elif isinstance(pk, PubKeyMultisigThreshold):
            flat = pk.flatten(msgs[i], sigs[i])
            if flat is None or len(flat) < pk.k:
                _host_fallback("multisig_structural")
                out[i] = pk.verify_bytes(msgs[i], sigs[i])
                continue
            ms_groups.append((i, len(ed_items), len(flat)))
            ed_items.extend(SigItem(p, m, s) for p, m, s in flat)
        else:
            _host_fallback("unbatchable_key")
            out[i] = pk.verify_bytes(msgs[i], sigs[i])
    if ed_items:
        res = np.asarray(verifier.verify_ed25519(ed_items), dtype=bool)
        for i, pos in ed_idx:
            out[i] = res[pos]
        for i, start, cnt in ms_groups:
            out[i] = bool(res[start: start + cnt].all())
    if sk_items:
        out[sk_idx] = verifier.verify_secp256k1(sk_items)
    return out
