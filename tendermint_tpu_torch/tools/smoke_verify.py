"""The verify path an operator smoke runs on, and its proof that the run
reached the card.

Every smoke of this package (``statesync_smoke``, ``flight_smoke``,
``critpath_smoke``, ``quorum_smoke``, ``soak_smoke``,
``bench_commit_path``) takes ``--device``, ``cuda`` by default, and runs
its nets inside ``SmokeVerify``:

  * on the card it installs a default ``[verify]`` root of its own
    (``verify_root.configure_verify``, which builds the kernels first)
    before any net is built, so every vote-feed flush, LastCommit check,
    trust hop and backfill window goes to the root's guarded verifier
    and executor (K1 + K2, the K7 tally);
  * with ``--device cpu`` it installs ``HostBatchVerifier`` and an
    executor that runs each window on it (``verify_root.install_host_verify``),
    as the reference's CPU runs verify;
  * without a card and without ``--device cpu`` it raises
    ``NoCudaDeviceError``.

On leaving it puts back the verifier and the executor it found installed.
On the card ``card_failures()`` names what keeps the run from counting as
one that reached the card: no K1 or no K2 launch since the start
(``ops/ed25519_cuda.launches``, reset on entry), a device fallback, a
breaker not closed, an audit mismatch. A device fault is not caught here:
on the card the path halts on it, and the smoke fails.
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
import time
from typing import Dict, List

from tendermint_tpu_torch.crypto import batch as _batch
from tendermint_tpu_torch.device import DeviceLike, resolve_device
from tendermint_tpu_torch.libs import breaker as _brk
from tendermint_tpu_torch.libs.metrics import get_verify_metrics
from tendermint_tpu_torch.node import verify_root
from tendermint_tpu_torch.ops import ed25519_cuda
from tendermint_tpu_torch.parallel import planner

K1_K2 = ("ed25519_prologue", "ed25519_ladder")


def _fallbacks() -> float:
    return sum(get_verify_metrics().device_fallback._values.values())


def _mismatches() -> float:
    return get_verify_metrics().device_audit._values.get(("mismatch",), 0.0)


class SmokeVerify:
    """``with SmokeVerify(args.device) as sv:`` around a smoke's nets."""

    def __init__(self, device: DeviceLike):
        self.device = resolve_device(device)  # no card: NoCudaDeviceError
        self.on_card = self.device.type == "cuda"
        self.root = None

    def __enter__(self) -> "SmokeVerify":
        self._prev = (_batch.installed_batch_verifier(), planner._device_executor)
        if self.on_card:
            self.root = verify_root.configure_verify(None, self.device)
        else:
            verify_root.install_host_verify()
        self._fallbacks0 = _fallbacks()
        self._mismatches0 = _mismatches()
        ed25519_cuda.reset_launches()
        return self

    def __exit__(self, *exc) -> None:
        verifier, executor = self._prev
        if verifier is None and executor is None:
            verify_root.reset_verify()
        else:
            _batch.set_batch_verifier(verifier)
            planner.set_device_executor(executor)

    def launches(self) -> Dict[str, int]:
        """K1 and K2 launches since entry."""
        return {name: ed25519_cuda.launches[name] for name in K1_K2}

    def card_failures(self) -> List[str]:
        """Empty when the run reached the card cleanly (always, off it)."""
        if not self.on_card:
            return []
        out = []
        launches = self.launches()
        if not all(launches[name] > 0 for name in K1_K2):
            out.append(f"the run never reached the card: K1 + K2 launches {launches}")
        fell_back = _fallbacks() - self._fallbacks0
        if fell_back:
            out.append(f"{fell_back:g} device dispatch(es) fell back to the host: "
                       f"{get_verify_metrics().device_fallback._values}")
        state = _brk.get_device_breaker().state
        if state != _brk.CLOSED:
            out.append(f"the device breaker is {state}")
        if _mismatches() > self._mismatches0:
            out.append(f"{_mismatches() - self._mismatches0:g} audit mismatch(es)")
        return out

    def summary(self) -> str:
        if not self.on_card:
            return "on the host (HostBatchVerifier)"
        k1, k2 = (self.launches()[name] for name in K1_K2)
        return (f"on {self.device}: K1 {k1}, K2 {k2} launches through the "
                f"root's guarded verifier")


def finish(tag: str, out: dict, failures: list, t0: float) -> dict:
    """A smoke's result: ``out`` with its failures, ``ok`` and the seconds
    since ``t0`` (``time.perf_counter``); the failures go to stderr."""
    out.update(failures=failures, ok=not failures, seconds=time.perf_counter() - t0)
    for f in failures:
        print(f"[{tag}] FAIL: {f}", file=sys.stderr)
    if not failures:
        print(f"[{tag}] OK", flush=True)
    return out


def write_round(round_dir: str, prefix: str, payload: dict, tag: str) -> str:
    """The next ``<prefix>_rNN.json`` under ``round_dir``, as the
    reference's scripts write their rounds."""
    pat = re.compile(rf"{prefix}_r(\d+)\.json$")
    ns = [int(m.group(1)) for p in glob.glob(os.path.join(round_dir, f"{prefix}_r*.json"))
          if (m := pat.search(os.path.basename(p)))]
    path = os.path.join(round_dir, f"{prefix}_r{max(ns, default=0) + 1:02d}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    print(f"[{tag}] round -> {path}", flush=True)
    return path
