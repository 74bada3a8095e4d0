"""A device fault injected under a running sim net on the card.

``card_fault_scenario(inner, n_ok)`` is a ``sim.scenario.Scenario`` of four
validators with the ``[verify]`` vote feed on (the ``vote_storm`` settings,
no storm, no double-signer) whose nodes share one installed
``GuardedBatchVerifier`` over ``RecordingDevice(FaultyDevice(inner))``: the
device answers ``n_ok`` calls, then fails every call. ``inner`` is the
card's verifier (``TorchBatchVerifier`` on CUDA) in ``chip_smoke.py``, a
host verifier that claims the card in the CPU tests. ``FaultyDevice``
forwards ``inner``'s device, so the guard is on the card and raises
``DeviceDispatchError`` where the reference's would complete on the host:
the node whose flush or LastCommit check meets the fault halts
(``ConsensusState.device_fault``), and since every node of the process
dispatches through the same verifier, so does every node that dispatches
after it. The net stops.

The drive waits for the fault, then for the net to stop (no store grows,
no vote is submitted and no node newly halts for ``QUIET_S``). The check:
at least one node halted, each on ``DeviceDispatchError``; every node that
submitted a vote after the fault halted (its flush met the failing device;
a node that never dispatches again waits for votes its halted peers do not
send); no store passed the highest height a node was deciding when the
fault fired; and every answered call's verdict equals
``HostBatchVerifier``'s on the same inputs. ``run.marks`` records the
consensus heights when the fault fired (``fault``) and when the net had
stopped (``halted``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

import numpy as np

from tendermint_tpu_torch.config.config import test_config
from tendermint_tpu_torch.crypto import batch as _batch
from tendermint_tpu_torch.libs import breaker as _brk
from tendermint_tpu_torch.sim.faults import FaultyDevice
from tendermint_tpu_torch.sim.scenario import Scenario, ScenarioRun

# a separate breaker for the faulty verifier, so that the process's default
# breaker is left closed: a threshold the fault run cannot reach keeps every
# failure a device error (not breaker_open) for the record
FAULT_BREAKER_THRESHOLD = 1000
# how long nothing may move before the net counts as stopped
QUIET_S = 1.5


def _votes_in(node) -> int:
    return node.vote_feed.votes_in if node.vote_feed is not None else 0


class RecordingDevice:
    """The BatchVerifier surface of ``inner``, keeping every answered call
    (its kind, inputs and verdict); a call that raises is not kept. Forwards
    ``inner``'s ``device`` and ``backend``."""

    def __init__(self, inner, on_fault: Optional[Callable[[], None]] = None):
        self.inner = inner
        self.device = getattr(inner, "device", None)
        self.backend = getattr(inner, "backend", "device")
        self.on_fault = on_fault
        self.calls: List[tuple] = []
        self._mtx = threading.Lock()

    def _call(self, kind: str, args: tuple, fn):
        try:
            out = fn()
        except Exception:
            if self.on_fault is not None:
                self.on_fault()
            raise
        with self._mtx:
            self.calls.append((kind, args, np.array(out, dtype=bool, copy=True)))
        return out

    def verify_ed25519(self, items):
        items = list(items)
        return self._call("ed25519", (items,), lambda: self.inner.verify_ed25519(items))

    def verify_ed25519_raw(self, pubs, msgs, sigs):
        args = (list(pubs), list(msgs), list(sigs))
        return self._call("ed25519_raw", args, lambda: self.inner.verify_ed25519_raw(*args))

    def verify_secp256k1(self, items):
        items = list(items)
        return self._call("secp256k1", (items,), lambda: self.inner.verify_secp256k1(items))


def host_disagreements(calls: List[tuple]) -> List[int]:
    """The indices of recorded calls whose verdict differs from
    ``HostBatchVerifier``'s on the same inputs."""
    host = _batch.HostBatchVerifier()
    bad = []
    for i, (kind, args, got) in enumerate(calls):
        fn = {"ed25519": host.verify_ed25519, "ed25519_raw": host.verify_ed25519_raw,
              "secp256k1": host.verify_secp256k1}[kind]
        if not np.array_equal(np.asarray(fn(*args), dtype=bool), got):
            bad.append(i)
    return bad


def _config():
    # the vote_storm scenario's [verify] vote feed
    cfg = test_config()
    cfg.verify.vote_batch_window_ms = 2.0
    cfg.verify.vote_batch_rows = 64
    return cfg


def card_fault_scenario(inner_factory: Callable[[], object], n_ok: int = 8,
                        seed: int = 14, halt_timeout: float = 30.0,
                        wire: Optional[Callable[[ScenarioRun, object], None]] = None
                        ) -> Scenario:
    """The scenario above. ``inner_factory()`` builds the card's verifier;
    ``wire(run, guarded)``, when given, runs after the faulty verifier is
    installed (the CPU tests point the nodes' feeds at it there)."""

    def setup(run: ScenarioRun) -> None:
        def at_fault():
            if "fault" not in run.marks:
                run.fault_votes_in = [_votes_in(n) for n in run.nodes]
                run.mark("fault")

        run.device = FaultyDevice(inner_factory(), seed=seed, fail_rate=1.0,
                                  schedule=["ok"] * n_ok)
        run.recorder = RecordingDevice(run.device, on_fault=at_fault)
        breaker = _brk.CircuitBreaker(name="sim-fault", threshold=FAULT_BREAKER_THRESHOLD)
        run.guarded = _batch.GuardedBatchVerifier(run.recorder, breaker=breaker)
        prev = _batch.installed_batch_verifier()
        _batch.set_batch_verifier(run.guarded)
        run.defer(lambda: _batch.set_batch_verifier(prev))
        if wire is not None:
            wire(run, run.guarded)

    def drive(run: ScenarioRun) -> List[str]:
        if not run.wait_for(lambda: "fault" in run.marks, halt_timeout):
            return [f"the fault never fired: heights {run.heights()}"]

        def state():
            return ([n.block_store.height() for n in run.nodes],
                    [_votes_in(n) for n in run.nodes],
                    [n.cs.device_fault is not None for n in run.nodes])

        # the net has stopped once nothing moves for QUIET_S: no store, no
        # vote submitted, no node newly halted
        deadline = time.monotonic() + halt_timeout
        last, since = state(), time.monotonic()
        while time.monotonic() - since < QUIET_S:
            if time.monotonic() > deadline:
                return [f"the net did not stop: stores, votes in, halted {state()}"]
            time.sleep(0.05)
            now = state()
            if now != last:
                last, since = now, time.monotonic()
        run.mark("halted")
        return []

    def check(run: ScenarioRun) -> List[str]:
        failures = []
        if not run.guarded.on_card:
            failures.append("the guarded verifier over the faulty device is not on the card")
        faults = [n.cs.device_fault for n in run.nodes]
        if not any(faults):
            failures.append("no node halted")
        if not all(f is None or isinstance(f, _brk.DeviceDispatchError) for f in faults):
            failures.append(f"a node halted on something else than DeviceDispatchError: {faults}")
        # every node that submitted a vote after the fault flushed it into
        # the failing device: it halted
        grew = [_votes_in(n) > v for n, v in zip(run.nodes, getattr(run, "fault_votes_in", []))]
        if any(g and f is None for g, f in zip(grew, faults)):
            failures.append(f"a node that dispatched after the fault did not halt: "
                            f"submitted since {grew}, faults {faults}")
        stores = [n.block_store.height() for n in run.nodes]
        at_fault = run.marks.get("fault", {}).get("heights")
        if at_fault is not None and max(stores) > max(at_fault):
            failures.append(f"a node committed past the halt: heights at the fault "
                            f"{at_fault}, stores {stores}")
        if len(run.recorder.calls) != n_ok:
            failures.append(f"{len(run.recorder.calls)} answered calls, not {n_ok}")
        bad = host_disagreements(run.recorder.calls)
        if bad:
            failures.append(f"verdicts before the fault differ from the host's: calls {bad}")
        return failures

    return Scenario(
        name="card_fault",
        description=f"the shared guarded verifier's card device answers {n_ok} calls, "
                    f"then fails: every node halts on DeviceDispatchError, no store grows",
        seed=seed,
        timeout_s=halt_timeout,
        config_factory=_config,
        setup=setup,
        drive=drive,
        check=check,
    )
