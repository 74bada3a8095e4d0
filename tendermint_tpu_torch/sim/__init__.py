"""Deterministic chaos/Byzantine simulation harness; the port's copy of the
reference package's ``sim/``.

Runs N real ConsensusStates (mempool, evidence pool, evidence reactor
included) over an in-proc simulated transport (``p2p/inproc.py`` +
``SimNet``), with seeded per-link fault injection, partitions, clock skew,
validator churn, and Byzantine signer wrappers. ``scenario.py`` is the
timed fault-schedule DSL; ``scenarios.py`` the named scenario matrix that
``tools/chaos_smoke.py`` executes. A net runs on the card unless the caller
passes ``device="cpu"``: its vote and tx feeds and its LastCommit checks
then go to the installed verifier (K1 + K2, K3).
"""

from tendermint_tpu_torch.sim.byzantine import EquivocatingPV
from tendermint_tpu_torch.sim.clock import SimClock
from tendermint_tpu_torch.sim.faults import FaultyDevice
from tendermint_tpu_torch.sim.node import SimNode, build_sim_net
from tendermint_tpu_torch.sim.scenario import (
    FaultOp,
    Scenario,
    ScenarioResult,
    round0_clean_top,
    run_scenario,
)
from tendermint_tpu_torch.sim.scenarios import SCENARIOS
from tendermint_tpu_torch.sim.simnet import LinkPolicy, SimNet

__all__ = [
    "EquivocatingPV",
    "FaultOp",
    "FaultyDevice",
    "LinkPolicy",
    "SCENARIOS",
    "Scenario",
    "ScenarioResult",
    "SimClock",
    "SimNet",
    "SimNode",
    "build_sim_net",
    "round0_clean_top",
    "run_scenario",
]
