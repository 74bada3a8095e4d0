"""The deterministic prefix of a ``baseline_determinism`` run.

Frozen clocks make a block a pure function of the chain only while each
height commits at round 0 (``sim.round0_clean_top``) and every precommit
reaches the next block stamped at the block's time + iota. Two wall-clock
races break the second at round 0 all the same: a validator that signs its
precommit before it holds the block's parts stamps the frozen clock instead
of the block's time + iota (``ConsensusState._vote_time_ns``), and a
proposer that waited out ``timeout_commit`` for the last precommit
proposes without it. ``recording_canonical_commits`` wraps a scenario's
check to record the heights whose block carries such a LastCommit;
``deterministic_top`` cuts the round-0-clean prefix below the first. Both
read only the nodes' block stores, so they serve a reference run too.
"""

from __future__ import annotations

from typing import Callable, Tuple

# baseline_determinism's [consensus] blocktime_iota (1 s)
IOTA_NS = 1_000_000_000


def not_canonical_heights(nodes, iota_ns: int = IOTA_NS) -> list:
    """The heights h of any node's store whose block's LastCommit misses a
    precommit or stamps one otherwise than block h - 1's time + iota."""
    bad = set()
    for n in nodes:
        for h in range(2, n.block_store.height() + 1):
            want = n.block_store.load_block(h - 1).header.time_ns + iota_ns
            if any(pc is None or pc.timestamp_ns != want
                   for pc in n.block_store.load_block(h).last_commit.precommits):
                bad.add(h)
    return sorted(bad)


def recording_canonical_commits(scenario):
    """``scenario`` whose check also records ``not_canonical_heights`` of
    its nodes as ``scenario.not_canonical``."""
    check_ = scenario.check

    def check(run):
        scenario.not_canonical = not_canonical_heights(run.nodes)
        return check_(run) if check_ is not None else []

    scenario.check = check
    return scenario


def deterministic_top(result, scenario, round0_clean_top: Callable) -> int:
    """``round0_clean_top(result)`` cut below the first height the wrapped
    ``scenario`` recorded as not canonical."""
    top = round0_clean_top(result)
    bad = getattr(scenario, "not_canonical", [])
    return min(top, bad[0] - 1) if bad else top


def deterministic_run(run_scenario, make_scenario, round0_clean_top: Callable,
                      **kwargs) -> Tuple[object, int]:
    """One run of ``make_scenario()`` (baseline_determinism) and the top of
    its deterministic prefix."""
    scenario = recording_canonical_commits(make_scenario())
    result = run_scenario(scenario, **kwargs)
    return result, deterministic_top(result, scenario, round0_clean_top)
