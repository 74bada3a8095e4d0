"""The ``[verify]`` configuration section.

The port's copy of the JAX package's ``config/config.py`` ``VerifyConfig``:
every field under the same name and with the same default, so a node's
``[verify]`` section configures the port as it configures the reference.
``node/verify_root.py`` applies it.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class VerifyConfig:
    """[verify] — fault tolerance for the device verification path
    (libs/breaker.py) and the planner's knobs (parallel/planner.py). Mirrors
    GuardConfig's field names so the configuration root can pass this
    section straight to configure_device_guard."""

    # consecutive device failures before the breaker opens
    breaker_threshold: int = 3
    # first open backoff (s); doubles per re-open up to breaker_backoff_max
    breaker_backoff: float = 1.0
    breaker_backoff_max: float = 60.0
    # wall-clock deadline per device dispatch (s); <= 0 disables the
    # supervising worker thread (a hung device then hangs the caller)
    dispatch_deadline: float = 30.0
    # fraction of device lanes cross-checked against the host oracle per
    # window; a mismatch quarantines the device path (operator reset).
    # 0 disables the audit, 1.0 re-verifies every lane on the host.
    audit_sample_rate: float = 0.05
    audit_seed: int = 0
    # retries after a failed device dispatch before host fallback
    retries: int = 1
    # limb-multiplier backend ("vpu", "mxu" or "mxu16"): the reference's
    # choice of TPU multiplier. The port has one (32x32 -> 64 integer
    # products) and records the value; "mxu16" records the eager carry
    # schedule, as the reference derives it.
    fe_backend: str = "vpu"
    # device verify strategy: "ladder" (per-signature double-scalar ladder,
    # K1 + K2) or "msm" (one multi-scalar multiplication a window, K1 + K4,
    # with K1 + K2 over the rows of a rejected window)
    ed25519_path: str = "ladder"
    # WindowPipeline depth: planned windows allowed in flight ahead of the
    # device (planner.pipeline_depth)
    pipeline_depth: int = 2
    # multi-window superdispatch budget: how many independent small windows
    # a LaneFeed flush may fold into one lane tile per device
    # (planner.windows_per_dispatch)
    windows_per_device: int = 4
    # where the per-height segment tallies reduce: "device" (int64
    # index_add_ on the card) or "host" (the step returns only the lane
    # verdicts and the int64 tallies fold on the host). Bit-identical.
    planner_reduce: str = "device"
    # live-vote micro-batcher window (ms); 0 = every vote verifies serially
    # on the host. node/verify_root.vote_feed builds the feed from it (the
    # consensus state that would own the feed is not ported)
    vote_batch_window_ms: float = 0.0
    # vote-set rows per window of a vote-batch flush (vote_feed's max_rows)
    vote_batch_rows: int = 64
