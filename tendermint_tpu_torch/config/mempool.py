"""The ``[mempool]`` configuration section.

The port's copy of the JAX package's ``config/config.py`` ``MempoolConfig``:
every field under the same name and with the same default.
``node/verify_root.mempool`` builds the mempool and its batched signature
hook from it. The per-peer QoS fields configure the mempool reactor's
admission control, which is not ported yet; they are kept so that one
``[mempool]`` section configures both packages.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class MempoolConfig:
    recheck: bool = True
    broadcast: bool = True
    wal_path: str = ""
    size: int = 5000
    cache_size: int = 10000
    # -- per-peer QoS (the reactor's). Rates are tokens/s with a burst
    # allowance; rate <= 0 disables that bucket.
    qos_enabled: bool = True
    qos_peer_tx_rate: float = 1000.0
    qos_peer_tx_burst: float = 2000.0
    qos_peer_byte_rate: float = float(1 << 20)  # 1 MiB/s
    qos_peer_byte_burst: float = float(2 << 20)
    qos_global_tx_rate: float = 0.0  # aggregate cap across peers; 0 = off
    qos_global_tx_burst: float = 0.0  # 0 = 2x rate
    # repeat-offender demotion: after `mute_after` violations the peer is
    # muted for mute_base_s * 2^offenses (capped at mute_max_s); a clean
    # stretch of forgive_s after a mute expires resets the offense count
    qos_mute_after: int = 50
    qos_mute_base_s: float = 1.0
    qos_mute_max_s: float = 60.0
    qos_forgive_s: float = 30.0
    # fairness under a contended global bucket: peers above
    # slack * (window grants / n_peers) shed first; under-share peers may
    # overdraft up to fair_reserve tokens (0 = global burst)
    qos_fair_window_s: float = 1.0
    qos_fair_slack: float = 1.5
    qos_fair_reserve: float = 0.0
    # -- priority lanes: ascending priority thresholds; a tx with
    # priority >= lane_bounds[i] rides lane i+1. () = a single lane (a full
    # mempool rejects instead of evicting).
    lane_bounds: tuple = (1, 1024)
    # -- micro-batching: coalesce up to `checktx_batch` CheckTx submissions
    # into one app-conn flush window (1 = flush per tx); recheck_batch
    # chunks the post-commit recheck (0 = one window for the whole round).
    checktx_batch: int = 1
    recheck_batch: int = 0
    # -- batched signature ingest: when > 0 and the app exposes a
    # `tx_sig_extractor`, CheckTx/recheck windows verify tx signatures in
    # one planner TxFeed dispatch (mempool/tx_verify.py) instead of one
    # serial verify per tx inside the app. window_ms bounds how long the
    # feed may coalesce rows from concurrent callers; rows caps the rows of
    # a flush. 0 disables (the app verifies serially).
    tx_batch_window_ms: float = 0.0
    tx_batch_rows: int = 64
