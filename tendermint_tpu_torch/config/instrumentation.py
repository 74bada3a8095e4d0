"""The ``[instrumentation]`` configuration section.

The port's copy of the JAX package's ``config/config.py``
``InstrumentationConfig``: every field under the same name and with the
same default. ``node/node.Node`` builds a ``libs/metrics.NodeMetrics`` when
``prometheus`` is on and serves it at the RPC server's ``/metrics`` route
(the reference's node does the same; neither opens
``prometheus_listen_addr``). ``node/verify_root.consensus_state`` reads the
instrument fields: ``flight_recorder`` enables
the state machine's flight recorder (and with it the critical-path and
quorum analyzers), ``watchdog`` builds a ``libs/watchdog.LivenessWatchdog``
and ``telemetry_spool`` a ``libs/telemetry.TelemetrySpool``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class InstrumentationConfig:
    prometheus: bool = False
    prometheus_listen_addr: str = ":26660"
    max_open_connections: int = 3
    namespace: str = "tendermint"
    # consensus flight recorder (consensus/flight.py); TM_FLIGHT=1 also works
    flight_recorder: bool = False
    # liveness watchdog (libs/watchdog.py): stall when no height/round
    # progress for stall_factor × block-interval EWMA (floored at
    # watchdog_min_stall_seconds)
    watchdog: bool = True
    watchdog_interval: float = 1.0
    watchdog_stall_factor: float = 5.0
    watchdog_min_stall_seconds: float = 10.0
    # crash-safe telemetry spool (libs/telemetry.py): a background flusher
    # appends one checksummed snapshot every N heights or T seconds to a
    # rotating segment group under the node root
    telemetry_spool: bool = False
    telemetry_spool_path: str = "data/telemetry/spool"
    telemetry_spool_interval_heights: int = 20
    telemetry_spool_interval_seconds: float = 5.0
    telemetry_spool_head_size_limit: int = 10 * 1024 * 1024
    telemetry_spool_total_size_limit: int = 256 * 1024 * 1024
    telemetry_spool_ring_capacity: int = 256
