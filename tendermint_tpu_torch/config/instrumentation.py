"""The ``[instrumentation]`` configuration section's consensus instruments.

The port's copy of the instrument fields of the JAX package's
``config/config.py`` ``InstrumentationConfig``: each under the same name
and with the same default. The port has no Prometheus listener yet, so the
section's ``prometheus*`` and ``namespace`` fields are not copied.
``node/verify_root.consensus_state`` reads it: ``flight_recorder`` enables
the state machine's flight recorder (and with it the critical-path and
quorum analyzers), ``watchdog`` builds a ``libs/watchdog.LivenessWatchdog``
and ``telemetry_spool`` a ``libs/telemetry.TelemetrySpool``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class InstrumentationConfig:
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
