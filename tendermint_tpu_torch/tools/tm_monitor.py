"""tm-monitor — multi-node health/uptime dashboard
(ref: tools/tm-monitor/monitor/monitor.go:21, node.go, network.go).

Tracks N nodes over RPC + websocket NewBlock events: per-node height,
latency, uptime %, and network-wide health (all nodes online + heights in
agreement). A /metrics scrape per poll feeds verify-dispatch latency and
p2p traffic columns. Renders a refreshing table, or JSON snapshots with
--json; offline nodes carry the last error and downtime duration instead
of silently flipping `online`.

The port's copy of the reference package's ``tools/tm_monitor.py``, over
the port's ``rpc/client.HTTPClient`` and ``WSEventClient`` and the metric
families its ``libs/metrics.py`` exports: on a port node on the card the
VERIFY column reads ``ladder`` (the devices' windows) and the DEVICE column
the guard's breaker.

Usage:
    python -m tendermint_tpu_torch.tools.tm_monitor tcp://127.0.0.1:26657,tcp://...
"""

from __future__ import annotations

import argparse
import http.client
import json
import sys
import threading
import time
from typing import Dict, List, Optional
from urllib.parse import urlparse

from tendermint_tpu_torch.rpc.client import HTTPClient, WSEventClient


def _scrape_metrics(addr: str, timeout: float = 3.0) -> Dict[str, float]:
    """Raw GET of /metrics (the JSON-RPC client can't — exposition is plain
    text).  Returns {metric_key: value} where labeled series key as
    `name{labels}`; histograms contribute their _sum/_count series."""
    u = urlparse(addr if "//" in addr else f"tcp://{addr}")
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    try:
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        if resp.status != 200:
            return {}
        text = resp.read().decode("utf-8", "replace")
    finally:
        conn.close()
    out: Dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        try:
            key, val = line.rsplit(None, 1)
            out[key] = float(val)
        except ValueError:
            continue
    return out


def _sum_family(metrics: Dict[str, float], name: str) -> float:
    """Total across every series of a (possibly labeled) family."""
    total = 0.0
    for k, v in metrics.items():
        if k == name or k.startswith(name + "{"):
            total += v
    return total


# commit-path phase -> CRIT column abbreviation (critpath.PHASES order)
_CRIT_ABBREV = {
    "propose_wait": "prop",
    "block_parts": "parts",
    "prevote_quorum": "prevote",
    "precommit_quorum": "precommit",
    "wal_append": "wal",
    "wal_fsync": "fsync",
    "abci_exec": "exec",
    "commit_persist": "persist",
}


def _phase_label(key: str, family: str) -> Optional[str]:
    """Extract phase="..." from `family{...}` series keys."""
    if not key.startswith(family + "{"):
        return None
    i = key.find('phase="')
    if i < 0:
        return None
    j = key.find('"', i + 7)
    return key[i + 7 : j] if j > i else None


def _verify_path(metrics: Dict[str, float]) -> str:
    """Which ed25519 verify strategy served device windows, from the
    `ed25519_path` label of verify_fe_backend_total: "ladder", "msm",
    "mixed" when both appear, "-" when no device dispatch recorded."""
    fam = "tendermint_verify_fe_backend_total{"
    seen = set()
    for k, v in metrics.items():
        if not k.startswith(fam) or v <= 0:
            continue
        i = k.find('ed25519_path="')
        if i < 0:
            continue
        j = k.find('"', i + 14)
        if j > i:
            seen.add(k[i + 14 : j])
    if not seen:
        return "-"
    if len(seen) > 1:
        return "mixed"
    return seen.pop()


def _quorum_column(metrics: Dict[str, float]) -> str:
    """Mean time-to-strict-2/3 quorum across vote kinds, from the
    quorum_time_to_two_thirds_seconds family's _sum/_count; "-" when the
    quorum observatory has no samples (flight recorder off)."""
    fam = "tendermint_consensus_quorum_time_to_two_thirds_seconds"
    total = _sum_family(metrics, fam + "_sum")
    count = _sum_family(metrics, fam + "_count")
    if count <= 0:
        return "-"
    return f"{1e3 * total / count:.0f}ms"


def _spool_column(metrics: Dict[str, float]) -> str:
    """Telemetry-spool health from the tendermint_telemetry_* families:
    `N@SIZE` (snapshots written @ on-disk bytes), suffixed `!E` when any
    write/drop errors accumulated; "-" when the spool is not running."""
    snaps = _sum_family(metrics, "tendermint_telemetry_snapshots_total")
    size = _sum_family(metrics, "tendermint_telemetry_spool_bytes")
    if snaps <= 0 and size <= 0:
        return "-"
    errs = _sum_family(
        metrics, "tendermint_telemetry_write_errors_total"
    ) + _sum_family(metrics, "tendermint_telemetry_dropped_snapshots_total")
    out = f"{snaps:.0f}@{_fmt_bytes(size)}"
    return f"{out}!{errs:.0f}" if errs > 0 else out


def _crit_column(metrics: Dict[str, float]) -> str:
    """Dominant commit-path phase from the height_phase_seconds family:
    `phase avg_ms` where avg is the per-height mean of the phase with the
    largest accumulated seconds; "-" when the family has no samples."""
    fam = "tendermint_consensus_height_phase_seconds"
    sums: Dict[str, float] = {}
    counts: Dict[str, float] = {}
    for k, v in metrics.items():
        phase = _phase_label(k, fam + "_sum")
        if phase is not None:
            sums[phase] = sums.get(phase, 0.0) + v
            continue
        phase = _phase_label(k, fam + "_count")
        if phase is not None:
            counts[phase] = counts.get(phase, 0.0) + v
    live = {p: s for p, s in sums.items() if counts.get(p, 0) > 0}
    if not live:
        return "-"
    top = max(live, key=live.get)
    avg_ms = 1e3 * live[top] / counts[top]
    return f"{_CRIT_ABBREV.get(top, top)} {avg_ms:.0f}ms"


class NodeMonitor:
    """One node's live stats (monitor/node.go)."""

    def __init__(self, addr: str):
        self.addr = addr
        self.online = False
        self.moniker = "?"
        self.network = "?"
        self.height = 0
        self.block_latency_ms = 0.0
        # offline diagnostics: why and since when (monotonic)
        self.last_error: Optional[str] = None
        self.offline_since: Optional[float] = None
        # hot-path columns from /metrics
        self.verify_ms = 0.0  # avg verify-dispatch latency
        self.verify_path = "-"  # ed25519 strategy (ladder | msm | mixed)
        self.traffic_bytes = 0.0  # total per-peer send+recv wire bytes
        # liveness-watchdog columns (tendermint_consensus_stall*)
        self.stalls_total = 0
        self.stall_seconds = 0.0
        # device-guard columns (tendermint_verify_device_*)
        self.device_state = -1  # -1 unknown, else breaker gauge code
        self.device_fallbacks = 0
        # critical-path column (tendermint_consensus_height_phase_seconds):
        # dominant commit-path phase + its mean per-height cost, or "-"
        # when the critpath analyzer has no samples (flight recorder off)
        self.crit = "-"
        # quorum column (tendermint_consensus_quorum_time_to_two_thirds_
        # seconds): mean time-to-strict-2/3 across vote kinds, or "-"
        self.quorum = "-"
        # telemetry-spool column (tendermint_telemetry_*): snapshots
        # written @ spool bytes, error-suffixed; "-" when spooling is off
        self.spool = "-"
        self._last_block_at: Optional[float] = None
        self._started = time.monotonic()
        self._online_time = 0.0
        self._last_poll = self._started
        self._stop = threading.Event()
        self._ws: Optional[WSEventClient] = None
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self) -> None:
        client = HTTPClient(self.addr, timeout=3.0)
        while not self._stop.is_set():
            now = time.monotonic()
            try:
                st = client.status()
                self.moniker = st["node_info"]["moniker"]
                self.network = st["node_info"]["network"]
                self.height = int(st["sync_info"]["latest_block_height"])
                if self.online:
                    self._online_time += now - self._last_poll
                self.online = True
                self.last_error = None
                self.offline_since = None
                self._scrape()
                if self._ws is None:
                    self._connect_ws()
            except Exception as e:
                if self.online or self.offline_since is None:
                    self.offline_since = now
                self.online = False
                self.last_error = f"{type(e).__name__}: {e}"
                if self._ws is not None:
                    self._ws.close()  # else the socket + watcher thread leak
                    self._ws = None
            self._last_poll = now
            self._stop.wait(1.0)

    def _scrape(self) -> None:
        """Best-effort /metrics poll for the latency/traffic columns —
        a node with prometheus disabled just shows zeros."""
        try:
            m = _scrape_metrics(self.addr)
        except Exception:
            return
        s = _sum_family(m, "tendermint_verify_dispatch_seconds_sum")
        c = _sum_family(m, "tendermint_verify_dispatch_seconds_count")
        if c > 0:
            self.verify_ms = round(1e3 * s / c, 1)
        self.verify_path = _verify_path(m)
        self.traffic_bytes = _sum_family(
            m, "tendermint_p2p_peer_send_bytes_total"
        ) + _sum_family(m, "tendermint_p2p_peer_receive_bytes_total")
        self.stalls_total = int(
            _sum_family(m, "tendermint_consensus_stalls_total")
        )
        self.stall_seconds = _sum_family(
            m, "tendermint_consensus_stall_seconds"
        )
        if "tendermint_verify_device_breaker_state" in m:
            self.device_state = int(
                m["tendermint_verify_device_breaker_state"]
            )
        self.device_fallbacks = int(
            _sum_family(m, "tendermint_verify_device_fallback_total")
        )
        self.crit = _crit_column(m)
        self.quorum = _quorum_column(m)
        self.spool = _spool_column(m)

    def _connect_ws(self) -> None:
        try:
            ws = WSEventClient(self.addr, timeout=3.0)
            ws.subscribe("tm.event = 'NewBlock'")
            self._ws = ws
            threading.Thread(target=self._watch_blocks, daemon=True).start()
        except Exception:
            self._ws = None

    def _watch_blocks(self) -> None:
        ws = self._ws
        while not self._stop.is_set() and ws is not None:
            try:
                ev = ws.next_event(timeout=1.0)
            except Exception:
                if self._ws is not ws:
                    return
                continue
            now = time.monotonic()
            header = ev["data"]["value"]["block"]["header"]
            self.height = max(self.height, int(header["height"]))
            if self._last_block_at is not None:
                self.block_latency_ms = round((now - self._last_block_at) * 1e3, 1)
            self._last_block_at = now

    @property
    def uptime_pct(self) -> float:
        total = time.monotonic() - self._started
        return round(100.0 * self._online_time / total, 1) if total > 0 else 0.0

    @property
    def downtime_s(self) -> Optional[float]:
        if self.offline_since is None:
            return None
        return round(time.monotonic() - self.offline_since, 1)

    def snapshot(self) -> dict:
        return {
            "addr": self.addr,
            "moniker": self.moniker,
            "network": self.network,
            "online": self.online,
            "last_error": self.last_error,
            "downtime_s": self.downtime_s,
            "height": self.height,
            "block_interval_ms": self.block_latency_ms,
            "verify_ms": self.verify_ms,
            "verify_path": self.verify_path,
            "traffic_bytes": self.traffic_bytes,
            "stalls_total": self.stalls_total,
            "stall_seconds": self.stall_seconds,
            "device_state": self.device_state,
            "device_fallbacks": self.device_fallbacks,
            "crit": self.crit,
            "quorum": self.quorum,
            "spool": self.spool,
            "uptime_pct": self.uptime_pct,
        }

    def stop(self) -> None:
        self._stop.set()
        if self._ws is not None:
            self._ws.close()


class NetworkMonitor:
    """Aggregates node monitors into network health (monitor/network.go)."""

    def __init__(self, addrs: List[str]):
        self.nodes = [NodeMonitor(a) for a in addrs]

    def health(self) -> str:
        ups = [n for n in self.nodes if n.online]
        if not ups:
            return "dead"
        if len(ups) < len(self.nodes):
            return "moderate"
        heights = [n.height for n in ups]
        if max(heights) - min(heights) > 5:
            return "moderate"  # someone lags
        return "full"

    def snapshot(self) -> dict:
        return {
            "health": self.health(),
            "num_nodes": len(self.nodes),
            "num_online": sum(1 for n in self.nodes if n.online),
            "max_height": max((n.height for n in self.nodes), default=0),
            "nodes": [n.snapshot() for n in self.nodes],
        }

    def stop(self) -> None:
        for n in self.nodes:
            n.stop()


# breaker gauge code -> DEVICE column label (libs/breaker.STATE_GAUGE)
_DEVICE_LABEL = {0: "ok", 1: "OPEN", 2: "PROBE", 3: "QUAR"}


def _fmt_verify(ms: float, path: str) -> str:
    """VERIFY column: mean dispatch latency, annotated with the ed25519
    strategy once a device window has dispatched (ladder | msm | mixed)."""
    base = f"{ms}ms"
    return base if path in ("-", "") else f"{base}/{path}"


def _fmt_device(state: int, fallbacks: int) -> str:
    if state < 0:
        return "-"
    label = _DEVICE_LABEL.get(state, f"?{state}")
    return f"{label}+fb{fallbacks}" if fallbacks else label


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024 or unit == "GB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}GB"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("endpoints", help="comma-separated tcp://host:port list")
    p.add_argument("--json", action="store_true", help="emit JSON snapshots")
    p.add_argument("--interval", type=float, default=2.0)
    p.add_argument("--iterations", type=int, default=0, help="0 = forever")
    args = p.parse_args(argv)

    net = NetworkMonitor([a.strip() for a in args.endpoints.split(",") if a.strip()])
    i = 0
    try:
        while True:
            time.sleep(args.interval)
            snap = net.snapshot()
            if args.json:
                print(json.dumps(snap), flush=True)
            else:
                print(f"\nnetwork: {snap['health']}  "
                      f"({snap['num_online']}/{snap['num_nodes']} online, "
                      f"height {snap['max_height']})")
                print(f"{'MONIKER':<16}{'HEIGHT':>8}{'INTERVAL':>10}"
                      f"{'VERIFY':>14}{'DEVICE':>10}{'CRIT':>15}"
                      f"{'QUORUM':>8}{'SPOOL':>12}"
                      f"{'TRAFFIC':>10}{'STALL':>9}{'UPTIME':>8}  ADDR")
                for n in snap["nodes"]:
                    if n["online"]:
                        suffix = ""
                    else:
                        why = n["last_error"] or "unreachable"
                        down = n["downtime_s"]
                        dur = f" {down:.0f}s" if down is not None else ""
                        suffix = f"  (OFFLINE{dur}: {why})"
                    # actively stalled -> live stall age; past stalls -> count
                    if n["stall_seconds"] > 0:
                        stall = f"!{n['stall_seconds']:.0f}s"
                    elif n["stalls_total"] > 0:
                        stall = f"x{n['stalls_total']}"
                    else:
                        stall = "-"
                    print(
                        f"{n['moniker']:<16}{n['height']:>8}"
                        f"{n['block_interval_ms']:>9}ms"
                        f"{_fmt_verify(n['verify_ms'], n.get('verify_path', '-')):>14}"
                        f"{_fmt_device(n['device_state'], n['device_fallbacks']):>10}"
                        f"{n['crit']:>15}"
                        f"{n.get('quorum', '-'):>8}"
                        f"{n.get('spool', '-'):>12}"
                        f"{_fmt_bytes(n['traffic_bytes']):>10}"
                        f"{stall:>9}"
                        f"{n['uptime_pct']:>7}%  "
                        f"{n['addr']}{suffix}"
                    )
            i += 1
            if args.iterations and i >= args.iterations:
                return 0
    except KeyboardInterrupt:
        return 0
    finally:
        net.stop()


if __name__ == "__main__":
    sys.exit(main())
