"""Strict Prometheus text-format v0.0.4 linter: the port's copy of the
reference's ``scripts/metrics_lint.py``.

Parses an exposition the hard way — char-level label-value unescaping, no
regex-over-the-whole-line shortcuts — and fails on everything a real scraper
would choke on or silently misread:

  * malformed metric/label names, bad escapes (only \\\\, \\", \\n are legal
    in label values; \\\\ and \\n in HELP), unterminated quotes;
  * duplicate series (same name + same labelset) and duplicate HELP/TYPE;
  * TYPE after samples of the same family, unknown TYPE values;
  * unparseable sample values / timestamps;
  * histogram shape: missing le, missing +Inf bucket, non-cumulative bucket
    counts, +Inf bucket != _count.

Usage:
    python -m tendermint_tpu_torch.tools.metrics_lint FILE [FILE ...]   # lint scrape snapshots
    python -m tendermint_tpu_torch.tools.metrics_lint                   # self-check mode

Self-check mode builds the port's registries (``libs/metrics.py``) so that
they exercise labeled histograms and every escaping edge (backslash, quote,
newline in label values and HELP), checks that the families dashboards
scrape keep the reference's names, and lints every ``Registry.expose_text()``.
Every operator smoke of this package lints its exposition with
``lint_text``.

``--device`` (default ``cuda``) is the smokes' common command line: the
lint runs on the host either way, and without a card the command exits
non-zero naming ``NoCudaDeviceError`` unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys

from tendermint_tpu_torch.device import resolve_device

_NAME_START = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ_:")
_NAME_CONT = _NAME_START | set("0123456789")
_LABEL_START = _NAME_START - {":"}
_LABEL_CONT = _NAME_CONT - {":"}
_TYPES = {"counter", "gauge", "histogram", "summary", "untyped"}


def _valid_name(s, start, cont):
    return bool(s) and s[0] in start and all(c in cont for c in s[1:])


def _parse_value(s):
    s = s.strip()
    if s in ("+Inf", "Inf"):
        return float("inf")
    if s == "-Inf":
        return float("-inf")
    if s == "NaN":
        return float("nan")
    return float(s)  # raises ValueError


def _unescape_help(s, err):
    """HELP text: only \\\\ and \\n escapes are defined."""
    out, i = [], 0
    while i < len(s):
        c = s[i]
        if c == "\\":
            if i + 1 >= len(s):
                err("trailing backslash in HELP text")
                break
            nxt = s[i + 1]
            if nxt == "\\":
                out.append("\\")
            elif nxt == "n":
                out.append("\n")
            else:
                err(f"illegal HELP escape \\{nxt}")
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_labels(s, pos, err):
    """Parse `{name="value",...}` starting at s[pos] == '{'.
    Returns (labels: tuple of (k, v), next_pos) or (None, pos) on error."""
    labels = []
    i = pos + 1
    while True:
        while i < len(s) and s[i] == " ":
            i += 1
        if i < len(s) and s[i] == "}":
            return tuple(labels), i + 1
        j = i
        while j < len(s) and s[j] not in ('=', '{', '}', '"', ','):
            j += 1
        lname = s[i:j].strip()
        if not _valid_name(lname, _LABEL_START, _LABEL_CONT):
            err(f"bad label name {lname!r}")
            return None, pos
        if j >= len(s) or s[j] != "=":
            err(f"expected '=' after label name {lname!r}")
            return None, pos
        j += 1
        if j >= len(s) or s[j] != '"':
            err(f"label value for {lname!r} not quoted")
            return None, pos
        j += 1
        val = []
        while True:
            if j >= len(s):
                err(f"unterminated label value for {lname!r}")
                return None, pos
            c = s[j]
            if c == "\\":
                if j + 1 >= len(s):
                    err(f"trailing backslash in label value for {lname!r}")
                    return None, pos
                nxt = s[j + 1]
                if nxt == "\\":
                    val.append("\\")
                elif nxt == '"':
                    val.append('"')
                elif nxt == "n":
                    val.append("\n")
                else:
                    err(f"illegal escape \\{nxt} in label value for {lname!r}")
                    return None, pos
                j += 2
            elif c == '"':
                j += 1
                break
            else:
                val.append(c)
                j += 1
        labels.append((lname, "".join(val)))
        if j < len(s) and s[j] == ",":
            j += 1
        i = j


def lint_text(text):
    """Returns a list of 'line N: problem' strings (empty = clean)."""
    errors = []
    helps = {}
    types = {}
    sampled = set()  # family names that have emitted samples
    series = {}  # (name, labels tuple) -> first line no
    # histogram consistency bookkeeping:
    buckets = {}  # base name -> list of (le float, labels-minus-le, count)
    counts = {}  # (base name, labels) -> _count value

    if text and not text.endswith("\n"):
        errors.append("exposition does not end with a newline")

    for lineno, line in enumerate(text.split("\n"), 1):
        if line == "":
            continue

        def err(msg, lineno=lineno, line=line):
            errors.append(f"line {lineno}: {msg} | {line!r}")

        if line.startswith("#"):
            parts = line.split(" ", 3)
            if len(parts) >= 2 and parts[1] in ("HELP", "TYPE"):
                if len(parts) < 4 and parts[1] == "TYPE":
                    err("TYPE line needs a metric name and a type")
                    continue
                if len(parts) < 3:
                    err(f"{parts[1]} line needs a metric name")
                    continue
                name = parts[2]
                if not _valid_name(name, _NAME_START, _NAME_CONT):
                    err(f"bad metric name {name!r}")
                    continue
                if parts[1] == "HELP":
                    if name in helps:
                        err(f"duplicate HELP for {name}")
                    helps[name] = _unescape_help(
                        parts[3] if len(parts) > 3 else "", err
                    )
                else:
                    kind = parts[3].strip()
                    if kind not in _TYPES:
                        err(f"unknown TYPE {kind!r}")
                    if name in types:
                        err(f"duplicate TYPE for {name}")
                    if name in sampled:
                        err(f"TYPE for {name} after its samples")
                    types[name] = kind
            # other comments are legal and ignored
            continue

        # sample line: name[{labels}] value [timestamp]
        i = 0
        while i < len(line) and line[i] not in ("{", " "):
            i += 1
        name = line[:i]
        if not _valid_name(name, _NAME_START, _NAME_CONT):
            err(f"bad metric name {name!r}")
            continue
        labels = ()
        if i < len(line) and line[i] == "{":
            labels, i = _parse_labels(line, i, err)
            if labels is None:
                continue
        rest = line[i:].strip().split()
        if not rest:
            err("missing sample value")
            continue
        if len(rest) > 2:
            err(f"trailing garbage after value: {rest[2:]!r}")
            continue
        try:
            value = _parse_value(rest[0])
        except ValueError:
            err(f"unparseable sample value {rest[0]!r}")
            continue
        if len(rest) == 2:
            try:
                int(rest[1])
            except ValueError:
                err(f"unparseable timestamp {rest[1]!r}")
                continue
        key = (name, labels)
        if key in series:
            err(f"duplicate series (first at line {series[key]})")
            continue
        series[key] = lineno
        # family bookkeeping: histogram child series belong to the base name
        family = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and types.get(name[: -len(suffix)]) == "histogram":
                family = name[: -len(suffix)]
                break
        sampled.add(family)
        if family != name and name.endswith("_bucket"):
            les = [v for k, v in labels if k == "le"]
            if len(les) != 1:
                err(f"histogram bucket of {family} needs exactly one le label")
                continue
            try:
                le = _parse_value(les[0])
            except ValueError:
                err(f"unparseable le value {les[0]!r}")
                continue
            other = tuple((k, v) for k, v in labels if k != "le")
            buckets.setdefault(family, []).append((le, other, value, lineno))
        elif family != name and name.endswith("_count"):
            counts[(family, labels)] = (value, lineno)

    # histogram shape checks
    for family, entries in buckets.items():
        per_series = {}
        for le, other, value, lineno in entries:
            per_series.setdefault(other, []).append((le, value, lineno))
        for other, rows in per_series.items():
            rows.sort(key=lambda r: r[0])
            prev = None
            for le, value, lineno in rows:
                if prev is not None and value < prev:
                    errors.append(
                        f"line {lineno}: histogram {family}{dict(other)} "
                        f"buckets not cumulative (le={le}: {value} < {prev})"
                    )
                prev = value
            if not rows or rows[-1][0] != float("inf"):
                errors.append(
                    f"histogram {family}{dict(other)} missing +Inf bucket"
                )
                continue
            cnt = counts.get((family, other))
            if cnt is not None and cnt[0] != rows[-1][1]:
                errors.append(
                    f"line {cnt[1]}: histogram {family}{dict(other)} _count "
                    f"{cnt[0]} != +Inf bucket {rows[-1][1]}"
                )
    return errors


def self_check_texts():
    """The self-check's corpus: (family-parity failures, [(label, exposition)]).
    The registries exercise labeled histograms, every escaping edge and the
    hot-path families of every metric set the port defines."""
    from tendermint_tpu_torch.libs.critpath import PHASES as _CRIT_PHASES
    from tendermint_tpu_torch.libs.metrics import (
        FrontendMetrics,
        MempoolBatchMetrics,
        NodeMetrics,
        Registry,
        VerifyMetrics,
        VoteBatchMetrics,
    )
    from tendermint_tpu_torch.libs.telemetry import EVICTION_STORES

    r = Registry()
    c = r.counter("lint_escapes_total", 'help with \\ backslash\nand newline',
                  label_names=("path", "quote"))
    c.add(1.0, ('C:\\temp\n"dir"', 'say "hi"'))
    c.add(2.0, ("plain", "values"))
    h = r.histogram("lint_latency_seconds", "labeled histogram",
                    buckets=(0.1, 1.0), label_names=("backend",))
    h.observe(0.05, ("host",))
    h.observe(5.0, ("cuda\\sm90",))
    g = r.gauge("lint_height", "a gauge")
    g.set(42)

    vm = VerifyMetrics()
    vm.record_dispatch("host", "ed25519", 64, 0.012, rejects=1, first=True)
    vm.record_dispatch("cuda", "secp256k1", 128, 0.3, fe_backend="mxu",
                       carry_mode="lazy")
    vm.record_dispatch("cuda", "ed25519", 256, 0.1, fe_backend="vpu",
                       carry_mode="eager")
    # verify-strategy attribution ([verify] ed25519_path: ladder | msm)
    vm.record_dispatch("planner_msm", "ed25519", 512, 0.05, fe_backend="vpu",
                       carry_mode="lazy", ed25519_path="msm")
    vm.host_fallback.add(1.0, ("no_cuda",))
    vm.speculative.add(3.0, ("hit",))
    vm.window_heights.observe(512.0)
    vm.record_planner(680, 1024, compiled=True)
    vm.record_planner(680, 1024)
    # device dispatch guard family (libs/breaker.py)
    vm.device_breaker_state.set(1.0)
    vm.device_fallback.add(1.0, ("timeout",))
    vm.device_fallback.add(1.0, ("audit_mismatch",))
    vm.device_retries.add(1.0)
    vm.device_audit.add(8.0, ("ok",))
    vm.device_audit.add(1.0, ("mismatch",))
    # per-device shard attribution (the mesh split): device ids past the
    # label cap fold into "overflow", which must still lint
    vm.record_device_shards((0, 1), 128)
    vm.record_device_shards((str(i) for i in range(40)), 8)

    fm = FrontendMetrics()
    fm.requests.add(3.0, ("verify_commit", "ok"))
    fm.requests.add(1.0, ("light_block", "error"))
    fm.cache_events.add(5.0, ("hit",))
    fm.cache_events.add(1.0, ("miss",))
    fm.cache_events.add(2.0, ("wait",))
    fm.cache_size.set(4.0)
    fm.heights_verified.add(2.0)
    fm.batch_rows.observe(8.0)
    fm.batch_occupancy.observe(0.75)
    fm.verify_seconds.observe(0.004)

    vbm = VoteBatchMetrics()
    # all three flush reasons must lint (the label drives the counter)
    vbm.record_flush("deadline", 24, 64, 0.375)
    vbm.record_flush("quorum", 3, 64, 0.047)
    vbm.record_flush("close", 1, 8, 0.125)

    mbm = MempoolBatchMetrics()
    # the tx-ingest feed shares the flush-reason vocabulary
    mbm.record_flush("deadline", 48, 64, 0.75)
    mbm.record_flush("quorum", 16, 64, 0.25)
    mbm.record_flush("close", 2, 8, 0.25)

    nm = NodeMetrics()
    # the hot-path families, so the lint covers sample lines, not just
    # TYPE/HELP headers
    nm.record_peer_traffic("f3a1", 0x40, sent=2048, received=4096)
    nm.record_peer_traffic("f3a1", 0x20, sent=17)
    nm.set_peer_pending("f3a1", 1024)
    nm.messages_sent.add(3.0, ("0x40",))
    nm.messages_received.add(2.0, ("0x40",))
    nm.step_duration.observe(0.004, ("NEW_ROUND",))
    nm.step_duration.observe(0.12, ("PREVOTE",))
    nm.vote_arrival_latency.observe(0.03, ("prevote",))
    nm.wal_append_seconds.observe(0.0004)
    nm.wal_fsync_seconds.observe(0.002)
    for i, _phase in enumerate(_CRIT_PHASES):
        nm.height_phase_seconds.observe(0.001 * (i + 1), (_phase,))
    nm.mempool_tx_size_bytes.observe(512.0)
    nm.mempool_failed_txs.add(1.0)
    nm.mempool_recheck_times.add(2.0)
    # the quorum observatory: the receive seam's sighting split (both
    # outcomes) and the time-to-quorum histograms (a series a vote kind)
    nm.record_vote_sighting("f3a1", 0x22, first=True)
    nm.record_vote_sighting("f3a1", 0x22, first=False)
    nm.record_vote_sighting("b7c2", 0x22, first=True)
    nm.quorum_time_to_third.observe(0.012, ("prevote",))
    nm.quorum_time_to_two_thirds.observe(0.045, ("precommit",))
    # the soak observatory's telemetry families: counters, the spool-size
    # gauge and every store label of the eviction counter
    nm.telemetry.snapshots.add(3.0)
    nm.telemetry.spool_bytes.set(8192.0)
    nm.telemetry.write_errors.add(1.0)
    nm.telemetry.dropped.add(1.0)
    for _store in EVICTION_STORES:
        nm.telemetry.evicted.add(2.0, (_store,))
    nm.forget_peer("f3a1")  # removal must leave the exposition lintable

    failures = []
    node_text = nm.registry.expose_text()
    verify_text = vm.registry.expose_text()
    frontend_text = fm.registry.expose_text()
    vb_text = vbm.registry.expose_text()
    mb_text = mbm.registry.expose_text()

    def typed(name, *texts):
        return all(f"# TYPE {name} " in t for t in texts)

    # reference-name parity: the families the reference exports under these
    # exact names (consensus/metrics.go, p2p/metrics.go, mempool/metrics.go)
    # must appear in the node exposition; renames break dashboards
    reference_names = (
        "tendermint_consensus_height",
        "tendermint_consensus_rounds",
        "tendermint_consensus_step_duration_seconds",
        "tendermint_p2p_peers",
        "tendermint_p2p_peer_receive_bytes_total",
        "tendermint_p2p_peer_send_bytes_total",
        "tendermint_p2p_peer_pending_send_bytes",
        "tendermint_mempool_size",
        "tendermint_mempool_tx_size_bytes",
        "tendermint_mempool_failed_txs",
        "tendermint_mempool_recheck_times",
        "tendermint_consensus_wal_append_seconds",
        "tendermint_consensus_wal_fsync_seconds",
        "tendermint_state_block_processing_time",
    )
    missing = [n for n in reference_names if not typed(n, node_text)]
    if missing:
        failures.append(("reference-name parity", [f"missing family {n}" for n in missing]))
    # the commit-latency waterfall histogram, a series a PHASES entry
    missing_cp = [n for n in ("tendermint_consensus_height_phase_seconds",)
                  if not typed(n, node_text)]
    missing_cp.extend(f'phase label "{p}"' for p in _CRIT_PHASES
                      if f'phase="{p}"' not in node_text)
    if missing_cp:
        failures.append(("critpath family parity", [f"missing {n}" for n in missing_cp]))
    # the quorum observatory: the time-to-quorum histograms and the
    # receive seam's sighting and duplicate counters
    quorum_names = (
        "tendermint_consensus_quorum_time_to_third_seconds",
        "tendermint_consensus_quorum_time_to_two_thirds_seconds",
        "tendermint_p2p_vote_first_sighting_total",
        "tendermint_p2p_duplicate_votes_total",
    )
    missing_q = [n for n in quorum_names if not typed(n, node_text)]
    missing_q.extend(f'vote-kind label "{k}"' for k in ("prevote", "precommit")
                     if f'type="{k}"' not in node_text)
    if missing_q:
        failures.append(("quorum family parity", [f"missing {n}" for n in missing_q]))
    # the device guard (libs/breaker.py), the limb backend and carry
    # attribution, and the per-device shard counters: VerifyMetrics owns
    # them and NodeMetrics attaches its registry
    device_names = (
        "tendermint_verify_device_breaker_state",
        "tendermint_verify_device_fallback_total",
        "tendermint_verify_device_retries_total",
        "tendermint_verify_device_audit_total",
        "tendermint_verify_fe_backend_total",
        "tendermint_verify_device_lanes_total",
        "tendermint_verify_device_dispatch_total",
    )
    missing_dev = [n for n in device_names if not typed(n, verify_text, node_text)]
    if missing_dev:
        failures.append(("device-family parity", [f"missing family {n}" for n in missing_dev]))
    # the light-client frontend: FrontendMetrics owns the names
    frontend_names = (
        "tendermint_lite_frontend_requests_total",
        "tendermint_lite_frontend_cache_events_total",
        "tendermint_lite_frontend_cache_size",
        "tendermint_lite_frontend_heights_verified_total",
        "tendermint_lite_frontend_batch_rows",
        "tendermint_lite_frontend_batch_occupancy",
        "tendermint_lite_frontend_verify_seconds",
    )
    missing_fe = [n for n in frontend_names if not typed(n, frontend_text, node_text)]
    if missing_fe:
        failures.append(("frontend-family parity", [f"missing family {n}" for n in missing_fe]))
    # the live-vote feed ([verify] vote_batch_window_ms, planner.VoteFeed)
    vote_batch_names = (
        "tendermint_consensus_vote_batch_rows",
        "tendermint_consensus_vote_batch_lanes",
        "tendermint_consensus_vote_batch_lane_occupancy",
        "tendermint_consensus_vote_batch_flush_total",
    )
    missing_vb = [n for n in vote_batch_names if not typed(n, vb_text, node_text)]
    if missing_vb:
        failures.append(("vote-batch family parity",
                         [f"missing family {n}" for n in missing_vb]))
    # the tx-ingest feed ([mempool] tx_batch_window_ms, planner.TxFeed)
    mempool_batch_names = (
        "tendermint_mempool_batch_rows",
        "tendermint_mempool_batch_lanes",
        "tendermint_mempool_batch_lane_occupancy",
        "tendermint_mempool_batch_flush_total",
    )
    missing_mb = [n for n in mempool_batch_names if not typed(n, mb_text, node_text)]
    if missing_mb:
        failures.append(("mempool-batch family parity",
                         [f"missing family {n}" for n in missing_mb]))
    # the soak observatory's spool health (soak_report's loss accounting);
    # TelemetryMetrics is per node, attached by the NodeMetrics constructor
    telemetry_names = (
        "tendermint_telemetry_snapshots_total",
        "tendermint_telemetry_spool_bytes",
        "tendermint_telemetry_write_errors_total",
        "tendermint_telemetry_dropped_snapshots_total",
        "tendermint_observability_evicted_total",
    )
    missing_tel = [n for n in telemetry_names if not typed(n, node_text)]
    missing_tel.extend(f'store label "{s}"' for s in EVICTION_STORES
                       if f'store="{s}"' not in node_text)
    if missing_tel:
        failures.append(("telemetry family parity", [f"missing {n}" for n in missing_tel]))
    texts = [
        ("escaping registry", r.expose_text()),
        ("VerifyMetrics", verify_text),
        ("FrontendMetrics", frontend_text),
        ("VoteBatchMetrics", vb_text),
        ("MempoolBatchMetrics", mb_text),
        ("NodeMetrics(+verify attached)", node_text),
    ]
    return failures, texts


def self_check():
    """The family-parity failures and every corpus text's lint problems,
    as (label, [problem, ...]) pairs; empty = clean."""
    failures, texts = self_check_texts()
    for label, text in texts:
        errs = lint_text(text)
        if errs:
            failures.append((label, errs))
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("files", nargs="*", help="scrape snapshots to lint (none: self-check)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the lint itself runs on the host")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no card: NoCudaDeviceError
    if args.files:
        rc = 0
        for path in args.files:
            with open(path) as f:
                errs = lint_text(f.read())
            if errs:
                rc = 1
                for e in errs:
                    print(f"{path}: {e}", file=sys.stderr)
            else:
                print(f"{path}: OK")
        return rc
    failures = self_check()
    if failures:
        for label, errs in failures:
            for e in errs:
                print(f"self-check [{label}]: {e}", file=sys.stderr)
        return 1
    print("metrics-lint self-check: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
