"""Mergeable streaming quantile sketch for long-horizon soak telemetry, the
port's copy of the reference package's ``libs/sketch.py`` with the same
fixed gamma, so a sketch built by either package merges exactly with one
built by the other.

DDSketch-style relative-error buckets (Masson et al., "DDSketch: a fast
and fully-mergeable quantile sketch with relative-error guarantees"): a
value x > 0 lands in bucket ceil(log_gamma(x)), so every bucket spans
(gamma^(i-1), gamma^i] and any value reported for a rank is within a
RELATIVE error alpha of the true value, where gamma = (1+alpha)/(1-alpha).

Two properties matter for the soak observatory:

* **Fixed gamma.** Unlike collapsing DDSketch variants, the accuracy
  parameter is fixed at construction and never renegotiated, so merging
  two sketches is bucket-wise integer addition — two nodes' sketches pool
  EXACTLY, and merge order cannot change a single bucket count.  The
  fleet-merged sketch is bit-identical to any association of pairwise
  merges.
* **Bounded memory.** Consensus latencies span roughly 1e-6 .. 1e3
  seconds; at the default alpha=0.01 that is ~1050 buckets worst case
  (log_gamma(1e9) ≈ 1036), a few KB per tracked distribution regardless
  of how many million samples a soak run feeds it — versus a rolling
  window that forgets everything older than its capacity.

The sketch is deterministic: same samples (in any order) -> same bucket
counts, same quantile answers.  The running ``sum`` is the only
order-sensitive field (float addition), which is why quantiles and the
merge identity never depend on it.

``WindowedCounter`` is the companion for rates: integer counts bucketed
by a fixed-width window index (heights or seconds), mergeable by the
same bucket-wise addition, with bounded retention.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

# Default relative accuracy: a reported quantile q~ satisfies
# |q~ - q| <= alpha * q.  0.01 keeps p99 of a 1s commit within 10ms.
DEFAULT_RELATIVE_ACCURACY = 0.01

# Values at or below this magnitude collapse into the zero bucket —
# nanosecond-scale noise is below anything the observatory reasons about.
MIN_INDEXABLE = 1e-9


class QuantileSketch:
    """Fixed-gamma DDSketch over non-negative samples.

    Not thread-safe: owners (CritPath/QuorumTrace/TelemetrySpool) already
    serialize ingest under their own lock.
    """

    __slots__ = (
        "alpha", "_gamma", "_log_gamma", "_buckets", "_zero",
        "_count", "_sum", "_min", "_max",
    )

    def __init__(self, alpha: float = DEFAULT_RELATIVE_ACCURACY):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        self.alpha = float(alpha)
        self._gamma = (1.0 + self.alpha) / (1.0 - self.alpha)
        self._log_gamma = math.log(self._gamma)
        self._buckets: Dict[int, int] = {}
        self._zero = 0  # samples <= MIN_INDEXABLE (incl. exact zeros)
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    # -- ingest -------------------------------------------------------------

    def add(self, value: float, count: int = 1) -> None:
        """Fold ``count`` occurrences of ``value`` into the sketch.
        Negative samples are clamped to the zero bucket (durations cannot
        be negative; a clamped clock glitch should not poison the index)."""
        if count <= 0:
            return
        v = float(value)
        if not math.isfinite(v):
            return
        if v < 0.0:
            v = 0.0
        if v <= MIN_INDEXABLE:
            self._zero += count
        else:
            idx = math.ceil(math.log(v) / self._log_gamma)
            self._buckets[idx] = self._buckets.get(idx, 0) + count
        self._count += count
        self._sum += v * count
        self._min = v if self._min is None else min(self._min, v)
        self._max = v if self._max is None else max(self._max, v)

    def extend(self, values: Iterable[float]) -> None:
        for v in values:
            self.add(v)

    # -- queries ------------------------------------------------------------

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def min(self) -> Optional[float]:
        return self._min

    @property
    def max(self) -> Optional[float]:
        return self._max

    def bucket_count(self) -> int:
        """Number of live buckets — the memory footprint proxy."""
        return len(self._buckets) + (1 if self._zero else 0)

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile estimate, within ``alpha`` relative error
        of the exact nearest-rank value.  q in [0, 1]; 0.0 on empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self._count == 0:
            return 0.0
        rank = max(1, math.ceil(q * self._count))
        if rank <= self._zero:
            # everything in the zero bucket is below observability noise;
            # report the smallest sample actually seen
            return self._min if self._min is not None else 0.0
        cum = self._zero
        est = 0.0
        for idx in sorted(self._buckets):
            cum += self._buckets[idx]
            if cum >= rank:
                # midpoint of (gamma^(i-1), gamma^i] in log space:
                # 2*gamma^i / (gamma + 1), the canonical DDSketch estimate
                est = 2.0 * math.pow(self._gamma, idx) / (self._gamma + 1.0)
                break
        # clamp to the observed envelope: never report outside [min, max]
        # (this also makes the single-sample sketch exact)
        if self._min is not None:
            est = max(est, self._min)
        if self._max is not None:
            est = min(est, self._max)
        return est

    def p50(self) -> float:
        return self.quantile(0.50)

    def p99(self) -> float:
        return self.quantile(0.99)

    # -- merge --------------------------------------------------------------

    def merge(self, other: "QuantileSketch") -> None:
        """Bucket-wise fold of ``other`` into self.  Exact: the merged
        bucket counts are independent of merge order/association."""
        if abs(other.alpha - self.alpha) > 1e-12:
            raise ValueError(
                f"cannot merge sketches with different alpha: "
                f"{self.alpha} vs {other.alpha}"
            )
        for idx, n in other._buckets.items():
            self._buckets[idx] = self._buckets.get(idx, 0) + n
        self._zero += other._zero
        self._count += other._count
        self._sum += other._sum
        if other._min is not None:
            self._min = other._min if self._min is None else min(
                self._min, other._min)
        if other._max is not None:
            self._max = other._max if self._max is None else max(
                self._max, other._max)

    @classmethod
    def merged(cls, sketches: Iterable["QuantileSketch"],
               alpha: Optional[float] = None) -> "QuantileSketch":
        """A fresh sketch holding the bucket-wise sum of ``sketches``."""
        out = None
        for sk in sketches:
            if out is None:
                out = cls(alpha if alpha is not None else sk.alpha)
            out.merge(sk)
        return out if out is not None else cls(
            alpha if alpha is not None else DEFAULT_RELATIVE_ACCURACY)

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> dict:
        """Compact JSON-safe form: buckets as a sorted [index, count] pair
        list (deterministic byte-for-byte when json-dumped with sort_keys)."""
        return {
            "kind": "ddsketch",
            "alpha": self.alpha,
            "count": self._count,
            "sum": self._sum,
            "min": self._min,
            "max": self._max,
            "zero": self._zero,
            "buckets": [[idx, self._buckets[idx]]
                        for idx in sorted(self._buckets)],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "QuantileSketch":
        if d.get("kind") != "ddsketch":
            raise ValueError(f"not a ddsketch dict: kind={d.get('kind')!r}")
        sk = cls(alpha=float(d["alpha"]))
        sk._count = int(d["count"])
        sk._sum = float(d["sum"])
        sk._min = None if d.get("min") is None else float(d["min"])
        sk._max = None if d.get("max") is None else float(d["max"])
        sk._zero = int(d.get("zero", 0))
        sk._buckets = {int(idx): int(n) for idx, n in d.get("buckets", [])}
        return sk

    def __len__(self) -> int:
        return self._count

    def __repr__(self) -> str:
        return (
            f"QuantileSketch(alpha={self.alpha}, count={self._count}, "
            f"buckets={len(self._buckets)}, p50={self.p50():.6g}, "
            f"p99={self.p99():.6g})"
        )


class WindowedCounter:
    """Integer event counts bucketed by fixed-width windows.

    ``observe(pos)`` increments the window containing ``pos`` (heights,
    seconds — any monotone axis).  Merge is bucket-wise addition with the
    same exactness argument as the sketch.  Retention is bounded: only the
    newest ``max_windows`` windows are kept, evictions are counted so a
    lossy report can say so.
    """

    __slots__ = ("window", "max_windows", "_counts", "_evicted")

    def __init__(self, window: float = 1.0, max_windows: int = 4096):
        if window <= 0:
            raise ValueError(f"window must be > 0, got {window}")
        if max_windows < 1:
            raise ValueError(f"max_windows must be >= 1, got {max_windows}")
        self.window = float(window)
        self.max_windows = int(max_windows)
        self._counts: Dict[int, int] = {}
        self._evicted = 0

    def observe(self, pos: float, count: int = 1) -> None:
        if count <= 0:
            return
        idx = int(math.floor(float(pos) / self.window))
        self._counts[idx] = self._counts.get(idx, 0) + count
        self._prune()

    def _prune(self) -> None:
        while len(self._counts) > self.max_windows:
            oldest = min(self._counts)
            self._evicted += self._counts.pop(oldest)

    @property
    def total(self) -> int:
        return sum(self._counts.values())

    @property
    def evicted(self) -> int:
        return self._evicted

    def windows(self) -> List[Tuple[int, int]]:
        """Sorted (window_index, count) pairs."""
        return [(idx, self._counts[idx]) for idx in sorted(self._counts)]

    def merge(self, other: "WindowedCounter") -> None:
        if abs(other.window - self.window) > 1e-12:
            raise ValueError(
                f"cannot merge counters with different window: "
                f"{self.window} vs {other.window}"
            )
        for idx, n in other._counts.items():
            self._counts[idx] = self._counts.get(idx, 0) + n
        self._evicted += other._evicted
        self._prune()

    def to_dict(self) -> dict:
        return {
            "kind": "windowed_counter",
            "window": self.window,
            "max_windows": self.max_windows,
            "evicted": self._evicted,
            "counts": [[idx, self._counts[idx]]
                       for idx in sorted(self._counts)],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "WindowedCounter":
        if d.get("kind") != "windowed_counter":
            raise ValueError(
                f"not a windowed_counter dict: kind={d.get('kind')!r}")
        wc = cls(window=float(d["window"]),
                 max_windows=int(d.get("max_windows", 4096)))
        wc._evicted = int(d.get("evicted", 0))
        wc._counts = {int(idx): int(n) for idx, n in d.get("counts", [])}
        return wc

    def __repr__(self) -> str:
        return (
            f"WindowedCounter(window={self.window}, "
            f"windows={len(self._counts)}, total={self.total})"
        )
