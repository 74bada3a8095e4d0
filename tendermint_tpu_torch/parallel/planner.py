"""Verification planner — ragged lane packing of a window of commits, one
guarded dispatch, and the per-height int64 quorum tally.

The port's counterpart of the JAX package's ``parallel/planner.py``. A
window ("verify the commits of H heights, each with its own valset") is
flattened into a 1-D lane axis holding only real votes, each lane carrying
the height it belongs to (its segment id), so the per-height tally is a
segment sum over the lanes instead of a reduction over a padded (H, V)
grid. Quorum semantics are the one shared implementation
(``WindowVerdict``): ``committed[h] = tally[h] * 3 > totals[h] * 2``
(strict) and ``sigs_ok[h]`` = no present vote of height h failed.

Two routes run a plan, as in the reference (``execute_plan``):

  * the verifier route (``use_device=False``, the reference's production
    path without a mesh): every lane goes through
    ``crypto.batch.verify_generic`` and the installed verifier — on the
    card ``GuardedBatchVerifier(TorchBatchVerifier)`` -> K1 -> K2 — and the
    tallies fold on the host in int64 (``_execute_host``);
  * the device route (``use_device=True``): the device executor
    (``device_executor``) packs the wellformed lanes by message length with
    ``ops.ed25519_cuda.packed_inputs``, runs K1 -> K2 per group through
    ``_device_verify_packed``, scatters the verdicts into one lane vector on
    the card, and tallies there (``segment_tally``: int64 ``index_add_`` of
    power and of failed votes over the segment ids, then the strict +2/3
    compare) — the reference's K7 step. Where the reference packs h on the
    host and runs its XLA ladder, the port runs K1 + K2; parity is per lane
    verdict and per int64 tally. With ``ed25519_path="msm"`` the executor
    folds every wellformed lane into one MSM instead
    (``_execute_device_msm``: ``ed25519_cuda.rlc_verify_batch``, K1 -> K4,
    and K1 -> K2 on the rows of a rejected window) and tallies on the host,
    as the reference's does.

The device route runs behind ``_execute_device_guarded`` (breaker, deadline,
retry, seeded audit, host fallback), the line-for-line counterpart of the
reference's, except that on the card a dispatch the reference would complete
on the host raises ``DeviceDispatchError``; the verifier route runs behind
the installed verifier's own guard (``GuardedBatchVerifier``). The executor
is a seam (``set_device_executor``): the configuration root
(``node/verify_root.py``) installs it with its device.

Four streaming entry points run windows through ``execute_plan``:
``WindowPipeline`` (state sync's backfill sub-windows: a worker thread plans
window N+1 while window N dispatches), ``LaneFeed`` (many callers with one
row each, such as the RPC's ``?verify=1`` burst: rows that arrive within a
deadline fold into one dispatch), ``VoteFeed`` (live consensus votes, one
lane each, one row per vote set) and ``TxFeed`` (mempool CheckTx
signatures, one row per CheckTx window). Not ported yet: the multi-GPU
lane split (ROADMAP queue 1 item 4b (iii)).
"""

from __future__ import annotations

import math
import queue
import random
import threading
import time
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tendermint_tpu_torch.crypto import ed25519 as _ed
from tendermint_tpu_torch.crypto.batch import (
    RLCHostVerifier,
    _resolve_ed25519_path,
    verify_generic,
)
from tendermint_tpu_torch.crypto.keys import PubKey, PubKeyEd25519
from tendermint_tpu_torch.device import DeviceLike, resolve_device
from tendermint_tpu_torch.libs import breaker as _brk
from tendermint_tpu_torch.libs import trace
from tendermint_tpu_torch.libs.metrics import (
    get_mempool_batch_metrics,
    get_verify_metrics,
    get_vote_batch_metrics,
)
from tendermint_tpu_torch.libs.profile import get_profiler
from tendermint_tpu_torch.ops import ed25519_cuda as _k

# (pubkey: key object or raw 32-byte ed25519 key, msg, sig) or None
SigTuple = Tuple[object, bytes, bytes]

MIN_LANES = 64  # smallest lane bucket
MAX_POW2_LANES = 4096  # above this, buckets are multiples of 4096
MIN_SEGS = 8  # smallest segment (height) bucket


def lanes_bucket(n: int) -> int:
    """Lane pad size: powers of two 64..4096, then multiples of 4096."""
    b = MIN_LANES
    while b < n and b < MAX_POW2_LANES:
        b *= 2
    if n > b:
        b = ((n + MAX_POW2_LANES - 1) // MAX_POW2_LANES) * MAX_POW2_LANES
    return b


def segs_bucket(h: int) -> int:
    """Segment (height) pad size: power of two >= MIN_SEGS."""
    b = MIN_SEGS
    while b < h:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# Planner configuration ([verify] section, node/verify_root.py)
# ---------------------------------------------------------------------------

_DEFAULT_PIPELINE_DEPTH = 2
_DEFAULT_WINDOWS_PER_DEVICE = 4

_pipeline_depth = _DEFAULT_PIPELINE_DEPTH
_windows_per_device = _DEFAULT_WINDOWS_PER_DEVICE
_reduce_mode = "device"

REDUCE_MODES = ("device", "host")


def configure_planner(cfg=None) -> None:
    """Apply the `[verify]` planner knobs (config/verify.VerifyConfig):
    ``pipeline_depth`` (``WindowPipeline``), ``windows_per_device``
    (``LaneFeed``'s superdispatch budget) and ``planner_reduce``; None
    restores the defaults."""
    global _pipeline_depth, _windows_per_device, _reduce_mode
    if cfg is None:
        _pipeline_depth = _DEFAULT_PIPELINE_DEPTH
        _windows_per_device = _DEFAULT_WINDOWS_PER_DEVICE
        _reduce_mode = "device"
        return
    _pipeline_depth = max(1, int(getattr(
        cfg, "pipeline_depth", _DEFAULT_PIPELINE_DEPTH)))
    _windows_per_device = max(1, int(getattr(
        cfg, "windows_per_device", _DEFAULT_WINDOWS_PER_DEVICE)))
    mode = str(getattr(cfg, "planner_reduce", "device") or "device").lower()
    if mode not in REDUCE_MODES:
        raise ValueError(
            f"planner_reduce must be one of {REDUCE_MODES}, got {mode!r}")
    _reduce_mode = mode


def pipeline_depth() -> int:
    """Configured ``WindowPipeline`` depth (packed windows in flight)."""
    return _pipeline_depth


def windows_per_dispatch(mesh=None) -> int:
    """How many independent windows one superdispatch folds: the configured
    per-device budget (one card; a mesh is the multi-GPU split)."""
    if mesh is not None:
        raise NotImplementedError(
            "a mesh (the multi-GPU lane split) is ported by ROADMAP queue 1 item 4b (iii)")
    return _windows_per_device


def reduce_mode() -> str:
    """Where the per-height int64 tallies reduce: "device"
    (``segment_tally`` on the card) or "host" (the step returns only the
    lane verdicts and ``_host_reduce`` folds them); bit-identical."""
    return _reduce_mode


def set_reduce_mode(mode: str) -> None:
    """Benches/tests: pick the tally reduction side directly."""
    global _reduce_mode
    if mode not in REDUCE_MODES:
        raise ValueError(
            f"planner_reduce must be one of {REDUCE_MODES}, got {mode!r}")
    _reduce_mode = mode


def _pub_bytes(pk) -> bytes:
    """Raw key bytes of a lane key: key objects expose .bytes(); bytes-like
    keys and numpy rows convert with bytes()."""
    b = getattr(pk, "bytes", None)
    return b() if callable(b) else bytes(pk)


@dataclass
class WindowPlan:
    """A ragged window flattened to lanes. ``coords[j] = (h, v)`` maps lane
    j back to its grid cell; ``seg_ids[j] = h`` feeds the segment tallies.
    Malformed votes (wrong sig/pub length, undecompressable key) keep their
    lane — they count as failures, not absences."""

    H: int
    V: int  # widest row (the ok-grid width)
    coords: np.ndarray  # (n, 2) int32
    seg_ids: np.ndarray  # (n,) int32, sorted ascending
    pubs: list  # lane pubkeys (key objects or raw bytes)
    msgs: list
    sigs: list
    powers: np.ndarray  # (n,) int64
    wellformed: np.ndarray  # (n,) bool — 32-byte pub and 64-byte sig: the
    # device route's precondition only (unshaped lanes fail there); the
    # verifier route ignores it and verify_generic decides every lane
    totals: np.ndarray  # (H,) int64 per-height total voting power
    dev: Optional["DevicePack"] = None  # device tensors (pack_device)
    dev_shape: Optional[Tuple[int, int]] = None  # (lane bucket, seg bucket)
    pack_seconds: float = 0.0  # host plan (+ pack) wall time (cost ledger)
    # multi-window superdispatch bookkeeping (plan_windows): window w's
    # heights occupy rows [row_offsets[w], row_offsets[w+1]), so the global
    # seg_ids stay sorted and one tally serves every window
    n_windows: int = 1
    row_offsets: Optional[np.ndarray] = None  # (n_windows+1,) int64
    window_ids: Optional[np.ndarray] = None  # (n,) int32 per-lane window id
    window_V: Optional[List[int]] = None  # per-window grid width

    @property
    def n_lanes(self) -> int:
        return len(self.pubs)

    def all_ed25519(self) -> bool:
        """True when every lane can ride the ed25519 kernels: any key that
        is not a ``PubKey`` of another type counts as a raw ed25519 key
        (bytes, numpy rows, key objects of other packages with .bytes());
        malformed lanes are handled either way."""
        return all(not isinstance(pk, PubKey) or isinstance(pk, PubKeyEd25519)
                   for pk in self.pubs)


@dataclass
class WindowVerdict:
    """Per-height outcome of one planned window."""

    ok: np.ndarray  # (H, V) bool — per-vote verdict grid
    tally: np.ndarray  # (H,) int64 — voting power of valid signatures
    committed: np.ndarray  # (H,) bool — tally*3 > total*2 (STRICT)
    sigs_ok: np.ndarray  # (H,) bool — no present vote failed
    lanes_present: int  # real votes dispatched
    lanes_dispatched: int  # lanes after bucket padding (0 for host path)

    @property
    def occupancy(self) -> float:
        if self.lanes_dispatched <= 0:
            return 1.0
        return self.lanes_present / self.lanes_dispatched


def plan_window(
    votes: Sequence[Sequence[Optional[SigTuple]]],
    powers: Sequence[Sequence[int]],
    totals: Sequence[int],
) -> WindowPlan:
    """Flatten ragged (height, valset) rows into lanes. ``votes[h][v]`` is
    ``(pub, msg, sig)`` or None (absent/nil); ``powers[h][v]`` the voting
    power; ``totals[h]`` the height's total power."""
    H = len(votes)
    if len(totals) != H or len(powers) != H:
        raise ValueError("votes, powers and totals must have one row per height")
    V = max((len(row) for row in votes), default=0)
    coords: List[Tuple[int, int]] = []
    pubs, msgs, sigs = [], [], []
    pw: List[int] = []
    wf: List[bool] = []
    for h, row in enumerate(votes):
        prow = powers[h]
        for v, item in enumerate(row):
            if item is None:
                continue
            pub, msg, sig = item
            coords.append((h, v))
            pubs.append(pub)
            msgs.append(bytes(msg))
            sigs.append(bytes(sig))
            pw.append(prow[v])
            wf.append(len(sig) == 64 and len(_pub_bytes(pub)) == 32)
    n = len(coords)
    coords_a = (
        np.asarray(coords, dtype=np.int32)
        if n
        else np.zeros((0, 2), dtype=np.int32)
    )
    return WindowPlan(
        H=H,
        V=V,
        coords=coords_a,
        seg_ids=np.ascontiguousarray(coords_a[:, 0]),
        pubs=pubs,
        msgs=msgs,
        sigs=sigs,
        powers=np.asarray(pw, dtype=np.int64),
        wellformed=np.asarray(wf, dtype=bool),
        totals=np.asarray(list(totals), dtype=np.int64),
    )


def plan_windows(
    specs: Sequence[Tuple[Sequence, Sequence, Sequence]],
) -> WindowPlan:
    """Bin-pack several independent windows into ONE lane tile. Each spec is
    a ``(votes, powers, totals)`` triple as ``plan_window`` takes them;
    ``split_verdict`` recovers per-window verdicts, each bit-identical to a
    flat ``verify_window(spec)``."""
    specs = list(specs)
    if not specs:
        raise ValueError("plan_windows needs at least one window spec")
    votes_all: List[Sequence] = []
    powers_all: List[Sequence] = []
    totals_all: List[int] = []
    row_offsets = [0]
    window_V: List[int] = []
    for votes, powers, totals in specs:
        votes_all.extend(votes)
        powers_all.extend(powers)
        totals_all.extend(list(totals))
        row_offsets.append(len(votes_all))
        window_V.append(max((len(row) for row in votes), default=0))
    plan = plan_window(votes_all, powers_all, totals_all)
    plan.n_windows = len(specs)
    plan.row_offsets = np.asarray(row_offsets, dtype=np.int64)
    plan.window_V = window_V
    if plan.seg_ids.size:
        plan.window_ids = np.searchsorted(
            plan.row_offsets[1:], plan.seg_ids, side="right"
        ).astype(np.int32)
    else:
        plan.window_ids = np.zeros((0,), dtype=np.int32)
    return plan


def split_verdict(plan: WindowPlan, verdict: WindowVerdict) -> List[WindowVerdict]:
    """Slice a superdispatch verdict back into per-window verdicts, each grid
    at its window's own width; ``lanes_dispatched`` carries the shared
    tile's bucket."""
    if plan.n_windows <= 1 or plan.row_offsets is None:
        return [verdict]
    out: List[WindowVerdict] = []
    offs = plan.row_offsets
    for w in range(plan.n_windows):
        a, b = int(offs[w]), int(offs[w + 1])
        Vw = plan.window_V[w] if plan.window_V is not None else plan.V
        lanes_w = int(np.count_nonzero(plan.window_ids == w)) if (
            plan.window_ids is not None
        ) else 0
        out.append(WindowVerdict(
            ok=np.ascontiguousarray(verdict.ok[a:b, :Vw]),
            tally=verdict.tally[a:b].copy(),
            committed=verdict.committed[a:b].copy(),
            sigs_ok=verdict.sigs_ok[a:b].copy(),
            lanes_present=lanes_w,
            lanes_dispatched=verdict.lanes_dispatched,
        ))
    return out


# ---------------------------------------------------------------------------
# The device step: pack, K1 -> K2 per message-length group, the K7 tally
# ---------------------------------------------------------------------------


@dataclass
class DevicePack:
    """A plan's device-resident inputs. ``groups`` holds, per message
    length, the lanes it covers (int64 on the device), their count and the
    eight tensors ``_device_verify_packed`` takes; the lane vectors are
    padded to the lane bucket B, ``totals`` to the segment bucket S.
    Padding lanes sit on segment S - 1 with zero power and is_vote False,
    so the segment ids stay sorted and the S - 1 tallies are unaffected."""

    device: torch.device
    shape: Tuple[int, int]  # (B, S)
    groups: List[tuple]
    present: torch.Tensor  # (B,) bool: wellformed, decompressable, s ok
    is_vote: torch.Tensor  # (B,) bool: a real lane
    power: torch.Tensor  # (B,) int64, 0 where not present
    seg_ids: torch.Tensor  # (B,) int64
    totals: torch.Tensor  # (S,) int64
    present_host: np.ndarray  # (B,) bool, the host copy of ``present``

    def nbytes(self) -> int:
        ts = [self.present, self.is_vote, self.power, self.seg_ids, self.totals]
        for lanes, _, inputs in self.groups:
            ts += [lanes, *inputs]
        return sum(t.numel() * t.element_size() for t in ts)


def pack_device(plan, device: torch.device) -> DevicePack:
    """Host prologue + upload for the device route: decompress every
    wellformed lane's key (cached per key and per column), split the lanes
    by message length and build each group's K1 and K2 inputs with
    ``ed25519_cuda.packed_inputs``. A port plan keeps its pack in
    ``plan.dev``; a plan of another planner with the same fields (the
    reference's, through its executor seam) is packed afresh each call."""
    own = isinstance(plan, WindowPlan)
    if own and isinstance(plan.dev, DevicePack) and plan.dev.device == device:
        return plan.dev
    n = plan.n_lanes
    B = lanes_bucket(n)
    S = segs_bucket(plan.H)
    present = np.zeros((B,), bool)
    is_vote = np.zeros((B,), bool)
    power = np.zeros((B,), np.int64)
    seg_ids = np.full((B,), S - 1, np.int64)
    groups = []
    if n:
        is_vote[:n] = True
        seg_ids[:n] = plan.seg_ids
        idx = np.flatnonzero(np.asarray(plan.wellformed, dtype=bool))
        if idx.size:
            pubs_a = np.frombuffer(
                b"".join(_pub_bytes(plan.pubs[j]) for j in idx), np.uint8
            ).reshape(idx.size, 32)
            sigs_a = np.frombuffer(
                b"".join(bytes(plan.sigs[j]) for j in idx), np.uint8
            ).reshape(idx.size, 64)
            neg_ax, ay, valid = _k._decompress_valset(pubs_a)
            valid = valid & ((sigs_a[:, 63] & 224) == 0)  # Go's s check
            present[idx] = valid
            lens = np.fromiter((len(plan.msgs[j]) for j in idx), np.int64, idx.size)
            for ln in np.unique(lens):
                g = np.flatnonzero(lens == ln)
                inputs, _ = _k.packed_inputs(
                    pubs_a[g], [bytes(plan.msgs[idx[i]]) for i in g], sigs_a[g],
                    neg_ax[g], ay[g], valid[g], int(ln), device)
                groups.append((torch.from_numpy(idx[g].astype(np.int64)).to(device),
                               int(g.size), inputs))
        power[:n] = np.where(present[:n], np.asarray(plan.powers, np.int64), 0)
    totals = np.zeros((S,), np.int64)
    totals[: plan.H] = np.asarray(plan.totals, np.int64)
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    pack = DevicePack(device, (B, S), groups, put(present), put(is_vote),
                      put(power), put(seg_ids), put(totals), present)
    if own:
        plan.dev, plan.dev_shape = pack, (B, S)
    return pack


# device launches of the tally (torch ops, not a hand-written kernel): one a
# device dispatch with reduce mode "device"
tally_launches = {"planner_tally": 0}


def segment_tally(ok, power, is_vote, seg_ids, totals):
    """The reference's K7 tally on any device, in int64: the power of valid
    votes and the count of failed votes per segment (``index_add_`` over
    the sorted segment ids), then committed = tally * 3 > totals * 2.
    Returns (tally (S,), committed (S,), nbad (S,))."""
    S = totals.shape[0]
    tally = torch.zeros((S,), dtype=torch.int64, device=ok.device).index_add_(
        0, seg_ids, torch.where(ok, power, torch.zeros_like(power)))
    nbad = torch.zeros((S,), dtype=torch.int64, device=ok.device).index_add_(
        0, seg_ids, (is_vote & ~ok).to(torch.int64))
    if ok.is_cuda:
        tally_launches["planner_tally"] += 1
    return tally, tally * 3 > totals * 2, nbad


def _planner_step(pack: DevicePack, reduce: str = "device"):
    """K1 -> K2 for every message-length group, the verdicts scattered into
    one (B,) lane vector masked by ``present``; with reduce "device" also
    the segment tally. Everything stays on the device."""
    B, _ = pack.shape
    lane_ok = torch.zeros((B,), dtype=torch.bool, device=pack.device)
    for lanes, m, inputs in pack.groups:
        lane_ok[lanes] = _k._device_verify_packed(*inputs)[:m] != 0
    ok = lane_ok & pack.present
    if reduce == "host":
        return ok
    return (ok, *segment_tally(ok, pack.power, pack.is_vote, pack.seg_ids,
                               pack.totals))


_buckets_seen: set = set()
_compiles = 0
_cache_mtx = threading.Lock()


def compile_count() -> int:
    """First dispatches of a (device, lane bucket, segment bucket, reduce)
    bucket since process start / last reset_cache(). The port has no jit:
    a bucket's first dispatch pays the launch warm-up, and it is counted
    and recorded (verify_compile_seconds) as the reference counts a
    compile."""
    return _compiles


def reset_cache() -> None:
    """Forget the buckets seen and zero the counter (tests)."""
    global _compiles
    with _cache_mtx:
        _buckets_seen.clear()
        _compiles = 0


def _note_bucket(key) -> bool:
    global _compiles
    with _cache_mtx:
        if key in _buckets_seen:
            return False
        _buckets_seen.add(key)
        _compiles += 1
        return True


def _host_reduce(plan, ok_l: np.ndarray):
    """Fold the lane verdicts into per-height int64 tallies on the host —
    the same integer math as ``segment_tally``. Every lane [:n] is a vote,
    so nbad per height is the count of its failed lanes."""
    tally = np.zeros((plan.H,), dtype=np.int64)
    nbad = np.zeros((plan.H,), dtype=np.int64)
    if plan.n_lanes:
        np.add.at(tally, plan.seg_ids[ok_l], plan.powers[ok_l])
        np.add.at(nbad, plan.seg_ids[~ok_l], 1)
    committed = tally * 3 > plan.totals * 2
    return tally, committed, nbad


# the labels the dispatch metrics carry: the port has one limb multiplier
# and one carry schedule, recorded under the JAX planner's default names
FE_BACKEND, CARRY_MODE = "vpu", "lazy"


# devices whose MSM route has dispatched once: the first pays the warm-up
_msm_warm: set = set()


def _execute_device_msm(plan, mesh=None, *, device: torch.device) -> WindowVerdict:
    """One MSM per window (``[verify] ed25519_path = "msm"``): every
    wellformed lane folds into one random-linear-combination check
    (``ed25519_cuda.rlc_verify_batch``: K1, K4, and on a reject K1 + K2
    over the window's rows with host chunk RLCs where a row fails), and the tallies fold on the host
    (``_host_reduce``), as in the reference. The verdicts equal the
    per-lane route's; the guard wraps it unchanged."""
    n = plan.n_lanes
    ok_l = np.zeros((n,), dtype=bool)
    wf = np.asarray(plan.wellformed, dtype=bool)
    rows = np.flatnonzero(wf)
    first = device not in _msm_warm
    t0 = time.perf_counter()
    with trace.span(
        "planner.dispatch", backend="planner_msm", H=plan.H, lanes=n, n=n,
        windows=plan.n_windows, compiled=first,
    ):
        if rows.size:
            pubs_a = np.frombuffer(
                b"".join(_pub_bytes(plan.pubs[j]) for j in rows), np.uint8
            ).reshape(rows.size, 32)
            sigs_a = np.frombuffer(
                b"".join(bytes(plan.sigs[j]) for j in rows), np.uint8
            ).reshape(rows.size, 64)
            ok_l[rows] = _k.rlc_verify_batch(
                pubs_a, [bytes(plan.msgs[j]) for j in rows], sigs_a, device=device)
    _msm_warm.add(device)
    dt = time.perf_counter() - t0
    tally, committed, nbad = _host_reduce(plan, ok_l)
    try:
        m = get_verify_metrics()
        m.record_planner(n, n, compiled=first)
        m.record_dispatch(
            "planner_msm", "ed25519", n, dt,
            rejects=int(np.count_nonzero(wf & ~ok_l)),
            first=first, fe_backend=FE_BACKEND, carry_mode=CARRY_MODE,
            ed25519_path="msm",
        )
        get_profiler().record(
            "planner_msm",
            bucket=(n, plan.H),
            lanes_present=n,
            lanes_dispatched=n,
            heights=plan.H,
            pack_seconds=plan.pack_seconds,
            run_seconds=dt,
            compiled=first,
            # the upload is about the extended-point pool: two points a
            # lane, 4 coordinates of 10 u32 limbs
            bytes_to_device=int(rows.size) * 2 * 4 * _k.NLIMB * 4,
            fe_backend=FE_BACKEND,
            carry_mode=CARRY_MODE,
            ed25519_path="msm",
            n_windows=plan.n_windows,
            n_devices=1,
        )
    except Exception:
        pass
    ok = np.zeros((plan.H, plan.V), dtype=bool)
    if n:
        ok[plan.coords[:, 0], plan.coords[:, 1]] = ok_l
    return WindowVerdict(
        ok=ok,
        tally=tally.astype(np.int64, copy=False),
        committed=committed,
        sigs_ok=nbad == 0,
        lanes_present=n,
        lanes_dispatched=n,
    )


def _execute_device(plan, mesh=None, *, device: torch.device) -> WindowVerdict:
    """Pack, run ``_planner_step`` and read the verdict and tallies back
    with one synchronisation (one ``.cpu()``); on the MSM path,
    ``_execute_device_msm``."""
    if mesh is not None:
        raise NotImplementedError(
            "a mesh (the multi-GPU lane split) is ported by ROADMAP queue 1 item 4b (iii)")
    if _resolve_ed25519_path(None) == "msm":
        return _execute_device_msm(plan, mesh, device=device)
    t_pack = time.perf_counter()
    with trace.span("planner.pack_device", H=plan.H, n=plan.n_lanes):
        pack = pack_device(plan, device)
    pack_seconds = plan.pack_seconds + (time.perf_counter() - t_pack)
    B, S = pack.shape
    H, n = plan.H, plan.n_lanes
    reduce = _reduce_mode
    compiled = _note_bucket((device, B, S, reduce))
    t0 = time.perf_counter()
    with trace.span(
        "planner.dispatch", backend="planner", H=H, lanes=B, n=n,
        windows=plan.n_windows, compiled=compiled,
    ):
        if reduce == "host":
            ok_l = _planner_step(pack, "host").cpu().numpy()[:n]
            tally, committed, nbad = _host_reduce(plan, ok_l)
        else:
            ok, tally_d, committed_d, nbad_d = _planner_step(pack)
            out = torch.cat([ok.to(torch.int64), tally_d,
                             committed_d.to(torch.int64), nbad_d]).cpu().numpy()
            ok_l = out[:n] != 0
            tally = out[B: B + H]
            committed = out[B + S: B + S + H] != 0
            nbad = out[B + 2 * S: B + 2 * S + H]
    dt = time.perf_counter() - t0
    try:
        m = get_verify_metrics()
        m.record_planner(n, B, compiled=compiled)
        # rejects = lanes that passed the host prechecks but failed the
        # device verify (the reference's definition)
        m.record_dispatch(
            "planner", "ed25519", n, dt,
            rejects=int(np.count_nonzero(pack.present_host[:n] & ~ok_l)),
            first=compiled, fe_backend=FE_BACKEND, carry_mode=CARRY_MODE,
            ed25519_path="ladder",
        )
        m.record_device_shards(
            (device.index if device.index is not None else device.type,), B)
        get_profiler().record(
            "planner",
            bucket=(B, S),
            lanes_present=n,
            lanes_dispatched=B,
            heights=H,
            pack_seconds=pack_seconds,
            run_seconds=dt,
            compiled=compiled,
            bytes_to_device=pack.nbytes(),
            fe_backend=FE_BACKEND,
            carry_mode=CARRY_MODE,
            ed25519_path="ladder",
            n_windows=plan.n_windows,
            n_devices=1,
        )
    except Exception:
        pass
    ok = np.zeros((H, plan.V), dtype=bool)
    if n:
        ok[plan.coords[:, 0], plan.coords[:, 1]] = ok_l
    return WindowVerdict(
        ok=ok,
        tally=np.asarray(tally, dtype=np.int64),
        committed=np.asarray(committed, dtype=bool),
        sigs_ok=np.asarray(nbad) == 0,
        lanes_present=n,
        lanes_dispatched=B,
    )


def device_executor(device: DeviceLike = None):
    """The device executor on an explicit device (``cuda`` unless the
    caller passes ``device="cpu"``, which runs K1's and K2's plain
    versions): ``fn(plan, mesh=None) -> WindowVerdict``, with the device
    as ``fn.device``. It takes this planner's ``WindowPlan`` or any plan
    with the same fields (``pubs`` of raw bytes or of objects with
    ``.bytes()``), so it also fits the reference's executor seam."""
    dev = resolve_device(device)

    def execute(plan, mesh=None) -> WindowVerdict:
        return _execute_device(plan, mesh, device=dev)

    execute.device = dev
    return execute


def _execute_default_device(plan, mesh=None) -> WindowVerdict:
    """The executor when none is installed: the current CUDA device (which
    raises when there is none). It counts as on the card for the guard."""
    return device_executor(None)(plan, mesh)


def _execute_host(plan, verifier=None) -> WindowVerdict:
    """Lane verification through the BatchVerifier boundary (verify_generic
    — mixed key types, the installed verifier), with the same segment
    tallies in int64 numpy (``_host_reduce``).

    Every present lane goes through verify_generic. The one structural
    failure decided here: a raw key (anything that is not a ``PubKey``)
    that is not 32 bytes cannot be any key type we speak — its lane
    fails."""
    t0 = time.perf_counter()
    n = plan.n_lanes
    ok_l = np.zeros((n,), dtype=bool)
    if n:
        idx: List[int] = []
        pub_objs = []
        for j in range(n):
            pk = plan.pubs[j]
            if not isinstance(pk, PubKey):
                try:
                    pk = PubKeyEd25519(_pub_bytes(pk))
                except (ValueError, TypeError):
                    continue  # wrong-length raw key: lane stays failed
            idx.append(j)
            pub_objs.append(pk)
        if idx:
            ok_l[np.asarray(idx)] = verify_generic(
                pub_objs,
                [plan.msgs[j] for j in idx],
                [plan.sigs[j] for j in idx],
                verifier=verifier,
            )
    tally, committed, nbad = _host_reduce(plan, ok_l)
    ok = np.zeros((plan.H, plan.V), dtype=bool)
    if n:
        ok[plan.coords[:, 0], plan.coords[:, 1]] = ok_l
    try:
        get_profiler().record(
            "host",
            lanes_present=n,
            lanes_dispatched=0,
            heights=plan.H,
            pack_seconds=plan.pack_seconds,
            run_seconds=time.perf_counter() - t0,
            n_windows=plan.n_windows,
        )
    except Exception:
        pass
    return WindowVerdict(
        ok=ok,
        tally=tally,
        committed=committed,
        sigs_ok=nbad == 0,
        lanes_present=n,
        lanes_dispatched=0,
    )


# ---------------------------------------------------------------------------
# Fault-tolerant device dispatch (libs/breaker.py)
# ---------------------------------------------------------------------------

# the executor seam: the configuration root installs the device executor;
# tests install fakes that fail, hang or corrupt
_device_executor = None

_audit_mtx = threading.Lock()
_audit_seq = 0


def set_device_executor(fn=None) -> None:
    """Install the device executor (``fn(plan, mesh) -> WindowVerdict``);
    None restores the default (the current CUDA device). The guard —
    breaker, deadline, retry, audit, host fallback off the card — wraps
    whatever is installed."""
    global _device_executor
    _device_executor = fn


def _installed_executor():
    return _device_executor if _device_executor is not None else _execute_default_device


def _executor_on_card(exe) -> bool:
    """The default executor (the current CUDA device) or one whose
    ``.device`` is CUDA: where the guard raises rather than complete a
    window on the host."""
    return exe is _execute_default_device or _brk.on_card(exe)


def _note_device_fallback(reason: str, plan, card: bool = False) -> None:
    """Count a fallback by reason (off the card) and record the profiler
    event: ``device_fallback``, or ``device_failure`` on the card, where
    the caller raises instead of falling back."""
    if not card:
        try:
            get_verify_metrics().device_fallback.add(1.0, (reason,))
        except Exception:
            pass
    try:
        get_profiler().record_event(
            "device_failure" if card else "device_fallback", reason=reason,
            backend="planner", heights=plan.H, lanes=plan.n_lanes,
        )
    except Exception:
        pass


def _without_device(reason: str, plan, verifier, card: bool, cause=None):
    """The window has no device verdict: off the card it completes through
    ``_execute_host``; on the card it raises ``DeviceDispatchError``
    (``DeviceAuditMismatch`` after a quarantine)."""
    _note_device_fallback(reason, plan, card)
    if card:
        err = (_brk.DeviceAuditMismatch if reason == "audit_mismatch"
               else _brk.DeviceDispatchError)
        raise err(reason, f"planner window of {plan.H} heights") from cause
    return _execute_host(plan, verifier=verifier)


def _audit_device_verdict(plan, verdict: WindowVerdict) -> bool:
    """Silent-corruption audit: re-verify k seeded-sampled wellformed lanes
    on the host oracle and compare with the device verdict. True iff any
    lane disagrees. Only wellformed lanes are sampled — unshaped lanes fail
    on the device by construction and carry no signal."""
    cfg = _brk.guard_config()
    rate = cfg.audit_sample_rate
    if rate <= 0 or plan.n_lanes == 0:
        return False
    cand = np.flatnonzero(plan.wellformed)
    if cand.size == 0:
        return False
    global _audit_seq
    with _audit_mtx:
        seq = _audit_seq
        _audit_seq += 1
    k = min(int(cand.size), max(1, int(math.ceil(cand.size * rate))))
    rng = random.Random((cfg.audit_seed << 20) ^ seq)
    lanes = rng.sample([int(j) for j in cand], k)
    bad = []
    with trace.span("planner.audit", lanes=k):
        for j in lanes:
            pb = _pub_bytes(plan.pubs[j])
            host_ok = _ed._verify_pure(pb, plan.msgs[j], plan.sigs[j])
            dev_ok = bool(verdict.ok[plan.coords[j, 0], plan.coords[j, 1]])
            if host_ok != dev_ok:
                bad.append(j)
    try:
        m = get_verify_metrics()
        if k - len(bad):
            m.device_audit.add(float(k - len(bad)), ("ok",))
        if bad:
            m.device_audit.add(float(len(bad)), ("mismatch",))
    except Exception:
        pass
    if bad:
        try:
            get_profiler().record_event(
                "audit_mismatch", backend="planner", heights=plan.H,
                sampled=k, mismatches=len(bad), lanes=bad[:8],
            )
        except Exception:
            pass
    return bool(bad)


def _execute_device_guarded(plan, mesh=None, verifier=None) -> WindowVerdict:
    """The device executor behind the full dispatch guard: breaker gate ->
    supervised deadline -> bounded retry -> bit-identical completion via
    `_execute_host`, plus the silent-corruption audit whose mismatch
    quarantines the device path (operator reset required). Off the card a
    caller always gets a verdict back — never a device exception, a hang,
    or an unaudited device result. On the card (the default executor, or
    one whose ``.device`` is CUDA) the same steps run, but where they would
    complete on the host the call raises ``DeviceDispatchError``."""
    br = _brk.get_device_breaker()
    cfg = _brk.guard_config()
    exe = _installed_executor()
    card = _executor_on_card(exe)
    if not br.allow():
        reason = (
            "quarantined" if br.state == _brk.QUARANTINED else "breaker_open"
        )
        return _without_device(reason, plan, verifier, card)
    attempts = 0
    while True:
        try:
            verdict = _brk.supervised_call(
                lambda: exe(plan, mesh), cfg.dispatch_deadline,
                name="planner-window",
            )
        except Exception as e:
            reason = (
                "timeout" if isinstance(e, _brk.DispatchTimeout) else "error"
            )
            br.record_failure(reason)
            attempts += 1
            if attempts <= cfg.retries and br.allow():
                try:
                    get_verify_metrics().device_retries.add(1.0)
                except Exception:
                    pass
                continue
            return _without_device(reason, plan, verifier, card, e)
        if _audit_device_verdict(plan, verdict):
            # the device returned verdicts that disagree with the host
            # oracle — a safety bug, not a perf bug. Latch it out of
            # service and recompute the whole window on the host (off the
            # card); the sampled lanes say nothing about the unsampled ones.
            br.quarantine("audit_mismatch:planner")
            return _without_device("audit_mismatch", plan, verifier, card)
        br.record_success()
        return verdict


def execute_plan(
    plan: WindowPlan, mesh=None, verifier=None, use_device: Optional[bool] = None
) -> WindowVerdict:
    """Run a planned window. use_device None -> device iff a mesh was given;
    True routes the guarded device executor (falling back to the verifier
    route when a lane's key type can't ride it); False goes through the
    BatchVerifier boundary (itself a device backend on the card)."""
    if use_device is None:
        use_device = mesh is not None
    if use_device and plan.all_ed25519():
        return _execute_device_guarded(plan, mesh=mesh, verifier=verifier)
    return _execute_host(plan, verifier=verifier)


def verify_window(
    votes: Sequence[Sequence[Optional[SigTuple]]],
    powers: Sequence[Sequence[int]],
    totals: Sequence[int],
    mesh=None,
    verifier=None,
    use_device: Optional[bool] = None,
) -> WindowVerdict:
    """plan + execute in one call — the synchronous entry point. The device
    route packs and uploads inside the guarded executor, so that a device
    fault there is a guarded failure too (the reference packs on the host
    before the guard)."""
    t0 = time.perf_counter()
    with trace.span("planner.pack", H=len(votes)):
        plan = plan_window(votes, powers, totals)
    plan.pack_seconds = time.perf_counter() - t0
    return execute_plan(plan, mesh=mesh, verifier=verifier, use_device=use_device)


def _plan_and_execute_windows(
    specs: Sequence[Tuple[Sequence, Sequence, Sequence]],
    mesh=None,
    verifier=None,
    use_device: Optional[bool] = None,
) -> Tuple[WindowPlan, WindowVerdict]:
    """Pack every spec into one lane tile and run it through execute_plan
    (the same guarded path single windows take); return plan + combined
    verdict."""
    t0 = time.perf_counter()
    with trace.span(
        "planner.pack",
        H=sum(len(v) for v, _, _ in specs),
        windows=len(specs),
    ):
        plan = plan_windows(specs)
    plan.pack_seconds = time.perf_counter() - t0
    verdict = execute_plan(
        plan, mesh=mesh, verifier=verifier, use_device=use_device)
    return plan, verdict


def verify_windows(
    specs: Sequence[Tuple[Sequence, Sequence, Sequence]],
    mesh=None,
    verifier=None,
    use_device: Optional[bool] = None,
) -> List[WindowVerdict]:
    """Verify several independent windows in ONE dispatch; the returned list
    is index-aligned with ``specs`` and each verdict is bit-identical to
    ``verify_window(*spec)``."""
    specs = list(specs)
    if not specs:
        return []
    plan, verdict = _plan_and_execute_windows(
        specs, mesh=mesh, verifier=verifier, use_device=use_device)
    return split_verdict(plan, verdict)


def rows_from_commit(precommits, pubkeys, msgs, sigs, powers):
    """Adapt ``ValidatorSet.collect_commit_sigs`` outputs (aligned, non-nil
    precommits in index order) into one planner row."""
    vrow: List[Optional[SigTuple]] = []
    prow: List[int] = []
    j = 0
    for pc in precommits:
        if pc is None:
            vrow.append(None)
            prow.append(0)
        else:
            vrow.append((pubkeys[j], msgs[j], sigs[j]))
            prow.append(powers[j])
            j += 1
    return vrow, prow


# ---------------------------------------------------------------------------
# Double-buffered window pipeline
# ---------------------------------------------------------------------------


class WindowPipeline:
    """Overlap host planning and packing with dispatch across a stream of
    windows (state sync's backfill sub-windows).

    A worker thread named ``planner-pack`` runs ``plan_window`` for windows
    N+1..N+depth while the consumer dispatches window N; a bounded queue
    keeps at most ``depth`` planned windows in memory (``[verify]
    pipeline_depth`` by default). The worker touches no device: the pack
    and upload run inside the guarded executor, under its deadline, so a
    failed or hung pack is a guarded failure of its window, never a stream
    error or an unbounded wait. Exceptions from the spec iterator re-raise
    at the consuming side, in order."""

    def __init__(self, mesh=None, verifier=None,
                 use_device: Optional[bool] = None,
                 prefetch: Optional[int] = None,
                 depth: Optional[int] = None):
        self.mesh = mesh
        self.verifier = verifier
        self.use_device = use_device
        # ``depth`` is the configured name, ``prefetch`` the reference's
        # original spelling: both mean the same bound
        d = depth if depth is not None else prefetch
        self.prefetch = max(1, int(d) if d is not None else _pipeline_depth)

    @property
    def depth(self) -> int:
        return self.prefetch

    def _device_route(self, plan) -> bool:
        dev = self.use_device if self.use_device is not None else self.mesh is not None
        return bool(dev) and plan.all_ed25519()

    def _execute_one(self, plan: WindowPlan) -> WindowVerdict:
        """One window's dispatch. A device-route exception that escapes the
        guard (a guard bug, an executor installed without it) must not
        abandon the windows behind it: off the card this window completes
        on the host and the stream goes on, as in the reference; on the card
        the failure is recorded and this window raises
        ``DeviceDispatchError``. Verifier-route exceptions re-raise: they
        are input faults, not device faults."""
        try:
            return execute_plan(
                plan, mesh=self.mesh, verifier=self.verifier,
                use_device=self.use_device,
            )
        except _brk.DeviceDispatchError:
            raise  # the guard on the card has recorded it already
        except Exception as e:
            if not self._device_route(plan):
                raise
            card = _executor_on_card(_installed_executor())
            _brk.get_device_breaker().record_failure("pipeline_error")
            _note_device_fallback("pipeline_error", plan, card)
            if card:
                raise _brk.DeviceDispatchError(
                    "pipeline_error", f"pipelined window of {plan.H} heights") from e
            return _execute_host(plan, verifier=self.verifier)

    def run(
        self, specs: Iterable[Tuple[Sequence, Sequence, Sequence]]
    ) -> Iterator[WindowVerdict]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(item) -> bool:
            """Bounded put that gives up when the consumer is gone: a syncer
            that rejects a snapshot abandons this generator mid-stream, and
            a plain put would park the worker on the full queue forever,
            holding up to ``prefetch`` planned windows."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for votes, powers, totals in specs:
                    if stop.is_set():
                        return
                    t0 = time.perf_counter()
                    with trace.span("planner.pack", H=len(votes)):
                        plan = plan_window(votes, powers, totals)
                    plan.pack_seconds = time.perf_counter() - t0
                    if not _put(("plan", plan)):
                        return
            except BaseException as e:  # re-raised on the consumer side
                _put(("err", e))
            else:
                _put(("done", None))

        threading.Thread(target=worker, name="planner-pack", daemon=True).start()
        try:
            while True:
                kind, item = q.get()
                if kind == "done":
                    return
                if kind == "err":
                    raise item
                yield self._execute_one(item)
        finally:
            # closed, abandoned or finished: stop the worker, then drop what
            # it already queued
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass


# ---------------------------------------------------------------------------
# Long-lived lane feed (cross-caller micro-batch aggregation)
# ---------------------------------------------------------------------------


@dataclass
class RowVerdict:
    """One submitted row's slice of a flushed ``LaneFeed`` batch: the same
    quorum semantics as ``WindowVerdict``, for one height row."""

    ok: np.ndarray  # (len(row),) bool, per lane in row order
    tally: int  # voting power of valid present lanes
    committed: bool  # tally*3 > total*2 (strict)
    sigs_ok: bool  # no present lane failed verification
    batch_rows: int  # rows folded into the dispatch that served this row
    batch_lanes: int  # present lanes in that dispatch
    occupancy: float  # lane occupancy of that dispatch


class _Ticket:
    """Handle for one submission; ``result()`` blocks until the feed's
    worker flushes the batch it rode in, and raises what the flush raised
    (on the card, ``DeviceDispatchError`` for a failed dispatch)."""

    __slots__ = ("_ev", "_verdict", "_err")
    _what = "feed"

    def __init__(self):
        self._ev = threading.Event()
        self._verdict = None
        self._err: Optional[BaseException] = None

    def _resolve(self, verdict=None, err=None) -> None:
        self._verdict = verdict
        self._err = err
        self._ev.set()

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError(f"{self._what} flush did not complete in time")
        if self._err is not None:
            raise self._err
        return self._verdict


class LaneTicket(_Ticket):
    """Handle for one submitted row of a ``LaneFeed``: ``result()`` gives
    its ``RowVerdict``."""

    __slots__ = ()
    _what = "lane feed"


@dataclass
class VoteVerdict:
    """One submitted vote's verdict and the shape of the dispatch that
    served it (the ``tendermint_consensus_vote_batch_*`` family)."""

    ok: bool  # signature verified
    batch_rows: int  # group rows folded into the dispatch
    batch_lanes: int  # present lanes in the dispatch
    occupancy: float  # lane occupancy of the dispatch
    flush_reason: str  # deadline | quorum | close


@dataclass
class TxVerdict(VoteVerdict):
    """One submitted transaction's verdict and the shape of its dispatch
    (the ``tendermint_mempool_batch_*`` family)."""


class VoteTicket(_Ticket):
    """A vote's ticket; ``submitted_ns`` and ``flushed_ns`` (the feed's
    clock) bound the queue wait the micro-batcher added."""

    __slots__ = ("submitted_ns", "flushed_ns")
    _what = "vote feed"

    def __init__(self):
        super().__init__()
        self.submitted_ns = 0
        self.flushed_ns = 0


class TxTicket(_Ticket):
    """A transaction's ticket."""

    __slots__ = ()
    _what = "tx feed"


class _GroupFeed:
    """The one micro-batcher under ``LaneFeed``, ``VoteFeed`` and
    ``TxFeed``. ``_park`` queues a submission; a worker thread holds the
    batch open for ``window_s`` (less after ``flush_now()``, ``close()`` or
    ``max_rows * windows_per_dispatch()`` pending submissions), then the
    subclass's ``_flush`` packs the batch into lane rows and ``_dispatch``
    chunks them into windows of at most ``max_rows``, folds those into ONE
    ``plan_windows`` tile and one guarded ``execute_plan`` dispatch
    (``_plan_and_execute_windows``), and resolves every ticket through the
    subclass's ``_resolve_row``. A failed dispatch raises into every ticket
    of its flush (on the card, ``DeviceDispatchError``)."""

    _thread_name = "planner-feed"
    _what = "feed"
    _verdict_cls = VoteVerdict

    def __init__(self, mesh, verifier, use_device, window_s, max_rows,
                 profile_kind, on_flush):
        windows_per_dispatch(mesh)  # a mesh raises here, not in the worker
        self.mesh = mesh
        self.verifier = verifier
        self.use_device = use_device
        self.window_s = max(0.0, float(window_s))
        self.max_rows = max(1, int(max_rows))
        self.profile_kind = profile_kind
        self.on_flush = on_flush
        # submissions and lanes in, the lane rows they packed into, the
        # dispatches, and the windows folded into them
        self._n_in = 0
        self.lanes_in = 0
        self.rows_out = 0
        self.dispatches = 0
        self.windows_out = 0
        self.flushes: dict = {"deadline": 0, "quorum": 0, "close": 0}
        self._cond = threading.Condition()
        self._pending: List[tuple] = []  # one entry a submission, its ticket last
        self._deadline = 0.0
        self._urgent = False
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    def _park(self, entry: tuple, urgent: bool = False, lanes: int = 1) -> None:
        """Queue one submission (its ticket last) for the next flush."""
        with self._cond:
            if self._closed:
                raise RuntimeError(f"{self._what} is closed")
            if not self._pending:
                self._deadline = time.monotonic() + self.window_s
            self._stamp(entry[-1])
            self._pending.append(entry)
            self._n_in += 1
            self.lanes_in += lanes
            if urgent:
                self._urgent = True
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._worker, name=self._thread_name, daemon=True)
                self._thread.start()
            self._cond.notify_all()

    def _stamp(self, ticket) -> None:
        pass

    def flush_now(self) -> None:
        """Collapse the current deadline: what is pending dispatches at
        once (counted as a quorum flush)."""
        with self._cond:
            self._urgent = True
            self._cond.notify_all()

    def close(self) -> None:
        """Stop accepting submissions; pending ones still flush before the
        worker exits (their tickets resolve, never hang)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for the worker to drain after close()."""
        t = self._thread
        if t is not None:
            t.join(timeout)

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._pending:
                    if self._closed:
                        return
                    self._cond.wait(0.1)
                # hold the batch open for the rest of the window unless a
                # quorum flush, close, or a full superdispatch's worth of
                # submissions comes first: racing submits fold into one
                # dispatch instead of queueing
                cap = self.max_rows * windows_per_dispatch(self.mesh)
                while (
                    len(self._pending) < cap
                    and not self._closed
                    and not self._urgent
                ):
                    left = self._deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cond.wait(left)
                if self._closed:
                    reason = "close"
                elif self._urgent:
                    reason = "quorum"
                else:
                    reason = "deadline"
                self._urgent = False
                batch, self._pending = self._pending, []
            self._flush(batch, reason)

    def _flush(self, batch: List[tuple], reason: str) -> None:
        raise NotImplementedError

    @staticmethod
    def _group(lanes: Iterable[tuple]) -> Tuple[List[tuple], dict]:
        """``(group_key, (pub, msg, sig), power, total, ticket)`` lanes into
        lane rows ``(vrow, prow, total, tickets)``, one a group key in
        first-seen order, and the rows by key."""
        rows: List[tuple] = []
        by_key: dict = {}
        for group_key, item, power, total, ticket in lanes:
            row = by_key.get(group_key)
            if row is None:
                row = ([], [], total, [])
                by_key[group_key] = row
                rows.append(row)
            row[0].append(item)
            row[1].append(power)
            row[3].append(ticket)
        return rows, by_key

    def _resolve_row(self, part: WindowVerdict, ri: int, row: tuple,
                     n_rows: int, verdict: WindowVerdict, reason: str) -> None:
        """Each lane's ticket of a dispatched row gets its own verdict."""
        for j, ticket in enumerate(row[3]):
            ticket._resolve(self._verdict_cls(
                ok=bool(part.ok[ri, j]),
                batch_rows=n_rows,
                batch_lanes=verdict.lanes_present,
                occupancy=verdict.occupancy,
                flush_reason=reason,
            ))

    def _metrics(self):
        return None

    def _notify(self, reason: str, n_in: int, n_rows: int,
                verdict: WindowVerdict, seconds: float) -> None:
        self.on_flush(reason, n_in, n_rows, verdict, seconds)

    def _dispatch(self, rows: List[tuple], keys, reason: str, n_in: int) -> None:
        """One guarded dispatch of ``rows`` ((vrow, prow, total, tickets),
        in arrival order) and every ticket resolved."""
        chunks = [rows[i: i + self.max_rows]
                  for i in range(0, len(rows), self.max_rows)]
        specs = [([r[0] for r in chunk], [r[1] for r in chunk], [r[2] for r in chunk])
                 for chunk in chunks]
        t0 = time.perf_counter()
        try:
            plan, verdict = _plan_and_execute_windows(
                specs, mesh=self.mesh, verifier=self.verifier,
                use_device=self.use_device,
            )
            parts = split_verdict(plan, verdict)
        except BaseException as e:
            for row in rows:
                for ticket in row[3]:
                    ticket._resolve(err=e)
            return
        seconds = time.perf_counter() - t0
        self.dispatches += 1
        self.windows_out += len(chunks)
        self.rows_out += len(rows)
        self.flushes[reason] = self.flushes.get(reason, 0) + 1
        try:
            # group keys lead with a height ((height, round, type) for
            # votes, (height, window_seq) for txs): the ledger entry covers
            # the batch's height span, as the reference's does
            hs = sorted({
                gk[0] for gk in keys
                if isinstance(gk, tuple) and gk and isinstance(gk[0], int)
            })
            prof = get_profiler()
            fields = dict(lanes_present=verdict.lanes_present,
                          lanes_dispatched=verdict.lanes_dispatched,
                          run_seconds=seconds, n_windows=len(chunks))
            if hs:
                with prof.window(hs[0], heights=hs[-1] - hs[0] + 1):
                    prof.record(self.profile_kind, **fields)
            else:
                prof.record(self.profile_kind, heights=len(rows), **fields)
        except Exception:
            pass
        try:
            m = self._metrics()
            if m is not None:
                m.record_flush(reason, rows=len(rows), lanes=verdict.lanes_present,
                               occupancy=verdict.occupancy)
        except Exception:
            pass
        if self.on_flush is not None:
            try:
                self._notify(reason, n_in, len(rows), verdict, seconds)
            except Exception:
                pass
        for part, chunk in zip(parts, chunks):
            for ri, row in enumerate(chunk):
                self._resolve_row(part, ri, row, len(rows), verdict, reason)


def _card_feed_verifier(device: DeviceLike, verifier):
    """A vote or tx feed's device and verifier: ``device`` resolved (``cuda``
    unless the caller passes ``"cpu"``; no card and no device raises
    ``NoCudaDeviceError``); ``verifier=None`` stays None on the card (the
    installed verifier runs) and is the reference's ``RLCHostVerifier`` on
    the CPU."""
    device = resolve_device(device)
    if verifier is None and device.type == "cpu":
        verifier = RLCHostVerifier()
    return device, verifier


class LaneFeed(_GroupFeed):
    """Long-lived lane feed, ``WindowPipeline``'s dual: many concurrent
    callers each hold one row (a commit's lanes). ``submit()`` parks the row
    for at most ``window_s`` seconds; a worker thread named
    ``planner-lane-feed`` chunks every row pending by then into windows of
    at most ``max_rows`` rows, folds the chunks into ONE lane tile
    (``plan_windows``) and one guarded ``execute_plan`` dispatch, and hands
    each caller its row's verdict. Collection stops early once
    ``max_rows * windows_per_dispatch()`` rows wait. ``rows_in`` and
    ``lanes_in`` count what was submitted, ``dispatches`` the flushes and
    ``windows_out`` the windows folded into them. On the defaults
    (``use_device=None``, no mesh) the feed takes the verifier route, as the
    RPC's feed does: ``verify_generic`` and the installed verifier."""

    _thread_name = "planner-lane-feed"
    _what = "lane feed"

    def __init__(self, mesh=None, verifier=None,
                 use_device: Optional[bool] = None, window_s: float = 0.002,
                 max_rows: int = 64, profile_kind: str = "lane_feed",
                 on_flush=None):
        # on_flush: (verdict, n_rows, seconds) per flush
        super().__init__(mesh, verifier, use_device, window_s, max_rows,
                         profile_kind, on_flush)

    @property
    def rows_in(self) -> int:
        return self._n_in

    def submit(
        self,
        vrow: Sequence[Optional[SigTuple]],
        prow: Sequence[int],
        total: int,
    ) -> LaneTicket:
        """Park one height row for the next flush; returns at once."""
        ticket = LaneTicket()
        self._park((list(vrow), list(prow), int(total), ticket),
                   lanes=sum(1 for it in vrow if it is not None))
        return ticket

    def _flush(self, batch: List[tuple], reason: str) -> None:
        # each submission is its own row
        rows = [(vrow, prow, total, [ticket]) for vrow, prow, total, ticket in batch]
        self._dispatch(rows, (), reason, len(batch))

    def _notify(self, reason, n_in, n_rows, verdict, seconds) -> None:
        self.on_flush(verdict, n_rows, seconds)

    def _resolve_row(self, part, ri, row, n_rows, verdict, reason) -> None:
        row[3][0]._resolve(RowVerdict(
            ok=np.asarray(part.ok[ri, : len(row[0])], dtype=bool),
            tally=int(part.tally[ri]),
            committed=bool(part.committed[ri]),
            sigs_ok=bool(part.sigs_ok[ri]),
            batch_rows=n_rows,
            batch_lanes=verdict.lanes_present,
            occupancy=verdict.occupancy,
        ))


class VoteFeed(_GroupFeed):
    """``LaneFeed``'s sibling for live consensus votes: the
    deadline-bounded micro-batcher behind ``VoteSet.add_vote``'s
    verification seam. The unit of submission is one vote; votes are keyed
    by their vote set, the ``(height, round, type)`` group whose validator
    set they share, and each group becomes one lane row, so concurrent vote
    sets ride one dispatch. ``flush_now()`` (or ``submit(urgent=True)``)
    collapses the window when a vote could complete a +2/3. Each flush
    records its trigger, its shape and its tickets' queue waits
    (``flush_records()``, ``tendermint_consensus_vote_batch_*``).

    ``device`` is resolved at construction (``cuda`` unless the caller
    passes ``"cpu"``; with no card and no device given it raises
    ``NoCudaDeviceError``). With ``verifier=None`` the feed passes no
    verifier down on the card, so the verifier route runs the installed
    verifier (the configuration root's guarded ``TorchBatchVerifier``: K1 +
    K2, K3 for secp256k1 lanes); on the CPU it takes the reference's
    default, ``RLCHostVerifier``. ``use_device=True`` takes the guarded
    device executor (K1 -> K2 -> the tally). ``on_flush`` gets ``(reason,
    n_in, n_rows, verdict, seconds)`` per flush."""

    FLUSH_RECORD_CAPACITY = 256  # the flush-attribution ring
    _thread_name = "planner-vote-feed"
    _what = "vote feed"

    def __init__(self, mesh=None, verifier=None,
                 use_device: Optional[bool] = None, window_s: float = 0.002,
                 max_rows: int = 64,
                 profile_kind: str = "consensus.vote_batch", on_flush=None,
                 now_ns=None, device: DeviceLike = None):
        self.device, verifier = _card_feed_verifier(device, verifier)
        super().__init__(mesh, verifier, use_device, window_s, max_rows,
                         profile_kind, on_flush)
        # the clock of the tickets' stamps; injectable so that a simulated
        # node's skewed clock stamps them
        self.now_ns = now_ns if now_ns is not None else time.time_ns
        self._flush_recs: List[dict] = []
        self._flush_recs_dropped = 0

    @property
    def votes_in(self) -> int:
        return self._n_in

    def submit(self, group_key, pub, msg: bytes, sig: bytes, power: int = 1,
               total: int = 1, urgent: bool = False) -> VoteTicket:
        """Park one vote for the next flush; returns at once. Votes that
        share ``group_key`` (their vote set) pack into one lane row."""
        ticket = VoteTicket()
        self._park((group_key, (pub, bytes(msg), bytes(sig)), int(power),
                    int(total), ticket), urgent)
        return ticket

    def _stamp(self, ticket) -> None:
        ticket.submitted_ns = self.now_ns()

    def flush_records(self) -> dict:
        """A copy of the recent-flush ledger: each flush's trigger, shape,
        (height, round, type) groups, window-open and flush stamps, and the
        worst and mean queue wait of its tickets."""
        with self._cond:
            return {
                "capacity": self.FLUSH_RECORD_CAPACITY,
                "dropped": self._flush_recs_dropped,
                "records": [dict(r) for r in self._flush_recs],
            }

    def _metrics(self):
        return get_vote_batch_metrics()

    def _flush(self, batch: List[tuple], reason: str) -> None:
        # the batch leaves the feed now: the queue wait is submit -> flush,
        # not submit -> verdict (the dispatch has its own spans)
        t_flush = self.now_ns()
        waits: List[float] = []
        for item in batch:
            ticket = item[-1]
            ticket.flushed_ns = t_flush
            if ticket.submitted_ns:
                waits.append(max(0.0, (t_flush - ticket.submitted_ns) / 1e9))
        # one lane row per vote-set group, in first-seen order
        rows, by_key = self._group(batch)
        rec = {
            "reason": reason,
            "votes": len(batch),
            "rows": len(rows),
            "groups": [list(gk) if isinstance(gk, tuple) else gk for gk in by_key],
            "t_open_ns": min(
                (it[-1].submitted_ns for it in batch if it[-1].submitted_ns),
                default=t_flush,
            ),
            "t_flush_ns": t_flush,
            "wait_max_s": max(waits) if waits else 0.0,
            "wait_mean_s": (sum(waits) / len(waits)) if waits else 0.0,
        }
        with self._cond:
            self._flush_recs.append(rec)
            if len(self._flush_recs) > self.FLUSH_RECORD_CAPACITY:
                del self._flush_recs[0]
                self._flush_recs_dropped += 1
        try:
            vm = get_vote_batch_metrics()
            for w in waits:
                vm.record_wait(w)
        except Exception:
            pass
        self._dispatch(rows, by_key, reason, len(batch))


class TxFeed(_GroupFeed):
    """``VoteFeed``'s ingest sibling: the deadline-bounded transaction
    micro-batcher behind the mempool's verdict-bearing CheckTx hook
    (``mempool/tx_verify.BatchTxVerifier``). The unit of submission is one
    transaction's ``(pub, sign_bytes, sig)``; each ``group_key`` (a
    ``(height, window_seq)`` CheckTx window) becomes one lane row. The
    quorum math is vestigial: power 1 a lane and total = the row's lane
    count. ``flush_now()`` collapses the window once a whole CheckTx window
    is in (counted as a quorum flush); flushes are counted in
    ``tendermint_mempool_batch_*``. ``device`` and ``verifier`` default as
    ``VoteFeed``'s do."""

    _thread_name = "planner-tx-feed"
    _what = "tx feed"
    _verdict_cls = TxVerdict

    def __init__(self, mesh=None, verifier=None,
                 use_device: Optional[bool] = None, window_s: float = 0.002,
                 max_rows: int = 64, profile_kind: str = "mempool.tx_batch",
                 on_flush=None, device: DeviceLike = None):
        self.device, verifier = _card_feed_verifier(device, verifier)
        super().__init__(mesh, verifier, use_device, window_s, max_rows,
                         profile_kind, on_flush)

    @property
    def txs_in(self) -> int:
        return self._n_in

    def submit(self, group_key, pub, msg: bytes, sig: bytes,
               urgent: bool = False) -> TxTicket:
        """Park one tx signature for the next flush; returns at once. Txs
        that share ``group_key`` (their CheckTx window) pack into one lane
        row."""
        ticket = TxTicket()
        self._park((group_key, (pub, bytes(msg), bytes(sig)), 1, 0, ticket), urgent)
        return ticket

    def _metrics(self):
        return get_mempool_batch_metrics()

    def _flush(self, batch: List[tuple], reason: str) -> None:
        rows, by_key = self._group(batch)
        rows = [(vrow, prow, len(vrow), tickets) for vrow, prow, _, tickets in rows]
        self._dispatch(rows, by_key, reason, len(batch))
